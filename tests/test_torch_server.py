"""The port's OpenAI-compatible server over a real socket: health, model
list, metrics, non-streaming and streaming chat completions on a tiny
quantized model with a byte-level tokenizer. Greedy text must equal the
port's own Engine.generate output for the same prompt."""

import json
import socket
import urllib.error
import urllib.request

import pytest
import torch

from ominix_mlx_tpu_torch.core.sampling import SamplerConfig
from ominix_mlx_tpu_torch.models import base
from ominix_mlx_tpu_torch.serving.server import ChatModel, Server
from ominix_mlx_tpu_torch.utils.tokenizer import chatml

torch.set_num_threads(2)

CFG = base.TransformerConfig(
    vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
    num_kv_heads=2, head_dim=64, intermediate_size=512, use_qk_norm=True,
    tie_word_embeddings=True)


class ByteTokenizer:
    """UTF-8 bytes are ids 0..255; larger ids decode as ``<id>``."""
    eos_token_id = 511

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        out, buf = [], bytearray()
        for i in ids:
            if i < 256:
                buf.append(i)
                continue
            out.append(buf.decode("utf-8", "replace"))
            buf = bytearray()
            out.append(f"<{i}>")
        out.append(buf.decode("utf-8", "replace"))
        return "".join(out)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def served():
    params = base.fuse_layer_projections(base.init_quantized_params(
        CFG, torch.Generator().manual_seed(0), act_bits=8))
    model = ChatModel("tiny", params, CFG, ByteTokenizer(), "cpu")
    srv = Server(port=_free_port())
    srv.add_model("tiny", model)
    srv.start_background()
    yield srv, model
    srv.shutdown()
    assert not srv.worker.thread.is_alive()


def _url(srv, path):
    return f"http://127.0.0.1:{srv.port}{path}"


def _get(srv, path):
    with urllib.request.urlopen(_url(srv, path), timeout=60) as r:
        return r.read()


def _post(srv, body):
    req = urllib.request.Request(_url(srv, "/v1/chat/completions"),
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    return urllib.request.urlopen(req, timeout=120)


MSGS = [{"role": "user", "content": "hi"}]


def _engine_text(model, n):
    toks = model.tokenizer.encode(chatml(MSGS))
    eng = model.engine(SamplerConfig())
    out = list(eng.generate(torch.tensor(toks), model.init_cache(
        len(toks) + n + 8), max_tokens=n,
        stop_tokens=(model.tokenizer.eos_token_id,)))
    return model.tokenizer.decode(out), len(out)


def test_health_models_metrics(served):
    srv, _ = served
    h = json.loads(_get(srv, "/health"))
    assert h["status"] == "ok" and h["models_loaded"] == 1
    m = json.loads(_get(srv, "/v1/models"))
    assert [d["id"] for d in m["data"]] == ["tiny"]
    assert b"ominix_requests_total" in _get(srv, "/metrics")
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv, "/v1/audio/voices")
    assert e.value.code == 404


def test_chat_nonstreaming_equals_engine(served):
    srv, model = served
    with _post(srv, {"messages": MSGS, "max_tokens": 8}) as r:
        out = json.loads(r.read())
    text, n = _engine_text(model, 8)
    assert out["object"] == "chat.completion"
    assert out["choices"][0]["message"]["content"] == text
    assert out["usage"]["completion_tokens"] == n > 0


def test_chat_streaming_equals_engine(served):
    srv, model = served
    with _post(srv, {"messages": MSGS, "max_tokens": 8,
                     "stream": True}) as r:
        raw = r.read().decode()
    events = [ln[6:] for ln in raw.split("\n") if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks)
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"
    assert text == _engine_text(model, 8)[0]


def test_chat_stop_string_and_errors(served):
    srv, _ = served
    with _post(srv, {"messages": MSGS, "max_tokens": 8}) as r:
        full = json.loads(r.read())["choices"][0]["message"]["content"]
    stop = full[2:4]
    with _post(srv, {"messages": MSGS, "max_tokens": 8, "stop": stop}) as r:
        cut = json.loads(r.read())["choices"][0]["message"]["content"]
    assert stop not in cut and full.startswith(cut)
    for body, code in (({"model": "nope", "messages": MSGS}, 404),
                       ({"messages": MSGS, "tools": [{"type": "x"}]}, 501),
                       ({"messages": MSGS, "max_tokens": 0}, 400)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv, body)
        assert e.value.code == code
