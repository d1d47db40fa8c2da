"""The port's OpenAI-compatible server over a real socket: health, model
list, metrics, non-streaming and streaming chat completions on a tiny
quantized model with a byte-level tokenizer. Greedy text must equal the
port's own Engine.generate output for the same prompt, and concurrent
requests to a batched (paged, prefix-cached) server must give the same
greedy text as the unbatched server."""

import json
import socket
import threading
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


@pytest.fixture(scope="module")
def served_batched():
    """Two models on one server over the same dense float32 weights: "solo"
    on the inference thread, "batched" on a paged, prefix-cached batcher
    (page 16, 3 slots, a 40-token chunk limit so long prompts adopt by
    chunks)."""
    cfg = base.TransformerConfig(
        vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
        num_kv_heads=2, head_dim=16, intermediate_size=128,
        use_qk_norm=True, tie_word_embeddings=True)
    params = base.init_params(cfg, torch.Generator().manual_seed(1),
                              torch.float32)
    srv = Server(port=_free_port())
    for name in ("solo", "batched"):
        srv.add_model(name, ChatModel(name, params, cfg, ByteTokenizer(),
                                      "cpu", kv_dtype=torch.float32))
    srv.enable_batching("batched", slots=3, max_len=256, paged=True,
                        page_size=16, prefix_cache=True,
                        dtype=torch.float32)
    srv.batchers["batched"].batcher.prefill_chunk = 40
    srv.start_background()
    yield srv
    srv.shutdown()
    assert not srv.batchers["batched"].thread.is_alive()


def _chat_text(srv, model, content, stream=False, **kw):
    body = {"model": model, "max_tokens": 6, "stream": stream,
            "messages": [{"role": "system", "content": "Be brief. " * 4},
                         {"role": "user", "content": content}], **kw}
    with _post(srv, body) as r:
        raw = r.read()
    if not stream:
        return json.loads(raw)["choices"][0]["message"]["content"]
    events = [ln[6:] for ln in raw.decode().split("\n")
              if ln.startswith("data: ")]
    assert events[-1] == "[DONE]"
    return "".join(json.loads(e)["choices"][0]["delta"].get("content", "")
                   for e in events[:-1])


def test_batched_concurrent_chat_equals_unbatched(served_batched):
    """Ten concurrent requests (more client threads than cores and than
    the 3 slots, with a short thread switch interval; all share a system
    prompt of several pages, one prompt is long enough to adopt by
    chunks, one streams, one samples) on the batched model: each greedy
    text equals the unbatched model's, and the prefix cache records
    hits."""
    import sys
    srv = served_batched
    contents = ["hi", "hello there", "what is 2+2?", "tell me more " * 6,
                "hi again", "ok", "why?", "one more", "count to 3"]
    want = [_chat_text(srv, "solo", c) for c in contents]
    got = [None] * len(contents)
    errs = []

    def run(i):
        try:
            got[i] = _chat_text(srv, "batched", contents[i], stream=i == 2)
        except Exception as e:      # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(contents))]
    sampled = threading.Thread(target=lambda: got.append(_chat_text(
        srv, "batched", "pick one", temperature=0.7, seed=3)))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads + [sampled]:
            t.start()
        for t in threads + [sampled]:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads + [sampled])
    assert not errs, errs
    assert got[:len(contents)] == want
    assert isinstance(got[-1], str)
    pfx = srv.batchers["batched"].batcher.prefix
    assert pfx.hits >= 1
    assert b"ominix_prefix_cache_hits" in _get(srv, "/metrics")


def test_batched_speculative_answers_501(served_batched):
    """Speculative batching is not ported: enabling it raises
    NotImplementedError, and a request needing an unported feature on the
    batched model still answers 501."""
    srv = served_batched
    with pytest.raises(NotImplementedError):
        srv.enable_batching("solo", draft_layers=1)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv, {"model": "batched", "messages": MSGS,
                    "tools": [{"type": "x"}]})
    assert e.value.code == 501


def test_batched_step_error_answers_500(served_batched):
    """A decode step that raises fails the requests in flight: HTTP 500
    with the error's text (an error event, and no [DONE], in a stream),
    never a normal short answer; the batcher then serves the next request
    as before."""
    srv = served_batched
    cb = srv.batchers["batched"].batcher
    fwd = cb.fwd

    def broken(*a, **kw):
        raise RuntimeError("kernel launch failed")

    cb.fwd = broken
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _chat_text(srv, "batched", "hi")
        assert e.value.code == 500
        assert b"kernel launch failed" in e.value.read()
        with _post(srv, {"model": "batched", "max_tokens": 6, "stream": True,
                         "messages": MSGS}) as r:
            raw = r.read()
        assert b'"code": 500' in raw and b"[DONE]" not in raw
    finally:
        cb.fwd = fwd
    assert _chat_text(srv, "batched", "hi") == _chat_text(srv, "solo", "hi")
