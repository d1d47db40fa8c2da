"""The port's audio routes and ASR loading on the CPU, on tiny random
models: POST /v1/audio/transcriptions and /v1/audio/translations take raw
WAV bytes and answer 200 with the text the first capable model's own
``transcribe`` / ``translate`` gives on the decoded samples (16-bit PCM,
channels averaged), past 30 s through ``translate_long``, and 404 where
no model can; ``registry.load_pipeline`` and ``Server.load_model`` load
Paraformer, Qwen3-ASR, Fun-ASR-Nano and FunASR-Qwen4B checkpoint
directories (each a ``transcribe(samples, rate)`` facade; a loaded model
answers as the in-memory one) while the other pipeline types still raise
``NotImplementedError`` naming their family; and ``python -m
ominix_mlx_tpu_torch.transcribe`` prints a loaded model's text."""

import io
import json
import os
import socket
import subprocess
import sys
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from ominix_mlx_tpu_torch import native
from ominix_mlx_tpu_torch.models import base, funasr_nano, paraformer
from ominix_mlx_tpu_torch.models import qwen3_asr, registry
from ominix_mlx_tpu_torch.serving.server import ChatModel, Server
from ominix_mlx_tpu_torch.utils.loading import (save_model,
                                                save_safetensors)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PF = dict(n_mels=8, lfr_m=2, encoder_dim=16, encoder_layers=2,
          encoder_heads=2, encoder_ffn_dim=24, sanm_kernel_size=3,
          decoder_layers=1, decoder_dim=16, decoder_heads=2,
          decoder_ffn_dim=24, vocab_size=40)
ADA = dict(in_dim=16, hidden=24, out_dim=32, layers=2, heads=2)
LM = base.TransformerConfig(vocab_size=64, hidden_size=32, num_layers=1,
                            num_heads=2, num_kv_heads=1, head_dim=16,
                            intermediate_size=48, use_qk_norm=True,
                            tie_word_embeddings=True)
LM_HF = {"model_type": "qwen3", "vocab_size": 64, "hidden_size": 32,
         "num_hidden_layers": 1, "num_attention_heads": 2,
         "num_key_value_heads": 1, "head_dim": 16, "intermediate_size": 48,
         "tie_word_embeddings": True}
ENC = dict(num_mel_bins=32, encoder_layers=1, encoder_attention_heads=2,
           encoder_ffn_dim=32, d_model=16, output_dim=32,
           downsample_hidden_size=8, n_window_infer=200)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _paraformer(seed=0):
    cfg = paraformer.ParaformerConfig(**PF)
    return paraformer.Transcriber(
        params=paraformer.init_params(cfg, _gen(seed), device="cpu"),
        cfg=cfg, device="cpu")


def _nano(seed=1):
    enc_cfg = paraformer.ParaformerConfig(**PF)
    acfg = funasr_nano.AdaptorConfig(**ADA)
    return funasr_nano.FunASRNano(
        enc_params=paraformer.init_params(enc_cfg, _gen(seed), device="cpu"),
        enc_cfg=enc_cfg,
        adaptor_params=funasr_nano.init_adaptor(acfg, _gen(seed + 1),
                                                device="cpu"),
        adaptor_cfg=acfg,
        lm_params=base.init_params(LM, _gen(seed + 2), torch.float32, "cpu"),
        lm_cfg=LM, device="cpu")


def _qwen3_asr(seed=2):
    ecfg = qwen3_asr.AudioEncoderConfig(**ENC)
    return qwen3_asr.Qwen3ASR(
        enc_params=qwen3_asr.init_encoder_params(ecfg, _gen(seed),
                                                 device="cpu"),
        enc_cfg=ecfg,
        lm_params=base.init_params(LM, _gen(seed + 1), torch.float32, "cpu"),
        lm_cfg=LM, device="cpu")


def _wav(seconds, rate=16000, channels=1, seed=0) -> bytes:
    n = int(seconds * rate)
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    x = 0.3 * np.sin(2 * np.pi * 250 * t)[:, None] + 0.05 * rng.normal(
        size=(n, channels))
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((x * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def _samples(wav_bytes):
    """The route's decode: 16-bit PCM to float, channels averaged."""
    with wave.open(io.BytesIO(wav_bytes), "rb") as w:
        rate, ch = w.getframerate(), w.getnchannels()
        raw = w.readframes(w.getnframes())
    x = native.pcm16_to_float(np.frombuffer(raw, np.int16))
    return (x.reshape(-1, ch).mean(-1) if ch > 1 else x), rate


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post_raw(srv, path, data):
    req = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}",
                                 data=data)
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def served():
    para, nano = _paraformer(), _nano()
    srv = Server(port=_free_port())
    srv.add_model("para", para)           # transcribes, cannot translate
    srv.add_model("nano", nano)
    srv.start_background()
    yield srv, para, nano
    srv.shutdown()


@pytest.mark.parametrize("channels", [1, 2])
def test_transcription_route_answers_the_first_capable_model(served,
                                                             channels):
    srv, para, _ = served
    data = _wav(0.6, channels=channels, seed=channels)
    code, out = _post_raw(srv, "/v1/audio/transcriptions", data)
    assert code == 200
    x, rate = _samples(data)
    assert out == {"text": para.transcribe(x, rate)} and out["text"]


def test_translation_route_takes_the_first_translating_model(served):
    srv, _, nano = served
    data = _wav(0.5, seed=3)
    code, out = _post_raw(srv, "/v1/audio/translations", data)
    x, rate = _samples(data)
    assert code == 200 and out == {"text": nano.translate(x, rate)}


def test_translation_past_30_s_takes_translate_long(served, monkeypatch):
    srv, _, nano = served
    calls = []
    orig = nano.translate_long

    def spy(samples, rate):
        calls.append(len(samples))
        return orig(samples, rate, max_tokens=3)

    monkeypatch.setattr(nano, "translate_long", spy)
    data = _wav(31, rate=8000, seed=4)
    code, out = _post_raw(srv, "/v1/audio/translations", data)
    x, rate = _samples(data)
    assert code == 200 and calls == [31 * 8000]
    assert out == {"text": orig(x, rate, max_tokens=3)}
    assert out["text"].count(" ") >= 1       # two chunks joined


def test_routes_answer_404_without_a_capable_model():
    params = base.init_params(LM, _gen(5), torch.float32, "cpu")
    srv = Server(port=_free_port())
    srv.add_model("chat", ChatModel("chat", params, LM, None, "cpu"))
    srv.add_model("para", _paraformer())
    srv.start_background()
    try:
        code, out = _post_raw(srv, "/v1/audio/translations", _wav(0.2))
        assert code == 404 and "translate" in out["error"]
        srv.remove_model("para")
        code, out = _post_raw(srv, "/v1/audio/transcriptions", _wav(0.2))
        assert code == 404 and "transcribe" in out["error"]
        with pytest.raises(KeyError, match="cannot transcribe"):
            srv.audio_transcription(_wav(0.2), model_name="chat")
        code, _ = _post_raw(srv, "/v1/audio/speech", b"{}")
        assert code == 404
    finally:
        srv.shutdown()


# ------------------------------------------------------------ checkpoints

def _paraformer_dir(path, model):
    save_model(str(path), {"model_type": "paraformer", **PF}, model.params)
    return str(path)


def _qwen3_asr_dir(path, model):
    enc = dict(model.enc_params)
    for name in qwen3_asr.CONVS:              # the JAX tree's OHWI
        enc[name] = {**enc[name], "w": enc[name]["w"].permute(0, 2, 3, 1)}
    save_model(str(path), {"model_type": "qwen3_asr",
                           "audio_encoder_conf": ENC, "text_config": LM_HF},
               {"encoder": enc, "llm": model.lm_params})
    return str(path)


def _funasr_dir(path, model, model_type):
    """A FunASRNano's trees in FunASR's encoder and adaptor names and HF
    Qwen3 names under llm.*."""
    flat = {}

    def lin(name, p):
        flat[f"{name}.weight"] = p["w"]
        if "b" in p:
            flat[f"{name}.bias"] = p["b"]

    def enc_layer(pre, lp):
        lin(f"{pre}.norm1", lp["norm1"])
        lin(f"{pre}.norm2", lp["norm2"])
        lin(f"{pre}.self_attn.linear_q_k_v", lp["self_attn"]["linear_q_k_v"])
        lin(f"{pre}.self_attn.linear_out", lp["self_attn"]["out_proj"])
        flat[f"{pre}.self_attn.fsmn_block.weight"] = \
            lp["self_attn"]["fsmn_block"]["w"].permute(0, 2, 1)
        lin(f"{pre}.feed_forward.w_1", lp["ffn_up"])
        lin(f"{pre}.feed_forward.w_2", lp["ffn_down"])

    ep, ap, lp = model.enc_params, model.adaptor_params, model.lm_params
    enc_layer("encoder.encoders0.0", ep["first_layer"])
    for i, layer in enumerate(ep["layers"]):
        enc_layer(f"encoder.encoders.{i}", layer)
    lin("encoder.after_norm", ep["after_norm"])
    lin("adaptor.linear1", ap["proj_in"])
    lin("adaptor.linear2", ap["proj_out"])
    for i, layer in enumerate(ap["layers"]):
        pre = f"adaptor.blocks.{i}"
        for ours, theirs in (("norm1", "norm1"), ("norm2", "norm2"),
                             ("q", "self_attn.q_proj"),
                             ("k", "self_attn.k_proj"),
                             ("v", "self_attn.v_proj"),
                             ("o", "self_attn.o_proj"), ("fc1", "fc1"),
                             ("fc2", "fc2")):
            lin(f"{pre}.{theirs}", layer[ours])
    flat["llm.model.embed_tokens.weight"] = lp["embed"]
    flat["llm.model.norm.weight"] = lp["norm"]
    names = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
             "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
             "q_norm": "self_attn.q_norm", "k_norm": "self_attn.k_norm",
             "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
             "down_proj": "mlp.down_proj",
             "input_layernorm": "input_layernorm",
             "post_attention_layernorm": "post_attention_layernorm"}
    for i, layer in enumerate(lp["layers"]):
        for ours, theirs in names.items():
            t = layer[ours]
            flat[f"llm.model.layers.{i}.{theirs}.weight"] = \
                t["w"] if isinstance(t, dict) else t
    os.makedirs(path, exist_ok=True)
    save_safetensors(os.path.join(path, "model.safetensors"),
                     {k: v.contiguous() for k, v in flat.items()})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": model_type,
                   "audio_encoder_conf": {"num_blocks": 2},
                   "adaptor_conf": {"llm_dim": 32}, "llm_conf": LM_HF}, f)
    return str(path)


def _tiny_nano_cfgs(m):
    """The loader's configs are Paraformer-large's and the default
    adaptor's apart from the depth and out width: give the loaded model
    the widths its checkpoint holds."""
    m.enc_cfg = paraformer.ParaformerConfig(**PF)
    m.adaptor_cfg = funasr_nano.AdaptorConfig(**ADA)
    return m


def test_load_pipeline_loads_each_asr_type(tmp_path):
    x = _samples(_wav(0.5, seed=6))[0]
    para = _paraformer(seed=7)
    cap, got = registry.load_pipeline(
        _paraformer_dir(tmp_path / "p", para), device="cpu")
    assert cap == "transcribe" and isinstance(got, paraformer.Transcriber)
    assert got.transcribe(x) == para.transcribe(x)

    q = _qwen3_asr(seed=8)
    cap, got = registry.load_pipeline(_qwen3_asr_dir(tmp_path / "q", q),
                                      device="cpu")
    assert cap == "transcribe" and isinstance(got, qwen3_asr.Qwen3ASR)
    assert got.transcribe(x, max_tokens=4) == q.transcribe(x, max_tokens=4)

    nano = _nano(seed=9)
    for mt in ("funasr_nano", "funasr_qwen4b"):
        cap, got = registry.load_pipeline(
            _funasr_dir(tmp_path / mt, nano, mt), device="cpu")
        assert cap == "transcribe"
        assert isinstance(got, funasr_nano.FunASRNano)
        assert _tiny_nano_cfgs(got).transcribe(x, max_tokens=4) == \
            nano.transcribe(x, max_tokens=4)


UNPORTED = {"gpt_sovits": "gpt_sovits", "step_audio2": "step_audio2",
            "flux_klein": "flux_klein", "qwen_image": "qwen_image",
            "zimage": "zimage"}


def test_the_unported_pipelines_are_the_other_six():
    unported = {mt for mt, (fam, _) in registry.PIPELINE_TYPES.items()
                if fam not in registry.PORTED_PIPELINES}
    assert unported == set(UNPORTED)


@pytest.mark.parametrize("model_type", sorted(UNPORTED))
def test_other_pipelines_still_raise(model_type, tmp_path):
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_type": model_type}, f)
    with pytest.raises(NotImplementedError, match=UNPORTED[model_type]):
        registry.load_pipeline(str(tmp_path), device="cpu")
    srv = Server(port=0)
    try:
        with pytest.raises(NotImplementedError):
            srv.load_model("x", str(tmp_path), device="cpu")
    finally:
        srv.shutdown()


def test_server_load_model_serves_a_transcription(tmp_path):
    para = _paraformer(seed=10)
    srv = Server(port=_free_port())
    srv.load_model("asr", _paraformer_dir(tmp_path / "p", para),
                   device="cpu")
    srv.start_background()
    try:
        data = _wav(0.7, rate=22050, seed=11)
        code, out = _post_raw(srv, "/v1/audio/transcriptions", data)
        x, rate = _samples(data)
        assert code == 200 and out == {"text": para.transcribe(x, rate)}
        assert srv.models["asr"].dir == str(tmp_path / "p")
    finally:
        srv.shutdown()


def test_transcribe_command_line(tmp_path):
    """``python -m ominix_mlx_tpu_torch.transcribe --device cpu`` prints
    the loaded model's text on the file read at 16 kHz (here resampled
    from 24 kHz by the native resampler)."""
    from ominix_mlx_tpu_torch.audio.io import load_wav

    para = _paraformer(seed=12)
    d = _paraformer_dir(tmp_path / "p", para)
    with open(tmp_path / "p" / "tokens.txt", "w", encoding="utf-8") as f:
        f.write("\n".join(f"t{i}" for i in range(PF["vocab_size"])) + "\n")
    wav = tmp_path / "x.wav"
    wav.write_bytes(_wav(0.5, rate=24000, seed=13))
    run = subprocess.run(
        [sys.executable, "-m", "ominix_mlx_tpu_torch.transcribe", "--model",
         d, "--audio", str(wav), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    x, rate = load_wav(str(wav), target_rate=16000)
    want = paraformer.load_model(d, device="cpu").transcribe(x, rate)
    assert run.stdout == want + "\n" and want.startswith("t")
