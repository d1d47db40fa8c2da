"""The port's speech route, TTS loading and the ``speak`` command on the
CPU, on a tiny random Qwen3-TTS (a 2-layer talker, a tiny codec):

  - POST /v1/audio/speech answers 200 with a mono 16-bit WAV at the
    model's 24 kHz whose samples are ``native.float_to_pcm16`` of the
    model's own ``synthesize(text, voice)`` (a named voice's codec prefix
    included), and 404 where no model can synthesize;
  - the ``ref_audio`` branch: a model with ``set_reference_audio`` gets
    the decoded reference (16-bit PCM to float, channels averaged) and
    rate before ``synthesize(text)``, and its bare waveform is written at
    its ``sample_rate``;
  - ``registry.load_pipeline`` loads a saved qwen3_tts directory into a
    ``qwen3_tts.TTSModel`` that synthesizes as the model it was saved
    from; ``Server.load_model`` serves it and ``remove_model`` closes it;
  - ``speak.main`` (``python -m ominix_mlx_tpu_torch.speak``) writes the WAV
    of the loaded model's samples, time-stretched where ``--speed`` is
    not 1.
"""

import base64
import io
import json
import socket
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest
import torch

from ominix_mlx_tpu_torch import native
from ominix_mlx_tpu_torch.audio.dsp import wsola_time_stretch
from ominix_mlx_tpu_torch.models import base, qwen3_tts, registry
from ominix_mlx_tpu_torch.serving.server import Server
from ominix_mlx_tpu_torch.utils.loading import save_model

torch.set_num_threads(2)

BODY_HF = {"vocab_size": 1, "hidden_size": 64, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "head_dim": 16, "intermediate_size": 96}
TALK = dict(codec_vocab_size=32, codec_head_size=40, num_code_groups=16,
            text_vocab_size=128, text_embed_dim=48, cp_hidden=32,
            cp_layers=1, cp_heads=2, codec_eos_id=33, codec_pad_id=34,
            codec_bos_id=35, tts_pad_token_id=100)
TCFG = qwen3_tts.TalkerConfig(
    transformer=base.TransformerConfig.from_hf(BODY_HF), **TALK)
VOICES = {"amy": [36, 37, 38, 39, 36]}


def _tts(seed=0, max_frames=5):
    g = torch.Generator().manual_seed(seed)
    tp = qwen3_tts.init_params(TCFG, g, device="cpu")
    tp["codec_head"]["w"] *= 4
    dec, cfg = qwen3_tts.init_codec(g, frame_dim=32, up_strides=(2,),
                                    dec_strides=(2, 2), codec_vocab=32,
                                    device="cpu")
    syn = qwen3_tts.Synthesizer(tp, TCFG, dec, cfg)
    return qwen3_tts.TTSModel(syn, voices=VOICES, max_frames=max_frames)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _post(srv, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/audio/speech",
        data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _read_wav(data: bytes):
    with wave.open(io.BytesIO(data), "rb") as w:
        assert w.getnchannels() == 1 and w.getsampwidth() == 2
        return w.getframerate(), np.frombuffer(w.readframes(w.getnframes()),
                                               np.int16)


def _pcm(samples):
    return native.float_to_pcm16(np.asarray(samples, np.float32))


@pytest.fixture(scope="module")
def tts():
    return _tts()


def test_speech_route_answers_the_models_wav(tts):
    srv = Server(port=_free_port())
    srv.add_model("tts", tts)
    srv.start_background()
    try:
        for voice in (None, "amy"):
            body = {"input": "Hi there", **({"voice": voice} if voice
                                            else {})}
            code, ctype, data = _post(srv, body)
            assert code == 200 and ctype == "audio/wav"
            assert data[:4] == b"RIFF" and data[8:12] == b"WAVE"
            rate, pcm = _read_wav(data)
            want, wrate = tts.synthesize("Hi there", voice=voice)
            assert rate == wrate == 24000
            assert len(pcm) >= 3 * qwen3_tts.samples_per_frame(
                tts.synthesizer.codec_cfg)
            np.testing.assert_array_equal(pcm, _pcm(want))
        # the preset voice's prefix gives other audio
        assert not np.array_equal(_read_wav(_post(srv, {
            "input": "Hi there"})[2])[1], _read_wav(_post(srv, {
                "input": "Hi there", "voice": "amy"})[2])[1])
    finally:
        srv.shutdown()


def test_speech_route_answers_404_without_a_tts_model():
    srv = Server(port=_free_port())
    srv.start_background()
    try:
        code, _, data = _post(srv, {"input": "hi"})
        assert code == 404 and "TTS" in json.loads(data)["error"]
        with pytest.raises(KeyError, match="no TTS capability"):
            srv.audio_speech({"input": "hi", "model": "nope"})
    finally:
        srv.shutdown()


class _Cloner:
    """A voice-clone model: ``set_reference_audio`` then a bare
    waveform."""

    sample_rate = 32000

    def __init__(self):
        self.ref = None

    def set_reference_audio(self, samples, rate):
        self.ref = (np.asarray(samples), rate)

    def synthesize(self, text):
        x, _ = self.ref
        return np.tile(x, 2)[:len(text) * 100] * 0.5


def test_speech_route_passes_ref_audio_to_a_cloner():
    rng = np.random.default_rng(0)
    ref = (rng.normal(scale=0.2, size=(800, 2)) * 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(ref.tobytes())
    m = _Cloner()
    srv = Server(port=_free_port())
    srv.add_model("clone", m)
    srv.start_background()
    try:
        code, _, data = _post(srv, {
            "input": "hello", "ref_audio": base64.b64encode(
                buf.getvalue()).decode()})
    finally:
        srv.shutdown()
    assert code == 200
    want_ref = native.pcm16_to_float(ref.reshape(-1)).reshape(-1, 2).mean(-1)
    np.testing.assert_array_equal(m.ref[0], want_ref)
    assert m.ref[1] == 16000
    rate, pcm = _read_wav(data)
    assert rate == 32000
    np.testing.assert_array_equal(pcm, _pcm(m.synthesize("hello")))


def _tts_dir(path, model):
    syn = model.synthesizer
    save_model(str(path), {
        "model_type": "qwen3_tts",
        "talker_config": {"transformer": BODY_HF, **TALK},
        "codec_config": dict(syn.codec_cfg), "sample_rate": 24000,
        "voices": VOICES}, {"talker": syn.tp, "codec": syn.codec})
    return str(path)


def test_load_pipeline_loads_a_qwen3_tts_directory(tts, tmp_path):
    cap, got = registry.load_pipeline(_tts_dir(tmp_path / "t", tts),
                                      device="cpu")
    assert cap == "speak" and isinstance(got, qwen3_tts.TTSModel)
    assert got.synthesizer.tcfg == TCFG and got.voices == VOICES
    got.max_frames = tts.max_frames
    for voice in (None, "amy"):
        w, rate = got.synthesize("Hi", voice=voice)
        want, _ = tts.synthesize("Hi", voice=voice)
        assert rate == 24000
        np.testing.assert_array_equal(w, want)


def test_server_loads_and_removes_a_tts_directory(tts, tmp_path):
    d = _tts_dir(tmp_path / "t", tts)
    srv = Server(port=_free_port())
    m = srv.load_model("tts", d, device="cpu")
    m.max_frames = tts.max_frames
    srv.start_background()
    try:
        code, _, data = _post(srv, {"input": "Hi"})
        assert code == 200 and m.dir == d
        np.testing.assert_array_equal(_read_wav(data)[1],
                                      _pcm(tts.synthesize("Hi")[0]))
        closed = []
        m.close = lambda: closed.append(True)
        srv.remove_model("tts")
        assert closed == [True] and "tts" not in srv.models
    finally:
        srv.shutdown()


def test_speak_command_line(tts, tmp_path, monkeypatch, capsys):
    """``speak.main`` (``python -m ominix_mlx_tpu_torch.speak``) writes the
    loaded model's samples and their WSOLA stretch with ``--speed``; the
    loader is wrapped to bound the random model at 5 frames."""
    from ominix_mlx_tpu_torch import speak
    from ominix_mlx_tpu_torch.audio.io import load_wav

    d = _tts_dir(tmp_path / "t", tts)
    m = qwen3_tts.load_model(d, device="cpu")
    m.max_frames = 5
    want, rate = m.synthesize("Hi")
    load = registry.load_pipeline

    def load_short(path, device=None):
        cap, model = load(path, device)
        assert str(device) == "cpu"
        model.max_frames = 5
        return cap, model

    monkeypatch.setattr(registry, "load_pipeline", load_short)
    for speed in (1.0, 1.5):
        out = tmp_path / f"out{speed}.wav"
        assert speak.main(["--model", d, "--text", "Hi", "--out", str(out),
                           "--speed", str(speed), "--device", "cpu"]) == 0
        assert capsys.readouterr().out.endswith(f"-> {out}\n")
        x = want if speed == 1.0 else wsola_time_stretch(want, rate, speed)
        got, grate = load_wav(str(out))
        assert grate == rate == 24000 and len(got) == len(x) > 0
        np.testing.assert_array_equal(
            (got * 32768).astype(np.int16),
            (np.clip(x, -1, 1) * 32767).astype(np.int16))


def test_speak_parses_the_reference_flags():
    """The command line takes examples/speak.py's flags and ``--device``,
    and no other."""
    from ominix_mlx_tpu_torch import speak

    a = speak.parse_args(["--model", "m", "--text", "t", "--voice", "amy",
                          "--speed", "1.2", "--play", "--device", "cpu"])
    assert (a.model, a.text, a.voice, a.out, a.speed, a.play, a.device) == (
        "m", "t", "amy", "out.wav", 1.2, True, "cpu")
    with pytest.raises(SystemExit):
        speak.parse_args(["--model", "m", "--text", "t", "--max-frames", "5"])
