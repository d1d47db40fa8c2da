"""The port's Qwen3-ASR against the JAX package's on the CPU, at tiny
widths (the JAX tests' encoder, a 2-layer Qwen3 decoder), the JAX trees
carried across by ``qwen3_asr.from_numpy``, inputs seeded numpy,
float32:

  - ``out_length``, ``sinusoid_positions``: equal;
  - the AuT ``encode`` on full and partial chunks, one window and
    several: 1e-4 of the largest magnitude (float32 convolutions and
    attention summed in other orders, through 2 layers);
  - greedy ``transcribe_embeds`` (with and without a stop token),
    ``transcribe`` from raw samples, ``ASRAdapter`` (resampling from 8
    kHz), and a checkpoint directory: token ids equal. The port's prefill
    runs ``fresh_prefill=True`` (kernel K2 on CUDA; on the CPU the same
    masked sdpa as the JAX call), the same function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.models import base as jbase
from ominix_mlx_tpu.models import qwen3_asr as jasr
from ominix_mlx_tpu.serving import adapters as jadapters
from ominix_mlx_tpu.utils import loading as jloading
from ominix_mlx_tpu_torch.models import base
from ominix_mlx_tpu_torch.models import qwen3_asr as asr
from ominix_mlx_tpu_torch.serving import adapters

torch.set_num_threads(2)

ENC = dict(num_mel_bins=32, encoder_layers=2, encoder_attention_heads=4,
           encoder_ffn_dim=64, d_model=32, output_dim=48,
           downsample_hidden_size=16, n_window=50, n_window_infer=200)
LM = dict(vocab_size=64, hidden_size=48, num_layers=2, num_heads=4,
          num_kv_heads=2, head_dim=12, intermediate_size=64,
          use_qk_norm=True, tie_word_embeddings=True)
PROMPT = ([1, 5, 9], [2, 7])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    want = np.asarray(want)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def pair():
    ecfg = jasr.AudioEncoderConfig(**ENC)
    lcfg = jbase.TransformerConfig(**LM)
    ep = jasr.init_encoder_params(ecfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    ep = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + rng.normal(
            scale=0.05, size=a.shape).astype(np.float32)), ep)
    lp = jbase.init_params(lcfg, jax.random.PRNGKey(2), jnp.float32)
    jm = jasr.Qwen3ASR(ep, ecfg, lp, lcfg)
    tm = asr.from_numpy(_np(ep), _np(lp), asr.AudioEncoderConfig(**ENC),
                        base.TransformerConfig(**LM), "cpu")
    return jm, tm


def test_length_and_positions_are_the_jax_ones():
    for n in (1, 50, 99, 100, 101, 250, 3000, 3017):
        assert asr.out_length(n) == jasr.out_length(n)
    np.testing.assert_array_equal(asr.sinusoid_positions(20, 16),
                                  jasr.sinusoid_positions(20, 16))


@pytest.mark.parametrize("n_frames", [100, 137, 250, 400])
def test_encode_matches_jax(pair, n_frames):
    """Full chunks (100, 400: two windows of 200 frames), partial last
    chunks (137, 250)."""
    jm, tm = pair
    pad = (-n_frames) % 100
    mel = np.random.default_rng(n_frames).normal(
        size=(ENC["num_mel_bins"], n_frames + pad)).astype(np.float32)
    want = jasr.encode(jm.enc_params, jm.enc_cfg, jnp.asarray(mel), n_frames)
    got = asr.encode(tm.enc_params, tm.enc_cfg, torch.from_numpy(mel),
                     n_frames)
    assert tuple(got.shape) == (asr.out_length(n_frames), ENC["output_dim"])
    assert _rel(got, want) < 1e-4


def _samples(n=8000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.1 * rng.normal(size=n)).astype(np.float32)


def test_encode_audio_matches_jax(pair):
    jm, tm = pair
    x = _samples(seed=1)
    assert _rel(tm.encode_audio(x), jm.encode_audio(jnp.asarray(x))) < 1e-4


@pytest.mark.parametrize("stop", [False, True])
def test_transcribe_embeds_match_jax(pair, stop):
    jm, tm = pair
    feats = np.random.default_rng(4).normal(size=(26, 48)).astype(np.float32)
    pre, suf = PROMPT
    want = jm.transcribe_embeds(jnp.asarray(feats), jnp.asarray(pre),
                                jnp.asarray(suf), max_tokens=8)
    stops = ()
    if stop:
        stops = (want[4],)
        want = jm.transcribe_embeds(jnp.asarray(feats), jnp.asarray(pre),
                                    jnp.asarray(suf), max_tokens=8,
                                    stop_tokens=stops)
    got = tm.transcribe_embeds(torch.from_numpy(feats), pre, suf,
                               max_tokens=8, stop_tokens=stops)
    assert got == want and (len(got) <= 4 if stop else len(got) == 8)


def test_transcribe_matches_jax(pair):
    jm, tm = pair
    x = _samples(seed=2)
    want = jm.transcribe(x, 16000, max_tokens=6)
    assert tm.transcribe(x, 16000, max_tokens=6) == want
    # rate is not read: the mel is a 16 kHz one either way
    assert tm.transcribe(x, 8000, max_tokens=6) == want


class _Tok:
    def decode(self, ids):
        return "|".join(map(str, ids))


def test_asr_adapter_matches_jax(pair):
    """ASRAdapter resamples to 16 kHz (the port's native resampler, bit for
    bit the JAX package's), encodes, decodes to a stop token."""
    jm, tm = pair
    x = _samples(4000, seed=6)
    pre, suf = PROMPT
    ja = jadapters.ASRAdapter(jm, _Tok(), pre, suf, stop_tokens=(3,))
    ta = adapters.ASRAdapter(tm, _Tok(), pre, suf, stop_tokens=(3,))
    assert ta.transcribe(x, 8000) == ja.transcribe(x, 8000)


def test_load_model_from_a_checkpoint_directory(pair, tmp_path):
    """The canonical format written by the JAX package (encoder.* in its
    OHWI convolutions, llm.*) loads through the port to the same text."""
    jm, _ = pair
    raw = {"model_type": "qwen3_asr", "audio_encoder_conf": ENC,
           "text_config": {"model_type": "qwen3", "vocab_size": 64,
                           "hidden_size": 48, "num_hidden_layers": 2,
                           "num_attention_heads": 4,
                           "num_key_value_heads": 2, "head_dim": 12,
                           "intermediate_size": 64,
                           "tie_word_embeddings": True}}
    jloading.save_model(str(tmp_path), raw, {"encoder": jm.enc_params,
                                             "llm": jm.lm_params})
    jl = jasr.load_model(str(tmp_path))
    tl = asr.load_model(str(tmp_path), device="cpu")
    assert tl.enc_cfg == asr.AudioEncoderConfig(**ENC)
    assert tl.lm_cfg.use_qk_norm and tl.lm_cfg.num_layers == 2
    x = _samples(seed=7)
    assert tl.transcribe(x, max_tokens=5) == jl.transcribe(x, max_tokens=5)
