"""The port's ECAPA-TDNN speaker encoder and Qwen3-TTS cloning from a
reference clip against the JAX package's on the CPU, at tiny widths, the
same seeded weights in both (made by the port's ``init_*``, carried as
numpy), inputs seeded numpy, float32:

  - ``speaker_encoder`` on two clips of 40 frames and one of 80: the
    x-vectors within 1e-4 of the largest magnitude (float32 convolutions,
    softmax and square roots summed in other orders);
  - ``params_from_flat`` (PyTorch's Conv1d layout [out, in, k]): the JAX
    package's tree, and the port's ``init_params`` tree back;
  - ``Synthesizer.synthesize_voice_clone`` from a reference mel (the
    speaker encoder's x-vector in the prefill's speaker slot) and
    reference samples (the speech encoder's codes, teacher-forced): code
    for code against the JAX package's clone given the JAX encoders'
    x-vector and codes, at least 3 frames (asserted, so an immediate EOS
    cannot pass).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.models import base as jbase
from ominix_mlx_tpu.models import qwen3_tts as jqt
from ominix_mlx_tpu.models import speaker_encoder as jse
from ominix_mlx_tpu_torch.models import base
from ominix_mlx_tpu_torch.models import qwen3_tts as qt
from ominix_mlx_tpu_torch.models import speaker_encoder as se

torch.set_num_threads(2)

SPK = dict(mel_dim=16, enc_dim=64, enc_channels=(24, 24, 24, 24, 48),
           enc_kernel_sizes=(5, 3, 3, 3, 1), enc_dilations=(1, 2, 3, 4, 1),
           enc_attention_channels=8, enc_res2net_scale=4, enc_se_channels=8)
BODY = dict(vocab_size=1, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, head_dim=16, intermediate_size=96)
TALK = dict(codec_vocab_size=32, codec_head_size=40, num_code_groups=16,
            text_vocab_size=128, text_embed_dim=48, cp_hidden=32,
            cp_layers=1, cp_heads=2, codec_eos_id=33, codec_pad_id=34,
            codec_bos_id=35, tts_pad_token_id=100)
JTINY = jqt.TalkerConfig(transformer=jbase.TransformerConfig(**BODY), **TALK)
TINY = qt.TalkerConfig(transformer=base.TransformerConfig(**BODY), **TALK)
ENC_STRIDES = (2, 3)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, _np(tree))


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def spk():
    """Random encoder weights, the biases made non-zero."""
    p = se.init_params(se.SpeakerEncoderConfig(**SPK), _gen(0),
                       device="cpu")
    rng = np.random.default_rng(1)
    p = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(scale=0.05, size=a.shape)).astype(
            np.float32), _np(p))
    return _jnp(p), jax.tree_util.tree_map(torch.from_numpy, p)


JAX_SPEAKER = jax.jit(lambda p, m: jse.speaker_encoder(
    p, jse.SpeakerEncoderConfig(**SPK), m))


@pytest.mark.parametrize("B,T", [(2, 40), (1, 80)])
def test_speaker_encoder_matches_jax(spk, B, T):
    jp, tp = spk
    mel = np.random.default_rng(T).normal(size=(B, T, 16)).astype(
        np.float32)
    want = JAX_SPEAKER(jp, jnp.asarray(mel))
    got = se.speaker_encoder(tp, se.SpeakerEncoderConfig(**SPK),
                             torch.from_numpy(mel))
    assert tuple(got.shape) == (B, 64)
    assert _rel(got, want) < 1e-4


def _flat(tree, prefix="speaker_encoder"):
    """The tree in PyTorch's names and Conv1d layout [out, in, k]."""
    flat = {}

    def conv(name, p):
        flat[f"{prefix}.{name}.weight"] = np.ascontiguousarray(
            np.transpose(np.asarray(p["w"]), (0, 2, 1)))
        flat[f"{prefix}.{name}.bias"] = np.asarray(p["b"])

    conv("blocks.0.conv", tree["tdnn0"])
    for i, blk in zip((1, 2, 3), tree["blocks"]):
        conv(f"blocks.{i}.tdnn1.conv", blk["tdnn1"])
        for j, b in enumerate(blk["res2net"]["blocks"]):
            conv(f"blocks.{i}.res2net_block.blocks.{j}.conv", b)
        conv(f"blocks.{i}.tdnn2.conv", blk["tdnn2"])
        conv(f"blocks.{i}.se_block.conv1", blk["se"]["conv1"])
        conv(f"blocks.{i}.se_block.conv2", blk["se"]["conv2"])
    conv("mfa.conv", tree["mfa"])
    conv("asp.tdnn.conv", tree["asp"]["tdnn"])
    conv("asp.conv", tree["asp"]["conv"])
    conv("fc", tree["fc"])
    return flat


def test_params_from_flat_matches_jax(spk):
    _, tp = spk
    cfg = se.SpeakerEncoderConfig(**SPK)
    flat = _flat(tp)
    got = se.params_from_flat({k: torch.from_numpy(v)
                               for k, v in flat.items()}, cfg)
    want = jse.params_from_flat(flat, jse.SpeakerEncoderConfig(**SPK))
    gl, gs = jax.tree_util.tree_flatten(_np(got))
    wl, ws = jax.tree_util.tree_flatten(want)
    tl, _ = jax.tree_util.tree_flatten(_np(tp))
    assert gs == ws and len(gl) == len(wl) == len(tl)
    for g, w, t in zip(gl, wl, tl):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(g, t)


@pytest.fixture(scope="module")
def cloners(spk):
    """(the JAX Synthesizer, the port's with its speaker and speech
    encoders, the JAX speech encoder and its jitted encode)."""
    jspk, tspk = spk
    tp = qt.init_params(TINY, _gen(2), device="cpu")
    tp["codec_head"]["w"] *= 4
    enc, ecfg = qt.init_speech_encoder(_gen(3), dim=16,
                                       enc_strides=ENC_STRIDES,
                                       codec_vocab=32, device="cpu")
    jcfg = jbase.TransformerConfig(
        vocab_size=1, hidden_size=16, num_layers=1, num_heads=4,
        num_kv_heads=4, head_dim=4, intermediate_size=32)
    jenc = _jnp({k: v for k, v in enc.items() if k != "_tcfg"})
    encode = jax.jit(lambda e, s: jqt.speech_encode(
        {**e, "_tcfg": jcfg}, ecfg, s))
    ts = qt.Synthesizer(qt.from_numpy(_np(tp), "cpu"), TINY,
                        spk_params=tspk,
                        spk_cfg=se.SpeakerEncoderConfig(**SPK),
                        speech_enc=enc, speech_enc_cfg=ecfg)
    return jqt.Synthesizer(_jnp(tp), JTINY), ts, \
        lambda x: np.asarray(encode(jenc, jnp.asarray(x)[None])[0])


def test_voice_clone_from_a_reference_clip_matches_jax(spk, cloners):
    """A 48-sample reference (4 frames of codes through strides (2, 3)
    and the downsample) and a 30-frame mel: the port's clone from the mel
    and samples against the JAX clone given the JAX encoders' x-vector
    and codes, code for code over 3 frames."""
    jspk, _ = spk
    js, ts, jax_codes = cloners
    rng = np.random.default_rng(11)
    samples = rng.normal(scale=0.3, size=48).astype(np.float32)
    mel = rng.normal(size=(30, 16)).astype(np.float32)
    ref = jax_codes(samples)
    assert ref.shape == (4, 16)
    np.testing.assert_array_equal(ts.encode_reference(samples), ref)
    xvec = np.asarray(JAX_SPEAKER(jspk, jnp.asarray(mel)[None])[0])
    assert _rel(ts.encode_speaker(mel), xvec) < 1e-4
    want = js.synthesize_voice_clone([5, 9], [11, 3, 7], ref_codes=ref,
                                     spk_embed=jnp.asarray(xvec),
                                     max_frames=3)
    got = ts.synthesize_voice_clone([5, 9], [11, 3, 7], ref_mel=mel,
                                    ref_samples=samples, max_frames=3)
    assert want.frames == 3 and got.frames == want.frames
    np.testing.assert_array_equal(got.codes, want.codes)
