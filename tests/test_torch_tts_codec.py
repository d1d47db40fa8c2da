"""The port's Qwen3-TTS codec decoder, its layers and the speech encoder
against the JAX package's on the CPU, at tiny widths, the same seeded
weights in both (made by the port's ``init_*``, carried as numpy), inputs
seeded numpy, float32:

  - ``snake_beta``, ``causal_conv1d`` (dilated), ``convnext_block``:
    1e-5 of the largest magnitude;
  - ``conv_transpose1d`` at K = 2 s for s in 2, 3, 4, 5, 8, with and
    without padding (the weight's permutation derived here, not taken on
    trust: neither the flipped kernel nor the other channel order gives
    the JAX package's) and ``causal_conv_transpose1d``: 1e-5;
  - ``codec_decode`` with and without a sliding window: 1e-4 (float32
    convolutions and attention summed in other orders), control ids past
    the codebook clamped as the JAX gather clamps them;
  - ``rvq_encode``: ids equal; ``speech_encode`` of a seeded clip: codes
    equal, and its frame count the product of the strides and 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.models import base as jbase
from ominix_mlx_tpu.models import qwen3_tts as jqt
from ominix_mlx_tpu.nn import layers as jlayers
from ominix_mlx_tpu_torch.models import qwen3_tts as qt
from ominix_mlx_tpu_torch.nn import layers

torch.set_num_threads(2)

CODEC = dict(frame_dim=32, up_strides=(2,), dec_strides=(2, 2),
             codec_vocab=32)


def _np(tree):
    """A tree of tensors -> the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def codec():
    dec, cfg = qt.init_codec(torch.Generator().manual_seed(1), **CODEC,
                             device="cpu")
    rng = np.random.default_rng(7)
    # non-trivial SnakeBeta parameters and biases
    dec = jax.tree_util.tree_map(
        lambda a: (a * rng.uniform(0.5, 1.5, size=a.shape)).astype(
            np.float32), _np(dec))
    return jax.tree_util.tree_map(jnp.asarray, dec), cfg, \
        qt.from_numpy(dec, "cpu")


def test_snake_beta_matches_jax():
    rng = np.random.default_rng(1)
    p = {"alpha_exp": rng.uniform(0.5, 2, (1, 1, 6)).astype(np.float32),
         "beta_exp": rng.uniform(0.5, 2, (1, 1, 6)).astype(np.float32)}
    x = rng.normal(size=(2, 9, 6)).astype(np.float32)
    want = jqt.snake_beta(jax.tree_util.tree_map(jnp.asarray, p),
                          jnp.asarray(x))
    got = layers.snake_beta({k: _t(v) for k, v in p.items()}, _t(x))
    assert _rel(got, want) < 1e-5
    # bf16 in, float32 inside, bf16 out
    xb = _t(x).bfloat16()
    assert layers.snake_beta({k: _t(v) for k, v in p.items()},
                             xb).dtype == torch.bfloat16


def _conv(rng, cout, k, cin):
    return {"w": rng.normal(size=(cout, k, cin)).astype(np.float32) * 0.2,
            "b": rng.normal(size=(cout,)).astype(np.float32)}


@pytest.mark.parametrize("s", [2, 3, 4, 5, 8])
def test_conv_transpose1d_matches_jax_at_k_2s(s):
    """PyTorch's conv_transpose1d with weight w.permute(2, 0, 1) is the
    JAX package's lax.conv_transpose(transpose_kernel=True, "IHO") on the
    MLX [C_out, K, C_in] weight, at K = 2 s (the codec's upsamplers), with
    and without padding; neither the spatial flip nor the other channel
    order gives it."""
    rng = np.random.default_rng(s)
    p = _conv(rng, 5, 2 * s, 3)
    x = rng.normal(size=(2, 7, 3)).astype(np.float32)
    jpp = {k: jnp.asarray(v) for k, v in p.items()}
    for pad in (0, 1):
        want = jlayers.conv_transpose1d(jpp, jnp.asarray(x), stride=s,
                                        padding=pad)
        assert want.shape == (2, 6 * s + 2 * s - 2 * pad, 5)
        got = layers.conv_transpose1d({k: _t(v) for k, v in p.items()},
                                      _t(x), stride=s, padding=pad)
        assert _rel(got, want) < 1e-5
    # on square channels: neither the flipped kernel nor the other
    # channel order computes it
    sq = _conv(rng, 4, 2 * s, 4)
    xs = rng.normal(size=(1, 5, 4)).astype(np.float32)
    want = jlayers.conv_transpose1d({"w": jnp.asarray(sq["w"])},
                                    jnp.asarray(xs), stride=s)
    w = _t(sq["w"])
    for wrong in (w.permute(2, 0, 1).flip(-1), w.permute(0, 2, 1)):
        y = torch.nn.functional.conv_transpose1d(
            _t(xs).transpose(1, 2), wrong.contiguous(), stride=s)
        assert _rel(y.transpose(1, 2), want) > 1e-2
    got = qt.causal_conv_transpose1d({k: _t(v) for k, v in p.items()},
                                     _t(x), s)
    assert _rel(got, jqt.causal_conv_transpose1d(jpp, jnp.asarray(x), s)) \
        < 1e-5 and got.shape[1] == 7 * s


@pytest.mark.parametrize("dilation", [1, 3])
def test_causal_conv1d_matches_jax(dilation):
    rng = np.random.default_rng(dilation)
    p = _conv(rng, 6, 3, 4)
    x = rng.normal(size=(2, 11, 4)).astype(np.float32)
    want = jqt.causal_conv1d({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), dilation)
    got = qt.causal_conv1d({k: _t(v) for k, v in p.items()}, _t(x),
                           dilation)
    assert _rel(got, want) < 1e-5


def test_convnext_block_matches_jax(codec):
    dec, _, tdec = codec
    x = np.random.default_rng(2).normal(size=(1, 9, 32)).astype(np.float32)
    want = jqt.convnext_block(dec["upsample_convnext"][0], jnp.asarray(x))
    assert _rel(qt.convnext_block(tdec["upsample_convnext"][0], _t(x)),
                want) < 1e-5


@pytest.mark.parametrize("window", [None, 3])
def test_codec_decode_matches_jax(codec, window):
    """8 frames, the pre-transformer under a causal mask and under a
    sliding window of 3 frames."""
    dec, cfg, tdec = codec
    cfg = dict(cfg, sliding_window=window)
    codes = np.random.default_rng(4).integers(0, 32, (8, 16)).astype(
        np.int32)
    codes[3, 0] = 36                  # a control id: past codebook 0
    want = jax.jit(lambda d, c: jqt.codec_decode(d, c, cfg))(
        dec, jnp.asarray(codes))
    got = qt.codec_decode(tdec, _t(codes), cfg)
    assert got.shape == (8 * qt.samples_per_frame(cfg),)
    assert _rel(got, want) < 1e-4


def test_rvq_encode_matches_jax():
    rng = np.random.default_rng(9)
    book = rng.normal(size=(24, 8)).astype(np.float32)
    x = rng.normal(size=(2, 7, 8)).astype(np.float32)
    want = jqt.rvq_encode(jnp.asarray(book), jnp.asarray(x))
    assert qt.rvq_encode(_t(book), _t(x)).tolist() == \
        np.asarray(want).tolist()


def test_speech_encode_matches_jax():
    """A seeded 192-sample clip through strides (2, 3) and the 2x
    downsample: 16 frames, the 16 codebooks of each equal."""
    enc, ecfg = qt.init_speech_encoder(torch.Generator().manual_seed(3),
                                       dim=16, enc_strides=(2, 3),
                                       codec_vocab=32, device="cpu")
    tcfg = enc.pop("_tcfg")
    jenc = jax.tree_util.tree_map(jnp.asarray, _np(enc))
    jenc["_tcfg"] = jbase.TransformerConfig(
        vocab_size=1, hidden_size=16, num_layers=1, num_heads=4,
        num_kv_heads=4, head_dim=4, intermediate_size=32)
    enc["_tcfg"] = tcfg
    x = np.random.default_rng(10).normal(size=(1, 192)).astype(np.float32)
    want = jax.jit(lambda e, s: jqt.speech_encode(
        {**e, "_tcfg": jenc["_tcfg"]}, ecfg, s))(
        {k: v for k, v in jenc.items() if k != "_tcfg"}, jnp.asarray(x))
    got = qt.speech_encode(enc, ecfg, _t(x))
    assert tuple(got.shape) == (1, 192 // (2 * 3 * 2), 16)
    assert got.tolist() == np.asarray(want).tolist()
