"""Port parity for the core pieces (rms_norm, RoPE, masks and sdpa, the
KV cache, the sampler) against the JAX package on the same seeded numpy
inputs, and the import hygiene of the port."""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.core import attention as jatt
from ominix_mlx_tpu.core import cache as jcache
from ominix_mlx_tpu.core import rope as jrope
from ominix_mlx_tpu.core import sampling as jsamp
from ominix_mlx_tpu.nn import layers as jlayers
from ominix_mlx_tpu_torch.core import attention as tatt
from ominix_mlx_tpu_torch.core import cache as tcache
from ominix_mlx_tpu_torch.core import quant as tquant
from ominix_mlx_tpu_torch.core import rope as trope
from ominix_mlx_tpu_torch.core import sampling as tsamp
from ominix_mlx_tpu_torch.nn import layers as tlayers

torch.set_num_threads(2)


def test_rms_norm_matches_jax():
    """float32 max abs < 1e-6; bf16 (the model's type) equal except for
    rare one-ulp rounding ties (rel < 1e-2)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 256)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    want = jlayers.rms_norm(jnp.asarray(w), jnp.asarray(x), 1e-6)
    got = tlayers.rms_norm(torch.from_numpy(w), torch.from_numpy(x), 1e-6)
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < 1e-6
    wb = jlayers.rms_norm(jnp.asarray(w, jnp.bfloat16),
                          jnp.asarray(x, jnp.bfloat16), 1e-6)
    gb = tlayers.rms_norm(torch.from_numpy(w).bfloat16(),
                          torch.from_numpy(x).bfloat16(), 1e-6)
    assert gb.dtype == torch.bfloat16
    d = np.abs(gb.float().numpy() - np.asarray(wb, np.float32))
    assert d.max() / np.abs(np.asarray(wb, np.float32)).max() < 1e-2


def _rope64(x, pos, dims, theta, traditional):
    """RoPE in float64 numpy: the exact function both packages round."""
    half = dims // 2
    freqs = np.exp(-np.arange(half, dtype=np.float64) * (np.log(theta)
                                                         / half))
    ang = pos.astype(np.float64)[:, None] * freqs
    cos, sin = np.cos(ang), np.sin(ang)
    rot = x[..., :dims].astype(np.float64)
    if traditional:
        x1, x2 = rot[..., 0::2], rot[..., 1::2]
        out = np.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       -1).reshape(rot.shape)
    else:
        x1, x2 = rot[..., :half], rot[..., half:]
        out = np.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return np.concatenate([out, x[..., dims:]], -1), float(ang.max())


def _rope_bound(x, max_angle):
    """A float32 resolution bound on |RoPE_f32 - RoPE_exact|, from the unit
    roundoff u = eps / 2: the frequency exp(-i ln(theta) / half) carries
    its argument's two roundings times the argument a (at most a u for
    the product, a u for ln) plus exp's own ulp, and the angle one more
    rounding, so with ang = pos e^-a the angle is off by at most
    u ang (2 a + 2) <= 2 u pos (a e^-a + e^-a) <= 3 u max|angle|
    (a e^-a <= 1/e, e^-a <= 1); cos and sin add an ulp each, the two
    products and their sum three roundings of at most |x1| + |x2|. An
    output is |x1| cos -/+ |x2| sin, so it moves by at most
    (|x1| + |x2|) (3 u max|angle| + 4 u) <= 2 max|x| (3 u max|angle| + 4 u).
    """
    u = np.finfo(np.float32).eps / 2
    return 2 * float(np.abs(x).max()) * (3 * u * max_angle + 4 * u)


@pytest.mark.parametrize("traditional,factor", [(False, 1.0), (True, 0.5)])
def test_apply_rope_matches_jax(traditional, factor):
    """The same config, then the port's and the JAX package's float32 RoPE
    each within the float32 resolution bound (``_rope_bound``) of a
    float64 RoPE at positions 1000-1006; and the two within twice that
    bound of each other at positions 57-63. Neither rounds exactly: XLA's
    and torch's float32 exp give some frequencies one ulp apart, and one
    ulp of an angle near 1000 moves an output by about 3e-5, so a fixed
    bound below float32's resolution there passes or fails with the CPU's
    math library."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 7, 64)).astype(np.float32)
    jcfg = jrope.make_rope(64, 1e6, partial_rotary_factor=factor,
                           traditional=traditional)
    tcfg = trope.make_rope(64, 1e6, partial_rotary_factor=factor,
                           traditional=traditional)
    assert tcfg == trope.RopeConfig(jcfg.dims, jcfg.theta, jcfg.scale,
                                    jcfg.traditional)
    for pos, exact in ((np.arange(7) + 1000, True),
                       (np.arange(57, 64), False)):
        want = np.asarray(jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                           jcfg))
        got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                               tcfg).numpy()
        ref, max_angle = _rope64(x, pos, tcfg.dims, 1e6, traditional)
        bound = _rope_bound(x, max_angle)
        if exact:
            assert np.max(np.abs(got - ref)) <= bound
            assert np.max(np.abs(want - ref)) <= bound
        else:
            assert np.max(np.abs(got - want)) <= 2 * bound


def test_causal_mask_and_sdpa_match_jax():
    """Mask identical; sdpa over a part-filled cache max abs < 1e-5."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((1, 4, 3, 32)).astype(np.float32)
    k = rng.standard_normal((1, 2, 16, 32)).astype(np.float32)
    v = rng.standard_normal((1, 2, 16, 32)).astype(np.float32)
    jm = jatt.causal_mask(3, 16, jnp.int32(5), window=4)
    tm = tatt.causal_mask(3, 16, 5, window=4)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    want = jatt.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.2,
                     mask=jatt.causal_mask(3, 16, jnp.int32(5)))
    got = tatt.sdpa(torch.from_numpy(q), torch.from_numpy(k),
                    torch.from_numpy(v), 0.2,
                    mask=tatt.causal_mask(3, 16, 5))
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < 1e-5


def test_kv_cache_update_matches_jax_in_place():
    rng = np.random.default_rng(3)
    kn = rng.standard_normal((1, 2, 3, 8)).astype(np.float32)
    vn = rng.standard_normal((1, 2, 3, 8)).astype(np.float32)
    jc = jcache.KVCache.init(1, 2, 10, 8, jnp.float32).update(
        jnp.asarray(kn), jnp.asarray(vn), jnp.int32(4))
    tc = tcache.KVCache.init(1, 2, 10, 8, torch.float32, device="cpu")
    kbuf = tc.k
    out = tc.update(torch.from_numpy(kn), torch.from_numpy(vn), 4)
    assert out is tc and out.k is kbuf          # written in place
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    with pytest.raises(ValueError):
        tc.update(torch.from_numpy(kn), torch.from_numpy(vn), 8)


def test_sampling_greedy_and_filters_match_jax():
    """Greedy tokens equal; every filter keeps the same token set as the
    JAX package's (the draws themselves use other generators)."""
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 64)).astype(np.float32) * 3
    recent = np.array([[1, 2, -1], [5, 5, 7], [-1, -1, -1]])
    for pen in (1.0, 1.3):
        cfg_j = jsamp.SamplerConfig(repetition_penalty=pen)
        cfg_t = tsamp.SamplerConfig(repetition_penalty=pen)
        want = jsamp.sample(jnp.asarray(logits), None, cfg_j,
                            jnp.asarray(recent, jnp.int32))
        got = tsamp.sample(torch.from_numpy(logits), None, cfg_t,
                           torch.from_numpy(recent))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lt = torch.from_numpy(logits)
    lj = jnp.asarray(logits)
    pairs = [(tsamp.apply_top_k(lt, 5), jsamp.apply_top_k(lj, 5)),
             (tsamp.apply_top_p(lt, 0.7), jsamp.apply_top_p(lj, 0.7)),
             (tsamp.apply_min_p(lt, 0.2), jsamp.apply_min_p(lj, 0.2)),
             (tsamp.apply_repetition_penalty(lt, torch.from_numpy(recent),
                                             1.5),
              jsamp.apply_repetition_penalty(
                  lj, jnp.asarray(recent, jnp.int32), 1.5))]
    for t, j in pairs:
        np.testing.assert_array_equal(np.isfinite(t.numpy()),
                                      np.isfinite(np.asarray(j)))
        fin = np.isfinite(t.numpy())
        assert np.max(np.abs(t.numpy()[fin] - np.asarray(j)[fin])) < 1e-6
    g = torch.Generator().manual_seed(0)
    cfg = tsamp.SamplerConfig(temperature=0.8, top_k=5)
    draws = tsamp.sample(lt, g, cfg)
    allowed = torch.topk(lt, 5, -1).indices
    assert all(int(d) in allowed[i].tolist() for i, d in enumerate(draws))
    with pytest.raises(ValueError):
        tsamp.sample(lt, None, cfg)


def test_quantize_tensor_matches_jax():
    """Same codes and float32 scales/biases as the JAX quantizer."""
    from ominix_mlx_tpu.core.quant import quantize_tensor as jq
    rng = np.random.default_rng(5)
    w = rng.standard_normal((64, 256)).astype(np.float32)
    want = jq(jnp.asarray(w), 64, 4)
    got = tquant.quantize_tensor(torch.from_numpy(w), 64, 4)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    assert np.max(np.abs(got.scales.numpy()
                         - np.asarray(want.scales))) < 1e-6
    assert np.max(np.abs(got.biases.numpy()
                         - np.asarray(want.biases))) < 1e-5
    deq = tquant.dequantize(got, torch.float32)
    assert (deq - torch.from_numpy(w)).abs().max() < 0.3


def test_import_leaves_jax_out():
    """The port imports neither jax nor the JAX package, even indirectly:
    every module of the package is imported in a fresh process."""
    code = ("import sys, importlib, pkgutil, ominix_mlx_tpu_torch as p; "
            "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "'ominix_mlx_tpu_torch.')]; "
            "[importlib.import_module(m) for m in mods]; "
            "assert 'ominix_mlx_tpu_torch.serving.batching' in mods; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'ominix_mlx_tpu.')) or "
            "m == 'ominix_mlx_tpu']; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=pathlib.Path(__file__).resolve().parent.parent)
    assert r.returncode == 0, r.stdout + r.stderr
