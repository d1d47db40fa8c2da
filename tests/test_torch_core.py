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


@pytest.mark.parametrize("traditional,factor", [(False, 1.0), (True, 0.5)])
def test_apply_rope_matches_jax(traditional, factor):
    """float32 max abs < 1e-5 (same cos/sin formula), at positions far
    from zero."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 7, 64)).astype(np.float32)
    pos = np.arange(7) + 1000
    jcfg = jrope.make_rope(64, 1e6, partial_rotary_factor=factor,
                           traditional=traditional)
    tcfg = trope.make_rope(64, 1e6, partial_rotary_factor=factor,
                           traditional=traditional)
    assert tcfg == trope.RopeConfig(jcfg.dims, jcfg.theta, jcfg.scale,
                                    jcfg.traditional)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jcfg)
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tcfg)
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < 1e-5


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
    tc = tcache.KVCache.init(1, 2, 10, 8, torch.float32)
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
    """The port imports neither jax nor the JAX package, even indirectly."""
    code = ("import sys, ominix_mlx_tpu_torch.serving.server, "
            "ominix_mlx_tpu_torch.models.qwen3, "
            "ominix_mlx_tpu_torch.utils.params; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'ominix_mlx_tpu.')) or "
            "m == 'ominix_mlx_tpu']; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=pathlib.Path(__file__).resolve().parent.parent)
    assert r.returncode == 0, r.stdout + r.stderr
