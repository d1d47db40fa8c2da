"""Port parity for the causal flash prefill (kernel K2's plain version)
against the JAX package's dense ``sdpa`` with ``causal_mask(T, T, 0)``.
K2 itself is checked on a CUDA card by tests/test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.core.attention import causal_mask as jax_causal_mask
from ominix_mlx_tpu.core.attention import sdpa as jax_sdpa
from ominix_mlx_tpu_torch.ops import flash_attention as tfa
from ominix_mlx_tpu_torch.ops._build import LAUNCHES, reset_launches

torch.set_num_threads(2)


def _qkv(T, H=4, Hkv=2, D=64, B=1, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, T, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, D)).astype(np.float32))


@pytest.mark.parametrize("T", [16, 100, 256])
def test_flash_reference_matches_jax_sdpa(T):
    """float32, H/Hkv = 2: max abs < 1e-5 against the JAX dense path; the
    LSE against a numpy logsumexp of the scaled causal scores."""
    q, k, v = _qkv(T, seed=T)
    scale = 64 ** -0.5
    want = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    scale=scale,
                    mask=jax_causal_mask(T, T, jnp.zeros((), jnp.int32)))
    reset_launches()
    out, lse = tfa.flash_prefill_lse(torch.from_numpy(q),
                                     torch.from_numpy(k),
                                     torch.from_numpy(v), scale)
    assert LAUNCHES["k2"] == 0          # CPU tensors take the plain version
    assert np.max(np.abs(out.numpy() - np.asarray(want))) < 1e-5
    kk = np.repeat(k, 2, axis=1).astype(np.float64)
    s = np.einsum("bhtd,bhsd->bhts", q.astype(np.float64), kk) * scale
    s = np.where(np.tril(np.ones((T, T), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    want_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert np.max(np.abs(lse.numpy() - want_lse)) < 1e-4
    assert torch.equal(tfa.flash_prefill(torch.from_numpy(q),
                                         torch.from_numpy(k),
                                         torch.from_numpy(v), scale), out)


def test_use_flash_rule():
    """Every fresh prefill of T > 1 tokens on CUDA goes to K2, whatever its
    head dim: K2's wrapper raises for a head dim it does not take (before
    anything is built), so the card never runs a quiet dense path."""
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    assert not tfa.use_flash(128, cpu)           # CPU: dense sdpa, as JAX
    assert tfa.use_flash(2, gpu) and tfa.use_flash(777, gpu)
    assert not tfa.use_flash(1, gpu)
    q = torch.zeros(1, 4, 8, 96, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tfa._k2(q, q[:, :2], q[:, :2], 0.1)
