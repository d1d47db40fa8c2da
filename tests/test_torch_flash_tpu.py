"""The plain versions of K2 and K2c against the TPU flash kernel itself.

The JAX package's ``flash_prefill`` (A2 ``_flash``) and
``flash_chunk_prefill`` (A2c ``_flash_chunk``) run the library Pallas TPU
flash kernel, here on the CPU under
``jax.experimental.pallas.tpu.force_tpu_interpret_mode()``; the same seeded
bf16 inputs go to the port's ``flash_prefill_reference`` and
``flash_chunk_reference``. Shapes are multiples of 128, as the library
kernel takes them. The kernels K2/K2c themselves are held to these plain
versions on a CUDA card by tests/test_torch_kernels_cuda.py.

Tolerance: max error over max |TPU| < 1e-2, about one bf16 ulp of the
output. Both sides feed the products bf16(q * scale) and sum in float32,
but the TPU kernel rounds its softmax weights to bf16 against each key
block's running max, which no dense version reproduces; the plain
versions keep them in float32 (3.4e-3 to 6.6e-3 at these shapes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ominix_mlx_tpu.ops import flash_attention as jfa
from ominix_mlx_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)
TOL = 1e-2


def _qkv(seed, H, Hkv, Tq, S, D):
    """bf16-valued unit-variance q [1, H, Tq, D] and k/v [1, Hkv, S, D]."""
    rng = np.random.default_rng(seed)
    return [np.asarray(jnp.asarray(rng.standard_normal(shape), jnp.bfloat16))
            for shape in ((1, H, Tq, D), (1, Hkv, S, D), (1, Hkv, S, D))]


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("H,Hkv", [(4, 2), (8, 1)])
@pytest.mark.parametrize("T", [128, 256])
def test_flash_prefill_reference_matches_tpu_kernel(T, H, Hkv, D):
    """A2 under the TPU interpreter against K2's plain version."""
    q, k, v = _qkv(T + H + D, H, Hkv, T, T, D)
    scale = D ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_prefill(*(jnp.asarray(a) for a in (q, k, v)), scale)
    got, _ = tfa.flash_prefill_reference(
        *(torch.from_numpy(a.astype(np.float32)).bfloat16()
          for a in (q, k, v)), scale)
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("H,Hkv,D", [(4, 2, 64), (8, 1, 128)])
@pytest.mark.parametrize("pos", [128, 256])
def test_flash_chunk_reference_matches_tpu_kernel(pos, H, Hkv, D):
    """A2c (two library calls merged by LSE) under the TPU interpreter
    against K2c's plain version: a 128-query chunk at pos over pos + 128
    keys."""
    T = 128
    q, k, v = _qkv(pos + H + D, H, Hkv, T, pos + T, D)
    scale = D ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_chunk_prefill(
            *(jnp.asarray(a) for a in (q, k, v)), pos, scale)
    got, _ = tfa.flash_chunk_reference(
        *(torch.from_numpy(a.astype(np.float32)).bfloat16()
          for a in (q, k, v)), pos, scale)
    assert _rel(got, want) < TOL
