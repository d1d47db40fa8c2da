"""The plain version of the dq kernel against the TPU kernels it replaces,
and the kernel's plan.

The JAX package's ``_qmm_dq`` (A3 ``_dq_kernel``: 2-16 rows, 4 and 8 bits)
and ``_qmm_vpu`` (A5 ``_vpu_kernel``: up to 64 rows, 4 bits) run here on the
CPU under ``jax.experimental.pallas.tpu.force_tpu_interpret_mode()``, on a
row-major weight the JAX package's ``prepare`` packed; the same weights go
to the port through ``utils.params.params_from_numpy`` and the same seeded
bf16 x to ``qmm_dq_reference``, the plain version of csrc/qmm_tc.cu. The
kernel itself is held to that plain version on a CUDA card by
tests/test_torch_kernels_cuda.py.

Tolerance: max error over max |TPU| < 1e-2. Both sides round bf16(d * s)
once and sum bf16 products in float32; they differ in summation order, and
the port rebuilds the 4-bit bias from its stored fold b - 8s, one bf16 ulp
of |b| + 8s off the JAX package's b at most.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ominix_mlx_tpu.core import quant as jquant
from ominix_mlx_tpu.ops import quant_matmul as jqm
from ominix_mlx_tpu_torch.ops import quant_matmul as tqm
from ominix_mlx_tpu_torch.utils.params import params_from_numpy

torch.set_num_threads(2)
TOL = 1e-2
GS = 64
N, K = 256, 512

# Qwen3-4B's projections (chip_smoke.K1_SHAPES) and Qwen3-30B-A3B's
# attention projections (hidden 2048, 32 query and 4 KV heads of 128)
PLAN_SHAPES = {"qkv_proj": (6144, 2560), "o_proj": (2560, 4096),
               "gate_up_proj": (19456, 2560), "down_proj": (2560, 9728),
               "lm_head": (151936, 2560), "moe_q_proj": (4096, 2048),
               "moe_qkv_proj": (5120, 2048), "moe_o_proj": (2048, 4096)}


def _weights(seed, bits):
    """(JAX row-major packed weight, port packed weight) of one random
    weight [N, K], quantized by the JAX package."""
    rng = np.random.default_rng(seed)
    qt = jquant.quantize_tensor(
        jnp.asarray(rng.standard_normal((N, K)).astype(np.float32) * 0.05),
        GS, bits)
    jw = jqm.prepare(qt, act_bits=None, batched=True)
    tw = params_from_numpy(
        {"q": np.asarray(qt.q), "scales": np.asarray(qt.scales, np.float32),
         "biases": np.asarray(qt.biases, np.float32), "group_size": GS,
         "bits": bits, "batched": True}, "cpu", act_bits=None)
    return jw, tw


def _x(seed, m):
    x = np.random.default_rng(seed).standard_normal((m, K))
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [2, 16])
def test_dq_reference_matches_a3_tpu_kernel(bits, M):
    """A3 (``_qmm_dq``) under the TPU interpreter against
    qmm_dq_reference, on the batched row-major weight A3 takes."""
    jw, tw = _weights(M + bits, bits)
    assert tqm.route(tw, M) == "k1_mn"
    x = _x(M, M)
    with pltpu.force_tpu_interpret_mode():
        want = jqm._qmm_dq(jnp.asarray(x), jw.data, jw.scales, jw.biases,
                           GS, K, bits, jnp.float32)
    got = tqm.qmm_dq_reference(torch.from_numpy(x.astype(np.float32))
                               .bfloat16(), tw)
    assert got.shape == (M, N)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("M", [17, 64])
def test_dq_reference_matches_a5_tpu_kernel(M):
    """A5 (``_qmm_vpu``) under the TPU interpreter against
    qmm_dq_reference (x rounded to bf16 first, as A5 does)."""
    jw, tw = _weights(M, 4)
    x = _x(M + 1, M)
    with pltpu.force_tpu_interpret_mode():
        want = jqm._qmm_vpu(jnp.asarray(x), jw.data, jw.scales, jw.biases,
                            GS, 4, K, jnp.float32)
    got = tqm.qmm_dq_reference(torch.from_numpy(x.astype(np.float32))
                               .bfloat16(), tw, raw_sums=False)
    assert got.shape == (M, N)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("shape", list(PLAN_SHAPES))
@pytest.mark.parametrize("M", [1, 2, 16, 17, 64])
@pytest.mark.parametrize("bits", [4, 8])
def test_dq_plan_covers_k_and_fills_the_card(shape, M, bits):
    """dq_plan's slices cover K exactly in whole groups and whole pipeline
    steps; K stays whole where the 64-row tiles of N fill the card's SMs
    and x over all of K fits shared memory, and is split where the tiles
    do not fill it; every CTA fits shared memory and the CTAs fit one
    wave."""
    n, k = PLAN_SHAPES[shape]
    p = tqm.dq_plan(M, n, k, GS, bits)
    assert p.mp >= M and p.mp in (8, 16, 32, 64)
    assert p.k_slice % GS == 0 and p.k_slice % tqm.DQ_STEP_K == 0
    assert (p.splits - 1) * p.k_slice < k <= p.splits * p.k_slice
    assert tqm.dq_smem(p.mp, p.warpgroups, p.k_slice, GS, bits) \
        <= tqm.DQ_SMEM_MAX
    tiles = -(-n // tqm.DQ_TILE_N)
    ctas = p.splits * -(-tiles // (p.warpgroups * p.tiles))
    assert ctas <= tqm.SMS
    step = tqm.DQ_STEP_K
    whole_fits = tqm.dq_smem(p.mp, 1, -(-k // step) * step, GS, bits) \
        <= tqm.DQ_SMEM_MAX
    if tiles >= tqm.SMS and whole_fits:
        assert p.splits == 1
    if tiles < tqm.SMS:
        assert p.splits > 1 and tiles * p.splits >= min(
            tqm.SMS, tiles * -(-k // step))


def test_dq_plan_rejects_what_the_kernel_does_not_take():
    for M, k, gs in ((0, 512, 64), (65, 512, 64), (2, 500, 64),
                     (2, 512, 48)):
        with pytest.raises(ValueError):
            tqm.dq_plan(M, 256, k, gs)
