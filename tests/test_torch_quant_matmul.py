"""Port parity for the quantized matmul (kernel K1's plain version), the
packed layout and the quantized embedding: the same seeded numpy inputs go
through ominix_mlx_tpu (the reference, on CPU) and ominix_mlx_tpu_torch.
K1 itself is checked on a CUDA card by tests/test_torch_kernels_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.core.quant import quantize_tensor as jax_quantize_tensor
from ominix_mlx_tpu.ops import quant_matmul as jqm
from ominix_mlx_tpu_torch.core.quant import QuantizedTensor, dequantize
from ominix_mlx_tpu_torch.ops import _build
from ominix_mlx_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(2)

N, K, GS = 384, 512, 64
EPS = 1e-6


def _bf16(a) -> np.ndarray:
    """Round to bf16 and widen back to float32 (numpy)."""
    return np.asarray(a, np.float32).astype(jnp.bfloat16).astype(np.float32)


def _weights(seed=0, n=N, k=K):
    """A JAX transposed-panel (tn) weight, as the JAX main path holds it,
    and the port's packed weight built from its canonical numpy form."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.05
    jt = jqm.to_panels_t(jqm.prepare(jax_quantize_tensor(jnp.asarray(w), GS,
                                                         4)))
    assert jt.tn, "shape must take the JAX main-path tn layout"
    qt = jqm.unpack(jt)
    tt = QuantizedTensor(
        q=torch.from_numpy(np.array(qt.q)),
        scales=torch.from_numpy(np.asarray(qt.scales, np.float32)).bfloat16(),
        biases=torch.from_numpy(np.asarray(qt.biases, np.float32)).bfloat16(),
        group_size=GS, bits=4)
    return jt, tt


def _rel(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def test_prepare_unpack_roundtrip_exact():
    _, tt = _weights()
    for act_bits in (8, None):
        pq = tqm.prepare(tt, act_bits=act_bits)
        assert pq.data.dtype == torch.uint8
        assert tuple(pq.data.shape) == (N, K // 2)
        rt = tqm.unpack(pq)
        assert torch.equal(rt.q, tt.q)
        assert torch.equal(rt.scales, tt.scales)
        assert torch.equal(rt.biases, tt.biases)


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("M", [1, 4, 16, 32])
def test_a16_matches_jax(M, norm):
    """Exact path (act_bits=None) against the JAX package's quantized_matmul
    on CPU (exact dequant, _dense_tn). Tolerance rel < 1e-2: bf16 rounding
    of the dequantised weights and of the output, summed in another
    order."""
    jt, tt = _weights(1)
    pq = tqm.to_panels(tqm.prepare(tt, act_bits=None))
    assert pq.panels
    rng = np.random.default_rng(2)
    x = _bf16(rng.standard_normal((M, K)))
    nw = _bf16(1.0 + 0.1 * rng.standard_normal(K)) if norm else None
    kw = {} if nw is None else {"norm_w": jnp.asarray(nw, jnp.bfloat16),
                                "norm_eps": EPS}
    want = jqm.quantized_matmul(jnp.asarray(x, jnp.bfloat16), jt, **kw)
    tkw = {} if nw is None else {"norm_w": torch.from_numpy(nw).bfloat16(),
                                 "norm_eps": EPS}
    got = tqm.quantized_matmul(torch.from_numpy(x).bfloat16(), pq, **tkw)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, N)
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < 1e-2


@pytest.mark.parametrize("norm", [False, True])
def test_a8_matches_jax(norm):
    """w4a8 at M=1 against the JAX package's exact CPU path: rel < 0.05,
    the a8 tolerance of tests/test_quant_ops.py."""
    jt, tt = _weights(3)
    pq = tqm.to_panels(tqm.prepare(tt, act_bits=8))
    rng = np.random.default_rng(4)
    x = _bf16(rng.standard_normal((1, K)))
    nw = _bf16(1.0 + 0.1 * rng.standard_normal(K))
    jkw = {"norm_w": jnp.asarray(nw, jnp.bfloat16), "norm_eps": EPS} \
        if norm else {}
    tkw = {"norm_w": torch.from_numpy(nw).bfloat16(), "norm_eps": EPS} \
        if norm else {}
    want = jqm.quantized_matmul(jnp.asarray(x, jnp.bfloat16), jt, **jkw)
    got = tqm.quantized_matmul(torch.from_numpy(x).bfloat16(), pq, **tkw)
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) < 0.05


def _tpu_pt_a8(x, nw, pt):
    """numpy transcription of the TPU M=1 w4a8 kernel (_pt_kernel with
    act_ik, int8_mxu and fuse_norm; quant_matmul.py:771-827, 914-927),
    reading the JAX tn layout directly: pre-XORed bytes, per-K-half group
    rows padded to g2p, biases folded to b - 8s."""
    f32 = np.float32
    data = np.asarray(pt.data)                         # [NCH, Kd, TN] int8
    NCH, Kd, TN = data.shape
    Kc, G2, g2p = Kd, K // GS // 2, pt.g2p
    byte = data.view(np.uint8) ^ np.uint8(0x80)
    lo = (byte & 15).astype(f32)                       # columns 0..Kc-1
    hi = (byte >> 4).astype(f32)                       # columns Kc..K-1
    sc = np.asarray(pt.scales, f32)                    # [NCH, 2*g2p, TN]
    bs = np.asarray(pt.biases, f32)
    xl, xh = x[:Kc].astype(f32), x[Kc:].astype(f32)
    inv = f32(1.0) / np.sqrt((np.sum(xl * xl, dtype=f32)
                              + np.sum(xh * xh, dtype=f32)) / f32(K)
                             + f32(EPS), dtype=f32)
    xl = _bf16(_bf16(xl * inv) * nw[:Kc])
    xh = _bf16(_bf16(xh * inv) * nw[Kc:])
    sx = f32(max(np.abs(xl).max(), np.abs(xh).max()) / f32(127.0)
             + f32(1e-12))
    cxl, cxh = np.round(xl / sx), np.round(xh / sx)
    y = np.zeros(NCH * TN, f32)
    for p in range(NCH):
        PA = (cxl.reshape(G2, GS, 1) * lo[p].reshape(G2, GS, TN)).sum(1)
        PB = (cxh.reshape(G2, GS, 1) * hi[p].reshape(G2, GS, TN)).sum(1)
        SP = sc[p, :G2] * PA + sc[p, g2p:g2p + G2] * PB   # [G2, TN]
        o = SP.sum(0, dtype=f32) * sx
        xg = _bf16(np.concatenate([xl.reshape(G2, GS).sum(1),
                                   xh.reshape(G2, GS).sum(1)]))
        bpan = np.concatenate([bs[p, :G2], bs[p, g2p:g2p + G2]])
        y[p * TN:(p + 1) * TN] = o + xg @ bpan
    return _bf16(y)


def test_a8_reference_is_the_tpu_formula():
    """The port's a8 plain version computes what the TPU kernel computes
    (not merely something close): rel < 1e-3 against a numpy
    transcription of _pt_kernel, from the same weights."""
    jt, tt = _weights(5)
    pq = tqm.prepare(tt, act_bits=8)
    rng = np.random.default_rng(6)
    x = _bf16(rng.standard_normal(K))
    nw = _bf16(1.0 + 0.1 * rng.standard_normal(K))
    want = _tpu_pt_a8(x, nw, jt)
    got = tqm.qmm_p_reference(
        torch.from_numpy(x[None]).bfloat16(), pq,
        torch.from_numpy(nw).bfloat16(), EPS)
    assert _rel(got[0].float().numpy(), want) < 1e-3


def test_gather_rows_matches_jax():
    """Quantized embedding lookup: equal to the JAX package's gather_rows
    on the tn layout, exactly (same float32 dequant, one bf16 rounding)."""
    jt, tt = _weights(7)
    pq = tqm.prepare(tt)
    toks = np.array([[0, 5, 383], [17, 17, 200]])
    want = np.asarray(jqm.gather_rows(jt, jnp.asarray(toks)), np.float32)
    got = tqm.gather_rows(pq, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 3, K)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # and the dense dequant of the canonical form agrees row for row
    ref = dequantize(tt, torch.bfloat16)[torch.from_numpy(toks)]
    assert _rel(got.float(), ref.float()) < 1e-2


def test_cpu_dispatch_counts_no_launch():
    """On CPU the wrapper runs the plain version of every route (panels,
    row-major, batched) and counts no launch."""
    _, tt = _weights(8, n=128, k=256)
    _build.reset_launches()
    routes = set()
    for pq in (tqm.to_panels(tqm.prepare(tt)), tqm.prepare(tt),
               tqm.prepare(tt, act_bits=None),
               tqm.prepare(tt, batched=True)):
        for M in (1, 4, 40):
            tqm.quantized_matmul(torch.zeros(M, 256, dtype=torch.bfloat16),
                                 pq)
            routes.add(tqm.route(pq, M))
    assert routes == {"k1", "k1_mn", "k6", "k7", "dense"}
    assert sum(_build.LAUNCHES.values()) == 0
