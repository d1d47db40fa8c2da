"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA card and skips without one; the file imports
neither jax nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import dataclasses
import gc

import pytest
import torch

from ominix_mlx_tpu_torch.core.quant import QuantizedTensor
from ominix_mlx_tpu_torch.ops import _build
from ominix_mlx_tpu_torch.ops import flash_attention as fa
from ominix_mlx_tpu_torch.ops import gated_delta as gd
from ominix_mlx_tpu_torch.ops import grouped_matmul as tgmm
from ominix_mlx_tpu_torch.ops import lightning_attention as la
from ominix_mlx_tpu_torch.ops import paged_attention as pa
from ominix_mlx_tpu_torch.ops import quant_matmul as qm

pytestmark = pytest.mark.cuda
EPS = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no "
                    "CPU mode")
    return torch.device("cuda")


def _packed(dev, N, K, act_bits, seed=0, bits=4):
    g = torch.Generator(device=dev).manual_seed(seed)
    lim = 1 << (bits - 1)
    qt = QuantizedTensor(
        q=torch.randint(-lim, lim, (N, K), generator=g, device=dev,
                        dtype=torch.int8),
        scales=((torch.rand(N, K // 64, generator=g, device=dev) + 0.5)
                * K ** -0.5 / lim).bfloat16(),
        biases=(torch.randn(N, K // 64, generator=g, device=dev)
                * K ** -0.5 / 4).bfloat16(),
        group_size=64, bits=bits)
    return qm.prepare(qt, act_bits=act_bits), g


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def _row_rel(a, b):
    """max over rows (every index but the last) of max |a - b| over max
    |b| in that row."""
    a, b = a.float(), b.float()
    return ((a - b).abs().amax(-1) / b.abs().amax(-1).clamp_min(1e-12)
            ).max().item()


@pytest.mark.parametrize("N,K", [(100, 2560), (2560, 9728), (6144, 2560)])
@pytest.mark.parametrize("mode", ["a8", "a8_norm", "a16", "a16_norm"])
def test_k1_m1_matches_plain(cuda, N, K, mode):
    """K1 at M=1 (the P formula), ragged N and G=152 included: rel < 1e-2
    (bf16 output, another summation order)."""
    a8 = mode.startswith("a8")
    pq, g = _packed(cuda, N, K, 8 if a8 else None)
    x = torch.randn(1, K, generator=g, device=cuda).bfloat16()
    nw = ((1 + 0.1 * torch.randn(K, generator=g, device=cuda)).bfloat16()
          if mode.endswith("norm") else None)
    got = qm._k1(x, pq, nw, EPS)
    want = qm.qmm_p_reference(x, pq, nw, EPS)
    torch.cuda.synchronize()
    assert _rel(got, want) < 1e-2


@pytest.mark.parametrize("M", [2, 5, 16])
def test_k1_m_gt_1_matches_plain(cuda, M):
    """K1 at 2 <= M <= 16 (the dq formula) on 4-bit weights."""
    pq, g = _packed(cuda, 2560, 9728, None, seed=M)
    x = torch.randn(M, 9728, generator=g, device=cuda).bfloat16()
    got = qm._k1(x, pq)
    want = qm.qmm_dq_reference(x, pq)
    torch.cuda.synchronize()
    assert _rel(got, want) < 1e-2


@pytest.mark.parametrize("N,K", [(100, 2560), (2560, 9728)])
@pytest.mark.parametrize("M,act_bits", [(1, 8), (1, None), (2, None),
                                        (13, None), (16, None)])
def test_k1_w8_matches_plain(cuda, N, K, M, act_bits):
    """K1 on 8-bit weights: M=1 w8a8 and w8a16 (the P formula), 2..16 rows
    the dq formula, odd M included: rel < 1e-2."""
    pq, g = _packed(cuda, N, K, act_bits, seed=M, bits=8)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    _build.reset_launches()
    got = qm._k1(x, pq)
    want = (qm.qmm_p_reference(x, pq) if M == 1
            else qm.qmm_dq_reference(x, pq))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["k1_m1_w8" if M == 1 else "k1_mn_w8"] == 1
    assert _rel(got, want) < 1e-2


@pytest.mark.parametrize("N,K", [(100, 2560), (2560, 9728), (6144, 2560)])
@pytest.mark.parametrize("M", [1, 4, 13, 16])
@pytest.mark.parametrize("mode", ["w4a8", "w8a8", "w8a16"])
def test_k6_matches_plain(cuda, N, K, M, mode):
    """K6 (the P formula row by row) against qmm_p_reference: rel < 1e-2
    per row (bf16 output; a8 codes are exact, so only the float sums
    differ)."""
    bits = 4 if mode.startswith("w4") else 8
    pq, g = _packed(cuda, N, K, 8 if mode.endswith("a8") else None,
                    seed=M, bits=bits)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    _build.reset_launches()
    got = qm._k6(x, pq)
    want = qm.qmm_p_reference(x, pq)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["k6"] == 1
    assert _row_rel(got, want) < 1e-2


# (N, K) of every projection of one Qwen3-4B decode token: qkv, o,
# gate_up, down, the tied lm_head
QWEN3_4B_NK = [(6144, 2560), (2560, 4096), (19456, 2560), (2560, 9728),
               (151936, 2560)]


@pytest.mark.parametrize("N,K", QWEN3_4B_NK)
@pytest.mark.parametrize("M", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("mode", ["w4a8", "w8a8", "w8a16"])
def test_qmm_p_at_model_shapes(cuda, N, K, M, mode):
    """The P formula's kernel (K6; K1 at one row is the same launch) at
    every Qwen3-4B projection and 1-16 rows: per row within 1e-2 of
    qmm_p_reference, the same bits on a second call."""
    bits = 4 if mode.startswith("w4") else 8
    pq, g = _packed(cuda, N, K, 8 if mode.endswith("a8") else None,
                    seed=M + N, bits=bits)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    got, again = qm._k6(x, pq), qm._k6(x, pq)
    want = qm.qmm_p_reference(x, pq)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _row_rel(got, want) < 1e-2


@pytest.mark.parametrize("mode,M", [
    ("w4a16", 1), *((m, M) for m in ("w4a8", "w8a8", "w8a16")
                    for M in (1, 2, 3, 7, 13))])
def test_qmm_p_every_instantiation(cuda, monkeypatch, mode, M):
    """Every rows-a-warp template of the rows kernel at each padded row
    count (1, 2, 4, 8, 16) and a ragged N (777 rows: the last CTA's warps
    run past N): per row within 1e-2 of qmm_p_reference at one row a
    warp, and every other rows-a-warp gives the same bits (each row is
    summed in one order whatever the plan)."""
    bits, a8 = (4 if mode.startswith("w4") else 8), mode.endswith("a8")
    N, K = 777, 2560
    pq, g = _packed(cuda, N, K, 8 if a8 else None, seed=M, bits=bits)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    widths = (1, 2, 4) if M <= 4 else (1, 2) if a8 else (1,)
    # the fewest warps the plan keeps: 10**9 -> 1 row a warp, 300 -> 2
    # (389 warps of 2 rows, 195 of 4), 1 -> the most the template allows
    outs = {}
    for min_warps in (10 ** 9, 300, 1):
        monkeypatch.setattr(qm, "QMM_P_MIN_WARPS", min_warps)
        rw = qm.qmm_p_rows_per_warp(M, N, a8)
        outs[rw] = qm._k1(x, pq, None, EPS) if M == 1 else qm._k6(x, pq)
    assert sorted(outs) == list(widths)
    want = qm.qmm_p_reference(x, pq)
    torch.cuda.synchronize()
    assert _row_rel(outs[1], want) < 1e-2
    for rw in widths[1:]:
        assert torch.equal(outs[rw], outs[1]), rw


@pytest.mark.parametrize("N,K", [QWEN3_4B_NK[0], QWEN3_4B_NK[2],
                                 QWEN3_4B_NK[4]])
@pytest.mark.parametrize("a8", [True, False])
def test_k1_fused_norm_at_model_shapes(cuda, N, K, a8):
    """K1 at one row with the RMSNorm fused (w4a8 and w4a16) where
    Qwen3-4B fuses it: within 1e-2 of the plain version, repeatable."""
    pq, g = _packed(cuda, N, K, 8 if a8 else None, seed=N)
    x = torch.randn(1, K, generator=g, device=cuda).bfloat16()
    nw = (1 + 0.1 * torch.randn(K, generator=g, device=cuda)).bfloat16()
    _build.reset_launches()
    got, again = qm._k1(x, pq, nw, EPS), qm._k1(x, pq, nw, EPS)
    assert dict(_build.LAUNCHES) == {"k1_m1": 2}
    want = qm.qmm_p_reference(x, pq, nw, EPS)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _row_rel(got, want) < 1e-2


@pytest.mark.parametrize("N,K", [(100, 512), (2560, 9728), (6144, 2560)])
@pytest.mark.parametrize("M", [1, 17, 37, 64])
def test_k7_matches_plain(cuda, N, K, M):
    """K7 (exact w4a16 on the tensor cores) against qmm_dq_reference: rel
    < 1e-2 per row; ragged N and odd M included."""
    pq, g = _packed(cuda, N, K, None, seed=M)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    _build.reset_launches()
    got = qm._k7(x, pq)
    again = qm._k7(x, pq)
    want = qm.qmm_dq_reference(x, pq)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["k7"] == 2
    assert torch.equal(got, again)
    assert _row_rel(got, want) < 1e-2


# Qwen3-4B's projections (K1_SHAPES of chip_smoke.py) and a ragged N
DQ_SHAPES = [(6144, 2560), (2560, 4096), (19456, 2560), (2560, 9728),
             (151936, 2560), (100, 2560)]


@pytest.mark.parametrize("N,K", DQ_SHAPES)
@pytest.mark.parametrize("bits,M", [(4, 2), (4, 5), (4, 16), (4, 17),
                                    (4, 37), (4, 64), (8, 2), (8, 13),
                                    (8, 16)])
def test_dq_kernel_matches_plain(cuda, N, K, bits, M):
    """The dq kernel (csrc/qmm_tc.cu, the routes k1_mn, k1_mn_w8 and k7)
    against qmm_dq_reference: rel < 1e-2 per row (bf16 output, another
    summation order), whatever dq_plan splits."""
    pq, g = _packed(cuda, N, K, None, seed=M + bits, bits=bits)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    got = qm._launch_dq("dq", x, pq)
    want = qm.qmm_dq_reference(x, pq)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and torch.isfinite(got.float()).all()
    assert _row_rel(got, want) < 1e-2


@pytest.mark.parametrize("gs,K", [(96, 1056), (128, 1152), (32, 1248)])
@pytest.mark.parametrize("bits,M", [(4, 3), (4, 16), (4, 40), (8, 3),
                                    (8, 16)])
def test_dq_kernel_odd_group_counts(cuda, bits, gs, K, M):
    """Group sizes other than 64, odd group counts per row and per slice
    (G = 11, 9, 39), a ragged N: rel < 1e-2 per row against
    qmm_dq_reference."""
    N, G = 200, K // gs
    g = torch.Generator(device=cuda).manual_seed(gs + M)
    lim = 1 << (bits - 1)
    qt = QuantizedTensor(
        q=torch.randint(-lim, lim, (N, K), generator=g, device=cuda,
                        dtype=torch.int8),
        scales=((torch.rand(N, G, generator=g, device=cuda) + 0.5)
                * K ** -0.5 / lim).bfloat16(),
        biases=(torch.randn(N, G, generator=g, device=cuda)
                * K ** -0.5 / 4).bfloat16(),
        group_size=gs, bits=bits)
    pq = qm.prepare(qt, act_bits=None)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    got = qm._launch_dq("dq", x, pq)
    want = qm.qmm_dq_reference(x, pq)
    torch.cuda.synchronize()
    assert _row_rel(got, want) < 1e-2


@pytest.mark.parametrize("bits,N,K,M", [(4, 2560, 9728, 64),
                                        (4, 19456, 2560, 16),
                                        (4, 100, 512, 37),
                                        (8, 2560, 9728, 16),
                                        (8, 6144, 2560, 13)])
def test_dq_kernel_dequantizes_bit_for_bit(cuda, bits, N, K, M):
    """With the unfolded bias zero (stored b' = -8s at 4 bits, b = 0 at 8)
    and one-hot rows of x, row m of the output is column k_m of the
    dequantized weight bf16(d * s), bit for bit: the in-register rounding
    is the TPU kernels' one rounding, with or without a split of K."""
    g = torch.Generator(device=cuda).manual_seed(N + M)
    lim, G = 1 << (bits - 1), K // 64
    qt = QuantizedTensor(
        q=torch.randint(-lim, lim, (N, K), generator=g, device=cuda,
                        dtype=torch.int8),
        scales=((torch.rand(N, G, generator=g, device=cuda) + 0.5)
                * K ** -0.5 / lim).bfloat16(),
        biases=torch.zeros(N, G, device=cuda).bfloat16(),
        group_size=64, bits=bits)
    pq = qm.prepare(qt, act_bits=None)
    assert not qm.unfolded_biases(pq).float().any()
    cols = torch.randint(0, K, (M,), generator=g, device=cuda)
    x = torch.zeros(M, K, device=cuda).bfloat16()
    x[torch.arange(M, device=cuda), cols] = 1
    got = qm._launch_dq("dq", x, pq)
    d = qt.q.float()
    wd = (d.reshape(N, G, 64) * qt.scales.float()[..., None]).reshape(
        N, K).bfloat16()
    torch.cuda.synchronize()
    assert torch.equal(got, wd[:, cols].T)
    assert torch.equal(got, qm.qmm_dq_reference(x, pq))


@pytest.mark.parametrize("N,K,M,splits", [(2560, 9728, 16, 4),
                                          (19456, 2560, 16, 1)])
def test_dq_kernel_launches_are_bit_equal(cuda, N, K, M, splits):
    """Two launches on the same inputs are bit-equal, where dq_plan splits
    K (down_proj) and where it does not (gate_up): the partials are summed
    in slice order, with no atomics."""
    assert qm.dq_plan(M, N, K, 64).splits == splits
    pq, g = _packed(cuda, N, K, None, seed=3)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    a = qm._launch_dq("dq", x, pq)
    b = qm._launch_dq("dq", x, pq)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("bits", [4, 8])
def test_dq_kernel_split_agrees_with_one_slice(cuda, bits, monkeypatch):
    """o_proj at M = 16 under dq_plan (K in 4 slices) and under a plan
    forced to one slice of all of K agree within the tolerance."""
    N, K, M = 2560, 4096, 16
    plan = qm.dq_plan(M, N, K, 64, bits)
    assert plan.splits == 4
    pq, g = _packed(cuda, N, K, None, seed=5, bits=bits)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    split = qm._launch_dq("dq", x, pq)
    monkeypatch.setattr(qm, "dq_plan", lambda *a: qm.DqPlan(
        plan.mp, 1, 1, 1, K))
    whole = qm._launch_dq("dq", x, pq)
    torch.cuda.synchronize()
    assert _row_rel(split, whole) < 1e-2
    assert _row_rel(whole, qm.qmm_dq_reference(x, pq)) < 1e-2


def test_k1_dispatch_counts_and_rejects(cuda):
    pq, g = _packed(cuda, 256, 512, 8)
    pq = qm.to_panels(pq)
    assert pq.panels
    _build.reset_launches()
    for M in (1, 4, 17):
        y = qm.quantized_matmul(
            torch.randn(M, 512, generator=g, device=cuda).bfloat16(), pq)
        assert y.shape == (M, 256)
    assert _build.LAUNCHES["k1_m1"] == 1 and _build.LAUNCHES["k1_mn"] == 1
    with pytest.raises(ValueError):
        qm._k1(torch.randn(1, 512, device=cuda), pq, None, EPS)
    with pytest.raises(ValueError):      # the norm fuses at M=1 only
        qm._k1(torch.randn(2, 512, device=cuda).bfloat16(), pq,
               torch.ones(512, device=cuda).bfloat16(), EPS)


def test_routes_launch_their_kernel_or_raise(cuda, monkeypatch):
    """On CUDA each route launches its kernel (row-major 4-bit w4a8 up to
    16 rows and 8-bit: K6; 4-bit a16 up to 64 rows: K7; batched at 2..16
    rows: K1) and never a plain version; a weight the kernel does not take
    (its scales on another device, a 4-bit a16 weight handed to K6) raises
    instead of falling back."""
    def no_plain(*a, **k):
        raise AssertionError("a plain version ran on CUDA")

    monkeypatch.setattr(qm, "qmm_p_reference", no_plain)
    monkeypatch.setattr(qm, "qmm_dq_reference", no_plain)
    w4a8, g = _packed(cuda, 256, 512, 8)
    w4, _ = _packed(cuda, 256, 512, None)
    w8, _ = _packed(cuda, 256, 512, None, bits=8)
    batched = dataclasses.replace(w4, batched=True)
    cases = [(w4a8, 1, "k6"), (w4a8, 16, "k6"), (w4, 1, "k7"),
             (w4, 40, "k7"), (w8, 3, "k6"), (batched, 8, "k1_mn")]
    for w, M, key in cases:
        assert qm.route(w, M) == key
        _build.reset_launches()
        y = qm.quantized_matmul(
            torch.randn(M, 512, generator=g, device=cuda).bfloat16(), w)
        assert y.shape == (M, 256) and torch.isfinite(y.float()).all()
        assert dict(_build.LAUNCHES) == {key: 1}
    x = torch.randn(4, 512, device=cuda).bfloat16()
    off = dataclasses.replace(w4a8, scales=w4a8.scales.cpu())
    for w in (off, dataclasses.replace(w4, scales=w4.scales.cpu())):
        with pytest.raises(ValueError):
            qm.quantized_matmul(x, w)
    with pytest.raises(ValueError):
        qm._k6(x, w4)


@pytest.mark.parametrize("T,H,Hkv,D", [
    (2, 4, 4, 64), (33, 8, 2, 64), (128, 32, 8, 128), (777, 32, 8, 128),
    (100, 4, 1, 256), (16, 32, 8, 128),
    # either side of the 64-key and 128-query tile edges
    (63, 8, 2, 128), (64, 8, 2, 128), (65, 8, 2, 128), (127, 8, 2, 128),
    (128, 8, 2, 128), (129, 8, 2, 128), (2048, 16, 4, 64),
    (2048, 8, 2, 256)])
def test_k2_matches_plain(cuda, T, H, Hkv, D):
    """K2 against its plain version: max error over max |plain| < 1e-2
    (bf16 output, relative so that an output above 4, where one bf16 ulp
    is 3.1e-2, cannot fail a right kernel); LSE within 1e-3 absolute,
    the check that catches wrong scores (both sides score bf16(q * scale),
    the scale rounded to bf16)."""
    g = torch.Generator(device=cuda).manual_seed(T)
    q = torch.randn(1, H, T, D, generator=g, device=cuda).bfloat16()
    k = torch.randn(1, Hkv, T, D, generator=g, device=cuda).bfloat16()
    v = torch.randn(1, Hkv, T, D, generator=g, device=cuda).bfloat16()
    _build.reset_launches()
    out, lse = fa.flash_prefill_lse(q, k, v, D ** -0.5)
    assert _build.LAUNCHES["k2"] == 1
    want, want_lse = fa.flash_prefill_reference(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert _rel(out, want) < 1e-2
    assert (lse - want_lse).abs().max().item() < 1e-3


def test_k2_rejects(cuda):
    q = torch.randn(1, 4, 8, 96, device=cuda).bfloat16()
    with pytest.raises(ValueError):
        fa._k2(q, q[:, :2], q[:, :2], 0.1)
    q = torch.randn(1, 4, 8, 64, device=cuda).bfloat16()
    off = torch.randn(4 * 8 * 64 + 4, device=cuda).bfloat16()[4:]
    with pytest.raises(ValueError, match="16-byte"):    # misaligned base
        fa._k2(off.view(1, 4, 8, 64), q, q, 0.1)


@pytest.mark.parametrize("T,H,Hkv,D", [(256, 8, 2, 128), (2048, 32, 8, 128),
                                       (300, 4, 1, 64)])
def test_k2c_rows_equal_k2_rows(cuda, T, H, Hkv, D):
    """K2 over T keys and K2c for the chunk of queries T/2..T-1 over the
    same keys give the same rows, output and LSE bit for bit: key tiles
    start at absolute position 0 in both, so a query walks the same tiles
    in the same order (the chunked and single-shot prefills agree)."""
    g = torch.Generator(device=cuda).manual_seed(T + D)
    q = torch.randn(1, H, T, D, generator=g, device=cuda).bfloat16()
    k = torch.randn(1, Hkv, T, D, generator=g, device=cuda).bfloat16()
    v = torch.randn(1, Hkv, T, D, generator=g, device=cuda).bfloat16()
    out, lse = fa._k2(q, k, v, D ** -0.5)
    pos = T // 2
    out_c, lse_c = fa._k2c(q[:, :, pos:].contiguous(), k, v, pos, D ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(out_c, out[:, :, pos:])
    assert torch.equal(lse_c, lse[:, :, pos:])


@pytest.mark.parametrize("B,H,Hkv,D,pos,T", [
    (1, 32, 8, 128, 2048, 2048), (1, 32, 8, 128, 6144, 2048),
    (1, 32, 8, 128, 128, 100), (1, 32, 8, 128, 300, 17),
    (2, 4, 4, 64, 1, 1), (2, 8, 2, 64, 5, 33), (2, 4, 1, 256, 77, 100),
    # pos not a multiple of the 64-key tile, chunks across tile edges
    (1, 8, 2, 128, 65, 63), (1, 8, 2, 128, 100, 129),
    (1, 8, 2, 256, 190, 200), (1, 16, 4, 64, 1000, 2048)])
def test_k2c_matches_plain(cuda, B, H, Hkv, D, pos, T):
    """K2c over the [:pos+T] prefix of a larger cache, read in place
    (strided view): output max error over max |plain| < 1e-2, LSE within
    1e-3 absolute, as K2."""
    g = torch.Generator(device=cuda).manual_seed(pos + T)
    cap = pos + T + 37
    q = torch.randn(B, H, T, D, generator=g, device=cuda).bfloat16()
    kc = torch.randn(B, Hkv, cap, D, generator=g, device=cuda).bfloat16()
    vc = torch.randn(B, Hkv, cap, D, generator=g, device=cuda).bfloat16()
    k, v = kc[:, :, :pos + T], vc[:, :, :pos + T]
    assert not k.is_contiguous()
    _build.reset_launches()
    out, lse = fa.flash_chunk_prefill_lse(q, k, v, pos, D ** -0.5)
    assert _build.LAUNCHES["k2c"] == 1
    want, want_lse = fa.flash_chunk_reference(q, k, v, pos, D ** -0.5)
    torch.cuda.synchronize()
    assert _rel(out, want) < 1e-2
    assert (lse - want_lse).abs().max().item() < 1e-3


def test_k2c_rejects(cuda):
    q = torch.randn(1, 4, 8, 64, device=cuda).bfloat16()
    k = torch.randn(1, 2, 12, 64, device=cuda).bfloat16()
    with pytest.raises(ValueError):                   # float32 q
        fa._k2c(q.float(), k, k, 4, 0.1)
    with pytest.raises(ValueError):                   # pos + T != keys
        fa._k2c(q, k, k, 3, 0.1)
    with pytest.raises(ValueError):                   # D not unit stride
        kt = torch.randn(1, 2, 64, 12, device=cuda).bfloat16()
        fa._k2c(q, kt.transpose(2, 3), k, 4, 0.1)
    with pytest.raises(ValueError):                   # CPU tensors
        fa._k2c(q.cpu(), k.cpu(), k.cpu(), 4, 0.1)
    # views whose rows the kernel cannot copy in 16-byte units raise, and
    # are never copied in silence: a row pitch of 68 elements, and a base
    # 8 bytes off
    wide = torch.randn(1, 2, 12, 68, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="multiples of 8"):
        fa._k2c(q, wide[..., :64], k, 4, 0.1)
    flat = torch.randn(2 * 12 * 64 + 4, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="16-byte"):
        fa._k2c(q, k, flat[4:].view(1, 2, 12, 64), 4, 0.1)


def _paged_inputs(dev, B, H, Hkv, D, ps, MP, lengths, quant, seed=0):
    """Pools of B * MP + 1 pages (page 0 the null page) and shuffled,
    non-contiguous page tables."""
    g = torch.Generator(device=dev).manual_seed(seed)
    P = B * MP + 1
    q = torch.randn(B, H, D, generator=g, device=dev).bfloat16()
    if quant:
        kp = torch.randint(-127, 128, (P, Hkv, ps, D), generator=g,
                           device=dev, dtype=torch.int8)
        vp = torch.randint(-127, 128, (P, Hkv, ps, D), generator=g,
                           device=dev, dtype=torch.int8)
        ks = torch.rand(P, Hkv, ps, generator=g, device=dev) / 64 + 1e-3
        vs = torch.rand(P, Hkv, ps, generator=g, device=dev) / 64 + 1e-3
    else:
        kp = torch.randn(P, Hkv, ps, D, generator=g, device=dev).bfloat16()
        vp = torch.randn(P, Hkv, ps, D, generator=g, device=dev).bfloat16()
        ks = vs = None
    perm = torch.randperm(P - 1, generator=g, device=dev) + 1
    table = perm.reshape(B, MP).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, ks, vs, table, lens


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 512])
def test_k3_main_shape_matches_plain(cuda, quant, window):
    """K3 at the chip_smoke shape (B=8, H=32, Hkv=8, D=128, page 128, 16
    pages per row, shuffled tables, ragged lengths) against the gathered
    view + masked sdpa, held per (row, head): max error over max |plain|
    of that row and head < 3e-2. The plain version rounds the softmax
    weights, and int8 pages' dequantized view, to bf16, which reads up to
    8e-3 against an exact kernel; one page or token left out of a row
    reads 0.11 or more."""
    lengths = [1, 127, 128, 129, 700, 1500, 2047, 2048]
    args = _paged_inputs(cuda, 8, 32, 8, 128, 128, 16, lengths, quant)
    q, kp, vp, ks, vs, table, lens = args
    _build.reset_launches()
    got = pa.paged_decode_attention(q, kp, vp, table, lens, 128 ** -0.5,
                                    window=window, k_scale=ks, v_scale=vs)
    assert _build.LAUNCHES["k3"] == 1
    assert _build.LAUNCHES["k3_int8"] == int(quant)
    want = pa.paged_decode_reference(q, kp, vp, table, lens, 128 ** -0.5,
                                     window=window, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _row_rel(got, want) < 3e-2


@pytest.mark.parametrize("B,H,Hkv,D,ps,MP,lengths", [
    (3, 4, 2, 64, 16, 5, (1, 17, 80)), (2, 8, 8, 256, 8, 3, (24, 5)),
    (2, 32, 2, 128, 32, 4, (100, 33)), (1, 16, 2, 64, 4, 9, (35,))])
@pytest.mark.parametrize("quant", [False, True])
def test_k3_small_ragged_matches_plain(cuda, B, H, Hkv, D, ps, MP, lengths,
                                       quant):
    args = _paged_inputs(cuda, B, H, Hkv, D, ps, MP, lengths, quant, seed=B)
    q, kp, vp, ks, vs, table, lens = args
    for window in (0, 7):
        got = pa.paged_decode_attention(q, kp, vp, table, lens, D ** -0.5,
                                        window=window, k_scale=ks,
                                        v_scale=vs)
        want = pa.paged_decode_reference(q, kp, vp, table, lens, D ** -0.5,
                                         window=window, k_scale=ks,
                                         v_scale=vs)
        torch.cuda.synchronize()
        assert _row_rel(got, want) < 3e-2


def test_k3_never_reads_table_past_length(cuda):
    """Table entries past a row's length hold garbage page ids far out of
    the pool; K3 must not read them (a read would fault or differ)."""
    q, kp, vp, ks, vs, table, lens = _paged_inputs(
        cuda, 2, 8, 2, 128, 16, 8, (20, 40), False)
    bad = table.clone()
    bad[0, 2:] = 1 << 28
    bad[1, 3:] = -(1 << 28)
    got = pa.paged_decode_attention(q, kp, vp, bad, lens, 0.1)
    want = pa.paged_decode_attention(q, kp, vp, table, lens, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_k3_rejects(cuda):
    q, kp, vp, ks, vs, table, lens = _paged_inputs(
        cuda, 2, 8, 2, 64, 16, 4, (3, 9), True)
    with pytest.raises(ValueError):                   # float32 q
        pa._k3(q.float(), kp, vp, table, lens, 0.1, 0, ks, vs)
    with pytest.raises(ValueError):                   # int8 pools, no scales
        pa._k3(q, kp, vp, table, lens, 0.1, 0, None, None)
    with pytest.raises(ValueError):                   # lengths of wrong shape
        pa._k3(q, kp, vp, table, lens[:1], 0.1, 0, ks, vs)
    with pytest.raises(ValueError):                   # H / Hkv = 3
        pa._k3(q[:, :6], kp, vp, table, lens, 0.1, 0, ks, vs)
    with pytest.raises(ValueError):                   # CPU tensors
        pa._k3(q.cpu(), kp.cpu(), vp.cpu(), table.cpu(), lens.cpu(), 0.1, 0,
               ks.cpu(), vs.cpu())


def _k3_both(args, window=0):
    """K3 twice and the plain version on the same inputs."""
    q, kp, vp, ks, vs, table, lens = args
    scale = q.shape[-1] ** -0.5
    _build.reset_launches()
    got = pa.paged_decode_attention(q, kp, vp, table, lens, scale,
                                    window=window, k_scale=ks, v_scale=vs)
    again = pa.paged_decode_attention(q, kp, vp, table, lens, scale,
                                      window=window, k_scale=ks, v_scale=vs)
    assert _build.LAUNCHES["k3"] == 2
    want = pa.paged_decode_reference(q, kp, vp, table, lens, scale,
                                     window=window, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)            # bitwise repeatable
    return got, want


@pytest.mark.parametrize("quant", [False, True])
def test_k3_one_long_request(cuda, quant):
    """One row of 32768 tokens at Qwen3-4B's heads (64 splits of 4 pages):
    per (row, head) within 3e-2 of the plain version, the same bits on a
    second call."""
    assert pa.k3_plan(1, 8, 1, 256, 128) == pa.K3Plan(64, 4)
    got, want = _k3_both(_paged_inputs(cuda, 1, 32, 8, 128, 128, 256,
                                       (32768,), quant, seed=7))
    assert _row_rel(got, want) < 3e-2


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("lengths", [
    (1,) * 8, (255, 256, 257, 511, 512, 513, 2047, 2048),
    (1, 128, 129, 767, 768, 769, 1, 1024)])
def test_k3_lengths_at_split_boundaries(cuda, quant, lengths):
    """B=8 rows of 16 pages (8 splits of 256 tokens): every row of length
    1, and lengths at split boundaries +-1."""
    assert pa.k3_plan(8, 8, 1, 16, 128) == pa.K3Plan(8, 2)
    got, want = _k3_both(_paged_inputs(cuda, 8, 32, 8, 128, 128, 16, lengths,
                                       quant, seed=sum(lengths)))
    assert _row_rel(got, want) < 3e-2


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [1, 256, 300, 1000])
def test_k3_window_across_splits(cuda, quant, window):
    """A sliding window of one token, one that starts at a split's first
    token (row 0: 1536 - 256 = 1280), and ones that span two or more
    splits, so the splits before them are skipped."""
    lengths = (1536, 1000, 2048, 700, 257, 1, 1792, 1300)
    got, want = _k3_both(_paged_inputs(cuda, 8, 32, 8, 128, 128, 16, lengths,
                                       quant, seed=window), window)
    assert _row_rel(got, want) < 3e-2


def test_k3_split_never_reads_table_past_length(cuda):
    """As test_k3_never_reads_table_past_length, with splits: 8 rows of 16
    pages, garbage page ids past each row's length."""
    lengths = (1, 200, 256, 257, 600, 1024, 1500, 2048)
    q, kp, vp, ks, vs, table, lens = _paged_inputs(
        cuda, 8, 32, 8, 128, 128, 16, lengths, True, seed=3)
    bad = table.clone()
    for b, n in enumerate(lengths):
        bad[b, -(-n // 128):] = (1 << 28) * (1 if b % 2 else -1)
    got = pa.paged_decode_attention(q, kp, vp, bad, lens, 0.1, k_scale=ks,
                                    v_scale=vs)
    want = pa.paged_decode_attention(q, kp, vp, table, lens, 0.1,
                                     k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_model_attention_runs_kernels_or_raises(cuda):
    """On CUDA the model sends a fresh prefill, a continuation chunk and a
    paged decode step to K2, K2c and K3 whatever the shape, a sliding
    window included (each kernel takes it): a head dim the kernels do not
    take raises, never a quiet dense path."""
    from ominix_mlx_tpu_torch.models import base

    def run(head_dim, window):
        cfg = base.TransformerConfig(
            vocab_size=64, hidden_size=64, num_layers=1, num_heads=4,
            num_kv_heads=2, head_dim=head_dim, intermediate_size=64,
            sliding_window=window)
        gen = torch.Generator(device=cuda).manual_seed(0)
        params = base.init_params(cfg, gen, device=cuda)
        toks = torch.arange(1, 9, device=cuda)[None]
        outcomes = []
        for step in ("prefill", "chunk", "paged_decode"):
            _build.reset_launches()
            try:
                if step == "prefill":
                    base.forward(params, cfg, toks,
                                 base.init_cache(cfg, 1, 32, device=cuda),
                                 fresh_prefill=True)
                elif step == "chunk":
                    _, c = base.forward(params, cfg, toks, base.init_cache(
                        cfg, 1, 32, device=cuda))          # dense sdpa
                    base.forward(params, cfg, toks[:, :4], c, kv_limit=12)
                else:
                    base.forward(params, cfg, toks[:, :1],
                                 base.init_paged_cache(cfg, 1, 32, 16,
                                                       device=cuda))
                outcomes.append({k: v for k, v in _build.LAUNCHES.items()
                                 if v and k in ("k2", "k2c", "k3")})
            except (ValueError, NotImplementedError) as e:
                outcomes.append(type(e).__name__)
        return outcomes

    assert run(64, None) == [{"k2": 1}, {"k2c": 1}, {"k3": 1}]
    assert run(96, None) == ["ValueError"] * 3
    assert run(64, 4) == [{"k2": 1}, {"k2c": 1}, {"k3": 1}]


@pytest.mark.parametrize("M", [1, 8, 17, 64])
def test_channel_matmul_exact_on_cuda(cuda, M):
    """The w8a8 product on the card (torch._int_mm, rows padded below 17)
    equals the CPU's exactly: the same activation codes (scales divided
    by 127 exactly on both devices), int8 x int8 summed in int32, then
    the same float32 rescale."""
    g = torch.Generator(device=cuda).manual_seed(M)
    w = qm.channel_quantize(torch.randn(264, 512, generator=g, device=cuda))
    x = torch.randn(M, 512, generator=g, device=cuda).bfloat16()
    got = qm.channel_matmul(x, w)
    want = qm.channel_matmul(x.cpu(), qm.ChannelQuantizedTensor(
        w.data.cpu(), w.scale.cpu()))
    assert torch.equal(got.cpu(), want)


# ------------------------------------------------------ GQA group of 8 ------

@pytest.mark.parametrize("T", [16, 300])
def test_k2_k2c_at_32_over_4_heads(cuda, T):
    """Qwen3-30B-A3B's heads (32 query over 4 KV, a group of 8, D=128):
    K2 over a fresh prompt and K2c over a chunk at pos=T, as above."""
    g = torch.Generator(device=cuda).manual_seed(T)
    q = torch.randn(1, 32, T, 128, generator=g, device=cuda).bfloat16()
    kc = torch.randn(1, 4, 2 * T + 5, 128, generator=g, device=cuda).bfloat16()
    vc = torch.randn(1, 4, 2 * T + 5, 128, generator=g, device=cuda).bfloat16()
    out, lse = fa.flash_prefill_lse(q, kc[:, :, :T].contiguous(),
                                    vc[:, :, :T].contiguous(), 128 ** -0.5)
    want, want_lse = fa.flash_prefill_reference(
        q, kc[:, :, :T], vc[:, :, :T], 128 ** -0.5)
    torch.cuda.synchronize()
    assert _rel(out, want) < 1e-2
    assert (lse - want_lse).abs().max().item() < 1e-3
    k, v = kc[:, :, :2 * T], vc[:, :, :2 * T]
    out, lse = fa.flash_chunk_prefill_lse(q, k, v, T, 128 ** -0.5)
    want, want_lse = fa.flash_chunk_reference(q, k, v, T, 128 ** -0.5)
    torch.cuda.synchronize()
    assert _rel(out, want) < 1e-2
    assert (lse - want_lse).abs().max().item() < 1e-3


@pytest.mark.parametrize("quant", [False, True])
def test_k3_at_32_over_4_heads(cuda, quant):
    """K3 at batch 8 with 32 query heads over 4 KV heads: per (row, head)
    error < 3e-2 of max |plain|, as test_k3_main_shape_matches_plain."""
    lengths = [1, 127, 128, 129, 200, 300, 500, 512]
    q, kp, vp, ks, vs, table, lens = _paged_inputs(
        cuda, 8, 32, 4, 128, 128, 4, lengths, quant, seed=4)
    got = pa.paged_decode_attention(q, kp, vp, table, lens, 128 ** -0.5,
                                    k_scale=ks, v_scale=vs)
    want = pa.paged_decode_reference(q, kp, vp, table, lens, 128 ** -0.5,
                                     k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert _row_rel(got, want) < 3e-2


# ------------------------------------------- sliding window (Mistral) ------

@pytest.mark.parametrize("window", [0, 128, 256, 100, 4000, 5000])
@pytest.mark.parametrize("T,H,Hkv,D", [(1000, 8, 2, 128), (777, 32, 2, 128),
                                       (300, 4, 1, 64), (500, 4, 2, 256)])
def test_k2_window_matches_plain(cuda, T, H, Hkv, D, window):
    """K2 with a sliding window (0: none; multiples of the 128-key tile,
    one that is not, one longer than T) against its plain version, as
    test_k2_matches_plain holds K2: output 1e-2 of max |plain|, LSE 1e-3.
    A windowed launch also counts as "k2_window"."""
    g = torch.Generator(device=cuda).manual_seed(T + window)
    q = torch.randn(1, H, T, D, generator=g, device=cuda).bfloat16()
    k = torch.randn(1, Hkv, T, D, generator=g, device=cuda).bfloat16()
    v = torch.randn(1, Hkv, T, D, generator=g, device=cuda).bfloat16()
    _build.reset_launches()
    out, lse = fa.flash_prefill_lse(q, k, v, D ** -0.5, window)
    assert _build.LAUNCHES["k2"] == 1
    assert _build.LAUNCHES["k2_window"] == int(window > 0)
    want, want_lse = fa.flash_prefill_reference(q, k, v, D ** -0.5, window)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert _rel(out, want) < 1e-2
    assert (lse - want_lse).abs().max().item() < 1e-3


@pytest.mark.parametrize("window", [0, 128, 256, 100, 4000, 9000])
@pytest.mark.parametrize("pos,T,H,Hkv,D", [
    (6144, 2048, 32, 8, 128),     # the 8k prefill's last chunk
    (6144, 2048, 32, 2, 128),     # GLM-4's 16 query heads a KV head
    (300, 100, 8, 2, 128),        # the window's edge inside the chunk
    (90, 33, 4, 1, 64), (200, 130, 4, 2, 256)])
def test_k2c_window_matches_plain(cuda, pos, T, H, Hkv, D, window):
    """K2c over the strided prefix of a larger cache with a window, against
    its plain version (1e-2, LSE 1e-3)."""
    g = torch.Generator(device=cuda).manual_seed(pos + T + window)
    cap = pos + T + 37
    q = torch.randn(1, H, T, D, generator=g, device=cuda).bfloat16()
    kc = torch.randn(1, Hkv, cap, D, generator=g, device=cuda).bfloat16()
    vc = torch.randn(1, Hkv, cap, D, generator=g, device=cuda).bfloat16()
    k, v = kc[:, :, :pos + T], vc[:, :, :pos + T]
    _build.reset_launches()
    out, lse = fa.flash_chunk_prefill_lse(q, k, v, pos, D ** -0.5, window)
    assert _build.LAUNCHES["k2c"] == 1
    assert _build.LAUNCHES["k2c_window"] == int(window > 0)
    want, want_lse = fa.flash_chunk_reference(q, k, v, pos, D ** -0.5,
                                              window)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert _rel(out, want) < 1e-2
    assert (lse - want_lse).abs().max().item() < 1e-3


@pytest.mark.parametrize("window", [128, 100, 1000])
def test_k2c_window_rows_equal_k2_window_rows(cuda, window):
    """With a window too, K2c's chunk rows equal K2's single-shot rows bit
    for bit: the key tiles sit at absolute multiples of the tile, and a
    tile a row sees no key of leaves its state as it was."""
    T, H, Hkv, D = 2048, 8, 2, 128
    g = torch.Generator(device=cuda).manual_seed(window)
    q = torch.randn(1, H, T, D, generator=g, device=cuda).bfloat16()
    k = torch.randn(1, Hkv, T, D, generator=g, device=cuda).bfloat16()
    v = torch.randn(1, Hkv, T, D, generator=g, device=cuda).bfloat16()
    out, lse = fa._k2(q, k, v, D ** -0.5, window)
    for pos in (1024, 1500):
        out_c, lse_c = fa._k2c(q[:, :, pos:].contiguous(), k, v, pos,
                               D ** -0.5, window)
        torch.cuda.synchronize()
        assert torch.equal(out_c, out[:, :, pos:])
        assert torch.equal(lse_c, lse[:, :, pos:])


def test_window_model_prefill_runs_k2_and_k2c(cuda):
    """A sliding-window model's fresh prefill launches K2 and a
    continuation chunk K2c, each with the window: no branch falls back to
    sdpa (every launch also counts as the windowed kind)."""
    from ominix_mlx_tpu_torch.core.generate import Engine
    from ominix_mlx_tpu_torch.models import base

    cfg = base.TransformerConfig(
        vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
        num_kv_heads=2, head_dim=64, intermediate_size=512,
        sliding_window=100)
    g = torch.Generator(device=cuda).manual_seed(0)
    params = base.init_params(cfg, g, device=cuda)
    eng = Engine(lambda p, t, c: base.forward(p, cfg, t, c), params,
                 prefill_forward_fn=lambda p, t, c: base.forward(
                     p, cfg, t, c, fresh_prefill=True),
                 chunk_forward_fn=lambda p, t, c, kl: base.forward(
                     p, cfg, t, c, kv_limit=kl))
    prompt = torch.randint(0, 256, (1, 600), generator=g, device=cuda)
    _build.reset_launches()
    last, _ = eng.prefill_chunked(prompt, base.init_cache(
        cfg, 1, 640, device=cuda), chunk_size=256)
    assert torch.isfinite(last).all()
    assert _build.LAUNCHES["k2"] == _build.LAUNCHES["k2_window"] == 2
    assert _build.LAUNCHES["k2c"] == _build.LAUNCHES["k2c_window"] == 4


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 4096])
def test_k3_at_32_over_2_heads(cuda, quant, window):
    """GLM-4-9B's heads (32 query over 2 KV, a group of 16, D=128) at
    batch 8, ragged, with and without a window: per (row, head) error
    < 3e-2 of max |plain|, as test_k3_main_shape_matches_plain."""
    lengths = [1, 127, 128, 129, 700, 1500, 4097, 5000]
    q, kp, vp, ks, vs, table, lens = _paged_inputs(
        cuda, 8, 32, 2, 128, 128, 40, lengths, quant, seed=16)
    got = pa.paged_decode_attention(q, kp, vp, table, lens, 128 ** -0.5,
                                    window=window, k_scale=ks, v_scale=vs)
    want = pa.paged_decode_reference(q, kp, vp, table, lens, 128 ** -0.5,
                                     window=window, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _row_rel(got, want) < 3e-2


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 1000])
def test_k3_at_96_over_8_heads(cuda, quant, window):
    """GLM-4.5-Air's heads (96 query over 8 KV: 12 a KV head, three CTAs
    of 4 rows each) at batch 8, ragged, with and without a window: per
    (row, head) error < 3e-2 of max |plain|, as
    test_k3_main_shape_matches_plain."""
    lengths = [1, 127, 128, 129, 700, 1500, 2047, 2048]
    q, kp, vp, ks, vs, table, lens = _paged_inputs(
        cuda, 8, 96, 8, 128, 128, 16, lengths, quant, seed=12)
    _build.reset_launches()
    got = pa.paged_decode_attention(q, kp, vp, table, lens, 128 ** -0.5,
                                    window=window, k_scale=ks, v_scale=vs)
    assert _build.LAUNCHES["k3"] == 1
    want = pa.paged_decode_reference(q, kp, vp, table, lens, 128 ** -0.5,
                                     window=window, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _row_rel(got, want) < 3e-2


def test_loader_reads_onto_the_card(cuda, tmp_path):
    """The port's safetensors writer and reader: every dtype lands on the
    card bit for bit, and MLX's uint32 words unpack there as on the CPU."""
    from ominix_mlx_tpu_torch.core.quant import from_mlx_arrays, pack_codes
    from ominix_mlx_tpu_torch.utils import loading

    g = torch.Generator().manual_seed(0)
    codes = torch.randint(0, 16, (64, 256), generator=g, dtype=torch.uint8)
    ts = {"bf16": torch.randn(33, 17, generator=g).bfloat16(),
          "f32": torch.randn(5, generator=g),
          "i8": torch.randint(-128, 128, (9,), generator=g,
                              dtype=torch.int8),
          "w": pack_codes(codes, 4),
          "s": torch.rand(64, 4, generator=g).bfloat16(),
          "b": torch.randn(64, 4, generator=g).bfloat16()}
    path = str(tmp_path / "m.safetensors")
    loading.save_safetensors(path, ts)
    got = loading.read_safetensors(path, device=cuda)
    for k, t in ts.items():
        assert got[k].is_cuda and got[k].dtype == t.dtype
        words = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
                 torch.uint32: torch.int32}.get(t.dtype)
        a, b = got[k].cpu(), t
        if words is not None:
            a, b = a.view(words), b.view(words)
        assert torch.equal(a, b), k
    on_card = from_mlx_arrays(got["w"], got["s"], got["b"], 64, 4)
    on_host = from_mlx_arrays(ts["w"], ts["s"], ts["b"], 64, 4)
    assert torch.equal(on_card.q.cpu(), on_host.q)
    assert torch.equal(on_card.biases.cpu().view(torch.int16),
                       on_host.biases.view(torch.int16))


# ------------------------------------------------- K4: expert gather-qmm ----

def _experts(dev, E, N, K, act_bits=8, seed=0, bits=4):
    g = torch.Generator(device=dev).manual_seed(seed)
    G = K // 64
    lim = 1 << (bits - 1)
    if bits == 4:
        data = torch.randint(0, 256, (E, N, K // 2), generator=g, device=dev,
                             dtype=torch.uint8)
    else:
        data = torch.randint(-lim, lim, (E, N, K), generator=g, device=dev,
                             dtype=torch.int8)
    w = qm.PackedQuantizedExperts(
        data=data,
        scales=((torch.rand(E, N, G, generator=g, device=dev) + 0.5)
                * K ** -0.5 / lim).bfloat16(),
        biases=(torch.randn(E, N, G, generator=g, device=dev)
                * K ** -0.5 / 4).bfloat16(),
        group_size=64, bits=bits, in_features=K, act_bits=act_bits)
    return w, g


def _ids(g, dev, E, T, k):
    """Expert ids out of order, with a repeat and the last expert."""
    ids = torch.randint(0, E, (T, k), generator=g, device=dev)
    ids[0, -1] = E - 1
    ids[-1, 0] = ids[0, 0]
    return ids


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("T,k,N,K", [(1, 8, 768, 2048), (8, 8, 768, 2048),
                                     (8, 1, 2048, 768), (64, 1, 2048, 768),
                                     (3, 5, 100, 256)])
def test_k4_matches_plain(cuda, T, k, N, K, bits):
    """K4 against gather_qmm_reference(act_bits=8) at 4 and 8 bits, ids out
    of order with repeats and the last expert: max error over max |plain|
    of each (row, slot) < 1e-2 (bf16 output, another summation order).
    gather_qmm launches it on the "k4" route; N = 100, which the TPU
    kernel refuses, calls the wrapper directly."""
    E = 128
    w, g = _experts(cuda, E, N, K, seed=T * k, bits=bits)
    x = torch.randn(T, K, generator=g, device=cuda).bfloat16()
    ids = _ids(g, cuda, E, T, k)
    key = "k4" if bits == 4 else "k4_w8"
    _build.reset_launches()
    if qm.expert_route(w, T) == "k4":
        got = qm.gather_qmm(x, w, ids)
    else:
        got = qm._k4(x, w, ids.int())
    assert dict(_build.LAUNCHES) == {key: 1}
    want = qm.gather_qmm_reference(x, w, ids, act_bits=8)
    torch.cuda.synchronize()
    assert got.shape == (T, k, N) and got.dtype == torch.bfloat16
    assert torch.isfinite(got).all()
    assert _row_rel(got, want) < 1e-2


@pytest.mark.parametrize("bits", [4, 8])
def test_k4_k8_repeat_beside_the_p_formula(cuda, bits):
    """K4 and K8 share the activation prologue with K1 and K6: at
    Qwen3-30B-A3B's gate shape (T=1, k=8) K4 gives the same bits on a
    second call, within 1e-2 of its plain version, also when a K6 launch
    (the prologue launched for a dependent kernel) runs between them; K8
    equals its plain version."""
    w, g = _experts(cuda, 128, 768, 2048, seed=bits, bits=bits)
    x = torch.randn(1, 2048, generator=g, device=cuda).bfloat16()
    ids = _ids(g, cuda, 128, 1, 8).int()
    first = qm._k4(x, w, ids)
    pq, _ = _packed(cuda, 2560, 2048, 8, seed=1, bits=bits)
    qm._k6(x, pq)
    second = qm._k4(x, w, ids)
    want = qm.gather_qmm_reference(x, w, ids, act_bits=8)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert _row_rel(first, want) < 1e-2
    cw = qm.ChannelQuantizedExperts(
        data=torch.randint(-127, 128, (128, 768, 2048), generator=g,
                           device=cuda, dtype=torch.int8),
        scale=torch.rand(128, 768, generator=g, device=cuda) / 2048)
    xf = x.float()
    assert torch.equal(qm._k8(xf, cw, ids),
                       qm.channel_gather_qmm_reference(xf, cw, ids))


def test_float32_x_raises_where_the_formula_reads_it_unrounded(cuda):
    """The quantized kernels take bf16 x. Where the JAX formula quantizes
    and group-sums float32 x unrounded (A1 8-bit, A3, A4 past one 4-bit
    row, A6), quantized_matmul and gather_qmm raise on CUDA rather than
    round it; where the formula rounds x to bf16 first (A5, and A1/A4 at
    one 4-bit row) the kernel runs and float32 comes back."""
    w8, g = _packed(cuda, 256, 512, 8, bits=8)
    assert qm.route(w8, 4) == "k6"
    with pytest.raises(ValueError, match="float32"):
        qm.quantized_matmul(torch.randn(4, 512, generator=g, device=cuda),
                            w8)
    w4, _ = _packed(cuda, 256, 512, None)
    assert qm.route(w4, 40) == "k7"
    x = torch.randn(40, 512, generator=g, device=cuda)
    _build.reset_launches()
    y = qm.quantized_matmul(x, w4)
    assert dict(_build.LAUNCHES) == {"k7": 1} and y.dtype == torch.float32
    for bits in (4, 8):
        w, g = _experts(cuda, 128, 768, 2048, bits=bits)
        assert qm.expert_route(w, 1) == "k4"
        with pytest.raises(ValueError, match="float32"):
            qm.gather_qmm(torch.randn(1, 2048, generator=g, device=cuda), w,
                          _ids(g, cuda, 128, 1, 8))


@pytest.mark.parametrize("bits", [4, 8])
def test_k4_rejects_and_flags_bad_ids(cuda, bits):
    w, g = _experts(cuda, 4, 128, 256, bits=bits)
    x = torch.randn(2, 256, generator=g, device=cuda).bfloat16()
    with pytest.raises(ValueError):                   # T * k > 65535
        qm._k4(torch.zeros(2, 256, device=cuda).bfloat16(), w,
               torch.zeros(2, 32768, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):                   # float32 x
        qm._k4(x.float(), w, torch.zeros(2, 1, dtype=torch.int32,
                                         device=cuda))
    with pytest.raises(ValueError):                   # exact experts
        qm._k4(x, dataclasses.replace(w, act_bits=None),
               torch.zeros(2, 1, dtype=torch.int32, device=cuda))
    bad = torch.tensor([[0, 4], [-1, 2]], dtype=torch.int32, device=cuda)
    got = qm._k4(x, w, bad)
    torch.cuda.synchronize()
    assert torch.isnan(got[0, 1]).all() and torch.isnan(got[1, 0]).all()
    assert torch.isfinite(got[0, 0]).all() and torch.isfinite(got[1, 1]).all()


@pytest.mark.parametrize("bits", [4, 8])
def test_gather_qmm_exact_and_gathered_routes_launch_no_k4(cuda, bits):
    """Experts with act_bits=None, and experts on the "gathered" route
    (N = 200, which the TPU kernel refuses), compute the JAX package's
    exact fallback on the card as on the CPU: no K4 launch, equal to the
    plain version. Experts of 4096 x 2048 at 8 bits (a 16 MiB double
    buffer) are "gathered" too."""
    w, g = _experts(cuda, 4, 128, 256, bits=bits)
    ragged, _ = _experts(cuda, 4, 200, 256, bits=bits)
    x = torch.randn(3, 256, generator=g, device=cuda).bfloat16()
    ids = torch.tensor([[0, 3], [1, 1], [2, 0]], device=cuda)
    for experts in (dataclasses.replace(w, act_bits=None), ragged):
        _build.reset_launches()
        got = qm.gather_qmm(x, experts, ids)
        assert sum(_build.LAUNCHES.values()) == 0
        want = qm.gather_qmm_reference(x, experts, ids, act_bits=None)
        assert torch.equal(got, want)
    big = qm.PackedQuantizedExperts(
        torch.empty(2, 4096, 2048, dtype=torch.int8, device="meta"),
        torch.empty(2, 4096, 32, device="meta"),
        torch.empty(2, 4096, 32, device="meta"), 64, 8, 2048)
    assert qm.expert_route(big, 1) == "gathered"
    assert qm.expert_route(dataclasses.replace(w, bits=bits), 1) == "k4"


# ------------------------------------- K8: channel w8a8 expert gather-qmm ----

def _channel_experts(dev, E, N, K, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return qm.channel_quantize_experts(
        torch.randn(E, N, K, generator=g, device=dev)), g


@pytest.mark.parametrize("T,k,N,K", [(1, 8, 768, 2048), (8, 8, 768, 2048),
                                     (8, 1, 2048, 768), (64, 1, 2048, 768),
                                     (70, 2, 40, 48)])
def test_k8_matches_plain_exactly(cuda, T, k, N, K):
    """K8 against channel_gather_qmm_reference on the same inputs: equal
    bit for bit (the same int8 codes from an IEEE division, exact int32
    sums, the same float32 rescale order). The reference computes the
    activations' codes from float32 x as K8's prologue does, so bf16 x
    and float32 x both hold."""
    E = 128
    w, g = _channel_experts(cuda, E, N, K, seed=T * k)
    x = torch.randn(T, K, generator=g, device=cuda) * 3
    ids = _ids(g, cuda, E, T, k)
    for xx in (x, x.bfloat16()):
        _build.reset_launches()
        got = qm.channel_gather_qmm(xx, w, ids)
        assert dict(_build.LAUNCHES) == {"k8": 1}
        want = qm.channel_gather_qmm_reference(xx, w, ids)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == (T, k, N)
        assert torch.equal(got, want)


def test_k8_flags_bad_ids_and_rejects(cuda):
    w, g = _channel_experts(cuda, 4, 64, 256)
    x = torch.randn(2, 256, generator=g, device=cuda)
    bad = torch.tensor([[0, 4], [-1, 2]], dtype=torch.int32, device=cuda)
    got = qm._k8(x, w, bad)
    torch.cuda.synchronize()
    assert torch.isnan(got[0, 1]).all() and torch.isnan(got[1, 0]).all()
    assert torch.isfinite(got[0, 0]).all() and torch.isfinite(got[1, 1]).all()
    with pytest.raises(ValueError):                   # float16 x
        qm._k8(x.half(), w, bad)
    with pytest.raises(ValueError):                   # K not a multiple of 16
        qm._k8(torch.zeros(2, 248, device=cuda), qm.ChannelQuantizedExperts(
            w.data[:, :, :248].contiguous(), w.scale), bad)
    with pytest.raises(ValueError):                   # scale on the CPU
        qm._k8(x, qm.ChannelQuantizedExperts(w.data, w.scale.cpu()), bad)


# ------------------------------ K4 and K8: plans, gate and up, the prologue --

# (T rows, k slots, N, K) of Qwen3-30B-A3B's expert projections (gate and
# up at 1 and 8 decode rows, down at 8 and 64 rows of one slot) and an
# odd N that the TPU kernel refuses
GATHER_SHAPES = [(1, 8, 768, 2048), (8, 8, 768, 2048), (8, 1, 2048, 768),
                 (64, 1, 2048, 768), (3, 5, 100, 256)]
GATHER_KERNELS = ["w4a8", "w8a8", "k8"]


def _gather_case(dev, kernel, T, k, N, K, seed=0, stacks=1):
    """Experts (``stacks`` of them), x in the type the model sends (bf16)
    and ids for K4 at 4 or 8 bits or K8; and the kernel wrapper."""
    E = 128
    if kernel == "k8":
        ws = [_channel_experts(dev, E, N, K, seed=seed + i)[0]
              for i in range(stacks)]
        launch = qm._k8
    else:
        ws = [_experts(dev, E, N, K, seed=seed + i,
                       bits=4 if kernel == "w4a8" else 8)[0]
              for i in range(stacks)]
        launch = qm._k4
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    x = torch.randn(T, K, generator=g, device=dev).bfloat16()
    return ws, x, _ids(g, dev, E, T, k).int(), launch


@pytest.mark.parametrize("T,k,N,K", GATHER_SHAPES)
@pytest.mark.parametrize("kernel", GATHER_KERNELS)
def test_gather_every_plan_gives_the_same_bits(cuda, monkeypatch, kernel,
                                               T, k, N, K):
    """Every (lanes, rows) template of K4's and K8's rows kernel, forced
    through gather_plan, gives the bits of the plan's own choice: each
    output row is summed in one order whatever the plan (K4: a lane
    group's partial sums folded as the warp butterfly folds them; K8:
    exact int32 sums). The plan's choice is within 1e-2 per (row, slot)
    of the plain version (K4) or equal to it (K8)."""
    (w,), x, ids, launch = _gather_case(cuda, kernel, T, k, N, K, seed=T)
    if kernel == "k8" and k == 1:        # the down projection's float32 h
        x = x.float()
    base = launch(x, w, ids)
    real = qm.gather_plan
    outs = {}
    for plan in qm.GATHER_PLANS:
        monkeypatch.setattr(qm, "gather_plan", lambda *a, p=plan: p)
        outs[plan] = launch(x, w, ids)
    monkeypatch.setattr(qm, "gather_plan", real)
    if kernel == "k8":      # on the CPU: torch._int_mm on the card takes
        # no k * N that is not a multiple of 8 (here 5 x 100)
        want = qm.channel_gather_qmm_reference(
            x.cpu(), qm.ChannelQuantizedExperts(w.data.cpu(), w.scale.cpu()),
            ids.cpu())
    else:
        want = qm.gather_qmm_reference(x, w, ids, act_bits=8)
    torch.cuda.synchronize()
    for plan, y in outs.items():
        assert torch.equal(y, base), plan
    if kernel == "k8":
        assert torch.equal(base.cpu(), want)
    else:
        assert _row_rel(base, want) < 1e-2


@pytest.mark.parametrize("T,k,N,K", GATHER_SHAPES)
@pytest.mark.parametrize("kernel", GATHER_KERNELS)
def test_gather_gate_up_one_launch_equals_two(cuda, kernel, T, k, N, K):
    """Gate and up in one launch (one prologue, one rows kernel, two
    stacks that are separate allocations) give each stack's single-launch
    output bit for bit, and count one launch; the model's entries
    gather_qmm_gate_up and channel_gather_qmm_gate_up launch it once where
    the stacks take the kernel."""
    (wg, wu), x, ids, launch = _gather_case(cuda, kernel, T, k, N, K,
                                            seed=3, stacks=2)
    key = {"w4a8": "k4", "w8a8": "k4_w8", "k8": "k8"}[kernel]
    _build.reset_launches()
    g, u = launch(x, wg, ids, wu)
    assert dict(_build.LAUNCHES) == {key: 1}
    assert torch.equal(g, launch(x, wg, ids))
    assert torch.equal(u, launch(x, wu, ids))
    if kernel == "k8":
        entry, single = qm.channel_gather_qmm_gate_up, qm.channel_gather_qmm
    else:
        entry, single = qm.gather_qmm_gate_up, qm.gather_qmm
    _build.reset_launches()
    eg, eu = entry(x, wg, wu, ids.long())
    on_kernel = kernel == "k8" or qm.expert_route(wg, T) == "k4"
    assert sum(_build.LAUNCHES.values()) == (1 if on_kernel else 0)
    assert torch.equal(eg, single(x, wg, ids)) and torch.equal(
        eu, single(x, wu, ids))


@pytest.mark.parametrize("T,k,N,K", GATHER_SHAPES)
def test_k8_bf16_x_equals_x_widened(cuda, T, k, N, K):
    """K8's prologue reads bf16 x and widens it exactly: the outputs on
    bf16 x equal those on the same x as float32 bit for bit, single and
    with gate and up in one launch."""
    (wg, wu), x, ids, _ = _gather_case(cuda, "k8", T, k, N, K, seed=5,
                                       stacks=2)
    assert torch.equal(qm._k8(x, wg, ids), qm._k8(x.float(), wg, ids))
    pair, widened = qm._k8(x, wg, ids, wu), qm._k8(x.float(), wg, ids, wu)
    assert torch.equal(pair[0], widened[0])
    assert torch.equal(pair[1], widened[1])


@pytest.mark.parametrize("T,k,N,K", GATHER_SHAPES)
@pytest.mark.parametrize("kernel", GATHER_KERNELS)
def test_gather_consecutive_calls_read_their_own_x(cuda, kernel, T, k, N,
                                                   K):
    """Calls queued back to back with different x each return their own
    x's result: a rows kernel that read the prologue's scratch (x's codes,
    group sums, sx) before griddepcontrol.wait would read the call
    before's. Each call alone (synchronised) is the reference; single
    launches and gate and up in one launch, alternating."""
    (wg, wu), x1, ids, launch = _gather_case(cuda, kernel, T, k, N, K,
                                             seed=7, stacks=2)
    g2 = torch.Generator(device=cuda).manual_seed(11)
    x2 = (torch.randn(T, K, generator=g2, device=cuda) * 3).to(x1.dtype)
    alone = {}
    for name, x in (("x1", x1), ("x2", x2)):
        alone[name] = (launch(x, wg, ids), launch(x, wg, ids, wu))
        torch.cuda.synchronize()
    queued = []
    for name, x in (("x1", x1), ("x2", x2)) * 3:
        queued.append((name, launch(x, wg, ids), launch(x, wg, ids, wu)))
    torch.cuda.synchronize()
    assert not torch.equal(alone["x1"][0], alone["x2"][0])
    for name, single, pair in queued:
        assert torch.equal(single, alone[name][0]), name
        assert torch.equal(pair[0], alone[name][1][0]), name
        assert torch.equal(pair[1], alone[name][1][1]), name


@pytest.mark.parametrize("T,k,N,K", [(2, 2, 768, 2048), (2, 2, 2048, 768),
                                     (2, 2, 100, 256)])
@pytest.mark.parametrize("kernel", GATHER_KERNELS)
def test_gather_bad_ids_write_nan_at_every_plan(cuda, monkeypatch, kernel,
                                                T, k, N, K):
    """An expert id outside [0, E) writes NaN to its output rows, in both
    stacks of a gate-and-up launch and at every plan (lane groups of 8
    lanes with 2 rows and of 16 with 4), and its neighbours stay finite
    and equal to their own result."""
    (wg, wu), x, _, launch = _gather_case(cuda, kernel, T, k, N, K, seed=9,
                                          stacks=2)
    bad = torch.tensor([[0, 128], [-1, 2]], dtype=torch.int32, device=cuda)
    good = torch.tensor([[0, 1], [1, 2]], dtype=torch.int32, device=cuda)
    want = launch(x, wg, good)
    for plan in qm.GATHER_PLANS:
        monkeypatch.setattr(qm, "gather_plan", lambda *a, p=plan: p)
        for y in (launch(x, wg, bad), *launch(x, wg, bad, wu)):
            torch.cuda.synchronize()
            assert torch.isnan(y[0, 1]).all() and torch.isnan(y[1, 0]).all()
            assert torch.isfinite(y[0, 0]).all() and torch.isfinite(
                y[1, 1]).all()
        y = launch(x, wg, bad)
        assert torch.equal(y[0, 0], want[0, 0]) and torch.equal(
            y[1, 1], want[1, 1]), plan


# --------------------------------------------------- K5: grouped matmul -----

def _ragged(E, S, dev, seed=0):
    """Group sizes summing to S: empty groups, a one-row group and one of
    S / 2, the rest spread at random."""
    g = torch.Generator().manual_seed(seed)
    gs = torch.zeros(E, dtype=torch.int64)
    gs[E // 3] = S // 2
    gs[1] = 1
    rest = S - int(gs.sum())
    free = torch.tensor([e for e in range(E)
                         if e not in (1, E // 3) and e % 5])
    picks = free[torch.randint(0, len(free), (rest,), generator=g)]
    gs += torch.bincount(picks, minlength=E)
    return gs.to(dev)


@pytest.mark.parametrize("S,N,K", [(16384, 768, 2048), (128, 2048, 768),
                                   (100, 40, 72), (1000, 130, 2048)])
def test_k5_matches_plain(cuda, S, N, K):
    """K5 against grouped_matmul_reference on ragged groups (empty ones, a
    one-row group, one of S/2): max error over max |plain| < 1e-4 (both
    sum bf16 products in float32; a bf16 output or accumulator reads
    about 4e-3), and the same bits on a second run (no atomics)."""
    E = 128
    g = torch.Generator(device=cuda).manual_seed(S)
    xs = torch.randn(S, K, generator=g, device=cuda).bfloat16()
    w = (torch.randn(E, N, K, generator=g, device=cuda) * K ** -0.5).bfloat16()
    gs = _ragged(E, S, cuda, seed=S)
    assert int(gs.sum()) == S and int((gs == 0).sum()) > 0
    _build.reset_launches()
    got = tgmm.grouped_matmul(xs, w, gs)
    assert _build.LAUNCHES["k5"] == 1
    want = tgmm.grouped_matmul_reference(xs, w, gs)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (S, N)
    assert _rel(got, want) < 1e-4
    assert torch.equal(tgmm.grouped_matmul(xs, w, gs), got)


def test_k5_zeroes_rows_past_the_groups_and_rejects(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    xs = torch.randn(200, 64, generator=g, device=cuda).bfloat16()
    w = torch.randn(3, 24, 64, generator=g, device=cuda).bfloat16()
    gs = torch.tensor([70, 0, 60], device=cuda)
    got = tgmm.grouped_matmul(xs, w, gs)
    want = tgmm.grouped_matmul_reference(xs, w, gs)
    torch.cuda.synchronize()
    assert torch.equal(got[130:], torch.zeros_like(got[130:]))
    assert _rel(got, want) < 1e-4
    with pytest.raises(ValueError):                   # float32 xs
        tgmm._k5(xs.float(), w, gs.int())
    with pytest.raises(ValueError):                   # K not a multiple of 8
        tgmm._k5(xs[:, :60].contiguous(), w[:, :, :60].contiguous(),
                 gs.int())
    wq = _k5_experts(cuda, 3, 24, 64, 4, seed=1)
    with pytest.raises(ValueError):                   # float32 xs
        tgmm._k5(xs.float(), wq, gs.int())
    with pytest.raises(ValueError):                   # int8 codes at 4 bits
        tgmm._k5(xs, dataclasses.replace(wq, data=wq.data.view(torch.int8)),
                  gs.int())
    with pytest.raises(ValueError):                   # N not a multiple of 8
        tgmm._k5(xs, _k5_experts(cuda, 3, 20, 64, 4, seed=1), gs.int())
    with pytest.raises(ValueError):                   # misaligned xs
        tgmm._k5(torch.empty(200 * 64 + 1, dtype=torch.bfloat16,
                              device=cuda)[1:].view(200, 64), wq, gs.int())
    with pytest.raises(ValueError):                   # K of x vs experts
        tgmm._k5(xs[:, :32].contiguous(), wq, gs.int())


def _k5_experts(dev, E, N, K, bits, seed, gs=64):
    """Random packed experts [E, N, K] at 4 or 8 bits with non-zero
    biases."""
    g = torch.Generator(device=dev).manual_seed(seed)
    G, lim = K // gs, 1 << (bits - 1)
    if bits == 4:
        data = torch.randint(0, 256, (E, N, K // 2), generator=g, device=dev,
                             dtype=torch.uint8)
    else:
        data = torch.randint(-lim, lim, (E, N, K), generator=g, device=dev,
                             dtype=torch.int8)
    return qm.PackedQuantizedExperts(
        data=data,
        scales=((torch.rand(E, N, G, generator=g, device=dev) + 0.5)
                * (K ** -0.5 / lim)).bfloat16(),
        biases=(torch.randn(E, N, G, generator=g, device=dev)
                * (K ** -0.5 / 4)).bfloat16(),
        group_size=gs, bits=bits, in_features=K, act_bits=8)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("S,N,K,gs", [(1024, 768, 2048, 64),
                                      (16384, 2048, 768, 64),
                                      (1000, 136, 2048, 64),
                                      (130, 40, 96, 32), (300, 64, 512, 128)])
def test_k5_packed_matches_plain(cuda, bits, S, N, K, gs):
    """K5 on 4- and 8-bit experts read packed, against the plain version
    (each routed expert dequantized, a float32 matmul per group) on
    ragged groups (empty ones, a one-row group, one of S/2; S a multiple
    of no tile width but 8 in one case): max error over max |plain| <
    1e-4, the same bits on a second launch, rows past sum(gs) zero, one
    launch under its own key."""
    E = 128
    g = torch.Generator(device=cuda).manual_seed(S + bits)
    xs = torch.randn(S, K, generator=g, device=cuda).bfloat16()
    w = _k5_experts(cuda, E, N, K, bits, seed=S, gs=gs)
    gs_ = _ragged(E, S - 5, cuda, seed=S)
    _build.reset_launches()
    got = tgmm.grouped_matmul(xs, w, gs_)
    assert dict(_build.LAUNCHES) == {f"k5_w{bits}": 1}
    want = tgmm.grouped_matmul_reference(xs, w, gs_)
    again = tgmm.grouped_matmul(xs, w, gs_)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (S, N)
    assert _rel(got, want) < 1e-4
    assert torch.equal(got, again)
    assert torch.equal(got[S - 5:], torch.zeros_like(got[S - 5:]))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("S", [9, 100, 1000])
def test_k5_streamed_scales_at_mixtral_down(cuda, bits, S):
    """Mixtral-8x7B's down projection (8 experts, N = 4096, K = 14336,
    group 64: 224 groups a row, whose scales and biases K5 streams from
    global memory instead of staging them), packed, on skewed groups
    (empty ones, a one-row group, one of S/2): max error over max |plain|
    < 1e-4, the same bits on a second launch, one launch."""
    E, N, K = 8, 4096, 14336
    assert tgmm.k5_plan(K, bits, 64).stream
    g = torch.Generator(device=cuda).manual_seed(S + bits)
    xs = torch.randn(S, K, generator=g, device=cuda).bfloat16()
    w = _k5_experts(cuda, E, N, K, bits, seed=S, gs=64)
    gs_ = _ragged(E, S, cuda, seed=S)
    _build.reset_launches()
    got = tgmm.grouped_matmul(xs, w, gs_)
    assert dict(_build.LAUNCHES) == {f"k5_w{bits}": 1}
    want = tgmm.grouped_matmul_reference(xs, w, gs_)
    again = tgmm.grouped_matmul(xs, w, gs_)
    torch.cuda.synchronize()
    assert _rel(got, want) < 1e-4
    assert torch.equal(got, again)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("K", [512, 14336])
def test_k5_packed_one_hot_rows_return_dequantized(cuda, bits, K):
    """A one-hot row of x against packed experts returns a column of
    dequantize_experts(w) bit for bit: the kernel dequantizes with the
    plain version's rounding (the exact product, one f32 rounding of the
    sum, one bf16 rounding), with its scales staged (K = 512) and
    streamed (K = 14336)."""
    E, N = 4, 256
    w = _k5_experts(cuda, E, N, K, bits, seed=bits)
    dense = qm.dequantize_experts(w)
    cols = torch.arange(0, K, 3, device=cuda)[:100]      # 100 rows a group
    counts = torch.tensor([100, 0, 100, 100], device=cuda)
    xs = torch.zeros(300, K, device=cuda, dtype=torch.bfloat16)
    xs[torch.arange(300, device=cuda), cols.repeat(3)] = 1
    got = tgmm.grouped_matmul(xs, w, counts)
    want = torch.cat([dense[e][:, cols].T.float() for e in (0, 2, 3)])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_moe_block_runs_k4_k5_and_k8(cuda):
    """A MoE layer on CUDA sends decode (M <= 8) to K4 twice (4- and 8-bit
    experts) or K8 twice (channel-int8 experts): gate and up in one
    launch, down in another; and a prefill
    (M > 8) to K5 three times (group experts read packed, under "k5_w4"
    or "k5_w8"; no dequantize-once) or to the exact int8 all-expert pass,
    which runs torch._int_mm and no kernel of the port; bf16 experts
    prefill through K5 ("k5")."""
    from ominix_mlx_tpu_torch.models import moe

    mcfg = moe.MoEConfig(num_experts=16, top_k=4, norm_topk_prob=True,
                         moe_intermediate_size=256)
    gen = torch.Generator(device=cuda).manual_seed(0)
    cases = (
        (moe.init_quantized_moe_params(gen, 256, mcfg, device=cuda),
         {"k4": 2}, {"k5_w4": 3}),
        (moe.init_quantized_moe_params(gen, 256, mcfg, device=cuda, bits=8),
         {"k4_w8": 2}, {"k5_w8": 3}),
        (moe.init_quantized_moe_params(gen, 256, mcfg, device=cuda,
                                       scheme="channel8"), {"k8": 2}, {}))
    lpd = moe.init_moe_params(gen, 256, mcfg, device=cuda)
    for lpq, decode, prefill in cases:
        for M, want in ((2, decode), (24, prefill)):
            x = torch.randn(1, M, 256, generator=gen, device=cuda).bfloat16()
            _build.reset_launches()
            y = moe.moe_block(lpq, mcfg, x)
            assert {k: v for k, v in _build.LAUNCHES.items() if v} == want
            assert torch.isfinite(y).all()
    _build.reset_launches()
    moe.moe_block(lpd, mcfg, torch.randn(1, 24, 256, device=cuda).bfloat16())
    assert _build.LAUNCHES["k5"] == 3


# ------------------------- Qwen3-Next: K9, and K2, K4, K5 at its shapes ----

K9_TOL = 1e-4   # max error over max |plain|: float32 sums in another order


def _k9_inputs(dev, B, T, Hk, r, dk=128, dv=128, seed=0, low=1.5):
    """Inputs of the gated delta rule as a DeltaNet layer gives them:
    l2-normed q (scaled by dk^-0.5) and k, g in (-low, 0), beta in (0,
    1), and a carried state that is not zero."""
    from torch.nn.functional import normalize

    g = torch.Generator(device=dev).manual_seed(seed)
    Hv = Hk * r

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    return {"q": normalize(randn(B, T, Hk, dk), dim=-1) * dk ** -0.5,
            "k": normalize(randn(B, T, Hk, dk), dim=-1),
            "v": randn(B, T, Hv, dv),
            "g": -torch.rand(B, T, Hv, generator=g, device=dev) * low,
            "beta": torch.rand(B, T, Hv, generator=g, device=dev),
            "state": randn(B, Hv, dk, dv) * 0.1}


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("B,T", [(1, 1), (8, 1), (1, 128), (2, 1000)])
def test_k9_matches_plain(cuda, B, T, r):
    """K9 at Qwen3-Next's widths (16 key heads, dk = dv = 128; r = 2 is
    its 32 value heads) against the plain version: outputs and the final
    state (written in place) within K9_TOL of max |plain|, the launches
    of the form k9_plan picks (recurrent at T = 1, chunked at 128 and
    1000), the same bits on a second run."""
    a = _k9_inputs(cuda, B, T, 16, r, seed=B * T + r)
    s1, s2, s3 = (a["state"].clone() for _ in range(3))
    args = [a[n] for n in ("q", "k", "v", "g", "beta")]
    _build.reset_launches()
    got = gd.gated_delta_rule(*args, s1)
    assert dict(_build.LAUNCHES) == gd.k9_launches(B, T, 16 * r, 128, 128)
    want = gd.gated_delta_rule_reference(*args, s2)
    again = gd.gated_delta_rule(*args, s3)
    torch.cuda.synchronize()
    assert got.shape == (B, T, 16 * r, 128) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert _rel(got, want) < K9_TOL and _rel(s1, s2) < K9_TOL
    assert torch.equal(got, again) and torch.equal(s1, s3)


@pytest.mark.parametrize("dk,dv", [(64, 48), (256, 96), (32, 200)])
def test_k9_other_widths_match_plain(cuda, dk, dv):
    """The other head widths K9 is built for, and value widths that are
    not a multiple of its 32 columns a CTA (the ragged CTA's dead columns
    read and write nothing)."""
    a = _k9_inputs(cuda, 2, 37, 2, 2, dk=dk, dv=dv, seed=dk + dv)
    s1, s2 = a["state"].clone(), a["state"].clone()
    args = [a[n] for n in ("q", "k", "v", "g", "beta")]
    got = gd.gated_delta_rule(*args, s1)
    want = gd.gated_delta_rule_reference(*args, s2)
    torch.cuda.synchronize()
    assert _rel(got, want) < K9_TOL and _rel(s1, s2) < K9_TOL


def test_k9_carries_the_state_across_calls(cuda):
    """Two calls of 50 and 78 tokens on one state equal one call of 128
    (K9_TOL), the state advanced in place by each."""
    a = _k9_inputs(cuda, 2, 128, 16, 2, seed=7)
    whole, parts = a["state"].clone(), a["state"].clone()
    names = ("q", "k", "v", "g", "beta")
    one = gd.gated_delta_rule(*(a[n] for n in names), whole)
    two = torch.cat([gd.gated_delta_rule(
        *(a[n][:, sl].contiguous() for n in names), parts)
        for sl in (slice(0, 50), slice(50, 128))], 1)
    torch.cuda.synchronize()
    assert _rel(two, one) < K9_TOL and _rel(parts, whole) < K9_TOL


@pytest.mark.parametrize("decay", [1.5, 20.0])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("B,T", [(1, 65), (1, 128), (2, 1000), (1, 2048)])
def test_k9_chunked_matches_plain(cuda, B, T, r, decay):
    """K9's chunked form (3xTF32 on the tensor cores) against the plain
    version at Qwen3-Next's widths, at decays down to -1.5 and -20 a token
    (G near -1300 within a chunk): outputs and the final state within
    K9_TOL of max |plain|, finite, one launch of each phase, the same bits
    on a second run."""
    a = _k9_inputs(cuda, B, T, 16, r, seed=7 * T + B + r, low=decay)
    s1, s2, s3 = (a["state"].clone() for _ in range(3))
    args = [a[n] for n in ("q", "k", "v", "g", "beta")]
    _build.reset_launches()
    got = gd._k9_chunked(*args, s1)
    assert dict(_build.LAUNCHES) == {"k9_chunk": 1, "k9_chunk_scan": 1}
    want = gd.gated_delta_rule_reference(*args, s2)
    again = gd._k9_chunked(*args, s3)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.isfinite(s1).all()
    assert _rel(got, want) < K9_TOL and _rel(s1, s2) < K9_TOL
    assert torch.equal(got, again) and torch.equal(s1, s3)


@pytest.mark.parametrize("T", [31, 128])
def test_k9_recurrent_form_at_prompt_lengths(cuda, T):
    """The recurrent form, which the plan keeps below K9_CHUNK_MIN_T, over
    a prompt (T = 31) and past the crossover (T = 128, called directly):
    within K9_TOL of the plain version, one "k9" launch."""
    a = _k9_inputs(cuda, 1, T, 16, 2, seed=T)
    s1, s2 = a["state"].clone(), a["state"].clone()
    args = [a[n] for n in ("q", "k", "v", "g", "beta")]
    _build.reset_launches()
    got = gd._k9(*args, s1)
    assert dict(_build.LAUNCHES) == {"k9": 1}
    want = gd.gated_delta_rule_reference(*args, s2)
    torch.cuda.synchronize()
    assert _rel(got, want) < K9_TOL and _rel(s1, s2) < K9_TOL


@pytest.mark.parametrize("cuts", [(20, 45, 100), (1, 63, 65, 130),
                                  (130, 1, 2)])
def test_k9_state_across_calls_of_either_form(cuda, cuts):
    """Calls of lengths that are not multiples of 64, each in the form the
    plan picks (recurrent under K9_CHUNK_MIN_T, chunked from it), carry
    the state as one call over the whole sequence (K9_TOL), launching
    exactly what k9_launches says."""
    T = sum(cuts)
    a = _k9_inputs(cuda, 1, T, 16, 2, seed=T, low=4.0)
    names = ("q", "k", "v", "g", "beta")
    whole, parts = a["state"].clone(), a["state"].clone()
    want = gd.gated_delta_rule_reference(*(a[n] for n in names), whole)
    _build.reset_launches()
    outs, t0, counts = [], 0, {}
    for n in cuts:
        sl = slice(t0, t0 + n)
        outs.append(gd.gated_delta_rule(
            *(a[x][:, sl].contiguous() for x in names), parts))
        for key, c in gd.k9_launches(1, n, 32, 128, 128).items():
            counts[key] = counts.get(key, 0) + c
        t0 += n
    assert dict(_build.LAUNCHES) == counts
    torch.cuda.synchronize()
    assert _rel(torch.cat(outs, 1), want) < K9_TOL
    assert _rel(parts, whole) < K9_TOL


def _prep_inputs(dev, B, T, dtype, Hk=16, r=2, d=128, seed=0):
    """A DeltaNet layer's projections and parameters at Qwen3-Next's
    heads: qkvz and ba as the projections write them, a carried conv
    window, the taps, A_log and dt_bias as init_layer_params makes them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    Hv = Hk * r
    C = 2 * Hk * d + Hv * d

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    return {"qkvz": randn(B, T, Hk * (2 * d + 2 * r * d)).to(dtype),
            "ba": (2 * randn(B, T, 2 * Hv)).to(dtype),
            "window": randn(B, 3, C).to(dtype),
            "conv_w": (randn(C, 4) * 0.5).to(dtype),
            "A_log": (1 + 15 * torch.rand(Hv, generator=g, device=dev)).log(),
            "dt_bias": randn(Hv) - 4,
            "heads": (Hk, Hv, d, d)}


K9_PREP_TOL = 1e-5   # max error / max |plain|: l2norm's sum in another order


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T", [(1, 1), (8, 1), (1, 300)])
def test_k9_prep_matches_plain(cuda, B, T, dtype):
    """k9_prep against deltanet_prep_reference on the same inputs: q, k,
    v, g, beta within K9_PREP_TOL of max |plain| (v, g and beta read 0:
    the same float32 roundings), the window written in place bit for bit,
    one launch; then a second call on the advanced window."""
    a = _prep_inputs(cuda, B, T, dtype, seed=T + B)
    w1, w2 = a["window"].clone(), a["window"].clone()
    rest = (a["conv_w"], a["A_log"], a["dt_bias"], a["heads"])
    for call in range(2):
        _build.reset_launches()
        got = gd.k9_prep(a["qkvz"], a["ba"], w1, *rest)
        assert dict(_build.LAUNCHES) == {"k9_prep": 1}
        want = gd.deltanet_prep_reference(a["qkvz"], a["ba"], w2, *rest)
        torch.cuda.synchronize()
        assert torch.equal(w1, w2), call
        for name, x, y in zip(("q", "k", "v", "g", "beta"), got, want):
            assert x.dtype == torch.float32 and x.shape == y.shape, name
            assert _rel(x, y) < K9_PREP_TOL, (call, name, _rel(x, y))
        a["qkvz"] = a["qkvz"].flip(1).contiguous()


def test_k9_prep_window_rows_of_a_short_call(cuda):
    """T = 2 < K - 1: the new window keeps the old window's last row
    before the two new inputs, as the plain version's slice of
    [window; x] does."""
    a = _prep_inputs(cuda, 2, 2, torch.bfloat16, seed=3)
    w1, w2 = a["window"].clone(), a["window"].clone()
    rest = (a["conv_w"], a["A_log"], a["dt_bias"], a["heads"])
    gd.k9_prep(a["qkvz"], a["ba"], w1, *rest)
    gd.deltanet_prep_reference(a["qkvz"], a["ba"], w2, *rest)
    torch.cuda.synchronize()
    assert torch.equal(w1, w2)
    assert torch.equal(w1[:, 0], a["window"][:, 2])


def test_k9_rejects(cuda):
    a = _k9_inputs(cuda, 1, 4, 2, 1, dk=48, dv=32)
    args = [a[n] for n in ("q", "k", "v", "g", "beta")]
    with pytest.raises(ValueError, match="dk in"):
        gd._k9(*args, a["state"])
    b = _k9_inputs(cuda, 1, 4, 2, 1, dk=64, dv=32)
    with pytest.raises(ValueError, match="state"):
        gd._k9(*(b[n] for n in ("q", "k", "v", "g", "beta")),
               b["state"].bfloat16())
    with pytest.raises(ValueError, match="K9 v"):
        gd._k9(b["q"], b["k"], b["v"][:, :, :, ::2], b["g"], b["beta"],
               b["state"])


def test_deltanet_block_launches_k9_once(cuda):
    """A DeltaNet layer on the card runs a decode step (T = 1) through
    k9_decode, one launch, and a prompt's prologue through k9_prep and its
    recurrence through K9 in the planned form, one launch each (the
    chunked form's two phases at T = 300); its output is within 2e-2 of
    the same layer with the plain mixer (bf16 activations), the state
    within K9_TOL, the window equal."""
    from ominix_mlx_tpu_torch.models import deltanet as dn

    dcfg = dn.DeltaNetConfig(num_v_heads=32, num_k_heads=16, head_k_dim=128,
                             head_v_dim=128)
    g = torch.Generator(device=cuda).manual_seed(0)

    def make(o, i):
        return (torch.randn(o, i, generator=g, device=cuda)
                * i ** -0.5).bfloat16()

    lp = dn.init_layer_params(dcfg, 2048, g, make, device=cuda)
    for T in (1, 40, 300):
        x = torch.randn(2, T, 2048, generator=g, device=cuda).bfloat16()
        c1 = dn.RecurrentCache.init(2, dcfg, device=cuda)
        c2 = dn.RecurrentCache.init(2, dcfg, device=cuda)
        _build.reset_launches()
        y1, _ = dn.block(lp, dcfg, x, c1)
        assert dict(_build.LAUNCHES) == gd.deltanet_launches(2, T, 32, 128,
                                                             128)
        real = dn.gated_delta_rule, dn.k9_prep, dn.deltanet_decode
        dn.gated_delta_rule = gd.gated_delta_rule_reference
        dn.k9_prep = gd.deltanet_prep_reference
        dn.deltanet_decode = (lambda *a, overlap=False:
                              gd.deltanet_decode_reference(*a))
        try:
            y2, _ = dn.block(lp, dcfg, x, c2)
        finally:
            dn.gated_delta_rule, dn.k9_prep, dn.deltanet_decode = real
        torch.cuda.synchronize()
        assert _rel(y1, y2) < 2e-2 and _rel(c1.state, c2.state) < K9_TOL
        assert torch.equal(c1.conv, c2.conv)


# ---------------------------- k9_decode (DeltaNet decode mixer) -----------

# k9_decode's output against deltanet_decode_reference: o is K9's float32
# sum (another order than the plain version's einsum) from q and k within
# K9_PREP_TOL of the plain ones, so an element of o cast to bf16 may take
# the other neighbour (one ulp of that element, at most one of the head's
# largest), the norm's mean moves by a fraction of an ulp, and the three
# roundings after it (the normalized value, the weight's product, the
# gate's product) each add at most one: within 4 bf16 ulps of the value
# head's largest |plain| output (the spacing 2^(floor(log2 max) - 7)).
K9_DECODE_ULPS = 4


def _head_ulps(got, want, dv=128):
    """max |got - want| in bf16 ulps of each value head's largest |want|:
    [B, 1, Hv dv] seen as [B, Hv, dv] rows."""
    B = got.shape[0]
    return _row_ulps(got.reshape(B, -1, dv), want.reshape(B, -1, dv))


def _mixer_inputs(dev, B, dtype=torch.bfloat16, r=2, seed=0, strong=False,
                  Hk=16):
    """A DeltaNet layer's decode-step inputs at Qwen3-Next's widths (16 key
    heads of 128, r value heads each): _prep_inputs' qkvz, ba, window,
    taps and gates (dt_bias near -4, a weak decay, or near +4 with
    ``strong``: exp(g) down to e^-60), a carried state and a norm weight
    near one. At B > 1 the rows are ragged: row 0 a fresh slot (zero state
    and window), the others' states at scales 0.01 to 1."""
    a = _prep_inputs(dev, B, 1, dtype, Hk=Hk, r=r, seed=seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    if strong:
        a["dt_bias"] = a["dt_bias"] + 8
    scale = torch.logspace(-2, 0, B, device=dev)[:, None, None, None]
    a["state"] = torch.randn(B, Hk * r, 128, 128, generator=g,
                             device=dev) * scale
    if B > 1:
        a["state"][0] = 0
        a["window"][0] = 0
    a["norm_w"] = (1 + 0.1 * torch.randn(128, generator=g, device=dev)).to(
        dtype)
    return a


def _mixer_args(a, window, state):
    return (a["qkvz"], a["ba"], window, a["conv_w"], a["A_log"],
            a["dt_bias"], state, a["norm_w"], EPS, a["heads"])


def _parent_mixer(qkvz, ba, window, conv_w, A_log, dt_bias, state, norm_w,
                  eps, heads):
    """The decode mixer as the layer composed it before k9_decode: k9_prep,
    K9's recurrent form, then the cast, rms_norm and * silu(z) op by op."""
    from torch.nn.functional import silu

    q, k, v, g, beta = gd._k9_prep(qkvz, ba, window, conv_w, A_log,
                                   dt_bias, heads)
    z = gd.split_qkvz_ba(qkvz, ba, heads)[3]
    out = gd._k9(q, k, v, g, beta, state)
    out = qm.rms_norm(norm_w, out.to(qkvz.dtype), eps) * silu(z)
    return out.reshape(qkvz.shape[0], 1, -1)


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("B", [1, 8])
def test_k9_decode_matches_the_pair_and_plain(cuda, B, strong):
    """k9_decode at Qwen3-Next's heads (B = 8: ragged rows, one a fresh
    slot), weak and strong decay, two steps in a row: the state and the
    window bit for bit as k9_prep then K9 leave them, the output within
    K9_DECODE_ULPS of that pair's glue and of deltanet_decode_reference
    (whose state it holds within K9_TOL, its window bit for bit); one
    launch a call."""
    a = _mixer_inputs(cuda, B, seed=B + 10 * strong, strong=strong)
    w1, w2, w3 = (a["window"].clone() for _ in range(3))
    s1, s2, s3 = (a["state"].clone() for _ in range(3))
    for step in range(2):
        _build.reset_launches()
        got = gd.deltanet_decode(*_mixer_args(a, w1, s1))
        assert dict(_build.LAUNCHES) == {"k9_decode": 1}
        pair = _parent_mixer(*_mixer_args(a, w2, s2))
        want = gd.deltanet_decode_reference(*_mixer_args(a, w3, s3))
        torch.cuda.synchronize()
        assert got.shape == (B, 1, 32 * 128) and got.dtype == torch.bfloat16
        assert got.is_contiguous() and torch.isfinite(got.float()).all()
        assert torch.equal(w1, w2) and torch.equal(s1, s2), step
        assert torch.equal(w1, w3) and _rel(s1, s3) < K9_TOL, step
        assert _head_ulps(got, pair) <= K9_DECODE_ULPS, step
        assert _head_ulps(got, want) <= K9_DECODE_ULPS, step
        a["qkvz"] = a["qkvz"].flip(-1).contiguous()


@pytest.mark.parametrize("r", [1, 3, 4])
def test_k9_decode_at_other_head_ratios(cuda, r):
    """Hv / Hk = 1, 3 and 4 (clusters of 4, 12 and 16 CTAs) at 8 key heads
    and B = 2: the state and the window bit for bit as the pair's, the
    output within K9_DECODE_ULPS of the plain version's."""
    a = _mixer_inputs(cuda, 2, r=r, seed=r, Hk=8)
    w1, w2, w3 = (a["window"].clone() for _ in range(3))
    s1, s2, s3 = (a["state"].clone() for _ in range(3))
    got = gd.deltanet_decode(*_mixer_args(a, w1, s1))
    _parent_mixer(*_mixer_args(a, w2, s2))
    want = gd.deltanet_decode_reference(*_mixer_args(a, w3, s3))
    torch.cuda.synchronize()
    assert torch.equal(w1, w2) and torch.equal(s1, s2)
    assert _head_ulps(got, want) <= K9_DECODE_ULPS


def test_k9_decode_float32_x(cuda):
    """float32 x (no path sends it; k9_prep takes it, so the mixer does):
    the state and the window bit for bit as the pair's, the output within
    K9_TOL of max |plain| (no cast rounds o)."""
    a = _mixer_inputs(cuda, 2, dtype=torch.float32, seed=4)
    w1, w2, w3 = (a["window"].clone() for _ in range(3))
    s1, s2, s3 = (a["state"].clone() for _ in range(3))
    got = gd.deltanet_decode(*_mixer_args(a, w1, s1))
    pair = _parent_mixer(*_mixer_args(a, w2, s2))
    want = gd.deltanet_decode_reference(*_mixer_args(a, w3, s3))
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.equal(w1, w2) and torch.equal(s1, s2)
    assert _rel(got, pair) < K9_TOL and _rel(got, want) < K9_TOL


def test_k9_decode_repeatable_graphed_and_overlapped(cuda):
    """20 calls from the same state and window give the same bits; a CUDA
    graph's replay, three times, gives the eager call's; launched by
    dependent launch behind a projection (the model's call: a kernel
    that writes neither the state nor the taps nor the norm weight) it
    gives them too."""
    a = _mixer_inputs(cuda, 8, seed=21)
    s0, w0 = a["state"].clone(), a["window"].clone()
    st, wn = s0.clone(), w0.clone()
    base = gd._k9_decode(*_mixer_args(a, wn, st))
    torch.cuda.synchronize()
    for _ in range(20):
        s, w = s0.clone(), w0.clone()
        out = gd._k9_decode(*_mixer_args(a, w, s))
        torch.cuda.synchronize()
        assert torch.equal(out, base) and torch.equal(s, st) \
            and torch.equal(w, wn)
    x = torch.randn(8, 2048, device=cuda).bfloat16()
    proj = torch.randn(a["qkvz"].shape[-1], 2048, device=cuda).bfloat16()
    s, w = s0.clone(), w0.clone()
    torch.cuda.synchronize()
    _build.reset_launches()
    (x @ proj.T).sum()                 # kernels just before, not the state
    over = gd._k9_decode(*_mixer_args(a, w, s), overlap=True)
    assert dict(_build.LAUNCHES) == {"k9_decode": 1}
    torch.cuda.synchronize()
    assert torch.equal(over, base) and torch.equal(s, st) \
        and torch.equal(w, wn)
    gs, gw = s0.clone(), w0.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gd._k9_decode(*_mixer_args(a, gw, gs))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = gd._k9_decode(*_mixer_args(a, gw, gs))
    for _ in range(3):
        gs.copy_(s0)
        gw.copy_(w0)
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, base) and torch.equal(gs, st) \
            and torch.equal(gw, wn)


def test_k9_decode_on_row_views_of_a_batched_cache(cuda):
    """The batcher's row views (RecurrentCache.rows) reach the kernel as
    they are: a call on row 2 of a 4-row cache writes that row's state
    and window in the cache's buffers, bit for bit as a call on copies,
    and leaves the other rows alone."""
    from ominix_mlx_tpu_torch.models import deltanet as dn

    dcfg = dn.DeltaNetConfig(num_v_heads=32, num_k_heads=16, head_k_dim=128,
                             head_v_dim=128)
    a = _mixer_inputs(cuda, 1, seed=31)
    cache = dn.RecurrentCache.init(4, dcfg, device=cuda)
    cache.state.normal_()
    cache.conv.normal_()
    before = cache.state.clone(), cache.conv.clone()
    row = cache.rows(2)
    s, w = row.state.clone(), row.conv.clone()
    got = gd.deltanet_decode(*_mixer_args(a, row.conv, row.state))
    want = gd.deltanet_decode(*_mixer_args(a, w, s))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(cache.state[2], s[0])
    assert torch.equal(cache.conv[2], w[0])
    for b in (0, 1, 3):
        assert torch.equal(cache.state[b], before[0][b])
        assert torch.equal(cache.conv[b], before[1][b])


def test_k9_decode_rejects(cuda):
    a = _mixer_inputs(cuda, 1, seed=41)
    w, s = a["window"], a["state"]
    with pytest.raises(ValueError, match="k9_decode state"):
        gd._k9_decode(*_mixer_args(a, w, s.bfloat16()))
    with pytest.raises(ValueError, match="k9_decode state"):
        gd._k9_decode(*_mixer_args(a, w, s.transpose(2, 3)))
    with pytest.raises(ValueError, match="k9_decode window"):
        gd._k9_decode(*_mixer_args(a, w.float(), s))
    with pytest.raises(ValueError, match="k9_decode qkvz"):
        gd._k9_decode(a["qkvz"][..., 8:], *_mixer_args(a, w, s)[1:])
    with pytest.raises(ValueError, match="k9_decode norm_w"):
        gd._k9_decode(*_mixer_args({**a, "norm_w": a["norm_w"].float()}, w,
                                   s))
    b = _mixer_inputs(cuda, 1, r=8, Hk=2, seed=42)
    with pytest.raises(ValueError, match="Hv a multiple of Hk at most"):
        gd._k9_decode(*_mixer_args(b, b["window"], b["state"]))
    c = _prep_inputs(cuda, 1, 2, torch.bfloat16)
    with pytest.raises(ValueError, match="T = 1"):
        gd._k9_decode(c["qkvz"], c["ba"], c["window"], c["conv_w"],
                      c["A_log"], c["dt_bias"], a["state"], a["norm_w"], EPS,
                      c["heads"])


def test_k2_k2c_at_qwen3_next_heads(cuda):
    """Qwen3-Next's attention layers: 16 query heads over 2 KV heads of
    D = 256. K2 at T = 2048 and K2c on its second half against their
    plain versions (1e-2 of max |plain|, bf16 output)."""
    g = torch.Generator(device=cuda).manual_seed(13)
    T, H, Hkv, D = 2048, 16, 2, 256
    q = torch.randn(1, H, T, D, generator=g, device=cuda).bfloat16()
    k = torch.randn(1, Hkv, T, D, generator=g, device=cuda).bfloat16()
    v = torch.randn(1, Hkv, T, D, generator=g, device=cuda).bfloat16()
    _build.reset_launches()
    out = fa.flash_prefill(q, k, v, D ** -0.5)
    chunk = fa.flash_chunk_prefill(q[:, :, 1024:].contiguous(), k, v, 1024,
                                   D ** -0.5)
    assert dict(_build.LAUNCHES) == {"k2": 1, "k2c": 1}
    want, _ = fa.flash_prefill_reference(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert _rel(out, want) < 1e-2
    assert _rel(chunk, want[:, :, 1024:]) < 1e-2


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("T,k,N,K", [(1, 10, 512, 2048), (10, 1, 2048, 512),
                                     (8, 10, 512, 2048)])
def test_k4_at_512_experts_top_10(cuda, T, k, N, K, bits):
    """Qwen3-Next-80B-A3B's experts at decode: 512 of them, 10 a token;
    gate/up (N 512, K 2048) at one and 8 rows, down (N 2048, K 512) at
    10 rows. The "k4" route, one launch, within 1e-2 of the plain version
    per (row, slot)."""
    E = 512
    w, g = _experts(cuda, E, N, K, seed=T * k + bits, bits=bits)
    x = torch.randn(T, K, generator=g, device=cuda).bfloat16()
    ids = _ids(g, cuda, E, T, k)
    assert qm.expert_route(w, T) == "k4"
    _build.reset_launches()
    got = qm.gather_qmm(x, w, ids)
    assert dict(_build.LAUNCHES) == {"k4" if bits == 4 else "k4_w8": 1}
    want = qm.gather_qmm_reference(x, w, ids, act_bits=8)
    torch.cuda.synchronize()
    assert _row_rel(got, want) < 1e-2


@pytest.mark.parametrize("bits", [4, 16])
@pytest.mark.parametrize("N,K", [(512, 2048), (2048, 512)])
def test_k5_at_512_experts(cuda, bits, N, K):
    """Qwen3-Next-80B-A3B's experts at prefill: a 128-token prompt routes
    S = 1280 token copies over 512 experts (about 2.5 rows a group, most
    groups of 0-8 rows), 4-bit packed (the main path) and bf16, against
    the plain version at 1e-4 of max |plain|, the same bits twice."""
    E, S = 512, 1280
    g = torch.Generator(device=cuda).manual_seed(N + bits)
    xs = torch.randn(S, K, generator=g, device=cuda).bfloat16()
    if bits == 16:
        w = (torch.randn(E, N, K, generator=g, device=cuda)
             * K ** -0.5).bfloat16()
    else:
        w = _k5_experts(cuda, E, N, K, bits, seed=N)
    ids = torch.randint(0, E, (S,), generator=g, device=cuda)
    gs = torch.bincount(ids, minlength=E)
    _build.reset_launches()
    got = tgmm.grouped_matmul(xs, w, gs)
    assert sum(_build.LAUNCHES.values()) == 1
    want = tgmm.grouped_matmul_reference(xs, w, gs)
    again = tgmm.grouped_matmul(xs, w, gs)
    torch.cuda.synchronize()
    assert _rel(got, want) < 1e-4 and torch.equal(got, again)


# ------------------------------------------ K10 (lightning attention) -------

K10_TOL = 2e-5  # max error over max |plain|: float32 sums in another order


def _k10_inputs(dev, B, T, H=32, D=128, dtype=torch.bfloat16, seed=0,
                strong=1.0):
    """Inputs of K10 as a lightning layer gives them: q scaled by
    D^-0.5 after the norm, k, v, MiniCPM-SALA's slopes (times ``strong``
    for a stronger decay) and a carried state that is not zero."""
    from ominix_mlx_tpu_torch.models.lightning import alibi_slopes

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    return (((randn(B, H, T, D)) * D ** -0.5).to(dtype),
            randn(B, H, T, D).to(dtype), randn(B, H, T, D).to(dtype),
            torch.from_numpy(alibi_slopes(H) * strong).to(dev),
            randn(B, H, D, D) * 0.1)


def _k10_check(got, want, s_got, s_want):
    assert torch.isfinite(got).all() and torch.isfinite(s_got).all()
    assert _rel(got, want) < K10_TOL
    assert _rel(s_got, s_want) < K10_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,H,D", [(1, 1, 32, 128), (8, 1, 32, 128),
                                     (2, 37, 4, 128), (1, 200, 8, 128)])
def test_k10_recurrent_matches_plain(cuda, B, T, H, D, dtype):
    """K10's recurrent form against lightning_reference: outputs and the
    state written in place within K10_TOL of max |plain|, one "k10"
    launch, the same bits on a second launch."""
    q, k, v, sl, state = _k10_inputs(cuda, B, T, H, D, dtype, seed=B + T)
    s1, s2, s3 = state.clone(), state.clone(), state.clone()
    _build.reset_launches()
    got = la._k10(q, k, v, sl, s1)
    assert dict(_build.LAUNCHES) == {"k10": 1}
    want = la.lightning_reference(q, k, v, sl, s2)
    again = la._k10(q, k, v, sl, s3)
    torch.cuda.synchronize()
    _k10_check(got, want, s1, s2)
    assert torch.equal(got, again) and torch.equal(s1, s3)


@pytest.mark.parametrize("strong", [1.0, 8.0])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T", [(1, 32), (1, 100), (2, 1000), (1, 2048)])
def test_k10_chunked_matches_plain(cuda, B, T, dtype, strong):
    """K10's chunked form (a partial final chunk at 100 and 1000) against
    lightning_reference at MiniCPM-SALA's 32 heads of 128, and with the
    decay eight times as strong: outputs and state within K10_TOL, its
    one launch counted, bit-repeatable."""
    q, k, v, sl, state = _k10_inputs(cuda, B, T, dtype=dtype, seed=T + B,
                                     strong=strong)
    s1, s2, s3 = state.clone(), state.clone(), state.clone()
    _build.reset_launches()
    got = la._k10_chunked(q, k, v, sl, s1)
    assert dict(_build.LAUNCHES) == {"k10_chunk": 1}
    want = la.lightning_reference(q, k, v, sl, s2)
    again = la._k10_chunked(q, k, v, sl, s3)
    torch.cuda.synchronize()
    _k10_check(got, want, s1, s2)
    assert torch.equal(got, again) and torch.equal(s1, s3)


@pytest.mark.parametrize("cuts", [(1, 40, 100), (64, 1, 200, 1),
                                  (300, 5, 700)])
def test_k10_state_across_calls_of_either_form(cuda, cuts):
    """A prompt fed in pieces, each through the form k10_plan picks, and
    the whole prompt through the plain version: the outputs and the final
    state agree within K10_TOL, and the launches are what k10_launches
    says."""
    T = sum(cuts)
    q, k, v, sl, state = _k10_inputs(cuda, 1, T, seed=T, strong=2.0)
    s1, s2 = state.clone(), state.clone()
    want = la.lightning_reference(q, k, v, sl, s2)
    _build.reset_launches()
    outs, t0, counts = [], 0, {}
    for n in cuts:
        sl_t = slice(t0, t0 + n)
        outs.append(la.lightning_attention(q[:, :, sl_t], k[:, :, sl_t],
                                           v[:, :, sl_t], sl, s1))
        for key, c in la.k10_launches(1, n, 32, 128).items():
            counts[key] = counts.get(key, 0) + c
        t0 += n
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == counts
    _k10_check(torch.cat(outs, 2), want, s1, s2)


def test_k10_reads_strided_views(cuda):
    """q, k and v as the model hands them: views of [B, T, H, D]
    projections transposed to [B, H, T, D], read in place by both forms."""
    for T in (1, 150):
        g = torch.Generator(device=cuda).manual_seed(T)
        qkv = torch.randn(2, T, 3 * 32 * 128, generator=g, device=cuda,
                          dtype=torch.bfloat16) * 0.1
        q, k, v = (t.reshape(2, T, 32, 128).transpose(1, 2)
                   for t in qkv.split(32 * 128, -1))
        sl = _k10_inputs(cuda, 1, 1)[3]
        s1 = torch.randn(2, 32, 128, 128, generator=g, device=cuda) * 0.1
        s2 = s1.clone()
        got = la.lightning_attention(q, k, v, sl, s1)
        want = la.lightning_reference(q, k, v, sl, s2)
        torch.cuda.synchronize()
        _k10_check(got, want, s1, s2)


def test_k10_rejects(cuda):
    q, k, v, sl, state = _k10_inputs(cuda, 1, 4, 2, 128)
    with pytest.raises(ValueError, match="state"):
        la._k10(q, k, v, sl, state.bfloat16())
    with pytest.raises(ValueError, match="K10 k"):
        la._k10(q, torch.stack([k, k], -1)[..., 0], v, sl, state)
    with pytest.raises(ValueError, match="bf16 or float32"):
        la._k10(q.half(), k.half(), v.half(), sl, state)
    q, k, v, sl, state = _k10_inputs(cuda, 1, 4, 2, 64)
    for form in (la._k10, la._k10_chunked):
        with pytest.raises(ValueError, match="D in"):
            form(q, k, v, sl, state)


@pytest.mark.parametrize("T", [24, 65, 2048, 8192])
@pytest.mark.parametrize("B", [1, 8])
def test_k10_chunked_strong_decay_and_cuts(cuda, B, T):
    """The one-launch chunked form at MiniCPM-SALA's 32 heads of 128 with
    decays eight times as strong: one launch, outputs and state within
    K10_TOL of the plain version, bit-repeatable; and the same prompt cut
    in two calls at a point inside a chunk gives the same state (and
    outputs) within K10_TOL."""
    q, k, v, sl, state = _k10_inputs(cuda, B, T, seed=3 * T + B,
                                     strong=8.0)
    s1, s2, s3 = state.clone(), state.clone(), state.clone()
    _build.reset_launches()
    got = la._k10_chunked(q, k, v, sl, s1)
    assert dict(_build.LAUNCHES) == {"k10_chunk": 1}
    want = la.lightning_reference(q, k, v, sl, s2)
    again = la._k10_chunked(q, k, v, sl, s3)
    torch.cuda.synchronize()
    _k10_check(got, want, s1, s2)
    assert torch.equal(got, again) and torch.equal(s1, s3)
    cut = T // 2 + 7 if T > 24 else 11
    s4 = state.clone()
    first = la._k10_chunked(q[:, :, :cut], k[:, :, :cut], v[:, :, :cut], sl,
                            s4)
    rest = la._k10_chunked(q[:, :, cut:], k[:, :, cut:], v[:, :, cut:], sl,
                           s4)
    torch.cuda.synchronize()
    _k10_check(torch.cat([first, rest], 2), want, s4, s2)


# ---------------------------- k10_decode (lightning decode mixer) ---------

# k10_decode's output against its plain version: q, k and the state are
# the plain version's bits (the same roundings, PyTorch's reduction order),
# so an element differs only where K10's float32 o (another sum order)
# rounds to the other bf16 neighbour, and the norm's, weight's and gate's
# products of the two then round once more each: within 4 bf16 ulps of the
# row's largest |plain| value (the spacing 2^(floor(log2 max) - 7)).
K10_DECODE_ULPS = 4
K10_DECODE_FLAGS = {"all": ("z", "q_norm", "k_norm", "o_norm", "rope"),
                    "none": (), "gate": ("z",), "norm": ("o_norm",),
                    "qk_rope": ("q_norm", "k_norm", "rope")}


def _row_ulps(got, want):
    """max |got - want| in bf16 ulps of each row's largest |want|."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(
        w.abs().amax(-1, keepdim=True))) - 7)
    return ((g - w).abs() / ulp).max().item()


def _decode_inputs(dev, B, H=32, D=128, seed=0, use=K10_DECODE_FLAGS["all"]):
    """A lightning layer's decode-step inputs at MiniCPM-SALA's heads: q, k,
    v as views of one fused projection, the slopes, a carried state, and
    the keyword arguments ``use`` names (z, norm weights near one, RoPE)."""
    from ominix_mlx_tpu_torch.models.lightning import alibi_slopes

    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    N = H * D
    qkv = randn(B, 1, 3 * N).bfloat16()
    q, k, v = (t.reshape(B, 1, H, D).transpose(1, 2)
               for t in qkv.split([N, N, N], -1))
    kw = {"z": randn(B, 1, N).bfloat16(),
          "q_norm": (1 + 0.1 * randn(D)).bfloat16(),
          "k_norm": (1 + 0.1 * randn(D)).bfloat16(),
          "o_norm": (1 + 0.1 * randn(N)).bfloat16(), "rope_theta": 1e4}
    kw = {key: val for key, val in kw.items()
          if key in use or (key == "rope_theta" and "rope" in use)}
    return (q, k, v, torch.from_numpy(alibi_slopes(H)).to(dev),
            randn(B, H, D, D) * 0.1, kw)


@pytest.mark.parametrize("use", sorted(K10_DECODE_FLAGS))
@pytest.mark.parametrize("B,offset", [(1, 0), (1, 4095), (1, 524287),
                                      (8, "ragged")])
def test_k10_decode_matches_plain(cuda, B, offset, use):
    """k10_decode against lightning_decode_reference at MiniCPM-SALA's 32
    heads of 128, each flag combination: q and k as the state step reads
    them and the state bit for bit, the output within K10_DECODE_ULPS; one
    launch."""
    q, k, v, sl, state, kw = _decode_inputs(cuda, B, seed=B + 3,
                                            use=K10_DECODE_FLAGS[use])
    if offset == "ragged":
        offset = torch.tensor([0, 1, 4095, 4096, 70000, 131071, 524287, 9],
                              device=cuda)
    N = q.shape[1] * q.shape[3]
    qk1, qk2 = (torch.empty(B, 2, N, dtype=torch.bfloat16, device=cuda)
                for _ in range(2))
    s1, s2 = state.clone(), state.clone()
    torch.cuda.synchronize()
    _build.reset_launches()
    got = la._k10_decode(q, k, v, sl, s1, offset=offset, qk_out=qk1, **kw)
    assert dict(_build.LAUNCHES) == {"k10_decode": 1}
    want = la.lightning_decode_reference(q, k, v, sl, s2, offset=offset,
                                         qk_out=qk2, **kw)
    torch.cuda.synchronize()
    assert got.shape == (B, 1, N) and got.dtype == torch.bfloat16
    assert torch.isfinite(got.float()).all()
    assert torch.equal(qk1, qk2)
    assert torch.equal(s1, s2)
    assert _row_ulps(got, want) <= K10_DECODE_ULPS


def test_k10_decode_repeatable_and_graphed(cuda):
    """20 calls from the same state give the same bits, every ticket is
    zero after a call, and a CUDA graph's replay gives the eager call's
    bits; launched by dependent launch behind a kernel that does not
    write the state (the model's call) it gives them too."""
    q, k, v, sl, state, kw = _decode_inputs(cuda, 8, seed=5)
    offset = torch.arange(8, device=cuda) * 1000
    s0 = state.clone()
    base = la._k10_decode(q, k, v, sl, state, offset=offset, **kw)
    outs = []
    for _ in range(20):
        st = s0.clone()
        outs.append((la._k10_decode(q, k, v, sl, st, offset=offset, **kw),
                     st))
    torch.cuda.synchronize()
    assert all(torch.equal(o, base) and torch.equal(st, state)
               for o, st in outs)
    tickets = la._K10_BUFFERS[torch.cuda.current_device()][0]
    assert not tickets.any()
    st = s0.clone()
    torch.cuda.synchronize()
    qkv = torch.cat([q, k], 1).contiguous()
    qkv.mul_(1.0)                      # a kernel just before, not the state
    over = la._k10_decode(q, k, v, sl, st, offset=offset, overlap=True,
                          **kw)
    torch.cuda.synchronize()
    assert torch.equal(over, base) and torch.equal(st, state)
    gst = s0.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        la._k10_decode(q, k, v, sl, gst, offset=offset, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = la._k10_decode(q, k, v, sl, gst, offset=offset, **kw)
    for _ in range(3):
        gst.copy_(s0)
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, base) and torch.equal(gst, state)
    assert not tickets.any()


def test_k10_decode_rejects(cuda):
    q, k, v, sl, state, kw = _decode_inputs(cuda, 1, seed=6)
    with pytest.raises(ValueError, match="k10_decode q"):
        la._k10_decode(torch.cat([q, q], 2), torch.cat([k, k], 2),
                       torch.cat([v, v], 2), sl, state, **kw)
    with pytest.raises(ValueError, match="k10_decode q"):
        la._k10_decode(q.float(), k, v, sl, state, **kw)
    with pytest.raises(ValueError, match="k10_decode z"):
        la._k10_decode(q, k, v, sl, state, **{**kw, "z": kw["z"].float()})
    with pytest.raises(ValueError, match="o_norm"):
        la._k10_decode(q, k, v, sl, state,
                       **{**kw, "o_norm": kw["o_norm"][:128]})
    with pytest.raises(ValueError, match="offset"):
        la._k10_decode(q, k, v, sl, state,
                       offset=torch.zeros(1, dtype=torch.int32, device=cuda),
                       **kw)
    with pytest.raises(ValueError, match="state"):
        la._k10_decode(q, k, v, sl, state.bfloat16(), **kw)
    q2, k2, v2, sl2, state2, kw2 = _decode_inputs(cuda, 1, H=4, D=64,
                                                  use=())
    with pytest.raises(ValueError, match="D = 128"):
        la._k10_decode(q2, k2, v2, sl2, state2)


# ---------------------------- K11 (InfLLMv2 sparse decode attention) -------

K11_SCORE_TOL = 1e-6    # the scores' max error over max |plain|
K11_TOL = 3e-2          # per (row, head), as K3: bf16 softmax weights


def _k11_cache(dev, B, S, totals, Hkv=2, H=32, D=128, ks=32, seed=0):
    """A sparse cache of S positions per row, filled at random up to each
    row's total, its pooled keys from it, and a decode query."""
    from ominix_mlx_tpu_torch.models.sparse_attention import (
        SparseKVCache, compress_keys)

    g = torch.Generator(device=dev).manual_seed(seed)
    c = SparseKVCache.init(B, Hkv, S, D, torch.bfloat16, ks, dev)
    c.k.copy_(torch.randn(c.k.shape, generator=g, device=dev))
    c.v.copy_(torch.randn(c.v.shape, generator=g, device=dev))
    c.comp.copy_(compress_keys(c.k, ks))
    q = (torch.randn(B, H, 1, D, generator=g, device=dev)
         * 0.3).bfloat16()
    total = torch.tensor(totals, dtype=torch.int32, device=dev)
    return q, c, total


@pytest.mark.parametrize("B,S,totals", [(1, 8192, [4096]),
                                        (1, 65536, [65536]),
                                        (3, 20000, [20000, 3000, 1]),
                                        (2, 4096, [2111, 2048])])
def test_k11_score_matches_plain(cuda, B, S, totals):
    """k11_score against block_scores_reference: the finite scores within
    K11_SCORE_TOL of max |plain|, the masked ones NEG_INF in both."""
    from ominix_mlx_tpu_torch.models.sparse_attention import SparseConfig
    from ominix_mlx_tpu_torch.ops import sparse_attention as sa

    sc = SparseConfig()
    q, c, total = _k11_cache(cuda, B, S, totals, seed=S + B)
    args = (q, c.comp, total, sc.init_end, sc.window_size, sc.kernel_size)
    _build.reset_launches()
    got = sa._k11_score(*args)
    assert dict(_build.LAUNCHES) == {"k11_score": 1}
    want = sa.block_scores_reference(*args)
    torch.cuda.synchronize()
    masked = want <= sa.NEG_INF / 2
    assert torch.equal(got <= sa.NEG_INF / 2, masked)
    if (~masked).any():
        assert ((got - want)[~masked].abs().max()
                / want[~masked].abs().max()).item() < K11_SCORE_TOL


@pytest.mark.parametrize("B,S,totals", [
    (1, 8192, [4096]), (1, 65536, [65536]), (1, 4096, [1]),
    (4, 20000, [20000, 2112, 2113, 64]), (8, 16384,
                                          [16384, 16320, 16383, 16200,
                                           9000, 16350, 12000, 16384])])
def test_k11_attend_matches_plain(cuda, B, S, totals):
    """k11_attend given the same indices as sparse_attend_reference (the
    JAX gather plus masked sdpa), per (row, head) within K11_TOL of max
    |plain|, at totals around the window's and the tiles' edges, and the
    same bits on a second launch."""
    from ominix_mlx_tpu_torch.models.sparse_attention import SparseConfig
    from ominix_mlx_tpu_torch.ops import sparse_attention as sa

    sc = SparseConfig()
    q, c, total = _k11_cache(cuda, B, S, totals, seed=S + 7 * B)
    scores = sa.block_scores_reference(q, c.comp, total, sc.init_end,
                                       sc.window_size, sc.kernel_size)
    top, idx = torch.topk(scores, sc.topk, dim=-1)
    args = (q, c.k, c.v, idx, top, total, sc.init_end, sc.window_size,
            sc.kernel_size, 128 ** -0.5)
    _build.reset_launches()
    got = sa._k11_attend(*args)
    assert dict(_build.LAUNCHES) == {"k11_attend": 1}
    want = sa.sparse_attend_reference(*args)
    again = sa._k11_attend(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert _row_rel(got, want) < K11_TOL
    assert torch.equal(got, again)


def test_sparse_decode_attention_launches_k11(cuda):
    """The model's decode step on CUDA: one k11_select and one k11_attend
    (no k11_score, no torch.topk), the output within K11_TOL of the plain
    path's."""
    from ominix_mlx_tpu_torch.models.sparse_attention import (
        SparseConfig, sparse_decode_attention)
    from ominix_mlx_tpu_torch.ops import sparse_attention as sa

    q, c, _ = _k11_cache(cuda, 2, 12288, [12288, 12288], seed=3)
    _build.reset_launches()
    got = sparse_decode_attention(q, c, 12000, SparseConfig(), 128 ** -0.5)
    assert dict(_build.LAUNCHES) == {"k11_select": 1, "k11_attend": 1}
    total = torch.full((2,), 12001, dtype=torch.int32, device=cuda)
    sc = SparseConfig()
    scores = sa.block_scores_reference(q, c.comp, total, sc.init_end,
                                       sc.window_size, sc.kernel_size)
    top, idx = torch.topk(scores, sc.topk, dim=-1)
    want = sa.sparse_attend_reference(q, c.k, c.v, idx, top, total,
                                      sc.init_end, sc.window_size,
                                      sc.kernel_size, 128 ** -0.5)
    torch.cuda.synchronize()
    assert _row_rel(got, want) < K11_TOL


def test_k11_rejects(cuda):
    from ominix_mlx_tpu_torch.models.sparse_attention import SparseConfig
    from ominix_mlx_tpu_torch.ops import sparse_attention as sa

    sc = SparseConfig()
    q, c, total = _k11_cache(cuda, 1, 4096, [100])
    rest = (sc.init_end, sc.window_size, sc.kernel_size)
    with pytest.raises(ValueError, match="k11_score q"):
        sa._k11_score(q.float(), c.comp, total, *rest)
    with pytest.raises(ValueError, match="total"):
        sa._k11_score(q, c.comp, total.long(), *rest)
    with pytest.raises(ValueError, match="comp"):
        sa._k11_score(q, c.comp.float(), total, *rest)
    idx = torch.zeros(1, 2, 64, dtype=torch.int64, device=cuda)
    top = torch.zeros(1, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="top_idx"):
        sa._k11_attend(q, c.k, c.v, idx.int(), top, total, *rest, 0.1)
    with pytest.raises(ValueError, match="k11_attend k"):
        sa._k11_attend(q, c.k[:, :, ::2], c.v, idx, top, total, *rest, 0.1)
    q2, c2, t2 = _k11_cache(cuda, 1, 4096, [100], Hkv=1)
    with pytest.raises(ValueError, match="H / Hkv"):
        sa._k11_attend(q2, c2.k, c2.v, idx[:, :1], top[:, :1], t2, *rest,
                       0.1)


def _k11_attend_args(dev, B, S, totals, seed):
    """k11_attend's arguments at MiniCPM-SALA's heads and the production
    InfLLMv2 config, the blocks selected from the plain scores."""
    from ominix_mlx_tpu_torch.models.sparse_attention import SparseConfig
    from ominix_mlx_tpu_torch.ops import sparse_attention as sa

    sc = SparseConfig()
    q, c, total = _k11_cache(dev, B, S, totals, seed=seed)
    scores = sa.block_scores_reference(q, c.comp, total, sc.init_end,
                                       sc.window_size, sc.kernel_size)
    top, idx = torch.topk(scores, sc.topk, dim=-1)
    return (q, c.k, c.v, idx, top, total, sc.init_end, sc.window_size,
            sc.kernel_size, 128 ** -0.5)


@pytest.mark.parametrize("B,S,totals", [
    (1, 65536, [65536]),
    (8, 16384, [16384, 16320, 2100, 16200, 9000, 16350, 12000, 1])])
def test_k11_attend_one_launch_repeatable_and_graphed(cuda, B, S, totals):
    """k11_attend is one launch a call, the same bits over 20 calls, within
    K11_TOL per (row, head) of the plain version (rows 2 and 7 of the
    ragged batch hold no finite block), leaves every ticket zero, and
    replayed three times from a CUDA graph gives the eager call's bits."""
    from ominix_mlx_tpu_torch.ops import sparse_attention as sa

    args = _k11_attend_args(cuda, B, S, totals, seed=B + S)
    if B == 8:
        assert not (args[4][2] > sa.NEG_INF / 2).any()
    _build.reset_launches()
    base = sa._k11_attend(*args)
    assert dict(_build.LAUNCHES) == {"k11_attend": 1}
    outs = [sa._k11_attend(*args) for _ in range(20)]
    assert dict(_build.LAUNCHES) == {"k11_attend": 21}
    want = sa.sparse_attend_reference(*args)
    torch.cuda.synchronize()
    assert _row_rel(base, want) < K11_TOL
    assert all(torch.equal(o, base) for o in outs)
    splits = sa.k11_plan(B, 2, 64 + 64 * 32 + 2048)[0]
    assert splits > 1
    tickets = sa._K11_BUFFERS[cuda.index if cuda.index is not None
                              else torch.cuda.current_device()][0]
    assert not tickets.any()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sa._k11_attend(*args)           # warm up on the capture's stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = sa._k11_attend(*args)
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, base)
    assert not tickets.any()


# ------------------------------------------- k11_select (scores + top-k) ---

@pytest.mark.parametrize("k", [64, 128, 256])
@pytest.mark.parametrize("B,S,totals", [
    (1, 4096, [4096]), (1, 65536, [65536]), (1, 524288, [524288]),
    (8, 16384, [16384, 16320, 16383, 16200, 15000, 16350, 12000, 16384]),
    (3, 20000, [20000, 3000, 1]), (2, 1024, [1024, 700])])
def test_k11_select_matches_plain(cuda, B, S, totals, k):
    """k11_select's scores are k11_score's bit for bit and its top k is a
    stable descending sort of them (equal scores by block index, NEG_INF
    last in index order); the finite scores within K11_SCORE_TOL of
    block_select_reference's and the same blocks selected; one launch."""
    from ominix_mlx_tpu_torch.models.sparse_attention import SparseConfig
    from ominix_mlx_tpu_torch.ops import sparse_attention as sa

    sc = SparseConfig()
    q, c, total = _k11_cache(cuda, B, S, totals, seed=S + B + k)
    k = min(k, c.comp.shape[2])
    args = (q, c.comp, total, sc.init_end, sc.window_size, sc.kernel_size)
    _build.reset_launches()
    vals, idx = sa._k11_select(*args, k)
    assert dict(_build.LAUNCHES) == {"k11_select": 1}
    sv, si = torch.sort(sa._k11_score(*args), dim=-1, descending=True,
                        stable=True)
    pv, pi = sa.block_select_reference(*args, k)
    torch.cuda.synchronize()
    assert vals.dtype == torch.float32 and idx.dtype == torch.int64
    assert torch.equal(vals, sv[..., :k]) and torch.equal(idx, si[..., :k])
    fin = pv > sa.NEG_INF / 2
    assert torch.equal(vals > sa.NEG_INF / 2, fin)
    if fin.any():
        assert ((vals - pv)[fin].abs().max() / pv[fin].abs().max()).item() \
            < K11_SCORE_TOL
    sel = [[sorted(i[v > sa.NEG_INF / 2].tolist()) for v, i in zip(vr, ir)]
           for vr, ir in zip(vals.cpu(), idx.cpu())]
    want = [[sorted(i[v > sa.NEG_INF / 2].tolist()) for v, i in zip(vr, ir)]
            for vr, ir in zip(pv.cpu(), pi.cpu())]
    assert sel == want


def test_k11_select_ties_by_index(cuda):
    """Pooled keys repeated across blocks score the same: the lower block
    comes first, as jax.lax.top_k orders them."""
    from ominix_mlx_tpu_torch.models.sparse_attention import SparseConfig
    from ominix_mlx_tpu_torch.ops import sparse_attention as sa

    sc = SparseConfig()
    q, c, total = _k11_cache(cuda, 1, 65536, [65536], seed=9)
    c.comp[:, :, 100:] = c.comp[:, :, 2:100].repeat(1, 1, 21, 1)[
        :, :, :c.comp.shape[2] - 100]
    args = (q, c.comp, total, sc.init_end, sc.window_size, sc.kernel_size)
    vals, idx = sa._k11_select(*args, 256)
    sv, si = torch.sort(sa._k11_score(*args), dim=-1, descending=True,
                        stable=True)
    torch.cuda.synchronize()
    assert torch.equal(idx, si[..., :256]) and torch.equal(vals, sv[..., :256])
    same = vals[..., 1:] == vals[..., :-1]
    assert same.any()
    assert (idx[..., 1:][same] > idx[..., :-1][same]).all()


@pytest.mark.parametrize("B,S,totals", [
    (1, 524288, [524288]), (8, 16384, [16384, 16320, 2100, 16200, 9000,
                                       16350, 12000, 1])])
def test_k11_select_repeatable_and_graphed(cuda, B, S, totals):
    """The same bits over 20 calls, every ticket zero after a call, a CUDA
    graph's replay bit-equal to the eager call; k11_attend given its
    selection gives the bits it gives given k11_score's and torch.topk's
    (the same ids in the same order)."""
    from ominix_mlx_tpu_torch.models.sparse_attention import SparseConfig
    from ominix_mlx_tpu_torch.ops import sparse_attention as sa

    sc = SparseConfig()
    q, c, total = _k11_cache(cuda, B, S, totals, seed=B + S)
    args = (q, c.comp, total, sc.init_end, sc.window_size, sc.kernel_size,
            sc.topk)
    base = sa._k11_select(*args)
    outs = [sa._k11_select(*args) for _ in range(20)]
    torch.cuda.synchronize()
    assert all(torch.equal(v, base[0]) and torch.equal(i, base[1])
               for v, i in outs)
    if sa.k11_select_plan(c.comp.shape[2])[0] > 1:
        tickets = sa._K11_SELECT_BUFFERS[torch.cuda.current_device()][0]
        assert not tickets.any()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sa._k11_select(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = sa._k11_select(*args)
    for _ in range(3):
        captured[0].zero_()
        captured[1].zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured[0], base[0])
        assert torch.equal(captured[1], base[1])
    top, idx = torch.topk(sa._k11_score(*args[:-1]), sc.topk, dim=-1)
    rest = (total, sc.init_end, sc.window_size, sc.kernel_size, 128 ** -0.5)
    mine = sa._k11_attend(q, c.k, c.v, base[1], base[0], *rest)
    parent = sa._k11_attend(q, c.k, c.v, idx, top, *rest)
    torch.cuda.synchronize()
    fin = top > sa.NEG_INF / 2
    assert torch.equal(idx[fin], base[1][fin])
    assert torch.equal(mine, parent)


def test_k11_select_rejects(cuda):
    from ominix_mlx_tpu_torch.models.sparse_attention import SparseConfig
    from ominix_mlx_tpu_torch.ops import sparse_attention as sa

    sc = SparseConfig()
    q, c, total = _k11_cache(cuda, 1, 16384, [100])
    rest = (sc.init_end, sc.window_size, sc.kernel_size)
    with pytest.raises(ValueError, match="k <= min"):
        sa._k11_select(q, c.comp, total, *rest, 257)
    with pytest.raises(ValueError, match="k <= min"):
        sa._k11_select(q, c.comp[:, :, :10].contiguous(), total, *rest, 11)
    with pytest.raises(ValueError, match="k11_select q"):
        sa._k11_select(q.float(), c.comp, total, *rest, 64)
    with pytest.raises(ValueError, match="comp"):
        sa._k11_select(q, c.comp.float(), total, *rest, 64)
    with pytest.raises(ValueError, match="total"):
        sa._k11_select(q, c.comp, total.long(), *rest, 64)


# ------------------------------------------- the engine's captured step ----

# small configs of the nine families at widths the kernels take (hidden
# 256 so every packed weight is on panels: K1; head dims 64 for K2 and
# 128 for k9_decode, K10 and K11)
_SMALL_HF = dict(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                 intermediate_size=512, rms_norm_eps=1e-6,
                 tie_word_embeddings=False)
_MOE_HF = dict(_SMALL_HF, moe_intermediate_size=128, num_experts=8,
               num_experts_per_tok=2, norm_topk_prob=True,
               decoder_sparse_step=1, mlp_only_layers=[])
GRAPH_FAMILIES = ("qwen3", "qwen3_paged", "qwen3_moe_w4",
                  "qwen3_moe_channel8", "mistral_window", "glm4", "mixtral",
                  "glm4_moe", "deepseek_v3", "qwen3_next", "minicpm_sala")


def _attention_biases(params, cfg, g, dev):
    for lp in params["layers"]:
        for n, heads in (("q_proj", cfg.num_heads),
                         ("k_proj", cfg.num_kv_heads),
                         ("v_proj", cfg.num_kv_heads)):
            if n in lp:
                lp[n]["b"] = (torch.randn(heads * cfg.hd, generator=g,
                                          device=dev) * 0.1).bfloat16()
    return params


def _graph_family(dev, name):
    """(model module, config, w4a8 / w8a8 g64 params made packed and fused,
    cache maker (batch, max_len), prompt length) of ``name``."""
    from ominix_mlx_tpu_torch.models import (base, deepseek_v3, glm4,
                                             glm4_moe, minicpm_sala, mistral,
                                             mixtral, qwen3, qwen3_moe,
                                             qwen3_next)

    g = torch.Generator(device=dev).manual_seed(0)
    mod, T, dense_layers, scheme, bits = base, 20, 0, "group", 4
    if name in ("qwen3", "qwen3_paged"):
        cfg = qwen3.config_from_hf(dict(_SMALL_HF, model_type="qwen3",
                                        tie_word_embeddings=True))
    elif name.startswith("qwen3_moe"):
        cfg = qwen3_moe.config_from_hf(dict(_MOE_HF, model_type="qwen3_moe"))
        scheme = "channel8" if name.endswith("channel8") else "group"
    elif name == "mistral_window":
        cfg = mistral.config_from_hf(dict(_SMALL_HF, model_type="mistral",
                                          sliding_window=8))
    elif name == "glm4":
        cfg = glm4.config_from_hf(dict(_SMALL_HF, model_type="glm4",
                                       partial_rotary_factor=0.5,
                                       attention_bias=True))
    elif name == "mixtral":
        cfg = mixtral.config_from_hf(dict(
            _SMALL_HF, model_type="mixtral", intermediate_size=128,
            num_local_experts=4, num_experts_per_tok=2))
    elif name == "glm4_moe":
        cfg = glm4_moe.config_from_hf(dict(
            _MOE_HF, model_type="glm4_moe", n_routed_experts=8,
            n_shared_experts=1, first_k_dense_replace=1,
            routed_scaling_factor=1.0, n_group=1, topk_group=1,
            partial_rotary_factor=0.5, attention_bias=True))
        dense_layers = 1
    elif name == "deepseek_v3":
        cfg = deepseek_v3.config_from_hf(dict(
            _MOE_HF, model_type="deepseek_v2", num_key_value_heads=4,
            q_lora_rank=None, kv_lora_rank=128, qk_nope_head_dim=64,
            qk_rope_head_dim=32, v_head_dim=64, n_routed_experts=8,
            n_shared_experts=1, first_k_dense_replace=1,
            routed_scaling_factor=1.0, n_group=1, topk_group=1))
        dense_layers = 1
    elif name == "qwen3_next":
        cfg = qwen3_next.config_from_hf(dict(
            _MOE_HF, model_type="qwen3_next", num_hidden_layers=4,
            full_attention_interval=4, shared_expert_intermediate_size=128,
            linear_key_head_dim=128, linear_value_head_dim=128,
            linear_num_key_heads=2, linear_num_value_heads=4,
            linear_conv_kernel_dim=4, partial_rotary_factor=0.25))
    else:
        mod, T, bits = minicpm_sala, 500, 8
        cfg = minicpm_sala.MiniCPMConfig.from_hf(dict(
            model_type="minicpm_sala", vocab_size=512, hidden_size=512,
            num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2, head_dim=128, intermediate_size=512,
            qk_norm=True, lightning_nh=4, lightning_head_dim=128,
            mixer_types=["minicpm4", "lightning-attn", "lightning-attn",
                         "minicpm4"],
            sparse_config=dict(kernel_size=32, block_size=64, init_blocks=1,
                               window_size=128, topk=4)))
        params = base.fuse_layer_projections(
            minicpm_sala.init_quantized_params(cfg, g, 64, 8, 8, device=dev))
        return mod, cfg, params, (
            lambda B, L: minicpm_sala.init_cache(cfg, B, L, device=dev)), T
    params = base.init_quantized_params(cfg, g, 64, bits, act_bits=8,
                                        device=dev, scheme=scheme,
                                        dense_layers=dense_layers)
    if cfg.attention_bias:
        params = _attention_biases(params, cfg, g, dev)
    params = base.fuse_layer_projections(params)
    if name == "qwen3_paged":
        return mod, cfg, params, (lambda B, L: base.init_paged_cache(
            cfg, B, L, 16, device=dev)), T
    return mod, cfg, params, (
        lambda B, L: base.init_cache(cfg, B, L, device=dev)), T


def _graph_engine(mod, cfg, params, sampler=None):
    from ominix_mlx_tpu_torch.core.generate import Engine
    from ominix_mlx_tpu_torch.core.sampling import SamplerConfig

    return Engine(lambda p, t, c: mod.forward(p, cfg, t, c), params,
                  sampler or SamplerConfig(),
                  prefill_forward_fn=lambda p, t, c: mod.forward(
                      p, cfg, t, c, fresh_prefill=True))


def _cloned(cache):
    from ominix_mlx_tpu_torch.core.cache import ModelCache

    return ModelCache(layers=[dataclasses.replace(lc, **{
        f.name: getattr(lc, f.name).clone()
        for f in dataclasses.fields(lc)
        if isinstance(getattr(lc, f.name), torch.Tensor)})
        for lc in cache.layers], offset=cache.offset)


def _prefilled(dev, name, B=1, max_len=1024, sampler=None):
    from ominix_mlx_tpu_torch.core.sampling import sample

    mod, cfg, params, make_cache, T = _graph_family(dev, name)
    eng = _graph_engine(mod, cfg, params, sampler)
    g = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(1, 512, (B, T), generator=g, device=dev)
    with torch.inference_mode():
        last, cache = eng.prefill(prompt, make_cache(B, max_len))
        tok = sample(last, None, eng.sampler) if sampler is None else \
            last.argmax(-1)
    return eng, cache, tok


def _launch_counts():
    return {k: v for k, v in _build.LAUNCHES.items() if v}


@pytest.mark.parametrize("name", GRAPH_FAMILIES)
def test_decode_graph_replays_the_eager_body(cuda, name):
    """From one prefilled cache (cloned), 5 steps of the step's body run
    eagerly under set_sync_debug_mode("error") (no host sync in the body)
    against the captured step (the warm-up, then 4 replays): the logits
    and tokens of every step and the final caches bit for bit, the
    kernels' tickets reset between replays included, and the launch
    counts equal."""
    eng, cache, tok = _prefilled(cuda, name)
    a, b = _cloned(cache), _cloned(cache)
    torch.cuda.synchronize()
    with torch.inference_mode():
        _build.reset_launches()
        eager = eng.decode_step(a, tok.clone())
        torch.cuda.set_sync_debug_mode("error")
        try:
            want = [(eager.body().clone(), eager.tok.clone())
                    for _ in range(5)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        eager_launches = _launch_counts()
        _build.reset_launches()
        step = eng.decode_step(b, tok.clone())
        got = []
        for _ in range(5):
            step()
            got.append((step.logits.clone(), step.tok.clone()))
        step.close()
        graph_launches = _launch_counts()
    assert 0 in step.captured.records and step.captured.capture_ms[0] > 0
    assert graph_launches == eager_launches and eager_launches
    for i, ((wl, wt), (gl, gt)) in enumerate(zip(want, got)):
        assert torch.equal(gl, wl), f"logits of step {i}"
        assert torch.equal(gt, wt), f"token of step {i}"
    for la_, lb in zip(a.layers, b.layers):
        for f in dataclasses.fields(la_):
            x = getattr(la_, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, getattr(lb, f.name)), f.name
    assert torch.equal(eager.offset, step.offset)


def test_decode_graph_loops_give_the_eager_tokens(cuda, monkeypatch):
    """On the card generate, generate_scan and generate_batch (ragged
    rows, a stop token) replay their captured steps and give the tokens
    and launch counts of the same loops with every step's body run
    eagerly instead."""
    from ominix_mlx_tpu_torch.core.generate import DecodeStep
    from ominix_mlx_tpu_torch.models import base

    mod, cfg, params, _, _ = _graph_family(cuda, "qwen3")
    eng = _graph_engine(mod, cfg, params)
    g = torch.Generator(device=cuda).manual_seed(3)
    prompt = torch.randint(1, 512, (2, 12), generator=g, device=cuda)
    prompt[1, 9:] = 0
    n = 10

    def loops(stop):
        _build.reset_launches()
        scan, c = eng.generate_scan(prompt[:1], base.init_cache(
            cfg, 1, 64, device=cuda), n)
        streamed = list(eng.generate(prompt[0], base.init_cache(
            cfg, 1, 64, device=cuda), max_tokens=n))
        batch = eng.generate_batch(prompt, base.init_cache(
            cfg, 2, 64, device=cuda), max_tokens=n, stop_tokens=stop,
            pad_id=-1, prompt_lengths=[12, 9])
        torch.cuda.synchronize()
        return (scan.tolist(), c.offset, streamed, batch[0].tolist(),
                batch[1].tolist(), _launch_counts())

    with torch.inference_mode():
        replayed = loops(())
        with monkeypatch.context() as m:
            def eager_call(self):
                self.logits = self.body()
                self.steps += 1
            m.setattr(DecodeStep, "__call__", eager_call)
            eager = loops(())
            stop = (eager[3][1][4],)
            eager_stop = loops(stop)
        replayed_stop = loops(stop)
    assert replayed == eager
    assert replayed[0][0] == replayed[2] and replayed[1] == 12 + n
    assert replayed_stop == eager_stop
    assert -1 in replayed_stop[3][1] and replayed_stop[4][1] < n


def test_decode_graph_samples_through_a_registered_generator(cuda):
    """Stochastic sampling (temperature, top-k, top-p) in the captured
    step draws from the caller's generator, registered with the graph:
    the tokens of the warm-up and 7 replays equal those of 8 eager steps
    from a generator at the same seed, and each replay draws anew."""
    from ominix_mlx_tpu_torch.core.sampling import SamplerConfig

    sampler = SamplerConfig(temperature=1.0, top_k=50, top_p=0.95)
    eng, cache, tok = _prefilled(cuda, "qwen3", sampler=sampler)
    a, b = _cloned(cache), _cloned(cache)
    with torch.inference_mode():
        ga = torch.Generator(device=cuda).manual_seed(11)
        eager = eng.decode_step(a, tok.clone(), ga)
        want = []
        for _ in range(8):
            eager.body()
            want.append(int(eager.tok[0]))
        gb = torch.Generator(device=cuda).manual_seed(11)
        step = eng.decode_step(b, tok.clone(), gb)
        got = []
        for _ in range(8):
            step()
            got.append(int(step.tok[0]))
        step.close()
    assert got == want
    assert len(set(got)) > 1


def test_decode_graph_capture_raises_on_a_host_sync(cuda):
    """A host read planted in the step's body makes the capture raise; no
    eager fallback runs, and the card goes on working."""
    eng, cache, tok = _prefilled(cuda, "qwen3")
    real = eng.forward_fn

    def syncing(p, t, c):
        lg, c = real(p, t, c)
        float(lg.sum())            # a host read: the capture refuses it
        return lg, c

    eng.forward_fn = syncing
    with torch.inference_mode():
        step = eng.decode_step(cache, tok.clone())
        with pytest.raises(RuntimeError) as e:
            step()
        assert not step.captured.graphs
    # the step, its pool and the traceback go; the process goes on
    del step, e
    gc.collect()
    x = torch.ones(4, device=cuda)
    assert float((x * 2).sum()) == 8.0


# ------------------------------------- the batcher's step and speculation --

def _eager_bodies(monkeypatch):
    """Make every ``CapturedBodies.run`` call its body eagerly, under
    set_sync_debug_mode("error") (a host sync in a body raises)."""
    from ominix_mlx_tpu_torch.core.generate import CapturedBodies

    def eager(self, key, body):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return body()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(CapturedBodies, "run", eager)


def _batcher(dev, name, slots=4, spec=False):
    """A dense (qwen3) or paged int8 (qwen3_paged) batcher of
    ``_graph_family``'s model at 4 slots; ``spec``: a self-draft of the
    first layer, 3 tokens a round."""
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.serving import batching

    mod, cfg, params, _, _ = _graph_family(dev, name)
    fwd = lambda p, t, c: mod.forward(p, cfg, t, c)
    kw = dict(prefill_forward_fn=lambda p, t, c: mod.forward(
        p, cfg, t, c, fresh_prefill=True))
    if spec:
        dcfg = dataclasses.replace(cfg, num_layers=1)
        kw.update(draft_forward_fn=lambda p, t, c: mod.forward(
            p, dcfg, t, c), draft_params=dict(params,
                                             layers=params["layers"][:1]),
                  draft_init_cache_fn=lambda b, ml: base.init_cache(
                      dcfg, b, ml, device=dev), num_draft_tokens=3)
    if name == "qwen3_paged":
        return batching.PagedContinuousBatcher(
            fwd, params, cfg, slots=slots, max_len=256, page_size=16,
            quantize_kv=True, device=dev, **kw)
    return batching.ContinuousBatcher(
        fwd, params, cfg,
        lambda c, b, ml: base.init_cache(c, b, ml, device=dev),
        slots=slots, max_len=256, **kw)


def _drive(cb, mixed, steps=12):
    """Five requests on four slots (one waits for a slot), two sampled
    when ``mixed``; each step's logits, the tokens out and the launch
    counts."""
    from ominix_mlx_tpu_torch.core.sampling import SamplerConfig

    g = torch.Generator().manual_seed(4)
    for i in range(5):
        sampler = (SamplerConfig(temperature=0.9, top_k=40, top_p=0.9)
                   if mixed and i in (1, 3) else None)
        cb.submit(i, torch.randint(1, 500, (7 + 5 * i,),
                                   generator=g).tolist(), 8 + i,
                  sampler=sampler, seed=100 + i)
    _build.reset_launches()
    logits, done = [], {}
    with torch.inference_mode():
        for _ in range(steps):
            for rid, out in cb.step():
                done[rid] = out
            logits.append(cb.logits.clone())
        torch.cuda.synchronize()
    return logits, done, _launch_counts()


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("name", ["qwen3", "qwen3_paged"])
def test_batch_step_graph_replays_the_eager_body(cuda, monkeypatch, name,
                                                 mixed):
    """The continuous batcher's step on a dense cache and on a paged int8
    pool, greedy and mixed (two sampled requests): 12 steps replayed from
    its captured bodies give every step's logits, every request's tokens
    and the launch counts of the same steps with each body run eagerly
    (under set_sync_debug_mode("error")), bit for bit; the mixed run
    captures both bodies into one pool; close() frees them."""
    got = _drive(_batcher(cuda, name), mixed)
    cb = _batcher(cuda, name)
    assert cb.bodies.graphs == {}
    with monkeypatch.context() as m:
        _eager_bodies(m)
        want = _drive(cb, mixed)
    assert got[1] == want[1] and len(got[1]) >= 3
    assert got[2] == want[2] and got[2]
    for i, (a, b) in enumerate(zip(got[0], want[0])):
        assert torch.equal(a, b), f"logits of step {i}"


def test_batch_step_capture_keys_and_close(cuda):
    """A mixed run (its sampled requests end before the last greedy one)
    captures the sampled and the greedy body into one pool (both keys,
    the pool's bytes kept); close() drops them, and a later step captures
    anew."""
    cb = _batcher(cuda, "qwen3")
    _drive(cb, True, steps=30)
    assert set(cb.bodies.graphs) == {"greedy", "sampled"}
    assert cb.bodies.pool_bytes > 0 and cb.sampled_steps >= 1
    cb.close()
    assert cb.bodies.graphs == {}
    cb.submit("late", [5, 6, 7], 4)
    with torch.inference_mode():
        while cb.pending():
            cb.step()
    assert cb.bodies.graphs


@pytest.mark.parametrize("name", ["qwen3", "qwen3_moe_w4", "qwen3_paged"])
def test_spec_batcher_round_replays_the_eager_body(cuda, monkeypatch, name):
    """One speculative round for every slot (a first-layer self-draft,
    3 drafts, dense cache; qwen3_paged: the target's KV in a paged int8
    pool of 16-token pages), replayed: the target logits of every round,
    every request's tokens and the launch counts equal the rounds run
    eagerly, bit for bit. On the MoE model the verify's 4 slots x 4 rows
    pass 8 rows, so its experts take K5 inside the captured round. On the
    paged pool requests take new pages between replays (each round
    reserves nd + 1 positions past the offset)."""
    def paged_growth(cb):
        """Wrap the batcher's _pre_step: the slots that took a page."""
        grew, pre = [], cb._pre_step

        def counting():
            before = {b: len(cb.alloc.owned.get(b, []))
                      for b, r in enumerate(cb.active) if r is not None}
            pre()
            grew.extend(b for b, n in before.items()
                        if cb.active[b] is not None
                        and len(cb.alloc.owned.get(b, [])) > n)

        cb._pre_step = counting
        return grew

    cb = _batcher(cuda, name, spec=True)
    grew = paged_growth(cb) if name == "qwen3_paged" else None
    got = _drive(cb, False)
    with monkeypatch.context() as m:
        _eager_bodies(m)
        want = _drive(_batcher(cuda, name, spec=True), False)
    if name == "qwen3_moe_w4":
        assert got[2].get("k5_w4", 0) > 0 and got[2].get("k4", 0) > 0
    if name == "qwen3_paged":
        assert grew
    assert got[1] == want[1] and len(got[1]) >= 3
    assert got[2] == want[2] and got[2]
    for i, (a, b) in enumerate(zip(got[0], want[0])):
        assert torch.equal(a, b), f"logits of round {i}"


@pytest.mark.parametrize("name", GRAPH_FAMILIES)
def test_spec_engine_round_replays_the_eager_body(cuda, monkeypatch, name):
    """SpeculativeEngine.generate_scan with a self-draft (the first layer;
    MiniCPM-SALA its forward(num_layers=2)), 3 drafts a round, on each
    family, and with the target itself as the draft: the replayed rounds
    give the tokens, the rounds, the acceptance and the launch counts of
    the same rounds run eagerly (under set_sync_debug_mode("error"))."""
    from ominix_mlx_tpu_torch.core.speculative import (SpecStats,
                                                       SpeculativeEngine)
    from ominix_mlx_tpu_torch.serving.server import ChatModel, draft_for

    mod, cfg, params, make_cache, T = _graph_family(cuda, name)
    model = ChatModel(name, params, cfg, None, cuda, mod)
    dfwd, dparams, dinit = draft_for(model, draft_layers=(
        2 if name == "minicpm_sala" else 1))
    fwd = lambda p, t, c: mod.forward(p, cfg, t, c)
    g = torch.Generator(device=cuda).manual_seed(2)
    prompt = torch.randint(1, 500, (T,), generator=g, device=cuda)
    cap = 1024 if name == "minicpm_sala" else 256

    def run(draft):
        eng = SpeculativeEngine(fwd, params, draft[0], draft[1],
                                num_draft_tokens=3)
        st = SpecStats()
        _build.reset_launches()
        toks, rounds = eng.generate_scan(
            prompt, make_cache(1, cap), draft[2](1, cap) if len(draft) > 2
            else make_cache(1, cap), max_tokens=16, stats=st)
        torch.cuda.synchronize()
        return toks, rounds, st, _launch_counts()

    self_draft = (dfwd, dparams)
    whole = (fwd, params)

    def both(draft):
        got = run(draft)
        with monkeypatch.context() as m:
            _eager_bodies(m)
            want = run(draft)
        return got, want

    for draft in (self_draft + (dinit,), whole):
        got, want = both(draft)
        assert got[0] == want[0] and len(got[0]) == 16
        assert got[1:3] == want[1:3] and got[3] == want[3] and got[3]


def test_spec_engine_capture_raises_on_a_host_sync(cuda):
    """A host read planted in the draft's forward makes the round's
    capture raise: no eager fallback runs."""
    from ominix_mlx_tpu_torch.core.speculative import SpeculativeEngine

    mod, cfg, params, make_cache, T = _graph_family(cuda, "qwen3")
    fwd = lambda p, t, c: mod.forward(p, cfg, t, c)

    def syncing(p, t, c):
        lg, c = fwd(p, t, c)
        float(lg.sum())
        return lg, c

    eng = SpeculativeEngine(fwd, params, syncing, params, 2)
    prompt = torch.arange(1, T + 1, device=cuda)
    with torch.inference_mode(), pytest.raises(RuntimeError) as e:
        eng.generate_scan(prompt, make_cache(1, 128), make_cache(1, 128),
                          max_tokens=8)
    # the failed capture's pool goes with its traceback, and the process
    # goes on (a pool freed with a graph's hold left would abort it)
    del e
    gc.collect()
    assert float(torch.ones(2, device=cuda).sum()) == 2.0
    eng.df = fwd
    with torch.inference_mode():
        toks, _ = eng.generate_scan(prompt, make_cache(1, 128),
                                    make_cache(1, 128), max_tokens=8)
    assert len(toks) == 8


# ------------------------------------------------ VLM and OCR pipelines -----

def _plain_k1(x, w, nw=None, eps=EPS):
    return (qm.qmm_p_reference(x, w, nw, eps) if x.shape[0] == 1
            else qm.qmm_dq_reference(x, w))


def _tiny_moxin(dev):
    """Tiny bf16 towers (28 px) before a 256-wide w8a8 decoder on panels
    (K1's 8-bit P formula at one row, K2 at head dim 64)."""
    from ominix_mlx_tpu_torch.models import base, moxin_vlm, vit

    g = torch.Generator(device=dev).manual_seed(21)
    dcfg, scfg, _ = moxin_vlm.tiny_configs()
    lm_cfg = base.TransformerConfig(
        vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
        num_kv_heads=2, head_dim=64, intermediate_size=512)
    return moxin_vlm.MoxinVLM(
        dino_params=vit.init_params(dcfg, g, torch.bfloat16, dev),
        dino_cfg=dcfg,
        siglip_params=vit.init_params(scfg, g, torch.bfloat16, dev),
        siglip_cfg=scfg,
        projector=moxin_vlm.init_projector(g, (56, 64, 64, 256),
                                           torch.bfloat16, dev),
        lm_params=base.fuse_layer_projections(base.init_quantized_params(
            lm_cfg, g, 64, 8, act_bits=8, device=dev)),
        lm_cfg=lm_cfg, device=dev)


def _tiny_ocr2(dev):
    """SAM at 256 px (16 image tokens, so the 18-row prefill takes the
    sorted dispatch: K5), a 2-layer 128-wide flow (head dim 64, which K2
    would take), and a 2-layer 256-wide w4a8 decoder (a dense layer, then
    8 packed experts of 128, top 2, and a shared one)."""
    from ominix_mlx_tpu_torch.models import base, deepseek_ocr2, sam_vit

    g = torch.Generator(device=dev).manual_seed(22)
    scfg = sam_vit.SamViTConfig(img_size=256, patch_size=16, embed_dim=64,
                                depth=2, num_heads=2, window_size=6,
                                global_attn_indexes=(1,), out_chans=16,
                                adapter_chans=128)
    fcfg = deepseek_ocr2.visual_flow_config(hidden=128, layers=2)
    flow = base.init_params(fcfg, g, torch.bfloat16, dev)
    flow = {"layers": flow["layers"], "norm": flow["norm"],
            **{f"query_{px}": (torch.randn(n, 128, generator=g, device=dev)
                               * 0.02).bfloat16()
               for px, n in ((768, 16), (1024, 25))}}
    cfg = deepseek_ocr2.config_from_hf({
        "hidden_size": 256, "num_hidden_layers": 2,
        "num_attention_heads": 4, "num_key_value_heads": 4,
        "intermediate_size": 512, "n_routed_experts": 8,
        "moe_intermediate_size": 128, "num_experts_per_tok": 2,
        "n_shared_experts": 1})
    return deepseek_ocr2.DeepSeekOCR2(
        vision_params=sam_vit.init_params(scfg, g, torch.bfloat16, dev),
        vision_cfg=scfg,
        projector={"w": ((torch.rand(256, 128, generator=g, device=dev)
                          - 0.5) * 0.2).bfloat16(),
                   "b": torch.zeros(256, dtype=torch.bfloat16, device=dev)},
        lm_params=base.fuse_layer_projections(base.init_quantized_params(
            cfg, g, 64, 4, act_bits=8, device=dev, dense_layers=1)),
        lm_cfg=cfg, flow_params=flow, flow_cfg=fcfg,
        view_separator=(torch.randn(256, generator=g, device=dev)
                        * 0.02).bfloat16(), device=dev)


def _png_b64(h, w, seed):
    import base64
    import io

    import numpy as np
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, (h, w, 3), np.uint8)).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_moxin_request_launches_k2_then_qmm_p(cuda, monkeypatch):
    """On CUDA, a Moxin request's prefill over the spliced prompt launches
    K2 (a launch a layer) and its replayed decode K1's 8-bit P formula
    (4 projections a layer and the lm_head a step), none falling back;
    the prefill's logits within 5e-2 of the plain versions' (w8a8 on
    panels); a /v1/describe through the server (on its inference thread)
    launches both again."""
    from ominix_mlx_tpu_torch.serving.server import Server

    m = _tiny_moxin(cuda)
    image = torch.rand(1, 28, 28, 3, generator=torch.Generator(
        device=cuda).manual_seed(3), device=cuda)
    ids = [1, 5, 9, 12, 40]
    _build.reset_launches()
    with torch.inference_mode():
        logits, cache = m.prefill(image, ids, 8)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["k2"] == 2
    before = dict(_build.LAUNCHES)
    toks = list(m.engine().decode(logits, cache, 8))
    torch.cuda.synchronize()
    assert len(toks) == 8
    assert _build.LAUNCHES["k2"] == before["k2"]
    assert _build.LAUNCHES["k1_m1_w8"] - before.get("k1_m1_w8", 0) \
        >= 9 * 7
    with monkeypatch.context() as mp:
        mp.setattr(qm, "_k1", _plain_k1)
        mp.setattr(fa, "_k2", fa.flash_prefill_reference)
        with torch.inference_mode():
            want, _ = m.prefill(image, ids, 8)
    assert _rel(logits, want) < 5e-2
    srv = Server()
    srv.add_model("vlm", m)
    try:
        _build.reset_launches()
        out = srv.describe({"image": _png_b64(40, 30, 4), "max_tokens": 4})
        assert out["tokens"] == 4
        assert _build.LAUNCHES["k2"] == 2
        assert _build.LAUNCHES["k1_m1_w8"] >= 9 * 3
    finally:
        srv.worker.stop()


def test_ocr2_page_launches_k5_then_k4(cuda, monkeypatch):
    """On CUDA, an OCR page's prefill launches K2 and K5 on the packed
    experts (gate, up and down: three launches in the MoE layer) and its
    replayed decode K4 (gate and up in one launch a step; the K = 128
    down projection takes the gathered route) and K1 at one row, none
    falling back; the prefill's logits within 5e-2 of the plain
    versions'; a /v1/ocr through the server launches them again."""
    from ominix_mlx_tpu_torch.ops import grouped_matmul as gmm
    from ominix_mlx_tpu_torch.serving.server import Server

    m = _tiny_ocr2(cuda)
    image = torch.rand(1, 256, 256, 3, generator=torch.Generator(
        device=cuda).manual_seed(5), device=cuda)
    ids = m.prompt_ids("Free OCR.")
    assert len(ids) == 18
    _build.reset_launches()
    with torch.inference_mode():
        logits, cache = m.prefill(image, ids, 8)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["k2"] == 2 and _build.LAUNCHES["k5_w4"] == 3
    before = dict(_build.LAUNCHES)
    toks = list(m.engine().decode(logits, cache, 8))
    torch.cuda.synchronize()
    steps = len(toks) - 1
    assert _build.LAUNCHES["k4"] - before.get("k4", 0) >= steps
    assert _build.LAUNCHES["k1_m1"] - before.get("k1_m1", 0) >= 2 * steps
    with monkeypatch.context() as mp:
        mp.setattr(qm, "_k1", _plain_k1)
        mp.setattr(qm, "_k7", qm.qmm_dq_reference)
        mp.setattr(fa, "_k2", fa.flash_prefill_reference)
        mp.setattr(gmm, "_k5", gmm.grouped_matmul_reference)
        with torch.inference_mode():
            want, _ = m.prefill(image, ids, 8)
    assert _rel(logits, want) < 5e-2
    srv = Server()
    srv.add_model("ocr", m)
    try:
        _build.reset_launches()
        assert srv.ocr({"image": _png_b64(300, 200, 6), "max_tokens": 4})
        assert _build.LAUNCHES["k2"] == 2 and _build.LAUNCHES["k5_w4"] == 3
    finally:
        srv.worker.stop()


def test_visual_flow_never_reaches_k2(cuda, monkeypatch):
    """The visual flow's attention (image tokens bidirectional, queries
    causal) takes the masked sdpa on CUDA, never K2, which is causal only:
    with K2's entry points raising, no K2 launch, and the bf16 result
    within 2e-2 of the float32 flow on the CPU."""
    from ominix_mlx_tpu_torch.models import deepseek_ocr2
    from ominix_mlx_tpu_torch.utils.loading import (flatten_params,
                                                    unflatten_params)

    m = _tiny_ocr2(cuda)

    def refuse(*a, **k):
        raise AssertionError("the visual flow reached K2")

    monkeypatch.setattr(fa, "_k2", refuse)
    monkeypatch.setattr(fa, "flash_prefill", refuse)
    feats = torch.randn(1, 4, 4, 128, generator=torch.Generator(
        device=cuda).manual_seed(7), device=cuda).bfloat16()
    _build.reset_launches()
    with torch.inference_mode():
        got = deepseek_ocr2.visual_flow_encode(m.flow_params, m.flow_cfg,
                                               feats)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["k2"] == 0 and got.shape == (1, 16, 128)
    cpu = {k: v.float().cpu() for k, v in
           flatten_params(m.flow_params).items()}
    with torch.inference_mode():
        want = deepseek_ocr2.visual_flow_encode(
            unflatten_params(cpu), m.flow_cfg, feats.float().cpu())
    assert _rel(got.cpu(), want) < 2e-2


# ------------------------------------------------------------ K12: CIF

def _cif_inputs(dev, B, T, D, dtype, seed):
    """Hidden states and alphas with ragged fires: row 0 sigmoid-like
    alphas, row 1 a stretch that fires at every step, row 2 one that never
    fires (the rows past B are dropped)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(B, T, D, generator=g, device=dev).to(dtype)
    a = torch.rand(B, T, generator=g, device=dev) * 0.8 + 0.05
    if B > 1:
        a[1, : T // 2] = 0.93
    if B > 2:
        a[2] = 0.3 / T
    return h, a.to(dtype).contiguous()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T", [(1, 1), (1, 37), (1, 501), (3, 1),
                                 (3, 37), (3, 501)])
def test_k12_matches_plain_bit_for_bit(cuda, B, T, dtype):
    """K12's frames and counts equal its plain loop's bit for bit (the
    loop's products and sums rounded apart, as PyTorch runs them), one
    launch a call; Paraformer's D = 512 and a ragged D = 200."""
    from ominix_mlx_tpu_torch.ops import cif as tcif

    for D in (512, 200):
        h, a = _cif_inputs(cuda, B, T, D, dtype, seed=T * 10 + B)
        _build.reset_launches()
        frames, counts = tcif.cif(h, a)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["k12"] == 1
        want_f, want_c = tcif.cif_reference(h, a)
        assert torch.equal(counts, want_c), (counts, want_c)
        assert torch.equal(frames, want_f)
        if B > 2:
            assert int(counts[2]) == 0 and not frames[2].any()


def test_k12_clamps_at_max_tokens_and_reuses_no_state(cuda):
    """Writes past max_tokens - 1 land on the last row (as the plain loop
    and jax.lax.dynamic_update_slice); calls in a row give the same
    bits."""
    from ominix_mlx_tpu_torch.ops import cif as tcif

    h, a = _cif_inputs(cuda, 2, 64, 512, torch.bfloat16, seed=3)
    got = tcif.cif(h, a, max_tokens=5)
    want = tcif.cif_reference(h, a, max_tokens=5)
    assert int(want[1].max()) > 5
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    again = tcif.cif(h, a, max_tokens=5)
    assert torch.equal(again[0], got[0])


def test_k12_rejects(cuda):
    from ominix_mlx_tpu_torch.ops import cif as tcif

    h, a = _cif_inputs(cuda, 1, 16, 64, torch.float32, seed=1)
    with pytest.raises(ValueError, match="K12 hidden"):
        tcif.cif(h.half(), a)
    with pytest.raises(ValueError, match="K12 alphas"):
        tcif.cif(h, a[:, ::2])
    with pytest.raises(ValueError, match="K12 takes"):
        tcif.cif(torch.zeros(1, tcif.K12_MAX_T + 1, 8, device=cuda),
                 torch.zeros(1, tcif.K12_MAX_T + 1, device=cuda))


def test_paraformer_transcription_launches_k12(cuda, monkeypatch):
    """On CUDA a Paraformer transcription runs CIF through K12 once (never
    the plain loop), and its ids equal those of the same model with K12
    swapped for its plain version."""
    from ominix_mlx_tpu_torch.models import paraformer as pf
    from ominix_mlx_tpu_torch.ops import cif as tcif

    cfg = pf.ParaformerConfig(n_mels=80, encoder_layers=3, decoder_layers=2,
                              vocab_size=300)
    g = torch.Generator(device=cuda).manual_seed(5)
    m = pf.Transcriber(params=pf.init_params(cfg, g, torch.bfloat16, cuda),
                       cfg=cfg, device=cuda)
    x = torch.randn(16000 * 3, generator=g, device=cuda) * 0.1

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor took CIF's plain loop")

    with monkeypatch.context() as mp:
        mp.setattr(tcif, "cif_reference", refuse)
        _build.reset_launches()
        ids = m.transcribe_ids(x)
        torch.cuda.synchronize()
    assert _build.LAUNCHES["k12"] == 1 and ids
    with monkeypatch.context() as mp:
        mp.setattr(tcif, "_k12", lambda h, a, th, tail, n:
                   tcif.cif_reference(h, a, th, tail, n))
        assert m.transcribe_ids(x) == ids


# ---------------------------------------------------------------- Qwen3-TTS

def _tts_synth(dev, bits=None):
    """A small talker (2 layers, head dim 128, K2's widths) and code
    predictor (2 layers of 2 heads of 128), bf16, its codec-0 head scaled
    up so the codes move; at ``bits`` the talker's layers are quantized
    (group 64, int8 activations), the predictor and heads stay bf16."""
    from ominix_mlx_tpu_torch.models import base
    from ominix_mlx_tpu_torch.models import qwen3_tts as qt

    tcfg = qt.TalkerConfig(
        transformer=base.TransformerConfig(
            vocab_size=1, hidden_size=256, num_layers=2, num_heads=2,
            num_kv_heads=1, head_dim=128, intermediate_size=512,
            use_qk_norm=True),
        codec_vocab_size=256, codec_head_size=264, text_vocab_size=512,
        text_embed_dim=128, cp_hidden=256, cp_layers=2, cp_heads=2,
        codec_eos_id=258, codec_pad_id=259, codec_bos_id=260,
        tts_pad_token_id=300)
    g = torch.Generator(device=dev).manual_seed(3)
    tp = qt.init_params(tcfg, g, torch.bfloat16, dev)
    tp["codec_head"]["w"] = tp["codec_head"]["w"] * 4
    if bits:
        tp = base.quantize_params(tp, 64, bits)
    return qt.Synthesizer(base.fuse_layer_projections(tp), tcfg), tcfg


def _record_counts(record):
    return {k: c for counter, counts in record.launches.values()
            if counter is _build.LAUNCHES for k, c in counts.items() if c}


@pytest.mark.parametrize("bits", [None, 8])
def test_tts_frame_graph_replays_the_eager_body(cuda, bits):
    """The frame step captured once and replayed against the same frames
    with the body run eagerly: every frame's codes and codebook-0 logits
    bit for bit over 12 frames; one capture in the synthesizer's life (a
    second request captures nothing); the capture holds K2 (the
    predictor's 2-token prefill, once a predictor layer) and at 8 bits K1
    at one row (4 a talker layer); no host sync in the body; close()
    frees the graph."""
    syn, tcfg = _tts_synth(cuda, bits)
    text, prefix = list(range(20, 40)), [259] * 4

    def device_frames(step):
        with torch.inference_mode():
            return [(c.clone(), lg.clone())
                    for c, lg in syn._frames(text, prefix, 12, step)]

    want = device_frames(lambda st, cap: syn.frame_body(st))
    with torch.inference_mode():
        st = syn.state(32)
        torch.cuda.set_sync_debug_mode("error")
        try:
            syn.frame_body(st)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    got = device_frames(syn.step)
    assert len(got) == len(want) == 12
    for i, ((gc, gl), (wc, wl)) in enumerate(zip(got, want)):
        assert torch.equal(gc, wc), f"codes of frame {i}"
        assert torch.equal(gl, wl), f"logits of frame {i}"
    frames_e = [c[0].to(torch.int32).cpu().numpy() for c, _ in want]
    frames_g = list(syn.generate_frames(text, prefix, 12))
    assert len(frames_g) == 12
    assert all((a == b).all() for a, b in zip(frames_g, frames_e))
    assert syn.captures == 1 and list(syn.captured.graphs) == [32]
    again = list(syn.generate_frames(text, prefix, 12))
    assert syn.captures == 1
    assert all((a == b).all() for a, b in zip(again, frames_e))
    per_replay = _record_counts(syn.captured.records[32])
    assert per_replay.get("k2") == tcfg.cp_layers
    if bits:
        assert per_replay.get("k1_m1_w8") == 4 * tcfg.transformer.num_layers
    syn.close()
    assert not syn.captured.graphs and not syn._states


@pytest.mark.parametrize("T", [2, 11])
def test_k2_replayed_in_a_graph_matches_eager_and_plain(cuda, T):
    """K2 at the TTS shapes (8 heads of 128; T = 2, the code predictor's
    prefill, and 11, the talker's) launched inside a CapturedBodies graph
    and replayed on new inputs written into its static buffers: bit for
    bit the eager launch on those inputs, and within K2's limit (1e-2 of
    the largest) of its plain version; the capture records one K2
    launch."""
    from ominix_mlx_tpu_torch.core.generate import CapturedBodies

    g = torch.Generator(device=cuda).manual_seed(T)

    def qkv():
        return [torch.randn(1, 8, T, 128, generator=g,
                            device=cuda).bfloat16() for _ in range(3)]

    q, k, v = qkv()
    bodies = CapturedBodies(cuda)
    bodies.run(0, lambda: fa.flash_prefill(q, k, v, 128 ** -0.5))
    assert _record_counts(bodies.records[0]) == {"k2": 1}
    for _ in range(2):
        new = qkv()
        for buf, x in zip((q, k, v), new):
            buf.copy_(x)
        out = bodies.run(0, lambda: None).clone()
        eager = fa.flash_prefill(*new, 128 ** -0.5)
        want, _ = fa.flash_prefill_reference(*new, 128 ** -0.5)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        assert _rel(out, want) < 1e-2
    bodies.close()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [2, 5, 8])
def test_conv_transpose1d_on_cuda_matches_the_cpu_path(cuda, dtype, s):
    """nn.layers.conv_transpose1d (cuDNN) against the same layer on the
    CPU in float32: within 1e-5 of the largest output for float32 inputs
    (no TF32), 1e-2 for bf16."""
    from ominix_mlx_tpu_torch.nn import layers

    g = torch.Generator().manual_seed(s)
    p = {"w": torch.randn(256, 2 * s, 128, generator=g) * 0.05,
         "b": torch.randn(256, generator=g)}
    x = torch.randn(1, 60, 128, generator=g)
    want = layers.conv_transpose1d(p, x, stride=s)
    got = layers.conv_transpose1d({k: t.to(cuda, dtype) for k, t in
                                   p.items()}, x.to(cuda, dtype), stride=s)
    assert got.dtype == dtype and got.shape == want.shape
    assert _rel(got.cpu(), want) < (1e-5 if dtype == torch.float32
                                    else 1e-2)


@pytest.mark.parametrize("shape", ["fsmn", "tdnn", "res2net"])
def test_float32_convolutions_carry_float32_error(cuda, shape):
    """nn.layers.conv1d on float32 inputs on the card against the same
    convolution in float64: within 1e-5 of the largest output (TF32's
    10-bit mantissa would give about 1e-3). Shapes: Paraformer's FSMN
    memory (512 channels, depthwise, K = 11, 501 frames), ECAPA's first
    TDNN (128 mels to 512, K = 5, 300 frames) and a dilated Res2Net conv
    (64 channels, K = 3, dilation 2)."""
    from ominix_mlx_tpu_torch.nn import layers

    cin, cout, K, T, groups, dil = {
        "fsmn": (512, 512, 11, 501, 512, 1),
        "tdnn": (128, 512, 5, 300, 1, 1),
        "res2net": (64, 64, 3, 300, 1, 2)}[shape]
    g = torch.Generator().manual_seed(K)
    p = {"w": torch.randn(cout, K, cin // groups, generator=g,
                          dtype=torch.float64) * (cin * K / groups) ** -0.5}
    x = torch.randn(1, T, cin, generator=g, dtype=torch.float64)
    pad = (K - 1) * dil // 2
    want = layers.conv1d(p, x, padding=pad, groups=groups, dilation=dil)
    got = layers.conv1d({"w": p["w"].float().to(cuda)}, x.float().to(cuda),
                        padding=pad, groups=groups, dilation=dil)
    assert torch.backends.cudnn.allow_tf32      # restored after the call
    assert _rel(got.cpu().double(), want) < 1e-5
