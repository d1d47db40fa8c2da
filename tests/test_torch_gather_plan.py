"""K4's and K8's rows kernel (``gather_qmm_a8`` and ``chan_gather_qmm`` in
csrc/gather_qmm.cu) on the CPU: its host plan ``gather_plan`` (lanes a
row, rows a lane group), which must be one the C launch has a template
for, and the order in which a lane group of fewer than 32 lanes sums a
row, which must be the order of a whole warp on the row (so every plan
gives the same bits). The kernel itself runs on the card
(tests/test_torch_kernels_cuda.py, every plan in
``test_gather_every_plan_gives_the_same_bits``)."""

import pathlib
import re

import numpy as np
import pytest

from ominix_mlx_tpu_torch.ops import quant_matmul as tqm

CSRC = pathlib.Path(tqm.__file__).resolve().parent.parent / "csrc"


def test_gather_plans_are_the_templates():
    """GATHER_PLANS is the set of (lanes, rows) that ``by_plan`` in
    csrc/gather_qmm.cu instantiates, and each meets the kernel's
    static_assert: a batch of 8 / rows chunk positions spans whole
    multiples of 32 chunks."""
    src = (CSRC / "gather_qmm.cu").read_text()
    body = src[src.index("int by_plan("):src.index("struct KnownPlan")]
    pairs = {(int(a), int(b)) for a, b in re.findall(
        r"f\(integral_constant<int, (\d+)>\{\}, integral_constant<int, "
        r"(\d+)>\{\}\)", body)}
    assert pairs == set(tqm.GATHER_PLANS)
    for lanes, rows in tqm.GATHER_PLANS:
        assert (8 // rows) % (32 // lanes) == 0, (lanes, rows)


@pytest.mark.parametrize("N,K,bits,plan", [
    (768, 2048, 4, (16, 4)),     # Qwen3-30B-A3B gate and up: 64 chunks
    (768, 2048, 8, (16, 4)),     # the same at 8 bits (and K8): 128
    (2048, 768, 4, (8, 2)),      # down: 24 chunks, 8 lanes a row
    (2048, 768, 8, (16, 4)),     # down at 8 bits (and K8): 48
    (1536, 4096, 4, (16, 4)),    # Qwen3-235B-A22B gate and up
    (4096, 1536, 4, (16, 4)),    # and down: 48 chunks
    (100, 256, 4, (8, 2)),       # the card tests' odd N: 8 chunks
    (100, 256, 8, (16, 4)),      # 16 chunks
    (64, 96, 4, (8, 2)),         # 3 chunks: 8 lanes, 5 of them idle
    (64, 48, 8, (8, 2)),         # 3 chunks at 8 bits
    (64, 1024, 4, (16, 4))])     # 32 chunks
def test_gather_plan_at_model_shapes(N, K, bits, plan):
    """Expert projections [N, K] of the MoE models and of the card tests:
    8 rows a warp, 16 lanes a row where 16 divides the row's 16-byte
    chunks, else 8 (the down projection's 24-chunk 4-bit rows)."""
    assert tqm.gather_plan(K, bits) == plan


@pytest.mark.parametrize("bits", [4, 8])
def test_gather_plan_has_a_template(bits):
    """At every K of up to 64 chunks, the plan is one with a template, a
    warp owns 8 rows, and a lane group is 16 lanes where 16 divides the
    row's chunks, else 8."""
    for chunks in range(1, 65):
        K = chunks * 128 // bits
        lanes, rows = tqm.gather_plan(K, bits)
        assert (lanes, rows) in tqm.GATHER_PLANS
        assert 32 // lanes * rows == 8
        assert lanes == (16 if chunks % 16 == 0 else 8)


def test_gather_plan_rejects():
    for args in ((0, 4), (16, 4), (256, 3), (24, 8), (-128, 8)):
        with pytest.raises(ValueError):
            tqm.gather_plan(*args)


def _fma(a, b, c):
    """One rounding of a * b + c to float32 (the product of two float32
    values is exact in float64); used alike on both sides below."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def _warp_order(s, p, chunks):
    """K4's row sum on a whole warp (one warp a row): lane v sums chunks
    v, v + 32, .. with fmaf, then the butterfly at offsets 16, .., 1."""
    lane = [np.float32(0)] * 32
    for v in range(32):
        for c in range(v, chunks, 32):
            lane[v] = _fma(s[c], p[c], lane[v])
    for o in (16, 8, 4, 2, 1):
        lane = [np.float32(lane[v] + lane[v ^ o]) for v in range(32)]
    return lane[0]


def _group_order(s, p, chunks, lanes, rows):
    """The same sum as gather_qmm_a8 forms it on a group of ``lanes``
    lanes: lane l walks batches of 8 / rows chunk positions (chunk
    base + l + lanes * u), adding chunk u's term to its part u % J (J =
    32 / lanes, the warp lanes it stands for), folds its parts in the
    butterfly's order (offsets 16 .. lanes), then the butterfly over the
    group."""
    J, U = 32 // lanes, 8 // rows
    parts = [[np.float32(0)] * J for _ in range(lanes)]
    for l in range(lanes):
        for base in range(0, chunks, lanes * U):
            for u in range(U):
                c = base + l + lanes * u
                if c < chunks:
                    parts[l][u % J] = _fma(s[c], p[c], parts[l][u % J])
    lane = []
    for v in parts:
        h = J // 2
        while h >= 1:
            v = [np.float32(v[j] + v[j + h]) for j in range(h)] + v[h:]
            h //= 2
        lane.append(v[0])
    o = lanes // 2
    while o >= 1:
        lane = [np.float32(lane[v] + lane[v ^ o]) for v in range(lanes)]
        o //= 2
    return lane[0]


@pytest.mark.parametrize("chunks", [3, 8, 24, 40, 48, 64, 96, 128, 200])
def test_lane_groups_sum_in_the_warp_order(chunks):
    """For every plan, a row summed by a group of 8 or 16 lanes is the
    whole warp's sum bit for bit (random terms of mixed magnitude, so any
    other order would differ somewhere): the down projection's 24-chunk
    rows on 8 lanes keep a whole warp's bits."""
    rng = np.random.default_rng(chunks)
    for trial in range(4):
        s = (rng.standard_normal(chunks)
             * 10.0 ** rng.integers(-3, 4, chunks)).astype(np.float32)
        p = rng.integers(-4000, 4000, chunks).astype(np.float32)
        want = _warp_order(s, p, chunks)
        for lanes, rows in tqm.GATHER_PLANS:
            got = _group_order(s, p, chunks, lanes, rows)
            assert got.view(np.uint32) == want.view(np.uint32), (
                lanes, rows, trial)
