"""The P formula's rows kernel (``qmm_p`` in csrc/qmm.cu: K1 at one row and
K6) on the CPU: its host plan ``qmm_p_rows_per_warp``, the output rows a
warp owns, which must be one the C launch has a template for. The kernel
itself runs on the card (tests/test_torch_kernels_cuda.py, every template
in ``test_qmm_p_every_instantiation``)."""

import pytest

from ominix_mlx_tpu_torch.ops import quant_matmul as tqm


@pytest.mark.parametrize("M,N,rw", [
    (1, 2560, 1), (1, 6144, 2), (1, 19456, 4), (1, 151936, 4), (3, 19456, 4),
    (16, 19456, 2), (9, 4224, 2), (2, 100, 1)])
def test_qmm_p_plan_at_model_shapes(M, N, rw):
    """Qwen3-4B's projections and lm_head: as many rows a warp as still
    leave 16 warps an SM, at most 4 (2 past 4 rows of x)."""
    assert tqm.qmm_p_rows_per_warp(M, N) == rw


@pytest.mark.parametrize("M,N,rw", [(1, 19456, 4), (1, 151936, 4),
                                    (4, 19456, 4), (5, 19456, 1),
                                    (16, 151936, 1), (1, 2560, 1)])
def test_qmm_p_plan_with_bf16_x(M, N, rw):
    """With bf16 activations (a16) a warp owns as many rows as with int8
    ones up to 4 rows of x, and one row past them."""
    assert tqm.qmm_p_rows_per_warp(M, N, a8=False) == rw


@pytest.mark.parametrize("a8", [True, False])
@pytest.mark.parametrize("M", range(1, 17))
def test_qmm_p_plan_has_a_template(M, a8):
    """At every row count and N from 1 to past the lm_head, the rows a
    warp are ones ``launch_p_rw`` in csrc/qmm.cu instantiates: 1, 2 or 4
    up to 4 rows of x (a padded MT of at most 4), 1 or 2 past them with
    int8 x, 1 with bf16 x; and the plan never leaves fewer warps than it
    could have kept with fewer rows a warp."""
    allowed = (1, 2, 4) if M <= 4 else (1, 2) if a8 else (1,)
    for N in (1, 3, 64, 2560, 4223, 4224, 8447, 8448, 19456, 151936):
        rw = tqm.qmm_p_rows_per_warp(M, N, a8)
        assert rw in allowed, (N, rw)
        assert rw == 1 or -(-N // rw) >= tqm.QMM_P_MIN_WARPS, (N, rw)
        wider = [r for r in allowed if r > rw]
        assert all(-(-N // r) < tqm.QMM_P_MIN_WARPS for r in wider), (N, rw)


def test_qmm_p_plan_rejects():
    for M, N in ((0, 64), (17, 64), (1, 0)):
        with pytest.raises(ValueError):
            tqm.qmm_p_rows_per_warp(M, N)
