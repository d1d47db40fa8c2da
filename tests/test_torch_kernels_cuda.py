"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here needs a CUDA card and skips without one; the file imports
neither jax nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from ominix_mlx_tpu_torch.core.quant import QuantizedTensor
from ominix_mlx_tpu_torch.ops import _build
from ominix_mlx_tpu_torch.ops import flash_attention as fa
from ominix_mlx_tpu_torch.ops import quant_matmul as qm

pytestmark = pytest.mark.cuda
EPS = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ with no "
                    "CPU mode")
    return torch.device("cuda")


def _packed(dev, N, K, act_bits, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    qt = QuantizedTensor(
        q=torch.randint(-8, 8, (N, K), generator=g, device=dev,
                        dtype=torch.int8),
        scales=((torch.rand(N, K // 64, generator=g, device=dev) + 0.5)
                * K ** -0.5 / 8).bfloat16(),
        biases=(torch.randn(N, K // 64, generator=g, device=dev)
                * K ** -0.5 / 4).bfloat16(),
        group_size=64, bits=4)
    return qm.prepare(qt, act_bits=act_bits), g


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


@pytest.mark.parametrize("N,K", [(100, 2560), (2560, 9728), (6144, 2560)])
@pytest.mark.parametrize("mode", ["a8", "a8_norm", "a16", "a16_norm"])
def test_k1_m1_matches_plain(cuda, N, K, mode):
    """K1 at M=1, ragged N and G=152 included: rel < 1e-2 (bf16 output,
    another summation order)."""
    a8 = mode.startswith("a8")
    pq, g = _packed(cuda, N, K, 8 if a8 else None)
    x = torch.randn(1, K, generator=g, device=cuda).bfloat16()
    nw = ((1 + 0.1 * torch.randn(K, generator=g, device=cuda)).bfloat16()
          if mode.endswith("norm") else None)
    got = qm._k1(x, pq, nw, EPS, a8)
    want = qm.quantized_matmul_reference(x, pq, nw, EPS,
                                         act_bits=8 if a8 else None)
    torch.cuda.synchronize()
    assert _rel(got, want) < 1e-2


@pytest.mark.parametrize("M", [2, 5, 16])
def test_k1_m_gt_1_matches_plain(cuda, M):
    pq, g = _packed(cuda, 2560, 9728, None, seed=M)
    x = torch.randn(M, 9728, generator=g, device=cuda).bfloat16()
    got = qm._k1(x, pq, None, EPS, False)
    want = qm.quantized_matmul_reference(x, pq)
    torch.cuda.synchronize()
    assert _rel(got, want) < 1e-2


def test_k1_dispatch_counts_and_rejects(cuda):
    pq, g = _packed(cuda, 256, 512, 8)
    _build.reset_launches()
    for M in (1, 4, 17):
        y = qm.quantized_matmul(
            torch.randn(M, 512, generator=g, device=cuda).bfloat16(), pq)
        assert y.shape == (M, 256)
    assert _build.LAUNCHES["k1_m1"] == 1 and _build.LAUNCHES["k1_mn"] == 1
    with pytest.raises(ValueError):
        qm._k1(torch.randn(1, 512, device=cuda), pq, None, EPS, True)
    with pytest.raises(ValueError):
        qm._k1(torch.randn(2, 512, device=cuda).bfloat16(), pq, None, EPS,
               True)


@pytest.mark.parametrize("T,H,Hkv,D", [(2, 4, 4, 64), (33, 8, 2, 64),
                                       (128, 32, 8, 128), (777, 32, 8, 128),
                                       (100, 4, 1, 256)])
def test_k2_matches_plain(cuda, T, H, Hkv, D):
    """K2 against its plain version: max error over max |plain| < 1e-2
    (bf16 output, relative so that an output above 4, where one bf16 ulp
    is 3.1e-2, cannot fail a right kernel); LSE within 1e-3 absolute,
    the check that catches wrong scores."""
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
