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


def _row_rel(a, b):
    """max over rows (every index but the last) of max |a - b| over max
    |b| in that row."""
    a, b = a.float(), b.float()
    return ((a - b).abs().amax(-1) / b.abs().amax(-1).clamp_min(1e-12)
            ).max().item()


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


@pytest.mark.parametrize("B,H,Hkv,D,pos,T", [
    (1, 32, 8, 128, 2048, 2048), (1, 32, 8, 128, 6144, 2048),
    (1, 32, 8, 128, 128, 100), (1, 32, 8, 128, 300, 17),
    (2, 4, 4, 64, 1, 1), (2, 8, 2, 64, 5, 33), (2, 4, 1, 256, 77, 100)])
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


def test_model_attention_runs_kernels_or_raises(cuda):
    """On CUDA the model sends a fresh prefill, a continuation chunk and a
    paged decode step to K2, K2c and K3 whatever the shape: a head dim the
    kernels do not take raises, and so does a sliding window in K2's and
    K2c's branches, never a quiet dense path."""
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
    assert run(64, 4) == ["NotImplementedError"] * 2 + [{"k3": 1}]


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
