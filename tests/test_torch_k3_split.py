"""K3's split-KV index math on the CPU: the host plan ``k3_plan`` (split
count and pages a split, from shapes alone), and a plain PyTorch model of
the kernel's partition (splits of whole pages, 64-key tiles, 16 keys a
warp, an online softmax per warp with bf16 probabilities, the warps merged,
then the splits merged in split order) held to ``paged_decode_reference``
and once to the JAX package's Pallas kernel in interpret mode. The model
reads the page table only where the kernel does: its tables carry garbage
past each row's length. K3 itself runs on the card
(tests/test_torch_kernels_cuda.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.core import paged_cache as jpc
from ominix_mlx_tpu.ops import paged_attention as jpa
from ominix_mlx_tpu_torch.ops import paged_attention as pa

torch.set_num_threads(2)
K3_TOL = 3e-2     # per (row, head), as chip_smoke.py holds the kernel
WARPS, WARP_KEYS = 4, 16


@pytest.mark.parametrize("B,Hkv,groups,MP,ps", [
    (8, 8, 1, 16, 128), (1, 8, 1, 256, 128), (8, 4, 1, 8, 128),
    (8, 8, 1, 32, 128), (2, 2, 1, 48, 16), (3, 2, 1, 5, 16), (1, 2, 1, 9, 4),
    (1, 1, 4, 1000, 1), (64, 8, 2, 64, 64), (1, 8, 1, 3, 128)])
def test_k3_plan_covers_every_page(B, Hkv, groups, MP, ps):
    """The splits cover the table's pages once (none empty by pages), each
    holds at least K3_MIN_SPLIT_TOKENS tokens unless the whole table is
    shorter, and the grid aims at K3_CTAS_PER_SM CTAs an SM."""
    plan = pa.k3_plan(B, Hkv, groups, MP, ps)
    S, pps = plan.splits, plan.pages_per_split
    assert 1 <= pps <= MP and S == math.ceil(MP / pps)
    assert (S - 1) * pps < MP <= S * pps
    assert pps * ps >= min(pa.K3_MIN_SPLIT_TOKENS, MP * ps)
    if S > 1:                        # no finer than the target needs
        assert B * Hkv * groups * (S - 1) < pa.K3_CTAS_PER_SM * pa.SMS
    covered = sorted(p for s in range(S)
                     for p in range(s * pps, min((s + 1) * pps, MP)))
    assert covered == list(range(MP))


def test_k3_plan_at_the_timed_shapes():
    """Qwen3-4B's heads at page 128: 8 splits of 2 pages for B=8 x 16
    pages, 64 of 4 for one row of 256 pages; one split for a short
    table."""
    assert pa.k3_plan(8, 8, 1, 16, 128) == pa.K3Plan(8, 2)
    assert pa.k3_plan(1, 8, 1, 256, 128) == pa.K3Plan(64, 4)
    assert pa.k3_plan(2, 2, 1, 2, 128) == pa.K3Plan(1, 2)
    with pytest.raises(ValueError):
        pa.k3_plan(0, 8, 1, 16, 128)


def k3_model(q, k_pool, v_pool, table, lengths, scale, window=0,
             k_scale=None, v_scale=None):
    """The kernel's partition and merge order in float32 PyTorch."""
    B, H, D = q.shape
    _, Hkv, ps, _ = k_pool.shape
    MP = table.shape[1]
    G = H // Hkv
    R = pa._rows_per_cta(G)
    plan = pa.k3_plan(B, Hkv, G // R, MP, ps)
    S, span = plan.splits, plan.pages_per_split * ps
    quant = k_scale is not None
    qk = scale * math.log2(math.e)
    out = torch.empty(B, H, D)
    for b in range(B):
        n = min(int(lengths[b]), MP * ps)
        start = max(n - window, 0) if window > 0 else 0
        for h0 in range(0, H, R):
            j = h0 // G
            qr = q[b, h0:h0 + R].float()
            parts = []
            for s in range(S):
                lo, hi = max(s * span, start), min((s + 1) * span, n)
                if lo >= hi:
                    parts.append(None)
                    continue
                first = s * span + (lo - s * span) // pa.K3_TILE * pa.K3_TILE
                m = torch.full((WARPS, R), -math.inf)
                l_ = torch.zeros(WARPS, R)
                o = torch.zeros(WARPS, R, D)
                for t0 in range(first, hi, pa.K3_TILE):
                    for w in range(WARPS):
                        t = t0 + WARP_KEYS * w + torch.arange(WARP_KEYS)
                        ok = (t >= lo) & (t < hi)
                        kr = torch.zeros(WARP_KEYS, D)
                        vr = torch.zeros(WARP_KEYS, D)
                        ksc = torch.ones(WARP_KEYS)
                        vsc = torch.ones(WARP_KEYS)
                        for i in torch.nonzero(ok).flatten().tolist():
                            ti = int(t[i])
                            page = int(table[b, ti // ps])    # valid only
                            kr[i] = k_pool[page, j, ti % ps].float()
                            vr[i] = v_pool[page, j, ti % ps].float()
                            if quant:
                                ksc[i] = k_scale[page, j, ti % ps]
                                vsc[i] = v_scale[page, j, ti % ps]
                        x = (qr @ kr.T) * qk * ksc
                        x = torch.where(ok, x, -math.inf)
                        m_new = torch.maximum(m[w], x.max(1).values)
                        alpha = torch.where(m_new == -math.inf, 1.0,
                                            torch.exp2(m[w] - m_new))
                        p = torch.where(ok, torch.exp2(x - m_new[:, None]),
                                        0.0)
                        l_[w] = l_[w] * alpha + p.sum(1)
                        pv = (p * vsc).to(torch.bfloat16).float()
                        o[w] = o[w] * alpha[:, None] + pv @ vr
                        m[w] = m_new
                mm = m.max(0).values
                f = torch.where(m == -math.inf, 0.0, torch.exp2(m - mm))
                parts.append((mm, (f * l_).sum(0), (f[..., None] * o).sum(0)))
            valid = [p for p in parts if p is not None]
            mm = torch.stack([p[0] for p in valid]).max(0).values
            num, den = torch.zeros(R, D), torch.zeros(R)
            for pm, pl, pacc in valid:                # split order
                f = torch.where(pm == -math.inf, 0.0, torch.exp2(pm - mm))
                num += f[:, None] * pacc
                den += f * pl
            out[b, h0:h0 + R] = num / den[:, None]
    return out.to(q.dtype)


def _inputs(B, H, Hkv, D, ps, MP, lengths, quant, seed):
    """numpy-seeded pools (bf16, or int8 codes with f32 scales), a
    shuffled table, and the same table with garbage page ids past each
    row's length."""
    rng = np.random.default_rng(seed)
    P = B * MP + 1
    q = torch.from_numpy(rng.standard_normal((B, H, D), np.float32)
                         ).bfloat16()
    if quant:
        kp, vp = (torch.from_numpy(rng.integers(-127, 128, (P, Hkv, ps, D),
                                                dtype=np.int8))
                  for _ in range(2))
        ks, vs = (torch.from_numpy((rng.random((P, Hkv, ps)) / 64 + 1e-3
                                    ).astype(np.float32)) for _ in range(2))
    else:
        kp, vp = (torch.from_numpy(rng.standard_normal((P, Hkv, ps, D),
                                                       np.float32)).bfloat16()
                  for _ in range(2))
        ks = vs = None
    table = torch.from_numpy((rng.permutation(P - 1) + 1).reshape(
        B, MP).astype(np.int32))
    bad = table.clone()
    for b, n in enumerate(lengths):
        bad[b, -(-n // ps):] = 1 << 30
    return q, kp, vp, ks, vs, table, bad, torch.tensor(lengths)


def _row_rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().amax(-1) / b.abs().amax(-1).clamp_min(1e-12)
            ).max().item()


# page 16, 48 pages a row: 3 splits of 256 tokens (boundaries 256, 512)
PS, MP, SPAN = 16, 48, 256
LENGTHS = [(1, PS - 1, PS, PS + 1), (SPAN - 1, SPAN, SPAN + 1, 2 * SPAN - 1),
           (2 * SPAN + 1, MP * PS - 1, MP * PS, 3)]
# window starts inside the last split, at a split's start, before a split
WINDOWS = [(700, 100), (700, 700 - SPAN * 2), (700, 500), (300, 45)]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("lengths", LENGTHS)
def test_k3_model_matches_reference(quant, lengths):
    """Lengths 1, ps-1, ps, ps+1 and a split boundary +-1, bf16 and int8
    pages, 8 query heads over 2 KV heads (4 rows a CTA)."""
    assert pa.k3_plan(len(lengths), 2, 1, MP, PS) == pa.K3Plan(3, SPAN // PS)
    q, kp, vp, ks, vs, table, bad, lens = _inputs(
        len(lengths), 8, 2, 64, PS, MP, lengths, quant, seed=len(lengths))
    got = k3_model(q, kp, vp, bad, lens, 64 ** -0.5, 0, ks, vs)
    want = pa.paged_decode_reference(q, kp, vp, table, lens, 64 ** -0.5,
                                     k_scale=ks, v_scale=vs)
    assert _row_rel(got, want) < K3_TOL


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("length,window", WINDOWS)
def test_k3_model_window_across_splits(quant, length, window):
    """A sliding window that starts inside a split, at a split's first
    token, and before a split (so whole splits are skipped), 16 query
    heads over 2 KV heads (two CTAs of 8 rows a KV head)."""
    q, kp, vp, ks, vs, table, bad, lens = _inputs(
        2, 16, 2, 64, PS, MP, [length, length // 2], quant, seed=window)
    got = k3_model(q, kp, vp, bad, lens, 64 ** -0.5, window, ks, vs)
    want = pa.paged_decode_reference(q, kp, vp, table, lens, 64 ** -0.5,
                                     window=window, k_scale=ks, v_scale=vs)
    assert _row_rel(got, want) < K3_TOL


def test_k3_rows_per_cta():
    """The largest of 8, 4, 2 and 1 that divides the query heads a KV
    head: GLM-4.5-Air's 96 over 8 (12) take 4, so 3 CTAs a KV head."""
    got = {G: pa._rows_per_cta(G) for G in (1, 2, 3, 4, 6, 8, 12, 16, 24)}
    assert got == {1: 1, 2: 2, 3: 1, 4: 4, 6: 2, 8: 8, 12: 4, 16: 8, 24: 8}
    with pytest.raises(ValueError):
        pa._rows_per_cta(0)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 45])
def test_k3_model_at_12_heads_a_kv_head(quant, window):
    """24 query heads over 2 KV heads (GLM-4.5-Air's 12 a KV head): three
    CTAs of 4 rows a KV head, across splits, with and without a window."""
    q, kp, vp, ks, vs, table, bad, lens = _inputs(
        2, 24, 2, 64, PS, MP, [700, 300], quant, seed=12 + window)
    got = k3_model(q, kp, vp, bad, lens, 64 ** -0.5, window, ks, vs)
    want = pa.paged_decode_reference(q, kp, vp, table, lens, 64 ** -0.5,
                                     window=window, k_scale=ks, v_scale=vs)
    assert _row_rel(got, want) < K3_TOL


@pytest.mark.parametrize("quant", [False, True])
def test_k3_model_matches_jax_kernel(quant):
    """The model against the JAX package's Pallas kernel in interpret mode
    (as tests/test_torch_paged.py runs it) at page 128, 4 splits of 2
    pages: per (row, head) within K3_TOL of max |JAX|."""
    B, NKV, D, ps, mp = 2, 2, 128, 128, 8
    lengths = [300, 1000]
    assert pa.k3_plan(B, NKV, 1, mp, ps) == pa.K3Plan(4, 2)
    rng = np.random.default_rng(5)
    P = B * mp + 1
    kn = rng.standard_normal((NKV, P, ps, D)).astype(np.float32)
    vn = rng.standard_normal((NKV, P, ps, D)).astype(np.float32)
    table = (rng.permutation(P - 1) + 1).reshape(B, mp).astype(np.int32)
    q = rng.standard_normal((B, 4 * NKV, D)).astype(np.float32)
    if quant:
        kq, ksj = jpc.quantize_kv_tokens(jnp.asarray(kn))
        vq, vsj = jpc.quantize_kv_tokens(jnp.asarray(vn))
        kj, vj = jnp.asarray(kq), jnp.asarray(vq)
    else:
        kj, vj = jnp.asarray(kn, jnp.bfloat16), jnp.asarray(vn, jnp.bfloat16)
        ksj = vsj = None
    want = np.asarray(jpa.paged_decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.transpose(kj, (0, 1, 3, 2)), vj,
        jnp.asarray(table), jnp.asarray(lengths, jnp.int32), D ** -0.5,
        interpret=True, k_scale=ksj, v_scale=vsj), np.float32)

    def port(a):        # JAX [NKV, P, ...] -> port [P, NKV, ...]
        t = torch.from_numpy(np.array(a, np.float32 if a.dtype ==
                                        jnp.bfloat16 else a.dtype))
        t = t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t
        return t.transpose(0, 1).contiguous()

    got = k3_model(torch.from_numpy(q).bfloat16(), port(kj), port(vj),
                   torch.from_numpy(table), torch.tensor(lengths), D ** -0.5,
                   0, None if ksj is None else port(ksj),
                   None if vsj is None else port(vsj))
    assert _row_rel(got, torch.from_numpy(want)) < K3_TOL
