"""InfLLMv2's block selection in the PyTorch port (ops/sparse_attention.py
``block_select``: kernel k11_select on CUDA, its plain version
``block_select_reference`` on the CPU) against the JAX package's scores
and ``jax.lax.top_k`` (ominix_mlx_tpu/models/sparse_attention.py:150-166)
on the same seeded numpy inputs, in float32 on the CPU: the selected ids
in the same order, equal scores by block index (planted ties), fewer valid
blocks than k, fewer blocks than topk; the decode step that uses it
against the JAX package's; and a model of the kernel's plan (runs of 512
blocks sorted in chunks, merged in index order with the chunks that hold
no valid block passed over, one list a CTA merged by the last) against a
stable sort. Scores are float32 sums in another order than XLA's, held
within SCORE_TOL of their largest magnitude; the ids are held exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.core.attention import NEG_INF as JNEG_INF
from ominix_mlx_tpu.models import sparse_attention as jsa
from ominix_mlx_tpu_torch.models import sparse_attention as tsa
from ominix_mlx_tpu_torch.ops import sparse_attention as osa

SCORE_TOL = 1e-5
B, HKV, H, D, KS = 2, 2, 8, 16, 16
SMALL = dict(kernel_size=KS, block_size=32, init_blocks=1, window_size=128,
             topk=8)
JCFG, TCFG = jsa.SparseConfig(**SMALL), tsa.SparseConfig(**SMALL)


def _jax_select(q, comp, totals, topk):
    """The JAX package's masked scores and lax.top_k (its lines 150-166)."""
    nb = comp.shape[2]
    qs = jnp.asarray(q).reshape(B, HKV, H // HKV, 1, D)[:, :, 0]
    scores = jnp.einsum("bhqd,bhnd->bhqn", qs.astype(jnp.float32),
                        jnp.asarray(comp, jnp.float32))
    start = jnp.arange(nb) * KS
    ws = jnp.maximum(jnp.asarray(totals) - SMALL["window_size"],
                     TCFG.init_end)
    valid = (start[None] >= TCFG.init_end) & (start[None] + KS <= ws[:, None])
    scores = jnp.where(valid[:, None, None], scores, JNEG_INF)[:, :, 0]
    vals, idx = jax.lax.top_k(scores, min(topk, nb))
    return np.asarray(vals), np.asarray(idx)


def _inputs(nb, seed, ties=False):
    g = np.random.default_rng(seed)
    q = g.standard_normal((B, H, 1, D)).astype(np.float32)
    comp = g.standard_normal((B, HKV, nb, D)).astype(np.float32)
    if ties:        # every block from 40 on repeats one of blocks 8..39
        src = 8 + np.arange(nb - 40) % 32
        comp[:, :, 40:] = comp[:, :, src]
    return q, comp


def _port_select(q, comp, totals, topk):
    vals, idx = osa.block_select_reference(
        torch.from_numpy(q), torch.from_numpy(comp),
        torch.tensor(totals, dtype=torch.int32), TCFG.init_end,
        TCFG.window_size, KS, min(topk, comp.shape[2]))
    return vals.numpy(), idx.numpy()


def _held(got, want):
    (gv, gi), (wv, wi) = got, want
    assert gi.dtype == np.int64 and gv.dtype == np.float32
    np.testing.assert_array_equal(gi, wi)
    fin = wv > JNEG_INF / 2
    np.testing.assert_array_equal(gv > JNEG_INF / 2, fin)
    if fin.any():
        assert (np.abs(gv - wv)[fin].max() / np.abs(wv[fin]).max()
                < SCORE_TOL)


@pytest.mark.parametrize("totals", [[1024, 1024], [700, 300], [2, 170]])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_select_matches_jax_top_k(totals, ties):
    """The ids and scores of the top 8 of 64 blocks, in lax.top_k's order:
    with planted ties (blocks 40.. repeat blocks 8..39, so equal scores
    come in pairs) the lower block first; rows with few or no valid
    blocks fill with NEG_INF in index order."""
    q, comp = _inputs(64, seed=len(totals) + totals[1], ties=ties)
    _held(_port_select(q, comp, totals, 8), _jax_select(q, comp, totals, 8))
    if ties:
        vals, idx = _port_select(q, comp, totals, 64)
        for vr, ir in zip(vals.reshape(-1, 64), idx.reshape(-1, 64)):
            same = vr[1:] == vr[:-1]
            assert (ir[1:][same] > ir[:-1][same]).all()


def test_fewer_blocks_than_topk():
    """nb < topk: k = nb, every block ranked, as the JAX package's
    min(topk, nb)."""
    q, comp = _inputs(5, seed=11)
    _held(_port_select(q, comp, [80, 80], 8), _jax_select(q, comp, [80, 80],
                                                           8))


def test_fewer_valid_blocks_than_k():
    """Three valid blocks of 64 (total 210: the window starts at 82, so
    blocks 2..4 are whole before it): three finite scores, then NEG_INF
    with in-range ids, lowest first."""
    q, comp = _inputs(64, seed=12)
    vals, idx = _port_select(q, comp, [210, 210], 8)
    _held((vals, idx), _jax_select(q, comp, [210, 210], 8))
    assert (vals[..., :3] > JNEG_INF / 2).all()
    assert (vals[..., 3:] <= JNEG_INF / 2).all()
    np.testing.assert_array_equal(idx[..., 3:],
                                  np.broadcast_to([0, 1, 5, 6, 7], (B, HKV,
                                                                    5)))


@pytest.mark.parametrize("offset", [100, 600, 1023,
                                    np.array([1023, 431], np.int32)])
def test_sparse_decode_attention_matches_jax(offset):
    """The decode step through block_select against the JAX package's, at
    scalar and per-row offsets."""
    g = np.random.default_rng(13)
    jc = jsa.SparseKVCache.init(B, HKV, 1024, D, jnp.float32, KS)
    tc = tsa.SparseKVCache.init(B, HKV, 1024, D, torch.float32, KS,
                                device="cpu")
    k = g.standard_normal((B, HKV, 1024, D)).astype(np.float32)
    v = g.standard_normal((B, HKV, 1024, D)).astype(np.float32)
    jc = jc.update(jnp.asarray(k), jnp.asarray(v), jnp.asarray(0, jnp.int32))
    tc.update(torch.from_numpy(k), torch.from_numpy(v), 0)
    q = g.standard_normal((B, H, 1, D)).astype(np.float32)
    if isinstance(offset, np.ndarray):
        jo, to = jnp.asarray(offset), torch.from_numpy(offset).long()
    else:
        jo, to = jnp.asarray(offset, jnp.int32), offset
    want = np.asarray(jsa.sparse_decode_attention(jnp.asarray(q), jc, jo,
                                                  JCFG, D ** -0.5))
    got = tsa.sparse_decode_attention(torch.from_numpy(q), tc, to, TCFG,
                                      D ** -0.5).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < SCORE_TOL


@pytest.mark.parametrize("nb,ctas,rounds", [
    (1, 1, 1), (512, 1, 1), (513, 2, 1), (2048, 4, 1), (16384, 32, 1),
    (16385, 17, 2), (40000, 27, 3)])
def test_k11_select_plan(nb, ctas, rounds):
    """Runs of 512 blocks, at most 32 CTAs a (row, KV head), the fewest
    rounds a CTA that allows; the CTAs cover every block."""
    assert osa.k11_select_plan(nb) == (ctas, rounds)
    assert ctas * rounds * osa.K11_SELECT_SPAN >= nb
    assert ctas <= osa.K11_SELECT_MAX_CTAS


def _keys(scores, n0, n1, lo, hi, nb):
    """k11_select's keys of positions [n0, n1): (score, -index) for the
    valid blocks, (NEG_INF, -index) for the others, padding past nb below
    every block."""
    out = []
    for n in range(n0, n1):
        if n >= nb:
            out.append((-np.inf, -np.inf, -n))
        else:
            out.append((0, scores[n] if lo <= n < hi else JNEG_INF, -n))
    return out


def _top(a, b, L):
    return sorted(a + b, reverse=True)[:L]


def _select_model(scores, lo, hi, k):
    """The kernel's plan in Python: each CTA's runs of 512 sorted in
    chunks of L, a chunk that holds no valid block left as it is (already
    in order), neighbours merged into the lower one unless the upper holds
    no valid block; the runs folded; the CTAs' lists merged the same way
    (pairs first, then strides)."""
    nb = len(scores)
    L = osa.k11_select_width(k)
    ctas, rounds = osa.k11_select_plan(nb)
    span = rounds * osa.K11_SELECT_SPAN

    def valid(n0, n1):
        return n0 < hi and n1 > lo

    lists = []
    for c in range(ctas):
        best = None
        for r in range(rounds):
            start = c * span + r * osa.K11_SELECT_SPAN
            if not valid(start, start + osa.K11_SELECT_SPAN):
                if best is None:
                    best = _keys(scores, start, start + L, lo, hi, nb)
                continue
            chunks = [_keys(scores, start + i * L, start + (i + 1) * L, lo,
                            hi, nb)
                      for i in range(osa.K11_SELECT_SPAN // L)]
            chunks = [sorted(ch, reverse=True)
                      if valid(start + i * L, start + (i + 1) * L) else ch
                      for i, ch in enumerate(chunks)]
            st = 1
            while st < len(chunks):
                for i in range(0, len(chunks), 2 * st):
                    if i + st < len(chunks) and valid(
                            start + (i + st) * L, start + (i + 2 * st) * L):
                        chunks[i] = _top(chunks[i], chunks[i + st], L)
                st *= 2
            best = chunks[0] if best is None else _top(best, chunks[0], L)
        lists.append(best)
    if ctas > 1:
        merged = []
        for i in range(0, ctas, 2):
            merged.append(_top(lists[i], lists[i + 1], L)
                          if i + 1 < ctas
                          and valid((i + 1) * span, (i + 2) * span)
                          else lists[i])
        st = 1
        while st < len(merged):
            for i in range(0, len(merged), 2 * st):
                if i + st < len(merged) and valid(2 * (i + st) * span,
                                                  2 * (i + 2 * st) * span):
                    merged[i] = _top(merged[i], merged[i + st], L)
            st *= 2
        lists = merged
    return [-key[2] for key in lists[0][:k]]


@pytest.mark.parametrize("nb,lo,hi,k", [
    (128, 2, 64, 64), (2048, 2, 1984, 64), (16384, 2, 16320, 64),
    (3000, 1500, 1600, 64), (3000, 2, 40, 64), (3000, 2, 2, 64),
    (700, 650, 700, 128), (16385, 2, 16385, 256), (100, 0, 100, 100)])
def test_select_plan_model_matches_stable_sort(nb, lo, hi, k):
    """The kernel's plan, passing over chunks, runs and CTAs that hold no
    valid block, selects what a stable descending sort of the masked
    scores does (ties planted: scores rounded to a few values)."""
    g = np.random.default_rng(nb + lo + hi + k)
    scores = np.round(g.standard_normal(nb), 1).astype(np.float32)
    masked = np.where((np.arange(nb) >= lo) & (np.arange(nb) < hi), scores,
                      np.float32(JNEG_INF))
    want = np.argsort(-masked, kind="stable")[:k].tolist()
    assert _select_model(scores, lo, hi, k) == want


def test_cpu_tensors_take_the_plain_version():
    q, comp = _inputs(64, seed=14)
    args = (torch.from_numpy(q), torch.from_numpy(comp),
            torch.tensor([900, 900], dtype=torch.int32), TCFG.init_end,
            TCFG.window_size, KS, 8)
    got = osa.block_select(*args)
    want = osa.block_select_reference(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
