"""InfLLMv2 sparse attention of the PyTorch port
(models/sparse_attention.py, ops/sparse_attention.py) against the JAX
package's (ominix_mlx_tpu/models/sparse_attention.py) on the same seeded
numpy inputs, in float32 on the CPU, where ``block_scores`` and
``sparse_attend`` take the plain versions of kernel K11. The caches'
writes are exact; pooled keys, scores and outputs are float32 sums in
another order than XLA's, held within SPARSE_TOL of their largest
magnitude."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.core.attention import NEG_INF as JNEG_INF
from ominix_mlx_tpu.core.attention import sdpa as jsdpa
from ominix_mlx_tpu.core.cache import KVCache as JKVCache
from ominix_mlx_tpu.models import sparse_attention as jsa
from ominix_mlx_tpu_torch.core.attention import causal_mask, sdpa
from ominix_mlx_tpu_torch.core.cache import KVCache
from ominix_mlx_tpu_torch.models import sparse_attention as tsa
from ominix_mlx_tpu_torch.ops import sparse_attention as osa

SPARSE_TOL = 1e-5
B, HKV, H, S, D = 2, 2, 8, 1024, 16
# a small InfLLMv2 config: blocks of 16 tokens, one init block of 32, a
# window of 128, the top 8 blocks
SMALL = dict(kernel_size=16, block_size=32, init_blocks=1, window_size=128,
             topk=8)
JCFG, TCFG = jsa.SparseConfig(**SMALL), tsa.SparseConfig(**SMALL)


def _r(g, *shape):
    return g.standard_normal(shape).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _caches(seed=0):
    return (jsa.SparseKVCache.init(B, HKV, S, D, jnp.float32, 16),
            tsa.SparseKVCache.init(B, HKV, S, D, torch.float32, 16,
                                   device="cpu"))


def _same(jc, tc):
    np.testing.assert_array_equal(tc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(tc.v.numpy(), np.asarray(jc.v))
    assert _rel(tc.comp, jc.comp) < SPARSE_TOL


def _write(jc, tc, g, T, offset):
    k, v = _r(g, B, HKV, T, D), _r(g, B, HKV, T, D)
    if isinstance(offset, np.ndarray):
        jo, to = jnp.asarray(offset), torch.from_numpy(offset).long()
    else:
        jo, to = jnp.asarray(offset, jnp.int32), offset
    jc = jc.update(jnp.asarray(k), jnp.asarray(v), jo)
    tc.update(torch.from_numpy(k), torch.from_numpy(v), to)
    return jc


def _filled(seed=0, upto=S):
    """Both caches written with the same random K/V over [0, upto)."""
    g = np.random.default_rng(seed)
    jc, tc = _caches()
    return _write(jc, tc, g, upto, 0), tc


def test_compress_keys_matches_jax():
    g = np.random.default_rng(0)
    keys = _r(g, B, HKV, 200, D)
    got = tsa.compress_keys(torch.from_numpy(keys), 16)
    assert got.shape == (B, HKV, 12, D)
    assert _rel(got, jsa.compress_keys(jnp.asarray(keys), 16)) < SPARSE_TOL


def test_update_at_scalar_offsets_matches_jax():
    """Appends of 37, 1, 5, 100 and 1 tokens from offset 0 (starting
    inside blocks): k and v equal, comp re-pooled only where touched."""
    g = np.random.default_rng(1)
    jc, tc = _caches()
    off = 0
    for T in (37, 1, 5, 100, 1):
        jc = _write(jc, tc, g, T, off)
        off += T
        _same(jc, tc)


def test_update_at_per_row_offsets_matches_jax():
    """The batcher's per-row writes at misaligned offsets of each row."""
    g = np.random.default_rng(2)
    jc, tc = _caches()
    jc = _write(jc, tc, g, 50, 0)
    offs = np.array([50, 13], np.int32)
    for T in (3, 1, 1, 40):
        jc = _write(jc, tc, g, T, offs)
        offs = offs + T
        _same(jc, tc)


def test_rows_are_views():
    _, tc = _filled(upto=64)
    r = tc.rows(1)
    assert r.max_len == S and r.kernel_size == 16
    r.update(torch.ones(1, HKV, 16, D), torch.ones(1, HKV, 16, D), 64)
    assert tc.k[1, :, 64:80].eq(1).all() and tc.comp[1, :, 4].eq(1).all()
    assert not tc.k[0, :, 64:80].eq(1).all()


def _decode(jc, tc, q, offset, cfg=(JCFG, TCFG)):
    if isinstance(offset, np.ndarray):
        jo, to = jnp.asarray(offset), torch.from_numpy(offset).long()
    else:
        jo, to = jnp.asarray(offset, jnp.int32), offset
    want = jsa.sparse_decode_attention(jnp.asarray(q), jc, jo, cfg[0],
                                       D ** -0.5)
    got = tsa.sparse_decode_attention(torch.from_numpy(q), tc, to, cfg[1],
                                      D ** -0.5)
    return got, want


@pytest.mark.parametrize("offset", [0, 100, 159, 160, 600, 1023,
                                    np.array([700, 40], np.int32),
                                    np.array([1023, 431], np.int32)])
def test_sparse_decode_matches_jax(offset):
    """One decode step at scalar and per-row offsets, short contexts
    (total <= init + window: exact dense) and long ones (the top 8 of up
    to 54 middle blocks)."""
    jc, tc = _filled(seed=3)
    q = _r(np.random.default_rng(4), B, H, 1, D)
    got, want = _decode(jc, tc, q, offset)
    assert got.shape == (B, H, 1, D)
    assert _rel(got, want) < SPARSE_TOL


def _selected(scores, topk):
    """Per (row, KV head) the sorted block ids of the finite top-k."""
    vals, idx = torch.topk(torch.as_tensor(np.asarray(scores)), topk, -1)
    return [[sorted(i[v > JNEG_INF / 2].tolist()) for v, i in zip(vr, ir)]
            for vr, ir in zip(vals, idx)]


@pytest.mark.parametrize("total", [64, 200, 700, 1024])
def test_block_scores_and_selection_match_jax(total):
    """The masked block scores against the JAX formula (the einsum of the
    first query head of each group over comp, NEG_INF outside [init_end,
    window_start - ks]) and the selected sets equal."""
    jc, tc = _filled(seed=5)
    q = _r(np.random.default_rng(6), B, H, 1, D)
    tot = torch.full((B,), total, dtype=torch.int32)
    got = osa.block_scores_reference(torch.from_numpy(q), tc.comp, tot,
                                     TCFG.init_end, TCFG.window_size, 16)
    n_rep = H // HKV
    qs = jnp.asarray(q).reshape(B, HKV, n_rep, 1, D)[:, :, 0]
    raw = jnp.einsum("bhqd,bhnd->bhqn", qs, jc.comp)[:, :, 0]
    start = np.arange(S // 16) * 16
    ws = max(total - SMALL["window_size"], TCFG.init_end)
    valid = (start >= TCFG.init_end) & (start + 16 <= ws)
    want = np.where(valid[None, None], np.asarray(raw), JNEG_INF)
    assert np.array_equal(got.numpy() <= JNEG_INF / 2, want <= JNEG_INF / 2)
    if valid.any():
        assert _rel(got.numpy()[..., valid], want[..., valid]) < SPARSE_TOL
    assert _selected(got, 8) == _selected(want, 8)


def test_needle_block_is_selected():
    """A block whose keys align with the scoring query is in every row's
    selection, and its values reach the output: attention to a needle
    placed far outside the window."""
    g = np.random.default_rng(7)
    jc, tc = _caches()
    k, v = _r(g, B, HKV, S, D) * 0.1, _r(g, B, HKV, S, D)
    q = _r(g, B, H, 1, D)
    qs = q.reshape(B, HKV, H // HKV, D)[:, :, 0]
    k[:, :, 320:336] = qs[:, :, None] * 4.0       # block 20
    v[:, :, 320:336] = 50.0
    jc = jc.update(jnp.asarray(k), jnp.asarray(v), jnp.asarray(0, jnp.int32))
    tc.update(torch.from_numpy(k), torch.from_numpy(v), 0)
    tot = torch.full((B,), 1000, dtype=torch.int32)
    sc = osa.block_scores(torch.from_numpy(q), tc.comp, tot, TCFG.init_end,
                          TCFG.window_size, 16)
    assert all(20 in sel for row in _selected(sc, 8) for sel in row)
    got, want = _decode(jc, tc, q, 999)
    assert _rel(got, want) < SPARSE_TOL
    assert got[:, ::H // HKV].mean() > 10.0        # the scoring heads


def test_short_context_is_dense_attention():
    """Within init + window the sparse step is exact dense causal
    attention over the written prefix."""
    jc, tc = _filled(seed=8)
    q = torch.from_numpy(_r(np.random.default_rng(9), B, H, 1, D))
    got = tsa.sparse_decode_attention(q, tc, 140, TCFG, D ** -0.5)
    dense = sdpa(q, tc.k, tc.v, D ** -0.5, causal_mask(1, S, 140))
    assert _rel(got, dense) < SPARSE_TOL


def test_plain_attend_equals_jax_gather_and_sdpa():
    """``sparse_attend_reference`` given indices and scores equals the JAX
    package's gather of init + blocks + window and its masked sdpa, built
    here from the same indices (per-row totals)."""
    jc, tc = _filled(seed=10)
    g = np.random.default_rng(11)
    q = _r(g, B, H, 1, D)
    total = np.array([900, 300], np.int64)
    nb, topk, ks, W, ie = S // 16, 8, 16, 128, 32
    idx = np.stack([np.stack([g.choice(nb, topk, replace=False)
                              for _ in range(HKV)]) for _ in range(B)])
    top = _r(g, B, HKV, topk)
    top[1, 0, 5:] = JNEG_INF          # fewer valid blocks in one head
    got = osa.sparse_attend_reference(
        torch.from_numpy(q), tc.k, tc.v, torch.from_numpy(idx),
        torch.from_numpy(top), torch.from_numpy(total), ie, W, ks,
        D ** -0.5)
    ws = np.maximum(total - W, ie)
    blk = (idx[..., None] * ks + np.arange(ks)).reshape(B, HKV, -1)
    win = total[:, None] - W + np.arange(W)
    gi = np.concatenate([np.broadcast_to(np.arange(ie), (B, HKV, ie)), blk,
                         np.broadcast_to(np.clip(win, 0, S - 1)[:, None],
                                         (B, HKV, W))], -1)
    valid = np.concatenate([
        np.broadcast_to(np.arange(ie)[None, None] < total[:, None, None],
                        (B, HKV, ie)),
        np.repeat(top > JNEG_INF / 2, ks, -1),
        np.broadcast_to((win >= ws[:, None])[:, None], (B, HKV, W))], -1)
    gk = jnp.take_along_axis(jc.k, jnp.asarray(gi)[..., None], axis=2)
    gv = jnp.take_along_axis(jc.v, jnp.asarray(gi)[..., None], axis=2)
    mask = jnp.where(jnp.asarray(valid), 0.0, JNEG_INF)[:, :, None]
    want = jsdpa(jnp.asarray(q), gk, gv, D ** -0.5, mask)
    assert _rel(got, want) < SPARSE_TOL


def test_plain_kv_cache_pools_its_keys():
    """A plain KVCache (no pooled keys) recomputes them, as the JAX
    package's fallback does."""
    jc, tc = _filled(seed=12)
    q = _r(np.random.default_rng(13), B, H, 1, D)
    want = jsa.sparse_decode_attention(
        jnp.asarray(q), JKVCache(k=jc.k, v=jc.v), jnp.asarray(800),
        JCFG, D ** -0.5)
    got = tsa.sparse_decode_attention(torch.from_numpy(q),
                                      KVCache(k=tc.k, v=tc.v), 800, TCFG,
                                      D ** -0.5)
    assert _rel(got, want) < SPARSE_TOL


@pytest.mark.parametrize("B_,Hkv,slots,want", [
    (1, 2, 4160, (33, 128)), (8, 2, 4160, (13, 320)),
    (1, 2, 100, (1, 128)), (64, 8, 4160, (1, 4160))])
def test_k11_plan(B_, Hkv, slots, want):
    """Splits of whole 64-slot tiles, at least two a split, from shapes
    alone, at most two CTAs an SM; every slot is covered."""
    splits, sps = osa.k11_plan(B_, Hkv, slots)
    assert (splits, sps) == want
    assert sps % 64 == 0 and splits * sps >= slots > (splits - 1) * sps


def test_config_defaults_match_jax():
    assert tsa.SparseConfig() == tsa.SparseConfig(**{
        f: getattr(jsa.SparseConfig(), f)
        for f in jsa.SparseConfig.__dataclass_fields__})
    assert tsa.SparseConfig().init_end == 64
