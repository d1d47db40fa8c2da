"""Lightning attention of the PyTorch port (models/lightning.py,
ops/lightning_attention.py) against the JAX package's
(ominix_mlx_tpu/models/lightning.py) on the same seeded numpy inputs, in
float32 on the CPU, where ``lightning_attention`` takes the plain
versions of kernel K10. Sums run in another order than XLA's, so outputs
and states are held within LIGHTNING_TOL of their largest magnitude."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.models import lightning as jgla
from ominix_mlx_tpu_torch.models import lightning as tgla
from ominix_mlx_tpu_torch.ops import _build
from ominix_mlx_tpu_torch.ops import lightning_attention as la

LIGHTNING_TOL = 1e-5


def _inputs(B, H, L, D, seed, state_scale=0.3):
    g = np.random.default_rng(seed)

    def r(*s):
        return g.standard_normal(s).astype(np.float32)

    return (r(B, H, L, D) * D ** -0.5, r(B, H, L, D), r(B, H, L, D),
            r(B, H, D, D) * state_scale)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


@pytest.mark.parametrize("n", [4, 6, 32])
def test_alibi_slopes_match_jax(n):
    np.testing.assert_array_equal(tgla.alibi_slopes(n), jgla.alibi_slopes(n))


def test_decay_tensors_match_jax():
    s = jgla.alibi_slopes(6)
    for got, want in zip(tgla.decay_tensors(16, s), jgla.decay_tensors(16, s)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_step_matches_jax():
    q, k, v, s0 = _inputs(2, 4, 1, 16, seed=1)
    sl = jgla.alibi_slopes(4)
    jo, jc = jgla.gla_decode_step(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(sl),
                                  jgla.GLACache(jnp.asarray(s0)))
    cache = tgla.GLACache(torch.from_numpy(s0.copy()))
    to, _ = tgla.gla_decode_step(*_t(q, k, v), sl, cache)
    assert _rel(to, jo) < LIGHTNING_TOL
    assert _rel(cache.state, jc.state) < LIGHTNING_TOL


@pytest.mark.parametrize("L,strong", [(64, 1.0), (100, 1.0), (150, 1.0),
                                      (128, 8.0), (192, 8.0)])
def test_chunked_matches_jax(L, strong):
    """The plain chunked form (a partial final chunk at 100 and 150, its
    decays those of its own length) against the JAX pad-and-correct, with
    a nonzero initial state and, at strong=8, decays eight times the
    slopes of 4 heads (exp(-2) a token in the fastest). At strong decay the
    lengths are whole chunks: there the JAX correction exp(-slope * pad)
    meets a state scaled by nearly exp(-84) at L = 150 and loses it
    (test_strong_decay_partial_chunk_is_the_recurrence)."""
    q, k, v, s0 = _inputs(2, 4, L, 16, seed=L)
    sl = jgla.alibi_slopes(4) * np.float32(strong)
    jo, jc = jgla.gla_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              sl, jgla.GLACache(jnp.asarray(s0)))
    cache = tgla.GLACache(torch.from_numpy(s0.copy()))
    to, _ = tgla.gla_chunked(*_t(q, k, v), sl, cache)
    assert _rel(to, jo) < LIGHTNING_TOL
    assert _rel(cache.state, jc.state) < LIGHTNING_TOL


def test_strong_decay_partial_chunk_is_the_recurrence():
    """At strong decay with a partial final chunk the plain chunked form
    equals the JAX decode step applied token by token (the masked chunk
    keeps no padding to correct)."""
    q, k, v, s0 = _inputs(1, 4, 150, 16, seed=9)
    sl = jgla.alibi_slopes(4) * np.float32(8.0)
    jstate, jouts = jgla.GLACache(jnp.asarray(s0)), []
    for t in range(150):
        o, jstate = jgla.gla_decode_step(
            *(jnp.asarray(a[:, :, t:t + 1]) for a in (q, k, v)),
            jnp.asarray(sl), jstate)
        jouts.append(o)
    cache = tgla.GLACache(torch.from_numpy(s0.copy()))
    to, _ = tgla.gla_chunked(*_t(q, k, v), sl, cache)
    assert _rel(to, jnp.concatenate(jouts, 2)) < LIGHTNING_TOL
    assert _rel(cache.state, jstate.state) < LIGHTNING_TOL


@pytest.mark.parametrize("cuts", [(1, 1, 70, 1), (64, 37, 1, 30)])
def test_state_carried_across_calls(cuts):
    """A sequence fed to ``lightning_attention`` in pieces (decode steps
    and chunked calls) against the JAX chunked form over the whole of it:
    the outputs and the final state agree."""
    L = sum(cuts)
    q, k, v, s0 = _inputs(1, 4, L, 16, seed=L)
    sl = jgla.alibi_slopes(4)
    jo, jc = jgla.gla_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              sl, jgla.GLACache(jnp.asarray(s0)))
    state = torch.from_numpy(s0.copy())
    tq, tk, tv = _t(q, k, v)
    outs, t0 = [], 0
    for n in cuts:
        outs.append(la.lightning_attention(
            tq[:, :, t0:t0 + n], tk[:, :, t0:t0 + n], tv[:, :, t0:t0 + n],
            torch.from_numpy(sl), state))
        t0 += n
    assert _rel(torch.cat(outs, 2), jo) < LIGHTNING_TOL
    assert _rel(state, jc.state) < LIGHTNING_TOL


def test_the_forms_are_the_recurrence():
    """Token by token decode steps and one chunked call give the same
    outputs and state (the two plain forms are one function)."""
    q, k, v, s0 = _inputs(2, 4, 90, 16, seed=3)
    sl = torch.from_numpy(jgla.alibi_slopes(4))
    s1, s2 = torch.from_numpy(s0.copy()), torch.from_numpy(s0.copy())
    tq, tk, tv = _t(q, k, v)
    whole = la.chunked_reference(tq, tk, tv, sl, s1)
    steps = torch.cat([la.decay_step_reference(
        tq[:, :, t:t + 1], tk[:, :, t:t + 1], tv[:, :, t:t + 1], sl, s2)
        for t in range(90)], 2)
    assert _rel(steps, whole) < LIGHTNING_TOL
    assert _rel(s2, s1) < LIGHTNING_TOL


@pytest.mark.parametrize("B,T,H,D,form", [
    (1, 1, 32, 128, "recurrent"), (8, 1, 32, 128, "recurrent"),
    (1, la.K10_CHUNK_MIN_T - 1, 32, 128, "recurrent"),
    (1, la.K10_CHUNK_MIN_T, 32, 128, "chunked"),
    (1, 8192, 32, 128, "chunked"), (1, 2048, 32, 64, "recurrent"),
    (64, 65536, 32, 128, "chunked")])
def test_k10_plan(B, T, H, D, form):
    """The form from shapes alone: chunked from K10_CHUNK_MIN_T tokens at
    D = 128, at any batch and length (it keeps no scratch); its one
    launch."""
    assert la.k10_plan(B, T, H, D) == form
    assert la.k10_launches(B, T, H, D) == (
        {"k10_chunk": 1} if form == "chunked" else {"k10": 1})


# ---- the chunked kernel's arithmetic (csrc/lightning_attn.cu), in torch --

K10_COLS = 32      # value columns a CTA


def _split(x, n=3):
    """x (float32) as the kernel's n bf16 pieces (each returned as
    float32): hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)."""
    pieces = []
    for _ in range(n):
        p = x.bfloat16().float()
        pieces.append(p)
        x = x - p
    return pieces


def _pieces_mm(a, b):
    """sum over the piece pairs (i, j) with i + j <= 2 of a_i @ b_j, small
    terms first, in float32 (each product of two bf16 pieces is exact, as
    in the tensor core's float32 accumulator)."""
    out = None
    for s in (2, 1, 0):
        for i in range(len(a)):
            j = s - i
            if 0 <= j < len(b):
                t = a[i] @ b[j]
                out = t if out is None else out + t
    return out


def fused_chunk_reference(q, k, v, slopes, state, chunk=la.K10_CHUNK,
                          pieces=3):
    """The one-launch chunked form as the kernel computes it: a walk over
    the chunks per (row, head) and block of K10_COLS value columns, the
    block's state kept from chunk to chunk; bf16 q, k, v as exact bf16
    operands (float32 ones as three pieces); P, rev * V and the state
    split into three bf16 pieces once a chunk; the decays
    lambda^d = exp(slope d) in float32. q, k, v [B, H, T, D]; the state
    [B, H, D, D] float32 written in place; returns o float32. ``pieces``
    is the number of bf16 pieces of a float32 operand (3 in the kernel)."""
    B, H, T, D = q.shape

    def split(x):
        return _split(x, pieces)

    def ins(x):
        return [x.float()] if q.dtype == torch.bfloat16 else split(x.float())

    o = torch.empty(B, H, T, D)
    for b in range(B):
        for h in range(H):
            pw = torch.exp(slopes[h].float()
                           * torch.arange(chunk + 1, dtype=torch.float32))
            for c0 in range(0, D, K10_COLS):
                cols = slice(c0, c0 + K10_COLS)
                S = state[b, h, :, cols].clone()
                Sp = split(S)
                for t0 in range(0, T, chunk):
                    n = min(chunk, T - t0)
                    Q = ins(q[b, h, t0:t0 + n])
                    K = ins(k[b, h, t0:t0 + n])
                    V = ins(v[b, h, t0:t0 + n, cols])
                    i = torch.arange(n)
                    diff = i[:, None] - i[None, :]
                    A = _pieces_mm(Q, [x.T for x in K])
                    P = torch.where(diff >= 0, pw[diff.clamp(min=0)] * A,
                                    torch.zeros(()))
                    Vf = sum(V[1:], V[0])
                    VR = split(Vf * pw[n - 1 - i][:, None])
                    out = _pieces_mm(Q, Sp) * pw[i + 1][:, None]
                    o[b, h, t0:t0 + n, cols] = out + _pieces_mm(split(P), V)
                    S = S * pw[n] + _pieces_mm([x.T for x in K], VR)
                    Sp = split(S)
                state[b, h, :, cols] = S
    return o


def _bf16_inputs(B, H, L, D, seed, dtype, strong):
    q, k, v, s0 = _inputs(B, H, L, D, seed=seed)
    if dtype == "bf16":         # the values the kernel reads, both sides
        q, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
                   for a in (q, k, v))
    return q, k, v, s0, jgla.alibi_slopes(H) * np.float32(strong)


def _as(dtype, *arrays):
    ts = _t(*arrays)
    return [t.bfloat16() for t in ts] if dtype == "bf16" else ts


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("L", [1, 63, 64, 65, 200])
def test_fused_chunk_arithmetic_matches_jax(L, dtype):
    """The kernel's arithmetic (bf16 pieces, the column-block walk) against
    the JAX gla_chunked at MiniCPM-SALA's head width, a carried state:
    outputs and state within LIGHTNING_TOL."""
    q, k, v, s0, sl = _bf16_inputs(1, 2, L, 128, L, dtype, 1.0)
    jo, jc = jgla.gla_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              sl, jgla.GLACache(jnp.asarray(s0)))
    state = torch.from_numpy(s0.copy())
    to = fused_chunk_reference(*_as(dtype, q, k, v), torch.from_numpy(sl),
                               state)
    assert _rel(to, jo) < LIGHTNING_TOL
    assert _rel(state, jc.state) < LIGHTNING_TOL


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("L", [1, 63, 64, 65, 200])
def test_fused_chunk_arithmetic_strong_decay_is_the_recurrence(L, dtype):
    """At decays eight times MiniCPM-SALA's (exp(-2) a token in the
    fastest head), short last chunks included: the kernel's arithmetic
    against the JAX decode step token by token."""
    q, k, v, s0, sl = _bf16_inputs(1, 4, L, 128, 100 + L, dtype, 8.0)
    jstate, jouts = jgla.GLACache(jnp.asarray(s0)), []
    for t in range(L):
        o, jstate = jgla.gla_decode_step(
            *(jnp.asarray(a[:, :, t:t + 1]) for a in (q, k, v)),
            jnp.asarray(sl), jstate)
        jouts.append(o)
    state = torch.from_numpy(s0.copy())
    to = fused_chunk_reference(*_as(dtype, q, k, v), torch.from_numpy(sl),
                               state)
    assert _rel(to, jnp.concatenate(jouts, 2)) < LIGHTNING_TOL
    assert _rel(state, jstate.state) < LIGHTNING_TOL


@pytest.mark.parametrize("cuts", [(1, 63, 64, 65, 7), (200, 1, 30)])
def test_fused_chunk_state_across_cuts(cuts):
    """A prompt fed in pieces through the kernel's arithmetic, the state
    carried between calls, against the JAX chunked form over the whole:
    outputs and final state within LIGHTNING_TOL."""
    L = sum(cuts)
    q, k, v, s0, sl = _bf16_inputs(1, 2, L, 128, 7 + L, "bf16", 2.0)
    jo, jc = jgla.gla_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              sl, jgla.GLACache(jnp.asarray(s0)))
    state = torch.from_numpy(s0.copy())
    tq, tk, tv = _as("bf16", q, k, v)
    outs, t0 = [], 0
    for n in cuts:
        outs.append(fused_chunk_reference(
            tq[:, :, t0:t0 + n], tk[:, :, t0:t0 + n], tv[:, :, t0:t0 + n],
            torch.from_numpy(sl), state))
        t0 += n
    assert _rel(torch.cat(outs, 2), jo) < LIGHTNING_TOL
    assert _rel(state, jc.state) < LIGHTNING_TOL


def test_fused_chunk_pieces_are_needed():
    """A control: with P, rev * V and the state as ONE bf16 piece each, the
    same arithmetic misses LIGHTNING_TOL by far (the pieces, not the walk,
    carry float32's precision)."""
    q, k, v, s0, sl = _bf16_inputs(1, 2, 130, 128, 5, "bf16", 1.0)
    jo, _ = jgla.gla_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             sl, jgla.GLACache(jnp.asarray(s0)))
    to = fused_chunk_reference(*_as("bf16", q, k, v), torch.from_numpy(sl),
                               torch.from_numpy(s0.copy()), pieces=1)
    assert _rel(to, jo) > 10 * LIGHTNING_TOL


def test_cpu_tensors_take_the_plain_version():
    """On the CPU no kernel launches and nothing is counted."""
    q, k, v, s0 = _inputs(1, 4, 40, 16, seed=5)
    _build.reset_launches()
    la.lightning_attention(*_t(q, k, v),
                           torch.from_numpy(jgla.alibi_slopes(4)),
                           torch.from_numpy(s0))
    assert sum(_build.LAUNCHES.values()) == 0


def test_cache_rows_are_views():
    c = tgla.GLACache.init(3, 2, 8, device="cpu")
    c.rows(1).state.fill_(2.0)
    assert c.state[1].eq(2).all() and c.state[0].eq(0).all()
    c.rows(1).zero_()
    assert c.state.eq(0).all()
    assert not hasattr(c, "max_len")
