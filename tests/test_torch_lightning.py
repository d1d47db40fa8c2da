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
    (64, 65536, 32, 128, "recurrent")])
def test_k10_plan(B, T, H, D, form):
    """The form from shapes alone: chunked from K10_CHUNK_MIN_T tokens at
    D = 128 while its scratch fits K10_CHUNK_MAX_SCRATCH; its launches."""
    assert la.k10_plan(B, T, H, D) == form
    assert la.k10_launches(B, T, H, D) == (
        {"k10_chunk": 1, "k10_chunk_scan": 1} if form == "chunked"
        else {"k10": 1})


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

