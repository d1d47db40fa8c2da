"""The continuous batcher's step as one body over static buffers
(``serving.batching``: the counterpart of the JAX package's jitted
``decode_step`` and ``spec_round``, captured as CUDA graphs on the card),
on the CPU, where the bodies run directly.

* The step's greedy tokens against the JAX package's batchers, dense and
  paged, with greedy requests alone and with sampled ones beside them.
* The per-slot draw (``core.sampling.sample_slots`` over ``slot_noise``,
  keyed by the request's seed and the token's absolute position): the
  same (seed, position, logits) gives the same token in any slot, alone or
  beside other rows; a greedy row is the same whichever body runs; the
  draw's frequencies against known probabilities, within a stated bound;
  a preempted sampled request replays its tokens.
* Batched speculation against the JAX package's speculative batchers:
  the target as its own draft (every draft accepted), a first-layer
  self-draft (partial acceptance), the paged pool, prefix caching, the
  refusal of sampled requests and of recurrent layers."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_minicpm as mcpm
from ominix_mlx_tpu.core.sampling import SamplerConfig as JSampler
from ominix_mlx_tpu.models import base as jbase
from ominix_mlx_tpu.serving import batching as jb
from ominix_mlx_tpu_torch.core.sampling import (SamplerConfig, SamplerParams,
                                                _exp_noise, sample_slots,
                                                seed_word, slot_noise)
from ominix_mlx_tpu_torch.models import base as tbase
from ominix_mlx_tpu_torch.models import minicpm_sala as tms
from ominix_mlx_tpu_torch.serving import batching as tb
from ominix_mlx_tpu_torch.utils.params import params_from_numpy

torch.set_num_threads(2)

KW = dict(vocab_size=96, hidden_size=32, num_layers=2, num_heads=2,
          num_kv_heads=1, head_dim=16, intermediate_size=48,
          tie_word_embeddings=True)
JCFG, TCFG = jbase.TransformerConfig(**KW), tbase.TransformerConfig(**KW)
REQS = [("a", [3, 7, 11], 8), ("b", [5, 2], 9), ("c", [9, 1, 4, 8], 6),
        ("d", [13], 7)]
SAMPLED = JSampler(temperature=1.1, top_k=20, top_p=0.9)
TSAMPLED = SamplerConfig(temperature=1.1, top_k=20, top_p=0.9)


@pytest.fixture(scope="module")
def params():
    jp = jbase.init_params(JCFG, jax.random.PRNGKey(0), jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _fwd(mod, cfg):
    return lambda p, t, c, *a: mod.forward(
        p, cfg, t, c, **({"kv_limit": a[0]} if a else {}))


def _batchers(params, paged, slots=2, max_len=128, nd=None,
              draft_layers=None, **kw):
    """(JAX, port) batchers on the same weights; ``nd``: speculative, the
    target itself as the draft, or its first ``draft_layers`` layers."""
    out = []
    for mod, cfg, p, dt in ((jbase, JCFG, params[0], jnp.float32),
                            (tbase, TCFG, params[1], torch.float32)):
        torch_side = mod is tbase
        spec = {}
        if nd is not None:
            dcfg = (cfg if draft_layers is None
                    else dataclasses.replace(cfg, num_layers=draft_layers))
            dp = p if draft_layers is None else dict(
                p, layers=p["layers"][:draft_layers])
            spec = dict(
                draft_forward_fn=_fwd(mod, dcfg), draft_params=dp,
                draft_init_cache_fn=(
                    (lambda s, ml, dcfg=dcfg: mod.init_cache(
                        dcfg, s, ml, dt, "cpu")) if torch_side else
                    (lambda s, ml, dcfg=dcfg: mod.init_cache(dcfg, s, ml,
                                                             dt))),
                num_draft_tokens=nd)
        cls = jb if not torch_side else tb
        if paged:
            cb = cls.PagedContinuousBatcher(
                _fwd(mod, cfg), p, cfg, slots=slots, max_len=max_len,
                page_size=16, dtype=dt, **spec, **kw,
                **({"device": "cpu"} if torch_side else {}))
        else:
            init = ((lambda c, b, ml: mod.init_cache(c, b, ml, dt, "cpu"))
                    if torch_side else
                    (lambda c, b, ml: mod.init_cache(c, b, ml, dt)))
            cb = cls.ContinuousBatcher(_fwd(mod, cfg), p, cfg, init,
                                       slots=slots, max_len=max_len, **spec,
                                       **kw)
        out.append(cb)
    return out


def _greedy(params, prompt, n):
    """The port's plain greedy tokens of one request (its engine)."""
    from ominix_mlx_tpu_torch.core.generate import Engine

    eng = Engine(_fwd(tbase, TCFG), params[1])
    return list(eng.generate(torch.tensor(prompt), tbase.init_cache(
        TCFG, 1, 128, torch.float32, "cpu"), max_tokens=n))


# ------------------------------------------------------------ the step ----

@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_step_matches_jax_batcher(params, paged, mixed):
    """Four requests on two slots (and, when ``mixed``, two sampled ones
    submitted between them): every greedy request's tokens equal the JAX
    batcher's, in the same mix; sampled requests finish, draw in-vocab
    tokens and run the sampled body."""
    jcb, tcb = _batchers(params, paged)
    outs = []
    for cb, sampler in ((jcb, SAMPLED), (tcb, TSAMPLED)):
        for i, (rid, toks, mt) in enumerate(REQS):
            cb.submit(rid, toks, mt)
            if mixed and i < 2:
                cb.submit(f"s{i}", [4 + i, 9], 6, sampler=sampler,
                          seed=20 + i)
        outs.append(cb.run_all([]))
    want, got = outs
    assert {k: got[k] for k, *_ in REQS} == {k: want[k] for k, *_ in REQS}
    assert all(len(got[k]) >= 3 for k, *_ in REQS)
    if mixed:
        assert tcb.sampled_steps >= 1
        assert all(0 <= t < TCFG.vocab_size for i in range(2)
                   for t in got[f"s{i}"]) and len(got["s0"]) == 6
    else:
        assert tcb.sampled_steps == 0


def test_step_body_matches_jax_decode_step(params):
    """One call of the port's ``decode_body`` against one call of the JAX
    batcher's jitted ``decode_step`` from the same adopted state (two
    greedy slots, the offsets, tokens and repetition windows): the next
    tokens, the offsets (an inactive slot held) and the windows equal."""
    jcb, tcb = _batchers(params, paged=False, slots=3)
    for cb in (jcb, tcb):
        cb.submit("a", [3, 7, 11], 8)
        cb.submit("b", [5, 2, 9, 1], 8)
        cb._fill_free_slots()
    active = jnp.asarray([r is not None for r in jcb.active])
    _, joff, jnxt, jrec = jcb._decode(
        jcb.params, list(jcb.cache.layers), jcb.offsets, jcb.toks, active,
        jcb.sparams, jcb.keys, jcb.recent)
    tcb._sync_mask()
    with torch.no_grad():
        tcb.decode_body(False)
    assert tcb.toks[:2].tolist() == np.asarray(jnxt)[:2].tolist()
    assert tcb.offsets.tolist() == np.asarray(joff).tolist() == [4, 5, 0]
    assert tcb.recent[:2].tolist() == np.asarray(jrec)[:2].tolist()


# -------------------------------------------------------- the draw -------

def _sp(rows, device="cpu"):
    """SamplerParams of configs ``rows``."""
    sp = SamplerParams.from_config(SamplerConfig(), len(rows), device)
    for b, cfg in enumerate(rows):
        sp.set_row(b, cfg)
    return sp


def test_draw_depends_on_seed_position_and_logits_only():
    """A row's token is the same alone (slot 0 of 1) and in slot 3 of 5
    beside other rows (random logits, other seeds, positions and
    settings), over 200 (seed, position) pairs; the noise is the same
    for the same key and differs across seeds and positions."""
    g = torch.Generator().manual_seed(0)
    V = 300
    cfg = SamplerConfig(temperature=0.8, top_k=50, top_p=0.95, min_p=0.01)
    others = [SamplerConfig(temperature=1.3), SamplerConfig(),
              SamplerConfig(temperature=0.5, top_k=5),
              SamplerConfig(temperature=1.0, top_p=0.5)]
    for i in range(200):
        row = torch.randn(1, V, generator=g) * 3
        seed, pos = seed_word(i * 7919 - 5), 1 + i * 13
        alone = sample_slots(row, _sp([cfg]), torch.tensor([seed]),
                             torch.tensor([pos]))
        batch = torch.randn(5, V, generator=g) * 3
        batch[3] = row[0]
        seeds = torch.randint(0, 2 ** 62, (5,), generator=g)
        seeds[3] = seed
        poss = torch.randint(0, 4096, (5,), generator=g)
        poss[3] = pos
        got = sample_slots(batch, _sp(others[:3] + [cfg] + others[3:]),
                           seeds, poss)
        assert int(got[3]) == int(alone[0])
    a = slot_noise(torch.tensor([5, 5, 6]), torch.tensor([9, 10, 9]), 64)
    assert torch.equal(a, slot_noise(torch.tensor([5, 5, 6]),
                                     torch.tensor([9, 10, 9]), 64))
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], a[2])
    assert bool((a > 0).all()) and bool(torch.isfinite(a).all())


def test_noise_is_positive_at_every_hash_word():
    """The uniform behind the noise stays inside (0, 1): at the top hash
    word (2^32 - 1) and the others at the ends, the noise is finite and
    > 0; over 1024 (seed, position) keys at Qwen3's vocabulary of 151936
    (155.6 million words, where a uniform that reached 1 would give noise
    0 about 9 times) every noise value is finite and > 0."""
    ends = torch.tensor([0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 512,
                         2 ** 32 - 2, 2 ** 32 - 1])
    e = _exp_noise(ends)
    assert bool((e > 0).all()) and bool(torch.isfinite(e).all()), e
    V = 151936
    for i in range(0, 1024, 64):
        seeds = torch.arange(i, i + 64) * 2654435761 + 12345
        poss = torch.arange(i, i + 64) * 31 + 1
        noise = slot_noise(seeds, poss, V)
        assert bool((noise > 0).all()) and \
            bool(torch.isfinite(noise).all())


def test_top_k_draws_stay_inside_the_top_k_set():
    """256 sampled draws under top_k = 20 at a vocabulary of 151936, each
    a (seed, position) pair with its own random logits: every token is
    one of its row's 20 largest logits (an entry the filter removed has
    probability 0, and 0 over a noise of 0 would be NaN, which argmax
    would pick)."""
    g = torch.Generator().manual_seed(5)
    V, k, rows = 151936, 20, 32
    cfg = SamplerConfig(temperature=0.9, top_k=k)
    for i in range(0, 256, rows):
        logits = torch.randn(rows, V, generator=g)
        seeds = torch.arange(i, i + rows) * 40503 + 7
        poss = torch.arange(i, i + rows) * 17 + 3
        got = sample_slots(logits, _sp([cfg] * rows), seeds, poss)
        top = torch.topk(logits, k, -1).indices
        assert bool((top == got[:, None]).any(-1).all())


def test_greedy_row_is_the_same_in_either_body():
    """Greedy rows (temperature 0, with and without a repetition penalty)
    beside sampled rows: their tokens are the argmax of their (penalised)
    logits in the sampled body, and equal to the greedy body's."""
    g = torch.Generator().manual_seed(1)
    V = 200
    logits = torch.randn(6, V, generator=g) * 4
    rows = [SamplerConfig(), SamplerConfig(temperature=1.0),
            SamplerConfig(repetition_penalty=1.3),
            SamplerConfig(temperature=0.7, top_k=10, repetition_penalty=1.2),
            SamplerConfig(), SamplerConfig(temperature=2.0, min_p=0.1)]
    recent = torch.randint(-1, V, (6, 16), generator=g)
    seeds = torch.arange(6) * 1000 + 3
    poss = torch.arange(6) + 40
    sp = _sp(rows)
    mixed = sample_slots(logits, sp, seeds, poss, recent, sampled=True)
    greedy = sample_slots(logits, sp, seeds, poss, recent, sampled=False)
    for b in (0, 2, 4):
        assert int(mixed[b]) == int(greedy[b])
    assert int(greedy[0]) == int(logits[0].argmax())


def test_draw_frequencies_match_the_probabilities():
    """20000 draws (one a seed, at one position) from probabilities
    (0.4, 0.3, 0.2, 0.07, 0.03) at temperature 1: each count within 5
    standard deviations of N p (the binomial bound; a correct draw misses
    it with probability under 1e-5 a category), and the chi-square
    statistic over the 5 categories (4 degrees of freedom) under 30
    (p < 1e-5)."""
    p = torch.tensor([0.4, 0.3, 0.2, 0.07, 0.03])
    N = 20000
    logits = torch.log(p)[None].expand(N, -1).contiguous()
    sp = _sp([SamplerConfig(temperature=1.0)] * N)
    got = sample_slots(logits, sp, torch.arange(N) * 2654435761 % 2 ** 62,
                       torch.full((N,), 17))
    counts = torch.bincount(got, minlength=5).double()
    expect = N * p.double()
    sd = torch.sqrt(expect * (1 - p.double()))
    assert bool(((counts - expect).abs() <= 5 * sd).all()), counts
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < 30.0, chi2
    # the positions of one seed draw as independently as the seeds do
    pos_draw = sample_slots(logits, sp, torch.full((N,), 99),
                            torch.arange(N) + 1)
    counts = torch.bincount(pos_draw, minlength=5).double()
    assert bool(((counts - expect).abs() <= 5 * sd).all()), counts
    assert math.isclose(float(p.sum()), 1.0, rel_tol=1e-6)


def test_preempted_sampled_request_replays_its_tokens(params):
    """A pool too small for every in-flight sequence (5 usable pages of 4
    tokens): the sampled request is preempted and re-prefilled, and its
    tokens equal those of the same request on a pool that never
    preempts; so do the greedy requests'."""
    _, tp = params

    def run(num_pages):
        cb = tb.PagedContinuousBatcher(
            _fwd(tbase, TCFG), tp, TCFG, slots=2, max_len=64, page_size=4,
            num_pages=num_pages, dtype=torch.float32, device="cpu")
        preempted = []
        real = cb._preempt

        def counting(b):
            preempted.append(cb.active[b].rid)
            real(b)

        cb._preempt = counting
        cb.submit("g", [3, 7, 11], 10)
        cb.submit("s", [5, 2], 12, sampler=TSAMPLED, seed=77)
        cb.submit("h", [9, 1, 4, 8], 8)
        return cb.run_all([]), preempted

    small, preempted = run(6)
    big, none = run(None)
    assert preempted and not none
    assert small == big
    assert len(small["s"]) == 12


# ---------------------------------------------------- batched speculation --

def _check_spec(jcb, tcb, reqs, params):
    want = jcb.run_all(reqs)
    got = tcb.run_all(reqs)
    assert got == want
    for rid, prompt, mt in reqs:
        ref = _greedy(params, prompt, mt)
        assert got[rid] == ref[:len(got[rid])] and \
            len(got[rid]) >= len(ref) - 1, (rid, got[rid], ref)
    return got


def test_spec_batcher_acceptance_one_matches_jax(params):
    """The target as its own draft, 3 drafts: the JAX batcher's tokens
    (plain greedy's) in fewer rounds than tokens."""
    jcb, tcb = _batchers(params, paged=False, nd=3)
    steps = 0
    reqs = [("a", [3, 7, 11], 9), ("b", [5, 2], 7), ("c", [9, 1, 4, 8], 8)]
    for rid, toks, mt in reqs:
        tcb.submit(rid, toks, mt)
    got = {}
    while tcb.pending():
        for rid, out in tcb.step():
            got[rid] = out
        steps += 1
    jcb2, _ = _batchers(params, paged=False, nd=3)
    assert got == jcb2.run_all(reqs)
    assert steps < sum(len(v) for v in got.values())
    assert int(tcb.n_acc.max()) == 3


@pytest.mark.parametrize("nd", [1, 3])
def test_spec_batcher_partial_acceptance_matches_jax(params, nd):
    """A first-layer self-draft (partial acceptance), more requests than
    slots: the JAX batcher's tokens, equal to plain greedy."""
    jcb, tcb = _batchers(params, paged=False, nd=nd, draft_layers=1)
    _check_spec(jcb, tcb, REQS, params)


def test_spec_batcher_paged_pool_matches_jax(params):
    """Speculation on the paged pool (pages reserve the round's nd + 1
    writes): the JAX batcher's tokens; every page returns."""
    jcb, tcb = _batchers(params, paged=True, nd=3, draft_layers=1)
    _check_spec(jcb, tcb, REQS, params)
    assert all(not v for v in tcb.alloc.owned.values())


def test_spec_batcher_composes_with_prefix_cache(params):
    """Speculation, prefix caching and the paged pool in one batcher: the
    second identical 35-token prompt reuses pages (a hit) and both equal
    the JAX batcher's and plain greedy's tokens."""
    jcb, tcb = _batchers(params, paged=True, nd=3, draft_layers=1,
                         prefix_cache=True)
    prompt = [(i * 7 + 3) % 96 for i in range(35)]
    for cb in (jcb, tcb):
        cb.chunk_fwd = _fwd(jbase if cb is jcb else tbase,
                            JCFG if cb is jcb else TCFG)
    outs = [[cb.run_all([(rid, prompt, 7)])[rid] for rid in ("a", "b")]
            for cb in (jcb, tcb)]
    assert outs[1] == outs[0]
    assert tcb.prefix.hits == jcb.prefix.hits == 1
    ref = _greedy(params, prompt, 7)
    assert outs[1][0] == ref[:len(outs[1][0])]


def test_spec_batcher_refuses_sampled_and_recurrent(params):
    """A speculative batcher refuses a sampled request (ValueError, as the
    JAX one); a model with recurrent layers (MiniCPM-SALA's lightning
    layers) refuses a draft (the JAX package's ValueError)."""
    _, tcb = _batchers(params, paged=False, nd=2)
    with pytest.raises(ValueError, match="greedily"):
        tcb.submit("s", [3, 7], 4, sampler=SamplerConfig(temperature=0.8))
    tcb.submit("g", [3, 7], 4, sampler=SamplerConfig(temperature=0.0))
    _, tcfg, _, tp = mcpm._pair()
    fwd = lambda p, t, c: tms.forward(p, tcfg, t, c)
    with pytest.raises(ValueError, match="recurrent"):
        tb.ContinuousBatcher(
            fwd, tp, tcfg,
            lambda c, b, ml: tms.init_cache(c, b, ml, torch.float32,
                                            device="cpu"),
            slots=2, max_len=64, draft_forward_fn=fwd, draft_params=tp,
            draft_init_cache_fn=lambda b, ml: tms.init_cache(
                tcfg, b, ml, torch.float32, device="cpu"))
