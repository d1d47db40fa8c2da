"""Port parity for speculative decoding (``core.speculative``, the
counterpart of ominix_mlx_tpu/core/speculative.py), on the CPU, where each
round's body runs directly.

The same numpy weights (JAX init, carried across with
``utils.params.params_from_numpy``) go through the JAX package's
``SpeculativeEngine`` and the port's: greedy tokens equal token for token,
and equal plain greedy decoding's (the JAX engine's and the port's),
for a separate draft (partial acceptance), a self-draft of the first
layer, the target as its own draft (every draft accepted) and
``force_accept``, at 1 and 4 drafts a round, for dense, MoE and MLA
targets; MiniCPM-SALA's self-speculation (approximate by design in both
packages: its lightning layers' state keeps rejected drafts) gives the
JAX package's tokens; the capacity check raises where the JAX one does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_minicpm as mcpm
import test_torch_moe_families as moef
from ominix_mlx_tpu.core.generate import Engine as JEngine
from ominix_mlx_tpu.core.speculative import SpecStats as JSpecStats
from ominix_mlx_tpu.core.speculative import SpeculativeEngine as JSpec
from ominix_mlx_tpu.models import base as jbase
from ominix_mlx_tpu.models import minicpm_sala as jms
from ominix_mlx_tpu_torch.core.generate import Engine
from ominix_mlx_tpu_torch.core.speculative import SpecStats, SpeculativeEngine
from ominix_mlx_tpu_torch.models import base as tbase
from ominix_mlx_tpu_torch.models import minicpm_sala as tms
from ominix_mlx_tpu_torch.utils.params import params_from_numpy

torch.set_num_threads(2)

KW = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
          num_kv_heads=2, head_dim=16, use_qk_norm=True,
          intermediate_size=96, tie_word_embeddings=True)
DKW = dict(KW, hidden_size=32, num_layers=1, num_heads=2, num_kv_heads=1,
           intermediate_size=48)
JCFG, TCFG = jbase.TransformerConfig(**KW), tbase.TransformerConfig(**KW)
JDCFG, TDCFG = jbase.TransformerConfig(**DKW), tbase.TransformerConfig(**DKW)
PROMPT = np.array([3, 1, 4, 1, 5])
CAP = 96


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    """(JAX, port) params of the target and of the separate draft."""
    jp = jbase.init_params(JCFG, jax.random.PRNGKey(0), jnp.float32)
    jd = jbase.init_params(JDCFG, jax.random.PRNGKey(1), jnp.float32)
    return (jp, params_from_numpy(_np(jp), "cpu"),
            jd, params_from_numpy(_np(jd), "cpu"))


def _pair(kind, weights):
    """(JAX engine args, port engine args, JAX draft cfg, port draft cfg)
    of a draft ``kind``: "separate", "first_layer" or "whole"."""
    jp, tp, jd, td = weights
    if kind == "separate":
        jdc, tdc, jdp, tdp = JDCFG, TDCFG, jd, td
    elif kind == "whole":
        jdc, tdc, jdp, tdp = JCFG, TCFG, jp, tp
    else:
        jdc = dataclasses.replace(JCFG, num_layers=1)
        tdc = dataclasses.replace(TCFG, num_layers=1)
        jdp, tdp = dict(jp, layers=jp["layers"][:1]), \
            dict(tp, layers=tp["layers"][:1])
    return ((lambda p, t, c: jbase.forward(p, JCFG, t, c), jp,
             lambda p, t, c: jbase.forward(p, jdc, t, c), jdp),
            (lambda p, t, c: tbase.forward(p, TCFG, t, c), tp,
             lambda p, t, c: tbase.forward(p, tdc, t, c), tdp),
            jdc, tdc)


def _caches(jdc, tdc, cap=CAP):
    return ((jbase.init_cache(JCFG, 1, cap, jnp.float32),
             jbase.init_cache(jdc, 1, cap, jnp.float32)),
            (tbase.init_cache(TCFG, 1, cap, torch.float32, "cpu"),
             tbase.init_cache(tdc, 1, cap, torch.float32, "cpu")))


def _greedy(weights, n):
    jp, tp = weights[:2]
    je = JEngine(lambda p, t, c: jbase.forward(p, JCFG, t, c), jp)
    want = list(je.generate(jnp.asarray(PROMPT), jbase.init_cache(
        JCFG, 1, CAP, jnp.float32), max_tokens=n))
    te = Engine(lambda p, t, c: tbase.forward(p, TCFG, t, c), tp)
    got = list(te.generate(torch.from_numpy(PROMPT), tbase.init_cache(
        TCFG, 1, CAP, torch.float32, "cpu"), max_tokens=n))
    assert got == want
    return want


@pytest.mark.parametrize("nd", [1, 4])
@pytest.mark.parametrize("kind", ["separate", "first_layer", "whole"])
def test_engine_matches_jax_and_greedy(weights, kind, nd):
    """generate and generate_scan of the port against the JAX package's
    generate and plain greedy, 20 tokens: equal token for token; the
    acceptance the JAX engine counts (all drafts with the target as its
    own draft)."""
    n = 20
    want = _greedy(weights, n)
    jargs, targs, jdc, tdc = _pair(kind, weights)
    js, ts = JSpec(*jargs, num_draft_tokens=nd), \
        SpeculativeEngine(*targs, num_draft_tokens=nd)
    (jc, jdcache), (tc, tdcache) = _caches(jdc, tdc)
    jst = JSpecStats()
    jtoks = list(js.generate(jnp.asarray(PROMPT), jc, jdcache, max_tokens=n,
                             stats=jst))
    st = SpecStats()
    toks = list(ts.generate(torch.from_numpy(PROMPT), tc, tdcache,
                            max_tokens=n, stats=st))
    (_, _), (tc, tdcache) = _caches(jdc, tdc)
    scan_st = SpecStats()
    scan, rounds = ts.generate_scan(torch.from_numpy(PROMPT), tc, tdcache,
                                    max_tokens=n, stats=scan_st)
    assert jtoks == want and toks == want and scan == want
    assert rounds == scan_st.rounds >= 1
    assert st.accepted == jst.accepted and st.drafted == jst.drafted
    if kind == "whole":
        assert st.accepted == st.drafted
        assert rounds == -(-(n - 1) // (nd + 1))


def test_partial_acceptance_is_partial(weights):
    """The first-layer self-draft at 4 drafts agrees with the target on
    some drafts and not on others (so the partial cases above take both
    branches of the acceptance rule)."""
    _, targs, _, tdc = _pair("first_layer", weights)
    st = SpecStats()
    (_, _), (tc, tdcache) = _caches(JCFG, tdc)
    list(SpeculativeEngine(*targs, num_draft_tokens=4).generate(
        torch.from_numpy(PROMPT), tc, tdcache, max_tokens=40, stats=st))
    assert 0 < st.accepted < st.drafted


@pytest.mark.parametrize("nd", [1, 4])
def test_force_accept_matches_jax(weights, nd):
    """force_accept: every round emits nd + 1 tokens (the target's argmax
    after each draft, accepted or not): the JAX package's tokens."""
    jargs, targs, jdc, tdc = _pair("separate", weights)
    (jc, jdcache), (tc, tdcache) = _caches(jdc, tdc)
    jtoks, _ = JSpec(*jargs, num_draft_tokens=nd,
                     force_accept=True).generate_scan(
        jnp.asarray(PROMPT), jc, jdcache, max_tokens=21)
    st = SpecStats()
    toks, rounds = SpeculativeEngine(
        *targs, num_draft_tokens=nd, force_accept=True).generate_scan(
        torch.from_numpy(PROMPT), tc, tdcache, max_tokens=21, stats=st)
    assert toks == [int(t) for t in jtoks] and len(toks) == 21
    assert st.accepted == st.drafted == rounds * nd == 20 // (nd + 1) * nd


def test_capacity_value_error(weights):
    """generate refuses a request whose prompt, max_tokens and the nd + 1
    transient verify writes overrun the cache, as the JAX engine does;
    generate_scan stops short instead, at the JAX engine's bound."""
    jargs, targs, jdc, tdc = _pair("separate", weights)
    (jc, jdcache), (tc, tdcache) = _caches(jdc, tdc, cap=24)
    with pytest.raises(ValueError, match="capacity"):
        list(JSpec(*jargs, num_draft_tokens=4).generate(
            jnp.asarray(PROMPT), jc, jdcache, max_tokens=16))
    with pytest.raises(ValueError, match="capacity"):
        list(SpeculativeEngine(*targs, num_draft_tokens=4).generate(
            torch.from_numpy(PROMPT), tc, tdcache, max_tokens=16))
    toks, _ = SpeculativeEngine(*targs, num_draft_tokens=4).generate_scan(
        torch.from_numpy(PROMPT), tc, tdcache, max_tokens=16)
    assert 1 <= len(toks) < 16
    assert toks == _greedy(weights, len(toks))
    (jc, jdcache), (tc, tdcache) = _caches(jdc, tdc, cap=26)
    list(SpeculativeEngine(*targs, num_draft_tokens=4).generate(
        torch.from_numpy(PROMPT), tc, tdcache, max_tokens=16))


@pytest.mark.parametrize("name", ["mixtral", "deepseek_v3"])
def test_moe_and_mla_targets_match_greedy(name):
    """A MoE target (Mixtral) and an MLA one (DeepSeek), each with a
    first-layer self-draft at 3 drafts: the port's speculative tokens
    equal its plain greedy ones and the JAX engine's greedy ones."""
    _, _, jmod, tmod, jcfg, tcfg, jp, tp = moef._build(name)
    prompt = np.asarray(moef.TOKENS[0])
    n, cap = 12, 64
    je = JEngine(lambda p, t, c: jmod.forward(p, jcfg, t, c), jp)
    want = list(je.generate(jnp.asarray(prompt), jmod.init_cache(
        jcfg, 1, cap, jnp.float32), max_tokens=n))
    te = Engine(lambda p, t, c: tmod.forward(p, tcfg, t, c), tp)
    plain = list(te.generate(torch.from_numpy(prompt), tmod.init_cache(
        tcfg, 1, cap, torch.float32, device="cpu"), max_tokens=n))
    dcfg = dataclasses.replace(tcfg, num_layers=1)
    eng = SpeculativeEngine(
        lambda p, t, c: tmod.forward(p, tcfg, t, c), tp,
        lambda p, t, c: tmod.forward(p, dcfg, t, c),
        dict(tp, layers=tp["layers"][:1]), num_draft_tokens=3)
    st = SpecStats()
    got = list(eng.generate(
        torch.from_numpy(prompt),
        tmod.init_cache(tcfg, 1, cap, torch.float32, device="cpu"),
        tmod.init_cache(dcfg, 1, cap, torch.float32, device="cpu"),
        max_tokens=n, stats=st))
    assert plain == want and got == want
    assert st.rounds >= 1


def test_minicpm_self_speculation_matches_jax():
    """MiniCPM-SALA's self-speculative draft (its forward over the first
    two layers, num_layers=2), 3 drafts a round: the port's tokens equal
    the JAX package's, each approximate in the same way (rejected drafts
    stay in the lightning layers' state)."""
    jcfg, tcfg, jp, tp = mcpm._pair()
    prompt = np.asarray(mcpm.PROMPT[0, :24])
    n, cap = 10, 96
    js = JSpec(lambda p, t, c: jms.forward(p, jcfg, t, c), jp,
               lambda p, t, c: jms.forward(p, jcfg, t, c, num_layers=2), jp,
               num_draft_tokens=3)
    jst = JSpecStats()
    want = list(js.generate(jnp.asarray(prompt),
                            jms.init_cache(jcfg, 1, cap, jnp.float32),
                            jms.init_cache(jcfg, 1, cap, jnp.float32),
                            max_tokens=n, stats=jst))
    ts = SpeculativeEngine(
        lambda p, t, c: tms.forward(p, tcfg, t, c), tp,
        lambda p, t, c: tms.forward(p, tcfg, t, c, num_layers=2), tp,
        num_draft_tokens=3)
    st = SpecStats()
    got = list(ts.generate(
        torch.from_numpy(prompt),
        tms.init_cache(tcfg, 1, cap, torch.float32, device="cpu"),
        tms.init_cache(tcfg, 1, cap, torch.float32, device="cpu"),
        max_tokens=n, stats=st))
    assert got == want and len(got) == n
    assert st.accepted == jst.accepted
