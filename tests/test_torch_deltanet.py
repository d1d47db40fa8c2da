"""The port's Gated DeltaNet (models/deltanet.py) and the plain version of
its recurrence kernel K9 (ops/gated_delta.py) against the JAX package's
``deltanet`` and HF's ``torch_recurrent_gated_delta_rule``, on the CPU.
Inputs are made with numpy from a seed and given to both packages.

Tolerances: K9's plain version sums in float32 as the JAX scan does, in
another order (torch einsum against XLA's dot): held at 2e-5 relative
over T = 64 steps; ``block`` in float32 at 1e-5, in bf16 at 2e-2 (the
projections round to bf16 at other points of a sum, as the JAX
package's own bf16 parity bounds allow)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.core import cache as jcache
from ominix_mlx_tpu.core import paged_cache as jpaged
from ominix_mlx_tpu.models import deltanet as jdn
from ominix_mlx_tpu_torch.core import cache as tcache
from ominix_mlx_tpu_torch.core.paged_cache import PagedKVCache
from ominix_mlx_tpu_torch.models import deltanet as tdn
from ominix_mlx_tpu_torch.ops import _build
from ominix_mlx_tpu_torch.ops import gated_delta as gd

torch.set_num_threads(2)

RULE_TOL = 2e-5
BLOCK_TOL_F32 = 1e-5
BLOCK_TOL_BF16 = 2e-2


def _l2n(x):
    return x / np.sqrt((x * x).sum(-1, keepdims=True) + 1e-6)


def _rule_inputs(T, r, seed, B=2, Hk=2, dk=8, dv=12):
    """l2-normed q (scaled) and k, v, g < 0, beta in (0, 1), and a carried
    state that is not zero."""
    rng = np.random.default_rng(seed)
    Hv = Hk * r
    q = _l2n(rng.standard_normal((B, T, Hk, dk))).astype(np.float32)
    k = _l2n(rng.standard_normal((B, T, Hk, dk))).astype(np.float32)
    return {"q": q * np.float32(dk ** -0.5), "k": k,
            "v": rng.standard_normal((B, T, Hv, dv)).astype(np.float32),
            "g": -rng.uniform(0.01, 1.5, (B, T, Hv)).astype(np.float32),
            "beta": rng.uniform(0.05, 0.95, (B, T, Hv)).astype(np.float32),
            "state": rng.standard_normal((B, Hv, dk, dv)).astype(np.float32)}


def _jax_scan(q, k, v, g, beta, state):
    """The JAX package's recurrence as it stands in deltanet.block
    (ominix_mlx_tpu/models/deltanet.py:125-144): repeat, then the scan."""
    r = v.shape[2] // q.shape[2]
    q, k = jnp.repeat(q, r, axis=2), jnp.repeat(k, r, axis=2)

    def step(S, inp):
        q_t, k_t, v_t, g_t, b_t = inp
        S = S * jnp.exp(g_t)[..., None, None]
        kv_mem = jnp.einsum("bhkv,bhk->bhv", S, k_t)
        delta = (v_t - kv_mem) * b_t[..., None]
        S = S + jnp.einsum("bhk,bhv->bhkv", k_t, delta)
        return S, jnp.einsum("bhkv,bhk->bhv", S, q_t)

    seq = tuple(jnp.moveaxis(jnp.asarray(a), 1, 0) for a in (q, k, v, g,
                                                             beta))
    S, outs = jax.lax.scan(step, jnp.asarray(state), seq)
    return np.asarray(jnp.moveaxis(outs, 0, 1)), np.asarray(S)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("T", [1, 5, 64])
@pytest.mark.parametrize("r", [1, 2])
def test_rule_reference_matches_jax_scan_and_hf(T, r):
    """K9's plain version against the JAX scan and HF's recurrence, from a
    carried state: outputs and the final state, written in place."""
    from transformers.models.qwen3_next.modeling_qwen3_next import \
        torch_recurrent_gated_delta_rule

    a = _rule_inputs(T, r, seed=T * 10 + r)
    want_o, want_s = _jax_scan(**a)
    t = {n: torch.from_numpy(x.copy()) for n, x in a.items()}
    state = t["state"].clone()
    o = gd.gated_delta_rule_reference(t["q"], t["k"], t["v"], t["g"],
                                      t["beta"], state)
    assert o.dtype == torch.float32 and o.shape == a["v"].shape
    assert _rel(o.numpy(), want_o) < RULE_TOL
    assert _rel(state.numpy(), want_s) < RULE_TOL
    # HF repeats the heads before the rule and scales q inside it
    dk = a["q"].shape[-1]
    hq = (t["q"] / dk ** -0.5).repeat_interleave(r, 2)
    hk = t["k"].repeat_interleave(r, 2)
    ho, hs = torch_recurrent_gated_delta_rule(
        hq, hk, t["v"], t["g"], t["beta"], t["state"].clone(), True)
    assert _rel(o.numpy(), ho.numpy()) < RULE_TOL
    assert _rel(state.numpy(), hs.numpy()) < RULE_TOL


def test_rule_on_cpu_takes_the_plain_version_and_counts_nothing():
    """A CPU tensor never reaches K9: gated_delta_rule is the plain version
    bit for bit and the launch count stays 0; two calls of T/2 carry the
    state as one call of T."""
    a = _rule_inputs(6, 2, seed=3)
    t = {n: torch.from_numpy(x.copy()) for n, x in a.items()}
    _build.reset_launches()
    s1, s2 = t["state"].clone(), t["state"].clone()
    o1 = gd.gated_delta_rule(t["q"], t["k"], t["v"], t["g"], t["beta"], s1)
    o2 = gd.gated_delta_rule_reference(t["q"], t["k"], t["v"], t["g"],
                                       t["beta"], s2)
    assert torch.equal(o1, o2) and torch.equal(s1, s2)
    assert _build.LAUNCHES["k9"] == 0
    s3 = t["state"].clone()
    parts = [gd.gated_delta_rule(*(t[n][:, sl] for n in ("q", "k", "v", "g",
                                                         "beta")), s3)
             for sl in (slice(0, 3), slice(3, 6))]
    assert _rel(torch.cat(parts, 1).numpy(), o2.numpy()) < RULE_TOL
    assert _rel(s3.numpy(), s2.numpy()) < RULE_TOL


def _block_setup(r, conv_layout, seed, D=24, Hk=2, dk=8, dv=8, K=3):
    rng = np.random.default_rng(seed)
    jcfg = jdn.DeltaNetConfig(num_v_heads=Hk * r, num_k_heads=Hk,
                              head_k_dim=dk, head_v_dim=dv, conv_kernel=K)
    Hv, C = Hk * r, jcfg.conv_dim
    nqkvz = 2 * jcfg.key_dim + 2 * jcfg.value_dim

    def w(o, i):
        return (rng.standard_normal((o, i)) * i ** -0.5).astype(np.float32)

    conv = (rng.standard_normal((C, 1, K) if conv_layout == "hf"
                                else (C, K, 1)) * 0.5).astype(np.float32)
    lp = {"in_proj_qkvz": {"w": w(nqkvz, D)},
          "in_proj_ba": {"w": w(2 * Hv, D)},
          "conv1d": {"w": conv},
          "dt_bias": rng.standard_normal(Hv).astype(np.float32),
          "A_log": np.log(rng.uniform(1, 16, Hv)).astype(np.float32),
          "norm": (1 + 0.1 * rng.standard_normal(dv)).astype(np.float32),
          "out_proj": {"w": w(D, jcfg.value_dim)}}
    state = rng.standard_normal((2, Hv, dk, dv)).astype(np.float32)
    window = rng.standard_normal((2, K - 1, C)).astype(np.float32)
    return jcfg, lp, state, window, rng


def _tree(lp, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in lp.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("T", [1, 7])
def test_block_matches_jax(dtype, r, T):
    """deltanet.block against the JAX block from a carried state and conv
    window: the output, the new state and the new window (written in place
    into the port's cache); the conv weight in HF's [C, 1, K] layout at
    r = 1 and MLX's [C, K, 1] at r = 2."""
    jcfg, lp, state, window, rng = _block_setup(
        r, "hf" if r == 1 else "mlx", seed=r * 100 + T)
    tcfg = tdn.DeltaNetConfig(**{f: getattr(jcfg, f) for f in (
        "num_v_heads", "num_k_heads", "head_k_dim", "head_v_dim",
        "conv_kernel", "rms_norm_eps")})
    x = rng.standard_normal((2, T, 24)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jlp = _tree(lp, lambda a: jnp.asarray(a).astype(jdt))
    jc = jdn.RecurrentCache(state=jnp.asarray(state),
                            conv=jnp.asarray(window).astype(jdt))
    jout, jnew = jdn.block(jlp, jcfg, jnp.asarray(x).astype(jdt), jc)
    tlp = _tree(lp, lambda a: torch.from_numpy(a).to(tdt))
    tc = tdn.RecurrentCache(state=torch.from_numpy(state.copy()),
                            conv=torch.from_numpy(window).to(tdt))
    st, cv = tc.state, tc.conv
    with torch.inference_mode():
        tout, tnew = tdn.block(tlp, tcfg, torch.from_numpy(x).to(tdt), tc)
    assert tnew.state is st and tnew.conv is cv       # written in place
    assert tout.dtype == tdt and tnew.conv.dtype == tdt
    assert tnew.state.dtype == torch.float32
    tol = BLOCK_TOL_F32 if dtype == "float32" else BLOCK_TOL_BF16
    f = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    assert _rel(tout.float().numpy(), f(jout)) < tol
    assert _rel(tnew.state.numpy(), f(jnew.state)) < tol
    assert _rel(tnew.conv.float().numpy(), f(jnew.conv)) < tol


def test_split_qkvz_ba_matches_jax():
    jcfg, _, _, _, rng = _block_setup(2, "hf", seed=7)
    tcfg = tdn.DeltaNetConfig(num_v_heads=4, num_k_heads=2, head_k_dim=8,
                              head_v_dim=8, conv_kernel=3)
    qkvz = rng.standard_normal((2, 3, 2 * 16 + 2 * 32)).astype(np.float32)
    ba = rng.standard_normal((2, 3, 8)).astype(np.float32)
    jp = jdn._split_qkvz_ba(jnp.asarray(qkvz), jnp.asarray(ba), jcfg)
    tp = tdn._split_qkvz_ba(torch.from_numpy(qkvz), torch.from_numpy(ba),
                            tcfg)
    for j, t in zip(jp, tp):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_ingests_padding_matches_jax_on_every_cache_type():
    """The port's classification equals the JAX package's on each cache
    type both have: dense and paged KV caches are positional, the
    recurrent cache ingests padding. (The JAX package's RotatingKVCache,
    positional though it has no max_len, has no counterpart here.)"""
    jd = jdn.DeltaNetConfig(num_v_heads=2, num_k_heads=1, head_k_dim=8,
                            head_v_dim=8)
    td = tdn.DeltaNetConfig(num_v_heads=2, num_k_heads=1, head_k_dim=8,
                            head_v_dim=8)
    pairs = [
        (jcache.KVCache.init(1, 2, 16, 8, jnp.float32),
         tcache.KVCache.init(1, 2, 16, 8, torch.float32, device="cpu")),
        (jpaged.PagedKVCache.init(1, 2, 3, 8, 8, 2, jnp.float32),
         PagedKVCache.init(1, 2, 3, 8, 8, 2, torch.float32, device="cpu")),
        (jdn.RecurrentCache.init(1, jd, jnp.float32),
         tdn.RecurrentCache.init(1, td, torch.float32, device="cpu")),
    ]
    got = [tcache.ingests_padding(t) for _, t in pairs]
    assert got == [jcache.ingests_padding(j) for j, _ in pairs]
    assert got == [False, False, True]
    assert not jcache.ingests_padding(
        jcache.RotatingKVCache.init(1, 2, 8, 8, jnp.float32))


def test_recurrent_cache_rows_are_views_and_zero():
    td = tdn.DeltaNetConfig(num_v_heads=2, num_k_heads=1, head_k_dim=8,
                            head_v_dim=8, conv_kernel=3)
    c = tdn.RecurrentCache.init(3, td, torch.bfloat16, device="cpu")
    assert c.state.shape == (3, 2, 8, 8) and c.state.dtype == torch.float32
    assert c.conv.shape == (3, 2, td.conv_dim)
    assert c.conv.dtype == torch.bfloat16
    c.state.fill_(1.0)
    c.conv.fill_(1.0)
    c.rows(1).zero_()
    assert float(c.state[1].abs().sum()) == 0
    assert float(c.conv[1].abs().sum()) == 0
    assert bool((c.state[0] == 1).all()) and bool((c.state[2] == 1).all())


def test_random_layer_params_keep_the_decay_in_unit_interval():
    """init_layer_params: A and dt_bias keep exp(g) in (0, 1) for
    projection outputs a in [-4, 4], with heads that decay slower than
    0.99 a token at a = 0; the conv weight is HF's [C, 1, K]."""
    td = tdn.DeltaNetConfig(num_v_heads=4, num_k_heads=2, head_k_dim=8,
                            head_v_dim=8, conv_kernel=4)
    g = torch.Generator().manual_seed(0)
    lp = tdn.init_layer_params(td, 16, g, lambda o, i: torch.zeros(o, i),
                               device="cpu")
    assert lp["conv1d"]["w"].shape == (td.conv_dim, 1, 4)
    a = torch.linspace(-4, 4, 81)[:, None]
    decay = torch.exp(-torch.exp(lp["A_log"]) * torch.nn.functional.softplus(
        a + lp["dt_bias"]))
    assert bool(((decay > 0) & (decay < 1)).all())
    assert float(decay[40].max()) > 0.99
    assert lp["in_proj_qkvz"]["w"].shape == (2 * 16 + 2 * 32, 16)
    assert lp["in_proj_ba"]["w"].shape == (8, 16)
    assert lp["out_proj"]["w"].shape == (16, 32)


def test_k9_refuses_what_it_does_not_take():
    """The launch checks run before any library is touched: a float64
    input, or a head width the kernel is not built for, raises."""
    a = _rule_inputs(2, 1, seed=1)
    t = {n: torch.from_numpy(x.copy()) for n, x in a.items()}
    with pytest.raises(ValueError, match="K9 q"):
        gd._k9(t["q"].double(), t["k"], t["v"], t["g"], t["beta"],
               t["state"])
    with pytest.raises(ValueError, match="dk in"):
        gd._k9(t["q"][..., :6].contiguous(), t["k"][..., :6].contiguous(),
               t["v"], t["g"], t["beta"],
               t["state"][:, :, :6].contiguous())
