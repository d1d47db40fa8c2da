"""K9's chunked form and its prologue on the CPU: the plain versions
against the JAX package, and the plan that picks the form.

- ``chunk_gated_delta_rule_reference`` (the chunked form's formulas in
  float32 torch, chunks of 64) against the JAX scan of
  ominix_mlx_tpu/models/deltanet.py:block and against the token-by-token
  ``gated_delta_rule_reference``, from a carried state, at lengths on both
  sides of a chunk boundary and at decays down to -20 a token. Held at
  CHUNK_TOL = 2e-5 of max |JAX| (both float32, summed in another order;
  the cumulative decay G within a chunk loses about one ulp of |G|, which
  moves only terms that G has already made small).
- ``k9_plan``: the form each shape takes, from the shapes alone.
- ``deltanet_prep_reference`` (k9_prep's plain version) against the JAX
  block's own steps (its ``_split_qkvz_ba``, ``_causal_conv``,
  ``_l2norm`` and gate formulas), in bf16 and float32, the conv window
  carried across two calls: the window bit for bit; q, k, v, g, beta at
  PREP_TOL_F32 = 1e-5 in float32 and PREP_TOL_BF16 = 1e-2 in bf16 (the
  conv's sum and SiLU round to bf16 at points XLA may place otherwise:
  one bf16 ulp is 3.9e-3).
Inputs are made with numpy from a seed and given to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.models import deltanet as jdn
from ominix_mlx_tpu_torch.ops import _build
from ominix_mlx_tpu_torch.ops import gated_delta as gd

torch.set_num_threads(2)

CHUNK_TOL = 2e-5
PREP_TOL_F32 = 1e-5
PREP_TOL_BF16 = 1e-2


def _l2n(x):
    return x / np.sqrt((x * x).sum(-1, keepdims=True) + 1e-6)


def _rule_inputs(T, r, decay, seed, B=2, Hk=2, dk=8, dv=12):
    """l2-normed q (scaled) and k, v, g < 0 (down to -1.5 a token, or to
    -20 with "strong"), beta in (0, 1), and a carried state."""
    rng = np.random.default_rng(seed)
    Hv = Hk * r
    q = _l2n(rng.standard_normal((B, T, Hk, dk))).astype(np.float32)
    k = _l2n(rng.standard_normal((B, T, Hk, dk))).astype(np.float32)
    low = 20.0 if decay == "strong" else 1.5
    return {"q": q * np.float32(dk ** -0.5), "k": k,
            "v": rng.standard_normal((B, T, Hv, dv)).astype(np.float32),
            "g": -rng.uniform(0.01, low, (B, T, Hv)).astype(np.float32),
            "beta": rng.uniform(0.05, 0.95, (B, T, Hv)).astype(np.float32),
            "state": rng.standard_normal((B, Hv, dk, dv)).astype(np.float32)}


def _jax_scan(q, k, v, g, beta, state):
    """The JAX package's recurrence as deltanet.block runs it
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
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


def _torch(a):
    return {n: torch.from_numpy(x.copy()) for n, x in a.items()}


@pytest.mark.parametrize("decay", ["mild", "strong"])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 200])
def test_chunk_reference_matches_jax_scan(T, r, decay):
    """The chunked form's formulas equal the JAX recurrence and the plain
    token-by-token version: outputs and the final state (written in
    place), across chunk boundaries, from a carried state; finite at
    decays that take G to -1000 within a chunk (masked before the exp)."""
    a = _rule_inputs(T, r, decay, seed=T * 10 + r + (decay == "strong"))
    want_o, want_s = _jax_scan(**a)
    t = _torch(a)
    s_chunk, s_plain = t["state"].clone(), t["state"].clone()
    names = ("q", "k", "v", "g", "beta")
    o = gd.chunk_gated_delta_rule_reference(*(t[n] for n in names), s_chunk)
    o_plain = gd.gated_delta_rule_reference(*(t[n] for n in names), s_plain)
    assert o.dtype == torch.float32 and o.shape == a["v"].shape
    assert torch.isfinite(o).all() and torch.isfinite(s_chunk).all()
    assert _rel(o.numpy(), want_o) < CHUNK_TOL
    assert _rel(s_chunk.numpy(), want_s) < CHUNK_TOL
    assert _rel(o.numpy(), o_plain.numpy()) < CHUNK_TOL
    assert _rel(s_chunk.numpy(), s_plain.numpy()) < CHUNK_TOL


@pytest.mark.parametrize("T", [37, 100])
def test_chunk_padding_changes_nothing(T):
    """The kernel pads a short last chunk with q = k = v = 0, g = 0 and
    beta = 0 (G then stays at the last token's): the padded rows' outputs
    are dropped, and the real rows and the final state are those of the
    unpadded sequence."""
    a = _rule_inputs(T, 2, "mild", seed=T)
    t = _torch(a)
    pad = -(-T // gd.K9_CHUNK) * gd.K9_CHUNK - T
    names = ("q", "k", "v", "g", "beta")
    padded = {n: torch.cat([t[n], torch.zeros(t[n].shape[0], pad,
                                              *t[n].shape[2:])], 1)
              for n in names}
    s1, s2 = t["state"].clone(), t["state"].clone()
    o = gd.chunk_gated_delta_rule_reference(*(t[n] for n in names), s1)
    op = gd.chunk_gated_delta_rule_reference(*(padded[n] for n in names),
                                             s2)
    assert _rel(op[:, :T].numpy(), o.numpy()) < CHUNK_TOL
    assert _rel(s2.numpy(), s1.numpy()) < CHUNK_TOL


@pytest.mark.parametrize("B,T,Hv,dk,dv,want", [
    (1, 1, 32, 128, 128, "recurrent"),          # decode
    (8, 1, 32, 128, 128, "recurrent"),          # batched decode
    (1, gd.K9_CHUNK_MIN_T - 1, 32, 128, 128, "recurrent"),
    (1, gd.K9_CHUNK_MIN_T, 32, 128, 128, "chunked"),
    (1, 128, 32, 128, 128, "chunked"),
    (1, 2048, 32, 128, 128, "chunked"),
    (2, 1000, 16, 128, 128, "chunked"),
    (1, 2048, 32, 64, 64, "recurrent"),         # not built for 64
    (1, 2048, 32, 128, 96, "recurrent"),
    (64, 65536, 32, 128, 128, "recurrent"),     # scratch past the limit
])
def test_k9_plan(B, T, Hv, dk, dv, want):
    assert gd.k9_plan(B, T, Hv, dk, dv) == want
    got = gd.k9_launches(B, T, Hv, dk, dv)
    assert got == ({"k9_chunk": 1, "k9_chunk_scan": 1} if want == "chunked"
                   else {"k9": 1})


def test_k9_plan_scratch_limit_is_the_wrappers_allocation():
    """The plan's scratch reckoning is what _k9_chunked allocates: W, U0,
    P and G, (dk + dv + 64 + 1) floats a token slot, 80 KiB a chunk and
    value head at dk = dv = 128."""
    per_chunk = 4 * gd.K9_CHUNK * (128 + 128 + gd.K9_CHUNK + 1)
    assert per_chunk // 1024 == 80
    Hv = 32
    most = gd.K9_CHUNK_MAX_SCRATCH // (per_chunk * Hv)     # chunks a row
    assert gd.k9_plan(1, most * gd.K9_CHUNK, Hv, 128, 128) == "chunked"
    assert gd.k9_plan(1, most * gd.K9_CHUNK + 1, Hv, 128, 128) \
        == "recurrent"


def test_rule_on_cpu_takes_the_plain_version_at_every_length():
    """On the CPU, gated_delta_rule is the token-by-token plain version,
    bit for bit, whatever the plan would pick on the card, and counts no
    launch."""
    a = _rule_inputs(70, 2, "mild", seed=5, dk=128, dv=128, Hk=1, B=1)
    t = _torch(a)
    names = ("q", "k", "v", "g", "beta")
    assert gd.k9_plan(1, 70, 2, 128, 128) == "chunked"
    _build.reset_launches()
    s1, s2 = t["state"].clone(), t["state"].clone()
    o1 = gd.gated_delta_rule(*(t[n] for n in names), s1)
    o2 = gd.gated_delta_rule_reference(*(t[n] for n in names), s2)
    assert torch.equal(o1, o2) and torch.equal(s1, s2)
    assert sum(_build.LAUNCHES.values()) == 0


# ----------------------------------------------------------- the prologue

def _prep_setup(r, dtype, seed, Hk=2, dk=8, K=4, B=2):
    rng = np.random.default_rng(seed)
    jcfg = jdn.DeltaNetConfig(num_v_heads=Hk * r, num_k_heads=Hk,
                              head_k_dim=dk, head_v_dim=dk, conv_kernel=K)
    Hv, C = Hk * r, jcfg.conv_dim
    lp = {"conv1d": {"w": (rng.standard_normal((C, 1, K)) * 0.5
                           ).astype(np.float32)},
          "dt_bias": rng.standard_normal(Hv).astype(np.float32),
          "A_log": np.log(rng.uniform(1, 16, Hv)).astype(np.float32)}
    window = rng.standard_normal((B, K - 1, C)).astype(np.float32)
    return jcfg, lp, window, rng


def _jax_prep(lp, jcfg, qkvz, ba, window):
    """The JAX block's steps from the projections to the rule's inputs
    (ominix_mlx_tpu/models/deltanet.py:111-130), with its own helpers;
    q and k per key head (its jnp.repeat copies each head r times)."""
    B, T, _ = qkvz.shape
    q, k, v, _, b, a = jdn._split_qkvz_ba(qkvz, ba, jcfg)
    mixed = jnp.concatenate([q.reshape(B, T, -1), k.reshape(B, T, -1),
                             v.reshape(B, T, -1)], -1)
    mixed, new_window = jdn._causal_conv(lp, mixed, window, jcfg)
    kd = jcfg.key_dim
    q = mixed[..., :kd].reshape(B, T, jcfg.num_k_heads, jcfg.head_k_dim)
    k = mixed[..., kd:2 * kd].reshape(B, T, jcfg.num_k_heads,
                                      jcfg.head_k_dim)
    v = mixed[..., 2 * kd:].reshape(B, T, jcfg.num_v_heads, jcfg.head_v_dim)
    beta = jax.nn.sigmoid(b.astype(jnp.float32))
    g = (-jnp.exp(lp["A_log"].astype(jnp.float32))
         * jax.nn.softplus(a.astype(jnp.float32)
                           + lp["dt_bias"].astype(jnp.float32)))
    q = jdn._l2norm(q.astype(jnp.float32)) * jcfg.head_k_dim ** -0.5
    k = jdn._l2norm(k.astype(jnp.float32))
    return (q, k, v.astype(jnp.float32), g, beta), new_window


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [1, 7])
def test_prep_reference_matches_jax(dtype, T):
    """deltanet_prep_reference against the JAX block's steps, two calls in
    a row (the second reads the window the first wrote, in place), r = 2:
    the window bit for bit, q, k, v, g, beta within the stated limit."""
    jcfg, lp, window, rng = _prep_setup(2, dtype, seed=T * 3 + len(dtype))
    Hk, Hv, dk = jcfg.num_k_heads, jcfg.num_v_heads, jcfg.head_k_dim
    heads = (Hk, Hv, dk, dk)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jlp = {"conv1d": {"w": jnp.asarray(lp["conv1d"]["w"]).astype(jdt)},
           "A_log": jnp.asarray(lp["A_log"]),
           "dt_bias": jnp.asarray(lp["dt_bias"])}
    jwin = jnp.asarray(window).astype(jdt)
    twin = torch.from_numpy(window).to(tdt)
    conv_w = torch.from_numpy(lp["conv1d"]["w"]).to(tdt).reshape(
        jcfg.conv_dim, jcfg.conv_kernel)
    tol = PREP_TOL_F32 if dtype == "float32" else PREP_TOL_BF16
    for call in range(2):
        qkvz = rng.standard_normal(
            (2, T, Hk * (2 * dk + 2 * (Hv // Hk) * dk))).astype(np.float32)
        ba = rng.standard_normal((2, T, 2 * Hv)).astype(np.float32)
        want, jwin = _jax_prep(jlp, jcfg, jnp.asarray(qkvz).astype(jdt),
                               jnp.asarray(ba).astype(jdt), jwin)
        buf = twin
        got = gd.deltanet_prep_reference(
            torch.from_numpy(qkvz).to(tdt), torch.from_numpy(ba).to(tdt),
            twin, conv_w, torch.from_numpy(lp["A_log"]),
            torch.from_numpy(lp["dt_bias"]), heads)
        assert twin is buf and twin.dtype == tdt          # in place
        np.testing.assert_array_equal(
            twin.float().numpy(), np.asarray(jwin.astype(jnp.float32)))
        for name, x, w in zip(("q", "k", "v", "g", "beta"), got, want):
            assert x.dtype == torch.float32, name
            assert x.is_contiguous() or name not in ("g", "beta"), name
            assert _rel(x.numpy(), w) < tol, (call, name)


def test_prep_on_cpu_is_the_plain_version_and_counts_nothing():
    """k9_prep on CPU tensors is deltanet_prep_reference bit for bit (the
    window too) and no launch is counted."""
    jcfg, lp, window, rng = _prep_setup(2, "bfloat16", seed=11)
    Hk, Hv, dk = jcfg.num_k_heads, jcfg.num_v_heads, jcfg.head_k_dim
    heads = (Hk, Hv, dk, dk)
    qkvz = torch.from_numpy(rng.standard_normal(
        (2, 5, Hk * (2 * dk + 4 * dk))).astype(np.float32)).bfloat16()
    ba = torch.from_numpy(rng.standard_normal((2, 5, 2 * Hv)).astype(
        np.float32)).bfloat16()
    conv_w = torch.from_numpy(lp["conv1d"]["w"]).bfloat16().reshape(
        jcfg.conv_dim, 4)
    w1 = torch.from_numpy(window).bfloat16()
    w2 = w1.clone()
    args = (conv_w, torch.from_numpy(lp["A_log"]),
            torch.from_numpy(lp["dt_bias"]), heads)
    _build.reset_launches()
    got = gd.k9_prep(qkvz, ba, w1, *args)
    want = gd.deltanet_prep_reference(qkvz, ba, w2, *args)
    assert torch.equal(w1, w2)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    assert sum(_build.LAUNCHES.values()) == 0


def test_k9_prep_refuses_what_it_does_not_take():
    """The launch checks run before any library is touched: a head width
    the kernel is not built for, a conv of another length, or a float64
    input raises."""
    def call(dk, K, dtype=torch.bfloat16):
        Hk, Hv = 2, 4
        C = 2 * Hk * dk + Hv * dk
        return gd._k9_prep(
            torch.zeros(1, 3, Hk * (2 * dk + 4 * dk), dtype=dtype),
            torch.zeros(1, 3, 2 * Hv, dtype=dtype),
            torch.zeros(1, K - 1, C, dtype=dtype),
            torch.zeros(C, K, dtype=dtype), torch.zeros(Hv),
            torch.zeros(Hv), (Hk, Hv, dk, dk))

    with pytest.raises(ValueError, match="k9_prep takes dk"):
        call(8, 4)
    with pytest.raises(ValueError, match="k9_prep takes dk"):
        call(64, 3)
    with pytest.raises(ValueError, match="bf16 or float32"):
        call(128, 4, torch.float64)
