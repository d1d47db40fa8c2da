"""A Gated DeltaNet layer's decode mixer, ``ops.gated_delta.deltanet_decode``
(kernel k9_decode on the card), on the CPU:

- its plain version ``deltanet_decode_reference`` against the JAX
  package's ``deltanet.block`` at T = 1 over 8 chained steps from a
  carried state and conv window. The JAX block's input projections are
  selectors (in_proj_qkvz and in_proj_ba pick disjoint slices of x), so
  the plain version gets the block's qkvz and ba exactly; its output goes
  through the same random out_proj as the block's;
- the port's ``block`` at T = 1 on the CPU, bit for bit the unfused
  composition (the prologue's and the rule's plain versions, the cast,
  ``rms_norm``, ``* silu(z)``, out_proj), the cache written in place;
- the wrapper's refusals, raised by its argument checks before any
  library is touched, and the launch counts a layer's mixer takes.

Inputs are made with numpy from a seed and given to both packages (in a
bf16 case every input and parameter is a bf16 value). Tolerances: in
float32 test_torch_deltanet.py's ``block`` limit, 1e-5 of max |JAX| (the
sums in another order than XLA's). In bf16 the output and the state are
held to the JAX block run in float32 on the same values: within
BLOCK_TOL_BF16 (test_torch_deltanet.py's 2e-2) more than the JAX
package's own bf16 block strays from it. A direct bf16-to-bf16 limit of
2e-2 does not hold at these widths over 8 steps: the delta rule
subtracts S^T k from v, and at dk = 8 that difference amplifies each
path's bf16 roundings of q, k and v, so either bf16 block can stray from
the float32 one by more than 2e-2, and the two from each other. The
window is held bit for bit (both copy inputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ominix_mlx_tpu.models import deltanet as jdn
from ominix_mlx_tpu_torch.models import deltanet as tdn
from ominix_mlx_tpu_torch.nn.layers import linear
from ominix_mlx_tpu_torch.ops import _build
from ominix_mlx_tpu_torch.ops import gated_delta as gd
from ominix_mlx_tpu_torch.ops.quant_matmul import rms_norm

torch.set_num_threads(2)

BLOCK_TOL_F32 = 1e-5
BLOCK_TOL_BF16 = 2e-2
STEPS = 8


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _tree(lp, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in lp.items()}


def _setup(r, conv_layout, B, seed, Hk=2, d=8, K=4, dtype="float32"):
    """A layer's parameters (HF [C, 1, K] or MLX [C, K, 1] taps), a carried
    state and window, each a value of ``dtype``; the input projections
    are selectors, x is [qkvz | ba], and out_proj is random."""
    rng = np.random.default_rng(seed)
    _round = (lambda a: a) if dtype == "float32" else (
        lambda a: np.array(jnp.asarray(a).astype(jnp.bfloat16)
                             .astype(jnp.float32)))
    jcfg = jdn.DeltaNetConfig(num_v_heads=Hk * r, num_k_heads=Hk,
                              head_k_dim=d, head_v_dim=d, conv_kernel=K)
    Hv, C = Hk * r, jcfg.conv_dim
    nqkvz = 2 * jcfg.key_dim + 2 * jcfg.value_dim
    D = nqkvz + 2 * Hv
    eye = np.eye(D, dtype=np.float32)
    conv = (rng.standard_normal((C, 1, K) if conv_layout == "hf"
                                else (C, K, 1)) * 0.5).astype(np.float32)
    lp = {"in_proj_qkvz": {"w": eye[:nqkvz]},
          "in_proj_ba": {"w": eye[nqkvz:]},
          "conv1d": {"w": conv},
          "dt_bias": rng.standard_normal(Hv).astype(np.float32),
          "A_log": np.log(rng.uniform(1, 16, Hv)).astype(np.float32),
          "norm": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
          "out_proj": {"w": (rng.standard_normal((D, jcfg.value_dim))
                             * jcfg.value_dim ** -0.5).astype(np.float32)}}
    lp = _tree(lp, _round)
    state = rng.standard_normal((B, Hv, d, d)).astype(np.float32)
    window = _round(rng.standard_normal((B, K - 1, C)).astype(np.float32))
    return jcfg, lp, state, window, rng, nqkvz, _round


def _jax_steps(lp, jcfg, state, window, xs, dtype):
    """The JAX block over the steps ``xs`` from (state, window) in
    ``dtype``: the outputs [steps, B, 1, D], the states and the windows
    after each step, in float32."""
    jdt = getattr(jnp, dtype)
    jlp = _tree(lp, lambda a: jnp.asarray(a).astype(jdt))
    jc = jdn.RecurrentCache(state=jnp.asarray(state),
                            conv=jnp.asarray(window).astype(jdt))
    f = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    outs, states, windows = [], [], []
    for x in xs:
        jout, jc = jdn.block(jlp, jcfg, jnp.asarray(x).astype(jdt), jc)
        outs.append(f(jout))
        states.append(f(jc.state))
        windows.append(f(jc.conv))
    return np.stack(outs), np.stack(states), np.stack(windows)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("layout", ["hf", "mlx"])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_reference_matches_jax_block(dtype, r, layout, B):
    """deltanet_decode_reference against the JAX block at T = 1, 8 steps
    in a row from a carried state and window (each step reads what the
    last wrote in place): the output (through out_proj), the state and
    the window after each step."""
    jcfg, lp, state, window, rng, nqkvz, _round = _setup(
        r, layout, B, seed=100 * r + 10 * B + len(layout) + len(dtype),
        dtype=dtype)
    Hk, Hv, d, K = (jcfg.num_k_heads, jcfg.num_v_heads, jcfg.head_k_dim,
                    jcfg.conv_kernel)
    xs = [_round(rng.standard_normal((B, 1, nqkvz + 2 * Hv))
                 .astype(np.float32)) for _ in range(STEPS)]
    tdt = getattr(torch, dtype)
    t_state = torch.from_numpy(state.copy())
    t_window = torch.from_numpy(window.copy()).to(tdt)
    conv_w = torch.from_numpy(lp["conv1d"]["w"]).to(tdt).reshape(
        jcfg.conv_dim, K)
    args = (conv_w, torch.from_numpy(lp["A_log"]),
            torch.from_numpy(lp["dt_bias"]))
    norm_w = torch.from_numpy(lp["norm"]).to(tdt)
    out_proj = {"w": torch.from_numpy(lp["out_proj"]["w"]).to(tdt)}
    outs, states, windows = [], [], []
    for x in xs:
        tx = torch.from_numpy(x).to(tdt)
        out = gd.deltanet_decode_reference(
            tx[..., :nqkvz], tx[..., nqkvz:], t_window, *args, t_state,
            norm_w, jcfg.rms_norm_eps, (Hk, Hv, d, d))
        assert out.shape == (B, 1, Hv * d) and out.dtype == tdt
        outs.append(linear(out_proj, out).float().numpy())
        states.append(t_state.numpy().copy())
        windows.append(t_window.float().numpy().copy())
    got = (np.stack(outs), np.stack(states))
    want, want_state, want_window = _jax_steps(lp, jcfg, state, window, xs,
                                               dtype)
    np.testing.assert_array_equal(np.stack(windows), want_window)
    if dtype == "float32":
        assert _rel(got[0], want) < BLOCK_TOL_F32
        assert _rel(got[1], want_state) < BLOCK_TOL_F32
        return
    f32 = _jax_steps(lp, jcfg, state, window, xs, "float32")
    for i, name in enumerate(("output", "state")):
        own = _rel((want, want_state)[i], f32[i])
        assert _rel(got[i], f32[i]) < own + BLOCK_TOL_BF16, name


def _unfused(lp, dcfg, x, cache):
    """The layer at T = 1 as it was composed before the decode mixer: the
    prologue and the rule, then the glue, op by op."""
    heads = (dcfg.num_k_heads, dcfg.num_v_heads, dcfg.head_k_dim,
             dcfg.head_v_dim)
    qkvz = linear(lp["in_proj_qkvz"], x)
    ba = linear(lp["in_proj_ba"], x)
    conv_w = lp["conv1d"]["w"].reshape(dcfg.conv_dim, dcfg.conv_kernel)
    q, k, v, g, beta = gd.deltanet_prep_reference(
        qkvz, ba, cache.conv, conv_w.to(x.dtype), lp["A_log"].float(),
        lp["dt_bias"].float(), heads)
    z = gd.split_qkvz_ba(qkvz, ba, heads)[3]
    out = gd.gated_delta_rule_reference(q, k, v, g, beta, cache.state)
    out = rms_norm(lp["norm"], out.to(x.dtype), dcfg.rms_norm_eps)
    out = (out * F.silu(z)).reshape(x.shape[0], 1, -1)
    return linear(lp["out_proj"], out)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_at_one_token_is_the_unfused_composition(dtype, B):
    """models.deltanet.block at T = 1 on the CPU takes
    deltanet_decode_reference: bit for bit the unfused composition over 3
    chained steps, the state and the window written in place into the
    cache's buffers (also through a batched cache's row view), and no
    launch counted."""
    dcfg = tdn.DeltaNetConfig(num_v_heads=4, num_k_heads=2, head_k_dim=8,
                              head_v_dim=8)
    g = torch.Generator().manual_seed(B)

    def make(o, i):
        return (torch.randn(o, i, generator=g) * i ** -0.5).to(dtype)

    lp = tdn.init_layer_params(dcfg, 24, g, make, dtype=dtype, device="cpu")
    lp["norm"] = (1 + 0.1 * torch.randn(8, generator=g)).to(dtype)
    batched = tdn.RecurrentCache.init(B + 1, dcfg, dtype, device="cpu")
    batched.state.normal_(generator=g)
    batched.conv.copy_(torch.randn(batched.conv.shape, generator=g))
    c1 = tdn.RecurrentCache(state=batched.state[:B].clone(),
                            conv=batched.conv[:B].clone())
    c2 = batched.rows(0) if B == 1 else tdn.RecurrentCache(
        state=batched.state[:B], conv=batched.conv[:B])
    st, cv = c2.state, c2.conv
    _build.reset_launches()
    for _ in range(3):
        x = torch.randn(B, 1, 24, generator=g).to(dtype)
        with torch.inference_mode():
            want = _unfused(lp, dcfg, x, c1)
            got, new = tdn.block(lp, dcfg, x, c2)
        assert new.state is st and new.conv is cv
        assert torch.equal(got, want)
        assert torch.equal(c2.state, c1.state)
        assert torch.equal(c2.conv, c1.conv)
    assert torch.equal(batched.state[:B], c1.state)     # through the views
    assert torch.equal(batched.conv[:B], c1.conv)
    assert sum(_build.LAUNCHES.values()) == 0


def test_decode_on_cpu_is_the_plain_version():
    """deltanet_decode on CPU tensors is deltanet_decode_reference bit for
    bit, the window and the state too, and counts no launch."""
    jcfg, lp, state, window, rng, nqkvz, _ = _setup(2, "hf", 2, seed=5)
    heads = (jcfg.num_k_heads, jcfg.num_v_heads, 8, 8)
    x = torch.from_numpy(rng.standard_normal(
        (2, 1, nqkvz + 2 * jcfg.num_v_heads)).astype(np.float32)).bfloat16()
    conv_w = torch.from_numpy(lp["conv1d"]["w"]).bfloat16().reshape(
        jcfg.conv_dim, 4)
    w1 = torch.from_numpy(window).bfloat16()
    w2 = w1.clone()
    s1 = torch.from_numpy(state.copy())
    s2 = s1.clone()
    args = (conv_w, torch.from_numpy(lp["A_log"]),
            torch.from_numpy(lp["dt_bias"]))
    norm_w = torch.from_numpy(lp["norm"]).bfloat16()
    _build.reset_launches()
    got = gd.deltanet_decode(x[..., :nqkvz], x[..., nqkvz:], w1, *args, s1,
                             norm_w, 1e-6, heads)
    want = gd.deltanet_decode_reference(x[..., :nqkvz], x[..., nqkvz:], w2,
                                        *args, s2, norm_w, 1e-6, heads)
    assert torch.equal(got, want)
    assert torch.equal(w1, w2) and torch.equal(s1, s2)
    assert sum(_build.LAUNCHES.values()) == 0


def _decode_args(B=1, T=1, Hk=2, r=2, d=128, K=4, dtype=torch.bfloat16):
    """k9_decode's arguments as CPU tensors of the given shapes (zeros)."""
    Hv = Hk * r
    C = 2 * Hk * d + Hv * d
    return {"qkvz": torch.zeros(B, T, Hk * (2 * d + 2 * r * d), dtype=dtype),
            "ba": torch.zeros(B, T, 2 * Hv, dtype=dtype),
            "window": torch.zeros(B, K - 1, C, dtype=dtype),
            "conv_w": torch.zeros(C, K, dtype=dtype),
            "A_log": torch.zeros(Hv), "dt_bias": torch.zeros(Hv),
            "state": torch.zeros(B, Hv, d, d),
            "norm_w": torch.ones(d, dtype=dtype), "eps": 1e-6,
            "heads": (Hk, Hv, d, d)}


@pytest.mark.parametrize("change,match", [
    ({"d": 64}, "k9_decode takes T = 1, dk = dv"),
    ({"r": 8}, "k9_decode takes T = 1, dk = dv"),
    ({"K": 3}, "k9_decode takes T = 1, dk = dv"),
    ({"T": 2}, "k9_decode takes T = 1, dk = dv"),
    ({"dtype": torch.float16}, "bf16 or float32"),
    ({"state": "bf16"}, "k9_decode state"),
    ({"state": "strided"}, "k9_decode state"),
    ({"norm_w": "float32"}, "k9_decode norm_w"),
    ({"window": "short"}, "k9_decode window"),
    ({"ba": "float32"}, "k9_decode ba"),
    ({"qkvz": "long"}, "k9_decode qkvz"),
])
def test_k9_decode_refuses_what_it_does_not_take(change, match):
    """The launch checks run before any library is touched: a head width,
    a head ratio past a cluster of 16 CTAs, a conv length or a token count
    the kernel is not built for, a type it does not take, or an argument
    of another type, shape or layout (a copy would drop the in-place
    write) raises."""
    a = _decode_args(**{k: v for k, v in change.items()
                        if k in ("d", "r", "K", "T", "dtype")})
    if change.get("state") == "bf16":
        a["state"] = a["state"].bfloat16()
    if change.get("state") == "strided":
        a["state"] = torch.zeros(1, 4, 128, 256)[..., ::2]
    if change.get("norm_w") == "float32":
        a["norm_w"] = a["norm_w"].float()
    if change.get("window") == "short":
        a["window"] = a["window"][:, 1:]
    if change.get("ba") == "float32":
        a["ba"] = a["ba"].float()
    if change.get("qkvz") == "long":
        a["qkvz"] = torch.zeros(1, 1, a["qkvz"].shape[-1] + 8,
                                dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        gd._k9_decode(a["qkvz"], a["ba"], a["window"], a["conv_w"],
                      a["A_log"], a["dt_bias"], a["state"], a["norm_w"],
                      a["eps"], a["heads"])


@pytest.mark.parametrize("T,want", [
    (1, {"k9_decode": 1}),
    (5, {"k9_prep": 1, "k9": 1}),
    (47, {"k9_prep": 1, "k9": 1}),
    (48, {"k9_prep": 1, "k9_chunk": 1, "k9_chunk_scan": 1}),
])
def test_deltanet_launches(T, want):
    """A layer's mixer on the card: one k9_decode at a decode step, the
    prologue and the rule's planned form at prompts."""
    assert gd.deltanet_launches(1, T, 32, 128, 128) == want
