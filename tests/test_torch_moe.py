"""Port parity for the mixture-of-experts path: routing, the expert
gather-qmm (kernel K4's plain version), the grouped matmul (kernel K5's
plain version), the sorted dispatch, each ported ``moe_block`` branch and
a 2-layer Qwen3-MoE, against ominix_mlx_tpu on the CPU with the same
seeded numpy inputs. K4 and K5 themselves are checked on a CUDA card by
tests/test_torch_kernels_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.core.generate import Engine as JEngine
from ominix_mlx_tpu.core.quant import QuantizedTensor as JQuantizedTensor
from ominix_mlx_tpu.core.sampling import SamplerConfig as JSampler
from ominix_mlx_tpu.models import base as jbase
from ominix_mlx_tpu.models import moe as jmoe
from ominix_mlx_tpu.models import qwen3_moe as jqwen3_moe
from ominix_mlx_tpu.nn.layers import ACTIVATIONS as JACT
from ominix_mlx_tpu.ops import quant_matmul as jqm
from ominix_mlx_tpu_torch.core import cache as tcache
from ominix_mlx_tpu_torch.core import paged_cache as tpc
from ominix_mlx_tpu_torch.core.generate import Engine as TEngine
from ominix_mlx_tpu_torch.core.sampling import SamplerConfig as TSampler
from ominix_mlx_tpu_torch.models import base as tbase
from ominix_mlx_tpu_torch.models import moe as tmoe
from ominix_mlx_tpu_torch.models import qwen3_moe as tqwen3_moe
from ominix_mlx_tpu_torch.ops import _build
from ominix_mlx_tpu_torch.ops import grouped_matmul as tgmm
from ominix_mlx_tpu_torch.ops import quant_matmul as tqm
from ominix_mlx_tpu_torch.utils.params import params_from_numpy
from torch.utils._pytree import tree_leaves

torch.set_num_threads(2)
# the router's float32 matmul must stay full float32 (no TF32 on a card)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HF = {"model_type": "qwen3_moe", "vocab_size": 512, "hidden_size": 64,
      "num_hidden_layers": 2, "num_attention_heads": 4,
      "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
      "moe_intermediate_size": 32, "num_experts": 8,
      "num_experts_per_tok": 2, "norm_topk_prob": True, "rope_theta": 1e6,
      "rms_norm_eps": 1e-6, "tie_word_embeddings": False}
JCFG = jqwen3_moe.config_from_hf(HF)
TCFG = tqwen3_moe.config_from_hf(HF)
GS = 32     # the group size of the quantized model: I = 32


def _rel(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))


def _to_numpy(tree):
    """JAX param tree -> numpy tree with quantized weights in canonical
    form; the JAX package's stacked experts (K-half nibble split, unfolded
    biases) become a dict with a 3-D ``q``."""
    if isinstance(tree, jqm.PackedQuantizedExperts):
        b = np.asarray(tree.data).view(np.uint8).astype(np.int16)
        q = np.concatenate([(b & 15) - 8, (b >> 4) - 8], -1).astype(np.int8)
        G = tree.in_features // tree.group_size
        return {"q": q, "scales": np.asarray(tree.scales)[..., :G],
                "biases": np.asarray(tree.biases)[..., :G],
                "group_size": tree.group_size, "bits": tree.bits}
    if isinstance(tree, jqm.PackedQuantizedTensor):
        u = jqm.unpack(tree)
        return {"q": np.array(u.q), "scales": np.asarray(u.scales),
                "biases": np.asarray(u.biases),
                "group_size": u.group_size, "bits": u.bits}
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return np.asarray(tree)


def _exact_fold_experts(rng, E, N, K, gs):
    """Canonical 4-bit experts whose scales and biases have few mantissa
    bits, so that the fold b - 8s the port stores is exact in bf16 and
    both packages dequantize to the same float32 values: s = m/1024 with
    m in [1, 15], b - 8s = m'/1024 with m' in [-64, 64]."""
    G = K // gs
    q = rng.integers(-8, 8, (E, N, K)).astype(np.int8)
    s = rng.integers(1, 16, (E, N, G)).astype(np.float32) / 1024
    bf = rng.integers(-64, 65, (E, N, G)).astype(np.float32) / 1024
    return {"q": q, "scales": s, "biases": bf + 8 * s, "group_size": gs,
            "bits": 4}


def _jax_experts(c):
    """The JAX package's PackedQuantizedExperts from a canonical dict."""
    return jqm.experts_from_quantized([
        JQuantizedTensor(q=jnp.asarray(c["q"][e]),
                         scales=jnp.asarray(c["scales"][e], jnp.bfloat16),
                         biases=jnp.asarray(c["biases"][e], jnp.bfloat16),
                         group_size=c["group_size"], bits=4)
        for e in range(c["q"].shape[0])])


# ------------------------------------------------------------- routing ------

ROUTES = {
    "qwen_softmax_topk": dict(norm_topk_prob=True),
    "qwen_no_norm_scaled": dict(routed_scaling_factor=2.5),
    "mixtral_topk_softmax": dict(softmax_after_topk=True),
    "glm4_sigmoid_bias": dict(routing="sigmoid", norm_topk_prob=True,
                              routed_scaling_factor=1.8),
    "glm4_sigmoid_grouped": dict(routing="sigmoid", norm_topk_prob=True,
                                 n_group=4, topk_group=2,
                                 routed_scaling_factor=2.5),
}


@pytest.mark.parametrize("style", list(ROUTES))
def test_route_matches_jax(style):
    """All three routing styles, group-limited top-k included: the same
    expert indices and weights within rel 1e-6 (float32 scores)."""
    E, k, T, D = 16, 4, 24, 32
    mcfg = dict(num_experts=E, top_k=k, moe_intermediate_size=8,
                **ROUTES[style])
    rng = np.random.default_rng(len(style))
    x = rng.standard_normal((T, D)).astype(np.float32)
    lp = {"gate": {"w": (rng.standard_normal((E, D)) * 0.3).astype(
        np.float32)}}
    if mcfg.get("routing") == "sigmoid":
        lp["e_score_correction_bias"] = (rng.standard_normal(E) * 0.1
                                         ).astype(np.float32)
    jw, ji = jmoe.route(jax.tree.map(jnp.asarray, lp), jmoe.MoEConfig(**mcfg),
                        jnp.asarray(x))
    tw, ti = tmoe.route(params_from_numpy(lp, "cpu"), tmoe.MoEConfig(**mcfg),
                        torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tw.dtype == torch.float32
    assert _rel(tw.numpy(), jw) < 1e-6


# ------------------------------------------------- gather_qmm (K4 plain) ----

def test_gather_qmm_exact_matches_jax_fallback():
    """act_bits=None against the JAX package's CPU fallback of gather_qmm
    (float32 dequant of the gathered rows): rel < 1e-5 in float32, on
    experts whose stored fold is exact."""
    rng = np.random.default_rng(0)
    c = _exact_fold_experts(rng, 6, 48, 128, 32)
    x = rng.standard_normal((3, 128)).astype(np.float32)
    ids = np.array([[5, 0], [2, 2], [0, 5]], np.int32)
    want = jqm.gather_qmm(jnp.asarray(x), _jax_experts(c), jnp.asarray(ids))
    tw = params_from_numpy(c, "cpu", act_bits=None)
    assert isinstance(tw, tqm.PackedQuantizedExperts)
    got = tqm.gather_qmm(torch.from_numpy(x), tw, torch.from_numpy(ids))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 2, 48)
    assert _rel(got.numpy(), want) < 1e-5


def _tpu_gq_a8(x, ids, jw):
    """numpy transcription of the TPU decode kernel (_gather_qmm_decode and
    _gq_kernel, ops/quant_matmul.py:1606-1718) for each row of x, reading
    the JAX layout directly: K-half nibble split, biases folded in bf16
    inside the kernel."""
    f32 = np.float32
    bf = lambda a: np.asarray(a, f32).astype(jnp.bfloat16).astype(f32)
    data = np.asarray(jw.data).view(np.uint8)          # [E, N, K/2]
    u = np.concatenate([data & 15, data >> 4], -1).astype(f32)
    s = np.asarray(jw.scales, f32)
    b = bf(np.asarray(jw.biases, f32) - 8 * s)
    E, N, K = u.shape
    gs = jw.group_size
    G = K // gs
    out = np.zeros((x.shape[0], ids.shape[1], N), f32)
    for t in range(x.shape[0]):
        xf = x[t].astype(f32)
        xg = bf(xf.reshape(G, gs).sum(1))
        sx = f32(np.abs(xf).max() / f32(127.0) + f32(1e-12))
        cx = np.round(xf / sx)
        for j, e in enumerate(ids[t]):
            P = (u[e].reshape(N, G, gs) * cx.reshape(G, gs)).sum(-1)
            out[t, j] = sx * (s[e] * P).sum(-1) + b[e] @ xg
    return bf(out)


def test_gather_qmm_a8_reference_is_the_tpu_formula():
    """act_bits=8 computes what the TPU kernel computes (not merely
    something close): rel < 1e-3 per row against a numpy transcription of
    _gq_kernel, on experts quantized by the JAX package."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((6, 64, 256)).astype(np.float32) * 0.05
    jw = jqm.quantize_experts(jnp.asarray(w), 64, 4)
    x = np.asarray(rng.standard_normal((4, 256)), np.float32)
    x = x.astype(jnp.bfloat16).astype(np.float32)
    ids = np.array([[5, 1, 3], [0, 0, 5], [2, 4, 1], [3, 5, 0]], np.int32)
    want = _tpu_gq_a8(x, ids, jw)
    tw = params_from_numpy(_to_numpy(jw), "cpu", act_bits=8)
    got = tqm.gather_qmm_reference(torch.from_numpy(x).bfloat16(), tw,
                                   torch.from_numpy(ids), act_bits=8)
    assert got.dtype == torch.bfloat16
    for t in range(4):
        assert _rel(got[t].float().numpy(), want[t]) < 1e-3


@pytest.mark.parametrize("act_bits", [None, 8])
def test_gather_qmm_gate_up_cpu_is_two_plain_calls(act_bits):
    """gather_qmm_gate_up, the one launch for a MoE layer's gate and up
    projections on the card, is on the CPU gather_qmm of each stack (the
    plain version), with no launch; and it equals the JAX package as the
    single calls do: the exact mode its CPU gather_qmm (rel < 1e-5 in
    float32), the a8 mode the numpy transcription of _gq_kernel (per row
    < 1e-3), on experts of the shape the TPU kernel takes (route "k4")."""
    rng = np.random.default_rng(31)
    E, N, K = 6, 128, 256
    ids = np.array([[5, 1, 3], [0, 0, 5], [2, 4, 1]], np.int32)
    x = rng.standard_normal((3, K)).astype(np.float32)
    if act_bits is None:
        cs = [_exact_fold_experts(rng, E, N, K, 32) for _ in range(2)]
        wants = [jqm.gather_qmm(jnp.asarray(x), _jax_experts(c),
                                jnp.asarray(ids)) for c in cs]
        tws = [params_from_numpy(c, "cpu", act_bits=None) for c in cs]
        xt = torch.from_numpy(x)
    else:
        x = x.astype(jnp.bfloat16).astype(np.float32)
        jws = [jqm.quantize_experts(jnp.asarray(
            rng.standard_normal((E, N, K)).astype(np.float32) * 0.05), 64, 4)
            for _ in range(2)]
        wants = [_tpu_gq_a8(x, ids, jw) for jw in jws]
        tws = [params_from_numpy(_to_numpy(jw), "cpu", act_bits=8)
               for jw in jws]
        assert tqm.expert_route(tws[0], 3) == "k4"
        xt = torch.from_numpy(x).bfloat16()
    tids = torch.from_numpy(ids)
    _build.reset_launches()
    got = tqm.gather_qmm_gate_up(xt, tws[0], tws[1], tids)
    assert sum(_build.LAUNCHES.values()) == 0
    for g, tw, want in zip(got, tws, wants):
        assert torch.equal(g, tqm.gather_qmm(xt, tw, tids))
        if act_bits is None:
            assert _rel(g.numpy(), want) < 1e-5
        else:
            for t in range(3):
                assert _rel(g[t].float().numpy(), want[t]) < 1e-3


def test_quantize_experts_matches_jax():
    """The port's expert quantizer gives the JAX package's codes and bf16
    scales exactly, and biases within the bf16 rounding of the stored fold
    b - 8s; dequantize_expert agrees with the JAX package's to one bf16
    rounding."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((4, 32, 128)).astype(np.float32) * 0.05
    jc = _to_numpy(jqm.quantize_experts(jnp.asarray(w), 64, 4))
    tw = tqm.quantize_experts(torch.from_numpy(w), 64, 4)
    assert tuple(tw.data.shape) == (4, 32, 64) and tw.shape == (4, 32, 128)
    for e in range(4):
        u = tqm.unpack(tqm.PackedQuantizedTensor(
            tw.data[e], tw.scales[e], tw.biases[e], 64, 4, 128))
        np.testing.assert_array_equal(u.q.numpy(), jc["q"][e])
        s = np.asarray(jc["scales"][e], np.float32)
        np.testing.assert_array_equal(u.scales.float().numpy(), s)
        b = np.asarray(jc["biases"][e], np.float32)
        assert np.all(np.abs(u.biases.float().numpy() - b)
                      <= 2.0 ** -8 * (np.abs(b) + 8 * s))
        jd = np.asarray(jqm.dequantize_expert(
            jqm.quantize_experts(jnp.asarray(w), 64, 4), e), np.float32)
        assert _rel(tqm.dequantize_expert(tw, e).float().numpy(), jd) < 1e-2
    np.testing.assert_array_equal(
        tqm.dequantize_experts(tw)[2].float().numpy(),
        tqm.dequantize_expert(tw, 2).float().numpy())


def test_experts_from_quantized_equals_the_stacked_bridge():
    """Per-expert QuantizedTensors stacked by experts_from_quantized pack to
    the same bytes as the weights bridge's stacked [E, N, K] dict."""
    c = _exact_fold_experts(np.random.default_rng(3), 5, 16, 64, 32)
    got = tqm.experts_from_quantized([
        tqm.QuantizedTensor(q=torch.from_numpy(c["q"][e]),
                            scales=torch.from_numpy(c["scales"][e]).bfloat16(),
                            biases=torch.from_numpy(c["biases"][e]).bfloat16(),
                            group_size=32, bits=4)
        for e in range(5)])
    want = params_from_numpy(c, "cpu")
    assert got.shape == want.shape == (5, 16, 64)
    for name in ("data", "scales", "biases"):
        assert torch.equal(getattr(got, name), getattr(want, name))


def test_experts_raise_where_not_ported():
    """What has no port still raises rather than take another path: 3-bit
    experts (quantize_experts, quantize_experts_params and the packed
    init), an unknown scheme, and an unknown expert type in moe_block.
    8-bit and channel-int8 experts are ported (tests/test_torch_moe8.py)."""
    w = torch.zeros(2, 8, 64)
    with pytest.raises(NotImplementedError):
        tqm.quantize_experts(w, 64, bits=3)
    lp = {"gate": {"w": torch.zeros(2, 64)},
          "experts": {n: w for n in tmoe.EXPERT_NAMES}}
    with pytest.raises(NotImplementedError):
        tmoe.quantize_experts_params(lp, 64, bits=3)
    mcfg = tmoe.MoEConfig(num_experts=2, top_k=1, moe_intermediate_size=64)
    with pytest.raises(NotImplementedError):
        tmoe.init_quantized_moe_params(torch.Generator(), 64, mcfg, bits=3,
                                       device="cpu")
    with pytest.raises(ValueError):
        tmoe.quantize_experts_params(lp, scheme="channel4")
    assert isinstance(tmoe.quantize_experts_params(lp, scheme="channel8")[
        "experts"]["up_proj"], tqm.ChannelQuantizedExperts)
    lp["experts"]["gate_proj"] = object()
    with pytest.raises(NotImplementedError):
        tmoe.moe_block(lp, mcfg, torch.zeros(1, 1, 64))


# ------------------------------------------------ grouped matmul (K5 plain) -

@pytest.mark.parametrize("gs", [(0, 7, 0, 1, 20, 0), (28, 0, 0, 0, 0, 0),
                                (0, 0, 0, 0, 0, 28), (4, 5, 6, 3, 5, 5)])
def test_grouped_matmul_reference_matches_ragged_dot(gs):
    """One float32 matmul per group against jax.lax.ragged_dot (the JAX
    package's grouped matmul off the TPU), empty groups included:
    rel < 1e-5."""
    rng = np.random.default_rng(sum(gs) + len(gs))
    S, K, N = 28, 48, 40
    xs = rng.standard_normal((S, K)).astype(np.float32)
    w = rng.standard_normal((len(gs), N, K)).astype(np.float32)
    g = np.asarray(gs, np.int32)
    want = jax.lax.ragged_dot(jnp.asarray(xs), jnp.swapaxes(w, 1, 2),
                              jnp.asarray(g),
                              preferred_element_type=jnp.float32)
    got = tgmm.grouped_matmul(torch.from_numpy(xs), torch.from_numpy(w),
                              torch.from_numpy(g))
    assert got.dtype == torch.float32 and tuple(got.shape) == (S, N)
    assert _rel(got.numpy(), want) < 1e-5


def test_grouped_matmul_rows_past_the_groups_are_zero():
    xs = torch.ones(10, 16)
    out = tgmm.grouped_matmul_reference(xs, torch.ones(2, 4, 16),
                                        torch.tensor([3, 4]))
    assert torch.equal(out[7:], torch.zeros(3, 4))
    assert torch.equal(out[:7], torch.full((7, 4), 16.0))


def _packed_experts(E, N, K, bits, seed, gs=32):
    """Random packed experts with non-zero biases (scales and biases from
    a seeded numpy generator)."""
    rng = np.random.default_rng(seed)
    G = K // gs
    if bits == 4:
        data = torch.from_numpy(rng.integers(0, 256, (E, N, K // 2),
                                             dtype=np.uint8))
    else:
        data = torch.from_numpy(rng.integers(-128, 128, (E, N, K),
                                             dtype=np.int8))
    lim = 1 << (bits - 1)
    s = (rng.random((E, N, G)) + 0.5) * K ** -0.5 / lim
    b = rng.standard_normal((E, N, G)) * K ** -0.5 / 4
    return tqm.PackedQuantizedExperts(
        data=data, scales=torch.from_numpy(s).float().bfloat16(),
        biases=torch.from_numpy(b).float().bfloat16(), group_size=gs,
        bits=bits, in_features=K, act_bits=8)


def _skewed_counts(E, S, seed):
    """Group sizes summing to S: empty groups, a one-row group and one of
    S / 2, the rest at random."""
    rng = np.random.default_rng(seed)
    gs = np.zeros(E, np.int64)
    gs[E // 3] = S // 2
    gs[1] = 1
    free = [e for e in range(E) if e not in (1, E // 3) and e % 4]
    for e in rng.choice(free, S - int(gs.sum())):
        gs[e] += 1
    return torch.from_numpy(gs)


@pytest.mark.parametrize("S,N,K", [(37, 48, 64), (200, 40, 96)])
def test_grouped_matmul_packed_4bit_equals_dequantized(S, N, K):
    """4-bit packed experts through grouped_matmul (the plain version on
    the CPU: each expert that has rows dequantized alone) give the bf16
    form on dequantize_experts(w) bit for bit, empty groups and a one-row
    group included; rows past sum(gs) are zero."""
    E = 8
    w = _packed_experts(E, N, K, 4, seed=S)
    gs = _skewed_counts(E, S - 3, seed=S)
    xs = torch.from_numpy(np.random.default_rng(S).standard_normal(
        (S, K)).astype(np.float32)).bfloat16()
    _build.reset_launches()
    got = tgmm.grouped_matmul(xs, w, gs)
    want = tgmm.grouped_matmul_reference(xs, tqm.dequantize_experts(w), gs)
    assert got.dtype == torch.float32 and tuple(got.shape) == (S, N)
    assert torch.equal(got, want)
    assert torch.equal(got[S - 3:], torch.zeros(3, N))
    assert sum(_build.LAUNCHES.values()) == 0


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_prefill_same_bits_as_dequantize_once(bits):
    """The quantized moe_block prefill (M > 8) sends packed experts to the
    grouped matmul; on the CPU its output equals, bit for bit, the
    dequantize-once pipeline it replaces (every expert to bf16, then the
    sorted dispatch on the bf16 stack)."""
    mcfg = tmoe.MoEConfig(num_experts=8, top_k=2, norm_topk_prob=True,
                          moe_intermediate_size=64)
    lp = tmoe.init_quantized_moe_params(torch.Generator().manual_seed(bits),
                                        64, mcfg, group_size=32,
                                        device="cpu", bits=bits)
    ex = lp["experts"]
    for n in tmoe.EXPERT_NAMES:      # non-zero biases: the fold matters
        ex[n].biases = (ex[n].scales.float()
                        * torch.linspace(-9, 3, ex[n].scales.numel())
                        .reshape(ex[n].scales.shape)).bfloat16()
    x = torch.from_numpy(np.random.default_rng(bits).standard_normal(
        (1, 24, 64)).astype(np.float32)).bfloat16()
    got = tmoe.moe_block(lp, mcfg, x)
    xt = x.reshape(24, 64)
    w, idx = tmoe.route(lp, mcfg, xt)
    deq = {n: tqm.dequantize_experts(ex[n]) for n in tmoe.EXPERT_NAMES}
    want = tmoe.sorted_expert_mlp(xt, deq, w, idx, 8,
                                  torch.nn.functional.silu).to(x.dtype)
    assert torch.equal(got, want.reshape(1, 24, 64))


def _k5_tiles(gs: list) -> list:
    """What K5's device-side tile map gives (a model of ``gmm_tile_map``
    and the kernel's tile lookup): (group, first row, rows, width) of each
    row tile, in launch order. Group e takes ceil(gs[e] / 128) tiles; a
    tile's width is the least of K5_WIDTHS that holds its rows."""
    tiles, row = [], 0
    for e, n in enumerate(gs):
        n = max(int(n), 0)
        for r0 in range(row, row + n, tgmm.K5_TILE):
            rows = min(tgmm.K5_TILE, row + n - r0)
            tiles.append((e, r0, rows,
                          next(w for w in tgmm.K5_WIDTHS if rows <= w)))
        row += n
    return tiles



# Qwen3-30B-A3B's expert projections (gate/up, down) and chip_smoke's
# K5_SHAPES, at the row counts of a 9-token to a 2048-token prefill (k = 8)
QWEN3_MOE_PROJ = ((768, 2048), (2048, 768))


@pytest.mark.parametrize("S", [72, 128, 1000, 1024, 8192, 16384])
def test_k5_plan_fits_and_tiles_cover_every_row_once(S):
    """K5's host plan fits shared memory (227 KB less the barriers) for
    every form at Qwen3-30B-A3B's projections with at least 4 slots in
    each ring, and the model of its tile
    map covers every row of every group exactly once, each tile inside
    its group at a width that holds its rows, within the launch's
    ceil(S / 128) + E + 1 row tiles."""
    E = 128
    for N, K in QWEN3_MOE_PROJ:
        for bits, gs in ((16, 0), (4, 64), (8, 64), (4, 32), (8, 128)):
            plan = tgmm.k5_plan(K, bits, gs)
            assert 4 <= plan.x_slots <= tgmm.K5_MAX_SLOTS
            assert 4 <= plan.w_slots <= tgmm.K5_MAX_SLOTS
            assert plan.smem <= tgmm.K5_SMEM_MAX < 232448
    counts = _skewed_counts(E, S, seed=S).tolist()
    tiles = _k5_tiles(counts)
    starts = np.concatenate([[0], np.cumsum(counts)])
    seen = np.zeros(S, np.int64)
    for e, r0, rows, width in tiles:
        assert starts[e] <= r0 and r0 + rows <= starts[e + 1]
        assert 1 <= rows <= width <= 128 and width in tgmm.K5_WIDTHS
        assert width == 8 or rows > tgmm.K5_WIDTHS[
            tgmm.K5_WIDTHS.index(width) - 1]
        seen[r0:r0 + rows] += 1
    assert (seen == 1).all()
    assert len(tiles) <= -(-S // 128) + E + 1
    assert len(tiles) == sum(-(-c // 128) for c in counts)


# the expert projections' K of Mixtral-8x7B (4096, 14336), GLM-4.5-Air
# (4096, 1408) and DeepSeek-V2-Lite (2048, 1408)
MOE_FAMILY_K = (1408, 2048, 4096, 14336)


@pytest.mark.parametrize("K", MOE_FAMILY_K)
def test_k5_plan_streams_the_scales_where_they_do_not_fit(K):
    """Every packed form at group sizes 32, 64 and 128 has a plan within
    shared memory. Where the two buffers of 128 rows' scales and biases
    (8 * 128 * K/gs bytes) leave room for two slots of each ring, the
    plan stages them as before (the same depths as the former rule);
    otherwise (Mixtral's down projection, K = 14336: 224 groups at gs 64)
    it streams them and the rings take all of shared memory."""
    for bits in (4, 8):
        for gs in (32, 64, 128):
            plan = tgmm.k5_plan(K, bits, gs)
            side = 8 * tgmm.K5_TILE * (K // gs)
            slots = (tgmm.K5_SMEM_MAX - 1024 - side) // tgmm.K5_SLOT
            assert plan.stream == (slots < 4)
            assert plan.smem <= tgmm.K5_SMEM_MAX
            assert 2 <= plan.w_slots <= plan.x_slots <= tgmm.K5_MAX_SLOTS
            if not plan.stream:
                w = min(tgmm.K5_MAX_SLOTS, slots // 2)
                assert (plan.w_slots, plan.x_slots) == (
                    w, min(tgmm.K5_MAX_SLOTS, slots - w))
                assert plan.smem == 1024 + (plan.x_slots
                                            + plan.w_slots) * 16384 + side
    assert tgmm.k5_plan(14336, 4, 64).stream
    assert tgmm.k5_plan(14336, 8, 128).stream is False
    assert not tgmm.k5_plan(4096, 4, 32).stream


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm (default mode) on Python ints."""
    b = [(x >> (8 * i)) & 255 for i in range(4)] + \
        [(y >> (8 * i)) & 255 for i in range(4)]
    return sum(b[(sel >> (4 * k)) & 7] << (8 * k) for k in range(4))


def _f32(bits):
    return float(np.array([bits], np.uint32).view(np.float32)[0])


@pytest.mark.parametrize("bits", [4, 8])
def test_k5_a_fragment_index_math(bits):
    """A numpy model of how a K5 lane builds its A fragment from a weight
    slot (csrc/grouped_mm.cu consume): the slot as TMA writes it (128
    rows of 128 bytes, 16-byte chunk q of row r at chunk q ^ (r & 7)),
    the lane's swizzled reads, byte gathers, the 2^23 mantissa placement
    and the offset taken off. For every warpgroup, warp, lane, step of the
    slot, k16 slice and register, the two codes it yields are those of
    wgmma's A layout (rows r and r + 8, columns 16s + 2t, + 1 and
    16s + 8 + 2t, + 1 of the step), in natural K order. And fma(c, s, b)
    with the exact product is the plain version's f32(c * s) + b."""
    rng = np.random.default_rng(bits)
    cols = 256 if bits == 4 else 128               # columns a slot holds
    if bits == 4:
        codes = rng.integers(0, 16, (128, cols))
        raw = (codes[:, 0::2] | (codes[:, 1::2] << 4)).astype(np.uint8)
    else:
        codes = rng.integers(-128, 128, (128, cols))
        raw = codes.astype(np.int8).view(np.uint8)
    slot = np.zeros(128 * 128, np.int64)
    for row in range(128):
        for q in range(8):
            dst = row * 128 + ((q ^ (row & 7)) << 4)
            slot[dst:dst + 16] = raw[row, 16 * q:16 * q + 16]

    def word(addr):                     # ld.shared.u32 at a byte address
        return int(slot[addr] | slot[addr + 1] << 8 | slot[addr + 2] << 16
                   | slot[addr + 3] << 24)

    def chunk(row, q):                  # swz_chunk
        return row * 128 + ((q ^ (row & 7)) << 4)

    for c in range(2):
        for warp in range(4):
            for lane in range(32):
                g8, tq = lane >> 2, lane & 3
                r = c * 64 + warp * 16 + g8
                for sub in range(cols // 64):
                    for s in range(4):
                        got = []
                        for reg in range(4):
                            h, hi8 = reg & 1, reg >> 1
                            row = r + 8 * h
                            if bits == 4:
                                w = [word(chunk(row, 2 * sub + k // 4)
                                          + 4 * (k % 4)) for k in range(8)]
                                sel = tq | (tq + 4) << 4
                                wv = [_byte_perm(
                                    _byte_perm(w[4 * i], w[4 * i + 1], sel),
                                    _byte_perm(w[4 * i + 2], w[4 * i + 3],
                                               sel), 0x5410)
                                    for i in range(2)]
                                W = wv[s >> 1]
                                i = 2 * (s & 1) + hi8
                                pair = [_byte_perm(W & 0x0F0F0F0F,
                                                   0x4B000000, 0x7650 | i),
                                        _byte_perm((W >> 4) & 0x0F0F0F0F,
                                                   0x4B000000, 0x7650 | i)]
                                off = 8388608.0
                            else:
                                X = word(chunk(row, 4 * sub + s)
                                         + 4 * (tq >> 1) + 8 * hi8)
                                X ^= 0x80808080
                                i = 2 * (tq & 1)
                                pair = [_byte_perm(X, 0x4B000000, 0x7650 | i),
                                        _byte_perm(X, 0x4B000000,
                                                   0x7650 | (i + 1))]
                                off = 8388736.0
                            got.append([_f32(p) - off for p in pair])
                        col = 64 * sub + 16 * s + 2 * tq
                        want = [[codes[r + 8 * h, col + 8 * hi8 + d]
                                 for d in range(2)]
                                for hi8 in range(2) for h in range(2)]
                        assert got == want, (c, warp, lane, sub, s)
    cs = codes.astype(np.float32).ravel()
    sv = rng.random(cs.size).astype(np.float32) * 0.01
    sv = torch.from_numpy(sv).bfloat16().float().numpy()
    bv = torch.from_numpy(rng.standard_normal(cs.size).astype(np.float32)
                          * 0.01).bfloat16().float().numpy()
    fma = (cs.astype(np.float64) * sv + bv).astype(np.float32)
    np.testing.assert_array_equal(fma, cs * sv + bv)


# ---------------------------------------------------- sorted dispatch -------

def _dense_experts(E, D, I, seed):
    lp = jmoe.init_moe_params(jax.random.PRNGKey(seed), D, jmoe.MoEConfig(
        num_experts=E, top_k=1, moe_intermediate_size=I), jnp.float32)
    return lp, params_from_numpy(_to_numpy(lp), "cpu")


@pytest.mark.parametrize("E,k,M", [(16, 4, 64), (8, 2, 33), (4, 1, 128),
                                   ("skewed", 2, 40)])
def test_sorted_expert_mlp_matches_jax(E, k, M):
    """The cases of tests/test_moe_dispatch.py, the skewed one (every
    token on experts 3 and 5, the others empty) included: the same routing
    through both packages' sorted dispatch, rel < 2e-5."""
    skewed = E == "skewed"
    E = 8 if skewed else E
    D, I = 32, 48
    jlp, tlp = _dense_experts(E, D, I, 0)
    x = np.random.default_rng(M).standard_normal((M, D)).astype(np.float32)
    if skewed:
        idx = np.stack([np.full(M, 3), np.full(M, 5)], 1).astype(np.int32)
        w = np.full((M, k), 0.5, np.float32)
    else:
        mcfg = jmoe.MoEConfig(num_experts=E, top_k=k, moe_intermediate_size=I)
        jw, ji = jmoe.route(jlp, mcfg, jnp.asarray(x))
        w, idx = np.asarray(jw), np.asarray(ji)
    want = jmoe.sorted_expert_mlp(jnp.asarray(x), jlp["experts"],
                                  jnp.asarray(w), jnp.asarray(idx), E,
                                  JACT["silu"])
    got = tmoe.sorted_expert_mlp(torch.from_numpy(x), tlp["experts"],
                                 torch.from_numpy(np.array(w)),
                                 torch.from_numpy(np.array(idx)).long(), E,
                                 torch.nn.functional.silu)
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 2e-5


# ----------------------------------------------------- moe_block branches ---

@pytest.mark.parametrize("branch", ["dense_decode", "dense_prefill",
                                    "packed_decode", "packed_prefill"])
def test_moe_block_branch_matches_jax(branch):
    """Each ported moe_block branch against the JAX package's on the same
    float32 inputs: dense experts at M <= 8 (gathered slabs) and M > 8
    (sorted dispatch); 4-bit experts at M <= 8 (gather_qmm, exact mode on
    both sides) and M > 8 (the port dequantizes once and runs the sorted
    dispatch, the JAX package scans every expert; both round the
    dequantized weights to bf16 and compute in float32 here). A shared
    expert with its sigmoid gate rides along. rel < 1e-5 (1e-4 for the
    prefill of 4-bit experts, whose sums run in another order)."""
    E, k, D, I = 8, 2, 64, 32
    rng = np.random.default_rng(7)
    mcfg = dict(num_experts=E, top_k=k, norm_topk_prob=True,
                moe_intermediate_size=I)
    lp = {"gate": {"w": (rng.standard_normal((E, D)) * 0.2).astype(
              np.float32)},
          "shared_expert": {
              "gate_proj": {"w": (rng.standard_normal((48, D)) * 0.1
                                  ).astype(np.float32)},
              "up_proj": {"w": (rng.standard_normal((48, D)) * 0.1
                                ).astype(np.float32)},
              "down_proj": {"w": (rng.standard_normal((D, 48)) * 0.1
                                  ).astype(np.float32)}},
          "shared_expert_gate": {"w": (rng.standard_normal((1, D)) * 0.1
                                       ).astype(np.float32)}}
    if branch.startswith("packed"):
        lp["experts"] = {n: _exact_fold_experts(rng, E, *shape, GS)
                         for n, shape in (("gate_proj", (I, D)),
                                          ("up_proj", (I, D)),
                                          ("down_proj", (D, I)))}
        jlp = jax.tree.map(jnp.asarray, {kk: v for kk, v in lp.items()
                                         if kk != "experts"})
        jlp["experts"] = {n: _jax_experts(c)
                          for n, c in lp["experts"].items()}
    else:
        lp["experts"] = {n: (rng.standard_normal(shape) * 0.1).astype(
            np.float32) for n, shape in (("gate_proj", (E, I, D)),
                                         ("up_proj", (E, I, D)),
                                         ("down_proj", (E, D, I)))}
        jlp = jax.tree.map(jnp.asarray, lp)
    tlp = params_from_numpy(lp, "cpu", act_bits=None)
    T = 4 if branch.endswith("decode") else 12
    x = rng.standard_normal((2, T, D)).astype(np.float32)
    want = jmoe.moe_block(jlp, jmoe.MoEConfig(**mcfg), jnp.asarray(x))
    _build.reset_launches()
    got = tmoe.moe_block(tlp, tmoe.MoEConfig(**mcfg), torch.from_numpy(x))
    assert sum(_build.LAUNCHES.values()) == 0        # CPU: plain versions
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, T, D)
    tol = 1e-4 if branch == "packed_prefill" else 1e-5
    assert _rel(got.numpy(), want) < tol


@pytest.mark.parametrize("experts", ["4bit", "8bit", "channel8"])
def test_moe_block_decode_makes_one_gate_up_call(experts, monkeypatch):
    """moe_block's decode branch sends gate and up to one call
    (gather_qmm_gate_up or channel_gather_qmm_gate_up: one kernel launch
    on the card) and down to another, with the ids cast to int32 once for
    both; its output equals the branch computed with separate gate and up
    calls bit for bit (the JAX parity of the branch is held by
    test_moe_block_branch_matches_jax and the 8-bit file's)."""
    mcfg = tmoe.MoEConfig(num_experts=8, top_k=2, norm_topk_prob=True,
                          moe_intermediate_size=32)
    gen = torch.Generator().manual_seed(3)
    kw = ({"scheme": "channel8"} if experts == "channel8"
          else {"bits": 4 if experts == "4bit" else 8, "group_size": 32})
    lp = tmoe.init_quantized_moe_params(gen, 64, mcfg, device="cpu", **kw)
    x = torch.randn(1, 3, 64, generator=gen).bfloat16()
    pair = ("channel_gather_qmm_gate_up" if experts == "channel8"
            else "gather_qmm_gate_up")
    single = ("channel_gather_qmm" if experts == "channel8"
              else "gather_qmm")
    calls = []

    def counted(name, fn):
        def call(*a):
            calls.append((name, a[-1].dtype))
            return fn(*a)
        return call
    monkeypatch.setattr(tmoe, pair, counted(pair, getattr(tmoe, pair)))
    monkeypatch.setattr(tmoe, single, counted(single, getattr(tmoe, single)))
    got = tmoe.moe_block(lp, mcfg, x)
    assert calls == [(pair, torch.int32), (single, torch.int32)]
    separate = getattr(tqm, single)
    monkeypatch.setattr(tmoe, pair, lambda x, wg, wu, ids: (
        separate(x, wg, ids), separate(x, wu, ids)))
    assert torch.equal(got, tmoe.moe_block(lp, mcfg, x))


# ------------------------------------------------------- 2-layer model ------

def _logits_pair(jp, tp, prompt, steps, dtype_j, dtype_t):
    """A prefill then ``steps`` greedy decode steps through both packages'
    forward: [(jax logits, torch logits)] per call, float32 numpy."""
    jc = jbase.init_cache(JCFG, 1, 64, dtype_j)
    tc = tbase.init_cache(TCFG, 1, 64, dtype_t, device="cpu")
    out = []
    toks = np.asarray(prompt)[None]
    for i in range(steps + 1):
        jl, jc = jbase.forward(jp, JCFG, jnp.asarray(toks), jc,
                               fresh_prefill=i == 0)
        with torch.inference_mode():
            tl, tc = tbase.forward(tp, TCFG, torch.from_numpy(toks), tc,
                                   fresh_prefill=i == 0)
        jl = np.asarray(jl, np.float32)
        out.append((jl, tl.float().numpy()))
        toks = np.argmax(jl[:, -1:], -1)
    return out


def _dense_model(seed):
    jp = jqwen3_moe.init_params(JCFG, jax.random.PRNGKey(seed), jnp.float32)
    return jp, params_from_numpy(_to_numpy(jp), "cpu")


def test_qwen3_moe_float32_logits_match_jax():
    """2-layer Qwen3-MoE (hidden 64, E=8, k=2, I=32, head dim 16) on
    float32 weights carried across by the bridge: logits of a 20-token
    prefill (sorted dispatch) and 4 decode steps (gathered experts)
    within rel 1e-4."""
    jp, tp = _dense_model(0)
    assert "moe" in tp["layers"][1] and "gate_proj" not in tp["layers"][1]
    prompt = np.random.default_rng(0).integers(0, 512, 20)
    for jl, tl in _logits_pair(jp, tp, prompt, 4, jnp.float32,
                               torch.float32):
        assert jl.shape == tl.shape
        assert _rel(tl, jl) < 1e-4


def _quantized_pair(seed, act_bits, quantize_embed=True):
    dense = jqwen3_moe.init_params(JCFG, jax.random.PRNGKey(seed),
                                   jnp.float32)
    jp = jbase.fuse_layer_projections(jbase.quantize_params(
        dense, GS, 4, consume=False, quantize_embed=quantize_embed))
    assert isinstance(jp["layers"][0]["moe"]["experts"]["down_proj"],
                      jqm.PackedQuantizedExperts)
    tp = params_from_numpy(_to_numpy(jp), "cpu", act_bits=act_bits)
    assert isinstance(tp["layers"][0]["moe"]["experts"]["down_proj"],
                      tqm.PackedQuantizedExperts)
    return jp, tp


def test_qwen3_moe_w4a16_greedy_equals_jax():
    """4-bit weights and experts, exact activations: greedy
    Engine.generate gives the JAX package's 16 tokens, token for token
    (the 12-token prompt buckets to 16: M = 16 > 8 takes the quantized
    prefill branch, decode the gathered experts)."""
    jp, tp = _quantized_pair(1, act_bits=None)
    prompt = np.random.default_rng(1).integers(0, 512, 12)
    je = JEngine(lambda p, t, c: jbase.forward(p, JCFG, t, c), jp,
                 JSampler(),
                 prefill_forward_fn=lambda p, t, c: jbase.forward(
                     p, JCFG, t, c, fresh_prefill=True))
    te = TEngine(lambda p, t, c: tbase.forward(p, TCFG, t, c), tp,
                 TSampler(),
                 prefill_forward_fn=lambda p, t, c: tbase.forward(
                     p, TCFG, t, c, fresh_prefill=True))
    want = list(je.generate(jnp.asarray(prompt, jnp.int32),
                            jbase.init_cache(JCFG, 1, 64), max_tokens=16))
    got = list(te.generate(torch.from_numpy(prompt),
                           tbase.init_cache(TCFG, 1, 64, device="cpu"),
                           max_tokens=16))
    assert len(want) == 16 and got == want


def test_qwen3_moe_quantized_prefill_logits_close_to_jax():
    """Logits of the 4-bit model (dense float32 embedding, so activations
    stay float32) against the JAX package's: the 16-token prefill takes
    the quantized prefill branch (the port dequantizes each layer's
    experts once and runs the sorted dispatch; the JAX package scans every
    expert), then 3 decode steps. Both round the dequantized weights to
    bf16, and the port's plain K1 rounds its input to bf16 as the kernel
    does, so the two differ by bf16 roundings: rel < 2e-2 (read 1.4e-2 at
    most). With bf16 activations a router near-tie can pick another
    expert in one package than in the other, which no rounding bound
    covers; the branch itself is held by the moe_block test."""
    jp, tp = _quantized_pair(2, act_bits=None, quantize_embed=False)
    prompt = np.random.default_rng(2).integers(0, 512, 16)
    for jl, tl in _logits_pair(jp, tp, prompt, 3, jnp.float32,
                               torch.float32):
        assert np.isfinite(tl).all()
        assert _rel(tl, jl) < 2e-2


def test_qwen3_moe_config_and_layers():
    assert TCFG.moe.num_experts == 8 and TCFG.moe.top_k == 2
    assert TCFG.moe.norm_topk_prob and TCFG.use_qk_norm
    assert tqwen3_moe.moe_layer_indices(HF) == [0, 1]
    assert tqwen3_moe.moe_layer_indices(
        {**HF, "num_hidden_layers": 6, "decoder_sparse_step": 2,
         "mlp_only_layers": [3]}) == [1, 5]
    tp = tqwen3_moe.init_quantized_params(
        TCFG, torch.Generator().manual_seed(0), group_size=GS, device="cpu")
    ex = [lp["moe"]["experts"]["gate_proj"] for lp in tp["layers"]]
    assert all(isinstance(e, tqm.PackedQuantizedExperts) for e in ex)
    assert not torch.equal(ex[0].data, ex[1].data)   # each layer its own
    fused = tbase.fuse_layer_projections(tp)
    # the MoE block passes through: every expert weight and router tensor
    # is the same object
    got, want = (tree_leaves(p["layers"][0]["moe"]) for p in (fused, tp))
    assert len(got) == len(want) and all(a is b for a, b in zip(got, want))
    ch = tbase.init_quantized_params(TCFG, torch.Generator().manual_seed(1),
                                     device="cpu", scheme="channel8")
    assert all(isinstance(lp["moe"]["experts"][n],
                          tqm.ChannelQuantizedExperts)
               for lp in ch["layers"] for n in tmoe.EXPERT_NAMES)


def test_moe_cpu_dispatch_counts_no_launch():
    """On the CPU every kernel wrapper of the path runs its plain version
    and counts no launch."""
    tp = tqwen3_moe.init_quantized_params(
        TCFG, torch.Generator().manual_seed(3), group_size=GS, device="cpu")
    _build.reset_launches()
    cache = tbase.init_cache(TCFG, 1, 32, device="cpu")
    toks = torch.arange(1, 13)[None]
    with torch.inference_mode():
        _, cache = tbase.forward(tp, TCFG, toks, cache, fresh_prefill=True)
        logits, _ = tbase.forward(tp, TCFG, toks[:, :1], cache)
    assert torch.isfinite(logits.float()).all()
    assert sum(_build.LAUNCHES.values()) == 0


# -------------------------------------------------- the device default ------

def _gen(d):
    """A generator on the device the entry point will pick."""
    if d is None and torch.cuda.is_available():
        return torch.Generator(device="cuda")
    return torch.Generator()


CTORS = {
    "init_params": lambda d: tbase.init_params(
        TCFG, _gen(d), torch.float32, device=d),
    "init_quantized_params": lambda d: tqwen3_moe.init_quantized_params(
        TCFG, _gen(d), group_size=GS, device=d),
    "init_moe_params": lambda d: tmoe.init_moe_params(
        _gen(d), 64, TCFG.moe, device=d),
    "init_cache": lambda d: tbase.init_cache(TCFG, 1, 16, device=d),
    "init_paged_cache": lambda d: tbase.init_paged_cache(TCFG, 1, 32, 16,
                                                         device=d),
    "KVCache.init": lambda d: tcache.KVCache.init(1, 2, 8, 16, device=d),
    "ModelCache.init_dense": lambda d: tcache.ModelCache.init_dense(
        2, 1, 2, 8, 16, device=d),
    "PagedKVCache.init": lambda d: tpc.PagedKVCache.init(1, 2, 3, 4, 16, 2,
                                                         device=d),
}


def _devices(obj):
    if isinstance(obj, torch.Tensor):
        return {obj.device.type}
    if isinstance(obj, dict):
        return set().union(*map(_devices, obj.values()))
    if isinstance(obj, (list, tuple)):
        return set().union(set(), *map(_devices, obj))
    if dataclasses.is_dataclass(obj):
        return set().union(set(), *(_devices(getattr(obj, f.name))
                                    for f in dataclasses.fields(obj)))
    return set()


@pytest.mark.parametrize("ctor", list(CTORS))
def test_entry_points_default_to_the_card(ctor):
    """With no device named, an entry point allocates on the current CUDA
    device; with no card it raises and says to pass device="cpu"
    (device="cpu" builds on the CPU)."""
    assert _devices(CTORS[ctor]("cpu")) == {"cpu"}
    if torch.cuda.is_available():
        assert _devices(CTORS[ctor](None)) == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            CTORS[ctor](None)
