"""Port parity for 8-bit MoE serving: 8-bit group experts (kernel K4's
8-bit mode, whose plain version is ``gather_qmm_reference``), the expert
dispatch ``expert_route``, channel-int8 experts (kernel K8's plain version
``channel_gather_qmm_reference``), the four quantized ``moe_block``
branches at 8 bits, a 2-layer Qwen3-MoE, and the batched w8a8 server,
against ominix_mlx_tpu on the CPU with the same seeded numpy inputs. K4
and K8 themselves are checked on a CUDA card by
tests/test_torch_kernels_cuda.py."""

import json
import socket
import threading
import urllib.request

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
from ominix_mlx_tpu.ops import quant_matmul as jqm
from ominix_mlx_tpu.serving import batching as jb
from ominix_mlx_tpu_torch.core.generate import Engine as TEngine
from ominix_mlx_tpu_torch.core.quant import QuantizedTensor
from ominix_mlx_tpu_torch.core.sampling import SamplerConfig as TSampler
from ominix_mlx_tpu_torch.models import base as tbase
from ominix_mlx_tpu_torch.models import moe as tmoe
from ominix_mlx_tpu_torch.models import qwen3_moe as tqwen3_moe
from ominix_mlx_tpu_torch.ops import _build
from ominix_mlx_tpu_torch.ops import grouped_matmul as tgmm
from ominix_mlx_tpu_torch.ops import quant_matmul as tqm
from ominix_mlx_tpu_torch.serving.server import ChatModel, Server
from ominix_mlx_tpu_torch.utils.params import params_from_numpy
from ominix_mlx_tpu_torch.utils.tokenizer import chatml

torch.set_num_threads(2)
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
    """JAX param tree -> numpy tree with quantized weights in canonical form
    (4- or 8-bit stacked experts as a dict with a 3-D ``q``, channel
    weights as {"data", "scale"})."""
    if isinstance(tree, jqm.PackedQuantizedExperts):
        G = tree.in_features // tree.group_size
        if tree.bits == 8:
            q = np.asarray(tree.data)
        else:
            b = np.asarray(tree.data).view(np.uint8).astype(np.int16)
            q = np.concatenate([(b & 15) - 8, (b >> 4) - 8], -1).astype(
                np.int8)
        return {"q": q, "scales": np.asarray(tree.scales)[..., :G],
                "biases": np.asarray(tree.biases)[..., :G],
                "group_size": tree.group_size, "bits": tree.bits}
    if isinstance(tree, jqm.PackedQuantizedTensor):
        u = jqm.unpack(tree)
        return {"q": np.array(u.q), "scales": np.asarray(u.scales),
                "biases": np.asarray(u.biases),
                "group_size": u.group_size, "bits": u.bits}
    if isinstance(tree, (jqm.ChannelQuantizedTensor,
                         jqm.ChannelQuantizedExperts)):
        return {"data": np.asarray(tree.data), "scale": np.asarray(tree.scale)}
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return np.asarray(tree)


def _canonical8(rng, E, N, K, gs):
    """Canonical 8-bit experts: signed codes, bf16-exact scales and
    biases (the 8-bit layout stores b itself, so nothing is folded)."""
    G = K // gs
    return {"q": rng.integers(-128, 128, (E, N, K)).astype(np.int8),
            "scales": rng.integers(1, 16, (E, N, G)).astype(np.float32) / 4096,
            "biases": rng.integers(-64, 65, (E, N, G)).astype(np.float32)
            / 1024, "group_size": gs, "bits": 8}


def _jax_experts(c):
    """The JAX package's PackedQuantizedExperts from a canonical dict."""
    return jqm.experts_from_quantized([
        JQuantizedTensor(q=jnp.asarray(c["q"][e]),
                         scales=jnp.asarray(c["scales"][e], jnp.bfloat16),
                         biases=jnp.asarray(c["biases"][e], jnp.bfloat16),
                         group_size=c["group_size"], bits=c["bits"])
        for e in range(c["q"].shape[0])])


# ---------------------------------------------------- 8-bit group experts ---

def test_quantize_experts_8bit_matches_jax():
    """8-bit quantize_experts, experts_from_quantized and the bridge each
    give the JAX package's experts tensor for tensor: the signed codes,
    bf16 scales and unfolded bf16 biases equal; dequantize_expert(s) equal
    the JAX package's bit for bit."""
    rng = np.random.default_rng(20)
    w = rng.standard_normal((4, 32, 128)).astype(np.float32) * 0.05
    jw = jqm.quantize_experts(jnp.asarray(w), 64, 8)
    jc = _to_numpy(jw)
    tw = tqm.quantize_experts(torch.from_numpy(w), 64, 8)
    assert tw.bits == 8 and tw.data.dtype == torch.int8
    assert tuple(tw.data.shape) == (4, 32, 128) and tw.shape == (4, 32, 128)
    np.testing.assert_array_equal(tw.data.numpy(), jc["q"])
    for name in ("scales", "biases"):
        np.testing.assert_array_equal(getattr(tw, name).float().numpy(),
                                      np.asarray(jc[name], np.float32))
    stacked = tqm.experts_from_quantized([
        QuantizedTensor(q=torch.from_numpy(np.array(jc["q"][e])),
                        scales=torch.from_numpy(
                            np.asarray(jc["scales"][e], np.float32)).bfloat16(),
                        biases=torch.from_numpy(
                            np.asarray(jc["biases"][e], np.float32)).bfloat16(),
                        group_size=64, bits=8) for e in range(4)])
    bridged = params_from_numpy(jc, "cpu")
    for other in (stacked, bridged):
        assert isinstance(other, tqm.PackedQuantizedExperts)
        for name in ("data", "scales", "biases"):
            assert torch.equal(getattr(other, name), getattr(tw, name))
    all_e = tqm.dequantize_experts(tw)
    for e in range(4):
        want = np.asarray(jqm.dequantize_expert(jw, e), np.float32)
        np.testing.assert_array_equal(
            tqm.dequantize_expert(tw, e).float().numpy(), want)
        np.testing.assert_array_equal(all_e[e].float().numpy(), want)


def _tpu_gq8_a8(x, ids, jw, out_bf16=True):
    """numpy transcription of the TPU decode kernel at bits=8
    (_gather_qmm_decode and _gq_kernel, ops/quant_matmul.py:1606-1718) for
    each row of x: P the integer dot of cx with the signed int8 codes,
    o = sum_g sx * s_g * P_g (the Rm matmul), plus bf16(xg) . b with b
    unfolded."""
    f32 = np.float32
    bf = lambda a: np.asarray(a, f32).astype(jnp.bfloat16).astype(f32)
    q = np.asarray(jw.data).astype(f32)                # [E, N, K]
    s = np.asarray(jw.scales, f32)
    b = np.asarray(jw.biases, f32)
    E, N, K = q.shape
    gs = jw.group_size
    G = K // gs
    out = np.zeros((x.shape[0], ids.shape[1], N), f32)
    for t in range(x.shape[0]):
        xf = x[t].astype(f32)
        xg = bf(xf.reshape(G, gs).sum(1))
        sx = f32(np.abs(xf).max() / f32(127.0) + f32(1e-12))
        cx = np.round(xf / sx)
        for j, e in enumerate(ids[t]):
            P = (q[e].reshape(N, G, gs) * cx.reshape(G, gs)).sum(-1)
            out[t, j] = (sx * s[e] * P).sum(-1) + b[e] @ xg
    return bf(out) if out_bf16 else out


def test_gather_qmm_8bit_a8_reference_is_the_tpu_formula():
    """act_bits=8 on 8-bit experts computes _gq_kernel's bits=8 formula:
    rel < 1e-3 per row against the numpy transcription, on experts
    quantized by the JAX package."""
    rng = np.random.default_rng(21)
    w = rng.standard_normal((6, 64, 256)).astype(np.float32) * 0.05
    jw = jqm.quantize_experts(jnp.asarray(w), 64, 8)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    x = x.astype(jnp.bfloat16).astype(np.float32)
    ids = np.array([[5, 1, 3], [0, 0, 5], [2, 4, 1], [3, 5, 0]], np.int32)
    want = _tpu_gq8_a8(x, ids, jw)
    tw = params_from_numpy(_to_numpy(jw), "cpu", act_bits=8)
    got = tqm.gather_qmm_reference(torch.from_numpy(x).bfloat16(), tw,
                                   torch.from_numpy(ids), act_bits=8)
    assert got.dtype == torch.bfloat16
    for t in range(4):
        assert _rel(got[t].float().numpy(), want[t]) < 1e-3


def test_gather_qmm_gate_up_8bit_cpu_is_two_plain_calls():
    """gather_qmm_gate_up on 8-bit a8 experts is on the CPU gather_qmm of
    each stack, with no launch, and each output is within rel 1e-3 per row
    of the numpy transcription of _gq_kernel's bits=8 formula, on
    experts of the shape the TPU kernel takes (route "k4")."""
    rng = np.random.default_rng(25)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    x = x.astype(jnp.bfloat16).astype(np.float32)
    ids = np.array([[5, 1, 3], [0, 0, 5], [2, 4, 1]], np.int32)
    jws = [jqm.quantize_experts(jnp.asarray(
        rng.standard_normal((6, 128, 256)).astype(np.float32) * 0.05), 64, 8)
        for _ in range(2)]
    tws = [params_from_numpy(_to_numpy(jw), "cpu", act_bits=8) for jw in jws]
    assert tqm.expert_route(tws[0], 3) == "k4"
    xt, tids = torch.from_numpy(x).bfloat16(), torch.from_numpy(ids)
    _build.reset_launches()
    got = tqm.gather_qmm_gate_up(xt, tws[0], tws[1], tids)
    assert sum(_build.LAUNCHES.values()) == 0
    for g, tw, jw in zip(got, tws, jws):
        assert torch.equal(g, tqm.gather_qmm(xt, tw, tids))
        want = _tpu_gq8_a8(x, ids, jw)
        for t in range(3):
            assert _rel(g[t].float().numpy(), want[t]) < 1e-3


def test_gather_qmm_float32_x_takes_the_tpu_formula():
    """float32 activations: the TPU decode kernel's prologue quantizes and
    group-sums x as it is (_gather_qmm_decode, ops/quant_matmul.py
    :1682-1685), so the port's plain version on float32 x is within rel
    1e-5 per row of the numpy transcription given the same x, with float32
    out (rounding x to bf16 first, as the port did before this test, read
    4.4e-3 on the first row)."""
    rng = np.random.default_rng(23)
    w = rng.standard_normal((6, 64, 256)).astype(np.float32) * 0.05
    jw = jqm.quantize_experts(jnp.asarray(w), 64, 8)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    ids = np.array([[5, 1, 3], [0, 0, 5], [2, 4, 1], [3, 5, 0]], np.int32)
    want = _tpu_gq8_a8(x, ids, jw, out_bf16=False)
    tw = params_from_numpy(_to_numpy(jw), "cpu", act_bits=8)
    got = tqm.gather_qmm_reference(torch.from_numpy(x), tw,
                                   torch.from_numpy(ids), act_bits=8)
    assert got.dtype == torch.float32
    for t in range(4):
        assert _rel(got[t].numpy(), want[t]) < 1e-5


@pytest.mark.parametrize("act_bits", [None, 8])
def test_gather_qmm_8bit_exact_matches_jax_cpu(act_bits):
    """Where the JAX package takes its exact fallback (off the TPU, or at a
    shape its kernel refuses: here N = 48), the port's gather_qmm computes
    it too, whatever the experts' act_bits: rel < 1e-5 in float32
    against the JAX package's CPU gather_qmm."""
    rng = np.random.default_rng(22)
    c = _canonical8(rng, 6, 48, 128, 32)
    x = rng.standard_normal((3, 128)).astype(np.float32)
    ids = np.array([[5, 0], [2, 2], [0, 5]], np.int32)
    want = jqm.gather_qmm(jnp.asarray(x), _jax_experts(c), jnp.asarray(ids))
    tw = params_from_numpy(c, "cpu", act_bits=act_bits)
    assert tqm.expert_route(tw, 3) == "gathered"
    got = tqm.gather_qmm(torch.from_numpy(x), tw, torch.from_numpy(ids))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 2, 48)
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("gs", [32, 64])
def test_grouped_matmul_packed_8bit_equals_dequantized(gs):
    """8-bit packed experts through grouped_matmul (the plain version on
    the CPU) give the bf16 form on dequantize_experts(w) bit for bit, with
    empty groups, a one-row group and rows past sum(gs) (zero)."""
    rng = np.random.default_rng(gs)
    E, N, K, S = 6, 40, 128, 50
    G = K // gs
    w = tqm.PackedQuantizedExperts(
        data=torch.from_numpy(rng.integers(-128, 128, (E, N, K),
                                           dtype=np.int8)),
        scales=torch.from_numpy((rng.random((E, N, G)) + 0.5) / 1000)
        .float().bfloat16(),
        biases=torch.from_numpy(rng.standard_normal((E, N, G)) / 100)
        .float().bfloat16(),
        group_size=gs, bits=8, in_features=K, act_bits=8)
    counts = torch.tensor([0, 1, 24, 0, 20, 0])
    xs = torch.from_numpy(rng.standard_normal((S, K)).astype(np.float32)
                          ).bfloat16()
    _build.reset_launches()
    got = tgmm.grouped_matmul(xs, w, counts)
    want = tgmm.grouped_matmul_reference(xs, tqm.dequantize_experts(w),
                                         counts)
    assert torch.equal(got, want)
    assert torch.equal(got[45:], torch.zeros(5, N))
    assert sum(_build.LAUNCHES.values()) == 0


# --------------------------------------------------------- expert_route -----

class _Routed(Exception):
    pass


class _Slab:
    """Stands for a stacked expert array in the JAX dispatch: it carries
    its shape, and indexing it (the exact fallback's gather) names the
    branch."""

    def __init__(self, *shape):
        self.shape = shape

    def __getitem__(self, _):
        raise _Routed("gathered")


# (E, N, K, group size) at 4 and at 8 bits: shapes the TPU kernel takes,
# and one that fails each of its conditions
ROUTE_CASES = {
    "takes": (4, 256, 512, 64),
    "qwen3_30b_gate": (128, 768, 2048, 64),
    "qwen3_30b_down": (128, 2048, 768, 64),
    "groups_over_128": (2, 128, 8192, 32),
    "row_not_128": (2, 256, 320, 32),
    "n_not_128": (2, 200, 512, 64),
    "k_not_2gs": (2, 256, 768, 256),
    "slab_over_8mib": (2, 2048, 2304, 64),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_expert_route_matches_jax_dispatch(case, monkeypatch):
    """``expert_route`` names the branch the JAX package's gather_qmm
    takes on the TPU (``kernel_ok``, ops/quant_matmul.py:1734-1738), at 4
    and 8 bits and T in {1, 8, 64}. The JAX dispatch runs for real with
    its backend reported as "tpu", the kernel's entry stubbed to name
    "k4" and the fallback's gather to name "gathered"; the port's experts
    are built by pack_experts on meta tensors."""
    def kernel(*a, **k):
        raise _Routed("k4")

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jqm, "_gather_qmm_decode", kernel)
    E, N, K, gs = ROUTE_CASES[case]
    seen = set()
    for bits in (4, 8):
        kd = K // 2 if bits == 4 else K
        G = K // gs
        jw = jqm.PackedQuantizedExperts(
            data=_Slab(E, N, kd), scales=_Slab(E, N, G),
            biases=_Slab(E, N, G), group_size=gs, bits=bits, in_features=K)
        meta = dict(device="meta")
        tw = tqm.pack_experts(QuantizedTensor(
            q=torch.empty(E * N, K, dtype=torch.int8, **meta),
            scales=torch.empty(E * N, G, dtype=torch.bfloat16, **meta),
            biases=torch.empty(E * N, G, dtype=torch.bfloat16, **meta),
            group_size=gs, bits=bits), E)
        assert tw.data.shape == (E, N, kd)
        for T in (1, 8, 64):
            with pytest.raises(_Routed) as r:
                jqm.gather_qmm(jnp.zeros((T, K), jnp.bfloat16), jw,
                               jnp.zeros((T, 2), jnp.int32))
            assert tqm.expert_route(tw, T) == str(r.value), (bits, T)
            seen.add(str(r.value))
    want = {"takes": "k4", "qwen3_30b_gate": "k4",
            "qwen3_30b_down": "k4"}.get(case, "gathered")
    if case == "slab_over_8mib":      # 2 x 2048 x 1152 B fits at 4 bits
        assert seen == {"k4", "gathered"}
    else:
        assert seen == {want}


# -------------------------------------------------- channel-int8 experts ----

def test_channel_experts_match_jax():
    """channel_quantize_experts gives the JAX package's codes and scales
    exactly; channel_dequantize_expert, channel_expert_matmul_q and
    channel_gather_qmm (its plain version on the CPU) equal the JAX
    package's float32 outputs within 1e-6 relative (the same int32 sums
    and rescale order: bit for bit here), with sums past 2^24."""
    rng = np.random.default_rng(23)
    E, N, K = 6, 40, 1280
    w = rng.standard_normal((E, N, K)).astype(np.float32)
    # row 0 of expert 3 and x's row 0 the same signs of equal magnitude:
    # every code is +-127, so that int32 sum is K * 127^2 = 2.06e7 > 2^24,
    # where a float32 sum would round
    signs = np.sign(rng.standard_normal(K)).astype(np.float32)
    w[3, 0] = signs
    jw = jqm.channel_quantize_experts(jnp.asarray(w))
    tw = tqm.channel_quantize_experts(torch.from_numpy(w))
    np.testing.assert_array_equal(tw.data.numpy(), np.asarray(jw.data))
    np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
    bridged = params_from_numpy(_to_numpy(jw), "cpu")
    assert isinstance(bridged, tqm.ChannelQuantizedExperts)
    assert torch.equal(bridged.data, tw.data)
    assert torch.equal(bridged.scale, tw.scale)
    for e in (0, 5):
        np.testing.assert_array_equal(
            tqm.channel_dequantize_expert(tw, e).float().numpy(),
            np.asarray(jqm.channel_dequantize_expert(jw, e), np.float32))
    x = rng.standard_normal((5, K)).astype(np.float32)
    x[0] = signs
    ids = np.array([[3, 0, 5], [1, 1, 2], [5, 4, 3], [0, 2, 1], [4, 5, 0]],
                   np.int32)
    want = np.asarray(jqm.channel_gather_qmm(jnp.asarray(x), jw,
                                             jnp.asarray(ids)))
    got = tqm.channel_gather_qmm(torch.from_numpy(x), tw,
                                 torch.from_numpy(ids))
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 3, N)
    assert _rel(got.numpy(), want) < 1e-6
    xq, sx = jqm.quantize_act_channel(jnp.asarray(x))
    txq, tsx = tqm.quantize_act_channel(torch.from_numpy(x))
    np.testing.assert_array_equal(txq.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(tsx.numpy(), np.asarray(sx))
    want_e = np.asarray(jqm.channel_expert_matmul_q(xq, sx, jw, 4))
    got_e = tqm.channel_expert_matmul_q(txq, tsx, tw, 4)
    assert _rel(got_e.numpy(), want_e) < 1e-6
    assert int(np.abs(np.asarray(jnp.einsum(
        "td,tknd->tkn", xq, jw.data[ids],
        preferred_element_type=jnp.int32))).max()) > 2 ** 24


def test_channel_gather_qmm_gate_up_cpu_is_two_plain_calls():
    """channel_gather_qmm_gate_up (one K8 launch for gate and up on the
    card) is on the CPU channel_gather_qmm of each stack bit for bit, with
    no launch, on float32 and bf16 x, and equals the JAX package's
    channel_gather_qmm within 1e-6 relative (the same int32 sums and
    rescale order)."""
    rng = np.random.default_rng(26)
    E, N, K = 6, 40, 256
    jws = [jqm.channel_quantize_experts(jnp.asarray(
        rng.standard_normal((E, N, K)).astype(np.float32))) for _ in range(2)]
    tws = [params_from_numpy(_to_numpy(jw), "cpu") for jw in jws]
    x = rng.standard_normal((4, K)).astype(np.float32)
    ids = np.array([[3, 0], [1, 1], [5, 4], [0, 2]], np.int32)
    tids = torch.from_numpy(ids)
    for xt in (torch.from_numpy(x), torch.from_numpy(x).bfloat16()):
        _build.reset_launches()
        got = tqm.channel_gather_qmm_gate_up(xt, tws[0], tws[1], tids)
        assert sum(_build.LAUNCHES.values()) == 0
        for g, tw, jw in zip(got, tws, jws):
            assert torch.equal(g, tqm.channel_gather_qmm(xt, tw, tids))
            want = np.asarray(jqm.channel_gather_qmm(
                jnp.asarray(xt.float().numpy()), jw, jnp.asarray(ids)))
            assert _rel(g.numpy(), want) < 1e-6


# ----------------------------------------------------- moe_block branches ---

@pytest.mark.parametrize("branch", ["group8_decode", "group8_prefill",
                                    "channel_decode", "channel_prefill"])
def test_moe_block_8bit_branch_matches_jax(branch):
    """The quantized moe_block branches at 8 bits against the JAX
    package's on the same float32 inputs and weights, with a shared expert
    and its sigmoid gate: 8-bit group experts at M <= 8 (gather_qmm, exact
    on both sides) and M > 8 (the port dequantizes once and sorts, the JAX
    package scans every expert; both round the weights to bf16 and compute
    in float32 here), and channel-int8 experts at M <= 8 (the gathered
    int8 products, h in float32) and M > 8 (the all-expert pass in expert
    order on both sides). rel < 1e-5; 1e-4 for the group prefill, whose
    sums run in another order."""
    E, k, D, I = 8, 2, 64, 32
    rng = np.random.default_rng(24)
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
    jlp = jax.tree.map(jnp.asarray, lp)
    shapes = (("gate_proj", (I, D)), ("up_proj", (I, D)),
              ("down_proj", (D, I)))
    if branch.startswith("group8"):
        canon = {n: _canonical8(rng, E, *shape, GS) for n, shape in shapes}
        jlp["experts"] = {n: _jax_experts(c) for n, c in canon.items()}
    else:
        jlp["experts"] = {n: jqm.channel_quantize_experts(jnp.asarray(
            rng.standard_normal((E, *shape)).astype(np.float32) * 0.1))
            for n, shape in shapes}
    tlp = params_from_numpy(_to_numpy(jlp), "cpu", act_bits=None)
    kind = (tqm.PackedQuantizedExperts if branch.startswith("group8")
            else tqm.ChannelQuantizedExperts)
    assert all(isinstance(v, kind) for v in tlp["experts"].values())
    T = 4 if branch.endswith("decode") else 12
    x = rng.standard_normal((2, T, D)).astype(np.float32)
    want = jmoe.moe_block(jlp, jmoe.MoEConfig(**mcfg), jnp.asarray(x))
    _build.reset_launches()
    got = tmoe.moe_block(tlp, tmoe.MoEConfig(**mcfg), torch.from_numpy(x))
    assert sum(_build.LAUNCHES.values()) == 0        # CPU: plain versions
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, T, D)
    tol = 1e-4 if branch == "group8_prefill" else 1e-5
    assert _rel(got.numpy(), want) < tol


# ------------------------------------------------------- 2-layer model ------

def _quantized_pair(seed, scheme):
    """A 2-layer Qwen3-MoE quantized by the JAX package (8-bit group
    weights fused into panels, or channel8 with batched=True as its
    batched server does) and carried across by the bridge."""
    dense = jqwen3_moe.init_params(JCFG, jax.random.PRNGKey(seed),
                                   jnp.float32)
    if scheme == "q8":
        jp = jbase.fuse_layer_projections(jbase.quantize_params(
            dense, GS, 8, consume=False))
        kind = tqm.PackedQuantizedExperts
    else:
        jp = jbase.quantize_params(dense, consume=False, batched=True,
                                   scheme="channel8")
        kind = tqm.ChannelQuantizedExperts
    tp = params_from_numpy(_to_numpy(jp), "cpu", act_bits=None)
    assert all(isinstance(v, kind) for lp in tp["layers"]
               for v in lp["moe"]["experts"].values())
    return jp, tp


@pytest.mark.parametrize("scheme", ["q8", "channel8"])
def test_qwen3_moe_8bit_greedy_equals_jax(scheme):
    """quantize_params at 8 bits (exact activations) and with
    scheme="channel8": greedy Engine.generate gives the JAX package's 16
    tokens, token for token (the 12-token prompt buckets to 16, M = 16 >
    8: the quantized prefill branch; decode the gathered experts)."""
    jp, tp = _quantized_pair(3, scheme)
    prompt = np.random.default_rng(3).integers(0, 512, 12)
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


@pytest.mark.parametrize("scheme", ["group", "channel8"])
def test_quantize_params_moe_8bit_matches_jax(scheme):
    """The port's quantize_params on a MoE tree (bits=8, or
    scheme="channel8") gives the JAX package's experts tensor for tensor,
    and its dense layers the same types; the router gate stays dense."""
    dense = jqwen3_moe.init_params(JCFG, jax.random.PRNGKey(4), jnp.float32)
    jq = jbase.quantize_params(dense, GS, 8, consume=False, scheme=scheme)
    tq = tbase.quantize_params(params_from_numpy(_to_numpy(dense), "cpu"),
                               GS, 8, scheme=scheme)
    want = params_from_numpy(_to_numpy(jq), "cpu")
    for jl, tl in zip(want["layers"], tq["layers"]):
        assert isinstance(tl["moe"]["gate"]["w"], torch.Tensor)
        for name, wv in jl["moe"]["experts"].items():
            tv = tl["moe"]["experts"][name]
            assert type(tv) is type(wv) and type(tv) is (
                tqm.ChannelQuantizedExperts if scheme == "channel8"
                else tqm.PackedQuantizedExperts)
            fields = (("data", "scale") if scheme == "channel8"
                      else ("data", "scales", "biases"))
            for f in fields:
                assert torch.equal(getattr(tv, f), getattr(wv, f)), (name, f)
        assert type(tl["q_proj"]["w"]) is type(jl["q_proj"]["w"])


@pytest.mark.parametrize("bits,scheme", [(8, "group"), (4, "channel8")])
def test_init_quantized_params_moe(bits, scheme):
    """init_quantized_params on a MoE config makes the experts directly in
    their packed form, with base.init_quantized_params's ranges: 8-bit
    codes over [-128, 128) with scales 1/(sqrt(in) 128) and zero biases,
    or channel codes over [-127, 127] with scale in**-0.5 / 127; each
    layer its own; a forward on the CPU is finite and launches nothing."""
    tp = tqwen3_moe.init_quantized_params(
        TCFG, torch.Generator().manual_seed(5), group_size=GS, bits=bits,
        device="cpu", scheme=scheme)
    ex = [lp["moe"]["experts"] for lp in tp["layers"]]
    for name, (N, K) in (("gate_proj", (32, 64)), ("down_proj", (64, 32))):
        w = ex[0][name]
        assert tuple(w.data.shape) == (8, N, K) and w.data.dtype == torch.int8
        if scheme == "channel8":
            assert isinstance(w, tqm.ChannelQuantizedExperts)
            assert int(w.data.min()) >= -127
            assert torch.equal(w.scale, torch.full((8, N), K ** -0.5 / 127))
        else:
            assert isinstance(w, tqm.PackedQuantizedExperts) and w.bits == 8
            assert int(w.data.min()) == -128 and int(w.data.max()) == 127
            assert torch.equal(w.scales.float(), torch.full(
                (8, N, K // GS), K ** -0.5 / 128).bfloat16().float())
            assert not w.biases.float().any()
    assert not torch.equal(ex[0]["up_proj"].data, ex[1]["up_proj"].data)
    fused = tbase.fuse_layer_projections(tp)
    _build.reset_launches()
    with torch.inference_mode():
        cache = tbase.init_cache(TCFG, 1, 32, device="cpu")
        toks = torch.arange(1, 13)[None]
        _, cache = tbase.forward(fused, TCFG, toks, cache, fresh_prefill=True)
        logits, _ = tbase.forward(fused, TCFG, toks[:, :1], cache)
    assert torch.isfinite(logits.float()).all()
    assert sum(_build.LAUNCHES.values()) == 0


# ------------------------------------------------------ batched server ------

class _ByteTokenizer:
    """UTF-8 bytes are ids 0..255; larger ids decode as ``<id>``; no stop
    token, so every request runs its max_tokens."""
    eos_token_id = None

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        out, buf = [], bytearray()
        for i in ids:
            if i < 256:
                buf.append(i)
                continue
            out.append(buf.decode("utf-8", "replace"))
            buf = bytearray()
            out.append(f"<{i}>")
        out.append(buf.decode("utf-8", "replace"))
        return "".join(out)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_batched_w8_server_moe_matches_jax():
    """Server.enable_batching(quantize_bits=8) on a small Qwen3-MoE: the
    weights become channelwise w8a8 (channel-int8 experts), and three
    concurrent chat requests answer what the JAX package's batched server
    computes on the same float32 weights (its channel8 quantization with
    batched=True and its ContinuousBatcher over the same prompt tokens),
    token for token."""
    dense = jqwen3_moe.init_params(JCFG, jax.random.PRNGKey(6), jnp.float32)
    tok = _ByteTokenizer()
    contents = ["hi", "count to 3", "name a colour"]
    prompts = [tok.encode(chatml([{"role": "user", "content": c}]))
               for c in contents]
    n_out = 6
    jq = jbase.quantize_params(dense, bits=8, consume=False, batched=True,
                               scheme="channel8")
    jfwd = lambda p, t, c, *a: jbase.forward(
        p, JCFG, t, c, **({"kv_limit": a[0]} if a else {}))
    jcb = jb.ContinuousBatcher(
        jfwd, jq, JCFG,
        lambda cfg, b, ml: jbase.init_cache(cfg, b, ml, jnp.float32),
        slots=3, max_len=256,
        prefill_forward_fn=lambda p, t, c: jbase.forward(
            p, JCFG, t, c, fresh_prefill=True),
        chunk_forward_fn=jfwd,
        chunk_hidden_forward_fn=lambda p, t, c, kl: jbase.forward(
            p, JCFG, t, c, kv_limit=kl, skip_logits=True))
    want = jcb.run_all([(i, p, n_out) for i, p in enumerate(prompts)])

    srv = Server(port=_free_port())
    srv.add_model("moe", ChatModel("moe", params_from_numpy(
        _to_numpy(dense), "cpu"), TCFG, tok, "cpu"))
    srv.enable_batching("moe", slots=3, max_len=256, dtype=torch.float32,
                        quantize_bits=8)
    srv.start_background()
    texts = [None] * 3
    try:
        ex = srv.batchers["moe"].batcher.params["layers"][0]["moe"]["experts"]
        assert isinstance(ex["down_proj"], tqm.ChannelQuantizedExperts)

        def run(i):
            body = {"model": "moe", "max_tokens": n_out,
                    "messages": [{"role": "user", "content": contents[i]}]}
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/chat/completions",
                json.dumps(body).encode(),
                {"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                texts[i] = json.loads(r.read())["choices"][0]["message"][
                    "content"]

        threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
    finally:
        srv.shutdown()
    assert all(len(want[i]) == n_out for i in range(3))
    assert texts == [tok.decode(want[i]) for i in range(3)]
