"""Mixture-of-experts layer: SwiGLU experts and top-k routing (counterpart
of ominix_mlx_tpu/models/moe.py).

Expert weights are stacked [E, N, K] (HF output-major layout): dense bf16,
4- or 8-bit group ``PackedQuantizedExperts``, or channelwise int8
``ChannelQuantizedExperts`` (the batched server's w8a8). ``moe_block``
branches on the rows M of the layer's input and the experts' type:

* channel experts, M <= 8 (decode): ``channel_gather_qmm_gate_up`` then
  ``channel_gather_qmm`` for down, kernel K8 on CUDA (one launch for gate
  and up, one for down), reading only the selected experts' int8 rows;
  the hidden activation stays float32;
* group experts, M <= 8: ``gather_qmm_gate_up`` then ``gather_qmm``,
  kernel K4 on CUDA where ``expert_route`` names it (one launch for gate
  and up, one for down);
* bf16 experts, M <= 8: gather the selected slabs and compute plainly;
* channel experts, M > 8 (prefill): the JAX package's all-expert pass,
  activations quantized once and every expert's exact int8 products
  (``torch._int_mm``) combined by the routing weights in expert order,
  E/k times the routed work;
* other experts, M > 8: ``sorted_expert_mlp``, the token copies sorted by
  expert and three grouped matmuls, kernel K5 on CUDA, which reads group
  experts packed (each routed expert's weights dequantized in registers,
  no bf16 copy).

The port reads no environment variable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.core.quant import QuantizedTensor
from ominix_mlx_tpu_torch.nn.layers import ACTIVATIONS, linear
from ominix_mlx_tpu_torch.ops.grouped_matmul import grouped_matmul
from ominix_mlx_tpu_torch.ops.quant_matmul import (
    ChannelQuantizedExperts, ChannelQuantizedTensor, PackedQuantizedExperts,
    channel_expert_matmul_q, channel_gather_qmm, channel_gather_qmm_gate_up,
    channel_quantize_experts, gather_qmm, gather_qmm_gate_up, prepare,
    quantize_act_channel, quantize_experts)

EXPERT_NAMES = ("gate_proj", "up_proj", "down_proj")
GATHER_M_MAX = 8    # up to this many token rows, the experts are gathered
                    # per row (K4); more take the sorted dispatch (K5)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    norm_topk_prob: bool = False
    routing: str = "softmax"          # "softmax" (qwen, mixtral) or
                                      # "sigmoid" (glm4-moe)
    softmax_after_topk: bool = False  # mixtral: softmax over the k scores
    routed_scaling_factor: float = 1.0
    n_shared_experts: int = 0         # a shared expert of this many
                                      # experts' width (GLM4-MoE, DeepSeek)
    hidden_act: str = "silu"
    moe_intermediate_size: int = 0
    # DeepSeek-style node-limited group routing (glm4-moe): pick topk_group
    # groups by their top-2 score sums, then top_k within those groups
    n_group: int = 1
    topk_group: int = 1


def route(lp: dict, mcfg: MoEConfig, x: torch.Tensor):
    """x: [T, D] -> (weights [T, k] float32, indices [T, k] int64).

    Scores are float32 (x and the dense gate widened, a full float32
    matmul); the three styles are softmax then top-k (Qwen), top-k then
    softmax (Mixtral), and sigmoid with ``e_score_correction_bias`` and
    group-limited top-k (GLM4-MoE)."""
    gate = lp["gate"]
    scores = x.float() @ gate["w"].float().T               # [T, E]
    if "b" in gate:
        scores = scores + gate["b"].float()
    if mcfg.routing == "sigmoid":
        scores = torch.sigmoid(scores)
        sel = scores
        if "e_score_correction_bias" in lp:
            sel = scores + lp["e_score_correction_bias"].float()
        if mcfg.n_group > 1:
            # node-limited routing (HF Glm4MoeTopkRouter.get_topk_indices)
            T = sel.shape[0]
            g = sel.reshape(T, mcfg.n_group, -1)
            group_scores = torch.topk(g, 2, dim=-1).values.sum(-1)
            gidx = torch.topk(group_scores, mcfg.topk_group, dim=-1).indices
            gmask = torch.zeros_like(group_scores).scatter(1, gidx, 1.0)
            sel = torch.where(gmask[:, :, None] > 0, g,
                              torch.zeros_like(g)).reshape(T, -1)
        idx = torch.topk(sel, mcfg.top_k, dim=-1).indices
        w = torch.gather(scores, -1, idx)
    elif mcfg.softmax_after_topk:
        w, idx = torch.topk(scores, mcfg.top_k, dim=-1)
        w = torch.softmax(w, -1)
    else:
        w, idx = torch.topk(torch.softmax(scores, -1), mcfg.top_k, dim=-1)
    if mcfg.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * mcfg.routed_scaling_factor, idx


def sorted_expert_mlp(xt: torch.Tensor, ex: dict, w: torch.Tensor,
                      idx: torch.Tensor, num_experts: int,
                      act) -> torch.Tensor:
    """Sort-by-expert dispatch for MoE prefill: the M * k token copies are
    sorted by routed expert (a stable sort: ties keep token order), so each
    expert's rows form one contiguous block of the grouped matmuls.

    xt: [M, D] tokens; w / idx: [M, k] routing weights / expert ids;
    ex: stacked expert weights {gate_proj / up_proj [E, I, D], down_proj
    [E, D, I]}, bf16 or ``PackedQuantizedExperts``. Returns float32
    [M, D].

    The combine un-permutes ``ys * w`` into [M, k, D] and sums over k in a
    fixed order, where the JAX package adds into the token rows
    (``.at[tok].add``): a float32 scatter-add on CUDA uses atomics, whose
    order, and so whose bits, change from run to run."""
    M, D = xt.shape
    k = idx.shape[1]
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    xs = xt[order // k]                                 # [M*k, D] sorted
    # group sizes by integer adds on the device (exact in any order):
    # torch.bincount on CUDA reads the ids' min and max on the host, a
    # wait for the device in every MoE layer
    gs = torch.zeros(num_experts, dtype=torch.int32,
                     device=xt.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e, dtype=torch.int32))
    g = grouped_matmul(xs, ex["gate_proj"], gs)         # f32 [M*k, I]
    u = grouped_matmul(xs, ex["up_proj"], gs)
    h = (act(g) * u).to(xt.dtype)
    ys = grouped_matmul(h, ex["down_proj"], gs)         # f32 [M*k, D]
    wf = w.reshape(-1).float()[order]
    # order is a permutation, so no two rows of ys land on one row of yk
    yk = torch.empty_like(ys)
    yk[order] = ys * wf[:, None]
    return yk.reshape(M, k, D).sum(1)


def _expert_mlp(wg, wu, wd, x, act):
    """SwiGLU for one (gathered) expert weight set.

    wg/wu: [..., I, D]; wd: [..., D, I]; x: [..., D]."""
    g = torch.einsum("...id,...d->...i", wg, x)
    u = torch.einsum("...id,...d->...i", wu, x)
    h = act(g) * u
    return torch.einsum("...di,...i->...d", wd, h)


def moe_block(lp: dict, mcfg: MoEConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [B, T, D] -> [B, T, D].

    lp: {"gate": linear, "experts": {"gate_proj": [E, I, D], "up_proj":
    [E, I, D], "down_proj": [E, D, I]} (dense, PackedQuantizedExperts or
    ChannelQuantizedExperts), optional "shared_expert": dense mlp params,
    optional "shared_expert_gate", "e_score_correction_bias"}."""
    B, T, D = x.shape
    act = ACTIVATIONS[mcfg.hidden_act]
    xt = x.reshape(B * T, D)
    w, idx = route(lp, mcfg, xt)                         # [M, k]
    M = B * T
    k = mcfg.top_k
    ex = lp["experts"]
    kinds = (torch.Tensor, PackedQuantizedExperts, ChannelQuantizedExperts)
    if not all(isinstance(ex[n], kinds) for n in EXPERT_NAMES):
        raise NotImplementedError(
            f"{type(ex['gate_proj']).__name__} experts are not ported to "
            f"the torch package: bf16/float, 4- and 8-bit group and "
            f"channel-int8 experts are")
    quant = isinstance(ex["gate_proj"], PackedQuantizedExperts)
    chan = isinstance(ex["gate_proj"], ChannelQuantizedExperts)

    if M <= GATHER_M_MAX and (chan or quant):
        # the kernels take int32 ids: cast once for the layer's launches
        ids = idx.to(torch.int32)
    if M <= GATHER_M_MAX and chan:
        # decode, channel-int8 experts: read ONLY the top-k experts' int8
        # rows (K8 on CUDA, gate and up in one launch); the products are
        # exact, h stays float32
        g, u = channel_gather_qmm_gate_up(xt, ex["gate_proj"],
                                          ex["up_proj"], ids)  # [M, k, I]
        h = act(g) * u
        I = h.shape[-1]
        y = channel_gather_qmm(h.reshape(M * k, I), ex["down_proj"],
                               ids.reshape(M * k, 1)).reshape(M, k, D)
        y = torch.einsum("mkd,mk->md", y, w.float())
    elif M <= GATHER_M_MAX and quant:
        # decode, quantized experts: read ONLY the top-k experts' 4- or
        # 8-bit rows (K4 on CUDA, gate and up in one launch), as the TPU's
        # gather_qmm kernel does
        g, u = gather_qmm_gate_up(xt, ex["gate_proj"], ex["up_proj"],
                                  ids)                   # [M, k, I]
        h = (act(g.float()) * u.float()).to(x.dtype)
        I = h.shape[-1]
        y = gather_qmm(h.reshape(M * k, I), ex["down_proj"],
                       ids.reshape(M * k, 1)).reshape(M, k, D)
        y = torch.einsum("mkd,mk->md", y.float(), w.float())
    elif M <= GATHER_M_MAX:
        # decode: gather only the selected experts' weights
        wg = ex["gate_proj"][idx]                        # [M, k, I, D]
        wu = ex["up_proj"][idx]
        wd = ex["down_proj"][idx]
        y = _expert_mlp(wg, wu, wd, xt[:, None, :], act)  # [M, k, D]
        y = torch.einsum("mkd,mk->md", y.float(), w.float())
    elif chan:
        # prefill, channel-int8 experts: the JAX package's all-expert pass
        # (models/moe.py:206-222), activations quantized ONCE, each
        # expert's products exact (torch._int_mm, XLA's dot_general there),
        # accumulated in expert order as there, so the float32 sums match
        comb = torch.zeros(M, mcfg.num_experts, device=x.device).scatter_add_(
            1, idx, w.float())
        xq, sx = quantize_act_channel(xt.float())
        y = torch.zeros(M, D, device=x.device)
        for e in range(mcfg.num_experts):
            g = channel_expert_matmul_q(xq, sx, ex["gate_proj"], e)
            u = channel_expert_matmul_q(xq, sx, ex["up_proj"], e)
            hq, sh = quantize_act_channel(act(g) * u)
            ye = channel_expert_matmul_q(hq, sh, ex["down_proj"], e)
            y = y + ye * comb[:, e][:, None]
    else:
        # prefill: the sorted dispatch. Group experts go to the grouped
        # matmul packed, each routed expert's weights equal to its
        # dequantize_expert. The JAX package scans every expert over every
        # token instead, dropping the unrouted terms by zero weights
        # (models/moe.py:223-234): the same function at k/E of its FLOPs,
        # but rounded at other points (its matmuls round to bf16 before
        # the activation and after the down projection; here g, u and the
        # down projection stay float32, and h rounds to bf16 once)
        y = sorted_expert_mlp(xt, ex, w, idx, mcfg.num_experts, act)

    y = y.to(x.dtype)
    if "shared_expert" in lp:
        se = lp["shared_expert"]
        sh = linear(se["down_proj"],
                    act(linear(se["gate_proj"], xt))
                    * linear(se["up_proj"], xt))
        if "shared_expert_gate" in lp:
            sh = sh * torch.sigmoid(linear(lp["shared_expert_gate"], xt))
        y = y + sh
    return y.reshape(B, T, D)


def quantize_experts_params(lp: dict, group_size: int = 64, bits: int = 4,
                            scheme: str = "group",
                            act_bits: Optional[int] = 8) -> dict:
    """Quantize a MoE layer's stacked expert weights (returns a new dict);
    the router gate stays dense. scheme="group": 4- or 8-bit
    ``PackedQuantizedExperts``; scheme="channel8": per-(expert, output
    channel) int8 ``ChannelQuantizedExperts`` (the batched-serving w8a8;
    ``group_size``, ``bits`` and ``act_bits`` unused)."""
    if scheme not in ("group", "channel8"):
        raise ValueError(f"scheme {scheme!r}")
    out = dict(lp)
    ex = dict(lp["experts"])
    for name in EXPERT_NAMES:
        if isinstance(ex.get(name), torch.Tensor):
            ex[name] = (channel_quantize_experts(ex[name])
                        if scheme == "channel8" else
                        quantize_experts(ex[name], group_size, bits,
                                         act_bits))
    out["experts"] = ex
    return out


def _shared_shapes(mcfg: MoEConfig, D: int, gated_shared: int = 0) -> dict:
    """The shared expert's projections [out, in]: a SwiGLU MLP of
    ``gated_shared`` width where that is set (Qwen3-Next's
    ``mlp.shared_expert``), else of ``n_shared_experts`` experts' width
    (the JAX package's checkpoints' ``mlp.shared_experts``); {} for
    neither."""
    Is = gated_shared or mcfg.n_shared_experts * mcfg.moe_intermediate_size
    if not Is:
        return {}
    return {"gate_proj": (Is, D), "up_proj": (Is, D), "down_proj": (D, Is)}


def init_moe_params(generator: torch.Generator, hidden_size: int,
                    mcfg: MoEConfig, dtype=torch.bfloat16,
                    device=None, gated_shared: int = 0) -> dict:
    """Random dense MoE layer: uniform +-1/sqrt(in) router gate and
    experts (the JAX package's init_moe_params) and a shared expert where
    ``n_shared_experts`` > 0 or, of ``gated_shared`` width, behind a
    sigmoid gate [1, D] (Qwen3-Next's ``shared_expert_intermediate_size``:
    a width the JAX package's MoEConfig does not hold), on ``device``
    (default: the current CUDA device)."""
    device = resolve_device(device)
    E, I, D = mcfg.num_experts, mcfg.moe_intermediate_size, hidden_size

    def uniform(shape, lim):
        u = torch.rand(shape, generator=generator, device=device) * 2 - 1
        return (u * lim).to(dtype)

    lp = {"gate": {"w": uniform((E, D), D ** -0.5)},
          "experts": {"gate_proj": uniform((E, I, D), D ** -0.5),
                      "up_proj": uniform((E, I, D), D ** -0.5),
                      "down_proj": uniform((E, D, I), I ** -0.5)}}
    _add_shared(lp, mcfg, D, lambda o, i: uniform((o, i), i ** -0.5),
                lambda: uniform((1, D), D ** -0.5), gated_shared)
    return lp


def _add_shared(lp: dict, mcfg: MoEConfig, D: int, make, make_gate,
                gated_shared: int = 0):
    """The shared expert from ``make(out, in)`` and, for a gated one, its
    dense gate ``make_gate()`` [1, D] (the JAX package's quantize_params
    leaves it dense)."""
    shapes = _shared_shapes(mcfg, D, gated_shared)
    if shapes:
        lp["shared_expert"] = {n: {"w": make(*shape)} for n, shape in
                               shapes.items()}
    if gated_shared:
        lp["shared_expert_gate"] = {"w": make_gate()}


def random_quantized_linear(generator: torch.Generator, out_f: int,
                            in_f: int, group_size: int = 64, bits: int = 4,
                            act_bits: Optional[int] = 8, device=None,
                            scheme: str = "group", batched: bool = False):
    """One random quantized [out_f, in_f] weight made directly:
    scheme="group", 4- or 8-bit codes uniform over their range, scales
    1/(sqrt(in) 2^(bits-1)), zero biases, packed row-major
    (``ops.quant_matmul.prepare``); scheme="channel8", int8 codes uniform
    in [-127, 127] and scale in**-0.5 / 127 per row."""
    if scheme == "channel8":
        return ChannelQuantizedTensor(
            data=torch.randint(-127, 128, (out_f, in_f), generator=generator,
                               device=device, dtype=torch.int8),
            scale=torch.full((out_f,), (in_f ** -0.5) / 127.0,
                             dtype=torch.float32, device=device))
    lim = 1 << (bits - 1)
    q = torch.randint(-lim, lim, (out_f, in_f), generator=generator,
                      device=device, dtype=torch.int8)
    G = in_f // group_size
    qt = QuantizedTensor(
        q=q, scales=torch.full((out_f, G), (in_f ** -0.5) / lim,
                               dtype=torch.bfloat16, device=device),
        biases=torch.zeros((out_f, G), dtype=torch.bfloat16, device=device),
        group_size=group_size, bits=bits)
    return prepare(qt, act_bits=act_bits, batched=batched)


def init_quantized_moe_params(generator: torch.Generator, hidden_size: int,
                              mcfg: MoEConfig, group_size: int = 64,
                              act_bits: Optional[int] = 8,
                              device=None, bits: int = 4,
                              scheme: str = "group",
                              gated_shared: int = 0) -> dict:
    """Random quantized MoE layer made directly in the packed layout (never
    the dense weights), with the ranges of ``base.init_quantized_params``:
    scheme="group", 4- or 8-bit codes uniform over their range, scales
    1/(sqrt(in) 2^(bits-1)), zero biases (stored folded as -8s at 4 bits);
    scheme="channel8", int8 codes uniform in [-127, 127] and scale
    in**-0.5 / 127 per (expert, row). A dense bf16 router gate, and the
    shared expert, as in ``init_moe_params`` (the
    shared expert's weights quantized by the same scheme:
    ``random_quantized_linear``)."""
    device = resolve_device(device)
    if scheme not in ("group", "channel8"):
        raise ValueError(f"scheme {scheme!r}")
    E, I, D = mcfg.num_experts, mcfg.moe_intermediate_size, hidden_size

    def packed(N, K):
        if scheme == "channel8":
            return ChannelQuantizedExperts(
                data=torch.randint(-127, 128, (E, N, K), generator=generator,
                                   device=device, dtype=torch.int8),
                scale=torch.full((E, N), (K ** -0.5) / 127.0,
                                 dtype=torch.float32, device=device))
        if bits not in (4, 8):
            raise NotImplementedError(f"{bits}-bit experts: 4 and 8 bits "
                                      f"are ported")
        lim = 1 << (bits - 1)
        s = torch.full((E, N, K // group_size), (K ** -0.5) / lim,
                       dtype=torch.bfloat16, device=device)
        if bits == 4:
            data = torch.randint(0, 256, (E, N, K // 2), generator=generator,
                                 device=device, dtype=torch.uint8)
            b = (-8.0 * s.float()).to(torch.bfloat16)
        else:
            data = torch.randint(-lim, lim, (E, N, K), generator=generator,
                                 device=device, dtype=torch.int8)
            b = torch.zeros_like(s)
        return PackedQuantizedExperts(
            data=data, scales=s, biases=b, group_size=group_size, bits=bits,
            in_features=K, act_bits=act_bits)

    def bf16_uniform(shape):
        u = torch.rand(shape, generator=generator, device=device) * 2 - 1
        return (u * D ** -0.5).to(torch.bfloat16)

    lp = {"gate": {"w": bf16_uniform((E, D))},
          "experts": {"gate_proj": packed(I, D), "up_proj": packed(I, D),
                      "down_proj": packed(D, I)}}
    _add_shared(lp, mcfg, D, lambda o, i: random_quantized_linear(
        generator, o, i, group_size, bits, act_bits, device, scheme),
        lambda: bf16_uniform((1, D)), gated_shared)
    return lp
