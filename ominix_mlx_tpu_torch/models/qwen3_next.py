"""Qwen3-Next hybrid (counterpart of ominix_mlx_tpu/models/qwen3_next.py):
Gated DeltaNet linear-attention layers (``models.deltanet``) interleaved
with gated full-attention layers (QK-norm GQA, partial RoPE, the output
times sigmoid(g_proj)), each followed by a MoE with a gated shared
expert, on the shared decoder in models/base.py. ``forward`` and
``init_cache`` are base's (which builds the hybrid cache from
``cfg.layer_types``).

Checkpoints: HF names. The zero-centred RMSNorms get their +1 folded in
at load (the DeltaNet's gated norm is read as it is); HF's fused q_proj,
[query (hd), gate (hd)] per head, is split into q_proj and g_proj. Where
the JAX package splits the raw q_proj weight and stacks the experts by
their HF names (ominix_mlx_tpu/models/qwen3_next.py:97-110), so an
MLX-quantized checkpoint cannot load there, this port splits a quantized
q_proj by its rows (codes, scales and biases alike) and packs per-expert
quantized weights (``experts_from_quantized``); MLX's stacked
``switch_mlp`` names are read by neither.

``init_params`` and ``init_quantized_params`` make random trees (tests
and the smoke): unit norms (a folded checkpoint's are near 1), and
``A_log`` / ``dt_bias`` as HF initialises them, so that the decay stays
in (0, 1) and 48 random layers stay finite.
"""

from __future__ import annotations

import dataclasses

import torch

from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.core.quant import QuantizedTensor
from ominix_mlx_tpu_torch.models import base
from ominix_mlx_tpu_torch.models.base import (TransformerConfig, forward,
                                              init_cache)
from ominix_mlx_tpu_torch.models.deltanet import DeltaNetConfig
from ominix_mlx_tpu_torch.models.moe import EXPERT_NAMES, MoEConfig
from ominix_mlx_tpu_torch.ops.quant_matmul import experts_from_quantized
from ominix_mlx_tpu_torch.utils.loading import load_config, load_safetensors

__all__ = ["config_from_hf", "forward", "init_cache", "init_params",
           "init_quantized_params", "load_model", "params_from_flat"]


def config_from_hf(d: dict) -> TransformerConfig:
    """As the JAX package's (ominix_mlx_tpu/models/qwen3_next.py:25-47):
    its MoEConfig leaves ``n_shared_experts`` at 0 (the shared expert
    comes from the checkpoint; the random inits take its width,
    ``shared_expert_intermediate_size``, as an argument)."""
    cfg = TransformerConfig.from_hf(d)
    dn = DeltaNetConfig(
        num_v_heads=d["linear_num_value_heads"],
        num_k_heads=d["linear_num_key_heads"],
        head_k_dim=d["linear_key_head_dim"],
        head_v_dim=d["linear_value_head_dim"],
        conv_kernel=d.get("linear_conv_kernel_dim", 4),
        rms_norm_eps=d.get("rms_norm_eps", 1e-6))
    moe = MoEConfig(
        num_experts=d.get("num_experts", 512),
        top_k=d.get("num_experts_per_tok", 10),
        norm_topk_prob=d.get("norm_topk_prob", True),
        routing="softmax",
        moe_intermediate_size=d.get("moe_intermediate_size",
                                    d["intermediate_size"]),
        hidden_act=d.get("hidden_act", "silu"))
    layer_types = tuple(d.get("layer_types") or [
        "linear_attention" if (i + 1) % d.get("full_attention_interval", 4)
        else "full_attention" for i in range(cfg.num_layers)])
    return dataclasses.replace(
        cfg, deltanet=dn, moe=moe, use_qk_norm=True, layer_types=layer_types,
        partial_rotary_factor=d.get("partial_rotary_factor", 0.25))


def _split_fused_q(qw, num_heads: int, head_dim: int):
    """HF's q_proj packs each head as [query (hd), gate (hd)] rows: split
    it into (q_proj, g_proj) weights, a dense [2 H hd, D] tensor or an
    MLX ``QuantizedTensor`` (its codes, scales and biases by the same
    rows)."""
    def split(t):
        w = t.reshape(num_heads, 2 * head_dim, *t.shape[1:])
        return (w[:, :head_dim].reshape(-1, *t.shape[1:]).contiguous(),
                w[:, head_dim:].reshape(-1, *t.shape[1:]).contiguous())

    if isinstance(qw, QuantizedTensor):
        (q, g), (s, sg), (b, bg) = (split(t) for t in (qw.q, qw.scales,
                                                        qw.biases))
        return tuple(dataclasses.replace(qw, q=a, scales=sa, biases=ba)
                     for a, sa, ba in ((q, s, b), (g, sg, bg)))
    return split(qw)


def _moe_layer(flat: dict, p: str, cfg: TransformerConfig, qcfg,
               device) -> dict:
    def lin(name):
        return base._linear_params(flat, name, qcfg, device)

    def stack(name):
        parts = [base._maybe_quantized(flat, f"{p}.mlp.experts.{e}.{name}",
                                       qcfg, device)
                 for e in range(cfg.moe.num_experts)]
        if isinstance(parts[0], QuantizedTensor):
            return experts_from_quantized(parts)
        return torch.stack(parts)

    moe = {"gate": {"w": base._on(flat[f"{p}.mlp.gate.weight"], device)},
           "experts": {n: stack(n) for n in EXPERT_NAMES}}
    if f"{p}.mlp.shared_expert.gate_proj.weight" in flat \
            or f"{p}.mlp.shared_expert.gate_proj.scales" in flat:
        moe["shared_expert"] = {n: lin(f"{p}.mlp.shared_expert.{n}")
                                for n in EXPERT_NAMES}
        moe["shared_expert_gate"] = {"w": base._on(
            flat[f"{p}.mlp.shared_expert_gate.weight"], device)}
    return moe


def params_from_flat(flat: dict, cfg: TransformerConfig, d: dict,
                     qcfg=None, device=None) -> dict:
    """The tree from a flat {HF name: tensor} dict, each tensor moved to
    ``device`` where one is named (ominix_mlx_tpu/models/qwen3_next.py:
    58-127): the zero-centred norms folded (``w + 1``), the DeltaNet
    layers' "linear_attn" trees, the attention layers' q_proj split into
    q_proj and g_proj, and a MoE (experts stacked [E, N, K], router gate,
    shared expert and its gate) on every layer that
    ``decoder_sparse_step`` and ``mlp_only_layers`` make sparse; the
    others a dense MLP."""
    def t(name):
        return base._on(flat[name], device)

    def n1(name):
        return t(name) + 1.0

    def lin(name):
        return base._linear_params(flat, name, qcfg, device)

    params = {"embed": base._maybe_quantized(flat, "model.embed_tokens",
                                             qcfg, device),
              "norm": n1("model.norm.weight"), "layers": []}
    mlp_only = set(d.get("mlp_only_layers", []))
    step = d.get("decoder_sparse_step", 1)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        lp = {"input_layernorm": n1(f"{p}.input_layernorm.weight"),
              "post_attention_layernorm":
                  n1(f"{p}.post_attention_layernorm.weight")}
        if base.is_linear_layer(cfg, i):
            a = f"{p}.linear_attn"
            lp["linear_attn"] = {
                "in_proj_qkvz": lin(f"{a}.in_proj_qkvz"),
                "in_proj_ba": lin(f"{a}.in_proj_ba"),
                "conv1d": {"w": t(f"{a}.conv1d.weight")},
                "dt_bias": t(f"{a}.dt_bias"),
                "A_log": t(f"{a}.A_log"),
                "norm": t(f"{a}.norm.weight"),
                "out_proj": lin(f"{a}.out_proj")}
        else:
            s = f"{p}.self_attn"
            qw, gw = _split_fused_q(
                base._maybe_quantized(flat, f"{s}.q_proj", qcfg, device),
                cfg.num_heads, cfg.hd)
            lp["q_proj"] = {"w": qw}
            lp["g_proj"] = {"w": gw}
            for n in ("k_proj", "v_proj", "o_proj"):
                lp[n] = lin(f"{s}.{n}")
            lp["q_norm"] = n1(f"{s}.q_norm.weight")
            lp["k_norm"] = n1(f"{s}.k_norm.weight")
        sparse = not (i in mlp_only or (step > 0 and (i + 1) % step))
        if f"{p}.mlp.gate.weight" in flat and sparse:
            lp["moe"] = _moe_layer(flat, p, cfg, qcfg, device)
        else:
            for n in EXPERT_NAMES:
                lp[n] = lin(f"{p}.mlp.{n}")
        params["layers"].append(lp)
    if not cfg.tie_word_embeddings and "lm_head.weight" in flat:
        params["lm_head"] = lin("lm_head")
    return params


def load_model(model_dir: str, device=None):
    """A Qwen3-Next checkpoint directory -> (params, config), on
    ``device`` (default: the current CUDA device)."""
    device = resolve_device(device)
    raw = load_config(model_dir)
    cfg = config_from_hf(raw)
    return params_from_flat(load_safetensors(model_dir), cfg, raw,
                            raw.get("quantization"), device), cfg


def _require_hybrid(cfg: TransformerConfig):
    if cfg.deltanet is None or cfg.layer_types is None or cfg.moe is None:
        raise ValueError("a Qwen3-Next config needs cfg.deltanet, "
                         "cfg.layer_types and cfg.moe (config_from_hf)")


def init_params(cfg: TransformerConfig, generator, dtype=torch.bfloat16,
                device=None, shared_width=None) -> dict:
    """Random dense tree, every layer sparse (``base.init_params``) with
    a gated shared expert of ``shared_width`` (the checkpoint config's
    ``shared_expert_intermediate_size``; default the experts' width, as
    in Qwen3-Next-80B-A3B's config)."""
    _require_hybrid(cfg)
    return base.init_params(
        cfg, generator, dtype, device,
        gated_shared=shared_width or cfg.moe.moe_intermediate_size)


def init_quantized_params(cfg: TransformerConfig, generator, group_size=64,
                          bits=4, act_bits=8, device=None,
                          shared_width=None) -> dict:
    """Random quantized tree made packed, every layer sparse
    (``base.init_quantized_params``), ``shared_width`` as in
    ``init_params``: the experts straight into
    ``PackedQuantizedExperts`` (162 GB in bf16 at Qwen3-Next-80B-A3B's
    size, about 45 GB at 4 bits), every projection of the attention and
    DeltaNet layers and the shared expert quantized, the router and
    shared-expert gates, the conv taps and the norms bf16."""
    _require_hybrid(cfg)
    return base.init_quantized_params(
        cfg, generator, group_size, bits, act_bits, device=device,
        gated_shared=shared_width or cfg.moe.moe_intermediate_size)
