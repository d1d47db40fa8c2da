"""GLM-4-MoE (GLM-4.5 / 4.6; counterpart of
ominix_mlx_tpu/models/glm4_moe.py): the base GQA decoder with q/k/v
biases, partial rotary (half of each head's dims, half-split convention),
``first_k_dense_replace`` dense layers first, then MoE layers routed by
sigmoid scores plus ``e_score_correction_bias`` with group-limited top-k,
each with a shared expert. The loaded experts are dense stacks [E, N, K],
which ``base.quantize_params`` packs."""

from __future__ import annotations

import dataclasses

import torch

from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.models import base
from ominix_mlx_tpu_torch.models.base import TransformerConfig
from ominix_mlx_tpu_torch.models.moe import EXPERT_NAMES, MoEConfig
from ominix_mlx_tpu_torch.utils.loading import load_config, load_safetensors

__all__ = ["config_from_hf", "forward", "init_cache", "load_model",
           "moe_from_flat", "params_from_flat"]


def config_from_hf(d: dict) -> TransformerConfig:
    cfg = TransformerConfig.from_hf(d)
    moe = MoEConfig(
        num_experts=d.get("n_routed_experts", 128),
        top_k=d.get("num_experts_per_tok", 8),
        norm_topk_prob=d.get("norm_topk_prob", True),
        routing="sigmoid",
        routed_scaling_factor=d.get("routed_scaling_factor", 1.0),
        n_shared_experts=d.get("n_shared_experts", 1),
        moe_intermediate_size=d.get("moe_intermediate_size", 1408),
        hidden_act=d.get("hidden_act", "silu"),
        n_group=d.get("n_group", 1),
        topk_group=d.get("topk_group", 1),
    )
    return dataclasses.replace(
        cfg, moe=moe,
        partial_rotary_factor=d.get("partial_rotary_factor", 0.5),
        rope_traditional=False,     # rotate-half, as HF's modeling
        use_qk_norm=d.get("use_qk_norm", False),
        attention_bias=d.get("attention_bias", False))


def moe_from_flat(flat: dict, p: str, num_experts: int, device=None) -> dict:
    """The MoE layer under ``p`` (``model.layers.{i}.mlp``): router gate,
    ``e_score_correction_bias``, experts stacked [E, N, K] and the shared
    expert (GLM-4-MoE's and DeepSeek's names). A checkpoint without the
    correction bias raises KeyError, as in the JAX package."""
    def t(name):
        return base._on(flat[name], device)

    return {
        "gate": {"w": t(f"{p}.gate.weight")},
        "e_score_correction_bias": t(f"{p}.gate.e_score_correction_bias"),
        "experts": {n: torch.stack([t(f"{p}.experts.{e}.{n}.weight")
                                    for e in range(num_experts)])
                    for n in EXPERT_NAMES},
        "shared_expert": {n: {"w": t(f"{p}.shared_experts.{n}.weight")}
                          for n in EXPERT_NAMES}}


def params_from_flat(flat: dict, cfg: TransformerConfig, d: dict,
                     qcfg=None, device=None) -> dict:
    """The tree from a flat {HF name: tensor} dict: ``base.params_from_flat``
    (attention with its biases, q/k norms where the config has them, the
    dense MLP of the first ``first_k_dense_replace`` layers), then every
    later layer's MoE (``moe_from_flat``)."""
    params = base.params_from_flat(flat, cfg, qcfg, device)
    first_dense = d.get("first_k_dense_replace", 1)
    for i in range(first_dense, cfg.num_layers):
        params["layers"][i]["moe"] = moe_from_flat(
            flat, f"model.layers.{i}.mlp", cfg.moe.num_experts, device)
    return params


def load_model(model_dir: str, device=None):
    """A checkpoint directory -> (params, config), on ``device`` (default:
    the current CUDA device)."""
    device = resolve_device(device)
    raw = load_config(model_dir)
    cfg = config_from_hf(raw)
    return params_from_flat(load_safetensors(model_dir), cfg, raw,
                            raw.get("quantization"), device), cfg


forward = base.forward
init_cache = base.init_cache
