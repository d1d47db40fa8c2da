"""Mixtral 8x7B / 8x22B (counterpart of ominix_mlx_tpu/models/mixtral.py):
the base GQA decoder whose every layer is a MoE layer, top-2 of 8 experts
by softmax over the router's scores then renormalised over the two
(``norm_topk_prob``), SwiGLU experts. HF checkpoints name the experts
``block_sparse_moe.experts.{e}.w1`` (gate), ``w3`` (up) and ``w2``
(down); the loaded experts are dense stacks [E, N, K], which
``base.quantize_params`` packs."""

from __future__ import annotations

import dataclasses

import torch

from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.models import base
from ominix_mlx_tpu_torch.models.base import TransformerConfig
from ominix_mlx_tpu_torch.models.moe import MoEConfig
from ominix_mlx_tpu_torch.utils.loading import load_config, load_safetensors

__all__ = ["config_from_hf", "forward", "init_cache", "load_model",
           "params_from_flat"]

# HF expert name -> the port's
_W = {"w1": "gate_proj", "w3": "up_proj", "w2": "down_proj"}


def config_from_hf(d: dict) -> TransformerConfig:
    cfg = TransformerConfig.from_hf(d)
    moe = MoEConfig(
        num_experts=d.get("num_local_experts", 8),
        top_k=d.get("num_experts_per_tok", 2),
        norm_topk_prob=True,        # HF divides by the top-k sum
        routing="softmax",
        moe_intermediate_size=d["intermediate_size"],
        hidden_act=d.get("hidden_act", "silu"),
    )
    return dataclasses.replace(cfg, moe=moe)


def params_from_flat(flat: dict, cfg: TransformerConfig, qcfg=None,
                     device=None) -> dict:
    """The tree from a flat {HF name: tensor} dict: ``base.params_from_flat``
    (attention, norms, embedding, lm_head), then each layer's router gate
    and experts stacked [E, N, K]."""
    def t(name):
        return base._on(flat[name], device)

    params = base.params_from_flat(flat, cfg, qcfg, device)
    for i, lp in enumerate(params["layers"]):
        p = f"model.layers.{i}.block_sparse_moe"
        lp["moe"] = {
            "gate": {"w": t(f"{p}.gate.weight")},
            "experts": {ours: torch.stack([
                t(f"{p}.experts.{e}.{hf}.weight")
                for e in range(cfg.moe.num_experts)])
                for hf, ours in _W.items()}}
    return params


def load_model(model_dir: str, device=None):
    """A checkpoint directory -> (params, config), on ``device`` (default:
    the current CUDA device)."""
    device = resolve_device(device)
    raw = load_config(model_dir)
    cfg = config_from_hf(raw)
    return params_from_flat(load_safetensors(model_dir), cfg,
                            raw.get("quantization"), device), cfg


forward = base.forward
init_cache = base.init_cache
