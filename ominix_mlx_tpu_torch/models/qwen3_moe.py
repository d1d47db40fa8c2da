"""Qwen3-MoE (counterpart of ominix_mlx_tpu/models/qwen3_moe.py): QK-norm
GQA attention and a SwiGLU MoE with softmax-then-top-k routing and
``norm_topk_prob``, stacked expert weights, on the shared decoder in
models/base.py. ``params_from_flat`` and ``load_model`` read a checkpoint
whose sparse layers (``moe_layer_indices``) may be mixed with dense ones;
the loaded experts are dense stacks, which ``base.quantize_params`` packs.

The random inits give every layer its own expert weights (the JAX
package's ``init_params`` reuses one key, so there every layer's experts
are the same); tests that compare the two carry the JAX weights across
with ``utils.params.params_from_numpy``."""

from __future__ import annotations

import dataclasses

import torch

from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.models import base
from ominix_mlx_tpu_torch.models.base import (TransformerConfig, forward,
                                              init_cache)
from ominix_mlx_tpu_torch.models.moe import EXPERT_NAMES, MoEConfig
from ominix_mlx_tpu_torch.utils.loading import load_config, load_safetensors

__all__ = ["config_from_hf", "forward", "init_cache", "init_params",
           "init_quantized_params", "load_model", "moe_layer_indices",
           "params_from_flat"]


def config_from_hf(d: dict) -> TransformerConfig:
    cfg = TransformerConfig.from_hf(d)
    moe = MoEConfig(
        num_experts=d.get("num_experts", d.get("num_local_experts", 8)),
        top_k=d.get("num_experts_per_tok", 2),
        norm_topk_prob=d.get("norm_topk_prob", False),
        routing="softmax",
        moe_intermediate_size=d.get("moe_intermediate_size",
                                    d["intermediate_size"]),
        hidden_act=d.get("hidden_act", "silu"),
    )
    return dataclasses.replace(cfg, moe=moe)


def moe_layer_indices(d: dict) -> list:
    """Which layers are sparse (decoder_sparse_step / mlp_only_layers)."""
    n = d["num_hidden_layers"]
    step = d.get("decoder_sparse_step", 1)
    mlp_only = set(d.get("mlp_only_layers", []))
    return [i for i in range(n)
            if step > 0 and (i + 1) % step == 0 and i not in mlp_only]


def params_from_flat(flat: dict, cfg: TransformerConfig, d: dict,
                     qcfg=None, device=None) -> dict:
    """The tree from a flat {HF name: tensor} dict: ``base.params_from_flat``
    (attention, and a dense MLP where the layer has one), then each sparse
    layer's experts stacked [E, N, K] (dense), its router gate, and a
    shared expert (Qwen2-MoE) where the checkpoint has one."""
    def t(name):
        return base._on(flat[name], device)

    params = base.params_from_flat(flat, cfg, qcfg, device)
    for i in moe_layer_indices(d):
        p = f"model.layers.{i}"
        experts = {n: torch.stack([
            t(f"{p}.mlp.experts.{e}.{n}.weight")
            for e in range(cfg.moe.num_experts)]) for n in EXPERT_NAMES}
        moe = {"gate": {"w": t(f"{p}.mlp.gate.weight")}, "experts": experts}
        if f"{p}.mlp.shared_expert.gate_proj.weight" in flat:
            moe["shared_expert"] = {
                n: {"w": t(f"{p}.mlp.shared_expert.{n}.weight")}
                for n in EXPERT_NAMES}
            moe["shared_expert_gate"] = {
                "w": t(f"{p}.mlp.shared_expert_gate.weight")}
        params["layers"][i]["moe"] = moe
    return params


def load_model(model_dir: str, device=None):
    """A Qwen3-MoE / Qwen2-MoE checkpoint directory -> (params, config),
    on ``device`` (default: the current CUDA device)."""
    device = resolve_device(device)
    raw = load_config(model_dir)
    cfg = config_from_hf(raw)
    return params_from_flat(load_safetensors(model_dir), cfg, raw,
                            raw.get("quantization"), device), cfg


def _require_moe(cfg: TransformerConfig):
    if cfg.moe is None:
        raise ValueError("a Qwen3-MoE config needs cfg.moe (config_from_hf)")


def init_params(cfg: TransformerConfig, generator, dtype=torch.bfloat16,
                device=None) -> dict:
    """Random dense tree, every layer sparse (``base.init_params``)."""
    _require_moe(cfg)
    return base.init_params(cfg, generator, dtype, device)


def init_quantized_params(cfg: TransformerConfig, generator, group_size=64,
                          bits=4, act_bits=8, device=None,
                          scheme="group") -> dict:
    """Random quantized tree made packed, every layer sparse: 4- or 8-bit
    group experts straight into ``PackedQuantizedExperts``, or
    scheme="channel8" ones into ``ChannelQuantizedExperts``, never the
    dense weights (61 GB in bf16 at Qwen3-30B-A3B's size)."""
    _require_moe(cfg)
    return base.init_quantized_params(cfg, generator, group_size, bits,
                                      act_bits, device=device, scheme=scheme)
