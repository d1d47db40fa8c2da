"""GLM-4 dense (9B): the base decoder with partial, interleaved-pair RoPE
(the first half of each head's dims), q/k/v biases and sandwich norms
(``post_self_attn_layernorm`` on the attention output and
``post_mlp_layernorm`` on the MLP output); HF checkpoints carry the MLP's
gate and up projections fused as ``gate_up_proj`` (counterpart of
ominix_mlx_tpu/models/glm4.py)."""

from __future__ import annotations

import dataclasses

from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.models import base
from ominix_mlx_tpu_torch.models.base import TransformerConfig
from ominix_mlx_tpu_torch.utils.loading import load_config, load_safetensors

__all__ = ["config_from_hf", "forward", "init_cache", "load_model",
           "params_from_flat"]


def config_from_hf(d: dict) -> TransformerConfig:
    cfg = TransformerConfig.from_hf(d)
    return dataclasses.replace(
        cfg,
        partial_rotary_factor=d.get("partial_rotary_factor", 0.5),
        attention_bias=d.get("attention_bias", True),
        rope_traditional=True)     # GLM's rotary pairs are interleaved


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
params_from_flat = base.params_from_flat   # sandwich norms, gate_up_proj
