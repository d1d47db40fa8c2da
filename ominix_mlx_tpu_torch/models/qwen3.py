"""Qwen3 dense (and Qwen2, via config) on the shared decoder in
models/base.py (counterpart of ominix_mlx_tpu/models/qwen3.py): the config
mapping and ``load_model`` from a checkpoint directory (HF float or
MLX-quantized safetensors)."""

from __future__ import annotations

from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.models import base
from ominix_mlx_tpu_torch.models.base import (TransformerConfig, forward,
                                              init_cache)
from ominix_mlx_tpu_torch.utils.loading import load_config, load_safetensors

__all__ = ["config_from_hf", "forward", "init_cache", "init_params",
           "load_model"]


def config_from_hf(d: dict) -> TransformerConfig:
    return TransformerConfig.from_hf(d)


def load_model(model_dir: str, device=None):
    """A Qwen3 / Qwen2 checkpoint directory -> (params, config), the
    tensors on ``device`` (default: the current CUDA device; raises
    without a card)."""
    device = resolve_device(device)
    raw = load_config(model_dir)
    cfg = config_from_hf(raw)
    params = base.params_from_flat(load_safetensors(model_dir), cfg,
                                   raw.get("quantization"), device)
    return params, cfg


init_params = base.init_params
