"""Mistral 7B: the base GQA decoder with an optional sliding window
(counterpart of ominix_mlx_tpu/models/mistral.py). The window reaches
every attention branch: the masked ``sdpa`` off the card, K2 and K2c
(flash prefill and its continuation chunks) and K3 (paged decode) on it.
"""

from __future__ import annotations

import dataclasses

from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.models import base
from ominix_mlx_tpu_torch.models.base import TransformerConfig
from ominix_mlx_tpu_torch.utils.loading import load_config, load_safetensors

__all__ = ["config_from_hf", "forward", "init_cache", "init_params",
           "load_model"]


def config_from_hf(d: dict) -> TransformerConfig:
    """As ``TransformerConfig.from_hf``; a ``sliding_window`` in the config
    is taken whether or not ``use_sliding_window`` is set (Mistral's
    configs carry no such flag)."""
    cfg = TransformerConfig.from_hf(d)
    if d.get("sliding_window"):
        cfg = dataclasses.replace(cfg, sliding_window=d["sliding_window"])
    return cfg


def load_model(model_dir: str, device=None):
    """A checkpoint directory -> (params, config), on ``device`` (default:
    the current CUDA device)."""
    device = resolve_device(device)
    raw = load_config(model_dir)
    cfg = config_from_hf(raw)
    return base.params_from_flat(load_safetensors(model_dir), cfg,
                                 raw.get("quantization"), device), cfg


forward = base.forward
init_cache = base.init_cache
init_params = base.init_params
