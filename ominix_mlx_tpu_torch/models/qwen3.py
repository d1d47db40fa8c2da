"""Qwen3 dense (and Qwen2, via config) on the shared decoder in
models/base.py (counterpart of ominix_mlx_tpu/models/qwen3.py). Loading
checkpoints waits until weight and tokenizer files are available to the
port; the config mapping is here."""

from __future__ import annotations

from ominix_mlx_tpu_torch.models import base
from ominix_mlx_tpu_torch.models.base import (TransformerConfig, forward,
                                              init_cache)

__all__ = ["config_from_hf", "forward", "init_cache", "init_params"]


def config_from_hf(d: dict) -> TransformerConfig:
    return TransformerConfig.from_hf(d)


init_params = base.init_params
