"""Rotary position embeddings (counterpart of ominix_mlx_tpu/core/rope.py):
default RoPE with ``theta``, linear scaling, partial rotary dims, and the
interleaved-pair ("traditional") or half-split conventions.

As in the JAX package's ``make_rope``, every scaling type but "linear"
(yarn, llama3, ...) resolves to the default frequencies: a DeepSeek
config's yarn scaling enters only through MLA's softmax scale
(``models.mla.MLAConfig.scale``)."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class RopeConfig:
    dims: int                      # number of rotated dims (<= head_dim)
    theta: float = 10000.0
    scale: float = 1.0             # linear scaling: position * 1/factor
    traditional: bool = False      # True: interleaved pairs; False: half-split


def make_rope(head_dim: int, theta: float = 10000.0,
              rope_scaling: Optional[dict] = None,
              partial_rotary_factor: float = 1.0,
              traditional: bool = False) -> RopeConfig:
    dims = int(head_dim * partial_rotary_factor)
    scale = 1.0
    if rope_scaling:
        rtype = rope_scaling.get("type") or rope_scaling.get("rope_type")
        if rtype == "linear":
            scale = 1.0 / float(rope_scaling["factor"])
    return RopeConfig(dims=dims, theta=theta, scale=scale,
                      traditional=traditional)


def positions_of(offset, T: int, device) -> torch.Tensor:
    """Absolute positions [T] of T tokens at an int offset, or [B, T] at
    per-row offsets (a [B] tensor: continuous batching)."""
    ar = torch.arange(T, device=device)
    if isinstance(offset, torch.Tensor):
        return offset.to(device).long()[:, None] + ar
    return offset + ar


def _angles(positions: torch.Tensor, dims: int, theta: float, scale: float):
    half = dims // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=positions.device)
        * (math.log(theta) / half))
    ang = positions.float()[..., None] * scale * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: RopeConfig) -> torch.Tensor:
    """x: [..., T, head_dim]; positions: [T] absolute positions, or [B, T]
    per-row positions for x [B, H, T, head_dim] (continuous batching).
    Only the first ``cfg.dims`` dims rotate."""
    dims = cfg.dims
    dtype = x.dtype
    rot, rest = x[..., :dims], x[..., dims:]
    cos, sin = _angles(positions, dims, cfg.theta, cfg.scale)
    if positions.ndim == 2 and rot.ndim >= 3:
        while cos.ndim < rot.ndim:      # keep B on axis 0, broadcast heads
            cos, sin = cos[:, None], sin[:, None]
    rot = rot.float()
    if cfg.traditional:
        x1, x2 = rot[..., 0::2], rot[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          -1).reshape(rot.shape)
    else:
        half = dims // 2
        x1, x2 = rot[..., :half], rot[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    out = out.to(dtype)
    if rest.shape[-1]:
        out = torch.cat([out, rest], -1)
    return out
