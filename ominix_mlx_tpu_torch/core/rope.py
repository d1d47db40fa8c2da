"""Rotary position embeddings (counterpart of ominix_mlx_tpu/core/rope.py):
default RoPE with ``theta``, linear scaling, partial rotary dims, and the
interleaved-pair ("traditional") or half-split conventions."""

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
        elif rtype not in (None, "default"):
            raise NotImplementedError(f"rope scaling {rtype!r}")
    return RopeConfig(dims=dims, theta=theta, scale=scale,
                      traditional=traditional)


def _angles(positions: torch.Tensor, dims: int, theta: float, scale: float):
    half = dims // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=positions.device)
        * (math.log(theta) / half))
    ang = positions.float()[..., None] * scale * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: RopeConfig) -> torch.Tensor:
    """x: [..., T, head_dim]; positions: [T] absolute positions. Only the
    first ``cfg.dims`` dims rotate."""
    dims = cfg.dims
    dtype = x.dtype
    rot, rest = x[..., :dims], x[..., dims:]
    cos, sin = _angles(positions, dims, cfg.theta, cfg.scale)
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
