"""Masks and scaled dot-product attention with grouped KV heads
(counterpart of ominix_mlx_tpu/core/attention.py, same math)."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def causal_mask(q_len: int, kv_capacity: int, offset,
                window: Optional[int] = None,
                device=None) -> torch.Tensor:
    """Additive float32 mask for queries at absolute positions
    offset..offset+q_len over a KV buffer whose slot i holds position i
    (valid when i <= the query position). ``offset`` is an int ([q_len,
    kv_capacity] mask) or a [B] tensor of per-row offsets (continuous
    batching: a [B, q_len, kv_capacity] mask)."""
    if isinstance(offset, torch.Tensor):
        off = offset.to(device).long()
        q_pos = (off[:, None, None]
                 + torch.arange(q_len, device=device)[None, :, None])
        k_pos = torch.arange(kv_capacity, device=device)[None, None, :]
    else:
        q_pos = offset + torch.arange(q_len, device=device)[:, None]
        k_pos = torch.arange(kv_capacity, device=device)[None, :]
    ok = k_pos <= q_pos
    if window is not None:
        ok = ok & (k_pos > q_pos - window)
    return torch.where(ok, 0.0, NEG_INF).float()


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [B, H, T, D]; k, v: [B, Hkv, S, D]; mask: additive float32
    [T, S] or per-row [B, T, S]. Returns [B, H, T, D] in v's dtype."""
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    if H % Hkv:
        raise ValueError(f"{H} query heads, {Hkv} KV heads")
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, T, D)
    logits = torch.einsum("bhgtd,bhsd->bhgts", qg.float(), k.float()) * scale
    if mask is not None:
        if mask.ndim == 3:          # [B, T, S] per-sequence mask
            mask = mask[:, None, None]
        logits = logits + mask
    w = torch.softmax(logits, -1).to(v.dtype)
    out = torch.einsum("bhgts,bhsd->bhgtd", w, v)
    return out.reshape(B, H, T, v.shape[-1])
