"""KV caches: fixed capacity, preallocated once (counterpart of
ominix_mlx_tpu/core/cache.py). Layout [B, n_kv_heads, max_len, head_dim];
v may be narrower than k (MLA's latent cache: k [B, 1, L, Ckv + rope], v
[B, 1, L, Ckv], ``models.mla.init_cache_layer``).

Unlike the JAX package, whose caches are immutable values, ``update``
writes into the preallocated buffers IN PLACE and returns the same object.
The offset is a host int (one position for every row) or a [B] long tensor
of per-row offsets on the cache's device (continuous batching), with the
JAX package's semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ominix_mlx_tpu_torch.core.device import resolve_device

Offset = Union[int, torch.Tensor]


@dataclasses.dataclass
class KVCache:
    """Per-layer fixed-capacity KV cache."""

    k: torch.Tensor  # [B, n_kv, max_len, head_dim]
    v: torch.Tensor  # [B, n_kv, max_len, v_dim]

    @staticmethod
    def init(batch: int, n_kv: int, max_len: int, head_dim: int,
             dtype=torch.bfloat16, device=None,
             v_dim: Optional[int] = None) -> "KVCache":
        """Zeroed buffers on ``device`` (default: the current CUDA
        device; see ``core.device.resolve_device``); v is ``v_dim`` wide
        (default: ``head_dim``)."""
        device = resolve_device(device)
        shape = (batch, n_kv, max_len, head_dim)
        vshape = shape[:3] + (v_dim or head_dim,)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(vshape, dtype=dtype, device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor,
               offset: Offset) -> "KVCache":
        """Write k [B, n_kv, T, D] and v [B, n_kv, T, Dv] at positions
        offset..offset+T-1, in place.

        An int offset raises if the write would run past capacity. A [B]
        tensor writes each row at its own offset without a host sync; as
        ``lax.dynamic_update_slice`` does in the JAX package, a row's start
        is clamped to [0, max_len - T], so callers check capacity against
        a host mirror of the offsets (the batcher's ``off_host``)."""
        T = k_new.shape[2]
        if not isinstance(offset, torch.Tensor):
            if offset < 0 or offset + T > self.max_len:
                raise ValueError(f"KV write [{offset}, {offset + T}) outside "
                                 f"capacity {self.max_len}")
            self.k[:, :, offset:offset + T] = k_new
            self.v[:, :, offset:offset + T] = v_new
            return self
        B = k_new.shape[0]
        start = offset.to(self.k.device).long().clamp(0, self.max_len - T)
        rows = torch.arange(B, device=self.k.device)[:, None]
        cols = start[:, None] + torch.arange(T, device=self.k.device)
        # k[b, :, cols[b, t]] <- k_new[b, :, t]  (advanced dims lead: [B, T])
        self.k[rows, :, cols] = k_new.permute(0, 2, 1, 3).to(self.k.dtype)
        self.v[rows, :, cols] = v_new.permute(0, 2, 1, 3).to(self.v.dtype)
        return self


def ingests_padding(layer_cache) -> bool:
    """True for recurrent-state layer caches (``models.deltanet.
    RecurrentCache``): every position feeds the state, so padded prefill
    buckets or chunks would corrupt it and prefill must run exact
    lengths. Positional KV caches (dense, paged) expose ``max_len`` and
    mask padding by offset. Copied from ominix_mlx_tpu/core/cache.py:118-
    133 (the port has no ``RotatingKVCache``, the one positional cache
    there without ``max_len``); the engine's bucketing, chunked prefill's
    widths and the batcher's adoption consult it."""
    return not hasattr(layer_cache, "max_len")


@dataclasses.dataclass
class ModelCache:
    """Whole-model cache: per-layer caches and one offset: tokens processed
    so far, a host int or a [B] long tensor of per-row offsets."""

    layers: list
    offset: Offset = 0

    @staticmethod
    def init_dense(num_layers: int, batch: int, n_kv: int, max_len: int,
                   head_dim: int, dtype=torch.bfloat16,
                   device=None) -> "ModelCache":
        device = resolve_device(device)
        return ModelCache(
            layers=[KVCache.init(batch, n_kv, max_len, head_dim, dtype,
                                 device) for _ in range(num_layers)],
            offset=0)

    def advance(self, n: int) -> "ModelCache":
        return ModelCache(layers=self.layers, offset=self.offset + n)

    def with_layers(self, layers: list) -> "ModelCache":
        return ModelCache(layers=layers, offset=self.offset)
