"""KV caches: fixed capacity, preallocated once (counterpart of
ominix_mlx_tpu/core/cache.py). Layout [B, n_kv_heads, max_len, head_dim].

Unlike the JAX package, whose caches are immutable values, ``update``
writes into the preallocated buffers IN PLACE and returns the same object.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KVCache:
    """Per-layer fixed-capacity KV cache."""

    k: torch.Tensor  # [B, n_kv, max_len, head_dim]
    v: torch.Tensor

    @staticmethod
    def init(batch: int, n_kv: int, max_len: int, head_dim: int,
             dtype=torch.bfloat16, device=None) -> "KVCache":
        shape = (batch, n_kv, max_len, head_dim)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor,
               offset: int) -> "KVCache":
        """Write [B, n_kv, T, D] at positions offset..offset+T-1, in place.
        Raises if the write would run past capacity."""
        T = k_new.shape[2]
        if offset < 0 or offset + T > self.max_len:
            raise ValueError(f"KV write [{offset}, {offset + T}) outside "
                             f"capacity {self.max_len}")
        self.k[:, :, offset:offset + T] = k_new
        self.v[:, :, offset:offset + T] = v_new
        return self


@dataclasses.dataclass
class ModelCache:
    """Whole-model cache: per-layer caches and one shared offset (tokens
    processed so far, a host integer)."""

    layers: list
    offset: int = 0

    @staticmethod
    def init_dense(num_layers: int, batch: int, n_kv: int, max_len: int,
                   head_dim: int, dtype=torch.bfloat16,
                   device=None) -> "ModelCache":
        return ModelCache(
            layers=[KVCache.init(batch, n_kv, max_len, head_dim, dtype,
                                 device) for _ in range(num_layers)],
            offset=0)

    def advance(self, n: int) -> "ModelCache":
        return ModelCache(layers=self.layers, offset=self.offset + n)

    def with_layers(self, layers: list) -> "ModelCache":
        return ModelCache(layers=layers, offset=self.offset)
