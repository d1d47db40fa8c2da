"""InfLLMv2 block-sparse attention, MiniCPM-SALA's long-context layers
(counterpart of ominix_mlx_tpu/models/sparse_attention.py): mean-pooled
compressed keys over the middle of the cache, a per-KV-head top-k of
blocks, then attention over [init blocks + selected blocks + sliding
window] at decode.

``SparseKVCache`` keeps the full history and its pooled keys, written IN
PLACE (the JAX package's caches are values): an append re-pools only the
blocks it touches. ``sparse_decode_attention`` scores the blocks and takes
their top k (``ops.sparse_attention.block_select``: kernel K11's selector
on CUDA) and attends the gathered set
(``ops.sparse_attention.sparse_attend``: K11's attend on CUDA, reading K
and V in place). Its slot set has the JAX package's static length init +
topk * ks + window, the invalid slots masked, so a short context is exact
dense attention and a long one InfLLMv2.
"""

from __future__ import annotations

import dataclasses

import torch

from ominix_mlx_tpu_torch.core.cache import KVCache, Offset
from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.ops import sparse_attention as sa


@dataclasses.dataclass(frozen=True)
class SparseConfig:
    """Copied from ominix_mlx_tpu/models/sparse_attention.py:32-41 (the
    production config; ``dense_len`` is read by neither package)."""
    kernel_size: int = 32          # compression block size (tokens)
    block_size: int = 64           # init block granularity
    init_blocks: int = 1
    window_size: int = 2048
    topk: int = 64
    dense_len: int = 8192

    @property
    def init_end(self) -> int:
        return self.init_blocks * self.block_size


def compress_keys(keys: torch.Tensor, ks: int) -> torch.Tensor:
    """Mean-pool non-overlapping windows: [B, H, S, D] -> [B, H, S // ks,
    D], summed in float32 and cast back (as jnp.mean of a bf16 array)."""
    B, H, S, D = keys.shape
    nb = S // ks
    pooled = keys[:, :, :nb * ks].reshape(B, H, nb, ks, D).float().mean(3)
    return pooled.to(keys.dtype)


@dataclasses.dataclass
class SparseKVCache:
    """Full-history KV cache with its mean-pooled keys maintained on
    append (ominix_mlx_tpu/models/sparse_attention.py:52-128): only the
    block(s) the appended tokens touch are re-pooled, O(kernel_size) a
    decode step whatever the context."""

    k: torch.Tensor       # [B, Hkv, S, D]
    v: torch.Tensor       # [B, Hkv, S, D]
    comp: torch.Tensor    # [B, Hkv, S // ks, D]
    kernel_size: int = 32

    @staticmethod
    def init(batch: int, n_kv: int, max_len: int, head_dim: int,
             dtype=torch.bfloat16, kernel_size: int = 32,
             device=None) -> "SparseKVCache":
        """Zeroed buffers on ``device`` (default: the current CUDA
        device)."""
        device = resolve_device(device)
        shape = (batch, n_kv, max_len, head_dim)
        return SparseKVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            comp=torch.zeros(batch, n_kv, max_len // kernel_size, head_dim,
                             dtype=dtype, device=device),
            kernel_size=kernel_size)

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def rows(self, b: int) -> "SparseKVCache":
        """Row b as views: writes through them land in this cache."""
        return SparseKVCache(k=self.k[b:b + 1], v=self.v[b:b + 1],
                             comp=self.comp[b:b + 1],
                             kernel_size=self.kernel_size)

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor,
               offset: Offset) -> "SparseKVCache":
        """Write [B, Hkv, T, D] at ``offset`` (an int, or per-row [B]) in
        place and re-pool the touched blocks. An int offset raises past
        capacity; per-row positions clamp to the cache, as the JAX
        package's scatter does. Blocks holding stale slots past a row's
        length are re-pooled again as later tokens land in them, and the
        block mask of ``sparse_decode_attention`` hides them until then."""
        ks = self.kernel_size
        B, Hkv, T, D = k_new.shape
        S, nb = self.max_len, self.comp.shape[2]
        # T tokens starting anywhere in a block span at most
        # ceil((T - 1) / ks) + 1 blocks
        nblk = min((T + ks - 2) // ks + 1, nb)
        if not isinstance(offset, torch.Tensor):
            KVCache(k=self.k, v=self.v).update(k_new, v_new, offset)
            first = min(offset // ks, nb - nblk)
            lo, hi = first * ks, (first + nblk) * ks
            self.comp[:, :, first:first + nblk] = compress_keys(
                self.k[:, :, lo:hi], ks)
            return self
        dev = self.k.device
        off = offset.to(dev).long()
        rows = torch.arange(B, device=dev)[:, None]
        pos = (off[:, None] + torch.arange(T, device=dev)).clamp(0, S - 1)
        self.k[rows, :, pos] = k_new.permute(0, 2, 1, 3).to(self.k.dtype)
        self.v[rows, :, pos] = v_new.permute(0, 2, 1, 3).to(self.v.dtype)
        first = torch.clamp(off // ks, max=nb - nblk)                  # [B]
        tok = (first[:, None] * ks
               + torch.arange(nblk * ks, device=dev)).clamp(0, S - 1)
        region = self.k[rows, :, tok]                      # [B, T', Hkv, D]
        pooled = compress_keys(region.permute(0, 2, 1, 3), ks)
        blk = first[:, None] + torch.arange(nblk, device=dev)
        self.comp[rows, :, blk] = pooled.permute(0, 2, 1, 3)
        return self


def decode_totals(offset: Offset, B: int, device) -> torch.Tensor:
    """Each row's token count including this step's, [B] int32 on
    ``device``."""
    if isinstance(offset, torch.Tensor):
        return (offset.to(device) + 1).to(torch.int32)
    return torch.full((B,), offset + 1, dtype=torch.int32, device=device)


def sparse_decode_attention(q: torch.Tensor, cache, offset: Offset,
                            scfg: SparseConfig, scale: float) -> torch.Tensor:
    """q [B, H, 1, D], one decode step over the full-history cache ->
    [B, H, 1, D] in the cache's type (ominix_mlx_tpu/models/
    sparse_attention.py:131-197). cache: a ``SparseKVCache`` or a plain
    ``core.cache.KVCache`` (its pooled keys recomputed: tests only). The
    block scores read only the first query head of each KV group, and the
    tokens between the last whole block and the window start are never
    attended, as in the JAX package."""
    B = q.shape[0]
    ks = scfg.kernel_size
    total = decode_totals(offset, B, q.device)
    if isinstance(cache, SparseKVCache) and cache.kernel_size == ks:
        comp = cache.comp
    else:
        comp = compress_keys(cache.k, ks)
    top_scores, top_idx = sa.block_select(
        q, comp, total, scfg.init_end, scfg.window_size, ks,
        min(scfg.topk, comp.shape[2]))
    return sa.sparse_attend(q, cache.k, cache.v, top_idx, top_scores, total,
                            scfg.init_end, scfg.window_size, ks, scale)
