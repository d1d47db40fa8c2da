"""Paged KV cache: a shared page pool and per-sequence page tables
(counterpart of ominix_mlx_tpu/core/paged_cache.py).

Pool layout (the port's own): k_pool and v_pool [P, n_kv, page_size, D],
so one page of one KV head is a contiguous [page_size, D] block that the
decode kernel K3 (ops/paged_attention.py) reads with coalesced loads. The
TPU package stores K pages transposed ([n_kv, P, D, page_size]) for its
DMA alignment; parity between the two is held on the logical views ``.k``
and ``.v`` and on what attention computes, not on the pools.

Unlike the JAX package, ``update`` writes into the pools IN PLACE and
returns the same object. ``PageAllocator`` and ``PrefixCache`` are host
Python, copied from ominix_mlx_tpu/core/paged_cache.py:166-318 (importing
that module would load jax).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import List, Optional

import torch

from ominix_mlx_tpu_torch.core.quant import over_127


@dataclasses.dataclass
class PagedKVCache:
    """Per-layer paged cache presenting the KVCache interface (update, .k,
    .v, max_len) so models.base attention consumes it unchanged."""

    k_pool: torch.Tensor       # [P, n_kv, page_size, D]
    v_pool: torch.Tensor       # [P, n_kv, page_size, D]
    page_table: torch.Tensor   # [B, max_pages] int32 physical page ids
    # int8 KV mode: pools hold int8 codes with per-(page, head, token)
    # symmetric scales. None -> bf16 / float pools.
    k_scale: Optional[torch.Tensor] = None   # f32 [P, n_kv, page_size]
    v_scale: Optional[torch.Tensor] = None

    @staticmethod
    def init(batch: int, n_kv: int, num_pages: int, page_size: int,
             head_dim: int, max_pages: int, dtype=torch.bfloat16,
             page_table: Optional[torch.Tensor] = None,
             quantized: bool = False, device=None) -> "PagedKVCache":
        if page_table is None:
            page_table = torch.zeros((batch, max_pages), dtype=torch.int32,
                                     device=device)
        shape = (num_pages, n_kv, page_size, head_dim)
        if quantized:
            sshape = (num_pages, n_kv, page_size)
            return PagedKVCache(
                k_pool=torch.zeros(shape, dtype=torch.int8, device=device),
                v_pool=torch.zeros(shape, dtype=torch.int8, device=device),
                page_table=page_table,
                k_scale=torch.zeros(sshape, dtype=torch.float32,
                                    device=device),
                v_scale=torch.zeros(sshape, dtype=torch.float32,
                                    device=device))
        return PagedKVCache(
            k_pool=torch.zeros(shape, dtype=dtype, device=device),
            v_pool=torch.zeros(shape, dtype=dtype, device=device),
            page_table=page_table)

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def page_size(self) -> int:
        return self.k_pool.shape[2]

    @property
    def max_len(self) -> int:
        """Logical per-sequence capacity (the dense-view length)."""
        return self.page_table.shape[1] * self.page_size

    @property
    def k(self) -> torch.Tensor:
        """Logical keys [B, n_kv, max_len, D] (a gathered copy; int8 pages
        dequantized to bf16)."""
        return gather_pages(self.k_pool, self.page_table, self.k_scale)

    @property
    def v(self) -> torch.Tensor:
        return gather_pages(self.v_pool, self.page_table, self.v_scale)

    def update(self, k_new: torch.Tensor, v_new: torch.Tensor,
               offset) -> "PagedKVCache":
        """Write [B, n_kv, T, D] at logical position ``offset`` (int or a
        [B] tensor) through the page table, IN PLACE. Positions past a
        row's allocated pages land in that row's table entries verbatim
        (the allocator extends the table first); positions past the table
        WIDTH (capacity) go to the null page 0, as in the JAX package (a
        clipped index would corrupt the row's last real page). No host
        sync: offsets may stay on the device."""
        B, n_kv, T, d = k_new.shape
        ps = self.page_size
        dev = self.k_pool.device
        ar = torch.arange(T, device=dev)
        if isinstance(offset, torch.Tensor):
            pos = offset.to(dev).long()[:, None] + ar[None, :]      # [B, T]
        else:
            pos = (int(offset) + ar)[None, :].expand(B, T)
        mp = self.page_table.shape[1]
        logical = torch.clamp(pos // ps, 0, mp - 1)
        pages = torch.gather(self.page_table.long(), 1, logical)
        pages = torch.where(pos // ps >= mp, torch.zeros_like(pages), pages)
        within = pos % ps
        if self.quantized:
            k_src, k_sc = quantize_kv_tokens(k_new)   # [B,n_kv,T,D]/[B,n_kv,T]
            v_src, v_sc = quantize_kv_tokens(v_new)
            self.k_scale[pages, :, within] = k_sc.permute(0, 2, 1)
            self.v_scale[pages, :, within] = v_sc.permute(0, 2, 1)
        else:
            k_src, v_src = k_new, v_new
        # pool[pages[b,t], :, within[b,t], :] <- new[b, :, t, :]
        self.k_pool[pages, :, within] = k_src.permute(0, 2, 1, 3).to(
            self.k_pool.dtype)
        self.v_pool[pages, :, within] = v_src.permute(0, 2, 1, 3).to(
            self.v_pool.dtype)
        return self


def gather_pages(pool: torch.Tensor, table: torch.Tensor,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows' logical K or V [B, n_kv, MP * ps, D] gathered from a pool
    [P, n_kv, ps, D] through the page table [B, MP]; int8 codes with their
    per-token scales [P, n_kv, ps] are dequantized to bf16, as the JAX
    package's view does."""
    B, MP = table.shape
    _, n_kv, ps, d = pool.shape
    x = pool[table.long()]                          # [B, MP, n_kv, ps, D]
    x = x.permute(0, 2, 1, 3, 4).reshape(B, n_kv, MP * ps, d)
    if scale is None:
        return x
    s = scale[table.long()]                         # [B, MP, n_kv, ps]
    s = s.permute(0, 2, 1, 3).reshape(B, n_kv, MP * ps)
    return (x.float() * s[..., None]).to(torch.bfloat16)


def quantize_kv_tokens(x: torch.Tensor):
    """Per-token symmetric int8 over the trailing (head-dim) axis:
    scale = max|x| / 127 (+1e-12). Returns (codes int8 [..., D], scales f32
    [...]), the rule of the JAX package's ``quantize_kv_tokens``."""
    xf = x.float()
    s = over_127(xf.abs().amax(-1)) + 1e-12
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


class PageAllocator:
    """Host-side free-list over the physical pool. Page 0 is reserved as the
    null page (unallocated table entries point at it and gather masked-out
    garbage), so a zeroed page table is always safe.

    Pages are REF-COUNTED so a physical page can back several logical
    sequences at once (prefix caching: slots mapping a shared system-prompt
    page each hold a ref, and the PrefixCache holds one of its own). A page
    returns to the free list when its last ref drops."""

    def __init__(self, num_pages: int, page_size: int):
        self.page_size = page_size
        self.free: List[int] = list(range(1, num_pages))
        self.owned: dict = {}                       # slot -> [page ids]
        self.refs: dict = {}                        # page id -> refcount

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.page_size)

    def alloc(self, slot: int, n_tokens: int) -> List[int]:
        """Ensure ``slot`` owns enough pages for n_tokens; returns the full
        page list. Raises MemoryError when the pool is exhausted."""
        have = self.owned.setdefault(slot, [])
        need = self.pages_for(n_tokens) - len(have)
        if need > len(self.free):
            raise MemoryError(
                f"paged KV pool exhausted: need {need} pages, "
                f"{len(self.free)} free")
        for _ in range(max(0, need)):
            p = self.free.pop()
            self.refs[p] = 1
            have.append(p)
        return have

    def share(self, slot: int, pages: List[int]):
        """Map already-backed pages (a cached prefix) into ``slot``: the
        slot takes a ref on each. Must run BEFORE alloc() so the shared
        pages lead the slot's page list in token order."""
        have = self.owned.setdefault(slot, [])
        assert not have, "share() must precede alloc() on an empty slot"
        for p in pages:
            self.refs[p] = self.refs.get(p, 0) + 1
            have.append(p)

    def retain(self, page: int):
        self.refs[page] = self.refs.get(page, 0) + 1

    def drop(self, page: int):
        n = self.refs.get(page, 0) - 1
        if n <= 0:
            self.refs.pop(page, None)
            self.free.append(page)
        else:
            self.refs[page] = n

    def release(self, slot: int):
        for p in self.owned.pop(slot, []):
            self.drop(p)


class PrefixCache:
    """Exact-match prefix reuse at page granularity (vLLM-style automatic
    prefix caching).

    Full pages of a prompt are registered under a SHA-1 hash CHAIN (each
    page's key digests its tokens plus its parent's key, so a hit implies
    the entire prefix matches). Hits map the physical pages into the new
    request's table (allocator.share) and prefill runs only on the suffix.
    Registered pages hold one cache ref; LRU entries whose pages no active
    slot maps (refs == 1) are evictable when the pool runs dry."""

    def __init__(self, page_size: int):
        self.ps = page_size
        self.entries = collections.OrderedDict()    # digest -> page id
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0

    def _chain(self, tokens):
        h = b""
        for i in range(len(tokens) // self.ps):
            chunk = tokens[i * self.ps:(i + 1) * self.ps]
            m = hashlib.sha1(h)
            m.update(b",".join(str(t).encode() for t in chunk))
            h = m.digest()
            yield h

    def chain(self, tokens) -> List[bytes]:
        """Materialized digest chain for a prompt: compute ONCE per request
        and pass to lookup/register (lookup runs on every batcher step
        while a request queues)."""
        return list(self._chain(tokens))

    def lookup(self, tokens, max_pages: int,
               digests: Optional[List[bytes]] = None) -> List[int]:
        """Longest chain of cached pages covering a prefix of ``tokens``,
        capped at ``max_pages`` (callers cap at (T-1)//ps so at least one
        real token remains for the suffix prefill)."""
        pages: List[int] = []
        for h in (digests if digests is not None else self._chain(tokens)):
            if len(pages) >= max_pages:
                break
            p = self.entries.get(h)
            if p is None:
                break
            self.entries.move_to_end(h)
            pages.append(p)
        return pages

    def record(self, n_hit_pages: int):
        """Count one ADOPTION (lookup runs repeatedly while a request waits
        in the queue, so stats are recorded once, at adoption time)."""
        if n_hit_pages:
            self.hits += 1
            self.hit_tokens += n_hit_pages * self.ps
        else:
            self.misses += 1

    def register(self, tokens, pages: List[int], alloc: PageAllocator,
                 digests: Optional[List[bytes]] = None):
        """Record ``pages`` (the slot's in-order page list) as holding the
        full pages of ``tokens``; the cache takes a ref on each new entry."""
        for h, p in zip(digests if digests is not None
                        else self._chain(tokens), pages):
            if h in self.entries:
                continue
            self.entries[h] = p
            alloc.retain(p)

    def evict(self, alloc: PageAllocator, keep=(), max_evict: int = 1) -> int:
        """Drop up to ``max_evict`` LRU entries whose page only the cache
        still refs (refs == 1) and is not in ``keep``. Returns count."""
        keep = set(keep)
        evicted = 0
        for h in list(self.entries):
            if evicted >= max_evict:
                break
            p = self.entries[h]
            if p in keep or alloc.refs.get(p, 0) != 1:
                continue
            del self.entries[h]
            alloc.drop(p)
            evicted += 1
        return evicted

    def evictable(self, alloc: PageAllocator, keep=()) -> int:
        keep = set(keep)
        return sum(1 for p in self.entries.values()
                   if p not in keep and alloc.refs.get(p, 0) == 1)
