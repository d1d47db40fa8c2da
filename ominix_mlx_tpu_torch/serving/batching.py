"""Continuous batching: slot-based decode with in-flight request refill
(counterpart of ominix_mlx_tpu/serving/batching.py).

  - a fixed batch of ``slots`` sequences decodes in one forward per step;
    per-slot offsets (a [slots] tensor on the device) drive the causal mask,
    RoPE and the KV writes
  - a new request prefills and is ADOPTED into a free slot. The dense
    batcher prefills straight into the slot's row of the batch cache (a
    view, written in place); the paged batcher prefills into a fresh
    single-row cache and copies it into pool pages
  - finished slots free at once and refill from the queue

Where the JAX package donates buffers to its jits, the port updates the
cache tensors in place. The host keeps mirrors of what it must decide on
(``off_host``, the page table, the active set), so a step reads nothing
back from the device except the previous step's tokens, and those only
after the next forward is queued.

A hybrid model's recurrent layers (``models.deltanet.RecurrentCache``,
MiniCPM-SALA's ``models.lightning.GLACache``) ride the dense batcher:
adoption prefills at exactly T (a padded bucket would feed the pads into
the state), into the slot's rows of each recurrent layer, zeroed first,
since no offset mask hides a finished request's state; MiniCPM-SALA's
sparse layers (``models.sparse_attention.SparseKVCache``) prefill into
their slot's rows of K, V and the pooled keys. The paged batcher refuses
hybrids, as the JAX package's does.

Speculative batching is not ported: the server's ``enable_batching``
raises ``NotImplementedError`` for it.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ominix_mlx_tpu_torch.core.cache import (KVCache, ModelCache,
                                            ingests_padding)
from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.core.generate import Engine, bucket_length
from ominix_mlx_tpu_torch.core.paged_cache import (PageAllocator,
                                                   PagedKVCache, PrefixCache,
                                                   quantize_kv_tokens)
from ominix_mlx_tpu_torch.core.sampling import (SamplerConfig, SamplerParams,
                                                sample_dynamic)
from ominix_mlx_tpu_torch.models.deltanet import RecurrentCache
from ominix_mlx_tpu_torch.models.lightning import GLACache
from ominix_mlx_tpu_torch.models.sparse_attention import SparseKVCache

REP_WINDOW = 64
# cache layers with per-row views (``rows(b)``) besides KVCache
ROW_CACHES = (RecurrentCache, GLACache, SparseKVCache)


@dataclasses.dataclass
class _Request:
    rid: object
    tokens: List[int]
    max_tokens: int
    out: List[int] = dataclasses.field(default_factory=list)
    stop: Optional[set] = None          # per-request stop ids (None -> global)
    emit: Optional[Callable] = None     # streaming sink: emit(tok) per token,
    #                                     then exactly once emit(None) on
    #                                     finish or cancel, or emit(exc), an
    #                                     Exception, when the request failed
    sampler: Optional[SamplerConfig] = None   # None -> greedy
    seed: int = 0
    chain: Optional[list] = None    # memoized prefix-cache digest chain


def _seeded(gen: torch.Generator, seed: int, pos: int) -> torch.Generator:
    """Reseed ``gen`` from (request seed, absolute position of the token
    being drawn): a draw depends on nothing else, so a preempted request
    replays its sampled tokens exactly (the JAX package folds the position
    into the request's key for the same reason)."""
    return gen.manual_seed((int(seed) * 1_000_003 + int(pos)) % (1 << 63))


class ContinuousBatcher:
    """Continuous-batching decoder over ``forward(params, tokens, cache) ->
    (logits, cache)`` models (``base.forward``-compatible)."""

    def __init__(self, forward_fn: Callable, params, cfg, init_cache_fn,
                 slots: int = 4, max_len: int = 2048,
                 stop_tokens: Tuple[int, ...] = (),
                 prefill_forward_fn: Optional[Callable] = None,
                 chunk_forward_fn: Optional[Callable] = None,
                 chunk_hidden_forward_fn: Optional[Callable] = None,
                 prefill_chunk: int = 2048):
        """prefill_forward_fn: the variant for the (always fresh) adoption
        prefill, e.g. ``base.forward`` with fresh_prefill=True (K2 on CUDA).

        chunk_forward_fn(params, tokens, cache, kv_limit): enables CHUNKED
        adoption prefill for prompts longer than ``prefill_chunk`` (K2c on
        CUDA) and, in the paged batcher, the suffix-only prefill after a
        prefix-cache hit. chunk_hidden_forward_fn: its skip_logits form for
        non-final chunks.

        init_cache_fn(cfg, slots, max_len) -> ModelCache of KVCache (or,
        for the paged batcher, PagedKVCache) layers, and a hybrid's
        RecurrentCache, GLACache and SparseKVCache layers."""
        self.fwd = forward_fn
        self.prefill_fwd = prefill_forward_fn or forward_fn
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.stop_tokens = set(stop_tokens)
        layers = init_cache_fn(cfg, slots, max_len).layers
        if not all(isinstance(lc, (KVCache, PagedKVCache) + ROW_CACHES)
                   for lc in layers):
            raise ValueError(
                "continuous batching needs per-row cache state; init the "
                "batcher with dense KVCache layers (window masking) "
                "instead of RotatingKVCache")
        # recurrent layers take every position they are given: adoption
        # prefills at exactly T
        self._has_recurrent = any(ingests_padding(lc) for lc in layers)
        lc = layers[0]
        self.device = (lc.k_pool if isinstance(lc, PagedKVCache)
                       else lc.state if isinstance(lc, (RecurrentCache,
                                                        GLACache))
                       else lc.k).device
        dev = self.device
        self.offsets = torch.zeros(slots, dtype=torch.long, device=dev)
        self.toks = torch.zeros(slots, dtype=torch.long, device=dev)
        self.cache = ModelCache(layers=layers, offset=self.offsets)
        self.active: List[Optional[_Request]] = [None] * slots
        self.off_host: List[int] = [0] * slots   # host mirror of offsets
        self.queue: deque = deque()
        self.chunk_fwd = chunk_forward_fn
        self.chunk_hidden_fwd = chunk_hidden_forward_fn
        self.prefill_chunk = prefill_chunk
        self._chunk_engine_inst = None
        self._reserve = 1               # KV writes per step
        # per-slot sampling state: settings are [slots] tensors, sampled
        # slots own a generator (None: greedy)
        self.sparams = SamplerParams.from_config(SamplerConfig(), slots, dev)
        self.gens: List[Optional[torch.Generator]] = [None] * slots
        self.recent = torch.full((slots, REP_WINDOW), -1, dtype=torch.long,
                                 device=dev)
        # host copy of the tokens a step emits, read after the next forward
        # is queued (pinned, so the copy is asynchronous on CUDA)
        self._toks_host = torch.empty(slots, dtype=torch.long,
                                      pin_memory=dev.type == "cuda")

    # ------------------------------------------------------------ public ----

    def submit(self, rid, tokens: List[int], max_tokens: int = 128,
               stop_tokens=None, emit: Optional[Callable] = None,
               sampler: Optional[SamplerConfig] = None, seed: int = 0):
        if not tokens or len(tokens) >= self.max_len:
            raise ValueError(f"prompt of {len(tokens)} tokens does not fit "
                             f"the batcher's max_len {self.max_len}")
        if sampler is not None and sampler.temperature <= 0.0:
            sampler = None               # greedy is the default row state
        self.queue.append(_Request(
            rid, list(tokens), max_tokens,
            stop=set(stop_tokens) if stop_tokens is not None else None,
            emit=emit, sampler=sampler, seed=seed))

    def cancel(self, rid) -> bool:
        """Drop a queued or in-flight request. Frees the slot immediately;
        the emit sink (if any) receives the terminating ``None``."""
        for req in list(self.queue):
            if req.rid == rid:
                self.queue.remove(req)
                if req.emit:
                    req.emit(None)
                return True
        for b, req in enumerate(self.active):
            if req is not None and req.rid == rid:
                self.active[b] = None
                self._release_slot(b)
                if req.emit:
                    req.emit(None)
                return True
        return False

    def pending(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.active)

    def abort_all(self, reason: str = "request aborted"):
        """Fail every queued and in-flight request: each emit sink gets a
        ``RuntimeError(reason)`` of its own instead of the ``None`` of a
        finished request, so a step error or a shutdown never reaches a
        client as a normal short answer."""
        for req in list(self.queue):
            if req.emit:
                req.emit(RuntimeError(reason))
        self.queue.clear()
        for b, req in enumerate(self.active):
            if req is None:
                continue
            self.active[b] = None
            self._release_slot(b)
            if req.emit:
                req.emit(RuntimeError(reason))

    # ----------------------------------------------- adoption hooks --------
    # (overridden by PagedContinuousBatcher)

    def _prefill_layers(self, b: int, bucket: int) -> list:
        """Single-row cache layers the adoption prefill writes: here the
        slot's own row of the batch cache (views, written in place); a
        recurrent layer's row zeroed first (the slot's last request left
        its state there, which no offset mask hides)."""
        return [lc.rows(b).zero_() if ingests_padding(lc)
                else lc.rows(b) if isinstance(lc, SparseKVCache)
                else KVCache(k=lc.k[b:b + 1], v=lc.v[b:b + 1])
                for lc in self.cache.layers]

    def _adopt_request(self, b: int, layers1, T: int, tok, req=None):
        self.offsets[b] = T
        self.toks[b] = tok

    def _release_slot(self, b: int):
        pass

    def _pre_step(self):
        pass

    def _can_adopt(self, req) -> bool:
        """Whether backing memory exists to adopt this request now (paged
        pools may be oversubscribed)."""
        return True

    def _recent_row(self, req) -> List[int]:
        """Generated-so-far history for ``req`` as a [-1]-padded REP_WINDOW
        row (non-empty only for preempted continuations)."""
        hist = list(req.out[-REP_WINDOW:])
        return [-1] * (REP_WINDOW - len(hist)) + hist

    def _gen(self, b: int, req, pos: int) -> Optional[torch.Generator]:
        """Slot ``b``'s generator seeded for the token at ``pos`` (None for
        a greedy request)."""
        if req.sampler is None:
            return None
        if self.gens[b] is None:
            self.gens[b] = torch.Generator(device=self.device)
        return _seeded(self.gens[b], req.seed, pos)

    def _sample_first(self, b, req, last, scfg):
        """The first token of an adopted request, from its last prompt
        logits [V] (drawn at position T, as the JAX package folds T)."""
        rec1 = torch.tensor([self._recent_row(req)], device=self.device)
        return sample_dynamic(
            last[None], SamplerParams.from_config(scfg, 1, self.device),
            [self._gen(b, req, len(req.tokens))], rec1)[0]

    def _run_prefill(self, b: int, req, T: int, bucket: int, padded, scfg):
        """The adoption prefill of one request: returns the single-row
        cache layers it wrote and the first sampled token. Hook point: the
        paged batcher substitutes a suffix-only prefill on a prefix-cache
        hit."""
        if self.chunk_fwd is not None and T > self.prefill_chunk:
            return self._run_prefill_chunked(b, req, T, bucket, padded, scfg)
        cache1 = ModelCache(layers=self._prefill_layers(b, bucket), offset=0)
        logits, cache1 = self.prefill_fwd(self.params, padded, cache1)
        return cache1.layers, self._sample_first(b, req, logits[0, T - 1],
                                                 scfg)

    def _run_prefill_chunked(self, b, req, T, bucket, padded, scfg):
        """Long prompts prefill through the engine's chunked path (K2 then
        K2c chunks on CUDA) into the same single-row cache."""
        if self._chunk_engine_inst is None:
            self._chunk_engine_inst = Engine(
                self.fwd, self.params,
                prefill_forward_fn=self.prefill_fwd,
                chunk_forward_fn=self.chunk_fwd,
                chunk_hidden_forward_fn=self.chunk_hidden_fwd)
        cache1 = ModelCache(layers=self._prefill_layers(b, bucket), offset=0)
        last, cache1 = self._chunk_engine_inst.prefill_chunked(
            padded[:, :T], cache1, chunk_size=self.prefill_chunk)
        return cache1.layers, self._sample_first(b, req, last[0], scfg)

    # ------------------------------------------------------------------------

    def _fill_free_slots(self):
        for b in range(self.slots):
            if self.active[b] is not None or not self.queue:
                continue
            if not self._can_adopt(self.queue[0]):
                break                 # wait for pages to free; stay queued
            req = self.queue.popleft()
            T = len(req.tokens)
            bucket = (T if self._has_recurrent
                      else min(bucket_length(T), self.max_len))
            padded = torch.zeros(1, bucket, dtype=torch.long,
                                 device=self.device)
            padded[0, :T] = torch.tensor(req.tokens, device=self.device)
            scfg = req.sampler or SamplerConfig()
            layers1, tok = self._run_prefill(b, req, T, bucket, padded, scfg)
            self._adopt_request(b, layers1, T, tok, req)
            self.sparams.set_row(b, scfg)
            # recent = history shifted left + the token just sampled, so a
            # preempted continuation resumes with its true rep-penalty state
            row = self._recent_row(req)[1:] + [-1]
            self.recent[b] = torch.tensor(row, device=self.device)
            self.recent[b, -1] = tok
            self.off_host[b] = T
            self.active[b] = req

    @torch.no_grad()
    def step(self) -> List[Tuple[object, List[int]]]:
        """One decode step for every active slot; refills free slots first.
        Returns requests that FINISHED this step as (rid, tokens)."""
        self._fill_free_slots()
        if not any(r is not None for r in self.active):
            return []
        self._pre_step()
        active = [r is not None for r in self.active]
        # this step's input tokens are the ones it emits: queue their copy
        # to the host now, read it after the forward is queued
        self._toks_host.copy_(self.toks, non_blocking=True)
        copied = None
        if self.device.type == "cuda":
            copied = torch.cuda.Event()
            copied.record()
        logits, _ = self.fwd(self.params, self.toks[:, None],
                             ModelCache(layers=self.cache.layers,
                                        offset=self.offsets))
        gens = [self._gen(b, req, self.off_host[b] + 1)
                if req is not None else None
                for b, req in enumerate(self.active)]
        nxt = sample_dynamic(logits[:, -1], self.sparams, gens, self.recent)
        self.recent = torch.cat([self.recent[:, 1:], nxt[:, None]], 1)
        # inactive slots hold their offset (their KV write lands on the
        # same slot every step and is overwritten on adoption)
        self.offsets = torch.where(
            torch.tensor(active, device=self.device), self.offsets + 1,
            self.offsets)
        self.cache = ModelCache(layers=self.cache.layers,
                                offset=self.offsets)
        if copied is not None:
            copied.synchronize()
        cur = self._toks_host.tolist()
        finished = []
        for b, req in enumerate(self.active):
            if req is None:
                continue
            self.off_host[b] += 1
            t = cur[b]
            stops = req.stop if req.stop is not None else self.stop_tokens
            done = (t in stops
                    or len(req.out) + 1 >= req.max_tokens
                    or self.off_host[b] >= self.max_len - 1)
            if t not in stops:
                req.out.append(t)
                if req.emit:
                    req.emit(t)
            if done:
                finished.append((req.rid, req.out))
                if req.emit:
                    req.emit(None)
                self.active[b] = None
                self._release_slot(b)
        self.toks = nxt
        return finished

    def run_all(self, requests: List[Tuple[object, List[int], int]]
                ) -> Dict[object, List[int]]:
        """Drain a request list to completion (tests / offline batch)."""
        for rid, toks, mt in requests:
            self.submit(rid, toks, mt)
        done: Dict[object, List[int]] = {}
        while self.queue or any(r is not None for r in self.active):
            for rid, out in self.step():
                done[rid] = out
        return done


class PagedContinuousBatcher(ContinuousBatcher):
    """Continuous batching over a shared paged KV pool (core/paged_cache.py).

    Slots draw pages from one physical pool as their sequences grow instead
    of reserving slots x max_len up front. Page allocation is host side
    (a numpy table mirrored into one device tensor that every layer
    shares); decode attention runs K3 on CUDA. Works with
    ``base.forward``-compatible forwards (cfg with num_layers / num_kv_heads
    / hd)."""

    def __init__(self, forward_fn: Callable, params, cfg,
                 slots: int = 4, max_len: int = 2048,
                 num_pages: Optional[int] = None, page_size: int = 128,
                 stop_tokens: Tuple[int, ...] = (), dtype=torch.bfloat16,
                 prefill_forward_fn: Optional[Callable] = None,
                 quantize_kv: bool = False, prefix_cache: bool = False,
                 chunk_forward_fn: Optional[Callable] = None,
                 chunk_hidden_forward_fn: Optional[Callable] = None,
                 device=None):
        """prefix_cache=True turns on automatic prefix caching: full pages
        of each adopted prompt are registered under a hash chain; later
        requests sharing that prefix map the SAME physical pages
        (ref-counted) and prefill only their suffix (through
        chunk_forward_fn when given: K2c at pos = the cached length).
        quantize_kv=True stores int8 pages with per-token scales. The pool
        lives on ``device`` (default: the current CUDA device)."""
        device = resolve_device(device)
        if getattr(cfg, "deltanet", None) is not None \
                or getattr(cfg, "mla", None) is not None \
                or getattr(cfg, "mixer_types", None) is not None:
            raise ValueError(
                "paged batching backs uniform GQA KV layers with one page "
                "pool; hybrid (deltanet/GLA-mixer) and MLA families use the "
                "dense continuous batcher (--batch-slots without "
                "--batch-paged)")
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} is not a multiple of the "
                             f"page size {page_size}")
        self.page_size = page_size
        self.prefix = PrefixCache(page_size) if prefix_cache else None
        self._adopt_hit: List[int] = []
        self.max_pages = max_len // page_size
        self.n_kv = cfg.num_kv_heads
        self.hd = cfg.hd
        self.num_layers = cfg.num_layers
        self.dtype = dtype
        # default pool: fully backed (+1 null page); callers shrink it to
        # oversubscribe capacity across slots
        self.num_pages = num_pages or slots * self.max_pages + 1
        self.alloc = PageAllocator(self.num_pages, page_size)
        self.table = np.zeros((slots, self.max_pages), np.int32)
        self.dev_table = torch.zeros((slots, self.max_pages),
                                     dtype=torch.int32, device=device)

        def make_cache(cfg_, slots_, max_len_):
            return ModelCache(layers=[PagedKVCache.init(
                slots_, self.n_kv, self.num_pages, page_size, self.hd,
                self.max_pages, dtype, page_table=self.dev_table,
                quantized=quantize_kv, device=device)
                for _ in range(self.num_layers)])

        super().__init__(forward_fn, params, cfg, make_cache, slots=slots,
                         max_len=max_len, stop_tokens=stop_tokens,
                         prefill_forward_fn=prefill_forward_fn,
                         chunk_forward_fn=chunk_forward_fn,
                         chunk_hidden_forward_fn=chunk_hidden_forward_fn)

    # ----------------------------------------------------------- hooks -----

    def _sync_table(self):
        """Copy the host table into the device table every layer shares
        (stream-ordered: steps already queued still read the old one)."""
        self.dev_table.copy_(torch.from_numpy(self.table))

    def _prefill_layers(self, b: int, bucket: int) -> list:
        return [KVCache.init(1, self.n_kv, bucket, self.hd, self.dtype,
                             self.device)
                for _ in range(self.num_layers)]

    def _write_pages(self, layers1, page_row: torch.Tensor, skip: int):
        """Copy positions [skip * ps, ...) of the single-row prefill cache
        into the pool pages listed in page_row (quantized for int8 pools).
        Pages past the prompt are 0 entries: the null page takes them."""
        ps, n = self.page_size, page_row.shape[0]
        for lc, l1 in zip(self.cache.layers, layers1):
            for pool, scale, src in ((lc.k_pool, lc.k_scale, l1.k),
                                     (lc.v_pool, lc.v_scale, l1.v)):
                x = src[0, :, skip * ps:]                 # [n_kv, L, D]
                x = F.pad(x, (0, 0, 0, n * ps - x.shape[1]))
                x = x.reshape(self.n_kv, n, ps, self.hd).permute(1, 0, 2, 3)
                if scale is None:
                    pool[page_row] = x.to(pool.dtype)
                else:
                    codes, sc = quantize_kv_tokens(x)
                    pool[page_row] = codes
                    scale[page_row] = sc

    def _adopt_request(self, b: int, layers1, T: int, tok, req=None):
        ps = self.page_size
        bucket = layers1[0].k.shape[2]
        hit, self._adopt_hit = list(self._adopt_hit), []
        skip = len(hit)
        if skip:
            self.alloc.share(b, hit)       # prefix pages lead, ref-counted
        owned = self.alloc.alloc(b, T)
        n = -(-bucket // ps)
        row = np.zeros((n - skip,), np.int32)   # n > skip always:
        # skip <= (T-1)//ps < ceil(T/ps) <= ceil(bucket/ps) = n
        avail = owned[skip:n]
        row[:len(avail)] = avail
        self.table[b, :] = 0
        self.table[b, :len(owned)] = owned
        self._write_pages(layers1, torch.from_numpy(row).long().to(
            self.device), skip)
        self.offsets[b] = T
        self.toks[b] = tok
        if self.prefix is not None and req is not None:
            self.prefix.record(skip)
            # full pages of the prompt are immutable from here on (decode
            # writes land at positions >= T): register them for reuse
            self.prefix.register(req.tokens, owned[:T // ps], self.alloc,
                                 digests=req.chain)
        self._sync_table()

    def _can_adopt(self, req) -> bool:
        T = len(req.tokens)
        need = self.alloc.pages_for(T + self._reserve)
        if need > self.num_pages - 1:
            # can never fit even an empty pool: fail it rather than stall
            bad = self.queue.popleft()
            if bad.emit:
                bad.emit(ValueError(
                    f"prompt of {T} tokens needs {need} KV pages; the pool "
                    f"has {self.num_pages - 1}"))
            return bool(self.queue) and self._can_adopt(self.queue[0])
        hit = []
        if self.prefix is not None:
            if req.chain is None:      # hash the prompt ONCE per request
                req.chain = self.prefix.chain(req.tokens)
            hit = self.prefix.lookup(req.tokens,
                                     (T - 1) // self.page_size,
                                     digests=req.chain)
        self._adopt_hit = hit          # consumed by _run_prefill/_adopt
        need -= len(hit)
        lack = need - len(self.alloc.free)
        if lack > 0 and self.prefix is not None \
                and self.prefix.evictable(self.alloc, keep=hit) >= lack:
            self.prefix.evict(self.alloc, keep=hit, max_evict=lack)
            lack = 0
        return lack <= 0

    def _preempt(self, b: int):
        """Pool exhausted mid-decode: release this slot's pages and requeue
        the request as a continuation (prompt + tokens generated so far) so
        it re-prefills once pages free up. Replay is exact for greedy and
        sampled decode (draws are seeded by position)."""
        req = self.active[b]
        self.active[b] = None
        self._release_slot(b)
        self.queue.append(_Request(req.rid, req.tokens + req.out,
                                   req.max_tokens, out=req.out,
                                   stop=req.stop, emit=req.emit,
                                   sampler=req.sampler, seed=req.seed))

    def _pre_step(self):
        changed = False
        for b, req in enumerate(self.active):
            if req is None:
                continue
            tokens_needed = self.off_host[b] + self._reserve
            need = self.alloc.pages_for(tokens_needed)
            if len(self.alloc.owned.get(b, [])) < need:
                try:
                    owned = self._alloc_with_evict(b, tokens_needed)
                except MemoryError:
                    # oversubscribed pool: preempt this sequence instead of
                    # killing the stepping thread
                    self._preempt(b)
                    changed = True
                    continue
                self.table[b, :len(owned)] = owned
                changed = True
        if changed:
            self._sync_table()

    def _release_slot(self, b: int):
        self.alloc.release(b)
        self.table[b, :] = 0
        self._sync_table()

    def _alloc_with_evict(self, slot: int, n_tokens: int):
        """alloc() that reclaims LRU prefix-cache pages before giving up."""
        try:
            return self.alloc.alloc(slot, n_tokens)
        except MemoryError:
            if self.prefix is None:
                raise
            lack = (self.alloc.pages_for(n_tokens)
                    - len(self.alloc.owned.get(slot, []))
                    - len(self.alloc.free))
            if self.prefix.evict(self.alloc, max_evict=lack) < lack:
                raise
            return self.alloc.alloc(slot, n_tokens)

    # ------------------------------------------------ prefix caching -------

    def _run_prefill(self, b: int, req, T: int, bucket: int, padded, scfg):
        hit = self._adopt_hit
        if not hit:
            return super()._run_prefill(b, req, T, bucket, padded, scfg)
        L = len(hit) * self.page_size
        layers1 = self._gather_prefix_into(self._prefill_layers(b, bucket),
                                           hit)
        cache1 = ModelCache(layers=layers1, offset=L)
        if self.chunk_fwd is not None:
            # suffix queries at L.. over the prefix: K2c at pos = L
            logits, _ = self.chunk_fwd(self.params, padded[:, L:], cache1,
                                       bucket)
        else:
            logits, _ = self.fwd(self.params, padded[:, L:], cache1)
        return layers1, self._sample_first(b, req, logits[0, T - 1 - L],
                                           scfg)

    def _gather_prefix_into(self, layers1, hit):
        """Copy (dequantize) the shared prefix pages into positions [0, L)
        of the fresh single-row prefill cache, in page order, so the suffix
        forward attends them. Written in place; returns layers1."""
        nh, ps = len(hit), self.page_size
        pids = torch.tensor(hit, dtype=torch.long, device=self.device)
        for l1, lc in zip(layers1, self.cache.layers):
            for dst, pool, scale in ((l1.k, lc.k_pool, lc.k_scale),
                                     (l1.v, lc.v_pool, lc.v_scale)):
                x = pool[pids].permute(1, 0, 2, 3)    # [n_kv, nh, ps, D]
                if scale is not None:
                    x = x.float() * scale[pids].permute(1, 0, 2)[..., None]
                dst[0, :, :nh * ps] = x.reshape(self.n_kv, nh * ps,
                                                self.hd).to(dst.dtype)
        return layers1
