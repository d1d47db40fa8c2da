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
cache tensors in place. A decode step is one body over static buffers
(the forward at T = 1 at the [slots] offset tensor, the per-slot sampler,
the in-place updates of the offsets, the tokens and the repetition
window), the counterpart of the JAX package's jitted ``decode_step``: on
a CUDA cache it is captured as a CUDA graph at the first step
(``core.generate.CapturedBodies``) and replayed at every later one, a
greedy body while no active slot samples and a sampled one otherwise,
both in one graph pool that lives until ``close()``. A sampled slot
draws by ``core.sampling.slot_noise``, keyed on the device by the
request's seed and the absolute position of the token drawn, so a
preempted request replays its tokens exactly. The host keeps mirrors of
what it must decide on (``off_host``, the page table, the active set),
writes the device's copies in place between replays, and reads nothing
back except the previous step's tokens, and those only after the next
step is queued.

Speculative batching (``draft_forward_fn``, as the JAX package's): each
step is one draft-and-verify round for every slot, also one captured
body (``spec_round``); only greedy requests, and no recurrent layers.

A hybrid model's recurrent layers (``models.deltanet.RecurrentCache``,
MiniCPM-SALA's ``models.lightning.GLACache``) ride the dense batcher:
adoption prefills at exactly T (a padded bucket would feed the pads into
the state), into the slot's rows of each recurrent layer, zeroed first,
since no offset mask hides a finished request's state; MiniCPM-SALA's
sparse layers (``models.sparse_attention.SparseKVCache``) prefill into
their slot's rows of K, V and the pooled keys. The paged batcher refuses
hybrids, as the JAX package's does.
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
from ominix_mlx_tpu_torch.core.generate import (CapturedBodies, Engine,
                                                bucket_length)
from ominix_mlx_tpu_torch.core.paged_cache import (PageAllocator,
                                                   PagedKVCache, PrefixCache,
                                                   quantize_kv_tokens)
from ominix_mlx_tpu_torch.core.sampling import (SamplerConfig, SamplerParams,
                                                sample_slots, seed_word)
from ominix_mlx_tpu_torch.core.speculative import draft_and_verify
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


class ContinuousBatcher:
    """Continuous-batching decoder over ``forward(params, tokens, cache) ->
    (logits, cache)`` models (``base.forward``-compatible)."""

    def __init__(self, forward_fn: Callable, params, cfg, init_cache_fn,
                 slots: int = 4, max_len: int = 2048,
                 stop_tokens: Tuple[int, ...] = (),
                 prefill_forward_fn: Optional[Callable] = None,
                 draft_forward_fn: Optional[Callable] = None,
                 draft_params=None,
                 draft_init_cache_fn: Optional[Callable] = None,
                 num_draft_tokens: int = 4,
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

        draft_forward_fn / draft_params / draft_init_cache_fn turn on
        BATCHED SPECULATIVE decoding (the JAX package's): every step
        drafts ``num_draft_tokens`` greedily per slot and the target
        verifies all slots' drafts in one [slots, nd + 1] forward, token
        for token equal to plain greedy; sampled requests are refused.
        draft_init_cache_fn(slots, max_len) -> ModelCache of dense KVCache
        layers for the draft.

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
        # prefills at exactly T; and a speculative round cannot roll their
        # state back
        self._has_recurrent = any(ingests_padding(lc) for lc in layers)
        if self._has_recurrent and draft_forward_fn is not None:
            raise ValueError(
                "speculative batching cannot roll back recurrent-state "
                "layers; use plain continuous batching for hybrid models")
        lc = layers[0]
        self.device = (lc.k_pool if isinstance(lc, PagedKVCache)
                       else lc.state if isinstance(lc, (RecurrentCache,
                                                        GLACache))
                       else lc.k).device
        dev = self.device
        # the step's static buffers, written in place by the captured body
        # and, between replays, by the host (stream-ordered)
        self.offsets = torch.zeros(slots, dtype=torch.long, device=dev)
        self.toks = torch.zeros(slots, dtype=torch.long, device=dev)
        self.active_mask = torch.zeros(slots, dtype=torch.bool, device=dev)
        self.seeds = torch.zeros(slots, dtype=torch.long, device=dev)
        self.cache = ModelCache(layers=layers, offset=self.offsets)
        self.active: List[Optional[_Request]] = [None] * slots
        self.off_host: List[int] = [0] * slots   # host mirror of offsets
        self._mask_host: List[bool] = [False] * slots
        self.queue: deque = deque()
        self.chunk_fwd = chunk_forward_fn
        self.chunk_hidden_fwd = chunk_hidden_forward_fn
        self.prefill_chunk = prefill_chunk
        self._chunk_engine_inst = None
        # per-slot sampling settings as [slots] tensors (greedy by default)
        self.sparams = SamplerParams.from_config(SamplerConfig(), slots, dev)
        self.recent = torch.full((slots, REP_WINDOW), -1, dtype=torch.long,
                                 device=dev)
        # the step's bodies ("greedy", "sampled", "spec"), captured into
        # one pool on CUDA; the last step's logits (on CUDA in the pool,
        # until the next step); steps that ran the sampled body
        self.bodies = CapturedBodies(dev)
        self.logits: Optional[torch.Tensor] = None
        self.sampled_steps = 0
        self.spec = draft_forward_fn is not None
        self.nd = num_draft_tokens if self.spec else 0
        # per-step KV write headroom (a speculative round writes nd + 1)
        self._reserve = self.nd + 1
        if self.spec:
            if num_draft_tokens < 1:
                raise ValueError("num_draft_tokens must be >= 1")
            self.dfwd = draft_forward_fn
            self.dparams = draft_params
            self.d_cache = draft_init_cache_fn(slots, max_len)
            self.x_prev = torch.zeros(slots, dtype=torch.long, device=dev)
            self.tgt = torch.zeros(slots, self.nd + 1, dtype=torch.long,
                                   device=dev)
            self.n_acc = torch.zeros(slots, dtype=torch.long, device=dev)
        # host copies of what a step emits (pinned, so the copies are
        # asynchronous on CUDA)
        pin = dev.type == "cuda"
        self._toks_host = torch.empty(slots, dtype=torch.long, pin_memory=pin)
        if self.spec:
            self._tgt_host = torch.empty(slots, self.nd + 1,
                                         dtype=torch.long, pin_memory=pin)
            self._nacc_host = torch.empty(slots, dtype=torch.long,
                                          pin_memory=pin)

    # ------------------------------------------------------------ public ----

    def submit(self, rid, tokens: List[int], max_tokens: int = 128,
               stop_tokens=None, emit: Optional[Callable] = None,
               sampler: Optional[SamplerConfig] = None, seed: int = 0):
        if not tokens or len(tokens) >= self.max_len:
            raise ValueError(f"prompt of {len(tokens)} tokens does not fit "
                             f"the batcher's max_len {self.max_len}")
        if sampler is not None and sampler.temperature <= 0.0:
            sampler = None               # greedy is the default row state
        if sampler is not None and self.spec:
            raise ValueError(
                "speculative batcher verifies greedily; route sampled "
                "requests to the per-request engine path")
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

    def close(self):
        """Free the captured bodies' graphs and their pool (after the
        replays queued so far); a later step captures them anew."""
        self.bodies.close()

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

    def _sample_first(self, b, req, last, scfg):
        """The first token of an adopted request, from its last prompt
        logits [V], drawn at position T (the prompt's length), as the JAX
        package folds T."""
        rec1 = torch.tensor([self._recent_row(req)], device=self.device)
        at = torch.full((1,), len(req.tokens), dtype=torch.long,
                        device=self.device)
        seed = torch.full((1,), seed_word(req.seed), dtype=torch.long,
                          device=self.device)
        return sample_slots(
            last[None], SamplerParams.from_config(scfg, 1, self.device),
            seed, at, rec1, sampled=req.sampler is not None)[0]

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

    def _adopt_draft(self, b: int, padded, req):
        """The draft's adoption prefill (eager): the padded prompt through
        the draft forward into slot b's rows of the draft cache (views,
        written in place); x_prev, the token before the held one, is the
        prompt's last."""
        layers1 = [KVCache(k=lc.k[b:b + 1], v=lc.v[b:b + 1])
                   for lc in self.d_cache.layers]
        self.dfwd(self.dparams, padded, ModelCache(layers=layers1, offset=0))
        self.x_prev[b] = req.tokens[-1]

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
            if self.spec:
                self._adopt_draft(b, padded, req)
            self.sparams.set_row(b, scfg)
            self.seeds[b] = seed_word(req.seed)
            # recent = history shifted left + the token just sampled, so a
            # preempted continuation resumes with its true rep-penalty state
            row = self._recent_row(req)[1:] + [-1]
            self.recent[b] = torch.tensor(row, device=self.device)
            self.recent[b, -1] = tok
            self.off_host[b] = T
            self.active[b] = req

    def _sync_mask(self):
        """Write the active set into the device mask, in place, where it
        changed since the last step (stream-ordered fills: the replays
        queued before still read the old mask)."""
        for b, req in enumerate(self.active):
            on = req is not None
            if on != self._mask_host[b]:
                self.active_mask[b] = on
                self._mask_host[b] = on

    def _copy_to_host(self, pairs):
        """Queue copies of device tensors into pinned host buffers and
        return the event behind them (None on the CPU: copied already)."""
        for host, dev in pairs:
            host.copy_(dev, non_blocking=True)
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    def decode_body(self, sampled: bool) -> torch.Tensor:
        """One decode step for every slot, over the static buffers (the
        counterpart of the JAX package's ``decode_step``): the forward at
        T = 1 at the offsets, the per-slot sampler (its filters only when
        ``sampled``), each draw keyed by (seed, offset + 1), the repetition
        window rolled, inactive slots' offsets held (their KV write lands
        on the same slot every step and is overwritten on adoption), the
        drawn tokens written over the step's input tokens. Returns the
        logits [slots, V]."""
        logits, _ = self.fwd(self.params, self.toks[:, None], self.cache)
        logits = logits[:, -1]
        nxt = sample_slots(logits, self.sparams, self.seeds,
                           self.offsets + 1, self.recent, sampled)
        self.recent.copy_(torch.cat([self.recent[:, 1:], nxt[:, None]], 1))
        self.offsets.add_(self.active_mask.long())
        self.toks.copy_(nxt)
        return logits

    @torch.no_grad()
    def step(self) -> List[Tuple[object, List[int]]]:
        """One decode step for every active slot; refills free slots first.
        Returns requests that FINISHED this step as (rid, tokens)."""
        if self.spec:
            return self._spec_step()
        self._fill_free_slots()
        if not any(r is not None for r in self.active):
            return []
        self._pre_step()
        self._sync_mask()
        sampled = any(r is not None and r.sampler is not None
                      for r in self.active)
        # this step's input tokens are the ones it emits: queue their copy
        # to the host before the step overwrites them, read it after the
        # step is queued
        copied = self._copy_to_host([(self._toks_host, self.toks)])
        self.logits = self.bodies.run("sampled" if sampled else "greedy",
                                      lambda: self.decode_body(sampled))
        self.sampled_steps += sampled
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
                self._finish(b, req, finished)
        return finished

    def _finish(self, b, req, finished):
        finished.append((req.rid, req.out))
        if req.emit:
            req.emit(None)
        self.active[b] = None
        self._release_slot(b)

    # ------------------------------------------------ batched speculative --

    def spec_round(self) -> torch.Tensor:
        """One draft-and-verify round for ALL slots over the static
        buffers (the JAX package's ``spec_round``; the body is
        ``core.speculative.draft_and_verify``, the engine's round): the
        offsets advance by n_acc + 1 on active slots only. Writes the
        offsets, the held tokens, x_prev, ``tgt`` [slots, nd + 1] and
        ``n_acc`` [slots] in place; returns the target's logits."""
        return draft_and_verify(self.fwd, self.params, self.dfwd,
                                self.dparams, self.nd, self.cache,
                                self.d_cache.layers, self.toks, self.x_prev,
                                self.tgt, self.n_acc,
                                active=self.active_mask)

    def _spec_step(self) -> List[Tuple[object, List[int]]]:
        """One speculative round for every active slot: emits the held
        token plus every accepted draft per slot (1..nd+1 tokens), holds
        the target's correction as the next round's input."""
        self._fill_free_slots()
        finished = []
        # a prompt adopted near capacity cannot survive even one round's
        # nd+1 transient writes: emit its held token and finish it now
        for b, req in enumerate(self.active):
            if req is not None and \
                    self.off_host[b] >= self.max_len - self.nd - 2:
                t = int(self.toks[b])
                stops = req.stop if req.stop is not None else \
                    self.stop_tokens
                if t not in stops and len(req.out) < req.max_tokens:
                    req.out.append(t)
                    if req.emit:
                        req.emit(t)
                self._finish(b, req, finished)
        if not any(r is not None for r in self.active):
            return finished
        self._pre_step()
        self._sync_mask()
        held = self._copy_to_host([(self._toks_host, self.toks)])
        self.logits = self.bodies.run("spec", self.spec_round)
        done_ev = self._copy_to_host([(self._tgt_host, self.tgt),
                                      (self._nacc_host, self.n_acc)])
        for ev in (held, done_ev):
            if ev is not None:
                ev.synchronize()
        cur = self._toks_host.tolist()
        tgt_h = self._tgt_host.tolist()
        na_h = self._nacc_host.tolist()
        for b, req in enumerate(self.active):
            if req is None:
                continue
            n = na_h[b]
            self.off_host[b] += n + 1
            stops = req.stop if req.stop is not None else self.stop_tokens
            # emitted this round: the held token + accepted drafts
            # (tgt[b, :n] == drafts[b, :n]); tgt[b, n] is held for next
            done = False
            for t in [cur[b]] + tgt_h[b][:n]:
                if t in stops:
                    done = True
                    break
                req.out.append(t)
                if req.emit:
                    req.emit(t)
                if len(req.out) >= req.max_tokens:
                    done = True
                    break
            # leave headroom for the next round's nd+1 transient writes
            if self.off_host[b] >= self.max_len - self.nd - 2:
                done = True
            if done:
                self._finish(b, req, finished)
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
                 draft_forward_fn: Optional[Callable] = None,
                 draft_params=None,
                 draft_init_cache_fn: Optional[Callable] = None,
                 num_draft_tokens: int = 4, device=None):
        """prefix_cache=True turns on automatic prefix caching: full pages
        of each adopted prompt are registered under a hash chain; later
        requests sharing that prefix map the SAME physical pages
        (ref-counted) and prefill only their suffix (through
        chunk_forward_fn when given: K2c at pos = the cached length).
        quantize_kv=True stores int8 pages with per-token scales. The pool
        lives on ``device`` (default: the current CUDA device). The draft
        arguments are the dense batcher's; the draft cache is dense."""
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
                         draft_forward_fn=draft_forward_fn,
                         draft_params=draft_params,
                         draft_init_cache_fn=draft_init_cache_fn,
                         num_draft_tokens=num_draft_tokens,
                         chunk_forward_fn=chunk_forward_fn,
                         chunk_hidden_forward_fn=chunk_hidden_forward_fn)

    # ----------------------------------------------------------- hooks -----

    def _sync_table(self):
        """Copy the host table into the device table every layer shares,
        in place (stream-ordered: steps already queued still read the old
        one). On CUDA the copy leaves from a pinned block of PyTorch's
        caching host allocator, which keeps the block until the copy has
        run, so the host goes on without waiting for the device."""
        src = torch.from_numpy(self.table)
        if self.dev_table.is_cuda:
            src = src.pin_memory()
        self.dev_table.copy_(src, non_blocking=True)

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
