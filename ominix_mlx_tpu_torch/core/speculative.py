"""Speculative decoding: a draft proposes, the target verifies in one
forward (counterpart of ominix_mlx_tpu/core/speculative.py).

The draft emits ``num_draft_tokens`` (nd) greedily, the target scores the
previous token plus all drafts in ONE forward at T = nd + 1, and the
longest agreeing prefix is accepted, plus the target's own next token, so
every round yields at least one token. Both caches keep a fixed capacity;
a rejected draft's KV entries sit past the offset and are overwritten by
the next round: the rollback is offset arithmetic.

One round is one body over static buffers (``draft_and_verify``, which
the continuous batcher's round runs too): the draft's catch-up [x_prev,
last] at T = 2 on the draft cache at offset - 1, nd - 1 greedy draft
steps at T = 1, the target's verify, n_accept as the longest agreeing
prefix (or nd with ``force_accept``), the target offset advanced by
n_accept + 1 in place, and the next ``last`` and ``x_prev``. Both caches
run at [1] offset tensors the round owns. On a
CUDA cache the round is captured as a CUDA graph at the first round
(``core.generate.CapturedBodies``) and replayed at every later one; on the
CPU the body runs directly. The prefill of both models stays eager.

Each round's ``tgt`` and ``n_accept`` are copied to pinned host memory
behind an event; the host emits tokens and tests stops one round behind
the device, and a round run past a stop or past ``max_tokens`` is
discarded.

Recurrent layers (GLA, Gated DeltaNet): offset rollback cannot un-ingest
rejected drafts from a recurrent state. The JAX package and its reference
leave the state so ("the contamination from rejected tokens decays
exponentially"), which makes self-speculative decoding on hybrid models
approximate by design; the port keeps that rule. Exact speculative
decoding (dense, MoE, MLA caches) is what the continuous batcher exposes,
and it refuses recurrent layers.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterator, List, Optional

import torch

from ominix_mlx_tpu_torch.core.cache import ModelCache
from ominix_mlx_tpu_torch.core.generate import CapturedBodies


@dataclasses.dataclass
class SpecStats:
    rounds: int = 0
    drafted: int = 0
    accepted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0


def _capacity(cache: ModelCache) -> Optional[int]:
    caps = [lc.max_len for lc in cache.layers if hasattr(lc, "max_len")]
    return min(caps) if caps else None


def draft_and_verify(target_forward: Callable, target_params,
                     draft_forward: Callable, draft_params, nd: int,
                     t_cache: ModelCache, d_layers, last: torch.Tensor,
                     x_prev: torch.Tensor, tgt: torch.Tensor,
                     n_acc: torch.Tensor,
                     active: Optional[torch.Tensor] = None,
                     force_accept: bool = False) -> torch.Tensor:
    """One draft-and-verify round for B rows over static buffers, written
    in place: the round of ``SpeculativeEngine`` (B = 1) and of the
    continuous batcher (B = slots). ``t_cache.offset`` [B] is the position
    of ``last`` [B]; the draft's cache (``d_layers``) is valid through
    offset - 1, x_prev's slot, which the catch-up [x_prev, last] at T = 2
    rewrites with the same values (so the shape is static whatever the
    last round accepted). Then nd - 1 greedy draft steps at T = 1, and the
    target scores [last, d1..dnd] at T = nd + 1. n_acc [B] is the longest
    agreeing prefix (nd with ``force_accept``); the rollback is offset
    arithmetic: the offsets advance by n_acc + 1 (0 for a row that
    ``active`` [B] bool clears), and rejected drafts' KV past them is
    overwritten next round. Writes the offsets, ``last`` (the target's
    token after the accepted prefix), ``x_prev``, ``tgt`` [B, nd + 1] and
    ``n_acc``; returns the target's logits [B, nd + 1, V]."""
    off = t_cache.offset
    lg, _ = draft_forward(draft_params, torch.stack([x_prev, last], 1),
                          ModelCache(layers=d_layers, offset=off - 1))
    drafts = [torch.argmax(lg[:, -1], -1)]
    for i in range(1, nd):
        lg, _ = draft_forward(draft_params, drafts[-1][:, None],
                              ModelCache(layers=d_layers, offset=off + i))
        drafts.append(torch.argmax(lg[:, -1], -1))
    drafts = torch.stack(drafts, 1)                             # [B, nd]
    seq = torch.cat([last[:, None], drafts], 1)
    logits, _ = target_forward(target_params, seq, t_cache)
    t = torch.argmax(logits, -1)                                # [B, nd+1]
    if force_accept:
        n = torch.full_like(n_acc, nd)
    else:
        n = torch.cumprod((t[:, :-1] == drafts).long(), 1).sum(1)
    from_draft = torch.gather(drafts, 1, (n - 1).clamp(min=0)[:, None])[:, 0]
    x_prev.copy_(torch.where(n > 0, from_draft, last))
    last.copy_(torch.gather(t, 1, n[:, None])[:, 0])
    # rollback: keep KV only for last + the accepted drafts
    off.add_(n + 1 if active is None
             else torch.where(active, n + 1, torch.zeros_like(n)))
    tgt.copy_(t)
    n_acc.copy_(n)
    return logits


class _Round:
    """The static buffers of one generation's rounds, on the device: the
    target offset [1] (the position of ``last``), ``last`` and ``x_prev``
    [1], this round's ``tgt`` [1, nd + 1] and ``n_acc`` [1]."""

    def __init__(self, t_cache, d_cache, offset: int, last, x_prev, nd: int):
        dev = last.device
        self.t_off = torch.full((1,), offset, dtype=torch.long, device=dev)
        self.t_cache = ModelCache(layers=t_cache.layers, offset=self.t_off)
        self.d_layers = d_cache.layers
        self.last = last.reshape(1).long().clone()
        self.x_prev = x_prev.reshape(1).long().clone()
        self.tgt = torch.zeros(1, nd + 1, dtype=torch.long, device=dev)
        self.n_acc = torch.zeros(1, dtype=torch.long, device=dev)


class SpeculativeEngine:
    """``SpeculativeEngine(target_forward, target_params, draft_forward,
    draft_params, num_draft_tokens=4, force_accept=False)``, forwards of
    the form ``forward(params, tokens, cache) -> (logits, cache)``.

    force_accept (benchmarking only): every draft counts as verified (all
    the work still runs): the throughput ceiling at acceptance 1 for a
    draft of this size. target_prefill_forward: the variant for the
    target's first, fresh prefill (e.g. ``base.forward`` with
    fresh_prefill=True, K2 on CUDA); default the plain forward, with which
    the JAX package prefills, as the draft here does."""

    def __init__(self, target_forward: Callable, target_params,
                 draft_forward: Callable, draft_params,
                 num_draft_tokens: int = 4, force_accept: bool = False,
                 target_prefill_forward: Optional[Callable] = None):
        if num_draft_tokens < 1:
            raise ValueError("num_draft_tokens must be >= 1")
        self.tf, self.tp = target_forward, target_params
        self.df, self.dp = draft_forward, draft_params
        self.tpf = target_prefill_forward or target_forward
        self.nd = num_draft_tokens
        self.force_accept = force_accept
        # the last generation's round capture: its ms and the pool's bytes
        self.capture_ms = 0.0
        self.pool_bytes = 0

    # ------------------------------------------------------------ round --

    def round(self, st: _Round) -> torch.Tensor:
        """One draft-and-verify round over ``st``'s buffers (the JAX
        package's ``_draft_impl`` then ``_verify_impl``). Returns the
        target's logits [1, nd + 1, V]."""
        return draft_and_verify(self.tf, self.tp, self.df, self.dp, self.nd,
                                st.t_cache, st.d_layers, st.last, st.x_prev,
                                st.tgt, st.n_acc,
                                force_accept=self.force_accept)

    # ------------------------------------------------------------ loops --

    @torch.inference_mode()
    def _start(self, prompt, t_cache, d_cache):
        """Prefill both models on the whole prompt (eager) and set up the
        round's buffers; returns (state, first token on the host)."""
        if prompt.ndim == 1:
            prompt = prompt[None]
        if prompt.shape[0] != 1:
            raise ValueError("speculative decoding runs one sequence")
        T = prompt.shape[1]
        t_logits, t_cache = self.tpf(self.tp, prompt, t_cache)
        _, d_cache = self.df(self.dp, prompt, d_cache)
        last = torch.argmax(t_logits[:, -1], -1)
        st = _Round(t_cache, d_cache, T, last, prompt[:, -1], self.nd)
        return st, int(st.last[0])

    def _rounds(self, st: _Round, room: Callable[[int], bool],
                max_tokens: int, stats: Optional[SpecStats]):
        """Run rounds, one queued ahead of the host, and yield each
        processed round's emitted tokens (n_accept + 1 of them: the
        accepted drafts and the target's correction). A round is queued
        only where it fits the cache whatever the pending rounds accept
        (``room(produced)`` on the most they can have produced), else the
        host catches up first and asks with what it knows; no round is
        queued once the pending ones have produced ``max_tokens``. The
        caller stops when it likes; a queued round is then discarded."""
        cuda = st.last.is_cuda
        bodies = CapturedBodies(st.last.device)
        pending: List[tuple] = []
        produced = 1                    # the first token, from the prefill
        try:
            while True:
                queue_more = (produced + len(pending) < max_tokens
                              and room(produced + len(pending)
                                       * (self.nd + 1)))
                if queue_more:
                    bodies.run("round", lambda: self.round(st))
                    tgt_h = torch.empty(1, self.nd + 1, dtype=torch.long,
                                        pin_memory=cuda)
                    nacc_h = torch.empty(1, dtype=torch.long,
                                         pin_memory=cuda)
                    tgt_h.copy_(st.tgt, non_blocking=True)
                    nacc_h.copy_(st.n_acc, non_blocking=True)
                    ev = None
                    if cuda:
                        ev = torch.cuda.Event()
                        ev.record()
                    pending.append((tgt_h, nacc_h, ev))
                    if len(pending) < 2:
                        continue
                if not pending:
                    return
                tgt_h, nacc_h, ev = pending.pop(0)
                if ev is not None:
                    ev.synchronize()
                n = int(nacc_h[0])
                if stats is not None:
                    stats.rounds += 1
                    stats.drafted += self.nd
                    stats.accepted += n
                produced += n + 1
                yield tgt_h[0, :n + 1].tolist()
        finally:
            self.capture_ms = bodies.capture_ms.get("round", 0.0)
            self.pool_bytes = bodies.pool_bytes
            bodies.close()

    @torch.inference_mode()
    def generate(self, prompt: torch.Tensor, t_cache: ModelCache,
                 d_cache: ModelCache, max_tokens: int = 256,
                 stop_tokens: tuple = (),
                 stats: Optional[SpecStats] = None) -> Iterator[int]:
        """Streaming speculative generation for one sequence: yields token
        ids, token for token plain greedy decoding's (approximately, where
        a layer is recurrent)."""
        T = prompt.shape[-1]
        cap = _capacity(t_cache)
        if cap is not None and T + max_tokens + self.nd + 1 > cap:
            # a verify round writes nd+1 transient KV entries; past
            # capacity the writes would clamp onto real slots
            raise ValueError(
                f"prompt ({T}) + max_tokens ({max_tokens}) + draft headroom "
                f"({self.nd + 1}) exceeds KV cache capacity {cap}")
        st, t = self._start(prompt, t_cache, d_cache)
        if t in stop_tokens:
            return
        yield t
        if max_tokens <= 1:
            return
        produced = 1

        def room(n):
            # the round starts at offset T + n - 1 and writes nd + 1
            return cap is None or T + n + self.nd <= cap

        with contextlib.closing(
                self._rounds(st, room, max_tokens, stats)) as rounds:
            for toks in rounds:
                for t in toks:
                    if t in stop_tokens:
                        return
                    yield t
                    produced += 1
                    if produced >= max_tokens:
                        return

    @torch.inference_mode()
    def generate_scan(self, prompt: torch.Tensor, t_cache: ModelCache,
                      d_cache: ModelCache, max_tokens: int = 256,
                      stop_tokens: tuple = (),
                      stats: Optional[SpecStats] = None):
        """Rounds until ``max_tokens`` tokens are out or a stop token
        lands, each round replayed; as the JAX package's, no round runs
        where the cache lacks room for its writes plus the next round's
        headroom (``(cap - (T + produced) - (nd + 2)) // (nd + 1) >= 1``),
        so near capacity it may stop short. Returns (tokens, rounds), the
        rounds whose tokens were read."""
        T = prompt.shape[-1]
        cap = _capacity(t_cache)
        st, t = self._start(prompt, t_cache, d_cache)
        out: List[int] = []
        rounds = 0
        if t in stop_tokens:
            return out, rounds
        out.append(t)

        def room(n):
            return cap is None or \
                (cap - (T + n) - (self.nd + 2)) // (self.nd + 1) >= 1

        if len(out) >= max_tokens:
            return out, rounds
        with contextlib.closing(
                self._rounds(st, room, max_tokens, stats)) as run:
            for toks in run:
                rounds += 1
                for t in toks:
                    if t in stop_tokens:
                        return out, rounds
                    out.append(t)
                    if len(out) >= max_tokens:
                        return out, rounds
        return out, rounds
