"""Generation engine: bucketed prefill, and decode through one step captured
as a CUDA graph (counterpart of ominix_mlx_tpu/core/generate.py).

The JAX engine compiles its decode step (``_decode_jit``, the ``lax.scan``
of ``generate_scan`` and of ``generate_batch``). Here ``DecodeStep`` is that
step: one plain body over static buffers (the forward at T = 1 at a [B]
int64 offset tensor, the sampler, the in-place update of the step's own
state). On a CUDA cache its first call runs the body eagerly on a side
stream (the warm-up, which allocates the kernel wrappers' persistent
buffers outside the graph's pool), then captures it; every later call
replays the graph, and the launches recorded at the capture count again
(``ops._build.recording``). A capture that fails raises; nothing falls
back to an eager loop. The graph and its memory pool live for the call
that made them. On a CPU cache every call runs the body: the plain path
the tests hold to the JAX package. ``CapturedBodies`` is that machinery
on its own (bodies under keys, one pool), which the continuous batcher's
step and the speculative round use too.

``generate`` replays step i+1 before it reads token i, which it copies out
of the static buffer into pinned host memory behind an event;
``generate_scan`` reads no token until the loop is done; ``generate_batch``
keeps the finish flags, the stop test and a finished row's held offset in
the step.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterator, Optional

import torch
import torch.nn.functional as F

from ominix_mlx_tpu_torch.core.cache import ModelCache, ingests_padding
from ominix_mlx_tpu_torch.core.sampling import SamplerConfig, sample
from ominix_mlx_tpu_torch.ops import _build


def bucket_length(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _kv_capacity(cache: ModelCache) -> Optional[int]:
    """The least KV capacity of the cache's layers; None where no layer
    has one (every layer recurrent)."""
    caps = [lc.max_len for lc in cache.layers if hasattr(lc, "max_len")]
    return min(caps) if caps else None


def _exact(cache: ModelCache) -> bool:
    """Whether a layer ingests padding (a recurrent layer's state takes
    every position it is given): prefill then runs exact lengths."""
    return any(ingests_padding(lc) for lc in cache.layers)


@dataclasses.dataclass
class GenerationStats:
    prompt_tokens: int = 0
    generated_tokens: int = 0
    prefill_time_s: float = 0.0
    decode_time_s: float = 0.0

    @property
    def decode_tps(self) -> float:
        return (self.generated_tokens / self.decode_time_s
                if self.decode_time_s else 0.0)

    @property
    def prefill_tps(self) -> float:
        return (self.prompt_tokens / self.prefill_time_s
                if self.prefill_time_s else 0.0)


class Engine:
    """Wraps a model ``forward(params, tokens, cache) -> (logits, cache)``.

    prefill_forward_fn: the variant for the FIRST prefill on an empty cache
    (``base.forward`` with ``fresh_prefill=True``, which runs kernel K2 on
    CUDA). Defaults to forward_fn.

    chunk_forward_fn(params, tokens, cache, kv_limit): the variant for
    CONTINUATION chunks of a long prefill, attending only the first
    ``kv_limit`` cache slots (``base.forward`` with ``kv_limit=``, kernel
    K2c on CUDA). chunk_hidden_forward_fn: the same with its first return
    value ignored (``skip_logits=True``), for non-final chunks.

    The cache's KV buffers are written in place by every call.
    """

    def __init__(self, forward_fn: Callable, params,
                 sampler: SamplerConfig = SamplerConfig(),
                 prefill_forward_fn: Optional[Callable] = None,
                 chunk_forward_fn: Optional[Callable] = None,
                 chunk_hidden_forward_fn: Optional[Callable] = None):
        self.forward_fn = forward_fn
        self.prefill_forward_fn = prefill_forward_fn or forward_fn
        self.chunk_forward_fn = chunk_forward_fn
        self.chunk_hidden_forward_fn = chunk_hidden_forward_fn
        self.params = params
        self.sampler = sampler

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, cache: ModelCache,
                fresh: bool = True):
        """tokens: [B, T] on the model's device -> (last_logits [B, V],
        cache). The prompt is zero-padded to a power-of-two bucket (>= 16);
        the padded tail writes KV slots past offset + T that the causal
        mask never exposes and decode overwrites. Where a layer ingests
        padding (a hybrid's recurrent layers), the prompt runs at exactly
        T, as the JAX package does."""
        B, T = tokens.shape
        if isinstance(cache.offset, torch.Tensor):
            raise ValueError("prefill takes a cache at one shared offset")
        cap = _kv_capacity(cache)
        if cap is not None and T > cap:
            raise ValueError(f"prompt length {T} exceeds KV cache capacity "
                             f"{cap}; create the cache with a larger "
                             f"max_len")
        bucket = bucket_length(T) if cap is None else min(bucket_length(T),
                                                          cap)
        start = cache.offset
        if _exact(cache):
            bucket = T
        if not fresh and cap is not None:
            free = cap - start
            if T > free:
                raise ValueError(f"prompt length {T} exceeds the cache's "
                                 f"remaining capacity {free}")
            bucket = min(bucket, free)
        padded = F.pad(tokens, (0, bucket - T))
        fn = self.prefill_forward_fn if fresh else self.forward_fn
        logits, cache = fn(self.params, padded, cache)
        cache = ModelCache(layers=cache.layers, offset=start + T)
        return logits[:, T - 1], cache

    @torch.inference_mode()
    def prefill_chunked(self, tokens: torch.Tensor, cache: ModelCache,
                        chunk_size: int = 512):
        """Long-prompt prefill in fixed chunks: bounds per-chunk attention
        memory. The first chunk rides the fresh path (K2); continuation
        chunks attend the first ``kv_limit`` cache slots through
        ``chunk_forward_fn`` (K2c on CUDA), O(tokens written so far) per
        chunk instead of O(capacity). Where a layer ingests padding, every
        chunk runs at its exact width. Returns (last_logits [B, V],
        cache)."""
        B, T = tokens.shape
        cap = _kv_capacity(cache)
        exact = _exact(cache)
        last = None
        pos = 0
        while pos < T:
            end = min(pos + chunk_size, T)
            if pos == 0 or self.chunk_forward_fn is None:
                last, cache = self.prefill(tokens[:, pos:end], cache,
                                           fresh=(pos == 0))
            else:
                # pad to the chunk size but never past capacity (a padded
                # window past capacity would write out of the cache); the
                # exact fit keeps kv_limit == chunk start + width
                real = end - pos
                width = chunk_size if cap is None else min(chunk_size,
                                                           cap - pos)
                if exact:
                    width = real
                padded = F.pad(tokens[:, pos:end], (0, width - real))
                final = end >= T
                fn = (self.chunk_forward_fn
                      if final or self.chunk_hidden_forward_fn is None
                      else self.chunk_hidden_forward_fn)
                out, cache = fn(self.params, padded, cache, pos + width)
                cache = ModelCache(layers=cache.layers, offset=pos + real)
                if final:
                    last = out[:, real - 1]
            pos = end
        return last, cache

    def decode_step(self, cache: ModelCache, tok: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    recent: Optional[torch.Tensor] = None,
                    toks: Optional[torch.Tensor] = None) -> "DecodeStep":
        """The decode step of ``generate`` and ``generate_scan`` over static
        buffers: ``tok`` [B] int64, the step's input token, overwritten
        with the one it samples; ``recent`` [B, W] (the repetition-penalty
        window) rolled in place; ``toks`` [B, n], whose column i takes step
        i's input token. The cache's layers are written in place at the
        step's own offset tensor, started at ``cache.offset``."""
        step = DecodeStep(cache, tok, generator)
        fwd, params, sampler = self.forward_fn, self.params, self.sampler

        def body():
            if toks is not None:
                toks.index_copy_(1, step.index, step.tok[:, None])
            logits, _ = fwd(params, step.tok[:, None], step.cache)
            logits = logits[:, -1]
            nxt = sample(logits, generator, sampler, recent)
            if recent is not None:
                # the window rolls on the device (JAX :126-127)
                recent.copy_(torch.cat([recent[:, 1:], nxt[:, None]], -1))
            step.tok.copy_(nxt)
            step.advance()
            return logits

        step.body = body
        return step

    @torch.inference_mode()
    def generate(self, prompt: torch.Tensor, cache: ModelCache,
                 max_tokens: int = 256, stop_tokens: tuple = (),
                 generator: Optional[torch.Generator] = None,
                 stats: Optional[GenerationStats] = None) -> Iterator[int]:
        """Streaming generation for one sequence (B=1): yields token ids.
        Step i+1 is replayed before token i is read on the host, so host
        work (detokenising, stop checks) overlaps the device: each token
        is copied out of the step's buffer into its own pinned host slot
        behind an event, before the next replay overwrites the buffer."""
        if prompt.ndim == 1:
            prompt = prompt[None]
        cap = _kv_capacity(cache)
        off = cache.offset
        if cap is not None and off + prompt.shape[1] + max_tokens > cap:
            raise ValueError(
                f"offset ({off}) + prompt ({prompt.shape[1]}) + max_tokens "
                f"({max_tokens}) exceeds KV cache capacity {cap}")
        t0 = time.perf_counter()
        logits, cache = self.prefill(prompt, cache, fresh=(off == 0))
        if stats is not None:
            stats.prompt_tokens = int(prompt.shape[1])
        return self.decode(logits, cache, max_tokens, stop_tokens,
                           generator, stats, t0)

    @torch.inference_mode()
    def decode(self, logits: torch.Tensor, cache: ModelCache,
               max_tokens: int = 256, stop_tokens: tuple = (),
               generator: Optional[torch.Generator] = None,
               stats: Optional[GenerationStats] = None,
               t0: Optional[float] = None) -> Iterator[int]:
        """The streaming decode of ``generate`` after a prefill that left
        ``logits`` [B, V] (its last position) and ``cache``: the first
        token is sampled from ``logits``, each later one by the captured
        step; yields row 0's tokens, stopping before a stop token (the
        callers that prefill input embeddings themselves, such as the
        VLM and OCR pipelines, enter here). ``t0``: the prefill's start
        on the host clock, for ``stats.prefill_time_s``."""
        B = logits.shape[0]
        recent = None
        if self.sampler.repetition_penalty != 1.0:
            recent = torch.full((B, self.sampler.repetition_context), -1,
                                dtype=torch.long, device=logits.device)
        tok = sample(logits, generator, self.sampler, recent)
        if recent is not None:
            recent[:, -1] = tok
        pending_host = None
        if stats is not None:
            pending_host = int(tok[0])        # waits for the prefill
            if t0 is not None:
                stats.prefill_time_s = time.perf_counter() - t0
        return self._stream(cache, tok, max_tokens, stop_tokens, generator,
                            recent, pending_host, stats)

    @torch.inference_mode()
    def _stream(self, cache, tok, max_tokens, stop_tokens, generator,
                recent, pending_host, stats):
        step = self.decode_step(cache, tok, generator, recent)
        out = _TokenCopies(tok)
        out.put(0, step.tok)
        n = 0
        td0 = time.perf_counter()
        try:
            for i in range(max_tokens):
                if i + 1 < max_tokens:
                    step()
                    out.put(i + 1, step.tok)
                t = pending_host if pending_host is not None else out.get(i)
                pending_host = None
                n += 1
                if t in stop_tokens:
                    break
                yield t
                if i + 1 >= max_tokens:
                    break
        finally:
            step.close()
        if stats is not None:
            stats.generated_tokens = n
            stats.decode_time_s = time.perf_counter() - td0

    @torch.inference_mode()
    def generate_batch(self, prompts: torch.Tensor, cache: ModelCache,
                       max_tokens: int = 256, stop_tokens: tuple = (),
                       pad_id: int = 0,
                       generator: Optional[torch.Generator] = None,
                       prompt_lengths=None):
        """Batched decode with per-sequence finish flags.

        prompts: [B, T] RIGHT-padded to a common width; ``prompt_lengths``
        [B] gives each row's true length (None: all rows are length T).
        Right padding keeps every real token at its true RoPE position and
        the pads' garbage KV past each row's offset, where the causal mask
        never exposes it and decode overwrites it; decode then runs at
        per-row offsets. The step holds the finish flags, the stop test,
        the pad and a finished row's offset (its writes overwrite one
        garbage slot). Returns (tokens [B, max_tokens] with pad_id after
        each stop, lengths [B]), on the device."""
        B, T = prompts.shape
        dev = prompts.device
        if prompt_lengths is not None and _exact(cache) \
                and any(int(n) != T for n in prompt_lengths):
            raise ValueError("a recurrent layer's state takes every "
                             "position: right-padded prompts of other "
                             "lengths need one prefill each")
        cap = _kv_capacity(cache)
        if cap is not None and T + max_tokens > cap:
            raise ValueError(f"prompt ({T}) + max_tokens ({max_tokens}) "
                             f"exceeds KV cache capacity {cap}")
        lengths = (torch.full((B,), T, dtype=torch.long, device=dev)
                   if prompt_lengths is None
                   else torch.as_tensor(prompt_lengths, device=dev).long())
        stops = torch.tensor(list(stop_tokens) or [-1], device=dev)
        pad = torch.full((B,), pad_id, dtype=torch.long, device=dev)
        logits, cache = self.prefill_forward_fn(self.params, prompts, cache)
        last = logits[torch.arange(B, device=dev), lengths - 1]
        tok = sample(last, generator, self.sampler)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        toks = torch.empty(B, max_tokens, dtype=torch.long, device=dev)
        dones = torch.empty(B, max_tokens, dtype=torch.bool, device=dev)
        step = DecodeStep(ModelCache(layers=cache.layers, offset=lengths),
                          tok, generator, start=T)
        fwd, params, sampler = self.forward_fn, self.params, self.sampler

        def body():
            lg, _ = fwd(params, tok[:, None], step.cache)
            lg = lg[:, -1]
            nxt = sample(lg, generator, sampler)
            now = done | (tok[:, None] == stops[None]).any(-1)
            toks.index_copy_(1, step.index,
                             torch.where(now, pad, tok)[:, None])
            dones.index_copy_(1, step.index, now[:, None])
            tok.copy_(torch.where(now, tok, nxt))
            done.copy_(now)
            # a finished row holds its offset; a live one advances
            step.advance((~now).long())
            return lg

        step.body = body
        try:
            for _ in range(max_tokens):
                step()
        finally:
            step.close()
        return toks, (~dones).sum(-1)

    @torch.inference_mode()
    def generate_scan(self, prompt: torch.Tensor, cache: ModelCache,
                      max_tokens: int,
                      generator: Optional[torch.Generator] = None):
        """Fixed-length generation with no host round trip per token: the
        step writes its input token to ``toks[:, i]`` through a device step
        index, runs ``max_tokens`` times like the JAX package's
        ``lax.scan``, and the caller reads the tokens once. Runs at any
        batch B over a dense or paged cache. Returns (tokens [B,
        max_tokens] on the device, the cache at its start offset plus
        max_tokens)."""
        if prompt.ndim == 1:
            prompt = prompt[None]
        cap = _kv_capacity(cache)
        if cap is not None and prompt.shape[1] + max_tokens > cap:
            raise ValueError(
                f"prompt ({prompt.shape[1]}) + max_tokens ({max_tokens}) "
                f"exceeds KV cache capacity {cap}")
        logits, cache = self.prefill(prompt, cache)
        tok = sample(logits, generator, self.sampler)
        toks = torch.empty(prompt.shape[0], max_tokens, dtype=torch.long,
                           device=prompt.device)
        step = self.decode_step(cache, tok, generator, toks=toks)
        try:
            for _ in range(max_tokens):
                step()
        finally:
            step.close()
        return toks, ModelCache(layers=cache.layers,
                                offset=cache.offset + max_tokens)


class CapturedBodies:
    """Bodies captured as CUDA graphs that share one memory pool, each
    under a key, and replayed: the machinery of the engine's
    ``DecodeStep``, the continuous batcher's step (a greedy and a sampled
    body) and a speculative round.

    ``run(key, body)``: on the CPU, ``body()``. On CUDA, the first call
    for a key runs the body eagerly on a side stream (the warm-up, a real
    call: it allocates every wrapper's persistent buffers and initialises
    cuBLAS outside the pool), empties the allocator's cache, then captures
    it on that stream (``capture_error_mode="thread_local"``: another
    thread may launch meanwhile; a host sync in the body raises, and
    nothing falls back to an eager run) into the shared pool, recording
    its launches; later calls replay the graph and count its launches
    again (``ops._build.replayed``). Each call returns that call's output
    (a replay's lives in the pool and is overwritten by the next replay).
    The warm-up and capture run on one side stream a device, one at a
    time. Bodies that share the pool never run concurrently: a caller
    replays them on one stream. ``generator``: registered with every
    graph, so each replay draws from its state at that replay.
    ``close()`` waits for the replays, then drops the graphs and frees the
    pool."""

    def __init__(self, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        self.device = torch.device(device)
        self.generator = generator
        self.graphs: dict = {}          # key -> (graph, output)
        # kept after close(): key -> the capture's launch record, its ms
        self.records: dict = {}
        self.capture_ms: dict = {}
        self.pool_bytes = 0             # reserved by the captures, all keys
        self._pool = None

    def run(self, key, body: Callable):
        if self.device.type != "cuda":
            return body()
        got = self.graphs.get(key)
        if got is not None:
            graph, out = got
            graph.replay()
            _build.replayed(self.records[key])
            return out
        return self._warm_up_and_capture(key, body)

    def _warm_up_and_capture(self, key, body: Callable):
        side, lock = _capture_stream(self.device)
        main = torch.cuda.current_stream(self.device)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            register = getattr(graph, "register_generator_state", None)
            if register is None:
                raise RuntimeError(
                    "stochastic sampling in a CUDA graph needs "
                    "torch.cuda.CUDAGraph.register_generator_state, which "
                    f"torch {torch.__version__} lacks")
            register(self.generator)
        if self._pool is None:
            self._pool = torch.cuda.MemPool()
        held = self._pool.use_count()
        with lock, torch.cuda.stream(side):
            side.wait_stream(main)
            warm = body()                       # the warm-up: a real call
            # the graph's pool cannot reuse the blocks the warm-up cached:
            # give them back first (as torch.cuda.graph does), so the body
            # needs its transient memory once, not twice
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            t0 = time.perf_counter()
            with _build.recording() as record:
                graph.capture_begin(pool=self._pool.id,
                                    capture_error_mode="thread_local")
                try:
                    out = body()
                except BaseException:
                    _end_failed_capture(graph, self._pool, held,
                                        self.device)
                    # the traceback keeps this frame: let go of the graph
                    # now
                    graph = None
                    raise
                graph.capture_end()
            self.capture_ms[key] = (time.perf_counter() - t0) * 1e3
            self.pool_bytes += torch.cuda.memory_reserved(self.device) \
                - reserved
        main.wait_stream(side)
        self.graphs[key] = (graph, out)
        self.records[key] = record
        return warm

    def close(self):
        """Wait for the replays on the current stream, then drop the
        graphs and free the pool (their outputs go with them)."""
        if self.graphs:
            torch.cuda.current_stream(self.device).synchronize()
        self.graphs = {}
        self._pool = None

    def __del__(self):
        # the graphs before the pool they hold: a pool that dies under a
        # live graph aborts the process
        self.graphs = {}
        self._pool = None


class DecodeStep:
    """One decode step over static buffers, captured once as a CUDA graph
    on a CUDA cache and replayed (the counterpart of the JAX engine's
    compiled step) around ``tok``, its [B] int64 token buffer.
    ``Engine.decode_step`` and ``Engine.generate_batch`` set ``body``
    (the plain step: forward, sampler, in-place updates, ``advance``; it
    returns the step's logits [B, V]).

    The step owns ``offset``, a [B] int64 tensor on the cache's device
    started at the cache's offset, and ``cache``, the cache's layers at
    that offset; ``index`` is a one-element int64 step count on the
    device (the column a loop writes). ``steps`` counts calls on the host
    and ``offset_host`` mirrors the offsets (their largest, where a
    finished row holds), so nothing syncs to check capacity.

    Calling the step runs its ``captured`` bodies' ``CapturedBodies.run``
    on its body (key 0): on the CPU
    the body; on CUDA the warm-up and capture at the first call, then
    replays. ``body`` called directly runs the plain step on either
    device: tests and the smoke hold the replays to it. After each call,
    ``logits`` holds that step's logits (on CUDA in the graph's pool,
    until the next replay). ``close()`` waits for the replays and drops
    the graph and frees its pool."""

    def __init__(self, cache: ModelCache, tok: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 start: Optional[int] = None):
        """``start``: the host mirror of a [B] ``cache.offset`` (its
        largest row); an int offset is its own."""
        dev = tok.device
        if isinstance(cache.offset, torch.Tensor):
            if start is None:
                raise ValueError("a [B] offset needs its host mirror, start")
            self.offset = cache.offset.to(dev, torch.long).clone()
        else:
            start = cache.offset
            self.offset = torch.full(tok.shape, start, dtype=torch.long,
                                     device=dev)
        self.start = start
        self.cache = ModelCache(layers=cache.layers, offset=self.offset)
        self.index = torch.zeros(1, dtype=torch.long, device=dev)
        self.device = dev
        self.tok = tok
        self.body: Optional[Callable[[], torch.Tensor]] = None
        self.logits: Optional[torch.Tensor] = None
        self.steps = 0
        self.captured = CapturedBodies(dev, generator)

    @property
    def offset_host(self) -> int:
        return self.start + self.steps

    def advance(self, by=1):
        """The body's last act: the offsets by ``by`` (1, or a [B] tensor:
        0 for a finished row) and the step index by one, in place."""
        self.offset.add_(by)
        self.index.add_(1)

    def __call__(self):
        self.logits = self.captured.run(0, self.body)
        self.steps += 1

    def close(self):
        """Wait for the replays on the current stream, then drop the
        graph and free its pool (``logits`` goes with it: copy first what
        is to outlive the step)."""
        if self.captured.graphs:
            self.logits = None
        self.captured.close()


# per device: the side stream that every captured body's warm-up and
# capture run on, and a lock that takes them one at a time. One stream, so the
# warm-ups' cached blocks and cuBLAS's per-stream workspace are made once
# rather than on each new stream.
_CAPTURE_STREAMS: dict = {}
_CAPTURE_LOCK = threading.Lock()


def _capture_stream(device: torch.device):
    with _CAPTURE_LOCK:
        if device.index not in _CAPTURE_STREAMS:
            _CAPTURE_STREAMS[device.index] = (torch.cuda.Stream(device),
                                              threading.Lock())
        return _CAPTURE_STREAMS[device.index]


def _end_failed_capture(graph, pool, held: int, device):
    """End a capture whose body raised, so the stream leaves capture mode,
    and drop what it captured; the body's error is the one raised. An
    invalidated capture's end raises before the allocator stops routing
    to the pool and before the graph takes over the capture's hold on
    the pool, and a pool destroyed with either left aborts the process:
    stop the routing (a RuntimeError where it had stopped) and give the
    hold back, to the count the pool had before the capture began."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    try:
        torch._C._cuda_endAllocateToPool(index, pool.id)
    except RuntimeError:
        pass
    try:
        graph.reset()
    except RuntimeError:
        pass
    for _ in range(pool.use_count() - held):
        torch._C._cuda_releasePool(index, pool.id)


class _TokenCopies:
    """Row 0 of each step's token, copied out of the step's buffer into a
    pinned host slot behind an event (on CUDA), so the host reads token i
    while step i+1 runs; a ring of two slots. On the CPU a plain copy."""

    def __init__(self, like: torch.Tensor):
        cuda = like.is_cuda
        self.host = torch.empty(2, dtype=torch.long, pin_memory=cuda)
        self.events = [torch.cuda.Event() for _ in range(2)] if cuda \
            else None

    def put(self, i: int, tok: torch.Tensor):
        self.host[i % 2:i % 2 + 1].copy_(tok[:1], non_blocking=True)
        if self.events is not None:
            self.events[i % 2].record()

    def get(self, i: int) -> int:
        if self.events is not None:
            self.events[i % 2].synchronize()
        return int(self.host[i % 2])
