"""Generation engine: bucketed prefill, streaming decode, and a device-side
decode loop (counterpart of ominix_mlx_tpu/core/generate.py).

PyTorch runs eagerly, so there is no jit here. Tokens stay on the model's
device between steps: the streaming ``generate`` dispatches step i+1
before it reads token i on the host, and ``generate_scan`` never reads a
token until the loop is done. Capturing the decode step in a CUDA graph is
later work.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional

import torch
import torch.nn.functional as F

from ominix_mlx_tpu_torch.core.cache import ModelCache, ingests_padding
from ominix_mlx_tpu_torch.core.sampling import SamplerConfig, sample


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

    def _step(self, cache, tok, generator, recent):
        logits, cache = self.forward_fn(self.params, tok[:, None], cache)
        nxt = sample(logits[:, -1], generator, self.sampler, recent)
        if recent is not None:
            recent = torch.cat([recent[:, 1:], nxt[:, None]], -1)
        return nxt, cache, recent

    @torch.inference_mode()
    def generate(self, prompt: torch.Tensor, cache: ModelCache,
                 max_tokens: int = 256, stop_tokens: tuple = (),
                 generator: Optional[torch.Generator] = None,
                 stats: Optional[GenerationStats] = None) -> Iterator[int]:
        """Streaming generation for one sequence (B=1): yields token ids.
        Step i+1 is dispatched before token i is read on the host, so host
        work (detokenising, stop checks) overlaps the device."""
        if prompt.ndim == 1:
            prompt = prompt[None]
        B = prompt.shape[0]
        cap = _kv_capacity(cache)
        off = cache.offset
        if cap is not None and off + prompt.shape[1] + max_tokens > cap:
            raise ValueError(
                f"offset ({off}) + prompt ({prompt.shape[1]}) + max_tokens "
                f"({max_tokens}) exceeds KV cache capacity {cap}")
        recent = None
        if self.sampler.repetition_penalty != 1.0:
            recent = torch.full((B, self.sampler.repetition_context), -1,
                                dtype=torch.long, device=prompt.device)
        t0 = time.perf_counter()
        logits, cache = self.prefill(prompt, cache, fresh=(off == 0))
        tok = sample(logits, generator, self.sampler, recent)
        if recent is not None:
            recent[:, -1] = tok
        pending_host = None
        if stats is not None:
            pending_host = int(tok[0])        # waits for the prefill
            stats.prompt_tokens = int(prompt.shape[1])
            stats.prefill_time_s = time.perf_counter() - t0
        pending = tok
        n = 0
        td0 = time.perf_counter()
        for i in range(max_tokens):
            nxt = None
            if i + 1 < max_tokens:
                nxt, cache, recent = self._step(cache, pending, generator,
                                                recent)
            t = pending_host if pending_host is not None else int(pending[0])
            pending_host = None
            n += 1
            if t in stop_tokens:
                break
            yield t
            if nxt is None:
                break
            pending = nxt
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
        per-row offsets (a [B] tensor, no host sync per step). A finished
        row holds its offset, so its writes overwrite one garbage slot.
        Returns (tokens [B, max_tokens] with pad_id after each stop,
        lengths [B]), on the device."""
        B, T = prompts.shape
        dev = prompts.device
        if prompt_lengths is not None and _exact(cache) \
                and any(int(n) != T for n in prompt_lengths):
            raise ValueError("a recurrent layer's state takes every "
                             "position: right-padded prompts of other "
                             "lengths need one prefill each")
        lengths = (torch.full((B,), T, dtype=torch.long, device=dev)
                   if prompt_lengths is None
                   else torch.as_tensor(prompt_lengths, device=dev).long())
        stops = torch.tensor(list(stop_tokens) or [-1], device=dev)
        logits, cache = self.prefill_forward_fn(self.params, prompts, cache)
        cache = ModelCache(layers=cache.layers, offset=lengths)
        last = logits[torch.arange(B, device=dev), lengths - 1]
        tok = sample(last, generator, self.sampler)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        outs, dones = [], []
        for _ in range(max_tokens):
            lg, cache = self.forward_fn(self.params, tok[:, None], cache)
            nxt = sample(lg[:, -1], generator, self.sampler)
            done = done | torch.isin(tok, stops)
            outs.append(torch.where(done, torch.full_like(tok, pad_id), tok))
            dones.append(done)
            nxt = torch.where(done, tok, nxt)
            cache = ModelCache(layers=cache.layers,
                               offset=torch.where(done, cache.offset - 1,
                                                  cache.offset))
            tok = nxt
        toks = torch.stack(outs, 1)
        return toks, (~torch.stack(dones, 1)).sum(-1)

    @torch.inference_mode()
    def generate_scan(self, prompt: torch.Tensor, cache: ModelCache,
                      max_tokens: int,
                      generator: Optional[torch.Generator] = None):
        """Fixed-length generation with no host round trip per token: the
        sampled tokens stay on the device, the loop runs ``max_tokens``
        decode steps like the JAX package's ``lax.scan``, and the caller
        reads the tokens once. Runs at any batch B over a dense or paged
        cache. Returns (tokens [B, max_tokens] on the device, cache)."""
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
        for i in range(max_tokens):
            toks[:, i] = tok
            tok, cache, _ = self._step(cache, tok, generator, None)
        return toks, cache
