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

from ominix_mlx_tpu_torch.core.cache import ModelCache
from ominix_mlx_tpu_torch.core.sampling import SamplerConfig, sample


def bucket_length(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _kv_capacity(cache: ModelCache) -> Optional[int]:
    caps = [lc.max_len for lc in cache.layers if hasattr(lc, "max_len")]
    return min(caps) if caps else None


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
    CUDA). Defaults to forward_fn. The cache's KV buffers are written in
    place by every call.
    """

    def __init__(self, forward_fn: Callable, params,
                 sampler: SamplerConfig = SamplerConfig(),
                 prefill_forward_fn: Optional[Callable] = None):
        self.forward_fn = forward_fn
        self.prefill_forward_fn = prefill_forward_fn or forward_fn
        self.params = params
        self.sampler = sampler

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, cache: ModelCache,
                fresh: bool = True):
        """tokens: [B, T] on the model's device -> (last_logits [B, V],
        cache). The prompt is zero-padded to a power-of-two bucket (>= 16);
        the padded tail writes KV slots past offset + T that the causal
        mask never exposes and decode overwrites."""
        B, T = tokens.shape
        cap = _kv_capacity(cache)
        if cap is not None and T > cap:
            raise ValueError(f"prompt length {T} exceeds KV cache capacity "
                             f"{cap}; create the cache with a larger "
                             f"max_len")
        bucket = bucket_length(T) if cap is None else min(bucket_length(T),
                                                          cap)
        start = cache.offset
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
    def generate_scan(self, prompt: torch.Tensor, cache: ModelCache,
                      max_tokens: int,
                      generator: Optional[torch.Generator] = None):
        """Fixed-length generation with no host round trip per token: the
        sampled tokens stay on the device, the loop runs ``max_tokens``
        decode steps like the JAX package's ``lax.scan``, and the caller
        reads the tokens once. Returns (tokens [B, max_tokens] on the
        device, cache)."""
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
