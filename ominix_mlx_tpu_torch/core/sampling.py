"""Samplers: argmax / temperature / top-k / top-p / min-p / repetition
penalty (counterpart of ominix_mlx_tpu/core/sampling.py, same filters).

Randomness comes from an explicit ``torch.Generator``; it draws other
numbers than ``jax.random`` for the same seed, so only greedy sampling
agrees token for token with the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    temperature: float = 0.0
    top_k: int = 0              # 0 = off
    top_p: float = 1.0          # 1.0 = off
    min_p: float = 0.0          # 0.0 = off
    repetition_penalty: float = 1.0
    repetition_context: int = 64


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    thresh = torch.topk(logits, k, -1).values[..., -1:]
    return logits.masked_fill(logits < thresh, float("-inf"))


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, -1, descending=True).values
    probs = torch.softmax(sorted_logits, -1)
    cum = torch.cumsum(probs, -1)
    keep = cum - probs < p           # always keeps the top token
    thresh = torch.where(keep, sorted_logits,
                         torch.full_like(sorted_logits, float("inf")))
    thresh = thresh.amin(-1, keepdim=True)
    return logits.masked_fill(logits < thresh, float("-inf"))


def apply_min_p(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    if min_p <= 0.0:
        return logits
    probs = torch.softmax(logits, -1)
    top = probs.amax(-1, keepdim=True)
    return logits.masked_fill(probs < min_p * top, float("-inf"))


def apply_repetition_penalty(logits: torch.Tensor, recent: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """recent: [B, W] token ids, -1 for empty slots. Positive logits of
    recent tokens are divided by the penalty, negative ones multiplied."""
    if penalty == 1.0:
        return logits
    # max-reduce so a padding slot (clamped to id 0) never clears a real hit
    hit = torch.zeros_like(logits).scatter_reduce_(
        -1, recent.clamp(min=0), (recent >= 0).float(), reduce="amax") > 0
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(hit, pen, logits)


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           cfg: SamplerConfig,
           recent: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits: [B, V] -> tokens [B] int64. Stays on the logits' device."""
    logits = logits.float()
    if recent is not None and cfg.repetition_penalty != 1.0:
        logits = apply_repetition_penalty(logits, recent,
                                          cfg.repetition_penalty)
    if cfg.temperature <= 0.0:
        return torch.argmax(logits, -1)
    logits = logits / cfg.temperature
    logits = apply_top_k(logits, cfg.top_k)
    logits = apply_top_p(logits, cfg.top_p)
    logits = apply_min_p(logits, cfg.min_p)
    if generator is None:
        raise ValueError("stochastic sampling needs a torch.Generator")
    probs = torch.softmax(logits, -1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
