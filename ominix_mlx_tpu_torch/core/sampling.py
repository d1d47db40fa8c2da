"""Samplers: argmax / temperature / top-k / top-p / min-p / repetition
penalty (counterpart of ominix_mlx_tpu/core/sampling.py, same filters).

Randomness comes from an explicit ``torch.Generator``; it draws other
numbers than ``jax.random`` for the same seed, so only greedy sampling
agrees token for token with the JAX package.

``SamplerParams`` / ``sample_dynamic`` are the per-row form for the
continuous batcher: settings held as [B] tensors, one generator per
sampled row.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

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


# -------------------------------------------------- dynamic (per-row) form ---

@dataclasses.dataclass
class SamplerParams:
    """Per-row sampler settings as [B] tensors on the logits' device, so
    one decode step serves any per-slot mix of settings (counterpart of the
    JAX package's SamplerParams)."""

    temperature: torch.Tensor         # [B] f32; <= 0 -> greedy
    top_k: torch.Tensor               # [B] int64; 0 -> off
    top_p: torch.Tensor               # [B] f32; 1.0 -> off
    min_p: torch.Tensor               # [B] f32; 0.0 -> off
    repetition_penalty: torch.Tensor  # [B] f32; 1.0 -> off

    @staticmethod
    def from_config(cfg: SamplerConfig, batch: int = 1,
                    device=None) -> "SamplerParams":
        def f(v):
            return torch.full((batch,), float(v), dtype=torch.float32,
                              device=device)
        return SamplerParams(
            temperature=f(cfg.temperature),
            top_k=torch.full((batch,), int(cfg.top_k), dtype=torch.long,
                             device=device),
            top_p=f(cfg.top_p), min_p=f(cfg.min_p),
            repetition_penalty=f(cfg.repetition_penalty))

    def set_row(self, b: int, cfg: SamplerConfig) -> "SamplerParams":
        """Overwrite row ``b`` IN PLACE; returns self."""
        self.temperature[b] = cfg.temperature
        self.top_k[b] = cfg.top_k
        self.top_p[b] = cfg.top_p
        self.min_p[b] = cfg.min_p
        self.repetition_penalty[b] = cfg.repetition_penalty
        return self


def sample_dynamic(logits: torch.Tensor, sp: SamplerParams,
                   generators: Sequence[Optional[torch.Generator]],
                   recent: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int64, per-row settings from ``sp``.

    generators[b] is row b's ``torch.Generator``, or None for a greedy row
    (the host knows which rows sample). Every row takes the repetition
    penalty (rows at 1.0 are unchanged) and one batched argmax; only the
    sampled rows go through the per-row filters (top-k, top-p, min-p, the
    JAX package's formulas) and draw, each from its own generator. So a
    greedy row never depends on the sampled rows batched beside it, and no
    greedy row draws a random number."""
    logits = logits.float()
    B, V = logits.shape
    if recent is not None:
        pen = sp.repetition_penalty[:, None]
        hit = torch.zeros_like(logits).scatter_reduce_(
            -1, recent.clamp(min=0), (recent >= 0).float(),
            reduce="amax") > 0
        penalized = torch.where(logits > 0, logits / pen, logits * pen)
        logits = torch.where(hit & (pen != 1.0), penalized, logits)
    out = torch.argmax(logits, -1)
    rows: List[int] = [b for b, g in enumerate(generators) if g is not None]
    if not rows:
        return out
    idx = torch.tensor(rows, device=logits.device)
    lg = logits[idx]
    scaled = lg / sp.temperature[idx].clamp(min=1e-6)[:, None]
    # top-k: kth-largest threshold via one sort; k <= 0 keeps all
    sorted_desc = torch.sort(scaled, -1, descending=True).values
    k = sp.top_k[idx]
    k_eff = (torch.where(k <= 0, torch.full_like(k, V), k) - 1).clamp(0, V - 1)
    thresh_k = torch.gather(sorted_desc, -1, k_eff[:, None])
    scaled = scaled.masked_fill(scaled < thresh_k, float("-inf"))
    # top-p over the survivors
    sorted_desc = torch.sort(scaled, -1, descending=True).values
    probs = torch.softmax(sorted_desc, -1)
    cum = torch.cumsum(probs, -1)
    keep = cum - probs < sp.top_p[idx][:, None]
    thresh_p = torch.where(keep, sorted_desc,
                           torch.full_like(sorted_desc, float("inf")))
    scaled = scaled.masked_fill(scaled < thresh_p.amin(-1, keepdim=True),
                                float("-inf"))
    # min-p
    probs = torch.softmax(scaled, -1)
    top = probs.amax(-1, keepdim=True)
    scaled = scaled.masked_fill(probs < sp.min_p[idx][:, None] * top,
                                float("-inf"))
    probs = torch.softmax(scaled, -1)
    drawn = torch.cat([torch.multinomial(probs[i:i + 1], 1,
                                         generator=generators[b])[:, 0]
                       for i, b in enumerate(rows)])
    out[idx] = torch.where(sp.temperature[idx] <= 0.0, out[idx], drawn)
    return out
