"""Samplers: argmax / temperature / top-k / top-p / min-p / repetition
penalty (counterpart of ominix_mlx_tpu/core/sampling.py, same filters).

Randomness comes from an explicit ``torch.Generator``; it draws other
numbers than ``jax.random`` for the same seed, so only greedy sampling
agrees token for token with the JAX package. ``sample`` reads nothing on
the host, so the engine's captured decode step runs it on the device.

``SamplerParams`` / ``sample_slots`` are the per-row form for the
continuous batcher: settings held as [B] tensors, and each row's draw
keyed on the device by its (seed, position) through a counter hash
(``slot_noise``), with no generator and no host read.
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
    return draw(torch.softmax(logits, -1), generator)


def draw(probs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One token a row of probs [B, V] -> [B] int64: argmax of probs over
    exponential noise from ``generator``, the draw of ``torch.multinomial(
    probs, 1)`` (its one-sample path, the same numbers from the same
    generator state) without the host read by which multinomial first
    checks probs: a CUDA graph can capture it."""
    noise = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / noise, -1)


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


MASK32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """(a * m) mod 2^32 for int64 words a in [0, 2^32) and a constant m in
    [0, 2^32), in int64 without overflow: a's halves times m stay under
    2^49."""
    lo = (a & 0xFFFF) * m
    hi = ((a >> 16) * (m & 0xFFFF)) << 16
    return (lo + hi) & MASK32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """MurmurHash3's 32-bit finalizer on int64 words in [0, 2^32) (every
    word stays non-negative, so the right shifts are logical)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def slot_noise(seeds: torch.Tensor, positions: torch.Tensor,
               vocab: int) -> torch.Tensor:
    """Exponential(1) noise [B, V] float32 keyed on the device by each
    row's (seed, absolute position) alone: a counter hash of (seed's low
    and high words, position, vocabulary index), no generator state. So a
    draw depends on nothing but the row's seed, position and logits: not
    on the slot, the step or the rows beside it. seeds, positions: [B]
    int64, seeds in [0, 2^63). The uniform is the hash's top 23 bits
    plus a half, over 2^23: k + 0.5 for k < 2^23 is exact in float32, so
    u lies in (0, 1) and the noise is > 0 (a 24th bit would round
    k = 2^24 - 1 up to u = 1, noise 0, and a filtered entry's 0 / 0)."""
    s = seeds.long()
    p = positions.long() & MASK32
    h = _fmix32((s & MASK32) ^ 0x9E3779B9)
    h = _fmix32(h ^ (s >> 32))
    h = _fmix32(h ^ p)                                           # [B]
    idx = torch.arange(vocab, dtype=torch.long, device=seeds.device)
    col = _fmix32(_mul32(idx, 0x9E3779B1) ^ 0x7F4A7C15)          # [V]
    x = _fmix32(h[:, None] ^ col[None, :])                       # [B, V]
    return _exp_noise(x)


def _exp_noise(x: torch.Tensor) -> torch.Tensor:
    """Exponential(1) noise from 32-bit hash words in [0, 2^32)."""
    u = ((x >> 9).float() + 0.5) * (1.0 / (1 << 23))
    return -torch.log(u)


def seed_word(seed: int) -> int:
    """A request's seed as the non-negative int64 word ``slot_noise``
    keys on."""
    return int(seed) % (1 << 63)


def sample_slots(logits: torch.Tensor, sp: SamplerParams,
                 seeds: torch.Tensor, positions: torch.Tensor,
                 recent: Optional[torch.Tensor] = None,
                 sampled: bool = True) -> torch.Tensor:
    """logits [B, V] -> tokens [B] int64, per-row settings from ``sp``,
    with nothing read on the host (the continuous batcher's captured step
    runs it).

    Every row takes the repetition penalty (rows at 1.0 are unchanged)
    and one batched argmax: a greedy row's token. With ``sampled`` every
    row also goes through the JAX package's filters (temperature, top-k,
    top-p, min-p) and draws by argmax of probs over ``slot_noise(seeds,
    positions)``; rows with temperature <= 0 keep the argmax. So a greedy
    row's token is the same whether ``sampled`` is set or not, and
    whatever rows sit beside it. The caller clears ``sampled`` when no
    row samples (the two sorts over [B, V] are skipped)."""
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
    if not sampled:
        return out
    scaled = logits / sp.temperature.clamp(min=1e-6)[:, None]
    # top-k: kth-largest threshold via one sort; k <= 0 keeps all
    sorted_desc = torch.sort(scaled, -1, descending=True).values
    k = sp.top_k
    k_eff = (torch.where(k <= 0, torch.full_like(k, V), k) - 1).clamp(0, V - 1)
    thresh_k = torch.gather(sorted_desc, -1, k_eff[:, None])
    scaled = scaled.masked_fill(scaled < thresh_k, float("-inf"))
    # top-p over the survivors
    sorted_desc = torch.sort(scaled, -1, descending=True).values
    probs = torch.softmax(sorted_desc, -1)
    cum = torch.cumsum(probs, -1)
    keep = cum - probs < sp.top_p[:, None]
    thresh_p = torch.where(keep, sorted_desc,
                           torch.full_like(sorted_desc, float("inf")))
    scaled = scaled.masked_fill(scaled < thresh_p.amin(-1, keepdim=True),
                                float("-inf"))
    # min-p
    probs = torch.softmax(scaled, -1)
    top = probs.amax(-1, keepdim=True)
    scaled = scaled.masked_fill(probs < sp.min_p[:, None] * top,
                                float("-inf"))
    probs = torch.softmax(scaled, -1)
    drawn = torch.argmax(probs / slot_noise(seeds, positions, V), -1)
    return torch.where(sp.temperature <= 0.0, out, drawn)
