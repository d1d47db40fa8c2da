"""Lightning (GLA) linear attention with an ALiBi decay, MiniCPM-SALA's
mixer with a fixed-size state (counterpart of
ominix_mlx_tpu/models/lightning.py).

    state_{t} = exp(slope) * state_{t-1} + k_t^T v_t
    out_t     = q_t state_t

A layer keeps one float32 state [B, H, D, D]: O(1) memory in the sequence
length. ``gla_decode_step`` and ``gla_chunked`` keep the JAX signatures
and run the plain versions (``ops.lightning_attention``); the model calls
``ops.lightning_attention.lightning_attention``, kernel K10 on CUDA.
Unlike the JAX package, whose caches are values, the state is written IN
PLACE, so the batcher's row views carry it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.ops import lightning_attention as la


@dataclasses.dataclass
class GLACache:
    """One lightning layer's state (ominix_mlx_tpu/models/lightning.py:
    29-37). It has no ``max_len``: ``core.cache.ingests_padding`` is true
    for it (every position feeds the state)."""

    state: torch.Tensor   # [B, H, D, D] float32

    @staticmethod
    def init(batch: int, n_heads: int, head_dim: int,
             device=None) -> "GLACache":
        """A zeroed state on ``device`` (default: the current CUDA
        device)."""
        return GLACache(state=torch.zeros(
            batch, n_heads, head_dim, head_dim, dtype=torch.float32,
            device=resolve_device(device)))

    def rows(self, b: int) -> "GLACache":
        """Row b as a view: writes through it land in this cache."""
        return GLACache(state=self.state[b:b + 1])

    def zero_(self) -> "GLACache":
        self.state.zero_()
        return self


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Negated ALiBi slopes (copied from ominix_mlx_tpu/models/
    lightning.py:40-55)."""
    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3.0)))
        return [start * start ** i for i in range(n)]

    def slopes(n):
        if math.log2(n).is_integer():
            return pow2(n)
        c = 2 ** int(math.floor(math.log2(n)))
        s = pow2(c)
        extra = slopes(2 * c)
        s += extra[0::2][: n - c]
        return s[:n]

    return -np.asarray(slopes(n_heads), np.float32)


_SLOPES: dict = {}


def slopes_on(n_heads: int, device) -> torch.Tensor:
    """``alibi_slopes`` as a float32 tensor on ``device``, made once per
    (heads, device): a decode step copies nothing to the card."""
    key = (n_heads, str(device))
    if key not in _SLOPES:
        _SLOPES[key] = torch.from_numpy(alibi_slopes(n_heads)).to(device)
    return _SLOPES[key]


def decay_tensors(chunk: int, slopes: np.ndarray):
    """(intra_mask [1, H, C, C], q_decay [1, H, C, 1], rev_decay
    [1, H, C, 1], chunk_decay [1, H, 1, 1]) in float32, as the JAX
    package's (ominix_mlx_tpu/models/lightning.py:58-72)."""
    i = np.arange(chunk)
    s = np.asarray(slopes)[:, None, None]
    intra = np.where(i[None, :, None] >= i[None, None, :],
                     np.exp(s * (i[:, None] - i[None, :])), 0.0)
    q_dec = np.exp(np.asarray(slopes)[:, None] * (i + 1))
    rev_dec = np.exp(np.asarray(slopes)[:, None] * (chunk - i - 1))
    chk_dec = np.exp(np.asarray(slopes) * chunk)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    return (f32(intra[None]), f32(q_dec[None, :, :, None]),
            f32(rev_dec[None, :, :, None]), f32(chk_dec[None, :, None, None]))


def _as_tensor(slopes, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(slopes, np.float32), device=device)


def gla_decode_step(q, k, v, slopes, cache: GLACache):
    """One step (ominix_mlx_tpu/models/lightning.py:75-83): q, k, v
    [B, H, 1, D] -> (out [B, H, 1, D] float32, the cache, its state
    advanced in place). The plain version."""
    out = la.decay_step_reference(q, k, v, _as_tensor(slopes, q.device),
                                  cache.state)
    return out, cache


def gla_chunked(q, k, v, slopes, cache: GLACache, chunk: int = 64):
    """Chunked prefill (ominix_mlx_tpu/models/lightning.py:86-119): q, k,
    v [B, H, L, D], any L -> (out [B, H, L, D] float32, the cache, its
    state advanced in place). The plain version; a short final chunk takes
    its own decays, the JAX package's pad-and-correct's function."""
    out = la.chunked_reference(q, k, v, _as_tensor(slopes, q.device),
                               cache.state, chunk)
    return out, cache
