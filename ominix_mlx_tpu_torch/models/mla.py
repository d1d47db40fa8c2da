"""Multi-head latent attention (DeepSeek-V2/V3), absorbed form
(counterpart of ominix_mlx_tpu/models/mla.py).

The kv_b_proj up-projection is folded into the query and output paths
(``absorb_kv_b``, at load), so a layer's cache holds only the
``kv_lora_rank``-wide normed latent c and the ``qk_rope_head_dim``-wide
rotated key per token (576 numbers at DeepSeek's widths), one shared KV
head:

  q = q_proj(x)  or  q_b(rms(q_a(x)))           -> [B, T, H, nope + rope]
  c, k_rot = split(kv_a(x)); c = rms(c)          -> [B, T, Ckv], [B, T, rope]
  q_lat = q_nope @ W_UK                          -> [B, H, T, Ckv]
  scores = (q_lat . c_s + rot(q_rope) . rot(k_rot)_s) * scale
  out = o_proj((softmax(scores) @ c) @ W_UV^T)

Attention runs through the plain ``core.attention.sdpa`` at every length,
as in the JAX package, which runs no Pallas kernel here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ominix_mlx_tpu_torch.core.attention import sdpa
from ominix_mlx_tpu_torch.core.cache import KVCache
from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.core.rope import (RopeConfig, apply_rope,
                                            make_rope, positions_of)
from ominix_mlx_tpu_torch.nn.layers import linear, rms_norm


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    num_heads: int
    q_lora_rank: Optional[int]
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    rope_interleave: bool = True
    rope_scaling: Optional[dict] = None
    rms_norm_eps: float = 1e-6

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def scale(self) -> float:
        """The softmax scale: qk_head_dim^-0.5, times mscale^2 with
        mscale = 0.1 mscale_all_dim ln(factor) + 1 where the config's
        (yarn) rope_scaling gives both and factor > 1."""
        s = self.qk_head_dim ** -0.5
        if self.rope_scaling:
            m_all = self.rope_scaling.get("mscale_all_dim", 0)
            factor = self.rope_scaling.get("factor", 1.0)
            if m_all and factor > 1.0:
                mscale = 0.1 * m_all * math.log(factor) + 1.0
                s = s * mscale * mscale
        return s

    def rope(self) -> RopeConfig:
        """RoPE over the rope dims only, with no scaling (as in the JAX
        package: the yarn factor enters through ``scale`` alone)."""
        return make_rope(self.qk_rope_head_dim, self.rope_theta,
                         traditional=self.rope_interleave)


def absorb_kv_b(kv_b_weight: torch.Tensor, mcfg: MLAConfig):
    """kv_b_proj weight [H * (nope + v), Ckv] -> (W_UK [H, nope, Ckv],
    W_UV [H, v, Ckv]), the load-time fold."""
    w = kv_b_weight.reshape(mcfg.num_heads,
                            mcfg.qk_nope_head_dim + mcfg.v_head_dim,
                            mcfg.kv_lora_rank)
    return (w[:, :mcfg.qk_nope_head_dim].contiguous(),
            w[:, mcfg.qk_nope_head_dim:].contiguous())


def init_cache_layer(batch: int, mcfg: MLAConfig, max_len: int,
                     dtype=torch.bfloat16, device=None) -> KVCache:
    """The latent cache of one layer: k [B, 1, L, Ckv + rope] (c and the
    rotated key), v [B, 1, L, Ckv] (c again), on ``device`` (default: the
    current CUDA device)."""
    return KVCache.init(batch, 1, max_len,
                        mcfg.kv_lora_rank + mcfg.qk_rope_head_dim, dtype,
                        resolve_device(device), v_dim=mcfg.kv_lora_rank)


def attention_block(lp: dict, mcfg: MLAConfig, x: torch.Tensor,
                    cache: KVCache, offset,
                    mask: Callable[[], torch.Tensor],
                    kv_limit: Optional[int] = None):
    """x: [B, T, D] (already normed) -> ([B, T, D], cache). Writes c and
    the rotated key at ``offset`` (an int, or [B] per-row offsets) in
    place; ``mask()`` is the additive causal mask over the cache's
    columns, or its first ``kv_limit`` where a chunk of a long prefill
    attends only those."""
    B, T, _ = x.shape
    H = mcfg.num_heads
    rope = mcfg.rope()
    if mcfg.q_lora_rank is None:
        q = linear(lp["q_proj"], x)
    else:
        q = linear(lp["q_b_proj"],
                   rms_norm(lp["q_a_layernorm"], linear(lp["q_a_proj"], x),
                            mcfg.rms_norm_eps))
    q = q.reshape(B, T, H, mcfg.qk_head_dim)
    q_nope = q[..., :mcfg.qk_nope_head_dim]
    q_rope = q[..., mcfg.qk_nope_head_dim:]

    ckv = linear(lp["kv_a_proj_with_mqa"], x)
    c = rms_norm(lp["kv_a_layernorm"], ckv[..., :mcfg.kv_lora_rank],
                 mcfg.rms_norm_eps)                        # [B, T, Ckv]
    k_rot = ckv[..., mcfg.kv_lora_rank:]                   # [B, T, rope]

    positions = positions_of(offset, T, x.device)
    q_rope = apply_rope(q_rope.transpose(1, 2), positions, rope)
    k_rot = apply_rope(k_rot[:, None], positions, rope)    # [B, 1, T, rope]

    w_uk, w_uv = lp["w_uk"], lp["w_uv"]                    # [H, nope|v, Ckv]
    dt = torch.promote_types(q_nope.dtype, w_uk.dtype)
    q_lat = torch.einsum("bthn,hnc->bhtc", q_nope.to(dt), w_uk.to(dt))
    q_cat = torch.cat([q_lat, q_rope.to(q_lat.dtype)], -1)
    k_new = torch.cat([c[:, None], k_rot.to(c.dtype)], -1)
    cache = cache.update(k_new, c[:, None], offset)
    ck, cv = cache.k, cache.v
    if kv_limit is not None:
        ck, cv = ck[:, :, :kv_limit], cv[:, :, :kv_limit]
    out_lat = sdpa(q_cat, ck, cv, scale=mcfg.scale, mask=mask())
    dt = torch.promote_types(x.dtype, w_uv.dtype)
    out = torch.einsum("bhtc,hvc->bthv", out_lat.to(x.dtype).to(dt),
                       w_uv.to(dt))
    return linear(lp["o_proj"], out.reshape(B, T, -1)), cache
