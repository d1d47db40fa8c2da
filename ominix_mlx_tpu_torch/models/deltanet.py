"""Gated DeltaNet linear attention, the recurrent layers of Qwen3-Next's
hybrid (counterpart of ominix_mlx_tpu/models/deltanet.py).

A layer keeps a fixed-size state [B, Hv, dk, dv] (float32) and the
causal depthwise conv's window of its last K-1 inputs [B, K-1, conv_dim]
(in the model's type): O(1) memory in the sequence length. The delta rule
with a per-head decay (HF ``torch_recurrent_gated_delta_rule``):

    S_t = S_{t-1} * exp(g_t)
    delta_t = (v_t - k_t^T S_t) * beta_t
    S_t += outer(k_t, delta_t)
    o_t = q_t^T S_t        (q, k l2-normed; q scaled by dk^-0.5)

runs in ``ops.gated_delta.gated_delta_rule``: kernel K9 on CUDA (its
recurrent or its chunked form, as ``k9_plan`` picks), its plain version on
the CPU. What comes before it, the causal conv over the carried window,
SiLU, the l2norms and the gates, is ``ops.gated_delta.k9_prep``: one
launch on CUDA, ``deltanet_prep_reference`` on the CPU. A decode step (T =
1) takes ``ops.gated_delta.deltanet_decode`` instead: the prologue, the
step, the gated RMSNorm and the gate in one launch (``k9_decode``) on
CUDA, ``deltanet_decode_reference`` (the same composition as at prompts)
on the CPU. Unlike the JAX
package, whose caches are values, ``block`` writes the state and the conv
window into the cache's buffers IN PLACE, so the batcher's row views
carry them and a decode step allocates no new state.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ominix_mlx_tpu_torch.core.device import resolve_device
from ominix_mlx_tpu_torch.nn.layers import linear, rms_norm
from ominix_mlx_tpu_torch.ops.gated_delta import (deltanet_decode,
                                                  gated_delta_rule, k9_prep,
                                                  split_qkvz_ba)


@dataclasses.dataclass(frozen=True)
class DeltaNetConfig:
    num_v_heads: int
    num_k_heads: int
    head_k_dim: int
    head_v_dim: int
    conv_kernel: int = 4
    rms_norm_eps: float = 1e-6

    @property
    def key_dim(self):
        return self.head_k_dim * self.num_k_heads

    @property
    def value_dim(self):
        return self.head_v_dim * self.num_v_heads

    @property
    def conv_dim(self):
        return 2 * self.key_dim + self.value_dim


@dataclasses.dataclass
class RecurrentCache:
    """One DeltaNet layer's state (ominix_mlx_tpu/models/deltanet.py:53-64).
    It has no ``max_len``: ``core.cache.ingests_padding`` is true for it."""

    state: torch.Tensor    # [B, Hv, dk, dv] float32
    conv: torch.Tensor     # [B, K-1, conv_dim]

    @staticmethod
    def init(batch: int, dcfg: DeltaNetConfig, dtype=torch.bfloat16,
             device=None) -> "RecurrentCache":
        """Zeroed buffers on ``device`` (default: the current CUDA
        device)."""
        device = resolve_device(device)
        return RecurrentCache(
            state=torch.zeros(batch, dcfg.num_v_heads, dcfg.head_k_dim,
                              dcfg.head_v_dim, dtype=torch.float32,
                              device=device),
            conv=torch.zeros(batch, dcfg.conv_kernel - 1, dcfg.conv_dim,
                             dtype=dtype, device=device))

    def rows(self, b: int) -> "RecurrentCache":
        """Row b as views: writes through them land in this cache."""
        return RecurrentCache(state=self.state[b:b + 1],
                              conv=self.conv[b:b + 1])

    def zero_(self) -> "RecurrentCache":
        self.state.zero_()
        self.conv.zero_()
        return self


def init_layer_params(dcfg: DeltaNetConfig, hidden_size: int,
                      generator: torch.Generator, make,
                      dtype=torch.bfloat16, device=None) -> dict:
    """Random "linear_attn" tree (tests and benchmarks): the projections
    from ``make(out_features, in_features)`` (a dense or quantized
    weight); conv taps [C, 1, K] (HF's layout) uniform +-1/sqrt(K) in
    ``dtype``; A = U(1, 16) stored as ``A_log`` (HF's range) and
    ``dt_bias`` the inverse softplus of a step log-uniform in [1e-3, 0.1]
    (Mamba-2's init; float32), so the decay exp(g) stays in (0, 1) and
    spans fast and slow heads: the state carries far enough back that a
    chunk boundary or a stale slot would show; the gated norm's weight
    ones. ``device`` defaults to the current CUDA device."""
    device = resolve_device(device)
    C, K, Hv = dcfg.conv_dim, dcfg.conv_kernel, dcfg.num_v_heads
    D = hidden_size
    conv = torch.rand((C, 1, K), generator=generator, device=device) * 2 - 1
    A = 1 + 15 * torch.rand(Hv, generator=generator, device=device)
    dt = torch.exp(torch.rand(Hv, generator=generator, device=device)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return {
        "in_proj_qkvz": {"w": make(2 * dcfg.key_dim + 2 * dcfg.value_dim,
                                   D)},
        "in_proj_ba": {"w": make(2 * Hv, D)},
        "conv1d": {"w": (conv * K ** -0.5).to(dtype)},
        "A_log": A.log(),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "norm": torch.ones(dcfg.head_v_dim, dtype=dtype, device=device),
        "out_proj": {"w": make(D, dcfg.value_dim)},
    }


def _heads(dcfg: DeltaNetConfig):
    return (dcfg.num_k_heads, dcfg.num_v_heads, dcfg.head_k_dim,
            dcfg.head_v_dim)


def _split_qkvz_ba(qkvz: torch.Tensor, ba: torch.Tensor,
                   dcfg: DeltaNetConfig):
    """HF ``fix_query_key_value_ordering``: per-k-head interleaved packing
    [q (dk), k (dk), v (r dv), z (r dv)] and [b (r), a (r)] for each of the
    Hk key heads, r = Hv / Hk."""
    return split_qkvz_ba(qkvz, ba, _heads(dcfg))


def block(lp: dict, dcfg: DeltaNetConfig, x: torch.Tensor,
          cache: RecurrentCache):
    """x: [B, T, D] -> ([B, T, D], cache), the cache advanced in place.
    The JAX package's roundings: beta and g in float32; q, k, v in
    float32 (q l2-normed and scaled by dk^-0.5, k l2-normed); the
    recurrence's float32 output cast to x's type before the gated
    RMSNorm; then ``* silu(z)`` and ``out_proj``. At T = 1 everything
    between the projections and out_proj is one ``deltanet_decode``
    (on CUDA by dependent launch behind in_proj_ba, which writes neither
    the state nor the taps nor the norm weight)."""
    B, T, _ = x.shape
    qkvz = linear(lp["in_proj_qkvz"], x)
    ba = linear(lp["in_proj_ba"], x)
    heads = _heads(dcfg)
    # the taps, [C, 1, K] (HF) or [C, K, 1] (MLX), as [C, K]
    conv_w = lp["conv1d"]["w"].reshape(dcfg.conv_dim,
                                       dcfg.conv_kernel).to(x.dtype)
    A_log, dt_bias = lp["A_log"].float(), lp["dt_bias"].float()
    if T == 1:
        out = deltanet_decode(qkvz, ba, cache.conv, conv_w, A_log, dt_bias,
                              cache.state, lp["norm"], dcfg.rms_norm_eps,
                              heads, overlap=x.is_cuda)
        return linear(lp["out_proj"], out), cache
    q, k, v, g, beta = k9_prep(qkvz, ba, cache.conv, conv_w, A_log, dt_bias,
                               heads)
    z = _split_qkvz_ba(qkvz, ba, dcfg)[3]
    out = gated_delta_rule(q, k, v, g, beta, cache.state)

    # gated RMSNorm: rms(out) * silu(z), then out_proj
    out = rms_norm(lp["norm"], out.to(x.dtype), dcfg.rms_norm_eps)
    out = out * F.silu(z)
    return linear(lp["out_proj"], out.reshape(B, T, -1)), cache
