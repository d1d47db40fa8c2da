"""Group-wise affine quantization (counterpart of
ominix_mlx_tpu/core/quant.py).

Canonical form: ``QuantizedTensor`` holds signed int8 codes in
[-2^(bits-1), 2^(bits-1)), and a scale and a bias per group of
``group_size`` input features: ``w = scales * q + biases``. Kernels take
the packed layout of ``ops.quant_matmul.prepare`` instead.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class QuantizedTensor:
    """A group-quantized [out, in] matrix in unpacked, centred form."""

    q: torch.Tensor        # [out, in] int8 (signed centred codes)
    scales: torch.Tensor   # [out, in // group_size]
    biases: torch.Tensor   # [out, in // group_size]
    group_size: int = 64
    bits: int = 4

    @property
    def shape(self):
        return tuple(self.q.shape)


def quantize(w: torch.Tensor, group_size: int = 64, bits: int = 4):
    """[out, in] float -> (unsigned codes uint8 [out, in], scales, biases).

    Same affine rule as the JAX package's ``quantize``: per group,
    ``scale = (max - min) / (2^bits - 1)`` (1e-8 where zero), ``bias = min``
    and ``q = clip(round((w - bias) / scale), 0, 2^bits - 1)``. The codes
    are returned unpacked; the MLX uint32 word packing is a checkpoint
    format this port does not read yet.
    """
    out_f, in_f = w.shape
    if in_f % group_size:
        raise ValueError(f"in_features {in_f} not a multiple of "
                         f"group_size {group_size}")
    n_levels = (1 << bits) - 1
    g = w.reshape(out_f, in_f // group_size, group_size).float()
    w_min = g.amin(-1)
    w_max = g.amax(-1)
    scale = (w_max - w_min) / n_levels
    scale = torch.where(scale == 0, torch.full_like(scale, 1e-8), scale)
    q = torch.clamp(torch.round((g - w_min[..., None]) / scale[..., None]),
                    0, n_levels)
    return (q.to(torch.uint8).reshape(out_f, in_f), scale.to(w.dtype),
            w_min.to(w.dtype))


def quantize_tensor(w: torch.Tensor, group_size: int = 64,
                    bits: int = 4) -> QuantizedTensor:
    """Quantize and centre: the unsigned offset 2^(bits-1) moves into the
    biases (``biases' = biases + scales * 2^(bits-1)``)."""
    codes, scales, biases = quantize(w, group_size, bits)
    center = 1 << (bits - 1)
    q = (codes.to(torch.int16) - center).to(torch.int8)
    biases = (biases.float() + scales.float() * center).to(biases.dtype)
    return QuantizedTensor(q=q, scales=scales, biases=biases,
                           group_size=group_size, bits=bits)


def dequantize(qt: QuantizedTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense [out, in] matrix, computed in float32 then cast to ``dtype``."""
    out_f, in_f = qt.q.shape
    gs = qt.group_size
    q = qt.q.float().reshape(out_f, in_f // gs, gs)
    w = qt.scales[..., None].float() * q + qt.biases[..., None].float()
    return w.reshape(out_f, in_f).to(dtype)
