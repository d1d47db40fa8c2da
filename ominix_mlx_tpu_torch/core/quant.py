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


def over_127(x: torch.Tensor) -> torch.Tensor:
    """x / 127, correctly rounded on every device, as in the JAX package.
    On CUDA, PyTorch divides by a Python scalar as a multiply by its
    reciprocal, which is one ulp off for some x and then moves an int8
    code; a tensor divisor takes the true division."""
    return x / torch.full_like(x, 127.0)


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


def quantize_tree(params, group_size: int = 64, bits: int = 4,
                  pack: bool = True, min_dim: int = 256,
                  batched: bool = False, scheme: str = "group"):
    """Generic post-hoc quantizer for any parameter tree (the JAX
    package's ``core.quant.quantize_tree``): every dict holding a 2-D "w"
    whose shape suits the kernels (both dims multiples of 128 and at least
    ``min_dim``, K a multiple of the group size) gets it quantized;
    everything else (norms, convolutions, embeddings, small projections)
    stays dense. scheme="group": group quantization into the packed
    row-major layout (``ops.quant_matmul.prepare``, act_bits=8, marked
    ``batched`` if asked), or the canonical ``QuantizedTensor`` with
    pack=False. scheme="channel8": per-output-channel symmetric int8
    (``group_size``, ``bits`` and ``pack`` unused). Any other scheme
    raises, where the JAX package quantizes it as "group"."""
    from ominix_mlx_tpu_torch.ops.quant_matmul import (channel_quantize,
                                                       prepare)

    if scheme not in ("group", "channel8"):
        raise ValueError(f"scheme {scheme!r}: want 'group' or 'channel8'")

    def eligible(w):
        return (isinstance(w, torch.Tensor) and w.dim() == 2
                and w.shape[0] % 128 == 0 and w.shape[1] % 128 == 0
                and (scheme == "channel8" or w.shape[1] % group_size == 0)
                and min(w.shape) >= min_dim)

    def quant(w):
        if scheme == "channel8":
            return channel_quantize(w.float())
        qt = quantize_tensor(w.float(), group_size, bits)
        return prepare(qt, batched=batched) if pack else qt

    def walk(node):
        if isinstance(node, dict):
            return {k: quant(v) if k == "w" and eligible(v) else walk(v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)
