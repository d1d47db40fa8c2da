"""Group-wise affine quantization (counterpart of
ominix_mlx_tpu/core/quant.py).

Canonical form: ``QuantizedTensor`` holds signed int8 codes in
[-2^(bits-1), 2^(bits-1)), and a scale and a bias per group of
``group_size`` input features: ``w = scales * q + biases``. Kernels take
the packed layout of ``ops.quant_matmul.prepare`` instead.

MLX checkpoints (mlx-community) store a quantized linear as ``weight``
uint32 [out, in * bits / 32], element j of a word in bits [j * bits,
(j + 1) * bits), with the UNSIGNED code, and ``scales`` / ``biases`` [out,
in / group_size]; ``from_mlx_arrays`` centres the codes and folds the
offset into the biases, ``pack_codes`` writes that layout.
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
    are returned unpacked (``pack_codes`` gives MLX's uint32 words).
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


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Unsigned codes [out, in] -> MLX's uint32 words [out, in * bits /
    32] (element j of a word in bits [j * bits, (j + 1) * bits))."""
    per_word = 32 // bits
    out_f, in_f = codes.shape
    if 32 % bits or in_f % per_word:
        raise ValueError(f"{in_f} codes of {bits} bits do not fill words")
    c = codes.to(torch.int64).reshape(out_f, in_f // per_word, per_word)
    shifts = torch.arange(per_word, device=codes.device) * bits
    w = (c << shifts).sum(-1)
    # the words' bit patterns as int32, then read as uint32
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(
        torch.int32).view(torch.uint32)


def unpack_to_int8(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """MLX's uint32 words [out, n] -> the unsigned codes [out, n * 32 /
    bits] as int8 bit patterns (an 8-bit code above 127 reads negative, as
    the JAX package's ``unpack_to_int8`` returns it). The words are read
    as int32, and each shift is masked, so no sign bit leaks in."""
    per_word = 32 // bits
    out_f, n_words = packed.shape
    w = packed.view(torch.int32) if packed.dtype == torch.uint32 \
        else packed.to(torch.int32)
    shifts = torch.arange(per_word, dtype=torch.int32,
                          device=packed.device) * bits
    codes = (w[..., None] >> shifts) & ((1 << bits) - 1)
    return codes.reshape(out_f, n_words * per_word).to(torch.uint8).view(
        torch.int8)


def from_mlx_arrays(packed: torch.Tensor, scales: torch.Tensor,
                    biases: torch.Tensor, group_size: int,
                    bits: int) -> QuantizedTensor:
    """A ``QuantizedTensor`` from an MLX checkpoint's arrays: the unsigned
    codes centred into signed int8 and the offset folded into the biases,
    ``biases' = biases + scales * 2^(bits-1)`` in float32, rounded to the
    biases' type (as the JAX package's ``from_mlx_arrays``)."""
    center = 1 << (bits - 1)
    unsigned = unpack_to_int8(packed, bits).view(torch.uint8)
    q = (unsigned.to(torch.int16) - center).to(torch.int8)
    biases = (biases.float() + scales.float() * center).to(biases.dtype)
    return QuantizedTensor(q=q, scales=scales, biases=biases,
                           group_size=group_size, bits=bits)


def quantized_matmul(x: torch.Tensor, qt: QuantizedTensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """x @ W^T for a plain ``QuantizedTensor`` W: the JAX package's XLA
    path (dequantize in float32, round to ``dtype``, then one product in
    ``dtype``). No kernel computes it there either."""
    return torch.matmul(x.to(dtype), dequantize(qt, dtype).T)


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
