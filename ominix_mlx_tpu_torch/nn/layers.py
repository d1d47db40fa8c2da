"""Functional layers over plain dicts of tensors (counterpart of
ominix_mlx_tpu/nn/layers.py). Quantized layers are the same function
dispatching on the weight's type: a packed or channel-quantized weight
takes ``ops.quant_matmul``, a plain ``QuantizedTensor`` (as an MLX
checkpoint loads) the JAX package's dequantize-then-product path."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ominix_mlx_tpu_torch.core.quant import (QuantizedTensor, dequantize,
                                            quantized_matmul)
from ominix_mlx_tpu_torch.ops import quant_matmul as qm
from ominix_mlx_tpu_torch.ops.quant_matmul import (ChannelQuantizedTensor,
                                                   PackedQuantizedTensor,
                                                   channel_gather_rows,
                                                   gather_rows,
                                                   rms_norm)

QUANTIZED = (PackedQuantizedTensor, ChannelQuantizedTensor)


def linear(params: dict, x: torch.Tensor,
           norm: Optional[tuple] = None) -> torch.Tensor:
    """y = x @ W^T (+ b). params: {"w": [out, in] | PackedQuantizedTensor |
    ChannelQuantizedTensor | QuantizedTensor, "b"?}. norm (optional
    (weight, eps)): RMSNorm x first; fused into K1's prologue where the
    JAX package fuses it (a 4-bit panel weight at M=1). A packed weight
    takes the formula ``ops.quant_matmul.route`` names; a QuantizedTensor
    is dequantized to x's type and multiplied (``core.quant.
    quantized_matmul``), as the JAX package's ``quantized_matmul`` does."""
    w = params["w"]
    if isinstance(w, QUANTIZED):
        if norm is not None:
            y = qm.quantized_matmul(x, w, norm_w=norm[0], norm_eps=norm[1])
        else:
            y = qm.quantized_matmul(x, w)
    elif isinstance(w, QuantizedTensor):
        if norm is not None:
            x = rms_norm(norm[0], x, norm[1])
        y = quantized_matmul(x, w, x.dtype)
    else:
        if norm is not None:
            x = rms_norm(norm[0], x, norm[1])
        y = torch.matmul(x, w.T)
    b = params.get("b")
    if b is not None:
        y = y + b
    return y


def embedding(weight, tokens: torch.Tensor) -> torch.Tensor:
    """weight: [V, D] tensor, PackedQuantizedTensor, ChannelQuantizedTensor
    or QuantizedTensor (dequantizes only the gathered rows, bf16)."""
    if isinstance(weight, PackedQuantizedTensor):
        return gather_rows(weight, tokens)
    if isinstance(weight, ChannelQuantizedTensor):
        return channel_gather_rows(weight, tokens)
    if isinstance(weight, QuantizedTensor):
        flat = tokens.reshape(-1)
        rows = QuantizedTensor(q=weight.q[flat], scales=weight.scales[flat],
                               biases=weight.biases[flat],
                               group_size=weight.group_size, bits=weight.bits)
        return dequantize(rows).reshape(*tokens.shape, -1)
    return weight[tokens]


def embedding_as_linear(weight, x: torch.Tensor,
                        norm: Optional[tuple] = None) -> torch.Tensor:
    """Tied lm_head: x @ E^T. norm: see ``linear``."""
    return linear({"w": weight}, x, norm=norm)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


ACTIVATIONS = {"silu": F.silu}
