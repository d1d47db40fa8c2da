"""Weights bridge: a parameter tree of numpy arrays -> the port's tree.

The input mirrors the JAX package's tree converted to numpy: dense weights
are arrays, and each quantized weight is a dict
``{"q", "scales", "biases", "group_size", "bits"}`` in the canonical
layout (signed int8 codes, per-group scale and bias; what the JAX
package's ``ops.quant_matmul.unpack`` returns), and each channel-quantized
(w8a8) weight is a dict ``{"data", "scale"}`` (the JAX package's
``ChannelQuantizedTensor`` as numpy: int8 codes [N, K], float32 scale
[N]). The output lives on ``device``, with group-quantized weights packed
for kernel K1.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ominix_mlx_tpu_torch.core.quant import QuantizedTensor
from ominix_mlx_tpu_torch.ops.quant_matmul import (ChannelQuantizedTensor,
                                                   prepare)

_QKEYS = {"q", "scales", "biases", "group_size", "bits"}
_CKEYS = {"data", "scale"}


def _tensor(a, device, dtype=None) -> torch.Tensor:
    arr = np.asarray(a)
    if str(arr.dtype) == "bfloat16":
        # ml_dtypes bfloat16 (what jax arrays convert to): widen losslessly
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device, dtype: Optional[torch.dtype] = None,
                      act_bits: Optional[int] = 8):
    """Convert ``tree`` (dicts / lists / tuples of numpy arrays and
    quantized-weight dicts). Floating dense arrays are cast to ``dtype``
    when it is given and keep their own type otherwise; group-quantized
    weights keep bf16 scales and biases and get ``act_bits``;
    channel-quantized weights keep int8 codes and float32 scales."""
    def walk(node):
        if isinstance(node, dict):
            if _QKEYS <= node.keys():
                qt = QuantizedTensor(
                    q=_tensor(node["q"], device).to(torch.int8),
                    scales=_tensor(node["scales"], device, torch.bfloat16),
                    biases=_tensor(node["biases"], device, torch.bfloat16),
                    group_size=int(node["group_size"]),
                    bits=int(node["bits"]))
                return prepare(qt, act_bits=act_bits)
            if node.keys() == _CKEYS:
                return ChannelQuantizedTensor(
                    data=_tensor(node["data"], device).to(torch.int8),
                    scale=_tensor(node["scale"], device).to(torch.float32))
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return _tensor(node, device, dtype)

    return walk(tree)
