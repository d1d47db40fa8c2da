"""Weights bridge: a parameter tree of numpy arrays -> the port's tree.

The input mirrors the JAX package's tree converted to numpy: dense weights
are arrays, and each quantized weight is a dict
``{"q", "scales", "biases", "group_size", "bits"}`` in the canonical
layout (signed int8 codes, per-group scale and bias; what the JAX
package's ``ops.quant_matmul.unpack`` returns; a 3-D ``q`` [E, N, K] holds a
MoE layer's stacked experts), with optionally the JAX tensor's dispatch
flags ``"batched"`` and ``"tn"`` (its panel width, 0 for row-major), which
become the port's ``batched`` and ``panels``. The packed bytes are never
carried: the JAX package's 4-bit row-major byte order is not the port's.
Each channel-quantized
(w8a8) weight is a dict ``{"data", "scale"}`` (the JAX package's
``ChannelQuantizedTensor`` as numpy: int8 codes [N, K], float32 scale
[N]; its ``ChannelQuantizedExperts``: data [E, N, K], scale [E, N]). The
output lives on ``device``, with group-quantized weights packed for the
routes of ``ops.quant_matmul``, stacked 4- or 8-bit experts packed for
kernel K4 (``PackedQuantizedExperts``) and stacked channel experts for
kernel K8 (``ChannelQuantizedExperts``). Every key of the tree is
carried as it is named, so GLM-4's sandwich norms
(``post_self_attn_layernorm``, ``post_mlp_layernorm``) and biases ("b")
reach the port's ``decoder_layer`` and ``linear``, and MLA's absorbed
``w_uk`` / ``w_uv`` [H, d, Ckv], ``kv_a_layernorm`` and
``q_a_layernorm``, a MoE layer's ``e_score_correction_bias`` and its
``shared_expert`` (dense or quantized linears) and ``shared_expert_gate``
reach ``models.mla`` and ``models.moe``, and Qwen3-Next's DeltaNet
subtrees (``linear_attn``: its projections, ``conv1d``, ``A_log``,
``dt_bias``, ``norm``) and attention output gate ``g_proj`` reach
``models.deltanet`` and ``models.base``, and MiniCPM-SALA's lightning
layers' output gate ``z_proj`` and output norm ``o_norm`` and its
``q_norm`` / ``k_norm`` reach ``models.minicpm_sala``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ominix_mlx_tpu_torch.core.quant import QuantizedTensor
from ominix_mlx_tpu_torch.ops.quant_matmul import (ChannelQuantizedExperts,
                                                   ChannelQuantizedTensor,
                                                   pack_experts, prepare)

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
                q = _tensor(node["q"], device).to(torch.int8)
                scales = _tensor(node["scales"], device, torch.bfloat16)
                biases = _tensor(node["biases"], device, torch.bfloat16)
                gs, bits = int(node["group_size"]), int(node["bits"])
                if q.dim() == 3:        # stacked experts [E, N, K]
                    E, N, K = q.shape
                    return pack_experts(QuantizedTensor(
                        q=q.reshape(E * N, K),
                        scales=scales.reshape(E * N, -1),
                        biases=biases.reshape(E * N, -1), group_size=gs,
                        bits=bits), E, act_bits=act_bits)
                p = prepare(QuantizedTensor(q=q, scales=scales,
                                            biases=biases, group_size=gs,
                                            bits=bits), act_bits=act_bits,
                            batched=bool(node.get("batched", False)))
                if node.get("tn", 0):
                    p = dataclasses.replace(p, panels=True)
                return p
            if node.keys() == _CKEYS:
                data = _tensor(node["data"], device).to(torch.int8)
                kind = (ChannelQuantizedExperts if data.dim() == 3
                        else ChannelQuantizedTensor)
                return kind(data=data, scale=_tensor(
                    node["scale"], device).to(torch.float32))
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return _tensor(node, device, dtype)

    return walk(tree)
