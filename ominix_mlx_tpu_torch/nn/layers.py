"""Functional layers over plain dicts of tensors (counterpart of
ominix_mlx_tpu/nn/layers.py). Quantized layers are the same function
dispatching on the weight's type: a packed or channel-quantized weight
takes ``ops.quant_matmul``, a plain ``QuantizedTensor`` (as an MLX
checkpoint loads) the JAX package's dequantize-then-product path."""

from __future__ import annotations

import contextlib
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


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """GELU by its tanh approximation: ``jax.nn.gelu``'s default
    (``approximate=True``), where ``F.gelu`` defaults to the exact form."""
    return F.gelu(x, approximate="tanh")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """GELU by the error function (``jax.nn.gelu(x, approximate=False)``)."""
    return F.gelu(x)


# the JAX package's table (ominix_mlx_tpu/nn/layers.py:151-160): its
# "gelu" is jax.nn.gelu's default, the tanh form
ACTIVATIONS = {
    "silu": F.silu,
    "gelu": gelu_tanh,
    "gelu_new": gelu_tanh,
    "gelu_pytorch_tanh": gelu_tanh,
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def layer_norm(params: dict, x: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """params: {"w"?, "b"?}. Statistics in float32; the normalized x is
    cast to x's type before the affine, as the JAX package's
    ``layer_norm`` does."""
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).to(dtype)
    if params.get("w") is not None:
        y = y * params["w"]
    if params.get("b") is not None:
        y = y + params["b"]
    return y


@contextlib.contextmanager
def ieee_fp32(x: torch.Tensor):
    """Within: cuDNN computes a float32 convolution of ``x`` on the card
    in float32, not TF32 (PyTorch's default for cuDNN convolutions,
    ``torch.backends.cudnn.allow_tf32``), as the JAX package's float32
    convolutions are; the flag is restored on the way out, and anything
    else passes through untouched. The flag is the process's: the server
    runs every model call on its one inference thread."""
    if not (x.is_cuda and x.dtype == torch.float32
            and torch.backends.cudnn.allow_tf32):
        yield
        return
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = True


def conv1d(params: dict, x: torch.Tensor, stride: int = 1, padding=0,
           groups: int = 1, dilation: int = 1) -> torch.Tensor:
    """x: [B, T, C_in] (channels last); params["w"]: [C_out, K,
    C_in/groups] (the MLX layout the JAX tree keeps; moved to PyTorch's
    [C_out, C_in/groups, K] here, at the call), "b"?: [C_out].
    ``padding``: an int (both sides) or a ((left, right),) pair. Returns
    [B, T', C_out] in x's type; float32 without TF32 (``ieee_fp32``)."""
    w = params["w"].to(x.dtype).permute(0, 2, 1)
    xc = x.transpose(1, 2)
    if not isinstance(padding, int):
        (left, right), = padding
        xc = F.pad(xc, (left, right))
        padding = 0
    with ieee_fp32(x):
        y = F.conv1d(xc, w, stride=stride, padding=padding,
                     dilation=dilation, groups=groups).transpose(1, 2)
    if params.get("b") is not None:
        y = y + params["b"]
    return y


def conv2d(params: dict, x: torch.Tensor, stride=1, padding=0,
           groups: int = 1) -> torch.Tensor:
    """x: [B, H, W, C_in] (channels last, as the JAX package's towers);
    params["w"]: [C_out, C_in/groups, KH, KW] (PyTorch's layout; the JAX
    tree's OHWI weight becomes it through ``conv_weight``), "b"?: [C_out].
    ``padding``: an int or (ph, pw), both sides alike. Returns [B, H', W',
    C_out] in x's type; float32 without TF32 (``ieee_fp32``)."""
    with ieee_fp32(x):
        y = F.conv2d(x.permute(0, 3, 1, 2), params["w"].to(x.dtype),
                     stride=stride, padding=padding, groups=groups)
    y = y.permute(0, 2, 3, 1)
    if params.get("b") is not None:
        y = y + params["b"]
    return y


def conv_transpose1d(params: dict, x: torch.Tensor, stride: int = 1,
                     padding: int = 0) -> torch.Tensor:
    """x: [B, T, C_in] (channels last); params["w"]: [C_out, K, C_in]
    (MLX's ConvTranspose1d layout, as the JAX tree keeps it), "b"?:
    [C_out]. ``padding`` has PyTorch's meaning: out = (T - 1) * stride + K
    - 2 * padding. The JAX package's ``lax.conv_transpose`` with
    ``transpose_kernel=True`` and the "IHO" kernel spec is PyTorch's
    ``conv_transpose1d`` with the weight [C_in, C_out, K] =
    ``w.permute(2, 0, 1)`` (no flip; ``tests/test_torch_qwen3_tts.py``
    holds the two against each other at K = 2 * stride). Returns [B, T',
    C_out] in x's type; float32 without TF32 (``ieee_fp32``)."""
    w = params["w"].to(x.dtype).permute(2, 0, 1)
    with ieee_fp32(x):
        y = F.conv_transpose1d(x.transpose(1, 2), w, stride=stride,
                               padding=padding).transpose(1, 2)
    if params.get("b") is not None:
        y = y + params["b"]
    return y


def elu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.elu`` (alpha 1)."""
    return F.elu(x)


def snake_beta(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SnakeBeta, x + sin(alpha x)^2 / (beta + 1e-9), with alpha and beta
    held exponentiated (p["alpha_exp"], p["beta_exp"], float32 [1, 1, C]):
    computed in float32 and cast back to x's type, as the JAX package's
    ``qwen3_tts.snake_beta``."""
    xf = x.float()
    s = torch.sin(p["alpha_exp"] * xf)
    return (xf + s * s / (p["beta_exp"] + 1e-9)).to(x.dtype)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, h, w, C] in x's type, computed in float32:
    ``jax.image.resize(..., "bilinear")``, which antialiases when it
    shrinks (``F.interpolate`` does only with ``antialias=True``)."""
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=(h, w),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def conv_weight(w_ohwi: torch.Tensor) -> torch.Tensor:
    """A JAX tree's conv weight [O, KH, KW, I] as ``conv2d`` takes it,
    [O, I, KH, KW] (contiguous)."""
    return w_ohwi.permute(0, 3, 1, 2).contiguous()
