"""Quantized matmuls: x @ W^T with group-quantized 4-bit W
(counterpart of ominix_mlx_tpu/ops/quant_matmul.py).

The port keeps its own packed layout (``PackedQuantizedTensor``): row-major
``data`` uint8 [N, K/2] with natural nibble order (byte j of a row holds
codes 2j and 2j+1 as ``u[2j] | u[2j+1] << 4``, unsigned ``u = q + 8``), and
bf16 ``scales`` / ``biases`` [N, G]. The biases hold the zero-point fold
``b - 8s`` so that ``w = s * u + biases``: the same fold the TPU's M=1
kernel streams, which keeps the a8 formula identical to it.

Dispatch (``quantized_matmul``), by rows M of the flattened input:

* M = 1: kernel K1, w4a8 (``act_bits == 8``) or w4a16, RMSNorm fused;
* 2 <= M <= 16: kernel K1 in its a16 mode (replaces ``_dq_kernel``), the
  norm applied first;
* M > 16: dequantize and ``torch.matmul`` (the counterpart of
  ``_dense_tn``, plain XLA in the JAX package).

K1 is hand-written CUDA (``csrc/qmm.cu``). A CPU tensor takes the plain
PyTorch version ``quantized_matmul_reference``, which computes the same
formula; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ominix_mlx_tpu_torch.core.quant import QuantizedTensor

DECODE_M_MAX = 16   # up to this many rows, K1 runs


@dataclasses.dataclass
class PackedQuantizedTensor:
    """Kernel-ready 4-bit weight (see the module docstring for the layout)."""

    data: torch.Tensor     # uint8 [N, K/2]
    scales: torch.Tensor   # bf16 [N, G]
    biases: torch.Tensor   # bf16 [N, G], holds b - 8s
    group_size: int = 64
    bits: int = 4
    in_features: int = 0
    # 8 = per-row dynamic int8 activations at M=1 (w4a8); None = exact bf16
    act_bits: Optional[int] = 8

    @property
    def shape(self):
        return (self.data.shape[0], self.in_features)


def prepare(qt: QuantizedTensor, act_bits: Optional[int] = 8
            ) -> PackedQuantizedTensor:
    """One-time conversion QuantizedTensor -> the kernel layout."""
    if qt.bits != 4:
        raise NotImplementedError(
            f"{qt.bits}-bit weights: only the 4-bit K1 kernel is ported")
    if act_bits not in (8, None):
        raise ValueError(f"act_bits must be 8 or None, got {act_bits!r}")
    N, K = qt.q.shape
    if K % 32 or K % qt.group_size or qt.group_size % 32:
        raise ValueError(f"K={K}, group_size={qt.group_size}: K1 needs K "
                         f"and the group size to be multiples of 32")
    u = (qt.q.to(torch.int16) + 8).to(torch.uint8)
    data = (u[:, 0::2] | (u[:, 1::2] << 4)).contiguous()
    scales = qt.scales.to(torch.bfloat16)
    biases = (qt.biases.to(torch.bfloat16).float()
              - 8.0 * scales.float()).to(torch.bfloat16)
    return PackedQuantizedTensor(
        data=data, scales=scales.contiguous(), biases=biases.contiguous(),
        group_size=qt.group_size, bits=4, in_features=K, act_bits=act_bits)


def _codes(data: torch.Tensor) -> torch.Tensor:
    """uint8 [..., K/2] -> unsigned codes uint8 [..., K] in natural order."""
    lo = data & 15
    hi = data >> 4
    return torch.stack([lo, hi], -1).reshape(*data.shape[:-1],
                                             2 * data.shape[-1])


def unpack(pqt: PackedQuantizedTensor) -> QuantizedTensor:
    """Inverse of ``prepare`` (canonical signed codes, un-folded biases)."""
    q = (_codes(pqt.data).to(torch.int16) - 8).to(torch.int8)
    biases = (pqt.biases.float() + 8.0 * pqt.scales.float()).to(
        torch.bfloat16)
    return QuantizedTensor(q=q, scales=pqt.scales, biases=biases,
                           group_size=pqt.group_size, bits=pqt.bits)


def _dequant_rows(data, scales, biases, gs: int) -> torch.Tensor:
    """bf16 weights of the given packed rows: bf16(s * u + b') per element."""
    u = _codes(data).float()
    lead, K = u.shape[:-1], u.shape[-1]
    g = u.reshape(*lead, K // gs, gs)
    w = g * scales.float()[..., None] + biases.float()[..., None]
    return w.reshape(*lead, K).to(torch.bfloat16)


def dequantize_packed(pqt: PackedQuantizedTensor) -> torch.Tensor:
    """Dense bf16 [N, K] (the rounding of the JAX package's _dense_tn)."""
    return _dequant_rows(pqt.data, pqt.scales, pqt.biases, pqt.group_size)


def gather_rows(pqt: PackedQuantizedTensor,
                tokens: torch.Tensor) -> torch.Tensor:
    """Quantized embedding lookup: dequantize only the gathered rows.
    Returns [..., K] bf16."""
    return _dequant_rows(pqt.data[tokens], pqt.scales[tokens],
                         pqt.biases[tokens], pqt.group_size)


def rms_norm(weight: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """(x * rsqrt(mean(x^2) + eps)) in float32, cast back, times weight:
    the op order of the TPU kernel's fused prologue (nn.layers uses this
    function too)."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype) * weight


def quantized_matmul_reference(x: torch.Tensor, w: PackedQuantizedTensor,
                               norm_w: Optional[torch.Tensor] = None,
                               norm_eps: float = 1e-6,
                               act_bits: Optional[int] = None
                               ) -> torch.Tensor:
    """Plain PyTorch version of K1: x [M, K] -> [M, N] in x's dtype.

    act_bits=8 is the TPU M=1 kernel's w4a8 formula (quant_matmul.py
    :771-827, :914-927): x in bf16, optional RMSNorm
    ``xn = bf16(bf16(x * inv) * norm_w)``, per-row ``sx = max|xn|/127 +
    1e-12``, ``cx = round(xn / sx)``, and
    ``y = sx * sum_g s_g * P_g + sum_g b'_g * bf16(xg_g)`` where ``P_g`` is
    the integer dot product of cx with the unsigned codes of group g and
    ``xg_g`` the group sum of xn. act_bits=None is the exact path:
    ``y = bf16(x) @ bf16(s * u + b')^T`` accumulated in float32.
    """
    M, K = x.shape
    gs = w.group_size
    if act_bits is None:
        if norm_w is not None:
            x = rms_norm(norm_w, x, norm_eps)
        wd = dequantize_packed(w).float()
        y = x.to(torch.bfloat16).float() @ wd.T
        return y.to(x.dtype)
    xb = x.to(torch.bfloat16)
    if norm_w is not None:
        xb = rms_norm(norm_w.to(torch.bfloat16), xb, norm_eps)
    xn = xb.float()
    sx = xn.abs().amax(-1, keepdim=True) / 127.0 + 1e-12
    cx = torch.round(xn / sx)
    G = K // gs
    u = _codes(w.data).float().reshape(-1, G, gs)
    # |P| <= 64 * 127 * 15 < 2^24: exact in float32
    P = torch.einsum("mgk,ngk->mng", cx.reshape(M, G, gs), u)
    acc_p = (P * w.scales.float()[None]).sum(-1)
    xg = xn.reshape(M, G, gs).sum(-1).to(torch.bfloat16).float()
    acc_b = xg @ w.biases.float().T
    return (sx * acc_p + acc_b).to(x.dtype)


def _k1(x: torch.Tensor, w: PackedQuantizedTensor,
        norm_w: Optional[torch.Tensor], norm_eps: float,
        a8: bool) -> torch.Tensor:
    """Launch K1 (csrc/qmm.cu) on the current stream; x [M, K] on CUDA."""
    from ominix_mlx_tpu_torch.ops import _build

    M, K = x.shape
    N = w.data.shape[0]
    G = K // w.group_size
    dev = x.device
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"K1 takes contiguous bf16 x, got {x.dtype}")
    if not 1 <= M <= DECODE_M_MAX or (a8 and M != 1):
        raise ValueError(f"K1 takes 1 <= M <= {DECODE_M_MAX} (a8: M = 1), "
                         f"got M={M}")
    if K != w.in_features or w.bits != 4:
        raise ValueError(f"x has K={K}; weight is {w.bits}-bit with "
                         f"K={w.in_features}")
    for name, t, dt, shp in (("data", w.data, torch.uint8, (N, K // 2)),
                             ("scales", w.scales, torch.bfloat16, (N, G)),
                             ("biases", w.biases, torch.bfloat16, (N, G))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shp \
                or not t.is_contiguous():
            raise ValueError(f"K1 {name}: want contiguous {dt} {shp} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if w.data.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError("K1 needs 16-byte aligned data and x")
    if norm_w is not None and (norm_w.device != dev
                               or norm_w.dtype != torch.bfloat16
                               or tuple(norm_w.shape) != (K,)
                               or not norm_w.is_contiguous()):
        raise ValueError("K1 norm weight: want contiguous bf16 [K] on "
                         f"{dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"x is on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    lib = _build.library()
    y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
    xq = xg = sx = xn = None
    if a8:
        xq = torch.empty(M, K, dtype=torch.int8, device=dev)
        xg = torch.empty(M, G, dtype=torch.float32, device=dev)
        sx = torch.empty(M, dtype=torch.float32, device=dev)
    elif norm_w is not None:
        xn = torch.empty(M, K, dtype=torch.bfloat16, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.ominix_qmm_w4(
        ptr(x), ptr(norm_w), float(norm_eps), ptr(w.data), ptr(w.scales),
        ptr(w.biases), ptr(y), ptr(xq), ptr(xg), ptr(sx), ptr(xn),
        M, N, K, w.group_size, int(a8),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "K1 (ominix_qmm_w4)")
    _build.LAUNCHES["k1_m1" if M == 1 else "k1_mn"] += 1
    return y


def quantized_matmul(x: torch.Tensor, w: PackedQuantizedTensor,
                     norm_w: Optional[torch.Tensor] = None,
                     norm_eps: float = 1e-6) -> torch.Tensor:
    """x [..., K] @ W^T -> [..., N] in x's dtype.

    norm_w (optional [K]): RMSNorm x first; fused into K1's prologue at
    M=1, applied before the matmul at M > 1 with the same op order.
    """
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    N = w.data.shape[0]
    if M > 1 and norm_w is not None:
        x2 = rms_norm(norm_w, x2, norm_eps)
        norm_w = None
    a8 = M == 1 and w.act_bits == 8
    if not x2.is_cuda:
        y = quantized_matmul_reference(x2, w, norm_w, norm_eps,
                                       act_bits=8 if a8 else None)
    elif M > DECODE_M_MAX:
        # prefill: dequantize once, dense matmul (plain XLA in the JAX
        # package, _dense_tn)
        y = torch.matmul(x2.to(torch.bfloat16),
                         dequantize_packed(w).T).to(x.dtype)
    else:
        xk = x2.to(torch.bfloat16).contiguous()
        if xk.data_ptr() % 16:      # a view at an odd offset: K1 loads
            xk = xk.clone()         # x with 16-byte vector loads
        y = _k1(xk, w,
                None if norm_w is None else norm_w.to(torch.bfloat16),
                norm_eps, a8).to(x.dtype)
    return y.reshape(*lead, N)
