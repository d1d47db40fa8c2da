"""Quantized matmuls: x @ W^T with group-quantized 4- or 8-bit W
(counterpart of ominix_mlx_tpu/ops/quant_matmul.py).

The port keeps one packed layout (``PackedQuantizedTensor``), bf16
``scales`` and ``biases`` [N, G] beside the codes:

* 4-bit: ``data`` uint8 [N, K/2] in natural nibble order (byte j of a row
  holds codes 2j and 2j+1 as ``u[2j] | u[2j+1] << 4``, unsigned
  ``u = q + 8``); the biases hold the zero-point fold ``b' = b - 8s``, so
  ``w = s * u + b'`` (the fold the TPU's kernels stream);
* 8-bit: ``data`` int8 [N, K], the centred codes ``q``; the biases are
  ``b`` itself, ``w = s * q + b`` (as the JAX package's ``prepare`` keeps
  them).

The JAX package picks a formula from the weight's layout, its ``batched``
flag, its bits, ``act_bits`` and the row count M of the input
(``quantized_matmul``, ops/quant_matmul.py:1314-1402). The port carries
the two layout facts as dispatch flags only: ``panels`` (the JAX package
holds this weight in its transposed-panel layout: ``fuse_layer_projections``
sets it where ``to_panels_t`` would accept the shape) and ``batched``.
``route(w, M)`` copies the branch conditions and names the formula:

* ``"k1"`` (panels, M = 1; A1 ``_pt_kernel``): the P formula, w4a8,
  w4a16, w8a8 or w8a16, an RMSNorm fused for 4-bit;
* ``"k1_mn"`` (panels at 2 <= M <= 16, or a batched row-major weight;
  A3 ``_dq_kernel``): the dq formula;
* ``"k6"`` (row-major, M <= 16, 8-bit, or 4-bit with act_bits=8; A4
  ``_pm_kernel``): the P formula, row by row;
* ``"k7"`` (row-major 4-bit, M <= 64, shapes the JAX package does not
  pad; A5 ``_vpu_kernel``): the dq formula;
* ``"dense"``: dequantize and ``torch.matmul`` (plain XLA in the JAX
  package, ``_dense_tn`` or ``dequantize``).

The formulas, on x taken in bf16 (the model's activations):

* P: per row, ``sx = max|x| / 127 + 1e-12`` and ``cx = round(x / sx)``
  (a8) or ``sx = 1`` and ``cx = x`` (a16); ``xg`` the bf16-rounded group
  sums of x; ``y = sx * sum_g s_g * P_g + sum_g xg_g * b*_g`` with
  ``P_g = sum_{k in g} c_k * cx_k``, c the stored code (u or q) and b* the
  stored bias (b' or b). Under a8 P is an exact integer.
* dq: ``y = sum_k bf16(d_k * s_g) * x_k + sum_g xg_g * bh_g`` accumulated
  in float32, with d = u - 8 or q, and bh = b (8-bit) or
  ``bf16(b' + 8s)`` (4-bit: the JAX package's unfold of its panel
  biases; against a row-major weight's own b it is off by at most one
  bf16 ulp of |b| + 8s, and exact for the zero biases of a random init).

K1 at one row and K6 are one hand-written CUDA kernel, ``qmm_p`` in
``csrc/qmm.cu`` (planned by ``qmm_p_rows_per_warp``); the dq
formula ("k1_mn" and "k7", 1 to 64 rows, 4 and 8 bits) is one tensor-core
kernel in ``csrc/qmm_tc.cu``, planned by ``dq_plan``.
A CPU tensor takes the plain PyTorch version of its route
(``quantized_matmul_reference``); a CUDA tensor launches the route's kernel
or raises.

Stacked MoE experts (``PackedQuantizedExperts``, the 4- or 8-bit layout
with an expert axis) go through ``gather_qmm``. ``expert_route(w, T)``
copies the JAX package's test for its TPU kernel (``gather_qmm``,
ops/quant_matmul.py:1734-1738): on "k4", kernel K4 (``csrc/gather_qmm.cu``,
replaces the TPU's ``_gq_kernel`` at 4 and 8 bits) reads only the rows of
the experts each row of x selects, with K1's a8 formula
(``gather_qmm_reference`` is its plain version); on "gathered", and for
experts with act_bits=None, the JAX package's exact fallback (gathered rows
dequantized in float32), plain PyTorch on either device as XLA computes it
there.

A ``ChannelQuantizedTensor`` (per-output-channel int8, the batched-serving
w8a8 scheme) dispatches to ``channel_matmul``: dynamic per-token int8
activations, an exact int8 x int8 product summed in int32, then a rank-1
rescale. The JAX package computes that product in XLA, outside any Pallas
kernel; here it is ``torch._int_mm``. Its stacked form,
``ChannelQuantizedExperts``, goes through ``channel_gather_qmm``: PyTorch
has no op for that gathered int8 product, so the port has a kernel of its
own, K8 (``csrc/gather_qmm.cu``, in place of the XLA einsum at
ops/quant_matmul.py:1523-1533).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ominix_mlx_tpu_torch.core.quant import QuantizedTensor, over_127
from ominix_mlx_tpu_torch.ops._build import SMS

DECODE_M_MAX = 16   # up to this many rows, K1 and K6 run
VPU_M_MAX = 64      # up to this many rows, K7 runs
GATHER_PAIRS_MAX = 65535   # K4 and K8 run a CTA row per (row, slot) pair:
                           # the grid's y dimension bounds T * k
# the JAX package's TPU expert kernel DMAs whole expert slabs, double
# buffered, and takes the weight only where both fit (ops/quant_matmul.py:
# 1738)
GATHER_NBUF, GATHER_SLAB_MAX = 2, 8 * 1024 * 1024
# above this N the JAX package streams scales per panel and pads the rows
# to 2048 and the groups to 128 (ops/quant_matmul.py:114-125, :343)
SB_VMEM_MAX_N = 32768


@dataclasses.dataclass
class PackedQuantizedTensor:
    """Kernel-ready 4- or 8-bit weight (see the module docstring for the
    layout and the dispatch flags)."""

    data: torch.Tensor     # uint8 [N, K/2] (4-bit) or int8 [N, K] (8-bit)
    scales: torch.Tensor   # bf16 [N, G]
    biases: torch.Tensor   # bf16 [N, G]: b - 8s (4-bit) or b (8-bit)
    group_size: int = 64
    bits: int = 4
    in_features: int = 0
    # 8 = per-row dynamic int8 activations where the route's formula has
    # them (w4a8 / w8a8); None = exact bf16
    act_bits: Optional[int] = 8
    # prepare(batched=True) in the JAX package: 2 <= M <= 16 takes the dq
    # formula, and the weight never goes to panels
    batched: bool = False
    # the JAX package would hold this weight in transposed panels
    panels: bool = False
    # the JAX package's prepare would pad it (N > 32768 with G % 128 or
    # N % 2048); a stack of prepared weights has no padding, as there
    padded: bool = False

    @property
    def shape(self):
        return (self.data.shape[0], self.in_features)


def prepare(qt: QuantizedTensor, act_bits: Optional[int] = 8,
            batched: bool = False) -> PackedQuantizedTensor:
    """One-time conversion QuantizedTensor -> the kernel layout."""
    if qt.bits not in (4, 8):
        raise NotImplementedError(f"{qt.bits}-bit weights: 4 and 8 bits "
                                  f"are ported")
    if act_bits not in (8, None):
        raise ValueError(f"act_bits must be 8 or None, got {act_bits!r}")
    N, K = qt.q.shape
    gs = qt.group_size
    if K % 32 or K % gs or gs % 32:
        raise ValueError(f"K={K}, group_size={gs}: the kernels need K and "
                         f"the group size to be multiples of 32")
    scales = qt.scales.to(torch.bfloat16)
    if qt.bits == 4:
        u = (qt.q.to(torch.int16) + 8).to(torch.uint8)
        data = u[:, 0::2] | (u[:, 1::2] << 4)
        biases = (qt.biases.to(torch.bfloat16).float()
                  - 8.0 * scales.float()).to(torch.bfloat16)
    else:
        data = qt.q.to(torch.int8)
        biases = qt.biases.to(torch.bfloat16)
    G = K // gs
    return PackedQuantizedTensor(
        data=data.contiguous(), scales=scales.contiguous(),
        biases=biases.contiguous(), group_size=gs, bits=qt.bits,
        in_features=K, act_bits=act_bits, batched=batched,
        padded=N > SB_VMEM_MAX_N and bool(G % 128 or N % 2048))


def _codes(data: torch.Tensor) -> torch.Tensor:
    """uint8 [..., K/2] -> unsigned 4-bit codes uint8 [..., K] in natural
    order."""
    lo = data & 15
    hi = data >> 4
    return torch.stack([lo, hi], -1).reshape(*data.shape[:-1],
                                             2 * data.shape[-1])


def _code_values(data: torch.Tensor, bits: int) -> torch.Tensor:
    """The stored codes as float32: unsigned u (4-bit) or signed q."""
    return (_codes(data) if bits == 4 else data).float()


def unpack(pqt: PackedQuantizedTensor) -> QuantizedTensor:
    """Inverse of ``prepare`` (canonical signed codes, un-folded biases)."""
    if pqt.bits == 8:
        return QuantizedTensor(q=pqt.data, scales=pqt.scales,
                               biases=pqt.biases,
                               group_size=pqt.group_size, bits=8)
    q = (_codes(pqt.data).to(torch.int16) - 8).to(torch.int8)
    biases = (pqt.biases.float() + 8.0 * pqt.scales.float()).to(
        torch.bfloat16)
    return QuantizedTensor(q=q, scales=pqt.scales, biases=biases,
                           group_size=pqt.group_size, bits=pqt.bits)


def _dequant_rows(data, scales, biases, gs: int, bits: int = 4
                  ) -> torch.Tensor:
    """bf16 weights of the given packed rows: bf16(s * c + b) per element,
    c the stored code and b the stored bias."""
    c = _code_values(data, bits)
    lead, K = c.shape[:-1], c.shape[-1]
    g = c.reshape(*lead, K // gs, gs)
    w = g * scales.float()[..., None] + biases.float()[..., None]
    return w.reshape(*lead, K).to(torch.bfloat16)


def dequantize_packed(pqt: PackedQuantizedTensor) -> torch.Tensor:
    """Dense bf16 [N, K] (the rounding of the JAX package's _dense_tn)."""
    return _dequant_rows(pqt.data, pqt.scales, pqt.biases, pqt.group_size,
                         pqt.bits)


def gather_rows(pqt: PackedQuantizedTensor,
                tokens: torch.Tensor) -> torch.Tensor:
    """Quantized embedding lookup: dequantize only the gathered rows.
    Returns [..., K] bf16."""
    return _dequant_rows(pqt.data[tokens], pqt.scales[tokens],
                         pqt.biases[tokens], pqt.group_size, pqt.bits)


def rms_norm(weight: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """(x * rsqrt(mean(x^2) + eps)) in float32, cast back, times weight:
    the op order of the TPU kernel's fused prologue (nn.layers uses this
    function too)."""
    xf = x.float()
    inv = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * inv).to(x.dtype) * weight


# ------------------------------------------------------------- dispatch ---

def _rows(w: PackedQuantizedTensor) -> int:
    """N as the JAX package holds it: padded to 2048 where it pads."""
    N = w.data.shape[0]
    return N + (-N % 2048 if w.padded else 0)


def panels_ok(w: PackedQuantizedTensor) -> bool:
    """Would the JAX package's ``to_panels_t`` (ops/quant_matmul.py:142-155)
    take this weight? Not batched; 4-bit: K/2 a multiple of 128 and of the
    group size, and an even group count; 8-bit: K a multiple of 128; and a
    panel of at least 128 rows (``_pick_tn``: N a multiple of 128)."""
    K, gs = w.in_features, w.group_size
    if w.batched or _rows(w) % 128:
        return False
    if w.bits == 4:
        return (K // 2) % 128 == 0 and (K // 2) % gs == 0 \
            and (K // gs) % 2 == 0
    return w.bits == 8 and K % 128 == 0


def to_panels(w):
    """Mark a packed weight as held in panels where the JAX package would
    re-tile it (``to_panels_t``); anything else passes through."""
    if isinstance(w, PackedQuantizedTensor) and not w.panels \
            and panels_ok(w):
        return dataclasses.replace(w, panels=True)
    return w


def route(w: PackedQuantizedTensor, M: int) -> str:
    """The formula the JAX package's TPU path computes for this weight at
    M rows (``quantized_matmul``, ops/quant_matmul.py:1314-1402):
    "k1", "k1_mn", "k6", "k7" or "dense" (see the module docstring). The
    conditions are Mosaic's limits (``supported`` without its backend test,
    ``_p_shape_ok``, A5's unpadded shapes), but they choose the formula, so
    the port keeps them."""
    if w.panels:
        if M == 1:
            return "k1"
        return "k1_mn" if M <= DECODE_M_MAX else "dense"
    N, K, gs = _rows(w), w.in_features, w.group_size
    Kd = w.data.shape[1]
    if K % gs or Kd % 128 or N % 128:            # supported()
        return "dense"
    G = K // gs
    p_ok = G <= 128 or (K % (2 * gs) == 0 and (K // 2) % 128 == 0
                        and G <= 256 and N <= SB_VMEM_MAX_N)
    if 1 < M <= DECODE_M_MAX and w.batched:
        return "k1_mn"
    if M <= DECODE_M_MAX and p_ok and (w.bits == 8 or w.act_bits == 8):
        return "k6"
    if w.bits == 4 and M <= VPU_M_MAX and not w.padded:
        return "k7"
    return "dense"


def rounds_x(path: str, w: PackedQuantizedTensor, M: int) -> bool:
    """Whether the JAX formula of ``path`` rounds x to bf16 before it
    quantizes or group-sums it: A1 and A4 read a raw bf16 x at M=1 on
    4-bit weights (``act_ik``, ops/quant_matmul.py:599, :946), A5 and the
    dense product cast x first (:1258, :1393). Every other formula takes
    float32 x as it is (:603-608, :980-983, :1150-1153)."""
    return path in ("k7", "dense") or (
        path in ("k1", "k6") and w.bits == 4 and M == 1)


# ------------------------------------------------------ plain versions ---

def qmm_p_reference(x: torch.Tensor, w: PackedQuantizedTensor,
                    norm_w: Optional[torch.Tensor] = None,
                    norm_eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version of the P formula (K1 at M=1, K6): x [M, K] ->
    [M, N] in x's dtype, a8 where ``w.act_bits == 8``.

    The TPU kernels' formula (_pt_kernel, quant_matmul.py:771-838,
    :914-927; _pm_kernel/_qmm_p, :417-577, :603-620): x as given (bf16 at
    M=1 on 4-bit weights, where the kernels read a raw bf16 x), optional
    RMSNorm ``xn = bf16(bf16(x * inv) * norm_w)`` (fused into A1's 4-bit
    prologue), per-row ``sx = max|xn|/127 + 1e-12`` and ``cx = round(xn /
    sx)`` (a8) or ``sx = 1``, ``cx = bf16(xn)`` (a16), and
    ``y = sx * sum_g s_g * P_g + sum_g bf16(xg_g) * b*_g``, ``P_g`` the dot
    of cx with the stored codes of group g and ``xg_g`` the group sum of xn.
    """
    M, K = x.shape
    gs = w.group_size
    G = K // gs
    xb = x.to(torch.bfloat16) if rounds_x("k1", w, M) else x
    if norm_w is not None:
        xb = rms_norm(norm_w.to(torch.bfloat16), xb, norm_eps)
    xn = xb.float()
    if w.act_bits == 8:
        sx = over_127(xn.abs().amax(-1, keepdim=True)) + 1e-12
        cx = torch.round(xn / sx)
    else:
        sx = torch.ones(M, 1, device=x.device)
        cx = xn.to(torch.bfloat16).float()
    c = _code_values(w.data, w.bits).reshape(-1, G, gs)
    # a8: |P| <= gs * 127 * 128 < 2^24, exact in float32
    P = torch.einsum("mgk,ngk->mng", cx.reshape(M, G, gs), c)
    acc_p = (P * w.scales.float()[None]).sum(-1)
    xg = xn.reshape(M, G, gs).sum(-1).to(torch.bfloat16).float()
    acc_b = xg @ w.biases.float().T
    return (sx * acc_p + acc_b).to(x.dtype)


def unfolded_biases(w: PackedQuantizedTensor) -> torch.Tensor:
    """The dq formula's bias b: stored as is (8-bit), or bf16(b' + 8s)
    (4-bit, as the JAX package unfolds its panel biases)."""
    if w.bits == 8:
        return w.biases
    return (w.biases.float() + 8.0 * w.scales.float()).to(torch.bfloat16)


def qmm_dq_reference(x: torch.Tensor, w: PackedQuantizedTensor,
                     raw_sums: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the dq formula (K1 at 2 <= M <= 16, K7):
    x [M, K] -> [M, N] in x's dtype. The TPU kernels' rounding
    (_dq_kernel, quant_matmul.py:1110-1135; _vpu_kernel, :1229-1250):
    ``y = bf16(x) @ bf16(d * s)^T + bf16(xg) @ b^T`` in float32, d the
    centred code, b ``unfolded_biases(w)``, xg the group sums of x as
    given (raw_sums, A3 :1150-1153) or of bf16(x) (A5 rounds x first,
    :1258)."""
    M, K = x.shape
    gs = w.group_size
    G = K // gs
    xb = x.to(torch.bfloat16).float()
    xs = x.float() if raw_sums else xb
    d = _code_values(w.data, w.bits) - (8.0 if w.bits == 4 else 0.0)
    wd = (d.reshape(-1, G, gs) * w.scales.float()[..., None]).to(
        torch.bfloat16).float().reshape(-1, K)
    xg = xs.reshape(M, G, gs).sum(-1).to(torch.bfloat16).float()
    return (xb @ wd.T + xg @ unfolded_biases(w).float().T).to(x.dtype)


def dense_matmul(x: torch.Tensor, w: PackedQuantizedTensor) -> torch.Tensor:
    """The "dense" route: ``bf16(x) @ dequantize_packed(w)^T`` summed in
    float32 (cuBLAS on CUDA). Not a kernel of the port: the JAX package
    leaves this product to XLA."""
    wd = dequantize_packed(w)
    if x.is_cuda:
        return torch.matmul(x.to(torch.bfloat16), wd.T).to(x.dtype)
    return (x.to(torch.bfloat16).float() @ wd.float().T).to(x.dtype)


def quantized_matmul_reference(x: torch.Tensor, w: PackedQuantizedTensor,
                               path: str,
                               norm_w: Optional[torch.Tensor] = None,
                               norm_eps: float = 1e-6) -> torch.Tensor:
    """The plain version of the formula of ``path`` (a name ``route``
    returns): x [M, K] -> [M, N]. Only the P formula takes a norm (K1
    fuses it at M=1)."""
    if path in ("k1", "k6"):
        return qmm_p_reference(x, w, norm_w, norm_eps)
    if norm_w is not None:
        raise ValueError(f"route {path!r} takes an already-normed x")
    if path in ("k1_mn", "k7"):
        return qmm_dq_reference(x, w, raw_sums=path == "k1_mn")
    if path == "dense":
        return dense_matmul(x, w)
    raise ValueError(f"route {path!r}")


# ------------------------------------------------------------- kernels ---

def _check_launch(what: str, x: torch.Tensor, w: PackedQuantizedTensor,
                  m_max: int):
    """Raise unless x [M, K] and w are what the kernels take."""
    M, K = x.shape
    N = w.data.shape[0]
    G = K // w.group_size
    dev = x.device
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"{what} takes contiguous bf16 x, got {x.dtype}")
    if not 1 <= M <= m_max:
        raise ValueError(f"{what} takes 1 <= M <= {m_max}, got M={M}")
    if K != w.in_features or w.bits not in (4, 8) or K % 32 \
            or w.group_size % 32:
        raise ValueError(f"x has K={K}; {what} takes a 4- or 8-bit weight "
                         f"with K={w.in_features} and the group size "
                         f"multiples of 32")
    dt, shp = ((torch.uint8, (N, K // 2)) if w.bits == 4
               else (torch.int8, (N, K)))
    for name, t, want_dt, want_shp in (
            ("data", w.data, dt, shp),
            ("scales", w.scales, torch.bfloat16, (N, G)),
            ("biases", w.biases, torch.bfloat16, (N, G))):
        if t.device != dev or t.dtype != want_dt \
                or tuple(t.shape) != want_shp or not t.is_contiguous():
            raise ValueError(f"{what} {name}: want contiguous {want_dt} "
                             f"{want_shp} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    _check_aligned(what, w.data, x)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy where x is a view at an address the kernels' 16-byte
    vector loads cannot take."""
    return x.clone() if x.data_ptr() % 16 else x


def _check_aligned(what: str, data: torch.Tensor, x: torch.Tensor):
    if data.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError(f"{what} needs 16-byte aligned data and x")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x is on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _check_ids(what: str, ids: torch.Tensor, T: int, k: int, dev):
    if ids.dtype != torch.int32 or not ids.is_contiguous() \
            or ids.dim() != 2 or ids.shape[0] != T or ids.device != dev:
        raise ValueError(f"{what} ids: want contiguous int32 [{T}, k] on "
                         f"{dev}, got {ids.dtype} {tuple(ids.shape)} on "
                         f"{ids.device}")
    if not 1 <= T * k <= GATHER_PAIRS_MAX:
        raise ValueError(f"{what} takes 1 to {GATHER_PAIRS_MAX} (row, slot) "
                         f"pairs, got T={T}, k={k}")


# The P formula's plan (csrc/qmm.cu qmm_p): a warp owns ``rows_per_warp``
# output rows, as many as still leave QMM_P_MIN_WARPS warps over the card
# (16 an SM), at most 4 (2 past 4 rows of x, whose accumulators take the
# registers; one with bf16 activations past 4 rows, where a16's
# accumulators and unpacked codes leave too few warps an SM). The C
# launch derives the grid from N and the rows a warp.
QMM_P_MIN_WARPS = 16 * SMS


def qmm_p_rows_per_warp(M: int, N: int, a8: bool = True) -> int:
    """Output rows a warp of the rows kernel owns, for x [M, K] against
    W [N, K], int8 (a8) or bf16 activations; K and the bits do not enter
    (a lane walks the whole row)."""
    if not 1 <= M <= DECODE_M_MAX or N < 1:
        raise ValueError(f"the P formula takes 1 <= M <= {DECODE_M_MAX} "
                         f"and N >= 1; got M={M}, N={N}")
    widths = (4, 2, 1) if M <= 4 else (2, 1) if a8 else (1,)
    return next(r for r in widths
                if r == 1 or -(-N // r) >= QMM_P_MIN_WARPS)


def _launch_p(what: str, x: torch.Tensor, w: PackedQuantizedTensor,
              norm_w: Optional[torch.Tensor], norm_eps: float):
    """The P formula on the card (csrc/qmm.cu ominix_qmm_p): the prologue
    (norm, group sums, a8 quantisation), then the rows kernel behind it by
    programmatic dependent launch, ``qmm_p_rows_per_warp`` rows a warp."""
    from ominix_mlx_tpu_torch.ops import _build

    M, K = x.shape
    N = w.data.shape[0]
    G = K // w.group_size
    dev = x.device
    a8 = w.act_bits == 8
    rw = qmm_p_rows_per_warp(M, N, a8)
    lib = _build.library()
    y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
    xg = torch.empty(M, G, dtype=torch.float32, device=dev)
    xq = sx = xn = None
    if a8:
        xq = torch.empty(M, K, dtype=torch.int8, device=dev)
        sx = torch.empty(M, dtype=torch.float32, device=dev)
    elif norm_w is not None:
        xn = torch.empty(M, K, dtype=torch.bfloat16, device=dev)
    rc = lib.ominix_qmm_p(
        _ptr(x), _ptr(norm_w), float(norm_eps), _ptr(w.data),
        _ptr(w.scales), _ptr(w.biases), _ptr(y), _ptr(xq), _ptr(xg),
        _ptr(sx), _ptr(xn), M, N, K, w.group_size, w.bits, int(a8),
        rw, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, f"{what} (ominix_qmm_p)")
    return y


# The dq kernel's plan (csrc/qmm_tc.cu): a warpgroup owns 64-row tiles of
# the output, a pipeline stage is 128 columns of K, a CTA holds 1 to 4
# warpgroups (2 where x has more than 16 rows, whose warpgroups hold more
# registers) and the x slice of its split in shared memory. DQ_SMEM_MAX is
# the dynamic shared memory a block may use on sm_90.
DQ_TILE_N, DQ_STEP_K, DQ_MAX_WG = 64, 128, 4
DQ_SMEM_MAX = 232448


@dataclasses.dataclass(frozen=True)
class DqPlan:
    """How the dq kernel covers an [M, N, K] product: x padded to ``mp``
    rows, ``warpgroups`` a CTA, each over ``tiles`` 64-row tiles of N in
    turn, and K cut into ``splits`` slices of ``k_slice`` columns (the last
    may be shorter)."""

    mp: int
    warpgroups: int
    tiles: int
    splits: int
    k_slice: int


def dq_ring_bytes(mp: int, bits: int) -> int:
    """A thread's ring (``Ring`` in csrc/qmm_tc.cu): 4 stages where x is at
    most 16 rows, else 8, of two (4-bit) or four (8-bit) 16-byte chunks of
    codes and two scale words."""
    return (4 if mp <= 16 else 8) * ((2 if bits == 4 else 4) * 16 + 8)


def dq_smem(mp: int, warpgroups: int, k_slice: int, gs: int,
            bits: int = 4) -> int:
    """Shared memory of one CTA of the dq kernel, alignment slack included
    (``smem_bytes`` in csrc/qmm_tc.cu): the x slice in 128-column steps,
    the bias operand in boxes of 64 groups, the 32-column sums, the
    ring."""
    nst = -(-k_slice // DQ_STEP_K)
    nbb = -(-(k_slice // gs) // 64)
    return (1024 + nst * mp * 256 + nbb * mp * 128 + mp * nst * 16
            + dq_ring_bytes(mp, bits) * 128 * warpgroups)


def dq_plan(M: int, N: int, K: int, gs: int, bits: int = 4) -> DqPlan:
    """The dq kernel's plan for x [M, K] against a ``bits``-bit W [N, K] at
    group size gs.

    K is split where the 64-row tiles of N cannot give every SM a
    warpgroup, and further where the CTA's x slice does not fit shared
    memory; a slice is a whole number of groups and of 128-column steps.
    A CTA takes as many warpgroups as one wave over the SMs needs (at most
    4, fewer where shared memory is short), and each warpgroup as many
    tiles as keep the CTAs within one wave, so each staged x slice serves
    every tile of its CTA."""
    if not 1 <= M <= VPU_M_MAX or K % 32 or gs % 32 or K % gs:
        raise ValueError(f"the dq kernel takes 1 <= M <= {VPU_M_MAX} and K "
                         f"a multiple of the group size, both multiples of "
                         f"32; got M={M}, K={K}, group size {gs}")
    mp = next(p for p in (8, 16, 32, 64) if M <= p)
    tiles = -(-N // DQ_TILE_N)
    step = math.lcm(gs, DQ_STEP_K)
    units = -(-K // step)
    # steps per slice: the most that still gives every SM a tile, then
    # fewer until the CTA fits shared memory
    per = max(1, -(-units // -(-SMS // tiles)))
    while per > 1 and tiles * -(-units // per) < SMS:
        per -= 1
    while True:
        k_slice = per * step
        splits = -(-K // k_slice)
        want = min(DQ_MAX_WG if mp <= 16 else 2, -(-tiles * splits // SMS))
        for wgs in range(want, 0, -1):
            if dq_smem(mp, wgs, k_slice, gs, bits) <= DQ_SMEM_MAX:
                per_wg = -(-tiles * splits // (SMS * wgs))
                return DqPlan(mp, wgs, per_wg, splits, k_slice)
        if per == 1:
            raise ValueError(f"no dq plan fits shared memory at M={M}, "
                             f"group size {gs}")
        per -= 1


def _launch_dq(what: str, x: torch.Tensor, w: PackedQuantizedTensor):
    """The dq formula on the card (csrc/qmm_tc.cu ominix_qmm_dq_tc): one
    launch, or two where ``dq_plan`` splits K (the partials summed in
    slice order by a second kernel)."""
    from ominix_mlx_tpu_torch.ops import _build

    M, K = x.shape
    N = w.data.shape[0]
    dev = x.device
    if w.scales.data_ptr() % 4 or w.biases.data_ptr() % 4:
        raise ValueError(f"{what} needs 4-byte aligned scales and biases")
    if w.data.numel() >= 2 ** 31:
        raise ValueError(f"{what} indexes the weight with 32-bit offsets: "
                         f"{w.data.numel()} bytes is too many")
    plan = dq_plan(M, N, K, w.group_size, w.bits)
    lib = _build.library()
    y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
    part = (torch.empty(plan.splits, M, N, dtype=torch.float32, device=dev)
            if plan.splits > 1 else None)
    rc = lib.ominix_qmm_dq_tc(
        x.data_ptr(), w.data.data_ptr(), w.scales.data_ptr(),
        w.biases.data_ptr(), y.data_ptr(), _ptr(part), M, N, K,
        w.group_size, w.bits, plan.mp, plan.warpgroups, plan.tiles,
        plan.splits, plan.k_slice, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, f"{what} (ominix_qmm_dq_tc)")
    return y


def _k1(x: torch.Tensor, w: PackedQuantizedTensor,
        norm_w: Optional[torch.Tensor] = None,
        norm_eps: float = 1e-6) -> torch.Tensor:
    """Launch K1 on the current stream: bf16 x [M, K] on CUDA -> bf16
    [M, N]. M = 1: the P formula (A1, csrc/qmm.cu), a8 where
    ``w.act_bits == 8``, the RMSNorm fused for a 4-bit weight;
    2 <= M <= 16: the dq formula (A3) on the tensor cores
    (csrc/qmm_tc.cu), x already normed."""
    from ominix_mlx_tpu_torch.ops import _build

    _check_launch("K1", x, w, DECODE_M_MAX)
    M, K = x.shape
    if norm_w is not None and (M != 1 or w.bits != 4
                               or norm_w.device != x.device
                               or norm_w.dtype != torch.bfloat16
                               or tuple(norm_w.shape) != (K,)
                               or not norm_w.is_contiguous()):
        raise ValueError("K1 fuses the norm at M=1 on 4-bit weights only, "
                         f"from a contiguous bf16 [K] weight on {x.device}")
    w8 = "_w8" if w.bits == 8 else ""
    if M == 1:
        y = _launch_p("K1", x, w, norm_w, norm_eps)
        _build.LAUNCHES["k1_m1" + w8] += 1
    else:
        y = _launch_dq("K1", x, w)
        _build.LAUNCHES["k1_mn" + w8] += 1
    return y


def _k6(x: torch.Tensor, w: PackedQuantizedTensor) -> torch.Tensor:
    """Launch K6 (csrc/qmm.cu, the P formula over up to 16 rows; replaces
    A4 ``_pm_kernel``) on the current stream: bf16 x [M, K], already
    normed, on CUDA -> bf16 [M, N]. Modes w4a8, w8a8 and w8a16."""
    from ominix_mlx_tpu_torch.ops import _build

    _check_launch("K6", x, w, DECODE_M_MAX)
    if w.bits == 4 and w.act_bits != 8:
        raise ValueError("K6 takes w4a8, w8a8 or w8a16: a 4-bit weight "
                         "needs act_bits=8")
    y = _launch_p("K6", x, w, None, 0.0)
    _build.LAUNCHES["k6"] += 1
    return y


def _k7(x: torch.Tensor, w: PackedQuantizedTensor) -> torch.Tensor:
    """Launch K7 (the dq kernel of csrc/qmm_tc.cu on a row-major 4-bit
    weight; replaces A5 ``_vpu_kernel``) on the current stream: bf16 x
    [M, K], M <= 64, already normed, on CUDA -> bf16 [M, N]."""
    from ominix_mlx_tpu_torch.ops import _build

    _check_launch("K7", x, w, VPU_M_MAX)
    if w.bits != 4:
        raise ValueError("K7 takes 4-bit weights")
    y = _launch_dq("K7", x, w)
    _build.LAUNCHES["k7"] += 1
    return y


def quantized_matmul(x: torch.Tensor, w,
                     norm_w: Optional[torch.Tensor] = None,
                     norm_eps: float = 1e-6) -> torch.Tensor:
    """x [..., K] @ W^T -> [..., N] in x's dtype, by ``route(w, M)``.

    norm_w (optional [K]): RMSNorm x first; fused into K1's prologue where
    the JAX package fuses it (route "k1" on a 4-bit weight), applied
    before the matmul with the same op order everywhere else.
    """
    if isinstance(w, ChannelQuantizedTensor):
        if norm_w is not None:
            x = rms_norm(norm_w, x, norm_eps)
        return channel_matmul(x, w)
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    N = w.data.shape[0]
    r = route(w, M)
    if norm_w is not None and not (r == "k1" and w.bits == 4):
        x2 = rms_norm(norm_w, x2, norm_eps)
        norm_w = None
    if not x2.is_cuda:
        y = quantized_matmul_reference(x2, w, r, norm_w, norm_eps)
    elif r == "dense":
        y = dense_matmul(x2, w)
    else:
        if x2.dtype != torch.bfloat16 and not rounds_x(r, w, M):
            raise ValueError(
                f"route {r!r}: {x2.dtype} activations; the kernel takes bf16 "
                f"and the JAX formula quantizes and sums x unrounded here")
        xk = _aligned(x2.to(torch.bfloat16).contiguous())
        if r == "k1":
            y = _k1(xk, w, None if norm_w is None
                    else norm_w.to(torch.bfloat16).contiguous(), norm_eps)
        else:
            y = {"k1_mn": _k1, "k6": _k6, "k7": _k7}[r](xk, w)
    return y.to(x.dtype).reshape(*lead, N)


# ------------------------------------- channelwise w8a8 (batched serving) ---
# (counterpart of ominix_mlx_tpu/ops/quant_matmul.py:1404-1474)

INT_MM_MIN_ROWS = 17    # torch._int_mm on CUDA takes more than 16 rows


@dataclasses.dataclass
class ChannelQuantizedTensor:
    """Per-output-channel symmetric int8 weight: w[n, k] ~ data[n, k] *
    scale[n]. Activations are quantized per token at run time."""

    data: torch.Tensor   # int8 [N, K]
    scale: torch.Tensor  # f32 [N]

    @property
    def shape(self):
        return tuple(self.data.shape)


def channel_quantize(w: torch.Tensor) -> ChannelQuantizedTensor:
    """bf16/f32 [N, K] -> per-row symmetric int8 (scale = max|w|/127 +
    1e-12, codes = clip(round(w / scale), -127, 127))."""
    wf = w.float()
    s = over_127(wf.abs().amax(1)) + 1e-12
    q = torch.clamp(torch.round(wf / s[:, None]), -127, 127).to(torch.int8)
    return ChannelQuantizedTensor(data=q.contiguous(), scale=s)


def channel_dequantize(w: ChannelQuantizedTensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    return (w.data.float() * w.scale[:, None]).to(dtype)


def quantize_act_channel(xf: torch.Tensor):
    """Dynamic per-row symmetric int8 activations: xf [..., K] float32 ->
    (int8 codes [..., K], scale [...])."""
    sx = over_127(xf.abs().amax(-1)) + 1e-12
    xq = torch.clamp(torch.round(xf / sx[..., None]), -127, 127).to(
        torch.int8)
    return xq, sx


def _int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M, K] x int8 [N, K]^T summed in int32 -> [M, N].

    On CUDA, ``torch._int_mm`` takes more than 16 rows and K, N multiples
    of 8: fewer rows are zero-padded (exact: rows are independent); other
    K or N raise."""
    M, K = xq.shape
    N = wq.shape[0]
    if xq.is_cuda:
        if K % 8 or N % 8:
            raise ValueError(f"int8 matmul on CUDA needs K and N multiples "
                             f"of 8, got K={K}, N={N}")
        if M < INT_MM_MIN_ROWS:
            pad = -(-INT_MM_MIN_ROWS // 8) * 8 - M
            xq = torch.cat([xq, xq.new_zeros(pad, K)])
        return torch._int_mm(xq, wq.T)[:M]
    return torch._int_mm(xq, wq.T)


def channel_matmul(x: torch.Tensor, w: ChannelQuantizedTensor) -> torch.Tensor:
    """x [..., K] @ W^T -> [..., N] in x's dtype with dynamic per-token
    int8 activations, at any M: int8 x int8 summed in int32, then
    ``* sx * scale`` in float32 (ops/quant_matmul.py:1451-1455)."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    xq, sx = quantize_act_channel(x.reshape(-1, K).float())
    acc = _int8_matmul(xq.contiguous(), w.data)
    y = acc.float() * sx[:, None] * w.scale[None, :]
    return y.to(x.dtype).reshape(*lead, w.data.shape[0])


def channel_gather_rows(w: ChannelQuantizedTensor,
                        tokens: torch.Tensor) -> torch.Tensor:
    """Embedding lookup on a channel-quantized table -> bf16 rows."""
    rows = w.data[tokens].float()
    return (rows * w.scale[tokens][..., None]).to(torch.bfloat16)


# --------------------------- channelwise w8a8 MoE experts (channel_gather_qmm,
# K8; counterpart of ominix_mlx_tpu/ops/quant_matmul.py:1477-1533)

@dataclasses.dataclass
class ChannelQuantizedExperts:
    """Stacked per-(expert, output-channel) symmetric int8 weights, the
    batched-serving scheme of a MoE model: w[e, n, k] ~ data[e, n, k] *
    scale[e, n]."""

    data: torch.Tensor   # int8 [E, N, K]
    scale: torch.Tensor  # f32 [E, N]

    @property
    def shape(self):
        return tuple(self.data.shape)


def channel_quantize_experts(w: torch.Tensor) -> ChannelQuantizedExperts:
    """bf16/f32 stacked experts [E, N, K] -> per-(expert, row) int8, by
    ``channel_quantize``'s rule."""
    wf = w.float()
    s = over_127(wf.abs().amax(-1)) + 1e-12
    q = torch.clamp(torch.round(wf / s[..., None]), -127, 127).to(torch.int8)
    return ChannelQuantizedExperts(data=q.contiguous(), scale=s)


def channel_dequantize_expert(w: ChannelQuantizedExperts, e: int,
                              dtype=torch.bfloat16) -> torch.Tensor:
    """ONE expert's weights [N, K]."""
    return (w.data[e].float() * w.scale[e][:, None]).to(dtype)


def channel_expert_matmul_q(xq: torch.Tensor, sx: torch.Tensor,
                            w: ChannelQuantizedExperts, e: int
                            ) -> torch.Tensor:
    """Already quantized activations (xq int8 [M, K], sx [M]) against ONE
    expert: the exact int8 product (``torch._int_mm``; XLA's dot_general
    in the JAX package), then ``* sx * scale`` -> f32 [M, N]."""
    acc = _int8_matmul(xq, w.data[e])
    return acc.float() * sx[:, None] * w.scale[e][None, :]


def channel_gather_qmm_reference(x: torch.Tensor, w: ChannelQuantizedExperts,
                                 ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8: x [T, K], ids [T, k] -> f32 [T, k, N],
    row t against the experts ids[t] (the JAX package's
    ``channel_gather_qmm``): x quantized per row from float32
    (``quantize_act_channel``), the int8 products summed exactly in int32
    (up to K * 127^2, past float32's 2^24, so one ``_int8_matmul`` per
    row over its k gathered experts, never a float32 einsum), then
    ``acc * sx * scale`` in float32, in that order."""
    T, K = x.shape
    k = ids.shape[1]
    ids = ids.long()
    xq, sx = quantize_act_channel(x.float())
    N = w.data.shape[1]
    acc = torch.stack([_int8_matmul(xq[t:t + 1].contiguous(),
                                    w.data[ids[t]].reshape(k * N, K))[0]
                       for t in range(T)]).reshape(T, k, N)
    return acc.float() * sx[:, None, None] * w.scale[ids]


# The plan of K4's and K8's rows kernel (csrc/gather_qmm.cu): a warp's
# lanes form groups of ``lanes`` that each own ``rows`` consecutive output
# rows of one (row, slot) pair and stack, 8 rows a warp: 16 lanes a row
# where 16 divides a row's 16-byte chunks, else 8 (no lane idle at the
# down projection's 24-chunk 4-bit rows). Every decode call of moe_block
# (gate and up in one launch, and down) needs more than one wave of CTAs
# at Qwen3-30B-A3B's widths, where 8 rows a warp read fastest of the
# plans timed on the H100, or within 3.3 % of the fastest (PERF.md, "The
# plan"). GATHER_PLANS lists the (lanes, rows) the C launch has a
# template for; it derives the grid from them.
GATHER_PLANS = ((16, 4), (8, 2))


def gather_plan(K: int, bits: int) -> tuple:
    """(lanes, rows) of the rows kernel on experts of K ``bits``-bit codes
    a row (K8's int8 rows: 8), from shapes alone."""
    if bits not in (4, 8) or K < 1 or K * bits % 128:
        raise ValueError(f"no gather plan for K={K}, bits={bits}")
    return GATHER_PLANS[0] if K * bits // 128 % 16 == 0 else GATHER_PLANS[1]


def _ids32(ids: torch.Tensor) -> torch.Tensor:
    """ids as the kernels take them: contiguous int32 (no copy where they
    are already)."""
    return ids.to(torch.int32).contiguous()


def _check_pair(what: str, w, up, fields):
    """Raise unless ``up`` (the second stack of a launch) matches ``w``."""
    if up is not None and (up.data.shape != w.data.shape or any(
            getattr(up, f) != getattr(w, f) for f in fields)):
        raise ValueError(f"{what}: the second stack must match the first "
                         f"({tuple(w.data.shape)}, {fields}), got "
                         f"{tuple(up.data.shape)}")


def _k8(x: torch.Tensor, w: ChannelQuantizedExperts, ids: torch.Tensor,
        up: Optional[ChannelQuantizedExperts] = None):
    """Launch K8 (csrc/gather_qmm.cu) on the current stream: float32 or
    bf16 x [T, K], int32 ids [T, k] on CUDA -> f32 [T, k, N]; with ``up``
    (a second stack of the same shape), (y, y_up) from one launch."""
    from ominix_mlx_tpu_torch.ops import _build

    T, K = x.shape
    E, N, _ = w.data.shape
    k = ids.shape[1] if ids.dim() == 2 else 0
    dev = x.device
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or not x.is_contiguous():
        raise ValueError(f"K8 takes contiguous float32 or bf16 x, got "
                         f"{x.dtype}")
    _check_ids("K8", ids, T, k, dev)
    if K % 16:
        raise ValueError(f"K8 takes K a multiple of 16, got K={K}")
    _check_pair("K8", w, up, ())
    stacks = (w,) if up is None else (w, up)
    for ws in stacks:
        for name, t, dt, shp in (("data", ws.data, torch.int8, (E, N, K)),
                                 ("scale", ws.scale, torch.float32, (E, N))):
            if t.device != dev or t.dtype != dt or tuple(t.shape) != shp \
                    or not t.is_contiguous():
                raise ValueError(f"K8 {name}: want contiguous {dt} {shp} on "
                                 f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                                 f"{t.device}")
        _check_aligned("K8", ws.data, x)
    lanes, rows = gather_plan(K, 8)
    lib = _build.library()
    ys = [torch.empty(T, k, N, dtype=torch.float32, device=dev)
          for _ in stacks]
    xq = torch.empty(T, K, dtype=torch.int8, device=dev)
    sx = torch.empty(T, dtype=torch.float32, device=dev)
    second = (up.data, up.scale, ys[1]) if up is not None else (None,) * 3
    rc = lib.ominix_channel_gather_qmm(
        x.data_ptr(), int(x.dtype == torch.bfloat16), ids.data_ptr(),
        w.data.data_ptr(), w.scale.data_ptr(), ys[0].data_ptr(),
        *map(_ptr, second), xq.data_ptr(), sx.data_ptr(), T, k, E, N, K,
        lanes, rows, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "K8 (ominix_channel_gather_qmm)")
    _build.LAUNCHES["k8"] += 1
    return ys[0] if up is None else tuple(ys)


def _k8_x(x: torch.Tensor) -> torch.Tensor:
    """x as K8 takes it: float32 or bf16 as it is (the prologue widens bf16
    exactly), other types widened to float32; contiguous and aligned."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.float()
    return _aligned(x.contiguous())


def channel_gather_qmm(x: torch.Tensor, w: ChannelQuantizedExperts,
                       ids: torch.Tensor) -> torch.Tensor:
    """Expert-gathered w8a8 matmul (decode): x [T, K], ids [T, k] -> f32
    [T, k, N], reading only the selected experts' int8 rows. A CUDA tensor
    launches K8; a CPU tensor takes ``channel_gather_qmm_reference``."""
    if not x.is_cuda:
        return channel_gather_qmm_reference(x, w, ids)
    return _k8(_k8_x(x), w, _ids32(ids))


def channel_gather_qmm_gate_up(x: torch.Tensor, wg: ChannelQuantizedExperts,
                               wu: ChannelQuantizedExperts,
                               ids: torch.Tensor) -> tuple:
    """A MoE layer's gate and up projections at decode, against the same x
    [T, K] and ids [T, k]: (channel_gather_qmm(x, wg, ids),
    channel_gather_qmm(x, wu, ids)). On a CUDA tensor with stacks of one
    shape, one K8 launch (one prologue, one rows kernel, both outputs);
    else the two calls."""
    if x.is_cuda and wg.data.shape == wu.data.shape:
        return _k8(_k8_x(x), wg, _ids32(ids), wu)
    return channel_gather_qmm(x, wg, ids), channel_gather_qmm(x, wu, ids)


# ----------------------------------- MoE expert weights (gather_qmm, K4) ---
# (counterpart of ominix_mlx_tpu/ops/quant_matmul.py:1536-1761)

@dataclasses.dataclass
class PackedQuantizedExperts:
    """Stacked 4- or 8-bit expert weights [E, N, K] in K1's layout with an
    expert axis: ``data`` uint8 [E, N, K/2] in natural nibble order with
    the biases holding the fold ``b - 8s`` (4-bit), or int8 [E, N, K], the
    signed codes, with the biases ``b`` as they are (8-bit, as the JAX
    package's ``prepare`` stores them); bf16 ``scales`` and ``biases``
    [E, N, G]. act_bits=8 is the TPU kernel's a8 formula where
    ``expert_route`` names it; None is exact (what the JAX package computes
    off the TPU)."""

    data: torch.Tensor     # uint8 [E, N, K/2] (4-bit) or int8 [E, N, K]
    scales: torch.Tensor   # bf16 [E, N, G]
    biases: torch.Tensor   # bf16 [E, N, G]: b - 8s (4-bit) or b (8-bit)
    group_size: int = 64
    bits: int = 4
    in_features: int = 0
    act_bits: Optional[int] = 8

    @property
    def shape(self):
        return (self.data.shape[0], self.data.shape[1], self.in_features)


def pack_experts(qt: QuantizedTensor, E: int,
                 act_bits: Optional[int] = 8) -> PackedQuantizedExperts:
    """Pack ``qt``, which holds E experts' rows stacked [E * N, K]
    (``prepare``'s layout and bits; other than 4 or 8 bits raise)."""
    p = prepare(qt, act_bits=act_bits)
    N = p.data.shape[0] // E
    return PackedQuantizedExperts(
        data=p.data.reshape(E, N, -1), scales=p.scales.reshape(E, N, -1),
        biases=p.biases.reshape(E, N, -1), group_size=p.group_size,
        bits=p.bits, in_features=p.in_features, act_bits=act_bits)


def quantize_experts(w: torch.Tensor, group_size: int = 64, bits: int = 4,
                     act_bits: Optional[int] = 8) -> PackedQuantizedExperts:
    """Quantize stacked expert weights [E, N, K] (load time): each row by
    the same group rule as ``core.quant.quantize_tensor``."""
    from ominix_mlx_tpu_torch.core.quant import quantize_tensor

    E, N, K = w.shape
    return pack_experts(quantize_tensor(w.reshape(E * N, K).float(),
                                        group_size, bits), E, act_bits)


def experts_from_quantized(qts: list, act_bits: Optional[int] = 8
                           ) -> PackedQuantizedExperts:
    """Stack per-expert ``QuantizedTensor``s [N, K] (from a checkpoint)
    into the gather_qmm layout."""
    q0 = qts[0]
    stacked = QuantizedTensor(
        q=torch.cat([q.q for q in qts]),
        scales=torch.cat([q.scales for q in qts]),
        biases=torch.cat([q.biases for q in qts]),
        group_size=q0.group_size, bits=q0.bits)
    return pack_experts(stacked, len(qts), act_bits)


def dequantize_expert(pqe: PackedQuantizedExperts, e: int) -> torch.Tensor:
    """ONE expert's weights as bf16 [N, K]."""
    return _dequant_rows(pqe.data[e], pqe.scales[e], pqe.biases[e],
                         pqe.group_size, pqe.bits)


def dequantize_experts(pqe: PackedQuantizedExperts) -> torch.Tensor:
    """Every expert's weights as bf16 [E, N, K], in one elementwise pass
    (``dequantize_expert`` of each e, stacked)."""
    return _dequant_rows(pqe.data, pqe.scales, pqe.biases, pqe.group_size,
                         pqe.bits)


def expert_route(w: PackedQuantizedExperts, T: int) -> str:
    """The formula the JAX package's ``gather_qmm`` computes on the TPU for
    these experts (ops/quant_matmul.py:1734-1738): "k4", its kernel's a8
    formula, where the kernel takes the shape (4 or 8 bits, at most 128
    groups, the stored row and N multiples of 128, K a multiple of twice
    the group size, and the double-buffered expert slab within 8 MiB);
    else "gathered", its exact fallback. The TPU kernel runs every row of
    x alone (``lax.map``), so the row count T does not enter."""
    E, N, Kd = w.data.shape
    K, gs = w.in_features, w.group_size
    ok = (w.bits in (4, 8) and K // gs <= 128 and Kd % 128 == 0
          and N % 128 == 0 and K % (2 * gs) == 0
          and GATHER_NBUF * N * Kd <= GATHER_SLAB_MAX)
    return "k4" if ok else "gathered"


def gather_qmm_reference(x: torch.Tensor, w: PackedQuantizedExperts,
                         ids: torch.Tensor,
                         act_bits: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of K4: x [T, K], ids [T, k] -> [T, k, N] in
    x's dtype, row t against the experts ids[t].

    act_bits=8 is the TPU decode kernel's formula per row
    (_gather_qmm_decode and _gq_kernel, ops/quant_matmul.py:1676-1718,
    :1606-1672): x as given, ``sx = max|x|/127 + 1e-12``,
    ``cx = round(x / sx)``, bf16 group sums ``xg``, and
    ``y = sx * sum_g s_g * P_g + sum_g xg_g * b*_g`` with ``P_g`` the
    integer dot product of cx with the stored codes of group g (unsigned
    4-bit codes against the folded b - 8s, or signed 8-bit codes against
    b). act_bits=None is the JAX package's fallback (:1750-1760): the
    gathered weights dequantized in float32 (no bf16 rounding), times
    float32 x."""
    T, K = x.shape
    k = ids.shape[1]
    gs = w.group_size
    G = K // gs
    ids = ids.long()
    c = _code_values(w.data[ids], w.bits)                  # [T, k, N, K]
    s = w.scales[ids].float()                              # [T, k, N, G]
    b = w.biases[ids].float()
    N = c.shape[2]
    if act_bits is None:
        wd = (c.reshape(T, k, N, G, gs) * s[..., None]
              + b[..., None]).reshape(T, k, N, K)
        return torch.einsum("tknd,td->tkn", wd, x.float()).to(x.dtype)
    xf = x.float()
    sx = over_127(xf.abs().amax(-1)) + 1e-12               # [T]
    cx = torch.round(xf / sx[:, None]).reshape(T, G, gs)
    # |P| <= gs * 127 * 15 (4-bit) or gs * 127^2 (8-bit) < 2^24 for the
    # group sizes the kernels take: exact in float32
    P = torch.einsum("tkngc,tgc->tkng", c.reshape(T, k, N, G, gs), cx)
    xg = xf.reshape(T, G, gs).sum(-1).to(torch.bfloat16).float()
    y = (sx[:, None, None] * (s * P).sum(-1)
         + torch.einsum("tkng,tg->tkn", b, xg))
    return y.to(x.dtype)


def _k4(x: torch.Tensor, w: PackedQuantizedExperts, ids: torch.Tensor,
        up: Optional[PackedQuantizedExperts] = None):
    """Launch K4 (csrc/gather_qmm.cu) on the current stream: bf16 x [T, K],
    int32 ids [T, k] on CUDA -> bf16 [T, k, N], w4a8 or w8a8; with ``up``
    (a second stack of the same shape, bits and group size), (y, y_up)
    from one launch."""
    from ominix_mlx_tpu_torch.ops import _build

    T, K = x.shape
    E, N, _ = w.data.shape
    k = ids.shape[1] if ids.dim() == 2 else 0
    G = K // w.group_size
    dev = x.device
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"K4 takes contiguous bf16 x, got {x.dtype}")
    _check_ids("K4", ids, T, k, dev)
    if K != w.in_features or w.bits not in (4, 8) or w.act_bits != 8 \
            or K % 32 or w.group_size % 32:
        raise ValueError(f"K4 takes w4a8 or w8a8 experts with K and the "
                         f"group size multiples of 32; x has K={K}, experts "
                         f"are {w.bits}-bit, K={w.in_features}, act_bits="
                         f"{w.act_bits}, group {w.group_size}")
    _check_pair("K4", w, up, ("bits", "group_size", "in_features",
                              "act_bits"))
    stacks = (w,) if up is None else (w, up)
    dt, Kd = (torch.uint8, K // 2) if w.bits == 4 else (torch.int8, K)
    for ws in stacks:
        for name, t, want_dt, shp in (
                ("data", ws.data, dt, (E, N, Kd)),
                ("scales", ws.scales, torch.bfloat16, (E, N, G)),
                ("biases", ws.biases, torch.bfloat16, (E, N, G))):
            if t.device != dev or t.dtype != want_dt \
                    or tuple(t.shape) != shp or not t.is_contiguous():
                raise ValueError(f"K4 {name}: want contiguous {want_dt} "
                                 f"{shp} on {dev}, got {t.dtype} "
                                 f"{tuple(t.shape)} on {t.device}")
        _check_aligned("K4", ws.data, x)
    lanes, rows = gather_plan(K, w.bits)
    lib = _build.library()
    ys = [torch.empty(T, k, N, dtype=torch.bfloat16, device=dev)
          for _ in stacks]
    xq = torch.empty(T, K, dtype=torch.int8, device=dev)
    xg = torch.empty(T, G, dtype=torch.float32, device=dev)
    sx = torch.empty(T, dtype=torch.float32, device=dev)
    second = ((up.data, up.scales, up.biases, ys[1]) if up is not None
              else (None,) * 4)
    rc = lib.ominix_gather_qmm(
        x.data_ptr(), ids.data_ptr(), w.data.data_ptr(),
        w.scales.data_ptr(), w.biases.data_ptr(), ys[0].data_ptr(),
        *map(_ptr, second), xq.data_ptr(), xg.data_ptr(), sx.data_ptr(), T,
        k, E, N, K, w.group_size, w.bits, lanes, rows,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "K4 (ominix_gather_qmm)")
    _build.LAUNCHES["k4" if w.bits == 4 else "k4_w8"] += 1
    return ys[0] if up is None else tuple(ys)


def _on_k4(x: torch.Tensor, w: PackedQuantizedExperts) -> bool:
    """Whether gather_qmm launches K4 for x against w (a CUDA tensor, a8
    experts on ``expert_route`` "k4"); raises for x the kernel does not
    take."""
    if w.act_bits != 8 or expert_route(w, x.shape[0]) == "gathered" \
            or not x.is_cuda:
        return False
    if x.dtype != torch.bfloat16:
        raise ValueError(f"K4: {x.dtype} activations; the kernel takes bf16 "
                         f"and the JAX formula quantizes and sums x "
                         f"unrounded")
    return True


def gather_qmm(x: torch.Tensor, w: PackedQuantizedExperts,
               ids: torch.Tensor) -> torch.Tensor:
    """Per-row expert-gathered quantized matmul: x [T, K], ids [T, k] ->
    [T, k, N] in x's dtype. On ``expert_route`` "k4", experts with
    act_bits=8 take the TPU kernel's a8 formula: a CUDA tensor launches
    K4 (reading only the selected experts' rows), a CPU tensor takes
    ``gather_qmm_reference(act_bits=8)``. On "gathered", and for experts
    with act_bits=None, both devices compute the JAX package's exact
    fallback in plain PyTorch (XLA's product there too)."""
    if _on_k4(x, w):
        return _k4(_aligned(x.contiguous()), w, _ids32(ids))
    if w.act_bits != 8 or expert_route(w, x.shape[0]) == "gathered":
        return gather_qmm_reference(x, w, ids, None)
    return gather_qmm_reference(x, w, ids, 8)


def gather_qmm_gate_up(x: torch.Tensor, wg: PackedQuantizedExperts,
                       wu: PackedQuantizedExperts, ids: torch.Tensor
                       ) -> tuple:
    """A MoE layer's gate and up projections at decode, against the same x
    [T, K] and ids [T, k]: (gather_qmm(x, wg, ids), gather_qmm(x, wu,
    ids)). Where both launch K4 on stacks of one shape, bits and group
    size, one launch (one prologue, one rows kernel, both outputs, each
    bit-equal to its own call); else the two calls."""
    same = wg.data.shape == wu.data.shape and all(
        getattr(wg, f) == getattr(wu, f)
        for f in ("bits", "group_size", "in_features", "act_bits"))
    if same and _on_k4(x, wg) and _on_k4(x, wu):
        return _k4(_aligned(x.contiguous()), wg, _ids32(ids), wu)
    return gather_qmm(x, wg, ids), gather_qmm(x, wu, ids)
