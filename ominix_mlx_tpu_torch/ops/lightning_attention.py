"""Lightning attention: the linear attention of MiniCPM-SALA's
"lightning-attn" layers (``models.lightning``), over T tokens from a
carried state, with a scalar ALiBi decay per head:

    S_t = lambda_h S_{t-1} + k_t v_t^T        (lambda_h = exp(slope_h))
    o_t = q_t^T S_t

No TPU kernel computes it: the JAX package writes one einsum step for
decode (ominix_mlx_tpu/models/lightning.py:75-83) and a ``lax.scan`` over
chunks of 64 tokens for prompts (:86-119), which XLA compiles. Here a
CUDA tensor launches kernel K10 (``csrc/lightning_attn.cu``) or raises; a
CPU tensor takes the plain version ``lightning_reference``, the JAX
package's two functions (one step at T = 1, the chunked form otherwise).

K10 has two forms, which ``k10_plan`` picks from the shapes alone: the
recurrent form (counter ``k10``; the loop over T inside one launch; short
prompts) and the chunked form (counter ``k10_chunk``; one launch that
walks the chunks with the state on chip; prompts at D = 128). q, k and v
are [B, H, T, D] bf16 or float32 (any strides with a unit stride along
D); the state [B, H, D, D] float32 is written in place; the output o is
[B, H, T, D] float32.

A lightning layer's decode step (T = 1) takes ``lightning_decode``: its
whole mixer between the projections and o_proj (QK-norm, RoPE, the scale,
the state step, the output norm and the gate; ominix_mlx_tpu/models/
minicpm_sala.py:158-184), one launch of ``lightning_decode`` in
``csrc/lightning_attn.cu`` on CUDA (counter ``k10_decode``), the plain
composition ``lightning_decode_reference`` on the CPU.
"""

from __future__ import annotations

import math
import threading
from typing import Optional

import numpy as np
import torch

from ominix_mlx_tpu_torch.core.rope import apply_rope, make_rope, positions_of
from ominix_mlx_tpu_torch.ops.quant_matmul import rms_norm

# the head width both forms are built for (MiniCPM-SALA's)
K10_DIMS = (128,)
K10_MAX_GRID = 65535
# The chunked form: tokens a chunk, and the prompt length from which
# k10_plan takes it. Below it the recurrent form is faster: it costs about
# 1 us a token from 7.7 us at one, the one-launch chunked form about 9.3
# us up to 24 tokens, and they meet between 2 and 3 tokens (chip_smoke.py's
# k10_crossover lines, NVIDIA H100 80GB HBM3 at 700.00 W, MiniCPM-SALA's
# 32 heads of 128, B = 1: 8.5 against 9.3 us at 2 tokens, 9.6 against 9.3
# at 3, 10.5 against 9.3 at 4; PERF.md section 6).
K10_CHUNK = 64
K10_CHUNK_MIN_T = 3


def k10_plan(B: int, T: int, H: int, D: int) -> str:
    """The form of K10 for these shapes: "chunked" for prompts of at least
    K10_CHUNK_MIN_T tokens at the head width it is built for, else
    "recurrent". Reads shapes only."""
    if D in K10_DIMS and T >= K10_CHUNK_MIN_T:
        return "chunked"
    return "recurrent"


def k10_launches(B: int, T: int, H: int, D: int) -> dict:
    """The launch counts ({counter: n}) of one call on CUDA at these
    shapes."""
    if k10_plan(B, T, H, D) == "chunked":
        return {"k10_chunk": 1}
    return {"k10": 1}


def decay_step_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         slopes: torch.Tensor,
                         state: torch.Tensor) -> torch.Tensor:
    """One token (T = 1), the JAX ``gla_decode_step``: state = exp(slope)
    * state + k^T v; o = q state, in float32. The state is written in
    place."""
    decay = torch.exp(slopes.float())[None, :, None, None]
    kv = torch.einsum("bhtd,bhte->bhde", k.float(), v.float())
    new = state * decay + kv
    out = torch.einsum("bhtd,bhde->bhte", q.float(), new)
    state.copy_(new)
    return out


def chunked_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      slopes: torch.Tensor, state: torch.Tensor,
                      chunk: int = K10_CHUNK) -> torch.Tensor:
    """The JAX ``gla_chunked`` in float32, per chunk of ``chunk`` tokens
    (the last may be shorter: its decays are those of its own length,
    where the JAX package zero-pads it and scales the state back; the same
    function): with n the chunk's length and S the state at its start,
    O = (Q K^T * M) V + (Q * lambda^(i+1)) S, M_ij = lambda^(i-j) for
    j <= i; S <- lambda^n S + (K * lambda^(n-1-j))^T V. The state is
    written in place."""
    s = slopes.double()[:, None]                              # [H, 1]
    S = state.float()
    outs = []
    for t0 in range(0, q.shape[2], chunk):
        Q = q[:, :, t0:t0 + chunk].float()
        K = k[:, :, t0:t0 + chunk].float()
        V = v[:, :, t0:t0 + chunk].float()
        n = Q.shape[2]
        i = torch.arange(n, dtype=torch.float64, device=q.device)
        diff = i[:, None] - i[None, :]
        intra = torch.where(diff >= 0, torch.exp(s[..., None] * diff),
                            torch.zeros((), dtype=torch.float64,
                                        device=q.device)).float()
        q_dec = torch.exp(s * (i + 1)).float()[None, :, :, None]
        rev = torch.exp(s * (n - 1 - i)).float()[None, :, :, None]
        blk = torch.exp(s[:, 0] * n).float()[None, :, None, None]
        attn = (Q @ K.transpose(-1, -2)) * intra
        outs.append(attn @ V + (Q * q_dec) @ S)
        S = S * blk + (K * rev).transpose(-1, -2) @ V
    state.copy_(S)
    return torch.cat(outs, 2)


def lightning_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        slopes: torch.Tensor,
                        state: torch.Tensor) -> torch.Tensor:
    """Plain version of K10, both forms: the JAX package's one step at
    T = 1, its chunked form otherwise. q, k, v [B, H, T, D]; slopes [H]
    (negative); state [B, H, D, D] float32, written in place. Returns o
    [B, H, T, D] float32."""
    if q.shape[2] == 1:
        return decay_step_reference(q, k, v, slopes, state)
    return chunked_reference(q, k, v, slopes, state)


def _strides(t: torch.Tensor):
    return t.stride(0), t.stride(1), t.stride(2)


def _check(q, k, v, slopes, state):
    """(B, H, T, D, input dtype) of K10's arguments; raises for what the
    kernel does not take."""
    B, H, T, D = q.shape
    dev, dt = q.device, q.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K10 takes bf16 or float32 q, k, v; got {dt}")
    align = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != dt or tuple(t.shape) != (B, H, T, D) \
                or t.device != dev or t.stride(3) != 1 \
                or any(s % align for s in _strides(t)) or t.data_ptr() % 16:
            raise ValueError(
                f"K10 {name}: want {dt} {(B, H, T, D)} on {dev} with unit "
                f"stride along D, the other strides multiples of {align} "
                f"and a 16-byte aligned base; got {t.dtype} "
                f"{tuple(t.shape)} strides {t.stride()} on {t.device}")
    if slopes.dtype != torch.float32 or tuple(slopes.shape) != (H,) \
            or slopes.device != dev or not slopes.is_contiguous():
        raise ValueError(f"K10 slopes: want contiguous float32 ({H},) on "
                         f"{dev}")
    if state.dtype != torch.float32 or tuple(state.shape) != (B, H, D, D) \
            or state.device != dev or not state.is_contiguous():
        raise ValueError(f"K10 state: want contiguous float32 "
                         f"{(B, H, D, D)} on {dev}, got {state.dtype} "
                         f"{tuple(state.shape)}")
    if D not in K10_DIMS or T < 1 or B > K10_MAX_GRID or H > K10_MAX_GRID:
        raise ValueError(f"K10 takes D in {K10_DIMS}, T >= 1 and B, H <= "
                         f"{K10_MAX_GRID}; got D={D}, T={T}, B={B}, H={H}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"q is on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return B, H, T, D, dt


def _k10(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         slopes: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Launch K10's recurrent form on the current stream; raises for what
    it does not take."""
    from ominix_mlx_tpu_torch.ops import _build

    B, H, T, D, dt = _check(q, k, v, slopes, state)
    o = torch.empty(B, H, T, D, dtype=torch.float32, device=q.device)
    rc = _build.library().ominix_lightning(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(),
        state.data_ptr(), o.data_ptr(), B, H, T, D,
        int(dt == torch.bfloat16), *_strides(q), *_strides(k), *_strides(v),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "K10 (ominix_lightning)")
    _build.LAUNCHES["k10"] += 1
    return o


def _k10_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 slopes: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Launch K10's chunked form on the current stream: one launch, the
    chunks walked in order with the state on chip; raises for what it does
    not take."""
    from ominix_mlx_tpu_torch.ops import _build

    B, H, T, D, dt = _check(q, k, v, slopes, state)
    dev = q.device
    o = torch.empty(B, H, T, D, dtype=torch.float32, device=dev)
    rc = _build.library().ominix_lightning_chunked(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), slopes.data_ptr(),
        state.data_ptr(), o.data_ptr(), B, H, T, D,
        int(dt == torch.bfloat16), *_strides(q), *_strides(k), *_strides(v),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "K10 chunked (ominix_lightning_chunked)")
    _build.LAUNCHES["k10_chunk"] += 1
    return o


def _k10_rule(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              slopes: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """K10 on CUDA in the form ``k10_plan`` picks."""
    B, H, T, D = q.shape
    if k10_plan(B, T, H, D) == "chunked":
        return _k10_chunked(q, k, v, slopes, state)
    return _k10(q, k, v, slopes, state)


def lightning_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        slopes: torch.Tensor,
                        state: torch.Tensor) -> torch.Tensor:
    """o [B, H, T, D] float32, ``state`` [B, H, D, D] float32 advanced in
    place. A CUDA tensor launches K10 in the planned form (or raises); a
    CPU tensor takes ``lightning_reference``."""
    if not q.is_cuda:
        return lightning_reference(q, k, v, slopes, state)
    return _k10_rule(q, k, v, slopes, state)


def k10_macs(T: int, D: int, chunk: int = K10_CHUNK) -> int:
    """Multiply-adds of the chunked form for one (row, head) over T
    tokens: per chunk of n tokens Q K^T and (.)V (n^2 D each), K^T V and
    Q S (n D^2 each)."""
    full, last = divmod(T, chunk)
    return sum(2 * n * n * D + 2 * n * D * D
               for n in [chunk] * full + ([last] if last else []))



# ------------------------------------------------------------ decode mixer

K10_DECODE_MAX_WIDTH = 4096   # H * D of the output row (csrc kDecMaxRow)


def norm_rope(q: torch.Tensor, k: torch.Tensor, q_norm, k_norm, eps: float,
              rope_theta: Optional[float], offset):
    """QK-RMSNorm where ``q_norm`` and ``k_norm`` are given, then RoPE at
    ``offset`` (an int, or per-row [B]) where ``rope_theta`` is given:
    q, k [B, H, T, D] (MiniCPM-SALA's, ominix_mlx_tpu/models/
    minicpm_sala.py:130-138 and :164-172)."""
    if q_norm is not None:
        q = rms_norm(q_norm, q, eps)
        k = rms_norm(k_norm, k, eps)
    if rope_theta is not None:
        rc = make_rope(q.shape[-1], rope_theta)
        pos = positions_of(offset, q.shape[2], q.device)
        q = apply_rope(q, pos, rc)
        k = apply_rope(k, pos, rc)
    return q, k


def lightning_decode_reference(q, k, v, slopes, state, z=None, q_norm=None,
                               k_norm=None, o_norm=None, eps: float = 1e-6,
                               rope_theta: Optional[float] = None,
                               offset=0, qk_out=None) -> torch.Tensor:
    """Plain version of ``k10_decode``: one lightning layer's decode mixer
    as the model composes it (ominix_mlx_tpu/models/minicpm_sala.py:
    158-184 at T = 1). q, k, v [B, H, 1, D] (views of the projections); z
    [B, 1, H D] (the gate's input, z_proj(x)) or None; q_norm, k_norm [D]
    or None; o_norm [H D] or None; RoPE where ``rope_theta`` is given, at
    ``offset`` (an int or per-row [B]); ``state`` [B, H, D, D] float32
    advanced in place. Returns [B, 1, H D] in v's type. ``qk_out``, where
    given ([B, 2, H D]), receives q and k as the state step reads them."""
    B, H, T, D = q.shape
    q, k = norm_rope(q, k, q_norm, k_norm, eps, rope_theta, offset)
    q = q * D ** -0.5
    if qk_out is not None:
        qk_out.copy_(torch.stack([q, k], 1).reshape(B, 2, H * D))
    out = decay_step_reference(q, k, v, slopes, state)
    out = out.transpose(1, 2).reshape(B, T, H * D).to(v.dtype)
    if o_norm is not None:
        out = rms_norm(o_norm, out, eps)
    if z is not None:
        out = out * torch.sigmoid(z)
    return out


def reduce_width(rows: int, n: int) -> int:
    """The x-width (threads along the reduced dimension) of the block
    PyTorch's CUDA reduction takes for the mean over n of a contiguous
    float32 [rows, n] (ATen/native/cuda/Reduce.cuh setReduceConfig: the
    input read as 4-vectors, at most 512 threads a block, the outputs
    filling the rest). ``k10_decode`` sums the output norm's squares in
    the order this block does."""
    def pow2_floor(x):
        return 1 << (x.bit_length() - 1)

    dim0 = n // 4
    d0 = pow2_floor(dim0) if dim0 < 512 else 512
    d1 = pow2_floor(rows) if rows < 512 else 512
    bh = min(d1, 512 // min(d0, 32))
    return min(d0, 512 // bh)


# per device index: k10_decode's tickets (one a row, zero between calls)
# and gates (a row's sigmoid(z), which each CTA writes for its columns and
# the row's last one reads); an outgrown buffer stays referenced, since a
# CUDA graph captured over it writes it on replay
_K10_BUFFERS: dict = {}
_K10_RETIRED: list = []
_K10_LOCK = threading.Lock()


def _k10_buffers(dev: torch.device, rows: int, width: int):
    """(tickets, gates) of k10_decode for ``rows`` rows of ``width``
    values, allocated once per device and grown to at least twice their
    size when a call needs more."""
    with _K10_LOCK:
        tickets, gates = _K10_BUFFERS.get(dev.index, (None, None))
        if tickets is None or tickets.numel() < rows:
            _K10_RETIRED.append(tickets)
            tickets = torch.zeros(max(rows, 0 if tickets is None
                                      else 2 * tickets.numel()),
                                  dtype=torch.int32, device=dev)
        if gates is None or gates.numel() < rows * width:
            _K10_RETIRED.append(gates)
            gates = torch.empty(max(rows * width, 0 if gates is None
                                    else 2 * gates.numel()),
                                dtype=torch.bfloat16, device=dev)
        _K10_BUFFERS[dev.index] = (tickets, gates)
        return tickets, gates


def _bf16_vector(what, name, t, n, dev):
    if t.dtype != torch.bfloat16 or tuple(t.shape) != (n,) \
            or t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what} {name}: want contiguous bf16 ({n},) on "
                         f"{dev} with a 16-byte aligned base, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _k10_decode(q, k, v, slopes, state, z=None, q_norm=None, k_norm=None,
                o_norm=None, eps: float = 1e-6,
                rope_theta: Optional[float] = None, offset=0,
                qk_out=None, overlap: bool = False) -> torch.Tensor:
    """Launch ``k10_decode`` on the current stream; raises for what it does
    not take. ``overlap``: launch by programmatic dependent launch, the
    state read before the kernels ahead of it on the stream end (the
    model's call: only its projections are ahead of it); the kernel just
    before must then not write the state."""
    from ominix_mlx_tpu_torch.ops import _build

    what = "k10_decode"
    B, H, T, D = q.shape
    dev = q.device
    N = H * D
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != (B, H, 1, D) \
                or t.device != dev or t.stride(3) != 1 \
                or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
            raise ValueError(
                f"{what} {name}: want bf16 {(B, H, 1, D)} on {dev} with unit "
                f"stride along D, row and head strides multiples of 8 and a "
                f"16-byte aligned base; got {t.dtype} {tuple(t.shape)} "
                f"strides {t.stride()} on {t.device}")
    if D != K10_DIMS[0] or N > K10_DECODE_MAX_WIDTH or B > K10_MAX_GRID:
        raise ValueError(f"{what} takes D = {K10_DIMS[0]}, H D <= "
                         f"{K10_DECODE_MAX_WIDTH} and B <= {K10_MAX_GRID}; "
                         f"got D={D}, H={H}, B={B}")
    if z is not None and (z.dtype != torch.bfloat16
                          or tuple(z.shape) != (B, 1, N) or z.device != dev
                          or z.stride(2) != 1 or z.stride(0) % 8
                          or z.data_ptr() % 16):
        raise ValueError(f"{what} z: want bf16 {(B, 1, N)} on {dev} with unit "
                         f"stride along the width, the row stride a multiple "
                         f"of 8 and a 16-byte aligned base; got {z.dtype} "
                         f"{tuple(z.shape)} strides {z.stride()}")
    if (q_norm is None) != (k_norm is None):
        raise ValueError(f"{what}: q_norm and k_norm come together")
    for name, t, n in (("q_norm", q_norm, D), ("k_norm", k_norm, D),
                       ("o_norm", o_norm, N)):
        if t is not None:
            _bf16_vector(what, name, t, n, dev)
    if slopes.dtype != torch.float32 or tuple(slopes.shape) != (H,) \
            or slopes.device != dev or not slopes.is_contiguous():
        raise ValueError(f"{what} slopes: want contiguous float32 ({H},) on "
                         f"{dev}")
    if state.dtype != torch.float32 or tuple(state.shape) != (B, H, D, D) \
            or state.device != dev or not state.is_contiguous():
        raise ValueError(f"{what} state: want contiguous float32 "
                         f"{(B, H, D, D)} on {dev}, got {state.dtype} "
                         f"{tuple(state.shape)}")
    offsets, pos0 = None, 0
    if isinstance(offset, torch.Tensor):
        if offset.dtype != torch.int64 or tuple(offset.shape) != (B,) \
                or offset.device != dev or not offset.is_contiguous():
            raise ValueError(f"{what} offset: want an int or contiguous int64 "
                             f"({B},) on {dev}, got {offset.dtype} "
                             f"{tuple(offset.shape)} on {offset.device}")
        offsets = offset
    else:
        pos0 = int(offset)
    if qk_out is not None:
        _bf16_vector(what, "qk_out", qk_out.reshape(-1), B * 2 * N, dev)
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"q is on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    out = torch.empty(B, 1, N, dtype=torch.bfloat16, device=dev)
    tickets = gates = None
    if o_norm is not None:
        tickets, gates = _k10_buffers(dev, B, N)
    rope = rope_theta is not None

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = _build.library().ominix_lightning_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), v.stride(0), v.stride(1), ptr(z),
        0 if z is None else z.stride(0), ptr(q_norm), ptr(k_norm),
        ptr(o_norm), eps, int(rope),
        math.log(rope_theta) / (D // 2) if rope else 0.0, D ** -0.5,
        float(np.float32(B) / np.float32(B * N)), pos0, ptr(offsets),
        slopes.data_ptr(), state.data_ptr(), out.data_ptr(), ptr(qk_out),
        ptr(tickets), ptr(gates), B, H, D, reduce_width(B, N), int(overlap),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "k10_decode (ominix_lightning_decode)")
    _build.LAUNCHES["k10_decode"] += 1
    return out


def lightning_decode(q, k, v, slopes, state, z=None, q_norm=None,
                     k_norm=None, o_norm=None, eps: float = 1e-6,
                     rope_theta: Optional[float] = None, offset=0,
                     overlap: bool = False) -> torch.Tensor:
    """One lightning layer's decode mixer, [B, 1, H D] (the input of
    o_proj), the state advanced in place: ``k10_decode`` on CUDA (or it
    raises), ``lightning_decode_reference`` on the CPU. Arguments as the
    plain version's; ``overlap`` as ``_k10_decode``'s."""
    if not q.is_cuda:
        return lightning_decode_reference(q, k, v, slopes, state, z, q_norm,
                                          k_norm, o_norm, eps, rope_theta,
                                          offset)
    return _k10_decode(q, k, v, slopes, state, z, q_norm, k_norm, o_norm,
                       eps, rope_theta, offset, overlap=overlap)
