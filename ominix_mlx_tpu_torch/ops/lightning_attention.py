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
recurrent form (counter ``k10``; the loop over T inside one launch; decode
and short prompts) and the chunked form (counter ``k10_chunk``; one launch
that walks the chunks with the state on chip; prompts at D = 128). q, k
and v are [B, H, T, D] bf16 or float32 (any strides with a unit stride
along D); the state [B, H, D, D] float32 is written in place; the output
o is [B, H, T, D] float32.
"""

from __future__ import annotations

import torch

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

