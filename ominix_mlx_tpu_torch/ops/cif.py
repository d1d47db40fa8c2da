"""CIF: Paraformer's continuous integrate-and-fire (counterpart of
``cif`` in ominix_mlx_tpu/models/paraformer.py:110-155).

Per row, a scalar ``integrate`` sums the alphas frame by frame in
float32; each time it reaches the threshold the frame accumulated so far
(the hidden states weighted by their alphas, the firing frame by the part
that completes it) fires as one token's embedding, and the remainder
starts the next. After the last frame, what is left fires where its
weight passes the tail threshold.

No TPU kernel computes it: the JAX package runs the loop as a
``jax.lax.scan``, which XLA compiles. Here a CUDA tensor launches kernel
K12 (``csrc/cif.cu``; counter ``k12``) or raises; a CPU tensor takes the
plain version ``cif_reference``, the loop over the frames in torch,
vectorised over rows and columns, with no host sync. Both return frames
float32 [B, N, D] (N = max_tokens, default T; writes past N - 1 land on
row N - 1, as ``jax.lax.dynamic_update_slice`` clamps; rows from the
count on are zero) and counts int32 [B]. K12's frames and counts are
bit for bit the plain version's (card test).
"""

from __future__ import annotations

from typing import Optional

import torch

K12_MAX_T = 16384          # the kernel keeps 9 bytes a frame in shared memory
K12_MAX_ROWS = 65535


def cif_reference(hidden: torch.Tensor, alphas: torch.Tensor,
                  threshold: float = 1.0, tail_threshold: float = 0.45,
                  max_tokens: Optional[int] = None):
    """Plain version of K12: the JAX scan's step over the frames, in
    float32, products and sums as separate operations."""
    B, T, D = hidden.shape
    N = T if max_tokens is None else max_tokens
    dev = hidden.device
    h = hidden.float()
    a = alphas.float()
    rows = torch.arange(B, device=dev)
    integrate = torch.zeros(B, dtype=torch.float32, device=dev)
    frame = torch.zeros(B, D, dtype=torch.float32, device=dev)
    idx = torch.zeros(B, dtype=torch.long, device=dev)
    buf = torch.zeros(B, N, D, dtype=torch.float32, device=dev)

    def write(where, value):
        at = idx.clamp(max=N - 1)
        buf[rows, at] = torch.where(where[:, None], value, buf[rows, at])

    for t in range(T):
        h_t, a_t = h[:, t], a[:, t]
        completion = 1.0 - integrate
        integrate = integrate + a_t
        fire = integrate >= threshold
        integrate = torch.where(fire, integrate - 1.0, integrate)
        cur = torch.where(fire, completion, a_t)
        rem = a_t - cur
        frame = frame + cur[:, None] * h_t
        write(fire, frame)
        frame = torch.where(fire[:, None], rem[:, None] * h_t, frame)
        idx = idx + fire.long()
    tail = integrate > tail_threshold
    write(tail, frame)
    idx = idx + tail.long()
    return buf, idx.int()


def _k12(hidden: torch.Tensor, alphas: torch.Tensor, threshold: float,
         tail_threshold: float, N: int):
    """Launch K12 on the current stream; raises for what it does not
    take."""
    from ominix_mlx_tpu_torch.ops import _build

    if hidden.dim() != 3:
        raise ValueError(f"K12 hidden: want [B, T, D], got "
                         f"{tuple(hidden.shape)}")
    B, T, D = hidden.shape
    dev = hidden.device
    for name, t, shape in (("hidden", hidden, (B, T, D)),
                           ("alphas", alphas, (B, T))):
        if t.dtype not in (torch.bfloat16, torch.float32) \
                or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(f"K12 {name}: want contiguous bf16 or float32 "
                             f"{shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not (1 <= T <= K12_MAX_T and 1 <= B <= K12_MAX_ROWS and N >= 1):
        raise ValueError(f"K12 takes 1 <= T <= {K12_MAX_T}, 1 <= B <= "
                         f"{K12_MAX_ROWS} and N >= 1; got T={T}, B={B}, "
                         f"N={N}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"hidden is on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    frames = torch.empty(B, N, D, dtype=torch.float32, device=dev)
    counts = torch.empty(B, dtype=torch.int32, device=dev)
    rc = _build.library().ominix_cif(
        hidden.data_ptr(), alphas.data_ptr(), frames.data_ptr(),
        counts.data_ptr(), B, T, D, N, int(hidden.dtype == torch.bfloat16),
        int(alphas.dtype == torch.bfloat16), float(threshold),
        float(tail_threshold), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "K12 (ominix_cif)")
    _build.LAUNCHES["k12"] += 1
    return frames, counts


def cif(hidden: torch.Tensor, alphas: torch.Tensor, threshold: float = 1.0,
        tail_threshold: float = 0.45, max_tokens: Optional[int] = None):
    """hidden [B, T, D], alphas [B, T] -> (frames float32 [B, N, D],
    counts int32 [B]), N = max_tokens (default T). A CUDA tensor launches
    K12 (or raises); a CPU tensor takes ``cif_reference``."""
    if not hidden.is_cuda:
        return cif_reference(hidden, alphas, threshold, tail_threshold,
                             max_tokens)
    N = hidden.shape[1] if max_tokens is None else max_tokens
    return _k12(hidden, alphas, threshold, tail_threshold, N)


def k12_bytes(B: int, T: int, D: int, N: int, h_bytes: int = 2,
              a_bytes: int = 2) -> int:
    """Bytes K12 must move: hidden and alphas read once, the frames and
    counts written once."""
    return B * T * D * h_bytes + B * T * a_bytes + B * N * D * 4 + B * 4
