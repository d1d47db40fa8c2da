"""Flash attention for a fresh prompt and for the continuation chunks of a
long prefill (counterpart of ominix_mlx_tpu/ops/flash_attention.py, whose
``_flash`` and ``_flash_chunk`` call the Pallas TPU flash kernel).

Kernel K2 (``csrc/flash_attn.cu``) is a causal flash-attention forward with
native GQA that also returns the row log-sum-exp. K2c is the same kernel
with the causal diagonal shifted by the chunk's start ``pos`` and strided
K/V, so a chunk attends the written prefix of the cache in place (the TPU
merges two library calls by LSE instead). Both take a sliding window
(``window`` > 0: query position p sees keys p - window < k <= p), the
masked ``sdpa`` the JAX package computes for a sliding-window model with
``causal_mask(..., window)``; window 0 is none. A CPU tensor takes the
plain PyTorch versions ``flash_prefill_reference`` /
``flash_chunk_reference``; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

HEAD_DIMS = (64, 128, 256)


def scaled_queries(q: torch.Tensor, scale: float) -> torch.Tensor:
    """q * scale as the JAX package hands it to the TPU flash kernel
    (ops/flash_attention.py:65, :124): the scale rounded to q's dtype, the
    product rounded to q's dtype (exact for float32 q), as float32."""
    s = torch.tensor(scale, dtype=q.dtype).float()
    return (q.float() * s).to(q.dtype).float()


def kernel_scale(scale: float) -> float:
    """The scale as K2/K2c take it: rounded to bf16, so that the kernel's
    bf16(q * scale) is the one ``scaled_queries`` computes."""
    return float(torch.tensor(scale, dtype=torch.bfloat16))


def visible(q_pos: torch.Tensor, k_pos: torch.Tensor,
            window: int) -> torch.Tensor:
    """[Tq, Tk] bool: key position k_pos[j] is visible to query position
    q_pos[i] (k <= q, and q - window < k with a window > 0): the
    ``causal_mask`` of the JAX package as a boolean."""
    ok = k_pos[None, :] <= q_pos[:, None]
    if window:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return ok


def _check_window(window: int):
    if window < 0:
        raise ValueError(f"window {window}: want 0 (none) or a positive "
                         f"number of keys")


def flash_prefill_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float, window: int = 0):
    """Plain version of K2: causal attention of q [B, H, T, D] over
    k/v [B, Hkv, T, D] (query head h reads KV head h // (H / Hkv)), within
    the last ``window`` keys of each query where window > 0.
    q is scaled as ``scaled_queries`` does, as the TPU kernel is fed; the
    softmax weights stay float32 (the TPU kernel and K2 round them to
    bf16 per key block, which no dense version reproduces).
    Returns (out [B, H, T, D] in q's dtype, lse [B, H, T] float32)."""
    _check_window(window)
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qg = scaled_queries(q, scale).reshape(B, Hkv, G, T, D)
    s = torch.einsum("bhgtd,bhsd->bhgts", qg, k.float())
    t = torch.arange(T, device=q.device)
    s = s.masked_fill(~visible(t, t, window), float("-inf"))
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhgts,bhsd->bhgtd", p, v.float())
    return (out.reshape(B, H, T, D).to(q.dtype), lse.reshape(B, H, T))


def _check_copyable(what: str, name: str, t: torch.Tensor):
    """The kernel copies rows with TMA: the base and the stride of every
    dimension but D (of more than one element) must be 16-byte multiples
    (8 bf16). Raises rather than copy."""
    if t.data_ptr() % 16 or t.stride(-1) != 1 or any(
            st % 8 for st, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1):
        raise ValueError(f"{what} {name}: want a 16-byte aligned base and "
                         f"strides that are multiples of 8 elements with "
                         f"unit stride along D, got strides {t.stride()} "
                         f"at address {t.data_ptr():#x}")


def _k2(q, k, v, scale: float, window: int = 0):
    from ominix_mlx_tpu_torch.ops import _build

    _check_window(window)
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"K2 {name}: want contiguous bf16 on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    if tuple(k.shape) != (B, Hkv, T, D) or tuple(v.shape) != (B, Hkv, T, D) \
            or Hkv == 0 or H % Hkv or D not in HEAD_DIMS:
        raise ValueError(f"K2 shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; head dim "
                         f"must be one of {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_copyable("K2", name, t)
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    lib = _build.library()
    out = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    rc = lib.ominix_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, Hkv, T, D, window, kernel_scale(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "K2 (ominix_flash_fwd)")
    _build.LAUNCHES["k2"] += 1
    if window:
        _build.LAUNCHES["k2_window"] += 1
    return out, lse


def flash_prefill_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float, window: int = 0):
    """Causal self-attention over the fresh prompt tokens (within the
    last ``window`` keys where window > 0), and the row log-sum-exp of the
    scaled scores: (out [B, H, T, D], lse [B, H, T])."""
    _check_window(window)
    if q.is_cuda:
        dt = q.dtype
        out, lse = _k2(q.to(torch.bfloat16).contiguous(),
                       k.to(torch.bfloat16).contiguous(),
                       v.to(torch.bfloat16).contiguous(), scale, window)
        return out.to(dt), lse
    return flash_prefill_reference(q, k, v, scale, window)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, window: int = 0) -> torch.Tensor:
    """q: [B, H, T, D]; k/v: [B, Hkv, T, D]. Valid only when the cache was
    empty before this call (query i attends keys 0..i, or i - window + 1..i
    with a window > 0)."""
    return flash_prefill_lse(q, k, v, scale, window)[0]


def use_flash(T: int, device: torch.device) -> bool:
    """K2 serves every fresh prefill of T > 1 tokens on CUDA; its wrapper
    raises for a head dim it does not take. Off CUDA the dense masked
    ``sdpa`` runs, as in the JAX package off the TPU."""
    return device.type == "cuda" and T > 1


# --------------------- continuation chunks (long-prompt chunked prefill) ----

def flash_chunk_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos: int, scale: float, window: int = 0):
    """Plain version of K2c: queries q [B, H, T, D] at absolute positions
    pos..pos+T-1 over k/v [B, Hkv, pos+T, D] (the written prefix including
    this chunk); query t attends keys 0..pos+t (pos+t-window+1..pos+t with
    a window > 0); q scaled as in ``flash_prefill_reference``. Returns
    (out [B, H, T, D] in q's dtype, lse [B, H, T] float32)."""
    _check_window(window)
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if S != pos + T:
        raise ValueError(f"k/v hold {S} positions, want pos + T = {pos + T}")
    qg = scaled_queries(q, scale).reshape(B, Hkv, H // Hkv, T, D)
    s = torch.einsum("bhgtd,bhsd->bhgts", qg, k.float())
    ok = visible(pos + torch.arange(T, device=q.device),
                 torch.arange(S, device=q.device), window)
    s = s.masked_fill(~ok, float("-inf"))
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhgts,bhsd->bhgtd", p, v.float())
    return (out.reshape(B, H, T, D).to(q.dtype), lse.reshape(B, H, T))


def _k2c(q, k, v, pos: int, scale: float, window: int = 0):
    """Launch K2c. q contiguous bf16 [B, H, T, D]; k/v bf16 [B, Hkv,
    pos+T, D] with unit stride along D, a 16-byte aligned base and the
    other strides multiples of 8 elements (strided views of a larger cache
    are read in place; any other view raises). With a window > 0 the
    kernel reads no key tile below the first one a chunk row sees."""
    from ominix_mlx_tpu_torch.ops import _build

    _check_window(window)
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError(f"K2c q: want contiguous bf16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device \
                or t.stride(3) != 1:
            raise ValueError(f"K2c {name}: want bf16 on {q.device} with unit "
                             f"stride along D, got {t.dtype} on {t.device} "
                             f"strides {t.stride()}")
    if tuple(k.shape) != (B, Hkv, pos + T, D) or k.shape != v.shape \
            or Hkv == 0 or H % Hkv or D not in HEAD_DIMS or pos < 0 or T < 1:
        raise ValueError(f"K2c shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, pos {pos}; "
                         f"head dim must be one of {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_copyable("K2c", name, t)
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    lib = _build.library()
    out = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    rc = lib.ominix_flash_chunk_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, Hkv, T, pos, D, *k.stride()[:3],
        *v.stride()[:3], window, kernel_scale(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "K2c (ominix_flash_chunk_fwd)")
    _build.LAUNCHES["k2c"] += 1
    if window:
        _build.LAUNCHES["k2c_window"] += 1
    return out, lse


def flash_chunk_prefill_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, pos: int, scale: float,
                            window: int = 0):
    """Attention of a continuation chunk and its row log-sum-exp:
    (out [B, H, T, D], lse [B, H, T])."""
    _check_window(window)
    if q.is_cuda:
        dt = q.dtype
        out, lse = _k2c(q.to(torch.bfloat16).contiguous(),
                        k.to(torch.bfloat16), v.to(torch.bfloat16), pos,
                        scale, window)
        return out.to(dt), lse
    return flash_chunk_reference(q, k, v, pos, scale, window)


def flash_chunk_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pos: int, scale: float,
                        window: int = 0) -> torch.Tensor:
    """Attention for a continuation chunk of a long prefill.

    q: [B, H, T, D] at global positions pos..pos+T-1; k/v: [B, Hkv, pos+T,
    D], the written cache prefix INCLUDING this chunk's keys (a view of the
    cache: K2c reads it in place). Any pos >= 0 and T >= 1: the TPU's
    alignment rules (pos % 128, T % 128, T >= 128) are gone. ``window``:
    as in ``flash_prefill``."""
    return flash_chunk_prefill_lse(q, k, v, pos, scale, window)[0]
