"""Flash attention for a fresh prompt and for the continuation chunks of a
long prefill (counterpart of ominix_mlx_tpu/ops/flash_attention.py, whose
``_flash`` and ``_flash_chunk`` call the Pallas TPU flash kernel).

Kernel K2 (``csrc/flash_attn.cu``) is a causal flash-attention forward with
native GQA that also returns the row log-sum-exp. K2c is the same kernel
with the causal diagonal shifted by the chunk's start ``pos`` and strided
K/V, so a chunk attends the written prefix of the cache in place (the TPU
merges two library calls by LSE instead). A CPU tensor takes the plain
PyTorch versions ``flash_prefill_reference`` / ``flash_chunk_reference``;
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

HEAD_DIMS = (64, 128, 256)


def flash_prefill_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float):
    """Plain version of K2: causal attention of q [B, H, T, D] over
    k/v [B, Hkv, T, D] (query head h reads KV head h // (H / Hkv)).
    Returns (out [B, H, T, D] in q's dtype, lse [B, H, T] float32)."""
    B, H, T, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qg = q.float().reshape(B, Hkv, G, T, D)
    s = torch.einsum("bhgtd,bhsd->bhgts", qg, k.float()) * scale
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhgts,bhsd->bhgtd", p, v.float())
    return (out.reshape(B, H, T, D).to(q.dtype), lse.reshape(B, H, T))


def _k2(q, k, v, scale: float):
    from ominix_mlx_tpu_torch.ops import _build

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
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    lib = _build.library()
    out = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    rc = lib.ominix_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, Hkv, T, D, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "K2 (ominix_flash_fwd)")
    _build.LAUNCHES["k2"] += 1
    return out, lse


def flash_prefill_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float):
    """Causal self-attention over the fresh prompt tokens, and the row
    log-sum-exp of the scaled scores: (out [B, H, T, D], lse [B, H, T])."""
    if q.is_cuda:
        dt = q.dtype
        out, lse = _k2(q.to(torch.bfloat16).contiguous(),
                       k.to(torch.bfloat16).contiguous(),
                       v.to(torch.bfloat16).contiguous(), scale)
        return out.to(dt), lse
    return flash_prefill_reference(q, k, v, scale)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """q: [B, H, T, D]; k/v: [B, Hkv, T, D]. Valid only when the cache was
    empty before this call (query i attends keys 0..i)."""
    return flash_prefill_lse(q, k, v, scale)[0]


def use_flash(T: int, device: torch.device) -> bool:
    """K2 serves every fresh prefill of T > 1 tokens on CUDA; its wrapper
    raises for a head dim it does not take. Off CUDA the dense masked
    ``sdpa`` runs, as in the JAX package off the TPU."""
    return device.type == "cuda" and T > 1


# --------------------- continuation chunks (long-prompt chunked prefill) ----

def flash_chunk_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos: int, scale: float):
    """Plain version of K2c: queries q [B, H, T, D] at absolute positions
    pos..pos+T-1 over k/v [B, Hkv, pos+T, D] (the written prefix including
    this chunk); query t attends keys 0..pos+t. Returns (out [B, H, T, D]
    in q's dtype, lse [B, H, T] float32)."""
    B, H, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if S != pos + T:
        raise ValueError(f"k/v hold {S} positions, want pos + T = {pos + T}")
    qg = q.float().reshape(B, Hkv, H // Hkv, T, D)
    s = torch.einsum("bhgtd,bhsd->bhgts", qg, k.float()) * scale
    ok = (torch.arange(S, device=q.device)[None, :]
          <= pos + torch.arange(T, device=q.device)[:, None])
    s = s.masked_fill(~ok, float("-inf"))
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhgts,bhsd->bhgtd", p, v.float())
    return (out.reshape(B, H, T, D).to(q.dtype), lse.reshape(B, H, T))


def _k2c(q, k, v, pos: int, scale: float):
    """Launch K2c. q contiguous bf16 [B, H, T, D]; k/v bf16 [B, Hkv,
    pos+T, D] with unit stride along D (strided views of a larger cache
    are read in place)."""
    from ominix_mlx_tpu_torch.ops import _build

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
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    lib = _build.library()
    out = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    rc = lib.ominix_flash_chunk_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, Hkv, T, pos, D, *k.stride()[:3],
        *v.stride()[:3], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "K2c (ominix_flash_chunk_fwd)")
    _build.LAUNCHES["k2c"] += 1
    return out, lse


def flash_chunk_prefill_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, pos: int, scale: float):
    """Attention of a continuation chunk and its row log-sum-exp:
    (out [B, H, T, D], lse [B, H, T])."""
    if q.is_cuda:
        dt = q.dtype
        out, lse = _k2c(q.to(torch.bfloat16).contiguous(),
                        k.to(torch.bfloat16), v.to(torch.bfloat16), pos,
                        scale)
        return out.to(dt), lse
    return flash_chunk_reference(q, k, v, pos, scale)


def flash_chunk_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pos: int, scale: float) -> torch.Tensor:
    """Attention for a continuation chunk of a long prefill.

    q: [B, H, T, D] at global positions pos..pos+T-1; k/v: [B, Hkv, pos+T,
    D], the written cache prefix INCLUDING this chunk's keys (a view of the
    cache: K2c reads it in place). Any pos >= 0 and T >= 1: the TPU's
    alignment rules (pos % 128, T % 128, T >= 128) are gone."""
    return flash_chunk_prefill_lse(q, k, v, pos, scale)[0]
