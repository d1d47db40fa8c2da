"""Flash attention for a fresh prompt (counterpart of
ominix_mlx_tpu/ops/flash_attention.py, whose ``_flash`` calls the Pallas
TPU flash kernel).

Kernel K2 (``csrc/flash_attn.cu``) is a causal flash-attention forward with
native GQA that also returns the row log-sum-exp. A CPU tensor takes the
plain PyTorch version ``flash_prefill_reference``; a CUDA tensor launches
the kernel or raises.
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


def use_flash(T: int, head_dim: int, device: torch.device) -> bool:
    """K2 serves every fresh prefill on CUDA with T > 1 and a supported
    head dim. Off CUDA the dense masked ``sdpa`` runs, as in the JAX
    package off the TPU."""
    return device.type == "cuda" and T > 1 and head_dim in HEAD_DIMS
