"""Paged decode attention (counterpart of ominix_mlx_tpu/ops/paged_attention.py,
whose ``_pa_kernel`` is a hand-pipelined Pallas TPU kernel).

Kernel K3 (``csrc/paged_attn.cu``) attends one query token per row over the
pages its table maps, in one pass over K and V, with bf16 pages or int8
pages and per-token scales, and an optional sliding window. It splits each
row's pages into runs (``k3_plan``, from shapes alone: no host read of the
lengths) that CTAs take in parallel, and merges a row's partial softmaxes
in split order. The plain
version ``paged_decode_reference`` is the JAX package's default path: the
gathered page view plus masked ``sdpa``. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. On the TPU the
kernel is off by default (XLA over the gathered view won on v5e); the port
carries no switch, and on the card its paged decode always runs K3.

Pool layout: ``core/paged_cache.py`` (k and v both [P, n_kv, ps, D]).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ominix_mlx_tpu_torch.core.attention import NEG_INF, sdpa
from ominix_mlx_tpu_torch.core.paged_cache import gather_pages
from ominix_mlx_tpu_torch.ops._build import SMS

HEAD_DIMS = (64, 128, 256)
# K3's plan (csrc/paged_attn.cu): a CTA streams 64-key tiles of one split;
# a split holds at least K3_MIN_SPLIT_TOKENS tokens' worth of whole pages,
# and the plan aims at K3_CTAS_PER_SM CTAs an SM (two fit at once, so two
# waves even out ragged rows).
K3_TILE = 64
K3_MIN_SPLIT_TOKENS = 256
K3_CTAS_PER_SM = 4


@dataclasses.dataclass(frozen=True)
class K3Plan:
    """How K3 cuts each row's table of ``MP`` pages: ``splits`` runs of
    ``pages_per_split`` pages (the last may be shorter), one CTA each per
    (row, KV head, query-head group)."""

    splits: int
    pages_per_split: int


def k3_plan(B: int, Hkv: int, groups: int, MP: int, ps: int) -> K3Plan:
    """K3's split of an [B, MP] page table of ``ps``-token pages with Hkv
    KV heads and ``groups`` CTAs of query heads per KV head, from shapes
    alone (the lengths stay on the device, so a captured decode step can
    replay it). Splits that a row's length or window leaves empty exit at
    once in the kernel."""
    if min(B, Hkv, groups, MP, ps) < 1:
        raise ValueError(f"k3_plan: B={B}, Hkv={Hkv}, groups={groups}, "
                         f"MP={MP}, ps={ps}")
    units = B * Hkv * groups
    want = max(1, -(-K3_CTAS_PER_SM * SMS // units))
    pps = min(MP, max(-(-K3_MIN_SPLIT_TOKENS // ps), -(-MP // want)))
    return K3Plan(splits=-(-MP // pps), pages_per_split=pps)


def paged_decode_reference(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, scale: float,
                           window: int = 0,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain version of K3: q [B, H, D] over the gathered view of each
    row's pages, positions < lengths[b] (and >= lengths[b] - window when
    window > 0) unmasked. Returns [B, H, D] in q's dtype."""
    B, H, D = q.shape
    k = gather_pages(k_pool, page_table, k_scale)
    v = gather_pages(v_pool, page_table, v_scale)
    dt = k.dtype
    S = k.shape[2]
    kpos = torch.arange(S, device=q.device)[None, :]
    last = lengths.to(q.device).long()[:, None] - 1           # query position
    ok = kpos <= last
    if window > 0:
        ok = ok & (kpos > last - window)
    mask = torch.where(ok, 0.0, NEG_INF).float()[:, None, :]   # [B, 1, S]
    out = sdpa(q[:, :, None, :].to(dt), k, v, scale, mask=mask)
    return out[:, :, 0, :].to(q.dtype)


def _rows_per_cta(G: int) -> int:
    """Query heads a CTA of K3 takes, of the G that share a KV head: the
    largest of 8, 4, 2 and 1 that divides G (GLM-4.5-Air's 12: 4, so three
    CTAs a KV head)."""
    if G < 1:
        raise ValueError(f"K3: {G} query heads a KV head")
    return next(R for R in (8, 4, 2, 1) if G % R == 0)


def _k3(q, k_pool, v_pool, page_table, lengths, scale: float, window: int,
        k_scale, v_scale):
    """Launch K3 (csrc/paged_attn.cu) on the current stream."""
    from ominix_mlx_tpu_torch.ops import _build

    B, H, D = q.shape
    P, Hkv, ps, Dk = k_pool.shape
    dev = q.device
    quant = k_scale is not None
    pool_dt = torch.int8 if quant else torch.bfloat16
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError(f"K3 q: want contiguous bf16, got {q.dtype}")
    for name, t, dt, shp in (
            ("k_pool", k_pool, pool_dt, (P, Hkv, ps, D)),
            ("v_pool", v_pool, pool_dt, (P, Hkv, ps, D)),
            ("page_table", page_table, torch.int32, (B, page_table.shape[1])),
            ("lengths", lengths, torch.int32, (B,))) + (
            (("k_scale", k_scale, torch.float32, (P, Hkv, ps)),
             ("v_scale", v_scale, torch.float32, (P, Hkv, ps)))
            if quant else ()):
        if t is None or t.device != dev or t.dtype != dt \
                or tuple(t.shape) != shp or not t.is_contiguous():
            got = None if t is None else (t.dtype, tuple(t.shape), t.device)
            raise ValueError(f"K3 {name}: want contiguous {dt} {shp} on "
                             f"{dev}, got {got}")
    if (v_scale is None) != (k_scale is None):
        raise ValueError("K3: k_scale and v_scale go together")
    if Hkv == 0 or H % Hkv or D not in HEAD_DIMS or ps < 1:
        raise ValueError(f"K3 shapes: q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}; head dim must be one of "
                         f"{HEAD_DIMS}")
    R = _rows_per_cta(H // Hkv)
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"q is on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    MP = page_table.shape[1]
    plan = k3_plan(B, Hkv, (H // Hkv) // R, MP, ps)
    lib = _build.library()
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if plan.splits > 1:
        part_acc = torch.empty(B, H, plan.splits, D, dtype=torch.float32,
                               device=dev)
        part_ml = torch.empty(B, H, plan.splits, 2, dtype=torch.float32,
                              device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = lib.ominix_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), ptr(k_scale),
        ptr(v_scale), page_table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), ptr(part_acc), ptr(part_ml), B, H, Hkv, D, ps, MP,
        int(window), R, int(quant), float(scale), plan.pages_per_split,
        plan.splits, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "K3 (ominix_paged_decode)")
    _build.LAUNCHES["k3"] += 1
    if quant:
        _build.LAUNCHES["k3_int8"] += 1
    return out


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, page_table: torch.Tensor,
                           lengths: torch.Tensor, scale: float,
                           window: int = 0,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q: [B, H, D] (one decode step); k_pool/v_pool [P, n_kv, ps, D];
    page_table [B, max_pages]; lengths [B] valid tokens per row INCLUDING
    the token written this step. Returns [B, H, D] in q's dtype. window > 0
    restricts attention to the last ``window`` positions. k_scale/v_scale
    [P, n_kv, ps] switch to int8 pages."""
    if not q.is_cuda:
        return paged_decode_reference(q, k_pool, v_pool, page_table,
                                      lengths, scale, window, k_scale,
                                      v_scale)
    out = _k3(q.to(torch.bfloat16).contiguous(), k_pool, v_pool,
              page_table.to(torch.int32).contiguous(),
              lengths.to(torch.int32).contiguous(), scale, window, k_scale,
              v_scale)
    return out.to(q.dtype)
