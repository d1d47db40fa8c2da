"""InfLLMv2's sparse decode attention, the one-token step of MiniCPM-SALA's
"minicpm4" layers (``models.sparse_attention.sparse_decode_attention``),
in two launches:

- ``block_select``: each KV head's scoring query (the first query head of
  its group) against the mean-pooled keys ``comp``, in float32; blocks
  outside [init_end, window_start - ks] score NEG_INF
  (ominix_mlx_tpu/models/sparse_attention.py:150-163); then the top k of
  them, descending, equal scores by block index (``jax.lax.top_k``, :166).
  Kernel K11's selector (counter ``k11_select``) on CUDA; its scores are
  ``block_scores``' (K11's scorer alone, counter ``k11_score``, which the
  decode path no longer launches) bit for bit.
- ``sparse_attend``: every query head of a KV head over its init slots,
  its selected blocks (those whose score is finite) and its window; the
  others are masked (:165-197). Kernel K11's attend (counter
  ``k11_attend``, one launch) on CUDA, reading K and V in place through
  the indices; its partials and tickets live in buffers kept per device
  (``_k11_buffers``).

The JAX package computes both with XLA ops, no Pallas kernel. A CPU
tensor takes the plain versions, the JAX formulas in torch
(``block_select_reference``: ``block_scores_reference`` and a stable
descending sort; ``sparse_attend_reference``, the gather plus masked
attention); a CUDA tensor launches the kernel or raises. ``total``
is each row's token count including this step's, a [B] tensor.
"""

from __future__ import annotations

import threading

import torch

from ominix_mlx_tpu_torch.core.attention import NEG_INF
from ominix_mlx_tpu_torch.ops._build import SMS

K11_DIMS = (128,)      # MiniCPM-SALA's head width
K11_MAX_ROWS = 16       # query heads a KV head (the mma's rows)
K11_MAX_TOPK = 256
K11_TILE = 64           # slots a tile
# the attend's CTAs: at most two an SM over all rows (one wave: the shared
# memory of its cp.async ring allows two), each with at least K11_MIN_TILES
# tiles
K11_TARGET_CTAS = 2 * SMS
K11_MIN_TILES = 2
K11_MERGE_GROUP = 8     # splits a first-level merge (csrc/sparse_attn.cu)
# k11_select: blocks a CTA's run, and the most CTAs a (row, KV head) (the
# last one merges their lists pairwise, 16 warps at the first level)
K11_SELECT_SPAN = 512
K11_SELECT_MAX_CTAS = 32


def window_start(total: torch.Tensor, init_end: int,
                 window: int) -> torch.Tensor:
    """max(total - window, init_end): the first window slot of each row."""
    return torch.clamp(total.long() - window, min=init_end)


def block_scores_reference(q: torch.Tensor, comp: torch.Tensor,
                           total: torch.Tensor, init_end: int, window: int,
                           ks: int) -> torch.Tensor:
    """Plain version of ``k11_score``: q [B, H, 1, D], comp [B, Hkv, nb,
    D], total [B] -> scores [B, Hkv, nb] float32 (the JAX package's einsum
    on float32 copies, the invalid blocks NEG_INF)."""
    B, H, _, D = q.shape
    Hkv, nb = comp.shape[1], comp.shape[2]
    q_score = q.reshape(B, Hkv, H // Hkv, D)[:, :, 0]
    scores = torch.einsum("bhd,bhnd->bhn", q_score.float(), comp.float())
    start = torch.arange(nb, device=q.device) * ks
    ws = window_start(total.to(q.device), init_end, window)
    valid = (start[None] >= init_end) & (start[None] + ks <= ws[:, None])
    return torch.where(valid[:, None], scores,
                       torch.full((), NEG_INF, device=q.device))


def block_select_reference(q: torch.Tensor, comp: torch.Tensor,
                           total: torch.Tensor, init_end: int, window: int,
                           ks: int, k: int):
    """Plain version of ``k11_select``: (top_scores [B, Hkv, k] float32,
    top_idx [B, Hkv, k] int64), the ``block_scores_reference`` scores
    sorted descending with equal scores by block index (a stable sort:
    ``jax.lax.top_k``'s order, which ``torch.topk`` does not promise), the
    first k."""
    scores = block_scores_reference(q, comp, total, init_end, window, ks)
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k].contiguous(), idx[..., :k].contiguous()


def sparse_attend_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, top_idx: torch.Tensor,
                            top_scores: torch.Tensor, total: torch.Tensor,
                            init_end: int, window: int, ks: int,
                            scale: float) -> torch.Tensor:
    """Plain version of ``k11_attend``, the JAX gather plus masked sdpa:
    q [B, H, 1, D], k/v [B, Hkv, S, D], top_idx / top_scores [B, Hkv,
    topk], total [B] -> [B, H, 1, D] in v's dtype. The gathered set is
    init (slots below init_end, valid below total), the selected blocks
    (valid where their score is finite) and the last ``window`` positions
    (valid from the window start); the invalid slots are masked with
    NEG_INF, the softmax weights rounded to v's dtype."""
    B, H, _, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    topk = top_idx.shape[-1]
    dev = q.device
    total = total.to(dev).long()
    ws = window_start(total, init_end, window)
    ar_init = torch.arange(init_end, device=dev)
    blk_tok = (top_idx.long()[..., None] * ks
               + torch.arange(ks, device=dev)).reshape(B, Hkv, topk * ks)
    win_pos = total[:, None] - window + torch.arange(window, device=dev)
    idx = torch.cat([ar_init.expand(B, Hkv, init_end), blk_tok,
                     win_pos[:, None].expand(B, Hkv, window)], -1)
    idx = idx.clamp(0, S - 1)
    valid = torch.cat([
        (ar_init[None, None] < total[:, None, None]).expand(B, Hkv,
                                                            init_end),
        (top_scores > NEG_INF / 2).repeat_interleave(ks, -1),
        (win_pos >= ws[:, None])[:, None].expand(B, Hkv, window)], -1)
    gather = idx[..., None].expand(-1, -1, -1, D)
    gk = torch.gather(k, 2, gather)
    gv = torch.gather(v, 2, gather)
    qg = q.reshape(B, Hkv, H // Hkv, 1, D)
    logits = torch.einsum("bhgtd,bhsd->bhgts", qg.float(),
                          gk.float()) * scale
    logits = logits + torch.where(valid, 0.0, NEG_INF)[:, :, None, None]
    w = torch.softmax(logits, -1).to(v.dtype)
    out = torch.einsum("bhgts,bhsd->bhgtd", w, gv)
    return out.reshape(B, H, 1, D)


def k11_plan(B: int, Hkv: int, slots: int):
    """(splits, slots a split) of k11_attend for ``slots`` = init_end +
    topk * ks + window (the most a row can hold): whole 64-slot tiles, at
    least K11_MIN_TILES a split (unless the row has fewer), and the fewest
    a split whose B * Hkv * splits CTAs fit K11_TARGET_CTAS (one wave: a
    CTA that waits for a second wave delays its row's merge by a whole CTA
    time), or all of a row's tiles in one split where nothing fits. Reads
    shapes only."""
    tiles = -(-slots // K11_TILE)
    per = min(K11_MIN_TILES, tiles)
    while per < tiles and B * Hkv * -(-tiles // per) > K11_TARGET_CTAS:
        per += 1
    return -(-tiles // per), per * K11_TILE


def k11_select_plan(nb: int):
    """(ctas, rounds) of k11_select for nb blocks a (row, KV head): runs
    of K11_SELECT_SPAN blocks, ``rounds`` of them a CTA, the fewest rounds
    that keep the CTAs a pair within K11_SELECT_MAX_CTAS. Reads shapes
    only."""
    runs = -(-nb // K11_SELECT_SPAN)
    rounds = -(-runs // K11_SELECT_MAX_CTAS)
    return -(-runs // rounds), rounds


def k11_select_width(k: int) -> int:
    """L, the keys of the sorted list a CTA of k11_select keeps: the least
    of 64, 128, 256 that holds k."""
    return 64 if k <= 64 else 128 if k <= 128 else 256


# per device index: (tickets, partial numerators, partial maxima and
# denominators) of k11_attend; a buffer that is outgrown stays referenced
# in _K11_RETIRED, since a CUDA graph captured over it writes it on replay
_K11_BUFFERS: dict = {}
_K11_RETIRED: list = []
_K11_LOCK = threading.Lock()


def _k11_buffers(dev: torch.device, counters: int, parts: int):
    """k11_attend's tickets (``counters`` int32 counters, one a (row, KV
    head) and one a group of its splits; zero: the kernel sets each one it
    takes back to zero) and float32 partials (``parts`` (row, KV head,
    split, query head) entries of D and 2 floats, K11_MAX_ROWS heads a KV
    head), allocated once
    per device and grown to at least twice their size when a call needs
    more: otherwise a call allocates and clears nothing."""
    def grown(t, need):
        return max(need, 0 if t is None else 2 * t.numel())

    with _K11_LOCK:
        tickets, acc, ml = _K11_BUFFERS.get(dev.index, (None, None, None))
        if tickets is None or tickets.numel() < counters:
            _K11_RETIRED.append(tickets)
            tickets = torch.zeros(grown(tickets, counters), dtype=torch.int32,
                                  device=dev)
        if ml is None or ml.numel() < 2 * parts:
            _K11_RETIRED.extend((acc, ml))
            n = grown(ml, 2 * parts) // 2
            acc = torch.empty(n * K11_DIMS[0], dtype=torch.float32,
                              device=dev)
            ml = torch.empty(2 * n, dtype=torch.float32, device=dev)
        _K11_BUFFERS[dev.index] = (tickets, acc, ml)
        return tickets, acc, ml


# per device index: (tickets, candidate lists) of k11_select, grown as
# _k11_buffers' are
_K11_SELECT_BUFFERS: dict = {}


def _k11_select_buffers(dev: torch.device, pairs: int, keys: int):
    """k11_select's tickets (``pairs`` int32 counters, zero; the kernel
    sets each one it takes back to zero) and candidate lists (``keys``
    int64 sort keys), allocated once per device and grown to at least
    twice their size when a call needs more."""
    with _K11_LOCK:
        tickets, cands = _K11_SELECT_BUFFERS.get(dev.index, (None, None))
        if tickets is None or tickets.numel() < pairs:
            _K11_RETIRED.append(tickets)
            tickets = torch.zeros(max(pairs, 0 if tickets is None
                                      else 2 * tickets.numel()),
                                  dtype=torch.int32, device=dev)
        if cands is None or cands.numel() < keys:
            _K11_RETIRED.append(cands)
            cands = torch.empty(max(keys, 0 if cands is None
                                    else 2 * cands.numel()),
                                dtype=torch.int64, device=dev)
        _K11_SELECT_BUFFERS[dev.index] = (tickets, cands)
        return tickets, cands


def _check_common(q, total, what):
    B, H, T, D = q.shape
    if q.dtype != torch.bfloat16 or T != 1 or not q.is_contiguous():
        raise ValueError(f"{what} q: want contiguous bf16 [B, H, 1, D], got "
                         f"{q.dtype} {tuple(q.shape)}")
    if D not in K11_DIMS:
        raise ValueError(f"{what} takes D in {K11_DIMS}, got {D}")
    if total.dtype != torch.int32 or tuple(total.shape) != (B,) \
            or total.device != q.device or not total.is_contiguous():
        raise ValueError(f"{what} total: want contiguous int32 ({B},) on "
                         f"{q.device}, got {total.dtype} "
                         f"{tuple(total.shape)} on {total.device}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"q is on {q.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return B, H, D


def _want(what, name, t, shape, dtype, dev):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or t.device != dev or not t.is_contiguous():
        raise ValueError(f"{what} {name}: want contiguous {dtype} "
                         f"{tuple(shape)} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _k11_score(q: torch.Tensor, comp: torch.Tensor, total: torch.Tensor,
               init_end: int, window: int, ks: int) -> torch.Tensor:
    """Launch K11's scorer on the current stream; raises for what it does
    not take."""
    from ominix_mlx_tpu_torch.ops import _build

    B, H, D = _check_common(q, total, "k11_score")
    Hkv, nb = comp.shape[1], comp.shape[2]
    _want("k11_score", "comp", comp, (B, Hkv, nb, D), torch.bfloat16,
          q.device)
    if Hkv < 1 or H % Hkv or H // Hkv > K11_MAX_ROWS or B > 65535 \
            or Hkv > 65535:
        raise ValueError(f"k11_score: {H} query heads over {Hkv} KV heads, "
                         f"B = {B}")
    scores = torch.empty(B, Hkv, nb, dtype=torch.float32, device=q.device)
    rc = _build.library().ominix_sparse_score(
        q.data_ptr(), comp.data_ptr(), total.data_ptr(), scores.data_ptr(),
        B, H, Hkv, nb, D, init_end, window, ks,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "k11_score (ominix_sparse_score)")
    _build.LAUNCHES["k11_score"] += 1
    return scores


def _k11_select(q: torch.Tensor, comp: torch.Tensor, total: torch.Tensor,
                init_end: int, window: int, ks: int, k: int):
    """Launch K11's selector on the current stream: (top_scores,
    top_idx); raises for what it does not take."""
    from ominix_mlx_tpu_torch.ops import _build

    B, H, D = _check_common(q, total, "k11_select")
    Hkv, nb = comp.shape[1], comp.shape[2]
    dev = q.device
    _want("k11_select", "comp", comp, (B, Hkv, nb, D), torch.bfloat16, dev)
    if Hkv < 1 or H % Hkv or H // Hkv > K11_MAX_ROWS or B > 65535 \
            or Hkv > 65535:
        raise ValueError(f"k11_select: {H} query heads over {Hkv} KV heads, "
                         f"B = {B}")
    if not 1 <= k <= min(nb, K11_MAX_TOPK):
        raise ValueError(f"k11_select takes 1 <= k <= min(blocks, "
                         f"{K11_MAX_TOPK}); got k={k} over {nb} blocks")
    ctas, rounds = k11_select_plan(nb)
    top_val = torch.empty(B, Hkv, k, dtype=torch.float32, device=dev)
    top_idx = torch.empty(B, Hkv, k, dtype=torch.int64, device=dev)
    tickets = cands = None
    if ctas > 1:
        tickets, cands = _k11_select_buffers(
            dev, B * Hkv, B * Hkv * ctas * k11_select_width(k))
    rc = _build.library().ominix_sparse_select(
        q.data_ptr(), comp.data_ptr(), total.data_ptr(), top_val.data_ptr(),
        top_idx.data_ptr(), *(None if t is None else t.data_ptr()
                              for t in (cands, tickets)),
        B, H, Hkv, nb, D, init_end, window, ks, k, ctas, rounds,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "k11_select (ominix_sparse_select)")
    _build.LAUNCHES["k11_select"] += 1
    return top_val, top_idx


def _k11_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                top_idx: torch.Tensor, top_scores: torch.Tensor,
                total: torch.Tensor, init_end: int, window: int, ks: int,
                scale: float) -> torch.Tensor:
    """Launch K11's attend (one launch; past one split the last CTA of a
    (row, KV head) merges its partials) on the current stream; raises for
    what it does not take."""
    from ominix_mlx_tpu_torch.ops import _build

    B, H, D = _check_common(q, total, "k11_attend")
    Hkv, S = k.shape[1], k.shape[2]
    topk = top_idx.shape[-1]
    dev = q.device
    _want("k11_attend", "k", k, (B, Hkv, S, D), torch.bfloat16, dev)
    _want("k11_attend", "v", v, (B, Hkv, S, D), torch.bfloat16, dev)
    _want("k11_attend", "top_idx", top_idx, (B, Hkv, topk), torch.int64,
          dev)
    _want("k11_attend", "top_scores", top_scores, (B, Hkv, topk),
          torch.float32, dev)
    if Hkv < 1 or H % Hkv or H // Hkv > K11_MAX_ROWS \
            or topk > K11_MAX_TOPK or B > 65535 or Hkv > 65535:
        raise ValueError(f"k11_attend takes H / Hkv <= {K11_MAX_ROWS} and "
                         f"topk <= {K11_MAX_TOPK}; got H={H}, Hkv={Hkv}, "
                         f"topk={topk}")
    if init_end + window < 1:
        raise ValueError("k11_attend needs init_end + window >= 1 (a row's "
                         "first slot valid)")
    splits, sps = k11_plan(B, Hkv, init_end + topk * ks + window)
    out = torch.empty(B, H, 1, D, dtype=torch.bfloat16, device=dev)
    tickets = part_acc = part_ml = None
    if splits > 1:
        tickets, part_acc, part_ml = _k11_buffers(
            dev, B * Hkv * (1 + -(-splits // K11_MERGE_GROUP)),
            B * Hkv * splits * K11_MAX_ROWS)
    rc = _build.library().ominix_sparse_attend(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), top_idx.data_ptr(),
        top_scores.data_ptr(), total.data_ptr(), out.data_ptr(),
        *(None if t is None else t.data_ptr()
          for t in (part_acc, part_ml, tickets)),
        B, H, Hkv, S, D, topk, init_end, window, ks, splits, sps,
        K11_MERGE_GROUP, scale, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "k11_attend (ominix_sparse_attend)")
    _build.LAUNCHES["k11_attend"] += 1
    return out


def block_scores(q: torch.Tensor, comp: torch.Tensor, total: torch.Tensor,
                 init_end: int, window: int, ks: int) -> torch.Tensor:
    """The masked block scores [B, Hkv, nb] float32: K11's scorer on CUDA
    (or it raises), ``block_scores_reference`` on the CPU."""
    if not q.is_cuda:
        return block_scores_reference(q, comp, total, init_end, window, ks)
    return _k11_score(q, comp, total, init_end, window, ks)


def block_select(q: torch.Tensor, comp: torch.Tensor, total: torch.Tensor,
                 init_end: int, window: int, ks: int, k: int):
    """(top_scores [B, Hkv, k] float32, top_idx [B, Hkv, k] int64) of the
    masked block scores: K11's selector on CUDA (or it raises),
    ``block_select_reference`` on the CPU."""
    if not q.is_cuda:
        return block_select_reference(q, comp, total, init_end, window, ks,
                                      k)
    return _k11_select(q, comp, total, init_end, window, ks, k)


def sparse_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  top_idx: torch.Tensor, top_scores: torch.Tensor,
                  total: torch.Tensor, init_end: int, window: int, ks: int,
                  scale: float) -> torch.Tensor:
    """Attention over init, selected blocks and window, [B, H, 1, D]:
    K11's attend on CUDA (or it raises), ``sparse_attend_reference`` on the
    CPU."""
    if not q.is_cuda:
        return sparse_attend_reference(q, k, v, top_idx, top_scores, total,
                                       init_end, window, ks, scale)
    return _k11_attend(q, k, v, top_idx, top_scores, total, init_end, window,
                       ks, scale)
