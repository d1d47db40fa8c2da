"""K11's one-launch attend (csrc/sparse_attn.cu ``sparse_attend``) on the
CPU: a plain PyTorch model of the kernel's partition and merge, held to the
JAX package's gathered set and to ``sparse_attend_reference``. The model
numbers the valid slots of a (row, KV head) as the kernel does (init, the
finite top-k blocks in top-k order, each placed by its rank among the
finite scores, then the window), cuts them into ``k11_plan``'s splits of
64-slot tiles, gives each of 4 warps 16 slots of a tile with an online
softmax and merges the warps; then the split that draws the last ticket of
its group of K11_MERGE_GROUP splits merges the group's partials in split
order, and, where a row has more than one group, the group merger that
draws the (row, KV head)'s last ticket merges the groups' partials in
group order; each last drawer sets its ticket back to zero.
K11 itself runs on the card (tests/test_torch_kernels_cuda.py)."""

import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ominix_mlx_tpu.core.attention import NEG_INF as JNEG_INF
from ominix_mlx_tpu.models import sparse_attention as jsa
from ominix_mlx_tpu_torch.ops import sparse_attention as osa

torch.set_num_threads(2)
K11_TOL = 3e-2     # per (row, head), as chip_smoke.py holds the kernel
WARPS, WARP_SLOTS = 4, 16
# a small InfLLMv2 config (blocks of 16, one init block of 32, a window of
# 128, the top 8) and the production one (the JAX SparseConfig defaults)
SMALL = dict(init_end=32, ks=16, window=128, topk=8)
PROD = dict(init_end=64, ks=32, window=2048, topk=64)


def jax_gathered(q, k, total, init_end, ks, window, topk):
    """The JAX package's selection and gathered set, its lines
    (ominix_mlx_tpu/models/sparse_attention.py:149-193) in jnp: the masked
    block scores of each KV head's scoring query over the pooled keys,
    lax.top_k, the init / selected-block / window indices and their
    validity. numpy in, numpy (top_scores, top_idx, gather_idx, valid)
    out."""
    B, H, _, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    nb = S // ks
    total = jnp.asarray(total, jnp.int32)
    window_start = jnp.maximum(total - window, init_end)
    comp = jsa.compress_keys(jnp.asarray(k), ks)
    q_score = jnp.asarray(q).reshape(B, Hkv, H // Hkv, 1, D)[:, :, 0]
    scores = jnp.einsum("bhqd,bhnd->bhqn", q_score, comp)
    blk_start = jnp.arange(nb, dtype=jnp.int32) * ks
    blk_valid = ((blk_start[None] >= init_end)
                 & (blk_start[None] + ks <= window_start[:, None]))
    scores = jnp.where(blk_valid[:, None, None], scores, JNEG_INF)
    top_scores, top_idx = jax.lax.top_k(scores[:, :, 0], min(topk, nb))
    topk = top_idx.shape[-1]
    init_idx = jnp.broadcast_to(jnp.arange(init_end, dtype=jnp.int32),
                                (B, Hkv, init_end))
    blk_tok = (top_idx[..., None] * ks
               + jnp.arange(ks, dtype=jnp.int32)).reshape(B, Hkv, topk * ks)
    win_pos = (total[:, None] - window
               + jnp.arange(window, dtype=jnp.int32))
    win_idx = jnp.broadcast_to(jnp.clip(win_pos, 0, S - 1)[:, None],
                               (B, Hkv, window))
    gather_idx = jnp.concatenate([init_idx, blk_tok, win_idx], -1)
    valid = jnp.concatenate([
        jnp.broadcast_to(jnp.arange(init_end)[None, None]
                         < total[:, None, None], (B, Hkv, init_end)),
        jnp.repeat(top_scores > JNEG_INF / 2, ks, axis=-1),
        jnp.broadcast_to((win_pos >= window_start[:, None])[:, None],
                         (B, Hkv, window))], -1)
    return tuple(np.asarray(a) for a in (top_scores, top_idx, gather_idx,
                                         valid))


def k11_model(q, k, v, top_idx, top_scores, total, init_end, window, ks,
              scale, arrivals=None, in_arrival_order=False):
    """The kernel's partition and merge in float32 PyTorch. ``arrivals``
    maps (row, KV head, used splits) to the order in which the splits
    finish (default: split order); ``in_arrival_order`` is a control that
    sums the groups (one group: its splits) in the order they finish
    instead of a fixed order. Returns the
    output [B, H, 1, D] in v's dtype, the cache positions each (row, KV
    head)'s tiles read, in slot order, and the tickets after the call."""
    B, H, _, D = q.shape
    Hkv = k.shape[1]
    S = k.shape[2]
    R = H // Hkv
    topk = top_idx.shape[-1]
    splits, sps = osa.k11_plan(B, Hkv, init_end + topk * ks + window)
    qk = scale * math.log2(math.e)
    out = torch.empty(B, H, 1, D)
    tickets = torch.zeros(
        B * Hkv * (1 + -(-splits // osa.K11_MERGE_GROUP)), dtype=torch.int32)
    read = {}
    for b in range(B):
        tot = int(total[b])
        ws = max(tot - window, init_end)
        n_init, n_win = min(init_end, tot), max(tot - ws, 0)
        for g in range(Hkv):
            ok = top_scores[b, g] > osa.NEG_INF / 2
            rank = torch.cumsum(ok.int(), 0) - 1   # finite scores before
            sel = torch.empty(int(ok.sum()), dtype=torch.long)
            sel[rank[ok]] = top_idx[b, g][ok].long()
            sel_end = n_init + sel.numel() * ks
            count = sel_end + n_win
            used = -(-count // sps)
            assert used <= splits

            def pos_of(i):
                if i < n_init:
                    p = i
                elif i < sel_end:
                    u = i - n_init
                    p = int(sel[u // ks]) * ks + u % ks
                else:
                    p = ws + i - sel_end
                return min(p, S - 1)

            qr = q[b, g * R:(g + 1) * R, 0].float()
            read[(b, g)] = []
            parts = []
            for split in range(used):
                lo, hi = split * sps, min(split * sps + sps, count)
                m = torch.full((WARPS, R), -math.inf)
                l_ = torch.zeros(WARPS, R)
                o = torch.zeros(WARPS, R, D)
                for s0 in range(lo, hi, osa.K11_TILE):
                    slots = s0 + torch.arange(osa.K11_TILE).reshape(
                        WARPS, WARP_SLOTS)
                    live = slots < hi
                    pos = torch.tensor([pos_of(min(int(s), hi - 1))
                                        for s in slots.flatten()]
                                       ).reshape(WARPS, WARP_SLOTS)
                    read[(b, g)] += pos[live].tolist()
                    kr = torch.where(live[..., None], k[b, g, pos].float(),
                                     0.0)
                    vr = torch.where(live[..., None], v[b, g, pos].float(),
                                     0.0)
                    x = torch.einsum("rd,wsd->wrs", qr, kr) * qk
                    x = torch.where(live[:, None], x, -math.inf)
                    m_new = torch.maximum(m, x.amax(-1))
                    alpha = torch.where(m_new == -math.inf, 1.0,
                                        torch.exp2(m - m_new))
                    p = torch.where(live[:, None],
                                    torch.exp2(x - m_new[..., None]), 0.0)
                    l_ = l_ * alpha + p.sum(-1)
                    pv = p.to(v.dtype).float()     # P.V's bf16 operand
                    o = o * alpha[..., None] + torch.einsum(
                        "wrs,wsd->wrd", pv, vr)
                    m = m_new
                mm = m.amax(0)
                f = torch.where(m == -math.inf, 0.0, torch.exp2(m - mm))
                parts.append((mm, (f * l_).sum(0), (f[..., None] * o).sum(0)))
            rows = slice(g * R, (g + 1) * R)
            if used == 1:
                out[b, rows, 0] = parts[0][2] / parts[0][1][:, None]
                continue
            order = (list(arrivals(b, g, used)) if arrivals is not None
                     else list(range(used)))
            G = osa.K11_MERGE_GROUP
            groups, used_groups = -(-splits // G), -(-used // G)
            gtick = tickets[B * Hkv + (b * Hkv + g) * groups:][:groups]

            def members(grp):
                return range(grp * G, min(grp * G + G, used))

            done = []                 # the groups in the order they finish
            for split in order:       # each finishing split takes a ticket
                grp = split // G
                if _draw(gtick, grp, len(members(grp))):
                    done.append(grp)  # its last drawer merges it, then
                    if used_groups > 1:   # takes a ticket of the row
                        _draw(tickets, b * Hkv + g, used_groups)
            if in_arrival_order:   # the control: the order things finish
                merged = [_merge([parts[s] for s in sorted(
                    members(grp), key=order.index)]) for grp in done]
            else:
                merged = [_merge([parts[s] for s in members(grp)])
                          for grp in range(used_groups)]
            pm, pl, pacc = _merge(merged) if used_groups > 1 else merged[0]
            out[b, rows, 0] = pacc / pl[:, None]
    return out.to(v.dtype), read, tickets


def _draw(tickets, i, n):
    """Take ticket i of n: true for the last, which sets it back to
    zero."""
    t = int(tickets[i])
    tickets[i] = 0 if t == n - 1 else t + 1
    return t == n - 1


def _merge(parts):
    """The partials (row max in log2 units, denominator, numerator) summed
    in the order given, as one partial."""
    mm = torch.stack([p[0] for p in parts]).amax(0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for pm, pl, pacc in parts:
        f = torch.where(pm == -math.inf, 0.0, torch.exp2(pm - mm))
        num = num + f[:, None] * pacc
        den = den + f * pl
    return mm, den, num


def _case(B, H, Hkv, S, D, totals, cfg, dtype, seed):
    """numpy-seeded q, k, v (float32, or rounded to bf16), the JAX
    selection and gathered set, and the port's arguments."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, 1, D), np.float32) * 0.3
    k = rng.standard_normal((B, Hkv, S, D), np.float32)
    v = rng.standard_normal((B, Hkv, S, D), np.float32)
    if dtype == torch.bfloat16:
        q, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
                   for a in (q, k, v))
    top, idx, gidx, valid = jax_gathered(q, k, totals, cfg["init_end"],
                                         cfg["ks"], cfg["window"],
                                         cfg["topk"])
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    args = (tq, tk, tv, torch.tensor(idx).long(), torch.tensor(top),
            torch.tensor(totals, dtype=torch.int32), cfg["init_end"],
            cfg["window"], cfg["ks"], D ** -0.5)
    return args, gidx, valid


def _row_rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().amax(-1) / b.abs().amax(-1).clamp_min(1e-12)
            ).max().item()


# (B, H, Hkv, S, D, totals, config): long rows, short rows (no finite
# block; one token), totals around init + window, and the production
# config at 8192 cached tokens
CASES = [
    (2, 8, 2, 1024, 16, [1000, 700], SMALL),
    (3, 8, 2, 1024, 16, [100, 1, 33], SMALL),
    (2, 8, 2, 1024, 16, [160, 161], SMALL),
    (2, 8, 2, 1024, 16, [176, 177], SMALL),
    (1, 32, 2, 8192, 128, [8192], PROD),
]


@pytest.mark.parametrize("case", CASES, ids=[str(c[5]) for c in CASES])
def test_tiles_read_the_jax_gathered_set(case):
    """The positions the model's tiles read, taken from each score's rank
    among the finite ones, are the JAX gathered set's valid slots in its
    order: the init slots below the total, the finite top-k blocks, the
    window."""
    B, H, Hkv, S, D, totals, cfg = case
    args, gidx, valid = _case(B, H, Hkv, S, D, totals, cfg, torch.float32,
                              seed=sum(totals))
    _, read, tickets = k11_model(*args)
    for b in range(B):
        for g in range(Hkv):
            assert read[(b, g)] == gidx[b, g][valid[b, g]].tolist()
    assert not tickets.any()


@pytest.mark.parametrize("case", CASES, ids=[str(c[5]) for c in CASES])
def test_model_equals_the_plain_version_in_float32(case):
    """In float32 (no bf16 rounding of the probabilities) the model equals
    sparse_attend_reference, the JAX gather plus masked sdpa, to 1e-6 per
    (row, head)."""
    B, H, Hkv, S, D, totals, cfg = case
    args, _, _ = _case(B, H, Hkv, S, D, totals, cfg, torch.float32,
                       seed=sum(totals) + 1)
    got, _, _ = k11_model(*args)
    assert _row_rel(got, osa.sparse_attend_reference(*args)) < 1e-6


@pytest.mark.parametrize("case", CASES[::2], ids=[str(c[5])
                                                   for c in CASES[::2]])
def test_model_in_bf16_is_within_k11_tol(case):
    """With bf16 inputs the model rounds its probabilities to bf16 for
    P.V, as the kernel does: within K11_TOL per (row, head) of the plain
    version, which rounds its normalised weights."""
    B, H, Hkv, S, D, totals, cfg = case
    args, _, _ = _case(B, H, Hkv, S, D, totals, cfg, torch.bfloat16,
                       seed=sum(totals) + 2)
    got, _, _ = k11_model(*args)
    assert _row_rel(got, osa.sparse_attend_reference(*args)) < K11_TOL


def test_last_ticket_merge_is_the_same_bits_in_any_arrival_order():
    """Every order in which a row's splits can finish gives the same
    output bits, and every ticket is zero again after the call; a control
    that sums the partials in arrival order instead gives other bits for
    some order."""
    B, H, Hkv, S, D, totals, cfg = CASES[0]
    args, _, _ = _case(B, H, Hkv, S, D, totals, cfg, torch.float32, seed=3)
    base, _, _ = k11_model(*args)
    used = {(b, g): None for b in range(B) for g in range(Hkv)}
    orders = list(itertools.permutations(range(3)))
    differs = False
    for order in orders:
        def arrivals(b, g, n, order=order):
            used[(b, g)] = n
            return order if n == len(order) else range(n)

        got, _, tickets = k11_model(*args, arrivals=arrivals)
        assert torch.equal(got, base) and not tickets.any()
        ctrl, _, _ = k11_model(*args, arrivals=arrivals,
                               in_arrival_order=True)
        differs |= not torch.equal(ctrl, base)
    assert set(used.values()) == {3}       # every row merged three splits
    assert differs


@pytest.mark.parametrize("B_,Hkv,slots,want", [
    (1, 2, 4160, (33, 128)), (8, 2, 4160, (13, 320)),
    (16, 2, 4160, (8, 576)), (1, 2, 288, (3, 128)), (1, 2, 100, (1, 128)),
    (1, 2, 64, (1, 64)), (64, 8, 4160, (1, 4160))])
def test_k11_plan_gives_each_split_two_tiles_in_one_wave(B_, Hkv, slots,
                                                         want):
    """At the smoke's B = 1 and B = 8 shapes, a wider batch and small rows:
    at least K11_MIN_TILES tiles a split unless the row has fewer, the
    fewest tiles a split that keep the CTAs within K11_TARGET_CTAS (one
    wave) unless a row is one split, every slot covered."""
    splits, sps = osa.k11_plan(B_, Hkv, slots)
    assert (splits, sps) == want
    tiles = -(-slots // osa.K11_TILE)
    per = sps // osa.K11_TILE
    assert per >= min(osa.K11_MIN_TILES, tiles)
    assert B_ * Hkv * splits <= osa.K11_TARGET_CTAS or splits == 1
    if per > osa.K11_MIN_TILES:         # one tile fewer would not fit
        assert B_ * Hkv * -(-tiles // (per - 1)) > osa.K11_TARGET_CTAS
    assert splits * sps >= slots > (splits - 1) * sps


def test_two_level_merge_is_the_same_bits_in_any_arrival_order():
    """At the production config over 8192 cached tokens (33 splits: five
    groups, so both levels of the merge run): random orders of the splits'
    arrival give the same bits and leave every ticket zero; the control
    that merges the groups as they finish gives other bits for some
    order."""
    B, H, Hkv, S, D, totals, cfg = CASES[-1]
    args, _, _ = _case(B, H, Hkv, S, D, totals, cfg, torch.float32, seed=4)
    splits = osa.k11_plan(B, Hkv, 64 + 64 * 32 + 2048)[0]
    assert -(-splits // osa.K11_MERGE_GROUP) > 1
    base, _, _ = k11_model(*args)
    rng = np.random.default_rng(0)
    differs = False
    for _ in range(3):
        perm = rng.permutation(splits).tolist()

        def arrivals(b, g, n, perm=perm):
            assert n == splits
            return perm

        got, _, tickets = k11_model(*args, arrivals=arrivals)
        assert torch.equal(got, base) and not tickets.any()
        ctrl, _, _ = k11_model(*args, arrivals=arrivals,
                               in_arrival_order=True)
        differs |= not torch.equal(ctrl, base)
    assert differs
