"""The gated delta rule: the recurrence of a Gated DeltaNet layer
(``models.deltanet.block``) over T tokens from a carried state, the
prologue that prepares its inputs, and the layer's whole decode mixer.

No TPU kernel computes either: the JAX package runs the per-token step
under ``jax.lax.scan`` (ominix_mlx_tpu/models/deltanet.py:132-144), which
XLA compiles into one loop, and leaves the prologue (conv, gates,
l2norms: :111-130) to XLA. Here a CUDA tensor launches a kernel or
raises; a CPU tensor takes the plain version:

- the rule: kernel K9 (``csrc/gated_delta.cu``) in one of two forms,
  which ``k9_plan`` picks from the shapes alone: the recurrent form (the
  loop over T inside one launch; decode and short prompts, every head
  width) or the chunked form (chunks of 64 tokens as matrix products on
  the tensor cores, then a scan over the chunks; prompts at dk = dv =
  128). Plain version ``gated_delta_rule_reference``, the JAX step token
  by token in float32; ``chunk_gated_delta_rule_reference`` is the
  chunked form's formulas in torch, the same function summed in another
  order.
- the prologue: ``k9_prep`` (``csrc/k9_prep.cu``), one launch in place of
  the some 36 of its plain version ``deltanet_prep_reference``.
- the decode mixer (T = 1): ``deltanet_decode``, kernel ``k9_decode``
  (``csrc/k9_decode.cu``): the prologue, one step of the rule, the cast,
  the gated RMSNorm and ``* silu(z)`` in one launch; plain version
  ``deltanet_decode_reference``, the prologue's and the rule's plain
  versions and the glue as the layer composes them at prompts.

The rule writes the final state into ``state`` in place (the batcher's
row views carry it) and returns the outputs o [B, T, Hv, dv] in float32;
the prologue writes the conv window in place; the decode mixer both.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ominix_mlx_tpu_torch.ops.quant_matmul import rms_norm

# head widths dk the recurrent form is built for (a thread holds dk / 4 rows)
K9_DK = (32, 64, 128, 256)
K9_MAX_GRID = 65535
# The chunked form: tokens a chunk, the head widths (dk, dv) it is built
# for, and the prompt length from which k9_plan takes it. Below it the
# recurrent form is faster: it costs about 0.7 us a token, the chunked
# form's two launches a fixed 33-37 us up to one chunk, and they meet
# near 48 tokens (chip_smoke.py's k9_crossover lines, H100 80GB HBM3 at
# 700 W, Qwen3-Next's 16 / 32 heads of 128, B = 1; PERF.md section 6).
K9_CHUNK = 64
K9_CHUNK_DIMS = ((128, 128),)
K9_CHUNK_MIN_T = 48
# the most scratch the chunked form may allocate (80 KiB a chunk and
# value head), past which the plan keeps the recurrent form
K9_CHUNK_MAX_SCRATCH = 2 << 30
# (dk = dv) widths and the conv length the prologue is built for
K9_PREP_DIMS = (128,)
K9_PREP_TAPS = 4
K9_PREP_TILE = 16
# the decode mixer: dk = dv widths, and the largest Hv / Hk (its CTAs of
# one row and key head, 2 Hv / Hk of them, form one thread block cluster,
# at most 8 CTAs)
K9_DECODE_DIMS = (128,)
K9_DECODE_MAX_RATIO = 4


def k9_plan(B: int, T: int, Hv: int, dk: int, dv: int) -> str:
    """The form of K9 for these shapes: "chunked" for prompts of at least
    K9_CHUNK_MIN_T tokens at the head widths it is built for (while its
    scratch stays within K9_CHUNK_MAX_SCRATCH), else "recurrent". Reads
    shapes only."""
    nc = -(-T // K9_CHUNK)
    scratch = 4 * B * Hv * nc * K9_CHUNK * (dk + dv + K9_CHUNK + 1)
    if (dk, dv) in K9_CHUNK_DIMS and T >= K9_CHUNK_MIN_T \
            and scratch <= K9_CHUNK_MAX_SCRATCH:
        return "chunked"
    return "recurrent"


def k9_launches(B: int, T: int, Hv: int, dk: int, dv: int) -> dict:
    """The launch counts ({counter: n}) of one call of the rule on CUDA at
    these shapes: one "k9" for the recurrent form, one "k9_chunk" and one
    "k9_chunk_scan" (its two phases) for the chunked form."""
    if k9_plan(B, T, Hv, dk, dv) == "chunked":
        return {"k9_chunk": 1, "k9_chunk_scan": 1}
    return {"k9": 1}


def deltanet_launches(B: int, T: int, Hv: int, dk: int, dv: int) -> dict:
    """The launch counts of one DeltaNet layer's mixer on CUDA at these
    shapes (``models.deltanet.block``): one "k9_decode" at T = 1, else
    one "k9_prep" and the rule in the form k9_plan picks."""
    if T == 1:
        return {"k9_decode": 1}
    return {"k9_prep": 1, **k9_launches(B, T, Hv, dk, dv)}


def gated_delta_rule_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, g: torch.Tensor,
                               beta: torch.Tensor,
                               state: torch.Tensor) -> torch.Tensor:
    """Plain version of K9, the JAX step token by token in float32:
    S = S * exp(g_t); kv_mem = S^T k_t; delta = (v_t - kv_mem) * beta_t;
    S += k_t delta^T; o_t = S^T q_t. q, k [B, T, Hk, dk] (value head h
    reads key head h // (Hv / Hk), as ``jnp.repeat`` does); v [B, T, Hv,
    dv]; g, beta [B, T, Hv]; state [B, Hv, dk, dv] float32, written in
    place. Returns o [B, T, Hv, dv] float32."""
    Hk, Hv = q.shape[2], v.shape[2]
    r = Hv // Hk
    if r > 1:
        q = q.repeat_interleave(r, 2)
        k = k.repeat_interleave(r, 2)
    q, k, v = q.float(), k.float(), v.float()
    g, beta = g.float(), beta.float()
    S = state.float()
    outs = []
    for t in range(q.shape[1]):
        S = S * torch.exp(g[:, t])[..., None, None]
        kv_mem = torch.einsum("bhkv,bhk->bhv", S, k[:, t])
        delta = (v[:, t] - kv_mem) * beta[:, t, :, None]
        S = S + torch.einsum("bhk,bhv->bhkv", k[:, t], delta)
        outs.append(torch.einsum("bhkv,bhk->bhv", S, q[:, t]))
    state.copy_(S)
    return torch.stack(outs, 1)


def chunk_gated_delta_rule_reference(q: torch.Tensor, k: torch.Tensor,
                                     v: torch.Tensor, g: torch.Tensor,
                                     beta: torch.Tensor, state: torch.Tensor,
                                     chunk: int = K9_CHUNK) -> torch.Tensor:
    """The chunked form's formulas in float32 torch (the arguments and
    result as ``gated_delta_rule_reference``'s). Per chunk of ``chunk``
    tokens (the last may be shorter), with G the cumulative sum of g
    within it and S the state at its start:
    Gam_ij = exp(G_i - G_j) for j <= i, else 0 (masked before the exp);
    A = strictly-lower(diag(beta) Gam * K K^T); T = (I + A)^-1;
    W = T diag(beta e^G) K; U0 = T diag(beta) V; U = U0 - W S;
    O = diag(e^G) Q S + (Q K^T * Gam) U;
    S <- e^{G_C} S + K^T (diag(e^{G_C - G}) U)."""
    Hk, Hv = q.shape[2], v.shape[2]
    r = Hv // Hk
    if r > 1:
        q = q.repeat_interleave(r, 2)
        k = k.repeat_interleave(r, 2)

    def heads_first(x):
        return x.float().transpose(1, 2)

    q, k, v = heads_first(q), heads_first(k), heads_first(v)   # [B,Hv,T,d]
    g, beta = heads_first(g), heads_first(beta)                # [B,Hv,T]
    S = state.float()
    outs = []
    for t0 in range(0, q.shape[2], chunk):
        sl = slice(t0, t0 + chunk)
        Q, K, V, bt = q[:, :, sl], k[:, :, sl], v[:, :, sl], beta[:, :, sl]
        G = g[:, :, sl].cumsum(-1)
        n = G.shape[-1]
        lower = torch.ones(n, n, dtype=torch.bool).tril()
        diff = G[..., :, None] - G[..., None, :]
        gam = torch.exp(diff.masked_fill(~lower, -math.inf))
        A = ((bt[..., :, None] * gam) * (K @ K.transpose(-1, -2))).tril(-1)
        eye = torch.eye(n, dtype=torch.float32).expand_as(A)
        Tm = torch.linalg.solve_triangular(eye + A, eye, upper=False,
                                           unitriangular=True)
        W = Tm @ ((bt * torch.exp(G))[..., None] * K)
        U0 = Tm @ (bt[..., None] * V)
        P = (Q @ K.transpose(-1, -2)) * gam
        U = U0 - W @ S
        outs.append(torch.exp(G)[..., None] * (Q @ S) + P @ U)
        Ud = torch.exp(G[..., -1:] - G)[..., None] * U
        S = torch.exp(G[..., -1])[..., None, None] * S \
            + K.transpose(-1, -2) @ Ud
    state.copy_(S)
    return torch.cat(outs, 2).transpose(1, 2)


def _check_rule(q, k, v, g, beta, state):
    """(B, T, Hk, Hv, dk, dv) of K9's arguments, which must be contiguous
    float32 on the current CUDA device; raises for what it does not
    take."""
    B, T, Hk, dk = q.shape
    Hv, dv = v.shape[2], v.shape[3]
    dev = q.device
    want = {"q": (q, (B, T, Hk, dk)), "k": (k, (B, T, Hk, dk)),
            "v": (v, (B, T, Hv, dv)), "g": (g, (B, T, Hv)),
            "beta": (beta, (B, T, Hv)), "state": (state, (B, Hv, dk, dv))}
    for name, (t, shp) in want.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shp \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"K9 {name}: want contiguous float32 {shp} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if dk not in K9_DK or Hv % Hk or not 1 <= T or B > K9_MAX_GRID \
            or Hv > K9_MAX_GRID:
        raise ValueError(f"K9 takes dk in {K9_DK}, Hv a multiple of Hk, "
                         f"T >= 1 and B, Hv <= {K9_MAX_GRID}; got dk={dk}, "
                         f"Hk={Hk}, Hv={Hv}, T={T}, B={B}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"q is on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return B, T, Hk, Hv, dk, dv


def _k9(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
        beta: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Launch K9's recurrent form on the current stream (float32 CUDA
    tensors, shapes as in ``gated_delta_rule_reference``); raises for
    what it does not take."""
    from ominix_mlx_tpu_torch.ops import _build

    B, T, Hk, Hv, dk, dv = _check_rule(q, k, v, g, beta, state)
    o = torch.empty(B, T, Hv, dv, dtype=torch.float32, device=q.device)
    rc = _build.library().ominix_gated_delta(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        beta.data_ptr(), state.data_ptr(), o.data_ptr(), B, T, Hk, Hv, dk,
        dv, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "K9 (ominix_gated_delta)")
    _build.LAUNCHES["k9"] += 1
    return o


def _k9_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                g: torch.Tensor, beta: torch.Tensor,
                state: torch.Tensor) -> torch.Tensor:
    """Launch K9's chunked form on the current stream: phase 1 (the
    chunks' products, into a float32 scratch of 80 KiB a chunk and value
    head at dk = dv = 128), then phase 2 (the scan over the chunks).
    Arguments as ``_k9``'s; dk = dv = 128 only."""
    from ominix_mlx_tpu_torch.ops import _build

    B, T, Hk, Hv, dk, dv = _check_rule(q, k, v, g, beta, state)
    if (dk, dv) not in K9_CHUNK_DIMS:
        raise ValueError(f"K9's chunked form takes (dk, dv) in "
                         f"{K9_CHUNK_DIMS}; got ({dk}, {dv})")
    nc = -(-T // K9_CHUNK)
    dev = q.device
    o = torch.empty(B, T, Hv, dv, dtype=torch.float32, device=dev)
    blocks = B * Hv * nc * K9_CHUNK
    scratch = torch.empty(blocks * (dk + dv + K9_CHUNK + 1),
                          dtype=torch.float32, device=dev)
    W, U0, P, G = scratch.split([blocks * dk, blocks * dv,
                                 blocks * K9_CHUNK, blocks])
    rc = _build.library().ominix_gated_delta_chunked(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        beta.data_ptr(), state.data_ptr(), o.data_ptr(), W.data_ptr(),
        U0.data_ptr(), P.data_ptr(), G.data_ptr(), B, T, Hk, Hv, dk, dv,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "K9 chunked (ominix_gated_delta_chunked)")
    _build.LAUNCHES["k9_chunk"] += 1
    _build.LAUNCHES["k9_chunk_scan"] += 1
    return o


def _k9_rule(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             g: torch.Tensor, beta: torch.Tensor,
             state: torch.Tensor) -> torch.Tensor:
    """K9 on CUDA in the form ``k9_plan`` picks."""
    B, T, _, dk = q.shape
    Hv, dv = v.shape[2], v.shape[3]
    if k9_plan(B, T, Hv, dk, dv) == "chunked":
        return _k9_chunked(q, k, v, g, beta, state)
    return _k9(q, k, v, g, beta, state)


def gated_delta_rule(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     g: torch.Tensor, beta: torch.Tensor,
                     state: torch.Tensor) -> torch.Tensor:
    """The recurrence over T tokens: o [B, T, Hv, dv] float32, ``state``
    [B, Hv, dk, dv] float32 advanced in place. A CUDA tensor launches K9
    in the planned form (its inputs contiguous float32, as ``k9_prep``
    writes them, or it raises); a CPU tensor takes the plain version."""
    if not q.is_cuda:
        return gated_delta_rule_reference(q, k, v, g, beta, state)
    return _k9_rule(q, k, v, g, beta, state)


# ------------------------------------------------------------ the prologue

def split_qkvz_ba(qkvz: torch.Tensor, ba: torch.Tensor, heads):
    """HF ``fix_query_key_value_ordering``: per-k-head interleaved packing
    [q (dk), k (dk), v (r dv), z (r dv)] and [b (r), a (r)] for each of the
    Hk key heads, r = Hv / Hk; ``heads`` is (Hk, Hv, dk, dv). Views."""
    Hk, Hv, dk, dv = heads
    B, T, _ = qkvz.shape
    r = Hv // Hk
    qkvz = qkvz.reshape(B, T, Hk, 2 * dk + 2 * r * dv)
    q = qkvz[..., :dk]
    k = qkvz[..., dk:2 * dk]
    v = qkvz[..., 2 * dk:2 * dk + r * dv].reshape(B, T, Hv, dv)
    z = qkvz[..., 2 * dk + r * dv:].reshape(B, T, Hv, dv)
    ba = ba.reshape(B, T, Hk, 2 * r)
    b = ba[..., :r].reshape(B, T, Hv)
    a = ba[..., r:].reshape(B, T, Hv)
    return q, k, v, z, b, a


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + eps)


def causal_conv_reference(x: torch.Tensor, window: torch.Tensor,
                          conv_w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over x [B, T, C] after the carried window
    [B, K-1, C], then SiLU, in x's type (each output a float32 sum of its
    K taps, rounded once; no cuDNN, whose float32 convolutions run in
    TF32). conv_w is [C, K]. The window's last K-1 inputs are written back
    in place."""
    K, T = conv_w.shape[1], x.shape[1]
    w = conv_w.to(x.dtype).float()
    full = torch.cat([window.to(x.dtype), x], 1)            # [B, K-1+T, C]
    ff = full.float()
    out = ff[:, 0:T] * w[:, 0]
    for j in range(1, K):
        out = out + ff[:, j:j + T] * w[:, j]
    if K > 1:
        window.copy_(full[:, -(K - 1):])
    return F.silu(out.to(x.dtype))


def deltanet_prep_reference(qkvz: torch.Tensor, ba: torch.Tensor,
                            window: torch.Tensor, conv_w: torch.Tensor,
                            A_log: torch.Tensor, dt_bias: torch.Tensor,
                            heads):
    """Plain version of ``k9_prep``, the JAX package's roundings (its
    deltanet.block:111-130): the q|k|v channels of qkvz [B, T, Hk (2 dk +
    2 r dv)] through the causal conv and SiLU (``causal_conv_reference``,
    the window [B, K-1, conv_dim] written in place); beta = sigmoid(b) and
    g = -exp(A_log) softplus(a + dt_bias) from ba [B, T, 2 Hv], in
    float32; q l2-normed and scaled by dk^-0.5, k l2-normed, v, each in
    float32. ``heads`` is (Hk, Hv, dk, dv). Returns (q [B, T, Hk, dk], k,
    v [B, T, Hv, dv], g [B, T, Hv], beta)."""
    Hk, Hv, dk, dv = heads
    B, T, _ = qkvz.shape
    q, k, v, _, b, a = split_qkvz_ba(qkvz, ba, heads)
    mixed = torch.cat([q.reshape(B, T, -1), k.reshape(B, T, -1),
                       v.reshape(B, T, -1)], -1)
    mixed = causal_conv_reference(mixed, window, conv_w)
    kd = Hk * dk
    q = mixed[..., :kd].reshape(B, T, Hk, dk)
    k = mixed[..., kd:2 * kd].reshape(B, T, Hk, dk)
    v = mixed[..., 2 * kd:].reshape(B, T, Hv, dv)

    beta = torch.sigmoid(b.float())                                # [B,T,Hv]
    g = (-torch.exp(A_log.float())
         * F.softplus(a.float() + dt_bias.float()))
    q = l2norm(q.float()) * dk ** -0.5
    k = l2norm(k.float())
    return q, k, v.float(), g, beta


def _k9_prep(qkvz: torch.Tensor, ba: torch.Tensor, window: torch.Tensor,
             conv_w: torch.Tensor, A_log: torch.Tensor,
             dt_bias: torch.Tensor, heads):
    """Launch k9_prep on the current stream (arguments as
    ``deltanet_prep_reference``'s: qkvz, ba, the window and the taps in one
    type, bf16 or float32, contiguous; A_log and dt_bias float32); raises
    for what it does not take."""
    from ominix_mlx_tpu_torch.ops import _build

    Hk, Hv, dk, dv = heads
    B, T, _ = qkvz.shape
    dev = qkvz.device
    r = Hv // Hk if Hk and Hv % Hk == 0 else 0
    conv_dim = 2 * Hk * dk + Hv * dv
    K = conv_w.shape[-1]
    if not r or dk != dv or dk not in K9_PREP_DIMS or K != K9_PREP_TAPS \
            or B > K9_MAX_GRID or -(-T // K9_PREP_TILE) > K9_MAX_GRID:
        raise ValueError(f"k9_prep takes dk = dv in {K9_PREP_DIMS}, Hv a "
                         f"multiple of Hk, a conv of {K9_PREP_TAPS} taps; "
                         f"got dk={dk}, dv={dv}, Hk={Hk}, Hv={Hv}, K={K}")
    dt = qkvz.dtype
    want = {"qkvz": (qkvz, (B, T, Hk * (2 * dk + 2 * r * dv)), dt),
            "ba": (ba, (B, T, 2 * Hv), dt),
            "window": (window, (B, K - 1, conv_dim), dt),
            "conv_w": (conv_w, (conv_dim, K), dt),
            "A_log": (A_log, (Hv,), torch.float32),
            "dt_bias": (dt_bias, (Hv,), torch.float32)}
    for name, (t, shp, tdt) in want.items():
        if t.dtype != tdt or tuple(t.shape) != shp or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f"k9_prep {name}: want contiguous {tdt} {shp} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"k9_prep takes bf16 or float32 x, got {dt}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"qkvz is on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")

    def out(*shape):
        return torch.empty(*shape, dtype=torch.float32, device=dev)

    q, k = out(B, T, Hk, dk), out(B, T, Hk, dk)
    v, g, beta = out(B, T, Hv, dv), out(B, T, Hv), out(B, T, Hv)
    rc = _build.library().ominix_k9_prep(
        qkvz.data_ptr(), ba.data_ptr(), window.data_ptr(), conv_w.data_ptr(),
        A_log.data_ptr(), dt_bias.data_ptr(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), g.data_ptr(), beta.data_ptr(), B, T, Hk, Hv, dk, dv, K,
        int(dt == torch.bfloat16), dk ** -0.5,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "k9_prep (ominix_k9_prep)")
    _build.LAUNCHES["k9_prep"] += 1
    return q, k, v, g, beta


def k9_prep(qkvz: torch.Tensor, ba: torch.Tensor, window: torch.Tensor,
            conv_w: torch.Tensor, A_log: torch.Tensor,
            dt_bias: torch.Tensor, heads):
    """A DeltaNet layer's prologue: (q, k, v, g, beta) in float32 for the
    rule, the conv window advanced in place. A CUDA tensor launches
    k9_prep (or raises), a CPU tensor takes ``deltanet_prep_reference``."""
    if not qkvz.is_cuda:
        return deltanet_prep_reference(qkvz, ba, window, conv_w, A_log,
                                       dt_bias, heads)
    return _k9_prep(qkvz, ba, window, conv_w, A_log, dt_bias, heads)


# ---------------------------------------------------------- the decode mixer

def deltanet_decode_reference(qkvz: torch.Tensor, ba: torch.Tensor,
                              window: torch.Tensor, conv_w: torch.Tensor,
                              A_log: torch.Tensor, dt_bias: torch.Tensor,
                              state: torch.Tensor, norm_w: torch.Tensor,
                              eps: float, heads) -> torch.Tensor:
    """Plain version of ``k9_decode``: a DeltaNet layer's mixer between its
    input projections and out_proj as the layer composes it (the JAX
    block, ominix_mlx_tpu/models/deltanet.py:103-150): the prologue
    (``deltanet_prep_reference``, the window written in place), the rule
    (``gated_delta_rule_reference``, the state written in place), the
    cast of its float32 output to qkvz's type, the gated RMSNorm per value
    head over dv (``rms_norm`` with ``norm_w``) and ``* silu(z)``.
    Arguments as the prologue's, with the state [B, Hv, dk, dv] float32
    and norm_w [dv]; returns [B, T, Hv dv] (the kernel takes T = 1)."""
    B, T, _ = qkvz.shape
    q, k, v, g, beta = deltanet_prep_reference(qkvz, ba, window, conv_w,
                                               A_log, dt_bias, heads)
    z = split_qkvz_ba(qkvz, ba, heads)[3]
    out = gated_delta_rule_reference(q, k, v, g, beta, state)
    out = rms_norm(norm_w, out.to(qkvz.dtype), eps) * F.silu(z)
    return out.reshape(B, T, -1)


def _k9_decode(qkvz: torch.Tensor, ba: torch.Tensor, window: torch.Tensor,
               conv_w: torch.Tensor, A_log: torch.Tensor,
               dt_bias: torch.Tensor, state: torch.Tensor,
               norm_w: torch.Tensor, eps: float, heads,
               overlap: bool = False) -> torch.Tensor:
    """Launch ``k9_decode`` on the current stream (arguments as
    ``deltanet_decode_reference``'s at T = 1: qkvz, ba, the window, the
    taps and norm_w in one type, bf16 or float32, contiguous with 16-byte
    aligned bases; A_log, dt_bias and the state contiguous float32; the
    window and the state written in place, so a row view of a batched
    cache is taken as it is); raises for what it does not take.
    ``overlap``: launch by programmatic dependent launch, the state, the
    taps and norm_w read before the kernel ahead of it on the stream ends
    (the model's call: its projection is just before); that kernel must
    then write none of them."""
    from ominix_mlx_tpu_torch.ops import _build

    what = "k9_decode"
    Hk, Hv, dk, dv = heads
    B, T = qkvz.shape[0], qkvz.shape[1]
    dev = qkvz.device
    r = Hv // Hk if Hk > 0 and Hv % Hk == 0 else 0
    K = conv_w.shape[-1]
    if not 1 <= r <= K9_DECODE_MAX_RATIO or dk != dv \
            or dk not in K9_DECODE_DIMS or K != K9_PREP_TAPS or T != 1 \
            or not 1 <= B <= K9_MAX_GRID or Hk > K9_MAX_GRID:
        raise ValueError(f"{what} takes T = 1, dk = dv in {K9_DECODE_DIMS}, "
                         f"Hv a multiple of Hk at most "
                         f"{K9_DECODE_MAX_RATIO} times it, a conv of "
                         f"{K9_PREP_TAPS} taps and B, Hk <= {K9_MAX_GRID}; "
                         f"got T={T}, dk={dk}, dv={dv}, Hk={Hk}, Hv={Hv}, "
                         f"K={K}, B={B}")
    dt = qkvz.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} takes bf16 or float32 x, got {dt}")
    conv_dim = 2 * Hk * dk + Hv * dv
    want = {"qkvz": (qkvz, (B, 1, Hk * (2 * dk + 2 * r * dv)), dt),
            "ba": (ba, (B, 1, 2 * Hv), dt),
            "window": (window, (B, K - 1, conv_dim), dt),
            "conv_w": (conv_w, (conv_dim, K), dt),
            "norm_w": (norm_w, (dv,), dt),
            "A_log": (A_log, (Hv,), torch.float32),
            "dt_bias": (dt_bias, (Hv,), torch.float32),
            "state": (state, (B, Hv, dk, dv), torch.float32)}
    for name, (t, shp, tdt) in want.items():
        if t.dtype != tdt or tuple(t.shape) != shp or not t.is_contiguous() \
                or t.device != dev or t.data_ptr() % 16:
            raise ValueError(f"{what} {name}: want contiguous {tdt} {shp} "
                             f"on {dev} with a 16-byte aligned base, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"qkvz is on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    out = torch.empty(B, 1, Hv * dv, dtype=dt, device=dev)
    rc = _build.library().ominix_k9_decode(
        qkvz.data_ptr(), ba.data_ptr(), window.data_ptr(), conv_w.data_ptr(),
        A_log.data_ptr(), dt_bias.data_ptr(), state.data_ptr(),
        norm_w.data_ptr(), out.data_ptr(), B, Hk, Hv, dk, dv, K,
        int(dt == torch.bfloat16), dk ** -0.5, eps, int(overlap),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "k9_decode (ominix_k9_decode)")
    _build.LAUNCHES["k9_decode"] += 1
    return out


def deltanet_decode(qkvz: torch.Tensor, ba: torch.Tensor,
                    window: torch.Tensor, conv_w: torch.Tensor,
                    A_log: torch.Tensor, dt_bias: torch.Tensor,
                    state: torch.Tensor, norm_w: torch.Tensor, eps: float,
                    heads, overlap: bool = False) -> torch.Tensor:
    """A DeltaNet layer's decode mixer, [B, 1, Hv dv] (the input of
    out_proj), the window and the state advanced in place: ``k9_decode``
    on CUDA (or it raises), ``deltanet_decode_reference`` on the CPU.
    Arguments as the plain version's; ``overlap`` as ``_k9_decode``'s."""
    if not qkvz.is_cuda:
        return deltanet_decode_reference(qkvz, ba, window, conv_w, A_log,
                                         dt_bias, state, norm_w, eps, heads)
    return _k9_decode(qkvz, ba, window, conv_w, A_log, dt_bias, state,
                      norm_w, eps, heads, overlap=overlap)
