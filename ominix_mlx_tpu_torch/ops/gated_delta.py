"""The gated delta rule: the recurrence of a Gated DeltaNet layer
(``models.deltanet.block``) over T tokens from a carried state.

No TPU kernel computes it: the JAX package runs the per-token step under
``jax.lax.scan`` (ominix_mlx_tpu/models/deltanet.py:132-144), which XLA
compiles into one loop. Here a CUDA tensor launches kernel K9
(``csrc/gated_delta.cu``, the loop over T inside one launch) or raises; a
CPU tensor takes the plain version ``gated_delta_rule_reference``, that
step written out in float32 torch.

Both write the final state into ``state`` in place (the batcher's row
views carry it) and return the outputs o [B, T, Hv, dv] in float32.
"""

from __future__ import annotations

import torch

# head widths dk the kernel is built for (a thread holds dk / 4 rows)
K9_DK = (32, 64, 128, 256)
K9_MAX_GRID = 65535


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


def _k9(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
        beta: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Launch K9 on the current stream (float32 CUDA tensors, shapes as in
    ``gated_delta_rule_reference``); raises for what it does not take."""
    from ominix_mlx_tpu_torch.ops import _build

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
    o = torch.empty(B, T, Hv, dv, dtype=torch.float32, device=dev)
    rc = _build.library().ominix_gated_delta(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        beta.data_ptr(), state.data_ptr(), o.data_ptr(), B, T, Hk, Hv, dk,
        dv, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "K9 (ominix_gated_delta)")
    _build.LAUNCHES["k9"] += 1
    return o


def gated_delta_rule(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     g: torch.Tensor, beta: torch.Tensor,
                     state: torch.Tensor) -> torch.Tensor:
    """The recurrence over T tokens: o [B, T, Hv, dv] float32, ``state``
    [B, Hv, dk, dv] float32 advanced in place. A CUDA tensor launches K9
    (inputs made contiguous float32 first), a CPU tensor takes the plain
    version."""
    if not q.is_cuda:
        return gated_delta_rule_reference(q, k, v, g, beta, state)
    args = [t.float().contiguous() for t in (q, k, v, g, beta)]
    return _k9(*args, state)
