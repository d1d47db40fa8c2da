"""Grouped matmul over expert-sorted rows (counterpart of
ominix_mlx_tpu/models/moe.py ``_group_matmul``, which calls the Pallas
megablox ``gmm`` with ``transpose_rhs=True`` on the TPU).

``grouped_matmul(xs, w, gs)``: the rows of xs [S, K] are sorted by expert
and gs [E] gives each expert's row count; row r of group e is multiplied
by W_e [N, K] (the HF output-major layout, contracted on its last axis).
The result is float32 [S, N]; rows past the sum of gs are zero. ``w`` is
bf16 [E, N, K], or 4- or 8-bit ``PackedQuantizedExperts``, whose W_e is
exactly ``dequantize_expert(w, e)`` (the experts are read packed; no bf16
copy is made). A CUDA tensor launches kernel K5 (``csrc/grouped_mm.cu``)
or raises; a CPU tensor takes the plain version
``grouped_matmul_reference``.
"""

from __future__ import annotations

import dataclasses

import torch

from ominix_mlx_tpu_torch.ops.quant_matmul import (PackedQuantizedExperts,
                                                   dequantize_expert)

# K5's items (csrc/grouped_mm.cu): 128 weight rows against up to 128 rows
# of one group, at a width of 8, 16, 32, 64, 96 or 128 rows. Two rings of
# 16 KB slots feed them: x, 64 columns of up to 128 rows a slot, and the
# weights, 128 bytes of each of 128 rows a slot (64 columns of bf16, 128
# of 8-bit codes, 256 of 4-bit ones); packed forms add two buffers of an
# item's scales and biases where those leave room for two slots of each
# ring, and otherwise read them from global memory ("streamed", any K).
# The block may use 232448 bytes of shared memory, less the kernel's
# static barriers and tile map.
K5_TILE = 128
K5_WIDTHS = (8, 16, 32, 64, 96, 128)
K5_MAX_SLOTS = 8
K5_SLOT = 16384
K5_SMEM_MAX = 232448 - 8704
LAUNCH_KEYS = {16: "k5", 4: "k5_w4", 8: "k5_w8"}


@dataclasses.dataclass(frozen=True)
class K5Plan:
    """Ring depths and dynamic shared memory of one K5 launch; ``stream``:
    packed scales and biases read from global memory, not staged (the
    kernel decides the same from K, the group size and the depths)."""

    x_slots: int
    w_slots: int
    smem: int
    stream: bool = False


def k5_plan(K: int, bits: int = 16, gs: int = 0) -> K5Plan:
    """As many 16 KB slots (at most 8 a ring) as fit shared memory beside
    the two buffers of an item's scales and biases (packed forms: 128 x
    K/gs of each) and the 1024-byte alignment slack, half of them (at
    most 8) for the weights, the rest for x. Where those buffers leave
    fewer than two slots a ring (K/gs > 153), the scales stream and the
    rings take all of it."""
    side = 0 if bits == 16 else 8 * K5_TILE * (K // gs)
    stream = (K5_SMEM_MAX - 1024 - side) // K5_SLOT < 4
    if stream:
        side = 0
    slots = (K5_SMEM_MAX - 1024 - side) // K5_SLOT
    w = min(K5_MAX_SLOTS, slots // 2)
    x = min(K5_MAX_SLOTS, slots - w)
    return K5Plan(x, w, 1024 + (x + w) * K5_SLOT + side, stream)


def grouped_matmul_reference(xs: torch.Tensor, w, gs: torch.Tensor
                             ) -> torch.Tensor:
    """Plain version of K5: one float32 ``torch.matmul`` per group. Packed
    experts are dequantized one at a time, only those that have rows
    (``dequantize_expert``), so the result equals the bf16 form on
    ``dequantize_experts(w)`` bit for bit. Rows past the sum of gs are
    zero."""
    S = xs.shape[0]
    packed = isinstance(w, PackedQuantizedExperts)
    N = w.data.shape[1] if packed else w.shape[1]
    out = torch.zeros(S, N, dtype=torch.float32, device=xs.device)
    start = 0
    for e, n in enumerate(gs.tolist()):
        if n:
            we = dequantize_expert(w, e) if packed else w[e]
            out[start:start + n] = xs[start:start + n].float() @ we.float().T
        start += n
    return out


def _check(what: str, name: str, t: torch.Tensor, dt, shape, dev):
    if t.dtype != dt or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.device != dev:
        raise ValueError(f"{what} {name}: want contiguous {dt} "
                         f"{tuple(shape)} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} {name}: needs a 16-byte aligned base")


def _k5(xs: torch.Tensor, w, gs: torch.Tensor) -> torch.Tensor:
    """Launch K5 on the current stream: bf16 xs [S, K], int32 gs [E] and
    the experts (bf16 [E, N, K] or packed), all on CUDA -> float32 [S, N];
    launch key "k5", "k5_w4" or "k5_w8". The tile map is built on the
    device from gs; nothing here waits for the device."""
    from ominix_mlx_tpu_torch.ops import _build

    if xs.dim() != 2:
        raise ValueError(f"K5 xs: want [S, K], got {tuple(xs.shape)}")
    S, K = xs.shape
    dev = xs.device
    packed = isinstance(w, PackedQuantizedExperts)
    bits = w.bits if packed else 16
    what = "K5" if bits == 16 else f"K5 {bits}-bit"
    E, N = (w.data.shape[0], w.data.shape[1]) if packed else \
        (w.shape[0], w.shape[1])
    _check(what, "xs", xs, torch.bfloat16, (S, K), dev)
    _check(what, "gs", gs, torch.int32, (E,), dev)
    if K % 8 or not 1 <= E <= 1024 or S < 1 or N < 1 \
            or (-(-S // K5_TILE) + E) * -(-N // K5_TILE) >= 2 ** 31:
        raise ValueError(f"{what} takes K a multiple of 8, 1 <= E <= 1024 "
                         f"and fewer than 2^31 items, got K={K}, E={E}, "
                         f"S={S}, N={N}")
    gsz = 1
    if packed:
        gsz = w.group_size
        if bits not in (4, 8) or w.in_features != K or K % 32 or gsz % 32 \
                or K % gsz or N % 8:
            raise ValueError(f"{what} takes 4- or 8-bit experts with K "
                             f"and the group size multiples of 32 and N a "
                             f"multiple of 8; xs has K={K}, the experts "
                             f"{bits}-bit, K={w.in_features}, N={N}, group "
                             f"{gsz}")
        G = K // gsz
        dt, kd = (torch.uint8, K // 2) if bits == 4 else (torch.int8, K)
        _check(what, "data", w.data, dt, (E, N, kd), dev)
        _check(what, "scales", w.scales, torch.bfloat16, (E, N, G), dev)
        _check(what, "biases", w.biases, torch.bfloat16, (E, N, G), dev)
        wd, sc, bs = w.data, w.scales.data_ptr(), w.biases.data_ptr()
    else:
        _check(what, "w", w, torch.bfloat16, (E, N, K), dev)
        wd, sc, bs = w, None, None
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"xs is on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    plan = k5_plan(K, bits, gsz)
    lib = _build.library()
    out = torch.empty(S, N, dtype=torch.float32, device=dev)
    tile_map = torch.empty(2 * (E + 1), dtype=torch.int32, device=dev)
    rc = lib.ominix_grouped_mm(
        xs.data_ptr(), wd.data_ptr(), sc, bs, gs.data_ptr(), out.data_ptr(),
        tile_map.data_ptr(), S, N, K, E, gsz, bits, plan.x_slots,
        plan.w_slots, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, f"{what} (ominix_grouped_mm)")
    _build.LAUNCHES[LAUNCH_KEYS[bits]] += 1
    return out


def grouped_matmul(xs: torch.Tensor, w, gs: torch.Tensor) -> torch.Tensor:
    """xs [S, K] sorted by expert, w bf16 [E, N, K] or packed experts, gs
    [E] row counts -> float32 [S, N]. On CUDA xs must be bf16 (and bf16
    experts too); gs is cast to int32 on the device. The packed experts'
    ``act_bits`` does not enter: the product is exact against their
    dequantized bf16 weights."""
    if not xs.is_cuda:
        return grouped_matmul_reference(xs, w, gs)
    if not isinstance(w, PackedQuantizedExperts):
        w = w.contiguous()
    return _k5(xs.contiguous(), w, gs.to(torch.int32).contiguous())
