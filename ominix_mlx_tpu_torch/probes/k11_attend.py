"""Where K11's attend (csrc/sparse_attn.cu ``sparse_attend``) spends a
call, on one CUDA card, at MiniCPM-SALA's 32 query heads over 2 KV heads
of 128 and the production InfLLMv2 config (init 64, blocks of 32, top 64,
window 2048):

- ``plans``: the call timed (CUDA events, L2 evicted by a 256 MB read
  before each launch) at several (splits, merge group) plans of a row's 65
  tiles, at B = 1 over 65536 cached tokens and B = 8 at ragged totals near
  16384, beside the plan ``k11_plan`` picks;
- ``timeline``: a copy of the kernel with each CTA's thread 0 stamping
  %globaltimer at its start, when its slot positions are known, when its
  tiles are computed, when its partial is written, when it draws its
  group's last ticket and when it ends, built by nvcc into the package's
  _build/probe; per stage the earliest, median and latest CTA in us from
  the first start.

    python -m ominix_mlx_tpu_torch.probes.k11_attend

One JSON line per measurement. Needs a card, nvcc and torch only.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from ominix_mlx_tpu_torch.models.sparse_attention import (SparseConfig,
                                                          SparseKVCache,
                                                          compress_keys)
from ominix_mlx_tpu_torch.ops import _build
from ominix_mlx_tpu_torch.ops import sparse_attention as sa

# (B, cache positions, totals), as chip_smoke.py's K11_CASES
CASES = ((1, 65536, (65536,)),
         (8, 16384, (16384, 16320, 16383, 16200, 15000, 16350, 12000,
                     16384)))
# (splits, merge group) of a row's 65 tiles timed at each case
PLANS = {1: ((65, 8), (33, 8), (33, 16), (33, 128), (22, 8), (17, 128)),
         8: ((17, 8), (17, 128), (13, 8), (13, 16), (11, 16), (9, 16))}
STAGES = ("start", "positions", "computed", "written", "merge", "end")


def case(dev, B, S, totals, seed=9):
    """A sparse cache filled at random, its pooled keys, a decode query,
    the blocks selected from the plain scores: k11_attend's arguments."""
    g = torch.Generator(device=dev).manual_seed(seed)
    sc = SparseConfig()
    c = SparseKVCache.init(B, 2, S, 128, torch.bfloat16, sc.kernel_size, dev)
    c.k.normal_(generator=g)
    c.v.normal_(generator=g)
    c.comp.copy_(compress_keys(c.k, sc.kernel_size))
    q = (torch.randn(B, 32, 1, 128, generator=g, device=dev) * 0.3).bfloat16()
    total = torch.tensor(totals, dtype=torch.int32, device=dev)
    scores = sa.block_scores_reference(q, c.comp, total, sc.init_end,
                                       sc.window_size, sc.kernel_size)
    top, idx = torch.topk(scores, sc.topk, dim=-1)
    return (q, c.k, c.v, idx, top, total, sc.init_end, sc.window_size,
            sc.kernel_size, 128 ** -0.5)


def time_ms(fn, flush, iters=20):
    """Median CUDA-event time of fn, L2 evicted before each launch and a
    device spin queued ahead of it (chip_smoke.py's time_ms)."""
    fn()
    ts = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(200_000)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def launcher(lib, args, splits, group):
    """A call of the C entry at an explicit plan."""
    q, k, v, idx, top, total, ie, W, ks, scale = args
    B, H, _, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    sps = -(-65 // splits) * 64
    splits = -(-65 // (sps // 64))
    tk, acc, ml = sa._k11_buffers(q.device, B * Hkv * (1 + splits),
                                  B * Hkv * splits * 16)
    out = torch.empty(B, H, 1, D, dtype=torch.bfloat16, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream

    def call():
        rc = lib.ominix_sparse_attend(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), idx.data_ptr(),
            top.data_ptr(), total.data_ptr(), out.data_ptr(), acc.data_ptr(),
            ml.data_ptr(), tk.data_ptr(), B, H, Hkv, S, D, idx.shape[-1], ie,
            W, ks, splits, sps, group, scale, stream)
        if rc:
            raise RuntimeError(f"k11_attend: CUDA error {rc}")
        return out
    return splits, call


def timeline_library():
    """csrc/sparse_attn.cu with %globaltimer stamps (STAGES) by each CTA's
    thread 0 into a device array, and C entries to clear and read it."""
    src = (_build.CSRC / "sparse_attn.cu").read_text()
    stamp = ("if (threadIdx.x == 0) g_tl[((size_t)b * Hkv + g) * gridDim.x "
             "+ split][{}] = gtime();\n")
    marks = (("  const size_t bh0 = (size_t)b * H + h0;\n", 0, True),
             ("  const int n_tiles = (hi - lo + kTile - 1) / kTile;\n", 1,
              True),
             ("  __syncthreads();                        // the ring is free "
              "for the merge\n", 2, True),
             ("  if (used == 1) return;\n\n", 3, False),
             ("  merge_partials<D>(acc, ml, out + bh0 * D, R, first, 1,", 4,
              False))
    for anchor, i, after in marks:
        at = src.index(anchor) + (len(anchor) if after else 0)
        src = src[:at] + "  " + stamp.format(i) + src[at:]
    src = src.replace("  if (used_groups == 1) return;\n",
                      "  if (used_groups == 1) {\n    " + stamp.format(5) +
                      "    return;\n  }\n")
    end = "used_groups, true);\n}"
    src = src.replace(end, end[:-1] + "  " + stamp.format(5) + "}")
    src = src.replace("namespace {", """namespace {
__device__ unsigned long long g_tl[1 << 14][6];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}""", 1) + """
extern "C" int probe_read(void* host, int n) {
  return (int)cudaMemcpyFromSymbol(host, g_tl, (size_t)n * 6 * 8);
}
extern "C" int probe_clear() {
  static unsigned long long zero[1 << 14][6];
  return (int)cudaMemcpyToSymbol(g_tl, zero, sizeof(zero));
}
"""
    out = _build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "sparse_attn_timeline.cu").write_text(src)
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                        "-I", str(_build.CSRC), "-o",
                        str(out / "timeline.so"),
                        str(out / "sparse_attn_timeline.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(r.stderr)
    lib = ctypes.CDLL(str(out / "timeline.so"))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ominix_sparse_attend.argtypes = [vp] * 10 + [i] * 12 + [f, vp]
    lib.probe_read.argtypes = [vp, i]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    lib, tl = _build.library(), timeline_library()
    words = torch.zeros(64 << 20, dtype=torch.int32, device=dev)

    def flush():
        return words.max()

    for B, S, totals in CASES:
        args = case(dev, B, S, totals)
        plain = sa.sparse_attend_reference(*args)
        planned = sa.k11_plan(B, 2, 64 + 64 * 32 + 2048)[0]
        for splits, group in PLANS[B]:
            splits, call = launcher(lib, args, splits, group)
            got = call()
            err = ((got.float() - plain.float()).abs().amax(-1)
                   / plain.float().abs().amax(-1)).max().item()
            print(json.dumps({"probe": "plans", "B": B, "splits": splits,
                              "group": group, "planned": splits == planned,
                              "row_rel_err": err,
                              "ms": [time_ms(call, flush) for _ in range(2)],
                              "card": smi}), flush=True)
        for splits, group in ((planned, sa.K11_MERGE_GROUP), (65, 128)):
            splits, call = launcher(tl, args, splits, group)
            for _ in range(2):
                tl.probe_clear()
                call()
                flush()
                torch.cuda._sleep(200_000)
                call()
                torch.cuda.synchronize()
                n = B * 2 * splits
                t = np.zeros((n, 6), np.uint64)
                tl.probe_read(t.ctypes.data, n)
                t0 = t[:, 0].min()
                row = {"probe": "timeline", "B": B, "splits": splits,
                       "group": group, "card": smi}
                for k, name in enumerate(STAGES):
                    hit = t[:, k][t[:, k] >= t0].astype(np.float64)
                    row[name] = ([round(float(np.min(hit) - t0) / 1e3, 2),
                                  round(float(np.median(hit) - t0) / 1e3, 2),
                                  round(float(np.max(hit) - t0) / 1e3, 2)]
                                 if hit.size else None)
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
