// K5: grouped matmul over expert-sorted rows, out[r, :] = xs[r] @ W_e^T
// in float32, for bf16 xs [S, K] whose rows are sorted by expert, int32
// gs [E] (the row count of each expert's group) and the experts W [E, N, K]
// (output-major, contracted on K) in one of three forms:
//   bf16:  w bf16 [E, N, K];
//   4-bit: codes uint8 [E, N, K/2] (natural nibble order, unsigned u),
//          bf16 scales s and folded biases b' = b - 8s [E, N, K/gs];
//   8-bit: codes int8 [E, N, K] (signed q), bf16 scales and biases b.
// A packed weight is W = bf16(f32(c * s) + b) with c the stored code: the
// product exact in f32, one f32 rounding of the sum, one bf16 rounding
// (ops/quant_matmul.py _dequant_rows), so the result equals the bf16 form
// on dequantize_experts(w) bit for bit. Rows past sum(gs) are zero.
//
// Replaces the megablox grouped matmul of the TPU path
// (ominix_mlx_tpu/models/moe.py:84 _group_matmul -> gmm :100, with
// transpose_rhs=True and a float32 result); the packed forms replace the
// port's dequantize-once in front of it.
//
// What bounds it on an H100: at a long prefill operations (2 S N K on the
// tensor cores) and the f32 output; at a short one bytes (each routed
// expert's slab is read for a few rows). The design:
// - Weights as A, the group's rows of x as B: a CTA owns 128 weight rows
//   of one expert (two consumer warpgroups of 64, wgmma m64nNPk16) and up
//   to 128 rows of one group, NP = 8, 16, 32, 64, 96 or 128 wide, the least
//   that holds the tile's rows, so a group of 3 rows costs an n8 product.
// - A producer thread keeps two rings of 16 KB slots in flight with TMA:
//   x, one box of NP rows x 64 columns a step (128-byte swizzle, the
//   K-major B operand; rows past S zero-filled; rows of the next group
//   are multiplied but never stored), and the weights, 128 rows x 128
//   bytes a slot (128-byte swizzled: bf16, 64 columns, read by wgmma as A
//   from shared memory; packed, 128 or 256 columns of codes, read by the
//   lanes without bank conflicts). Slots complete on mbarriers; the
//   consumers free a slot once the products that read it retired.
// - Packed forms: an item's scales and biases (128 x K/gs each, contiguous
//   in memory) arrive by a bulk copy into one of two buffers; each lane
//   dequantizes its A fragment straight from the staged codes in natural
//   K order (a byte permute places a code in the mantissa of 2^23, one
//   FADD takes 2^23 off exactly, one FFMA forms c * s + b with the single
//   f32 rounding, one cvt packs two bf16), while the last stage's wgmma
//   run (two A buffers; the stage count is made even, a zero stage past K
//   where needed).
// - Streamed scales: where those two buffers would not leave shared memory
//   for two slots of each ring (K / gs > 153 groups: Mixtral's down
//   projection, K = 14336 at gs 64, needs 229376 bytes), nothing is
//   staged. Each lane reads the scale and bias of its two rows at each
//   new group straight from global memory (ld.global.nc: one 32-byte
//   sector holds 16 groups of a row, so 15 of 16 reads hit L1, and the
//   next sector is prefetched into L1 when a lane enters one), the rings
//   take all of shared memory, and every item runs on wgmma. Same
//   products, same roundings.
// - A persistent grid, one CTA an SM, walks the items (row tile, weight
//   tile), weight tiles fastest, so the items of one expert run together
//   and its slab comes from L2. The producer runs ahead across items, so
//   the next item's loads overlap this one's last products and stores;
//   the accumulators are stored straight to out (each warp store fills
//   32-byte runs).
// - Row tiles: group e takes ceil(gs[e] / 128) of them. A one-CTA
//   prologue scans gs on the device into row and tile offsets (no host
//   sync); an item finds its group by binary search. The rows past
//   sum(gs) are zeroed by the same launch. No split of K and no atomics:
//   bitwise repeatable.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kTileW = 128;          // weight rows an item
constexpr int kTileX = 128;          // x rows an item, at most
constexpr int kStepK = 64;           // columns a step
constexpr int kThreads = 384;        // producer + two consumer warpgroups
constexpr int kMaxSlots = 8;         // of each ring
constexpr int kSlot = 16384;         // a slot: 128 rows of 128 bytes
constexpr int kSmemMax = 232448 - 8704;  // less the static barriers, map
constexpr unsigned kFullMask = 0xffffffffu;

// A weight slot holds 128 bytes of each of 128 rows: 64 columns of bf16,
// 128 of 8-bit codes or 256 of 4-bit ones, so kSteps steps of 64 columns
// read one weight slot.
template <int FORM>
struct Form {
  static constexpr int kSteps = FORM == 16 ? 1 : FORM == 8 ? 2 : 4;
  static constexpr int kCols = FORM == 16 ? 64 : 128;   // box units a slot
};

// map[0 .. E] = row offsets (exclusive scan of gs, then the total);
// map[E + 1 .. 2E + 1] = tile offsets (scan of ceil(gs / kTileX)). One CTA
// of ceil(E / 32) * 32 threads, one group each; negative counts read as 0.
__global__ void gmm_tile_map(const int* __restrict__ gs, int E,
                             int* __restrict__ map) {
  __shared__ int wr[32], wt[32];
  const int e = threadIdx.x, lane = e & 31, warp = e >> 5;
  const int g = e < E ? max(gs[e], 0) : 0;
  const int t = (g + kTileX - 1) / kTileX;
  int r = g, tt = t;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(kFullMask, r, o);
    const int b = __shfl_up_sync(kFullMask, tt, o);
    if (lane >= o) { r += a; tt += b; }
  }
  if (lane == 31) { wr[warp] = r; wt[warp] = tt; }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int a = lane < nw ? wr[lane] : 0, b = lane < nw ? wt[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int a2 = __shfl_up_sync(kFullMask, a, o);
      const int b2 = __shfl_up_sync(kFullMask, b, o);
      if (lane >= o) { a += a2; b += b2; }
    }
    if (lane < nw) { wr[lane] = a; wt[lane] = b; }
  }
  __syncthreads();
  if (warp > 0) { r += wr[warp - 1]; tt += wt[warp - 1]; }
  if (e < E) { map[e] = r - g; map[E + 1 + e] = tt - t; }
  if (e == E - 1) { map[E] = r; map[2 * E + 1] = tt; }
}

__device__ __forceinline__ float bf16_bits(uint32_t h) {
  return __uint_as_float(h << 16);
}

__device__ __forceinline__ uint32_t lds_u16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ uint4 lds_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// The weight of code c (already under the f32 pattern of 2^23 + c + off):
// bf16 pair of fma(c, s, b) with one f32 rounding each
__device__ __forceinline__ uint32_t dq_pair(uint32_t p0, uint32_t p1,
                                            float off, float s, float b) {
  const float c0 = __uint_as_float(p0) - off;
  const float c1 = __uint_as_float(p1) - off;
  return pack_bf16(fmaf(c0, s, b), fmaf(c1, s, b));
}

// 4-bit: byte i of W holds the codes of columns c (low nibble) and c + 1
__device__ __forceinline__ uint32_t dq4(uint32_t W, int i, float s, float b) {
  const uint32_t lo = W & 0x0F0F0F0Fu, hi = (W >> 4) & 0x0F0F0F0Fu;
  const uint32_t sel = 0x7650u | (uint32_t)i;
  return dq_pair(__byte_perm(lo, 0x4B000000u, sel),
                 __byte_perm(hi, 0x4B000000u, sel), 8388608.f, s, b);
}

// 8-bit: bytes i and i + 1 of the word (XOR 0x80: q + 128) are columns c
// and c + 1
__device__ __forceinline__ uint32_t dq8(uint32_t X, int i, float s, float b) {
  return dq_pair(__byte_perm(X, 0x4B000000u, 0x7650u | (uint32_t)i),
                 __byte_perm(X, 0x4B000000u, 0x7650u | (uint32_t)(i + 1)),
                 8388736.f, s, b);
}

// What every warp of a CTA knows of the launch and of its shared memory.
struct Ctx {
  int S, N, E, G, gs, XS, WS, nk, ntn;
  uint32_t xring, wring, scales;   // shared addresses
  const unsigned short *sc, *bs;   // streamed: the scales and biases
};

// The widths of an item's x rows, and the boxes of x [S, K] a step loads
// at each: 64 columns of that many rows, 128-byte swizzled (the K-major B
// operand).
constexpr int kWidths[6] = {8, 16, 32, 64, 96, 128};
struct XMaps {
  CUtensorMap m[6];
};

// One work item: 128 weight rows (from n0) of expert e against rows
// row0 .. row0 + rows - 1 of its group.
struct Work {
  int e, row0, rows, n0;
};

// Item w: row tile w / ntn, weight tile w % ntn. False for a tile with no
// row (only where gs sums past S).
__device__ __forceinline__ bool work_of(const int* map, const Ctx& C, int w,
                                        Work& W) {
  const int* row_start = map;
  const int* tile_start = map + C.E + 1;
  const int tile = w / C.ntn;
  int lo = 0, hi = C.E - 1;  // the last group whose first tile is <= tile:
  while (lo < hi) {          // never an empty one (its successor starts at
    const int mid = (lo + hi + 1) >> 1;   // the same tile)
    if (tile_start[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  W.e = lo;
  W.row0 = row_start[lo] + (tile - tile_start[lo]) * kTileX;
  W.rows = min(min(row_start[lo + 1], C.S) - W.row0, kTileX);
  W.n0 = (w % C.ntn) * kTileW;
  return W.rows > 0;
}

// the width index of an item of `rows` rows, and kWidths[i]
__device__ __forceinline__ int width_of(int rows) {
  return rows <= 8 ? 0 : rows <= 16 ? 1 : rows <= 32 ? 2 : rows <= 64 ? 3
       : rows <= 96 ? 4 : 5;
}

__device__ __forceinline__ int width_rows(int i) {
  return i < 4 ? 8 << i : 32 * i - 32;
}

// A ring's position, walked in the same order by the producer and the
// consumers across all the items of a CTA.
struct Ring {
  int slot = 0, round = 0;
  __device__ __forceinline__ void next(int n) {
    if (++slot == n) { slot = 0; ++round; }
  }
};

// D[16 x 8] += A[16 x 16] . B[16 x 8], bf16 in, f32 accumulators, one warp
__device__ __forceinline__ void mma_bf16(float* c, const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// address of 16-byte chunk q of row r in a 128-byte-swizzled slot
__device__ __forceinline__ uint32_t swz_chunk(uint32_t slot, int r, int q) {
  return slot + r * 128 + ((q ^ (r & 7)) << 4);
}

// The two consumer warpgroups on one item at width NP: the item's nk
// steps (x from its ring every step, the weights from theirs every kSteps
// steps), then the f32 tile straight from the accumulators into out (a
// warp's store covers 32-byte runs of 8 output columns).
template <int FORM, int NP, bool STREAM>
__device__ __forceinline__ void consume(const Ctx& C, const Work& W, int it,
                                        Ring& XR, Ring& WR, uint64_t* bars,
                                        float* out) {
  constexpr int R = Form<FORM>::kSteps;
  constexpr bool kStaged = FORM != 16 && !STREAM;
  // packed weights against at most 32 rows of x: mma.sync, whose short
  // latency the next step's dequantization overlaps; else wgmma. Streamed
  // scales take wgmma at every width: with mma.sync, runs of the streamed
  // form at ring depths of 9 slots and more returned a wrong step in some
  // items (Mixtral's down projection, K = 14336), and with wgmma none did
  // at any of 43 ring depths
  constexpr bool kSync = FORM != 16 && NP <= 32 && !STREAM;
  uint64_t* xfull = bars;
  uint64_t* xempty = bars + kMaxSlots;
  uint64_t* wfull = bars + 2 * kMaxSlots;
  uint64_t* wempty = bars + 3 * kMaxSlots;
  uint64_t* sfull = bars + 4 * kMaxSlots;
  uint64_t* sempty = sfull + 2;
  const int tid = threadIdx.x - 128;            // 0 .. 255
  const int c = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g8 = lane >> 2, tq = lane & 3;
  const int r = c * 64 + warp * 16 + g8;        // rows r, r + 8 of the tile
  float acc[NP / 2];
#pragma unroll
  for (int q = 0; q < NP / 2; ++q) acc[q] = 0.f;
  const int sb = it & 1;                        // the item's scale buffer
  const uint32_t scs = C.scales + sb * 4 * kTileW * C.G;
  const uint32_t bss = scs + 2 * kTileW * C.G;
  if constexpr (kStaged) mbar_wait(sfull + sb, (it >> 1) & 1);
  // streamed: element offsets of rows r and r + 8's groups (rows past N
  // read row N - 1: their products are never stored)
  const uint32_t go0 = ((uint32_t)W.e * C.N + min(W.n0 + r, C.N - 1)) * C.G;
  const uint32_t go1 =
      ((uint32_t)W.e * C.N + min(W.n0 + r + 8, C.N - 1)) * C.G;

  int xprev = -1, wprev = -1, wcur = 0;
  // packed forms: the group of the next k16 slice, walked in order
  int gcur = 0, grem = 0, gl = -1;
  const int sl_per_g = C.gs / 16;
  float s0 = 0.f, s1 = 0.f, b0 = 0.f, b1 = 0.f;

  // step j: wait for its slots, dequantize (packed) and issue its four
  // wgmma; then retire step j - 1 (whose A buffer is `other`) and free
  // the slots only it still held
  auto step = [&](int j, unsigned (&a)[4][4], unsigned (&other)[4][4]) {
    const int sub = j % R;
    if (sub == 0) {
      mbar_wait(wfull + WR.slot, WR.round & 1);
      wcur = WR.slot;
      WR.next(C.WS);
    }
    mbar_wait(xfull + XR.slot, XR.round & 1);
    const uint32_t xs = C.xring + XR.slot * kSlot;
    const uint32_t ws = C.wring + wcur * kSlot;
    if constexpr (FORM != 16) {
      uint32_t wv[2][8];
      if constexpr (FORM == 4) {
        // a row's 32 bytes of the step (chunks 2 sub, 2 sub + 1): word j
        // holds columns 8j .. 8j + 7; this lane takes byte tq of each
        // (columns 8j + 2tq, + 1)
        const uint32_t sel = (uint32_t)tq | ((uint32_t)(tq + 4) << 4);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 p = lds_v4(swz_chunk(ws, r + 8 * h, 2 * sub));
          const uint4 q = lds_v4(swz_chunk(ws, r + 8 * h, 2 * sub + 1));
          const uint32_t w[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            wv[h][i] = __byte_perm(
                __byte_perm(w[4 * i], w[4 * i + 1], sel),
                __byte_perm(w[4 * i + 2], w[4 * i + 3], sel), 0x5410);
          }
        }
      } else {
        // a row's 64 bytes of the step (chunks 4 sub + s): slice s,
        // columns 16s + 2tq (+ 1) and + 8
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const uint32_t o = swz_chunk(ws, r + 8 * h, 4 * sub + s) +
                               4 * (tq >> 1);
            wv[h][2 * s] = lds_u32(o) ^ 0x80808080u;
            wv[h][2 * s + 1] = lds_u32(o + 8) ^ 0x80808080u;
          }
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        // past K (the steps are padded to a multiple of 4) x is zero: any
        // finite weight will do
        const int g = min(gcur, C.G - 1);
        if (g != gl) {
          gl = g;
          if constexpr (STREAM) {
            const uint32_t o0 = go0 + g, o1 = go1 + g;
            s0 = bf16_bits(__ldg(C.sc + o0));
            s1 = bf16_bits(__ldg(C.sc + o1));
            b0 = bf16_bits(__ldg(C.bs + o0));
            b1 = bf16_bits(__ldg(C.bs + o1));
            if ((g & 15) == 0 && g + 16 < C.G) {
              prefetch_l1(C.sc + o0 + 16);
              prefetch_l1(C.sc + o1 + 16);
              prefetch_l1(C.bs + o0 + 16);
              prefetch_l1(C.bs + o1 + 16);
            }
          } else {
            const uint32_t o0 = (r * C.G + g) * 2,
                           o1 = ((r + 8) * C.G + g) * 2;
            s0 = bf16_bits(lds_u16(scs + o0));
            s1 = bf16_bits(lds_u16(scs + o1));
            b0 = bf16_bits(lds_u16(bss + o0));
            b1 = bf16_bits(lds_u16(bss + o1));
          }
        }
        if (++grem == sl_per_g) { grem = 0; ++gcur; }
        if constexpr (FORM == 4) {
          // byte 2s / 2s + 1 of the gathered words: columns 16s + 2tq and
          // 16s + 8 + 2tq
          const uint32_t W0 = wv[0][s >> 1], W1 = wv[1][s >> 1];
          const int i = 2 * (s & 1);
          a[s][0] = dq4(W0, i, s0, b0);
          a[s][1] = dq4(W1, i, s1, b1);
          a[s][2] = dq4(W0, i + 1, s0, b0);
          a[s][3] = dq4(W1, i + 1, s1, b1);
        } else {
          const int i = 2 * (tq & 1);
          a[s][0] = dq8(wv[0][2 * s], i, s0, b0);
          a[s][1] = dq8(wv[1][2 * s], i, s1, b1);
          a[s][2] = dq8(wv[0][2 * s + 1], i, s0, b0);
          a[s][3] = dq8(wv[1][2 * s + 1], i, s1, b1);
        }
      }
      if constexpr (kSync) {
        // few rows of x: mma.sync m16n8k16 on each 8 of them, B read from
        // the swizzled x slot; nothing asynchronous holds a slot past the
        // step, so its slots are freed at once
#pragma unroll
        for (int s = 0; s < 4; ++s)
#pragma unroll
          for (int nb = 0; nb < NP / 8; ++nb) {
            const int xr = 8 * nb + g8;
            mma_bf16(&acc[4 * nb], a[s],
                     lds_u32(swz_chunk(xs, xr, 2 * s) + 4 * tq),
                     lds_u32(swz_chunk(xs, xr, 2 * s + 1) + 4 * tq));
          }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(xempty + XR.slot);
          if (sub == R - 1) mbar_arrive(wempty + wcur);
        }
        XR.next(C.XS);
        return;
      }
      keep(acc);
      keep(a);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        wgmma_rs_k<NP>(acc, a[s], gmma_desc(xs + s * 32, 16));
    } else {
      keep(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        wgmma_ss_k<NP>(acc, gmma_desc(ws + c * 8192 + s * 32, 16),
                       gmma_desc(xs + s * 32, 16));
    }
    wgmma_commit();
    wgmma_wait<1>();           // step j - 1 has retired
    keep(other);
    if (lane == 0) {
      if (xprev >= 0) mbar_arrive(xempty + xprev);
      if (sub == 0 && wprev >= 0) mbar_arrive(wempty + wprev);
    }
    xprev = XR.slot;
    XR.next(C.XS);
    if (sub == 0) wprev = wcur;
  };

  // two A buffers: one step is dequantized while the last one's wgmma
  // run; nk is a multiple of 4, so they alternate without a branch
  unsigned ae[4][4], ao[4][4];
  for (int j = 0; j < C.nk; j += 2) {
    step(j, ae, ao);
    step(j + 1, ao, ae);
  }
  if constexpr (!kSync) {
    wgmma_wait<0>();
    keep(acc);
    keep(ae);
    keep(ao);
    if (lane == 0) {
      mbar_arrive(xempty + xprev);
      mbar_arrive(wempty + wprev);
    }
  }
  if (kStaged && lane == 0) mbar_arrive(sempty + sb);
#pragma unroll
  for (int q = 0; q < NP / 2; ++q) {
    const int n = W.n0 + r + 8 * ((q >> 1) & 1);
    const int xr = (q >> 2) * 8 + 2 * tq + (q & 1);
    if (xr < W.rows && n < C.N)
      out[(size_t)(W.row0 + xr) * C.N + n] = acc[q];
  }
}

// A persistent grid of one CTA an SM, kThreads threads; FORM 16 (bf16),
// 4 or 8 (packed; STREAM: scales read from global memory, not staged).
// xm: the x boxes; tw: the weights [E, N, K(/2)] in
// boxes of 128 rows x 128 bytes, 128-byte swizzled. CTA b takes the items
// b, b + gridDim.x, ... of the list (row tile, weight tile), weight tiles
// fastest; its producer runs ahead across items as far as the rings let
// it.
template <int FORM, bool STREAM>
__global__ void __launch_bounds__(kThreads, 1)
gmm_kernel(const __grid_constant__ XMaps xm,
           const __grid_constant__ CUtensorMap tw,
           const __nv_bfloat16* __restrict__ sc,
           const __nv_bfloat16* __restrict__ bs, const int* __restrict__ map,
           float* __restrict__ out, int S, int N, int K, int E, int gs,
           int XS, int WS) {
  constexpr int R = Form<FORM>::kSteps;
  constexpr bool kStaged = FORM != 16 && !STREAM;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[4 * kMaxSlots + 4];
  const int tid = threadIdx.x;
  Ctx C;
  C.S = S;
  C.N = N;
  C.E = E;
  C.gs = gs;
  C.XS = XS;
  C.WS = WS;
  C.G = FORM == 16 ? 0 : K / gs;
  C.nk = ((K + kStepK - 1) / kStepK + 3) & ~3;
  C.ntn = (N + kTileW - 1) / kTileW;
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* wring = base + XS * kSlot;
  uint8_t* scales = wring + WS * kSlot;
  C.xring = smem_u32(base);
  C.wring = smem_u32(wring);
  C.scales = smem_u32(scales);
  C.sc = (const unsigned short*)sc;
  C.bs = (const unsigned short*)bs;
  // the tile map, for the items' lookups
  __shared__ int smap[2 * 1024 + 2];
  for (int i = tid; i < 2 * E + 2; i += kThreads) smap[i] = map[i];
  __syncthreads();
  const int items = smap[2 * E + 1] * C.ntn;

  // the rows past sum(gs) are zero
  const int used = max(0, min(smap[E], S));
  const size_t nzero = (size_t)(S - used) * N;
  for (size_t i = (size_t)blockIdx.x * kThreads + tid; i < nzero;
       i += (size_t)gridDim.x * kThreads)
    out[(size_t)used * N + i] = 0.f;
  if (blockIdx.x >= items) return;

  uint64_t* xfull = bars;
  uint64_t* xempty = bars + kMaxSlots;
  uint64_t* wfull = bars + 2 * kMaxSlots;
  uint64_t* wempty = bars + 3 * kMaxSlots;
  uint64_t* sfull = bars + 4 * kMaxSlots;
  uint64_t* sempty = sfull + 2;
  if (tid == 0) {
    for (int s = 0; s < kMaxSlots; ++s) {
      mbar_init(xfull + s, 1);
      mbar_init(xempty + s, 8);       // one arrival per consumer warp
      mbar_init(wfull + s, 1);
      mbar_init(wempty + s, 8);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(sfull + b, 1);
      mbar_init(sempty + b, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  Ring XR, WR;
  int it = 0;                         // the CTA's items so far
  if (tid < 128) {                    // producer: one thread issues copies
    // registers go to the consumers (40 x 128 + 232 x 256 <= 64 K)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid != 0) return;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      Work W;
      if (!work_of(smap, C, w, W)) continue;
      const int wi = width_of(W.rows);
      if constexpr (kStaged) {
        const int sb = it & 1;
        if (it >= 2) mbar_wait(sempty + sb, ((it >> 1) - 1) & 1);
        const uint32_t bytes = (uint32_t)min(kTileW, N - W.n0) * C.G * 2;
        const size_t off = ((size_t)W.e * N + W.n0) * C.G;
        uint8_t* sp = scales + sb * 4 * kTileW * C.G;
        mbar_expect_tx(sfull + sb, 2 * bytes);
        bulk_load(sp, sc + off, bytes, sfull + sb);
        bulk_load(sp + 2 * kTileW * C.G, bs + off, bytes, sfull + sb);
      }
      for (int j = 0; j < C.nk; ++j) {
        if (j % R == 0) {
          if (WR.round > 0) mbar_wait(wempty + WR.slot, (WR.round - 1) & 1);
          mbar_expect_tx(wfull + WR.slot, kSlot);
          tma_load_3d(wring + WR.slot * kSlot, &tw, wfull + WR.slot,
                      (j / R) * Form<FORM>::kCols, W.n0, W.e);
          WR.next(WS);
        }
        if (XR.round > 0) mbar_wait(xempty + XR.slot, (XR.round - 1) & 1);
        mbar_expect_tx(xfull + XR.slot, 128 * width_rows(wi));
        tma_load_2d(base + XR.slot * kSlot, &xm.m[wi], xfull + XR.slot,
                    kStepK * j, W.row0);
        XR.next(XS);
      }
      ++it;
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  for (int w = blockIdx.x; w < items; w += gridDim.x) {
    Work W;
    if (!work_of(smap, C, w, W)) continue;
    switch (width_of(W.rows)) {
      case 0: consume<FORM, 8, STREAM>(C, W, it, XR, WR, bars, out);
        break;
      case 1: consume<FORM, 16, STREAM>(C, W, it, XR, WR, bars, out);
        break;
      case 2: consume<FORM, 32, STREAM>(C, W, it, XR, WR, bars, out);
        break;
      case 3: consume<FORM, 64, STREAM>(C, W, it, XR, WR, bars, out);
        break;
      case 4: consume<FORM, 96, STREAM>(C, W, it, XR, WR, bars, out);
        break;
      default: consume<FORM, 128, STREAM>(C, W, it, XR, WR, bars, out);
    }
    ++it;
  }
}

// a tensor map of `dims` (innermost first) with byte strides of the outer
// dimensions, boxes `box` of 128-byte rows, 128-byte swizzled
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
              int rank, const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, type, rank, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int FORM>
int launch(const void* xs, const void* w, const void* sc, const void* bs,
           const int* counts, int* map, float* out, int S, int N, int K,
           int E, int gs, int XS, int WS, cudaStream_t st) {
  const int G = FORM == 16 ? 0 : K / gs;
  // the scales stream where staging them would not fit beside the rings
  const int rings = 1024 + (XS + WS) * kSlot;
  const bool stream = rings + 8 * kTileW * G > kSmemMax;
  const int smem = stream ? rings : rings + 8 * kTileW * G;
  if (XS < 2 || XS > kMaxSlots || WS < 2 || WS > kMaxSlots ||
      smem > kSmemMax || (stream && (long long)E * N * G >= (1LL << 32)))
    return (int)cudaErrorInvalidValue;
  XMaps xm;
  CUtensorMap tw;
  const cuuint64_t xd[2] = {(cuuint64_t)K, (cuuint64_t)S};
  const cuuint64_t xstr[1] = {(cuuint64_t)K * 2};
  for (int l = 0; l < 6; ++l) {
    const cuuint32_t xbox[2] = {kStepK, (cuuint32_t)kWidths[l]};
    if (!make_map(&xm.m[l], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xs, 2, xd,
                  xstr, xbox))
      return (int)cudaErrorInvalidValue;
  }
  const int esz = FORM == 16 ? 2 : 1;
  const int kd = FORM == 4 ? K / 2 : K;      // inner extent in elements
  const cuuint64_t wd[3] = {(cuuint64_t)kd, (cuuint64_t)N, (cuuint64_t)E};
  const cuuint64_t wstr[2] = {(cuuint64_t)kd * esz,
                              (cuuint64_t)kd * esz * N};
  const cuuint32_t wbox[3] = {(cuuint32_t)Form<FORM>::kCols, kTileW, 1};
  if (!make_map(&tw, FORM == 16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                w, 3, wd, wstr, wbox))
    return (int)cudaErrorInvalidValue;
  // set on every launch: the limit is per device, and cheap to set
  auto kernel = gmm_kernel<FORM, false>;
  if constexpr (FORM != 16)
    if (stream) kernel = gmm_kernel<FORM, true>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return (int)cudaGetLastError();
  gmm_tile_map<<<1, (E + 31) / 32 * 32, 0, st>>>(counts, E, map);
  kernel<<<sms, kThreads, smem, st>>>(
      xm, tw, (const __nv_bfloat16*)sc, (const __nv_bfloat16*)bs, map, out,
      S, N, K, E, gs, XS, WS);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K5 on `stream`: the tile map (scratch int32 [2 * (E + 1)] from
// the caller) then the tiles. bits = 16: w bf16 [E, N, K] (scales, biases
// and gs unused); 4 or 8: packed codes with bf16 scales and biases
// [E, N, K / gs]. x_slots and w_slots are the depths (2 .. 8) of the x
// and weight rings the caller planned; packed scales and biases are
// staged in shared memory where 8 * 128 * K / gs bytes fit beside the
// rings, and read from global memory otherwise.
// Needs E <= 1024 and K % 8 == 0; packed: K % 32 == 0, gs % 32 == 0,
// K % gs == 0 and N % 8 == 0. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape or plan the kernel does not take.
int ominix_grouped_mm(const void* xs, const void* w, const void* scales,
                      const void* biases, const void* counts, void* out,
                      void* tile_map, int S, int N, int K, int E, int gs,
                      int bits, int x_slots, int w_slots, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (S < 1 || N < 1 || K < 8 || K % 8 || E < 1 || E > 1024)
    return (int)cudaErrorInvalidValue;
  const int* c = (const int*)counts;
  int* m = (int*)tile_map;
  float* o = (float*)out;
  if (bits == 16)
    return launch<16>(xs, w, nullptr, nullptr, c, m, o, S, N, K, E, 1,
                      x_slots, w_slots, st);
  if (K % 32 || gs < 32 || gs % 32 || K % gs || N % 8)
    return (int)cudaErrorInvalidValue;
  if (bits == 4)
    return launch<4>(xs, w, scales, biases, c, m, o, S, N, K, E, gs, x_slots,
                     w_slots, st);
  if (bits == 8)
    return launch<8>(xs, w, scales, biases, c, m, o, S, N, K, E, gs, x_slots,
                     w_slots, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
