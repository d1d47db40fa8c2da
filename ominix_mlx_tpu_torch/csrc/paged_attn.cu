// K3: paged decode attention (one query token per row over a paged KV pool).
//
// Replaces the TPU kernel _pa_kernel in ominix_mlx_tpu/ops/paged_attention.py
// (launched by _paged_decode_call). q [B, H, D] bf16; k_pool and v_pool
// [P, Hkv, page_size, D], bf16 pages or int8 codes with f32 per-token
// scales k_scale / v_scale [P, Hkv, page_size]; page_table [B, MP] int32
// (page 0 is the null page); lengths [B] int32, the valid tokens of each
// row counting this step's; out [B, H, D] bf16. window > 0 keeps only the
// last `window` positions of each row. The int8 mode follows the TPU
// kernel's formula: scores times the key's scale, and each probability
// times the value's scale before the AV sum (the softmax denominator stays
// unscaled). Table entries past a row's length are never read.
//
// What bounds it on an H100: bytes. Each row streams its K and V once
// (2 * len * Hkv * D elements) and does 4 * G FLOPs per element read, far
// below the card's ratio of operations to bytes, so the design is about
// keeping every SM streaming:
//   * split-KV (flash-decoding): the grid runs over (split, KV head and
//     query-head group, row); a split is a fixed run of `pps` whole pages,
//     chosen on the host from shapes alone (ops/paged_attention.py
//     k3_plan), so one long row spreads over many SMs. A CTA holds all
//     R <= 8 query heads of its KV head, so K and V are read once. A split
//     past the row's length, or wholly before the window, exits at once.
//     With one split the CTA writes the output; otherwise it writes a
//     float32 partial (row max m in log2 units, denominator l, numerator
//     acc[D]) and a second small kernel merges a row's partials in split
//     order, never in arrival order, so a greedy decode repeats bit for
//     bit;
//   * a CTA-wide ring of 64-key tiles (3 stages for bf16 pages, 4 for
//     int8), each thread copying 16-byte pieces of K and V rows with
//     cp.async, whole tiles in flight ahead of the one being computed;
//     rows are gathered one by one through the page table, so any page
//     size works, and rows outside the row's range are zero-filled (one
//     bulk copy a row, completing on an mbarrier, measured slower: 128-
//     and 256-byte copies are too small for the copy engine);
//   * scores and P.V on the tensor cores (mma.sync m16n8k16, bf16 in, f32
//     accumulators): q's R rows are the A operand (rows R..15 zero), each
//     of the 4 warps takes 16 keys of the tile; K and V are read with
//     ldmatrix from rows stored with their 16-byte pieces XOR-swizzled by
//     the row, so 8 rows at one piece fall on 8 distinct bank groups. int8
//     codes are
//     widened to bf16 in shared memory first (exact: |c| <= 128); the key's
//     scale multiplies the f32 score, the value's scale the probability
//     (rounded to bf16 for the P.V product, as the plain version rounds its
//     softmax weights). The 1/sqrt(D) scale stays in f32.
// Each warp keeps an online softmax per query row; the 4 warps merge
// through shared memory at the end of the split in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;         // keys a tile, 16 a warp
constexpr int kRowsMax = 8;       // query rows a CTA (the mma's rows 0..7)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// 16-byte (or 4-byte) asynchronous copy global -> shared; src_bytes 0
// zero-fills the destination without reading (the source stays a valid
// address).
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += A (16 x 16, rows 8..15 zero: a1 = a3 = 0) . B (16 x 8), bf16 in,
// f32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], uint32_t a0, uint32_t a2,
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// 4 int8 codes -> 4 bf16, exactly: each code c goes into the mantissa of
// 2^23 as c + 128, an exact FADD takes 2^23 + 128 off, and the float's
// upper half is bf16(c) (|c| <= 128 needs 8 significant bits).
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
           8388736.f;
  return make_uint2(
      __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
      __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// byte offset of 16-byte piece c of row r in a bf16 tile [kTile][D]: the
// piece index's low 3 bits are XORed with the row's, so 8 consecutive rows
// at one piece fall on 8 distinct bank groups
template <int D>
__device__ __forceinline__ int at(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
}

// Shared-memory plan of one (D, KV) instance, in bytes: the ring's stages
// (K rows, V rows; int8: the tile's key and value scales) and the int8
// codes widened to bf16.
template <int D, typename KV>
struct Plan {
  static constexpr bool kQuant = sizeof(KV) == 1;
  static constexpr int kRowBytes = D * (int)sizeof(KV);     // a row as stored
  static constexpr int kPieces = kRowBytes / 16;            // 16 B a piece
  static constexpr int kSide = kTile * kRowBytes;           // K or V of a tile
  static constexpr int kStage = 2 * kSide + (kQuant ? 2 * kTile * 4 : 0);
  static constexpr int kStages = kQuant ? (D <= 128 ? 4 : 3)
                                        : (D <= 128 ? 3 : 2);
  static constexpr int kWide = kQuant ? 2 * kTile * D * 2 : 0;  // bf16 K, V
  static constexpr int kMerge = kWarps * kRowsMax * (D + 2) * 4;
  static constexpr int kRing = kStages * kStage + kWide;
  static constexpr size_t kBytes = kRing > kMerge ? kRing : kMerge;
  static constexpr int kCopies = kTile * kPieces / kThreads;  // a thread's
  static_assert(kTile * kPieces % kThreads == 0, "copy split");
};

// One CTA per (split, KV head j and group z of R query heads, row b).
template <int D, typename KV>
__global__ void __launch_bounds__(kThreads)
paged_decode(const __nv_bfloat16* __restrict__ q,
             const KV* __restrict__ k_pool, const KV* __restrict__ v_pool,
             const float* __restrict__ k_scale,
             const float* __restrict__ v_scale,
             const int* __restrict__ table, const int* __restrict__ lengths,
             __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc,
             float* __restrict__ part_ml, int H, int Hkv, int R, int ps,
             int ps_shift, int MP, int pps, int window, float scale) {
  using P = Plan<D, KV>;
  constexpr bool kQuant = P::kQuant;
  extern __shared__ __align__(128) unsigned char smem[];
  const int split = blockIdx.x, splits = gridDim.x, b = blockIdx.z;
  const int groups = (H / Hkv) / R;
  const int j = blockIdx.y / groups;
  const int h0 = j * (H / Hkv) + (blockIdx.y % groups) * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;   // the mma's row and column pair

  const int len = min(lengths[b], MP * ps);
  const int start = window > 0 ? max(len - window, 0) : 0;
  const int s_begin = split * pps * ps;
  const int lo = max(s_begin, start);
  const int hi = min(s_begin + pps * ps, len);
  const size_t bh0 = (size_t)b * H + h0;     // (row, first query head)
  if (lo >= hi) {                            // nothing of this row here
    if (splits > 1 && tid < R) {
      part_ml[((bh0 + tid) * splits + split) * 2] = -INFINITY;
      part_ml[((bh0 + tid) * splits + split) * 2 + 1] = 0.f;
    }
    return;
  }
  const int t_first = s_begin + ((lo - s_begin) / kTile) * kTile;
  const int n_tiles = (hi - t_first + kTile - 1) / kTile;
  const int* trow = table + (size_t)b * MP;

  // pool row (token t of this KV head) for lo <= t < hi
  auto row_of = [&](int t) -> size_t {
    const int pg = ps_shift >= 0 ? t >> ps_shift : t / ps;
    return ((size_t)trow[pg] * Hkv + j) * ps + (t - pg * ps);
  };
  auto stage = [&](int s) { return smem + (size_t)s * P::kStage; };
  // queue the copies of tile i into stage s: keys outside [lo, hi) are
  // zero-filled from a clamped, valid row
  auto issue = [&](int i, int s) {
    unsigned char* st = stage(s);
    const int t0 = t_first + i * kTile;
    const unsigned ks = smem_u32(st), vs = ks + P::kSide;
#pragma unroll
    for (int k = 0; k < P::kCopies; ++k) {
      const int idx = tid + k * kThreads;
      const int r = idx / P::kPieces, c = idx % P::kPieces, t = t0 + r;
      const int n = t >= lo && t < hi ? 16 : 0;
      const size_t off = row_of(min(max(t, lo), hi - 1)) * P::kRowBytes +
                         c * 16;
      const int dst = kQuant ? r * P::kRowBytes + c * 16 : at<D>(r, c);
      cp_async16(ks + dst, (const unsigned char*)k_pool + off, n);
      cp_async16(vs + dst, (const unsigned char*)v_pool + off, n);
    }
    if constexpr (kQuant) {
      const int key = tid % kTile, t = t0 + key;
      const size_t si = row_of(min(max(t, lo), hi - 1));
      cp_async4(smem_u32(st + 2 * P::kSide + tid * 4),
                (tid < kTile ? k_scale : v_scale) + si,
                t >= lo && t < hi ? 4 : 0);
    }
    cp_async_commit();
  };

  // q's rows as the mma's A operand (rows >= R and 8..15 are zero): per
  // 16-column step, (row g, columns 2t4, 2t4+1) and (g, 2t4+8, 2t4+9)
  uint32_t qa[D / 16][2];
  {
    const uint32_t* qr =
        reinterpret_cast<const uint32_t*>(q + (bh0 + g) * D);
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
      qa[s][0] = g < R ? qr[8 * s + t4] : 0u;
      qa[s][1] = g < R ? qr[8 * s + 4 + t4] : 0u;
    }
  }
  const float qk = scale * kLog2e;     // scores in log2 units, f32

  float o[D / 8][4], m_run = -INFINITY, l_run = 0.f;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

#pragma unroll
  for (int s = 0; s < P::kStages - 1; ++s) {
    if (s < n_tiles) issue(s, s);
    else cp_async_commit();
  }
  unsigned char* wide = smem + (size_t)P::kStages * P::kStage;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<P::kStages - 2>();      // tile i has landed
    __syncthreads();                      // ... for every thread; tile i-1
                                          // is consumed by every warp
    if (i + P::kStages - 1 < n_tiles)
      issue(i + P::kStages - 1, (i + P::kStages - 1) % P::kStages);
    else
      cp_async_commit();
    unsigned char* st = stage(i % P::kStages);
    unsigned char* kt = st;
    if constexpr (kQuant) {               // widen the codes to bf16 tiles
      constexpr int kN = 2 * kTile * D / 16;
      for (int idx = tid; idx < kN; idx += kThreads) {
        const int half = idx / (kTile * D / 16), rem = idx % (kTile * D / 16);
        const int r = rem / (D / 16), c = rem % (D / 16);
        const uint4 w = *reinterpret_cast<const uint4*>(
            st + half * P::kSide + r * D + c * 16);
        const uint2 a = widen4(w.x), bb = widen4(w.y), cc = widen4(w.z),
                    d = widen4(w.w);
        unsigned char* dst = wide + half * (kTile * D * 2);
        *reinterpret_cast<uint4*>(dst + at<D>(r, 2 * c)) =
            make_uint4(a.x, a.y, bb.x, bb.y);
        *reinterpret_cast<uint4*>(dst + at<D>(r, 2 * c + 1)) =
            make_uint4(cc.x, cc.y, d.x, d.y);
      }
      kt = wide;
      __syncthreads();
    }
    const unsigned kb = smem_u32(kt);
    const unsigned vb = kb + kTile * D * 2;
    const int t0 = t_first + i * kTile;

    // S = q . K^T over this warp's 16 keys (two n8 tiles), even and odd
    // 16-column steps in separate accumulators (two chains in flight)
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      float sd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      const int r = 16 * warp + (lane >> 4) * 8 + (lane & 7);
      const int h = (lane >> 3) & 1;
#pragma unroll
      for (int s = 0; s < D / 16; s += 2) {
        uint32_t f[4], e[4];
        ldsm_x4(kb + at<D>(r, 2 * s + h), f);
        ldsm_x4(kb + at<D>(r, 2 * s + 2 + h), e);
        mma(sc[0], qa[s][0], qa[s][1], f[0], f[1]);
        mma(sc[1], qa[s][0], qa[s][1], f[2], f[3]);
        mma(sd[0], qa[s + 1][0], qa[s + 1][1], e[0], e[1]);
        mma(sd[1], qa[s + 1][0], qa[s + 1][1], e[2], e[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        sc[n][0] += sd[n][0];
        sc[n][1] += sd[n][1];
      }
    }
    // online softmax of row g over the 4 keys this thread holds
    const float* kscale =
        reinterpret_cast<const float*>(st + 2 * P::kSide);
    float x[2][2], mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 16 * warp + 8 * n + 2 * t4 + e, t = t0 + key;
        float v = sc[n][e] * qk;
        if constexpr (kQuant) v *= kscale[key];
        x[n][e] = t >= lo && t < hi ? v : -INFINITY;
        mx = fmaxf(mx, x[n][e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = m_new == -INFINITY ? 1.f : exp2f(m_run - m_new);
    float pv[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = x[n][e] == -INFINITY ? 0.f : exp2f(x[n][e] - m_new);
        l_run = n + e == 0 ? fmaf(l_run, alpha, p) : l_run + p;
        pv[n][e] = p;
        if constexpr (kQuant)
          pv[n][e] *= kscale[kTile + 16 * warp + 8 * n + 2 * t4 + e];
      }
    }
    m_run = m_new;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      o[d][0] *= alpha;
      o[d][1] *= alpha;
    }
    // O += P . V over the same 16 keys (one k16 step)
    const uint32_t pa0 = pack_bf16(pv[0][0], pv[0][1]);
    const uint32_t pa2 = pack_bf16(pv[1][0], pv[1][1]);
    {
      const int r = 16 * warp + ((lane >> 3) & 1) * 8 + (lane & 7);
      const int h = lane >> 4;
#pragma unroll
      for (int c = 0; c < D / 8; c += 2) {
        uint32_t f[4];
        ldsm_x4_t(vb + at<D>(r, c + h), f);
        mma(o[c], pa0, pa2, f[0], f[1]);
        mma(o[c + 1], pa0, pa2, f[2], f[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                        // the ring is free for the merge

  // merge the warps' softmaxes (the ring's memory is reused)
  l_run += __shfl_xor_sync(kFull, l_run, 1);
  l_run += __shfl_xor_sync(kFull, l_run, 2);
  float* red_acc = reinterpret_cast<float*>(smem);      // [warp][row][D]
  float* red_ml = red_acc + kWarps * kRowsMax * D;      // [warp][row][2]
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    red_acc[(warp * kRowsMax + g) * D + 8 * d + 2 * t4] = o[d][0];
    red_acc[(warp * kRowsMax + g) * D + 8 * d + 2 * t4 + 1] = o[d][1];
  }
  if (t4 == 0) {
    red_ml[(warp * kRowsMax + g) * 2] = m_run;
    red_ml[(warp * kRowsMax + g) * 2 + 1] = l_run;
  }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      m = fmaxf(m, red_ml[(w * kRowsMax + r) * 2]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = red_ml[(w * kRowsMax + r) * 2];
      const float f = mw == -INFINITY ? 0.f : exp2f(mw - m);
      num = fmaf(f, red_acc[(w * kRowsMax + r) * D + d], num);
      den = fmaf(f, red_ml[(w * kRowsMax + r) * 2 + 1], den);
    }
    if (splits == 1) {
      out[(bh0 + r) * D + d] = __float2bfloat16(num / den);
    } else {
      const size_t pi = (bh0 + r) * splits + split;
      part_acc[pi * D + d] = num;
      if (d == 0) {
        part_ml[pi * 2] = m;
        part_ml[pi * 2 + 1] = den;
      }
    }
  }
}

// out[b, h] from the row's partials, in split order; empty splits (m =
// -inf) are skipped. One CTA per (row, query head), a thread per dim; the
// splits' (m, l) are staged in shared memory first, and the numerators
// are loaded 8 splits at a time so their latencies overlap.
__global__ void paged_merge(const float* __restrict__ part_acc,
                            const float* __restrict__ part_ml,
                            __nv_bfloat16* __restrict__ out, int splits) {
  extern __shared__ float ml[];             // [splits][2]
  const size_t bh = blockIdx.x;
  const int D = blockDim.x, d = threadIdx.x;
  for (int i = d; i < 2 * splits; i += D) ml[i] = part_ml[bh * splits * 2 + i];
  __syncthreads();
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, ml[2 * s]);
  const float* acc = part_acc + bh * splits * D + d;
  float num = 0.f, den = 0.f;
  for (int s0 = 0; s0 < splits; s0 += 8) {
    float a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = s0 + i < splits && ml[2 * (s0 + i)] != -INFINITY
                 ? acc[(size_t)(s0 + i) * D] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = s0 + i;
      if (s >= splits || ml[2 * s] == -INFINITY) continue;
      const float f = exp2f(ml[2 * s] - m);
      num = fmaf(f, a[i], num);
      den = fmaf(f, ml[2 * s + 1], den);
    }
  }
  out[bh * D + d] = __float2bfloat16(num / den);
}

struct Args {
  const void *q, *kp, *vp, *ksc, *vsc, *table, *lengths;
  void *out, *part_acc, *part_ml;
  int B, H, Hkv, R, ps, MP, pps, splits, window;
  float scale;
};

template <int D, typename KV>
int launch(const Args& a, cudaStream_t st) {
  constexpr size_t smem = Plan<D, KV>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      paged_decode<D, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int ps_shift = (a.ps & (a.ps - 1)) == 0 ? __builtin_ctz(a.ps) : -1;
  const dim3 grid(a.splits, a.Hkv * ((a.H / a.Hkv) / a.R), a.B);
  paged_decode<D, KV><<<grid, kThreads, smem, st>>>(
      (const __nv_bfloat16*)a.q, (const KV*)a.kp, (const KV*)a.vp,
      (const float*)a.ksc, (const float*)a.vsc, (const int*)a.table,
      (const int*)a.lengths, (__nv_bfloat16*)a.out, (float*)a.part_acc,
      (float*)a.part_ml, a.H, a.Hkv, a.R, a.ps, ps_shift, a.MP, a.pps,
      a.window, a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return (int)e;
  paged_merge<<<a.B * a.H, D, 2 * a.splits * sizeof(float), st>>>(
      (const float*)a.part_acc, (const float*)a.part_ml,
      (__nv_bfloat16*)a.out, a.splits);
  return (int)cudaGetLastError();
}

template <typename KV>
int by_dim(int D, const Args& a, cudaStream_t st) {
  switch (D) {
    case 64: return launch<64, KV>(a, st);
    case 128: return launch<128, KV>(a, st);
    case 256: return launch<256, KV>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// rows_per_cta: query heads per CTA (1, 2, 4 or 8, dividing H / Hkv).
// quant != 0: int8 pools with k_scale / v_scale; else bf16 pools. The
// sequence is cut into `splits` runs of `pages_per_split` pages (the
// plan of ops/paged_attention.py k3_plan); with more than one split,
// part_acc [B, H, splits, D] and part_ml [B, H, splits, 2] (f32, the
// caller's) hold the partials that a second kernel merges into out.
extern "C" int ominix_paged_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* lengths, void* out, void* part_acc, void* part_ml, int B,
    int H, int Hkv, int D, int ps, int MP, int window, int rows_per_cta,
    int quant, float scale, int pages_per_split, int splits, void* stream) {
  const int R = rows_per_cta;
  if (R < 1 || R > kRowsMax || Hkv < 1 || H % Hkv || (H / Hkv) % R ||
      ps < 1 || pages_per_split < 1 || splits < 1 ||
      (long long)splits * pages_per_split < MP ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, k_scale, v_scale, table, lengths,
               out, part_acc, part_ml, B, H, Hkv, R, ps, MP,
               pages_per_split, splits, window, scale};
  cudaStream_t st = (cudaStream_t)stream;
  return quant ? by_dim<int8_t>(D, a, st) : by_dim<__nv_bfloat16>(D, a, st);
}
