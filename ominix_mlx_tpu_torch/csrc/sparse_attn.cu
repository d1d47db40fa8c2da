// K11: InfLLMv2's sparse decode attention (MiniCPM-SALA's "minicpm4"
// layers at one query token a row), in two kernels the wrapper launches in
// turn with torch.topk between them:
//
//   sparse_score (counter k11_score): the block scores, float32 sums of the
//     products of the group's scoring query (its first query head) and the
//     mean-pooled keys comp [B, Hkv, nb, D] bf16; a block outside
//     [init_end, window_start - ks] scores NEG_INF. window_start =
//     max(total - window, init_end).
//   sparse_attend (counter k11_attend; with a second small kernel,
//     sparse_merge, where a row is split): attention of each (row, KV head)
//     over its init slots, its selected blocks and its window, K and V read
//     in place from the cache [B, Hkv, S, D] bf16 through the indices.
//
// No TPU kernel computes either: the JAX package scores with an einsum on
// a float32 copy of comp, takes lax.top_k, gathers init + top-k blocks +
// window (4160 slots a KV head at the production config) and runs a masked
// sdpa (ominix_mlx_tpu/models/sparse_attention.py:131-197), all XLA.
//
// What bounds them on an H100: bytes. sparse_score reads comp once in bf16
// (8 MiB a layer at a 524288-token cache; the plain version first copies
// it to float32) and only the blocks that can be valid: the rest get
// NEG_INF unread, so a short context in a long cache costs what it holds.
// sparse_attend reads each valid slot's K and V rows once (4160 slots x 2
// KV heads x 512 B at B = 1) and does 4 R FLOPs a byte, R = 16 query heads
// a KV head: far below the card's ratio of operations to bytes. Its design
// is K3's split-KV flash-decoding (paged_attn.cu) over a slot list instead
// of a page table:
//   * the valid slots of a (row, KV head) are numbered densely: the init
//     slots below min(init_end, total), then the selected blocks whose score
//     is finite (compacted in top-k order by a ballot), then the window
//     [window_start, total). A slot that is not valid is never read: the
//     same function as the NEG_INF mask, since slot 0 is always valid. The
//     list is cut into splits of whole 64-slot tiles (ops/sparse_attention
//     k11_plan, from shapes only); a split past the row's count exits at
//     once, so the work follows the valid slots;
//   * one CTA per (split, KV head, row) holds all R <= 16 query heads of
//     its KV head as the A operand of mma.sync m16n8k16 (bf16 in, float32
//     accumulators), so K and V are read once; a CTA-wide ring of three
//     64-slot tiles, rows copied by cp.async through the slot's position
//     (16-byte pieces XOR-swizzled by the row for ldmatrix), each of the 4
//     warps taking 16 slots of a tile with an online softmax per query
//     row; the probabilities are rounded to bf16 for the P.V product, as
//     the plain version rounds its softmax weights;
//   * with more than one split a CTA writes a float32 partial (row max in
//     log2 units, denominator, numerator) and sparse_merge sums a row's
//     partials in split order, never in arrival order: bit-repeatable.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
// core/attention.py NEG_INF: -0.7 * the largest float32
constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;

// ------------------------------------------------------------------ score

constexpr int kScoreWarps = 8;
constexpr int kScoreIters = 4;     // blocks a lane group, unrolled

// One CTA per (run of blocks, KV head, row); a group of D / 8 lanes per
// block, 8 elements (16 bytes) a lane.
template <int D>
__global__ void __launch_bounds__(32 * kScoreWarps)
    sparse_score(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ comp,
                 const int* __restrict__ total, float* __restrict__ scores,
                 int H, int Hkv, int nb, int init_end, int window, int ks) {
  constexpr int LPB = D / 8;              // lanes a block
  constexpr int PW = 32 / LPB;            // blocks a warp at once
  constexpr int PER_CTA = kScoreWarps * PW * kScoreIters;
  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / LPB, ls = lane % LPB;
  const unsigned smask = ((1u << LPB) - 1u) << (sub * LPB);
  const int tot = total[b];
  const int ws = max(tot - window, init_end);
  const int lo = (init_end + ks - 1) / ks;      // first block >= init_end
  const int hi = ws / ks;                       // blocks ending <= ws

  float qf[8];
  {
    const uint4 u = *reinterpret_cast<const uint4*>(
        q + ((size_t)b * H + (size_t)g * (H / Hkv)) * D + ls * 8);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qf[2 * i] = __uint_as_float(w[i] << 16);
      qf[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  const __nv_bfloat16* crow = comp + ((size_t)b * Hkv + g) * nb * D + ls * 8;
  float* srow = scores + ((size_t)b * Hkv + g) * nb;
  const int base = blockIdx.x * PER_CTA + warp * PW + sub;

  uint4 u[kScoreIters];
  bool ok[kScoreIters];
#pragma unroll
  for (int r = 0; r < kScoreIters; ++r) {
    const int n = base + r * kScoreWarps * PW;
    ok[r] = n >= lo && n < hi && n < nb;
    if (ok[r]) u[r] = *reinterpret_cast<const uint4*>(crow + (size_t)n * D);
  }
#pragma unroll
  for (int r = 0; r < kScoreIters; ++r) {
    const int n = base + r * kScoreWarps * PW;
    if (n >= nb) continue;
    float s = kNegInf;
    if (ok[r]) {                 // the same for the group's lanes
      const uint32_t w[4] = {u[r].x, u[r].y, u[r].z, u[r].w};
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc = fmaf(qf[2 * i], __uint_as_float(w[i] << 16), acc);
        acc = fmaf(qf[2 * i + 1], __uint_as_float(w[i] & 0xffff0000u), acc);
      }
#pragma unroll
      for (int off = LPB / 2; off >= 1; off >>= 1)
        acc += __shfl_xor_sync(smask, acc, off);
      s = acc;
    }
    if (ls == 0) srow[n] = s;
  }
}

// ----------------------------------------------------------------- attend

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;          // slots a tile, 16 a warp
constexpr int kRows = 16;          // query rows a CTA (the mma's 16 rows)
constexpr int kMaxTopk = 256;

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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

// c += A (16 x 16) . B (16 x 8), bf16 in, f32 accumulators; a0 / a2 rows g
// (columns 2t, 2t+1 / 2t+8, 2t+9), a1 / a3 rows g + 8
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of 16-byte piece c of row r in a bf16 tile [kTile][D]: the
// piece index's low 3 bits XORed with the row's (as K3's tiles)
template <int D>
__device__ __forceinline__ int at(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
}

template <int D>
struct Plan {
  static constexpr int kRowBytes = D * 2;
  static constexpr int kPieces = kRowBytes / 16;
  static constexpr int kSide = kTile * kRowBytes;        // K or V of a tile
  static constexpr int kStage = 2 * kSide;
  static constexpr int kStages = 3;
  static constexpr int kMerge = kWarps * kRows * (D + 2) * 4;
  static constexpr int kRing = kStages * kStage;
  static constexpr size_t kBytes = kRing > kMerge ? kRing : kMerge;
  static constexpr int kCopies = kTile * kPieces / kThreads;
  static_assert(kTile * kPieces % kThreads == 0, "copy split");
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    sparse_attend(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const long long* __restrict__ top_idx,
                  const float* __restrict__ top_val,
                  const int* __restrict__ total,
                  __nv_bfloat16* __restrict__ out,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  int H, int Hkv, int S, int topk, int init_end, int window,
                  int ks, int sps, float scale) {
  using P = Plan<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_sel[kMaxTopk];
  __shared__ int s_nsel;
  const int split = blockIdx.x, splits = gridDim.x;
  const int g = blockIdx.y, b = blockIdx.z;
  const int R = H / Hkv, h0 = g * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;

  const int tot = total[b];
  const int ws = max(tot - window, init_end);
  const int n_init = min(init_end, tot);
  const int n_win = max(tot - ws, 0);
  const size_t bg = (size_t)b * Hkv + g;

  // the selected blocks with a finite score, in top-k order
  if (warp == 0) {
    int cnt = 0;
    for (int i0 = 0; i0 < topk; i0 += 32) {
      const int i = i0 + lane;
      const bool ok = i < topk && top_val[bg * topk + i] > 0.5f * kNegInf;
      const unsigned bal = __ballot_sync(kFull, ok);
      if (ok)
        s_sel[cnt + __popc(bal & ((1u << lane) - 1u))] =
            (int)top_idx[bg * topk + i];
      cnt += __popc(bal);
    }
    if (lane == 0) s_nsel = cnt;
  }
  __syncthreads();
  const int sel_end = n_init + s_nsel * ks;
  const int count = sel_end + n_win;
  const int lo = split * sps, hi = min(lo + sps, count);
  const size_t bh0 = (size_t)b * H + h0;
  if (lo >= hi) {                            // nothing of this row here
    if (splits > 1 && tid < R) {
      part_ml[((bh0 + tid) * splits + split) * 2] = -INFINITY;
      part_ml[((bh0 + tid) * splits + split) * 2 + 1] = 0.f;
    }
    return;
  }
  const int n_tiles = (hi - lo + kTile - 1) / kTile;

  // cache position of valid slot i
  auto pos_of = [&](int i) -> int {
    int p;
    if (i < n_init) {
      p = i;
    } else if (i < sel_end) {
      const int u = i - n_init;
      p = s_sel[u / ks] * ks + u % ks;
    } else {
      p = ws + (i - sel_end);
    }
    return min(p, S - 1);
  };
  const unsigned char* kbase =
      reinterpret_cast<const unsigned char*>(k + bg * S * D);
  const unsigned char* vbase =
      reinterpret_cast<const unsigned char*>(v + bg * S * D);
  auto stage = [&](int s) { return smem + (size_t)s * P::kStage; };
  // queue tile i's copies into stage s; slots past hi are zero-filled
  auto issue = [&](int i, int s) {
    const unsigned kst = smem_u32(stage(s)), vst = kst + P::kSide;
    const int s0 = lo + i * kTile;
#pragma unroll
    for (int c4 = 0; c4 < P::kCopies; ++c4) {
      const int idx = tid + c4 * kThreads;
      const int r = idx / P::kPieces, c = idx % P::kPieces, sl = s0 + r;
      const int n = sl < hi ? 16 : 0;
      const size_t off =
          (size_t)pos_of(min(sl, hi - 1)) * P::kRowBytes + c * 16;
      cp_async16(kst + at<D>(r, c), kbase + off, n);
      cp_async16(vst + at<D>(r, c), vbase + off, n);
    }
    cp_async_commit();
  };

  // the query heads as the A operand: rows gq and gq + 8 (zero past R)
  uint32_t qa[D / 16][4];
  {
    const bool r0 = gq < R, r1 = gq + 8 < R;
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(
        q + (bh0 + (r0 ? gq : 0)) * D);
    const uint32_t* q1 = reinterpret_cast<const uint32_t*>(
        q + (bh0 + (r1 ? gq + 8 : 0)) * D);
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
      qa[s][0] = r0 ? q0[8 * s + t4] : 0u;
      qa[s][1] = r1 ? q1[8 * s + t4] : 0u;
      qa[s][2] = r0 ? q0[8 * s + 4 + t4] : 0u;
      qa[s][3] = r1 ? q1[8 * s + 4 + t4] : 0u;
    }
  }
  const float qk = scale * kLog2e;     // scores in log2 units, f32

  float o[D / 8][4], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

#pragma unroll
  for (int s = 0; s < P::kStages - 1; ++s) {
    if (s < n_tiles) issue(s, s);
    else cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<P::kStages - 2>();      // tile i has landed
    __syncthreads();                      // ... for every thread; tile i-1
                                          // is consumed by every warp
    if (i + P::kStages - 1 < n_tiles)
      issue(i + P::kStages - 1, (i + P::kStages - 1) % P::kStages);
    else
      cp_async_commit();
    const unsigned kb = smem_u32(stage(i % P::kStages));
    const unsigned vb = kb + P::kSide;
    const int s0 = lo + i * kTile;

    // S = Q K^T over this warp's 16 slots (two n8 tiles)
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const int r = 16 * warp + (lane >> 4) * 8 + (lane & 7);
      const int hh = (lane >> 3) & 1;
#pragma unroll
      for (int s = 0; s < D / 16; ++s) {
        uint32_t f[4];
        ldsm_x4(kb + at<D>(r, 2 * s + hh), f);
        mma16(sc[0], qa[s], f[0], f[1]);
        mma16(sc[1], qa[s], f[2], f[3]);
      }
    }
    // online softmax of rows gq (e = 0, 1) and gq + 8 (e = 2, 3)
    float x[2][2][2], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sl = s0 + 16 * warp + 8 * n + 2 * t4 + (e & 1);
        const float val = sl < hi ? sc[n][e] * qk : -INFINITY;
        x[e >> 1][n][e & 1] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2], m_new[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(kFull, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(kFull, mx[rr], 2));
      m_new[rr] = fmaxf(m_run[rr], mx[rr]);
      alpha[rr] = m_new[rr] == -INFINITY ? 1.f : exp2f(m_run[rr] - m_new[rr]);
      m_run[rr] = m_new[rr];
    }
    float p[2][2][2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float xv = x[rr][n][e];
          p[rr][n][e] = xv == -INFINITY ? 0.f : exp2f(xv - m_new[rr]);
          sum += p[rr][n][e];
        }
      l_run[rr] = fmaf(l_run[rr], alpha[rr], sum);
    }
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }
    // O += P . V over the same 16 slots (one k16 step)
    const uint32_t pa[4] = {pack_bf16(p[0][0][0], p[0][0][1]),
                            pack_bf16(p[1][0][0], p[1][0][1]),
                            pack_bf16(p[0][1][0], p[0][1][1]),
                            pack_bf16(p[1][1][0], p[1][1][1])};
    {
      const int r = 16 * warp + ((lane >> 3) & 1) * 8 + (lane & 7);
      const int hh = lane >> 4;
#pragma unroll
      for (int c = 0; c < D / 8; c += 2) {
        uint32_t f[4];
        ldsm_x4_t(vb + at<D>(r, c + hh), f);
        mma16(o[c], pa, f[0], f[1]);
        mma16(o[c + 1], pa, f[2], f[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                        // the ring is free for the merge

  // merge the warps' softmaxes (the ring's memory is reused)
  float* red_acc = reinterpret_cast<float*>(smem);      // [warp][row][D]
  float* red_ml = red_acc + kWarps * kRows * D;         // [warp][row][2]
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_run[rr];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    const int row = gq + 8 * rr;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      red_acc[(warp * kRows + row) * D + 8 * d + 2 * t4] = o[d][2 * rr];
      red_acc[(warp * kRows + row) * D + 8 * d + 2 * t4 + 1] =
          o[d][2 * rr + 1];
    }
    if (t4 == 0) {
      red_ml[(warp * kRows + row) * 2] = m_run[rr];
      red_ml[(warp * kRows + row) * 2 + 1] = l;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      m = fmaxf(m, red_ml[(w * kRows + r) * 2]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = red_ml[(w * kRows + r) * 2];
      const float f = mw == -INFINITY ? 0.f : exp2f(mw - m);
      num = fmaf(f, red_acc[(w * kRows + r) * D + d], num);
      den = fmaf(f, red_ml[(w * kRows + r) * 2 + 1], den);
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
// -inf) are skipped (K3's paged_merge). One CTA per (row, query head), a
// thread per dim.
__global__ void sparse_merge(const float* __restrict__ part_acc,
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

template <int D>
int launch_attend(const void* q, const void* k, const void* v,
                  const void* idx, const void* val, const void* total,
                  void* out, void* part_acc, void* part_ml, int B, int H,
                  int Hkv, int S, int topk, int init_end, int window, int ks,
                  int splits, int sps, float scale, cudaStream_t st) {
  constexpr size_t smem = Plan<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      sparse_attend<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  sparse_attend<D><<<dim3(splits, Hkv, B), kThreads, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const long long*)idx, (const float*)val,
      (const int*)total, (__nv_bfloat16*)out, (float*)part_acc,
      (float*)part_ml, H, Hkv, S, topk, init_end, window, ks, sps, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  sparse_merge<<<B * H, D, 2 * splits * sizeof(float), st>>>(
      (const float*)part_acc, (const float*)part_ml, (__nv_bfloat16*)out,
      splits);
  return (int)cudaGetLastError();
}

template <int D>
int launch_score(const void* q, const void* comp, const void* total,
                 void* scores, int B, int H, int Hkv, int nb, int init_end,
                 int window, int ks, cudaStream_t st) {
  constexpr int per_cta = kScoreWarps * (32 / (D / 8)) * kScoreIters;
  const dim3 grid((nb + per_cta - 1) / per_cta, Hkv, B);
  sparse_score<D><<<grid, 32 * kScoreWarps, 0, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)comp,
      (const int*)total, (float*)scores, H, Hkv, nb, init_end, window, ks);
  return (int)cudaGetLastError();
}

bool bad_heads(int B, int H, int Hkv) {
  return B < 1 || B > 65535 || Hkv < 1 || Hkv > 65535 || H % Hkv ||
         H / Hkv > kRows;
}

}  // namespace

extern "C" {

// k11_score on `stream`: q [B, H, D] bf16 (the decode step's queries; the
// scoring query of KV head g is query head g H / Hkv), comp [B, Hkv, nb, D]
// bf16, total [B] int32 (tokens including this step's); scores [B, Hkv,
// nb] float32. D = 128 (MiniCPM-SALA's). Returns the first CUDA error.
int ominix_sparse_score(const void* q, const void* comp, const void* total,
                        void* scores, int B, int H, int Hkv, int nb, int D,
                        int init_end, int window, int ks, void* stream) {
  if (bad_heads(B, H, Hkv) || nb < 1 || ks < 1 || init_end < 0 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D != 128) return (int)cudaErrorInvalidValue;
  return launch_score<128>(q, comp, total, scores, B, H, Hkv, nb, init_end,
                           window, ks, st);
}

// k11_attend on `stream`: q [B, H, D] bf16; k, v [B, Hkv, S, D] bf16;
// top_idx [B, Hkv, topk] int64 and top_val [B, Hkv, topk] float32 (as
// torch.topk returns them); total [B] int32; out [B, H, D] bf16. The slots
// are cut into `splits` runs of `slots_per_split` (a multiple of 64; the
// plan of ops/sparse_attention.py k11_plan); with more than one split,
// part_acc [B, H, splits, D] and part_ml [B, H, splits, 2] (float32, the
// caller's) hold the partials. D = 128, H / Hkv <= 16, topk <= 256.
int ominix_sparse_attend(const void* q, const void* k, const void* v,
                         const void* top_idx, const void* top_val,
                         const void* total, void* out, void* part_acc,
                         void* part_ml, int B, int H, int Hkv, int S, int D,
                         int topk, int init_end, int window, int ks,
                         int splits, int slots_per_split, float scale,
                         void* stream) {
  if (bad_heads(B, H, Hkv) || S < 1 || topk < 0 || topk > kMaxTopk ||
      ks < 1 || init_end < 0 || window < 0 || splits < 1 ||
      slots_per_split < kTile || slots_per_split % kTile ||
      (long long)splits * slots_per_split <
          (long long)init_end + (long long)topk * ks + window ||
      (splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D != 128) return (int)cudaErrorInvalidValue;
  return launch_attend<128>(q, k, v, top_idx, top_val, total, out, part_acc,
                            part_ml, B, H, Hkv, S, topk, init_end, window, ks,
                            splits, slots_per_split, scale, st);
}

}  // extern "C"
