// K10: lightning attention, the linear attention of MiniCPM-SALA's
// "lightning-attn" layers, over T tokens from a carried state, with a
// scalar decay per head (lambda_h = exp(slope_h), the negated ALiBi slope):
//
//   S_t = lambda_h S_{t-1} + k_t v_t^T        [D, D] float32
//   o_t = S_t^T q_t                            [D]
//
// No TPU kernel computes this: the JAX package writes one einsum step for
// decode (ominix_mlx_tpu/models/lightning.py:75-83) and a jax.lax.scan over
// chunks of 64 tokens for prompts (:86-119), which XLA compiles. The
// port's own kernel, as K9 is for Qwen3-Next's scan: the plain PyTorch
// version (ops/lightning_attention.py lightning_reference) dispatches some
// ten ops a chunk and layer from Python.
//
// Layout: q, k, v [B, H, T, D] bf16 or float32, any strides with a unit
// stride along D (the wrapper checks 16-byte aligned rows); slopes [H]
// float32; state [B, H, D, D] float32, read and written in place; o
// [B, H, T, D] float32. The sums are float32 in another order than the
// plain version's, so the kernel is held to it with a relative bound; each
// form is bit-repeatable (no atomics).
//
// Two forms of the same function; ops/lightning_attention.py k10_plan
// picks one from the shapes alone.
//
// The recurrent form (decode, short prompts; D = 128). What bounds it
// on an H100: at decode (T = 1) bytes, the state read and written once
// (2 MiB a layer each way at MiniCPM-SALA's 32 heads of 128 at B = 1);
// over a prompt each token's latency, the recurrence being serial in t.
// The design is K9's recurrent form without the delta: one CTA of 128
// threads per (row, head, 32 value columns), four threads a column
// holding D / 4 state rows in registers for the whole loop over T; each
// token's q and k staged in double-buffered shared memory (one barrier a
// token) while the next token's are loaded; S^T q as four fma chains a
// thread folded across the column's four lanes by two shuffles.
//
// The chunked form (prompts, D = 128), chunks of C = 64 tokens. With a
// scalar decay per head it needs no UT transform: per (row, head) and
// chunk of n tokens, with S the state at the chunk's start,
//   O = (Q K^T * M) V + diag(lambda^(i+1)) Q S,  M_ij = lambda^(i-j), j <= i
//   S <- lambda^n S + K^T diag(lambda^(n-1-j)) V
// Every product runs on mma.sync m16n8k8 TF32 in 3xTF32 (mma_tf32.cuh;
// plain TF32 misses the 1e-4 that K9 is held to). A short final chunk is
// masked (its rows past n read as zeros, its decays those of length n),
// not zero-padded: the JAX package's pad-and-correct's function.
//   * phase 1, lightning_chunk, grid (chunk, head, row), 8 warps: Q K^T on
//     and below the diagonal, masked and decayed into P (over Q's shared
//     memory); P V, the chunk's own output, written to o; K^T (rev * V),
//     the chunk's state increment, into a float32 scratch of D * D a chunk
//     and head that the wrapper allocates. Every chunk is independent, so
//     this phase fills the card from a few hundred tokens on. About 100 KiB
//     of shared memory: two CTAs an SM.
//   * phase 2, lightning_chunk_scan, grid (D / 32, head, row), 8 warps: the
//     scan over the chunks with the state's 32 columns in shared memory:
//     Q S_prev (each warp 16 rows by 16 columns) scaled by lambda^(i+1)
//     and added to the chunk's rows of o, then S = lambda^n S + dS. The
//     next chunk's Q and dS are loaded into registers while this one
//     computes.
// What bounds it on an H100: at MiniCPM-SALA's 32 heads of 128, T = 2048,
// the products (about 6.4 GFLOP: 13 us at the TF32 peak, three times that
// in 3xTF32 on mma.sync, which runs below wgmma's peak) against the bytes
// (q, k, v in bf16, o in float32 and the state once: about 26 us); the
// scratch (64 KiB a chunk and head, written once and read once) and phase
// 2's serial chunks come on top.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kCols = 32;          // value columns a CTA
constexpr int kThreads = 4 * kCols;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kChunk = 64;         // tokens a chunk
constexpr int kChunkThreads = 256; // 8 warps, either phase
constexpr int kLdC = kChunk + 4;   // P [C][C]: A reads conflict-free
constexpr int kLdN = kCols + 8;    // S slice [D][32]: B reads conflict-free

// element strides of a [B, H, T, D] input (unit stride along D)
struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 8 consecutive elements from a 16-byte aligned address, as float32
__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void store8(float* p, const float (&x)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

// ---------------------------------------------------------------- recurrent

template <typename In, int D>
__global__ void __launch_bounds__(kThreads)
    lightning_k10(const In* __restrict__ q, const In* __restrict__ k,
                  const In* __restrict__ v, const float* __restrict__ slopes,
                  float* __restrict__ state, float* __restrict__ o, int H,
                  int T, Strides sq, Strides sk, Strides sv) {
  constexpr int R = D / 4;                     // state rows a thread holds
  static_assert(R % 4 == 0 && D <= kThreads, "four chains, one load each");
  __shared__ float s_q[2][D], s_k[2][D];

  const int tid = threadIdx.x;
  const int part = tid & 3;
  const int col = blockIdx.x * kCols + (tid >> 2);
  const int h = blockIdx.y, b = blockIdx.z;
  const float lam = expf(slopes[h]);

  float* S = state + ((size_t)b * H + h) * D * D;
  float s[R];
#pragma unroll
  for (int j = 0; j < R; ++j) s[j] = S[(size_t)(4 * j + part) * D + col];

  const In* qb = q + b * sq.b + h * sq.h;
  const In* kb = k + b * sk.b + h * sk.h;
  const In* vb = v + b * sv.b + h * sv.h + col;
  float qn = 0.f, kn = 0.f, vn = 0.f;
  auto fetch = [&](int t) {
    if (tid < D) {
      qn = to_f32(qb[t * sq.t + tid]);
      kn = to_f32(kb[t * sk.t + tid]);
    }
    vn = to_f32(vb[t * sv.t]);
  };

  float* ob = o + ((size_t)b * H + h) * T * D + col;
  fetch(0);
  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    if (tid < D) {
      s_q[buf][tid] = qn;
      s_k[buf][tid] = kn;
    }
    const float vt = vn;
    __syncthreads();
    if (t + 1 < T) fetch(t + 1);
    const float* kk = s_k[buf];
    const float* qq = s_q[buf];

    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < R; ++j) {
      s[j] = fmaf(lam, s[j], kk[4 * j + part] * vt);
      c[j & 3] = fmaf(s[j], qq[4 * j + part], c[j & 3]);
    }
    float out = (c[0] + c[1]) + (c[2] + c[3]);
    out += __shfl_xor_sync(kFullMask, out, 1);
    out += __shfl_xor_sync(kFullMask, out, 2);
    if (part == 0) ob[(size_t)t * D] = out;
  }

#pragma unroll
  for (int j = 0; j < R; ++j) S[(size_t)(4 * j + part) * D + col] = s[j];
}

template <typename In, int D>
cudaError_t launch_recurrent(const void* q, const void* k, const void* v,
                             const float* slopes, float* state, float* o,
                             int B, int H, int T, Strides sq, Strides sk,
                             Strides sv, cudaStream_t st) {
  const dim3 grid(D / kCols, H, B);
  lightning_k10<In, D><<<grid, kThreads, 0, st>>>(
      (const In*)q, (const In*)k, (const In*)v, slopes, state, o, H, T, sq,
      sk, sv);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- chunked

template <int D>
struct ChunkSmem {
  static constexpr int kLdK = D + 4;   // [C][D]: A, A^T and [n][k] B reads
  static constexpr int kLdV = D + 8;   // [C][D] read as [k][n] B
  // phase 1: Q (then P), K, V, the reverse decays
  static constexpr int kPrep = 4 * (2 * kChunk * kLdK + kChunk * kLdV +
                                    kChunk);
  // phase 2: Q, the state's 32 columns, the query decays
  static constexpr int kScan = 4 * (kChunk * kLdK + D * kLdN + kChunk);
};

// rows t0 .. t0 + n - 1 of one (row, head) of x into dst [C][ld] as
// float32, zeros past n
template <typename In, int D>
__device__ __forceinline__ void rows_to_smem(const In* x, long long st,
                                             int t0, int n, float* dst,
                                             int ld, int tid) {
  for (int idx = tid; idx < kChunk * D / 8; idx += kChunkThreads) {
    const int i = idx / (D / 8), d = idx % (D / 8) * 8;
    float e[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (i < n) load8(x + (t0 + i) * st + d, e);
    store8(dst + i * ld + d, e);
  }
}

// Phase 1: one CTA per (chunk, head, row): the chunk's own output into o,
// its state increment into dS ([B][H][NC] blocks of D x D).
template <typename In, int D>
__global__ void __launch_bounds__(kChunkThreads, 2)
    lightning_chunk(const In* __restrict__ q, const In* __restrict__ k,
                    const In* __restrict__ v,
                    const float* __restrict__ slopes, float* __restrict__ o,
                    float* __restrict__ dS, int H, int T, Strides sq,
                    Strides sk, Strides sv) {
  static_assert(D == 8 * 16, "a warp per 16 rows of the D x D increment");
  using L = ChunkSmem<D>;
  constexpr int LK = L::kLdK, LV = L::kLdV;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                 // Q, then P [C][kLdC]
  float* sK = sQ + kChunk * LK;
  float* sV = sK + kChunk * LK;
  float* sRev = sV + kChunk * LV;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kChunk, n = min(kChunk, T - t0);
  const float slope = slopes[h];

  rows_to_smem<In, D>(q + b * sq.b + h * sq.h, sq.t, t0, n, sQ, LK, tid);
  rows_to_smem<In, D>(k + b * sk.b + h * sk.h, sk.t, t0, n, sK, LK, tid);
  rows_to_smem<In, D>(v + b * sv.b + h * sv.h, sv.t, t0, n, sV, LV, tid);
  if (tid < kChunk)
    sRev[tid] = tid < n ? expf(slope * (float)(n - 1 - tid)) : 0.f;
  __syncthreads();

  // Q K^T: warp (mb, nh) takes rows 16 mb .. + 15 and columns 32 nh .. +
  // 31, unless every one of them lies above the diagonal
  const int mb = warp >> 1, nh = warp & 1;
  const bool below = 32 * nh <= 16 * mb + 15;
  float acc[4][4] = {};
  if (below) {
#pragma unroll 4
    for (int ks = 0; ks < D / 8; ++ks) {
      const FragA a = load_a(sQ, LK, 16 * mb, 8 * ks, lane);
      FragB bf[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        bf[nt] = load_b_nk(sK, LK, 8 * ks, 32 * nh + 8 * nt, lane);
      mma3_row<4>(acc, a, bf);
    }
  }
  __syncthreads();                  // Q is read: P takes its place

  // P = (Q K^T) * M, M_ij = lambda^(i-j) for j <= i, else 0
  float* sP = sQ;
  if (below) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 16 * mb + g + 8 * hf, j0 = 32 * nh + 8 * nt + 2 * t;
        float val[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + e;
          val[e] = j <= i ? expf(slope * (float)(i - j)) *
                                acc[nt][2 * hf + e]
                          : 0.f;
        }
        *reinterpret_cast<float2*>(sP + i * kLdC + j0) =
            make_float2(val[0], val[1]);
      }
  }
  __syncthreads();

  const size_t bh = (size_t)b * H + h;
  // P V: rows 16 mb .. + 15, columns D/2 nh .. + D/2 - 1; P is zero past
  // column 16 mb + 15 (and never written there by a skipped warp)
  {
    constexpr int NT = D / 16;
    float ac[NT][4] = {};
    for (int ks = 0; ks < 2 * mb + 2; ++ks) {
      const FragA a = load_a(sP, kLdC, 16 * mb, 8 * ks, lane);
      FragB bf[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        bf[nt] = load_b_kn(sV, LV, 8 * ks, D / 2 * nh + 8 * nt, lane);
      mma3_row<NT>(ac, a, bf);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = 16 * mb + g + 8 * hf;
      if (i < n) {
        float* orow = o + (bh * T + t0 + i) * D + D / 2 * nh;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          *reinterpret_cast<float2*>(orow + 8 * nt + 2 * t) =
              make_float2(ac[nt][2 * hf], ac[nt][2 * hf + 1]);
      }
    }
  }

  // dS = K^T diag(rev) V: warp w takes rows 16 w .. + 15, in two halves of
  // D / 2 columns
  float* dSc = dS + (bh * gridDim.x + c) * D * D;
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    constexpr int NT = D / 16;
    float ac[NT][4] = {};
#pragma unroll 2
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      const FragA a = load_a_t(sK, LK, 16 * warp, 8 * ks, lane);
      FragB bf[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        bf[nt] = load_b_kn(sV, LV, 8 * ks, D / 2 * half + 8 * nt, lane,
                           sRev);
      mma3_row<NT>(ac, a, bf);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float* row = dSc + (size_t)(16 * warp + g + 8 * hf) * D + D / 2 * half;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(row + 8 * nt + 2 * t) =
            make_float2(ac[nt][2 * hf], ac[nt][2 * hf + 1]);
    }
  }
}

// Phase 2: one CTA per (32 value columns, head, row), the scan over the
// chunks. A thread owns D * 32 / 256 elements of the state's slice for
// the update; warp (mb, nh) computes Q S for rows 16 mb .. + 15 and
// columns 16 nh .. + 15 of the slice.
template <typename In, int D>
__global__ void __launch_bounds__(kChunkThreads, 1)
    lightning_chunk_scan(const In* __restrict__ q,
                         const float* __restrict__ slopes,
                         float* __restrict__ state, float* __restrict__ o,
                         const float* __restrict__ dS, int H, int T,
                         Strides sq) {
  using L = ChunkSmem<D>;
  constexpr int LK = L::kLdK;
  constexpr int QG = kChunk * D / 8 / kChunkThreads;    // Q's 8-groups
  constexpr int SE = D * kCols / kChunkThreads;         // state elements
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sS = sQ + kChunk * LK;
  float* sDec = sS + D * kLdN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * kCols, h = blockIdx.y, b = blockIdx.z;
  const int NC = (T + kChunk - 1) / kChunk;
  const float slope = slopes[h];
  const size_t bh = (size_t)b * H + h;
  const In* qb = q + b * sq.b + h * sq.h;

  float* Sg = state + bh * D * D + col0;
#pragma unroll
  for (int m = 0; m < SE; ++m) {
    const int idx = tid + m * kChunkThreads, r = idx / kCols, cc = idx % kCols;
    sS[r * kLdN + cc] = Sg[(size_t)r * D + cc];
  }

  float qn[QG][8], dn[SE];
  auto fetch = [&](int c) {
    const int t0 = c * kChunk, n = min(kChunk, T - t0);
#pragma unroll
    for (int m = 0; m < QG; ++m) {
      const int idx = tid + m * kChunkThreads;
      const int i = idx / (D / 8), d = idx % (D / 8) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) qn[m][e] = 0.f;
      if (i < n) load8(qb + (t0 + i) * sq.t + d, qn[m]);
    }
    const float* dSc = dS + (bh * NC + c) * D * D + col0;
#pragma unroll
    for (int m = 0; m < SE; ++m) {
      const int idx = tid + m * kChunkThreads;
      dn[m] = dSc[(size_t)(idx / kCols) * D + idx % kCols];
    }
  };

  const int mb = warp >> 1, nh = warp & 1;
  fetch(0);
  for (int c = 0; c < NC; ++c) {
    const int t0 = c * kChunk, n = min(kChunk, T - t0);
#pragma unroll
    for (int m = 0; m < QG; ++m) {
      const int idx = tid + m * kChunkThreads;
      store8(sQ + idx / (D / 8) * LK + idx % (D / 8) * 8, qn[m]);
    }
    float dcur[SE];
#pragma unroll
    for (int m = 0; m < SE; ++m) dcur[m] = dn[m];
    if (tid < kChunk) sDec[tid] = expf(slope * (float)(tid + 1));
    __syncthreads();
    if (c + 1 < NC) fetch(c + 1);

    // Q S_prev, scaled by lambda^(i+1), added to the chunk's rows of o
    float acc[2][4] = {};
#pragma unroll 4
    for (int ks = 0; ks < D / 8; ++ks) {
      const FragA a = load_a(sQ, LK, 16 * mb, 8 * ks, lane);
      FragB bf[2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        bf[nt] = load_b_kn(sS, kLdN, 8 * ks, 16 * nh + 8 * nt, lane);
      mma3_row<2>(acc, a, bf);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = 16 * mb + g + 8 * hf;
      if (i < n) {
        float* orow = o + (bh * T + t0 + i) * D + col0 + 16 * nh;
        const float dec = sDec[i];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          float2* p = reinterpret_cast<float2*>(orow + 8 * nt + 2 * t);
          float2 x = *p;
          x.x = fmaf(dec, acc[nt][2 * hf], x.x);
          x.y = fmaf(dec, acc[nt][2 * hf + 1], x.y);
          *p = x;
        }
      }
    }
    __syncthreads();              // S and Q are read by every warp

    const float blk = expf(slope * (float)n);
#pragma unroll
    for (int m = 0; m < SE; ++m) {
      const int idx = tid + m * kChunkThreads;
      float* s = sS + (idx / kCols) * kLdN + idx % kCols;
      *s = fmaf(blk, *s, dcur[m]);
    }
  }

#pragma unroll
  for (int m = 0; m < SE; ++m) {
    const int idx = tid + m * kChunkThreads, r = idx / kCols, cc = idx % kCols;
    Sg[(size_t)r * D + cc] = sS[r * kLdN + cc];
  }
}

template <typename In>
cudaError_t launch_chunked(const void* q, const void* k, const void* v,
                           const float* slopes, float* state, float* o,
                           float* dS, int B, int H, int T, Strides sq,
                           Strides sk, Strides sv, cudaStream_t st) {
  constexpr int D = 128;
  using L = ChunkSmem<D>;
  static bool attrs = false;
  if (!attrs) {
    cudaError_t e = cudaFuncSetAttribute(
        lightning_chunk<In, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L::kPrep);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(lightning_chunk_scan<In, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kScan);
    if (e != cudaSuccess) return e;
    attrs = true;
  }
  const int NC = (T + kChunk - 1) / kChunk;
  lightning_chunk<In, D><<<dim3(NC, H, B), kChunkThreads, L::kPrep, st>>>(
      (const In*)q, (const In*)k, (const In*)v, slopes, o, dS, H, T, sq, sk,
      sv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  lightning_chunk_scan<In, D>
      <<<dim3(D / kCols, H, B), kChunkThreads, L::kScan, st>>>(
          (const In*)q, slopes, state, o, dS, H, T, sq);
  return cudaGetLastError();
}

bool bad_args(int B, int H, int T) {
  return B < 1 || H < 1 || T < 1 || B > 65535 || H > 65535;
}

}  // namespace

extern "C" {

// K10's recurrent form on `stream` (see above): D = 128; bf16 != 0 for
// bf16 q, k, v (else float32); the element strides of q, k and v over
// (row, head, token). Returns the first CUDA error (an argument the kernel
// does not take: cudaErrorInvalidValue, nothing launched).
int ominix_lightning(const void* q, const void* k, const void* v,
                     const void* slopes, void* state, void* o, int B, int H,
                     int T, int D, int bf16, long long qb, long long qh,
                     long long qt, long long kb, long long kh, long long kt,
                     long long vb, long long vh, long long vt,
                     void* stream) {
  if (bad_args(B, H, T) || D != 128) return (int)cudaErrorInvalidValue;
  const Strides sq{qb, qh, qt}, sk{kb, kh, kt}, sv{vb, vh, vt};
  cudaStream_t st = (cudaStream_t)stream;
  const float* sl = (const float*)slopes;
  if (bf16)
    return (int)launch_recurrent<__nv_bfloat16, 128>(
        q, k, v, sl, (float*)state, (float*)o, B, H, T, sq, sk, sv, st);
  return (int)launch_recurrent<float, 128>(q, k, v, sl, (float*)state,
                                           (float*)o, B, H, T, sq, sk, sv,
                                           st);
}

// The chunked form on `stream` (see above): D = 128 (k10_plan); dS the
// float32 scratch of B H ceil(T / 64) D D floats, every element written by
// phase 1 before phase 2 reads it. Returns the first CUDA error.
int ominix_lightning_chunked(const void* q, const void* k, const void* v,
                             const void* slopes, void* state, void* o,
                             void* dS, int B, int H, int T, int D, int bf16,
                             long long qb, long long qh, long long qt,
                             long long kb, long long kh, long long kt,
                             long long vb, long long vh, long long vt,
                             void* stream) {
  if (bad_args(B, H, T) || D != 128) return (int)cudaErrorInvalidValue;
  const Strides sq{qb, qh, qt}, sk{kb, kh, kt}, sv{vb, vh, vt};
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return (int)launch_chunked<__nv_bfloat16>(
        q, k, v, (const float*)slopes, (float*)state, (float*)o, (float*)dS,
        B, H, T, sq, sk, sv, st);
  return (int)launch_chunked<float>(q, k, v, (const float*)slopes,
                                    (float*)state, (float*)o, (float*)dS, B,
                                    H, T, sq, sk, sv, st);
}

}  // extern "C"
