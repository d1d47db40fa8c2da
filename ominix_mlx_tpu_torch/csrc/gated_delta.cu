// K9: the gated delta rule, the recurrence of a Gated DeltaNet layer
// (Qwen3-Next's linear attention), over T tokens from a carried state:
//
//   S = S * exp(g_t)                   (per value head, a scalar decay)
//   kv_mem = S^T k_t                   [dv]
//   delta = (v_t - kv_mem) * beta_t
//   S = S + k_t delta^T
//   o_t = S^T q_t                      [dv]
//
// No TPU kernel computes this: the JAX package runs it as a jax.lax.scan
// over a per-token step (ominix_mlx_tpu/models/deltanet.py:132-144), which
// XLA compiles into one loop. The port's own kernel, in the way K8 is for
// an XLA einsum: the plain PyTorch version (ops/gated_delta.py
// gated_delta_rule_reference) dispatches some eight ops per token per
// layer from Python.
//
// Layout (float32, contiguous): q, k [B, T, Hk, dk], l2-normed, q already
// scaled by dk^-0.5; v [B, T, Hv, dv]; g, beta [B, T, Hv]; state
// [B, Hv, dk, dv], read and written in place; o [B, T, Hv, dv]. Value head
// h reads key head h / (Hv / Hk) (jnp.repeat of q and k along the heads,
// never materialised).
//
// Two forms of the same function; ops/gated_delta.py k9_plan picks one
// from the shapes alone.
//
// The recurrent form (decode, short prompts, every head width). What bounds
// it on an H100: at decode (T = 1) bytes, the state read and written once
// (2 MB a layer each way at Qwen3-Next's 32 x 128 x 128 per row); over a
// prompt the recurrence is serial in t, so it is bound by each token's
// latency. The design:
//   * one CTA of 128 threads per (row, value head, 32 value columns): four
//     threads own one column of S, dk / 4 rows each (rows 4j + part, so
//     the four read four banks of the staged k and q), in registers for
//     the whole loop over T, which runs inside the kernel: S touches
//     device memory twice;
//   * each token's q and k are staged once in shared memory (double
//     buffered: one barrier a token), and the next token's q, k, v, g and
//     beta are loaded into registers while this token computes;
//   * S^T k and S^T q are a thread's partial sums (four chains for
//     instruction-level parallelism) folded across the column's four lanes
//     by two shuffles, so all four hold the same sum and the same delta.
//
// The chunked form (prompts, dk = dv = 128): the WY / UT-transform form of
// the rule over chunks of C = 64 tokens, so that all but a short scan over
// the chunks is matrix products on the tensor cores. Per (row, value head)
// and chunk, with Q, K [C, dk], V [C, dv], G the inclusive cumulative sum
// of g within the chunk, S the state at the chunk's start:
//   Gam_ij = exp(G_i - G_j) for j <= i, else 0 (masked BEFORE the exp: G
//            reaches -1000 at strong decay, and exp of an upper entry
//            overflows, then inf * 0 = NaN)
//   A = strictly-lower(diag(beta) Gam * K K^T),  T = (I + A)^-1
//   W = T diag(beta e^G) K,  U0 = T diag(beta) V,  P = Q K^T * Gam
//   U = U0 - W S
//   O = diag(e^G) Q S + P U
//   S <- e^{G_C} S + K^T (diag(e^{G_C - G}) U)
// the same function as the recurrence, summed in another order (the
// CPU tests hold chunk_gated_delta_rule_reference, these formulas in
// torch, to the JAX scan). Every product runs on mma.sync m16n8k8 TF32 in
// 3xTF32: each float32 operand split into a TF32 high part and a TF32
// remainder, hi.hi + hi.lo + lo.hi summed in float32 (the small terms
// first). Plain TF32 misses the kernel's 1e-4 limit by eight times at
// T = 2048. T is solved by forward substitution in float32 on the CUDA
// cores: four threads a column of T, the column's partial sums folded by
// two shuffles a row (no barrier: each column of a unit triangular
// system is independent).
//   * phase 1, gated_delta_chunk, grid (chunk, value head, row), 8 warps:
//     K K^T and Q K^T (the 20 tiles on or below the diagonal of each, 5 a
//     warp), the masks and decays, the solve, then W and U0 (T's zero
//     columns skipped; a warp takes row blocks (0, 3) or (1, 2), so each
//     does 10 k-steps) into a float32 scratch that the wrapper allocates:
//     W [C, dk], U0 [C, dv], P [C, C] and G [C], 80 KiB a (chunk, value
//     head). Every chunk is independent, so this phase fills the card
//     from T = 1024 on. About 102 KiB of shared memory: two CTAs an SM.
//   * phase 2, gated_delta_chunk_scan, grid (dv / 32, value head, row), 8
//     warps: the scan over chunks with the state's 32 columns held in
//     four warps' mma accumulators for the whole scan (and copied to
//     shared memory each chunk as the next chunk's B operand). A chunk is
//     three steps between barriers: W S and Q S (four warps each); U =
//     U0 - W S and the decays; P U (the O warps) beside K^T U (the state
//     warps). The next chunk's W and Q are fetched by cp.async as soon as
//     step one has read this chunk's, its K, P, U0 and G as soon as step
//     three has: two copy groups in flight, one buffer each (166 KiB).
//     The state is read and written once, as in the recurrent form.
// What bounds it on an H100: not the bytes (105 MB at T = 2048, 31 us),
// and the products only in part (24 us at the TF32 peak for one pass;
// 3xTF32 makes three, on mma.sync, which runs below wgmma's peak) but the
// operands: each element is loaded from shared memory and split into its
// two TF32 parts by every warp that reads it, and every chunk's W, Q, K
// and P (112 KiB) is read from L2 by each of a head's four phase-2 CTAs:
// about 15 MB a chunk at B = 1 (chip_smoke.py's phase_us gives phase 2's
// time a chunk). The three terms of a product are
// issued across independent accumulators (mma3_row / mma3_each /
// mma3_grid) so that no warp waits on an HMMA's result; splitting the
// shared B operands once (into hi / lo planes) and 16 warps a CTA were
// each timed and gained nothing (PERF.md section 6). Phase 2 is the serial
// part: 32 chunks at T = 2048.
//
// The sums are float32 in another order than XLA's (and fused
// multiply-adds), so both forms are held to the plain version with a
// relative bound, not bit for bit; each is bit-repeatable (no atomics).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kCols = 32;          // value columns a CTA
constexpr int kThreads = 4 * kCols;
constexpr unsigned kFullMask = 0xffffffffu;

template <int DK>
__global__ void __launch_bounds__(kThreads)
    gated_delta_k9(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ g,
                   const float* __restrict__ beta, float* __restrict__ state,
                   float* __restrict__ o, int T, int Hk, int Hv, int dv) {
  constexpr int R = DK / 4;                    // state rows a thread holds
  constexpr int QPT = (DK + kThreads - 1) / kThreads;
  static_assert(R % 4 == 0, "four partial chains");
  __shared__ float sq[2][DK], sk[2][DK];

  const int tid = threadIdx.x;
  const int part = tid & 3;
  const int col = blockIdx.x * kCols + (tid >> 2);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hv / Hk);
  const bool live = col < dv;

  float* S = state + (size_t)(b * Hv + h) * DK * dv;
  float s[R];
#pragma unroll
  for (int j = 0; j < R; ++j)
    s[j] = live ? S[(size_t)(4 * j + part) * dv + col] : 0.f;

  float qn[QPT], kn[QPT], vn = 0.f, gn = 0.f, bn = 0.f;
  auto fetch = [&](int t) {
    const size_t row = (size_t)b * T + t;
    const float* qt = q + (row * Hk + hk) * DK;
    const float* kt = k + (row * Hk + hk) * DK;
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < DK) {
        qn[i] = qt[idx];
        kn[i] = kt[idx];
      }
    }
    vn = live ? v[(row * Hv + h) * dv + col] : 0.f;
    gn = g[row * Hv + h];
    bn = beta[row * Hv + h];
  };

  fetch(0);
  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < DK) {
        sq[buf][idx] = qn[i];
        sk[buf][idx] = kn[i];
      }
    }
    const float vt = vn, beta_t = bn, decay = expf(gn);
    __syncthreads();
    if (t + 1 < T) fetch(t + 1);
    const float* kk = sk[buf];
    const float* qq = sq[buf];

    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < R; ++j) {
      s[j] *= decay;
      a[j & 3] = fmaf(s[j], kk[4 * j + part], a[j & 3]);
    }
    float kv = (a[0] + a[1]) + (a[2] + a[3]);
    kv += __shfl_xor_sync(kFullMask, kv, 1);
    kv += __shfl_xor_sync(kFullMask, kv, 2);
    const float delta = (vt - kv) * beta_t;

    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < R; ++j) {
      s[j] = fmaf(kk[4 * j + part], delta, s[j]);
      c[j & 3] = fmaf(s[j], qq[4 * j + part], c[j & 3]);
    }
    float out = (c[0] + c[1]) + (c[2] + c[3]);
    out += __shfl_xor_sync(kFullMask, out, 1);
    out += __shfl_xor_sync(kFullMask, out, 2);
    if (live && part == 0)
      o[(((size_t)b * T + t) * Hv + h) * dv + col] = out;
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < R; ++j) S[(size_t)(4 * j + part) * dv + col] = s[j];
  }
}

template <int DK>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* g, const float* beta, float* state, float* o,
                   int B, int T, int Hk, int Hv, int dv, cudaStream_t st) {
  const dim3 grid((dv + kCols - 1) / kCols, Hv, B);
  gated_delta_k9<DK><<<grid, kThreads, 0, st>>>(q, k, v, g, beta, state, o,
                                                 T, Hk, Hv, dv);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- chunked

constexpr int kChunk = 64;              // tokens a chunk
constexpr int kChunkThreads = 256;      // 8 warps, either phase
constexpr int kLdC = kChunk + 4;        // [C][C] tiles: A reads conflict-free
constexpr int kLdN = kCols + 8;         // [k][32] tiles: B reads conflict-free

// Rows 16 mb .. 16 mb + 15 of L X for a lower triangular L [C][C] in
// shared memory (its columns past 16 mb + 15 are zero and skipped) and
// X [C][N] (row j scaled by sc[j]), columns [N/2 nh, N/2 nh + N/2), written
// from the accumulators to out [C][N]. Row block mb costs 2 mb + 2 k
// steps, so a caller gives a warp the pair (mb, 3 - mb): 10 steps each.
template <int N, int LDX>
__device__ __forceinline__ void lower_times(const float* sL, const float* sX,
                                            const float* sc, int mb, int nh,
                                            int lane, float* out) {
  constexpr int NT = N / 16;
  float acc[NT][4] = {};
  for (int ks = 0; ks < 2 * mb + 2; ++ks) {
    const FragA a = load_a(sL, kLdC, 16 * mb, 8 * ks, lane);
    FragB b[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      b[nt] = load_b_kn(sX, LDX, 8 * ks, N / 2 * nh + 8 * nt, lane, sc);
    mma3_row<NT>(acc, a, b);
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(
          out + (16 * mb + g + 8 * hf) * N + N / 2 * nh + 8 * nt + 2 * t) =
          make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
}

template <int DK, int DV>
struct ChunkSmem {
  static constexpr int kLdK = DK + 4;   // [C][dk]: A and [n][k] B conflict-free
  static constexpr int kLdV = DV + 8;   // [C][dv] read as [k][n] B
  static constexpr int kLdQV = kLdK > kLdV ? kLdK : kLdV;
  // phase 1: K, Q (then V), A, T, G, beta, beta e^G
  static constexpr int kPrep =
      4 * (kChunk * kLdK + kChunk * kLdQV + 2 * kChunk * kLdC + 3 * kChunk);
  // phase 2: W, Q, K, P, U0, G, S, U, U scaled
  static constexpr int kScan =
      4 * (3 * kChunk * kLdK + kChunk * kLdC + kChunk * kLdN + kChunk +
           DK * kLdN + 2 * kChunk * kLdN);
};

// Phase 1: one CTA per (chunk, value head, row); W, U0, P and G of the
// chunk into the scratch ([B][Hv][NC] blocks of C x dk, C x dv, C x C, C).
template <int DK, int DV>
__global__ void __launch_bounds__(kChunkThreads, 2)
    gated_delta_chunk(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ g,
                      const float* __restrict__ beta, float* __restrict__ W,
                      float* __restrict__ U0, float* __restrict__ P,
                      float* __restrict__ Gs, int T, int Hk, int Hv) {
  using L = ChunkSmem<DK, DV>;
  constexpr int LK = L::kLdK, LV = L::kLdV;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sQV = sK + kChunk * LK;
  float* sA = sQV + kChunk * L::kLdQV;
  float* sT = sA + kChunk * kLdC;
  float* sG = sT + kChunk * kLdC;
  float* sBeta = sG + kChunk;
  float* sWs = sBeta + kChunk;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hv / Hk);
  const int t0 = c * kChunk, n = min(kChunk, T - t0);
  const size_t blk = ((size_t)b * Hv + h) * gridDim.x + c;

  // the chunk's q and k rows, zeros past the sequence's end
  for (int idx = tid; idx < kChunk * DK / 4; idx += kChunkThreads) {
    const int i = idx / (DK / 4), d = idx % (DK / 4) * 4;
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), qx = kx;
    if (i < n) {
      const size_t off = (((size_t)b * T + t0 + i) * Hk + hk) * DK + d;
      kx = *reinterpret_cast<const float4*>(k + off);
      qx = *reinterpret_cast<const float4*>(q + off);
    }
    *reinterpret_cast<float4*>(sK + i * LK + d) = kx;
    *reinterpret_cast<float4*>(sQV + i * LK + d) = qx;
  }
  if (warp == 0) {
    // G: the inclusive cumulative sum of g (0 past the end, so G stays at
    // the last token's); a lane holds tokens 2 lane and 2 lane + 1
    float gv[2], bv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * lane + e;
      const size_t off = ((size_t)b * T + t0 + i) * Hv + h;
      gv[e] = i < n ? g[off] : 0.f;
      bv[e] = i < n ? beta[off] : 0.f;
    }
    const float pair = gv[0] + gv[1];
    float incl = pair;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float up = __shfl_up_sync(kFullMask, incl, s);
      if (lane >= s) incl += up;
    }
    const float G0 = (incl - pair) + gv[0], G1 = G0 + gv[1];
    sG[2 * lane] = G0;
    sG[2 * lane + 1] = G1;
    sBeta[2 * lane] = bv[0];
    sBeta[2 * lane + 1] = bv[1];
    sWs[2 * lane] = bv[0] * expf(G0);
    sWs[2 * lane + 1] = bv[1] * expf(G1);
    *reinterpret_cast<float2*>(Gs + blk * kChunk + 2 * lane) =
        make_float2(G0, G1);
  }
  __syncthreads();

  // K K^T (warps 0-3) and Q K^T (warps 4-7): of the 16 x 8 tiles on or
  // below the diagonal (2 mb + 2 in row block mb, 20 in all) a warp takes
  // rows 16 mb' of both row blocks of a pair, (0, 3) or (1, 2), and half
  // of their tiles: 5 each. Then masked and decayed: A into shared
  // memory, P into the scratch; the tiles above the diagonal are zeros.
  {
    const bool qk = warp >= 4;
    const int j4 = warp & 3;
    const int p0 = j4 >> 1, p1 = 3 - p0;    // row blocks of 1 + p0 and
    const int par = j4 & 1;                 // 4 - p0 tiles (nt % 2 = par)
    const float* sa = qk ? sQV : sK;
    float* Pc = P + blk * kChunk * kChunk;
    const int gq = lane >> 2, t = lane & 3;
    int tmb[5], tnt[5];
#pragma unroll
    for (int m = 0; m < 5; ++m) {
      const bool first = m <= p0;
      tmb[m] = first ? p0 : p1;
      tnt[m] = par + 2 * (first ? m : m - p0 - 1);
    }
    float acc[5][4] = {};
#pragma unroll 4
    for (int ks = 0; ks < DK / 8; ++ks) {
      const FragA a0 = load_a(sa, LK, 16 * p0, 8 * ks, lane);
      const FragA a1 = load_a(sa, LK, 16 * p1, 8 * ks, lane);
      FragA a[5];
      FragB b[5];
#pragma unroll
      for (int m = 0; m < 5; ++m) {
        a[m] = m <= p0 ? a0 : a1;
        b[m] = load_b_nk(sK, LK, 8 * ks, 8 * tnt[m], lane);
      }
      mma3_each<5>(acc, a, b);
    }
    // the warp's tiles, masked and decayed
#pragma unroll
    for (int m = 0; m < 5; ++m)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 16 * tmb[m] + gq + 8 * hf;
        const int j0 = 8 * tnt[m] + 2 * t;
        float val[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + e;
          val[e] = 0.f;
          if (qk ? j <= i : j < i) {
            const float decay = expf(sG[i] - sG[j]);   // j <= i only
            val[e] = qk ? decay * acc[m][2 * hf + e]
                        : (sBeta[i] * decay) * acc[m][2 * hf + e];
          }
        }
        if (qk)
          *reinterpret_cast<float2*>(Pc + i * kChunk + j0) =
              make_float2(val[0], val[1]);
        else
          *reinterpret_cast<float2*>(sA + i * kLdC + j0) =
              make_float2(val[0], val[1]);
      }
    // and zeros in its three tiles above the diagonal: 3 - p0 in row
    // block p0, p0 in row block p1
#pragma unroll
    for (int z = 0; z < 3; ++z) {
      const bool first = z < 3 - p0;
      const int mb = first ? p0 : p1;
      const int nt = par + 2 * (first ? p0 + 1 + z : p1 + 1 + z - (3 - p0));
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 16 * mb + gq + 8 * hf, j0 = 8 * nt + 2 * t;
        if (qk)
          *reinterpret_cast<float2*>(Pc + i * kChunk + j0) =
              make_float2(0.f, 0.f);
        else
          *reinterpret_cast<float2*>(sA + i * kLdC + j0) =
              make_float2(0.f, 0.f);
      }
    }
  }
  __syncthreads();

  // V into Q's buffer (Q is read), in flight during the solve
  for (int idx = tid; idx < kChunk * DV / 4; idx += kChunkThreads) {
    const int i = idx / (DV / 4), d = idx % (DV / 4) * 4;
    const bool in = i < n;
    cp_async16(sQV + i * LV + d,
               v + (((size_t)b * T + t0 + (in ? i : 0)) * Hv + h) * DV + d,
               in ? 16 : 0);
  }
  cp_async_commit();

  // T = (I + A)^-1 by forward substitution: column tid / 4, its rows
  // 4 m + part in this thread; x_i = [i == col] - sum_{j<i} A_ij x_j
  // (each column of a unit triangular system is independent: no barrier)
  {
    const int col = tid >> 2, part = tid & 3;
    float xs[kChunk / 4];
#pragma unroll
    for (int m = 0; m < kChunk / 4; ++m) xs[m] = 0.f;
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int m = 0; m < (i + 3) / 4; ++m) {   // A_ij = 0 for j >= i
        const float a = sA[i * kLdC + 4 * m + part];
        if (m & 1)
          s1 = fmaf(a, xs[m], s1);
        else
          s0 = fmaf(a, xs[m], s0);
      }
      float s = s0 + s1;
      s += __shfl_xor_sync(kFullMask, s, 1);
      s += __shfl_xor_sync(kFullMask, s, 2);
      const float x = (i == col ? 1.f : 0.f) - s;
      if ((i & 3) == part) xs[i >> 2] = x;
    }
#pragma unroll
    for (int m = 0; m < kChunk / 4; ++m)
      sT[(4 * m + part) * kLdC + col] = xs[m];
  }
  cp_async_wait<0>();
  __syncthreads();

  // W = T diag(beta e^G) K (warps 0-3) and U0 = T diag(beta) V (warps
  // 4-7): row blocks (0, 3) or (1, 2), column half warp % 2
  const int pair = (warp >> 1) & 1, nh = warp & 1;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int mb = m == 0 ? pair : 3 - pair;
    if (warp < 4)
      lower_times<DK, LK>(sT, sK, sWs, mb, nh, lane, W + blk * kChunk * DK);
    else
      lower_times<DV, LV>(sT, sQV, sBeta, mb, nh, lane,
                          U0 + blk * kChunk * DV);
  }
}

// Phase 2: one CTA per (32 value columns, value head, row), the scan over
// the chunks. Warps 0-3 (the state warps) hold S[32 w .. 32 w + 31][cols]
// in their accumulators and compute U; warps 4-7 (the output warps)
// compute O for rows 16 (w - 4) .. + 15.
template <int DK, int DV>
__global__ void __launch_bounds__(kChunkThreads, 1)
    gated_delta_chunk_scan(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ W,
                           const float* __restrict__ U0,
                           const float* __restrict__ P,
                           const float* __restrict__ Gs,
                           float* __restrict__ state, float* __restrict__ o,
                           int T, int Hk, int Hv) {
  using L = ChunkSmem<DK, DV>;
  constexpr int LK = L::kLdK;
  extern __shared__ __align__(16) float smem[];
  float* sW = smem;
  float* sQ = sW + kChunk * LK;
  float* sK = sQ + kChunk * LK;
  float* sP = sK + kChunk * LK;
  float* sU0 = sP + kChunk * kLdC;
  float* sG = sU0 + kChunk * kLdN;
  float* sS = sG + kChunk;
  float* sU = sS + DK * kLdN;
  float* sUd = sU + kChunk * kLdN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * kCols, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hv / Hk);
  const int NC = (T + kChunk - 1) / kChunk;
  const int wg = warp & 3;
  const bool state_warp = warp < 4;
  const int gq = lane >> 2, t = lane & 3;

  auto rows_of = [&](const float* x, int c, float* dst) {
    // the chunk's rows of q or k (zeros past the end)
    const int t0 = c * kChunk, n = min(kChunk, T - t0);
    for (int idx = tid; idx < kChunk * DK / 4; idx += kChunkThreads) {
      const int i = idx / (DK / 4), d = idx % (DK / 4) * 4;
      const bool in = i < n;
      cp_async16(dst + i * LK + d,
                 x + (((size_t)b * T + t0 + (in ? i : 0)) * Hk + hk) * DK + d,
                 in ? 16 : 0);
    }
  };
  auto fetch_wq = [&](int c) {
    const float* Wc = W + (((size_t)b * Hv + h) * NC + c) * kChunk * DK;
    for (int idx = tid; idx < kChunk * DK / 4; idx += kChunkThreads) {
      const int i = idx / (DK / 4), d = idx % (DK / 4) * 4;
      cp_async16(sW + i * LK + d, Wc + i * DK + d, 16);
    }
    rows_of(q, c, sQ);
  };
  auto fetch_kpug = [&](int c) {
    const size_t blk = ((size_t)b * Hv + h) * NC + c;
    rows_of(k, c, sK);
    const float* Pc = P + blk * kChunk * kChunk;
    for (int idx = tid; idx < kChunk * kChunk / 4; idx += kChunkThreads) {
      const int i = idx / (kChunk / 4), j = idx % (kChunk / 4) * 4;
      cp_async16(sP + i * kLdC + j, Pc + i * kChunk + j, 16);
    }
    const float* Uc = U0 + blk * kChunk * DV + col0;
    for (int idx = tid; idx < kChunk * kCols / 4; idx += kChunkThreads) {
      const int i = idx / (kCols / 4), j = idx % (kCols / 4) * 4;
      cp_async16(sU0 + i * kLdN + j, Uc + i * DV + j, 16);
    }
    if (tid < kChunk / 4)
      cp_async16(sG + 4 * tid, Gs + blk * kChunk + 4 * tid, 16);
  };

  fetch_wq(0);
  cp_async_commit();
  fetch_kpug(0);
  cp_async_commit();

  // the state's slice: rows 32 wg + 16 mt + gq (+ 8), columns 8 nt + 2 t
  float* Sg = state + ((size_t)b * Hv + h) * DK * DV + col0;
  float sacc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int d = 32 * wg + 16 * mt + gq + 8 * hf, j = 8 * nt + 2 * t;
        float2 x = make_float2(0.f, 0.f);
        if (state_warp) {
          x = *reinterpret_cast<const float2*>(Sg + (size_t)d * DV + j);
          *reinterpret_cast<float2*>(sS + d * kLdN + j) = x;
        }
        sacc[mt][nt][2 * hf] = x.x;
        sacc[mt][nt][2 * hf + 1] = x.y;
      }

  for (int c = 0; c < NC; ++c) {
    const int t0 = c * kChunk, n = min(kChunk, T - t0);
    cp_async_wait<1>();    // this chunk's W and Q
    __syncthreads();

    // (1) W S (state warps) or Q S (output warps), 16 rows x 32 columns
    float acc[4][4] = {};
    {
      const float* sa = state_warp ? sW : sQ;
#pragma unroll 4
      for (int ks = 0; ks < DK / 8; ++ks) {
        const FragA a = load_a(sa, LK, 16 * wg, 8 * ks, lane);
        FragB b[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          b[nt] = load_b_kn(sS, kLdN, 8 * ks, 8 * nt, lane);
        mma3_row<4>(acc, a, b);
      }
    }
    __syncthreads();
    if (c + 1 < NC) fetch_wq(c + 1);
    cp_async_commit();
    cp_async_wait<1>();    // this chunk's K, P, U0 and G
    __syncthreads();

    // (2) U = U0 - W S, and U scaled by e^{G_C - G}; O's first term
    const float gc = sG[n - 1];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * wg + gq + 8 * (e >> 1);
        const int j = 8 * nt + 2 * t + (e & 1);
        if (state_warp) {
          const float u = sU0[i * kLdN + j] - acc[nt][e];
          sU[i * kLdN + j] = u;
          sUd[i * kLdN + j] = expf(gc - sG[i]) * u;
        } else {
          acc[nt][e] = expf(sG[i]) * acc[nt][e];
        }
      }
    __syncthreads();

    // (3) S = e^{G_C} S + K^T Ud (state warps); O += P U (output warps)
    if (state_warp) {
      const float dec = expf(gc);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[mt][nt][e] *= dec;
#pragma unroll 2
      for (int ks = 0; ks < kChunk / 8; ++ks) {
        FragB bf[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          bf[nt] = load_b_kn(sUd, kLdN, 8 * ks, 8 * nt, lane);
        FragA a[2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          a[mt] = load_a_t(sK, LK, 32 * wg + 16 * mt, 8 * ks, lane);
        mma3_grid<2, 4>(sacc, a, bf);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<float2*>(
                sS + (32 * wg + 16 * mt + gq + 8 * hf) * kLdN + 8 * nt +
                2 * t) = make_float2(sacc[mt][nt][2 * hf],
                                     sacc[mt][nt][2 * hf + 1]);
    } else {
      for (int ks = 0; ks < 2 * wg + 2; ++ks) {   // P is lower triangular
        const FragA a = load_a(sP, kLdC, 16 * wg, 8 * ks, lane);
        FragB b[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          b[nt] = load_b_kn(sU, kLdN, 8 * ks, 8 * nt, lane);
        mma3_row<4>(acc, a, b);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 16 * wg + gq + 8 * hf;
        if (i < n) {
          float* orow = o + (((size_t)b * T + t0 + i) * Hv + h) * DV + col0;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            *reinterpret_cast<float2*>(orow + 8 * nt + 2 * t) =
                make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
        }
      }
    }
    __syncthreads();
    if (c + 1 < NC) fetch_kpug(c + 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

  if (state_warp) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int d = 32 * wg + 16 * mt + gq + 8 * hf;
          *reinterpret_cast<float2*>(Sg + (size_t)d * DV + 8 * nt + 2 * t) =
              make_float2(sacc[mt][nt][2 * hf], sacc[mt][nt][2 * hf + 1]);
        }
  }
}

template <int DK, int DV>
cudaError_t launch_chunked(const float* q, const float* k, const float* v,
                           const float* g, const float* beta, float* state,
                           float* o, float* W, float* U0, float* P, float* Gs,
                           int B, int T, int Hk, int Hv, cudaStream_t st) {
  using L = ChunkSmem<DK, DV>;
  static bool attrs = false;
  if (!attrs) {
    cudaError_t e = cudaFuncSetAttribute(
        gated_delta_chunk<DK, DV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::kPrep);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gated_delta_chunk_scan<DK, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kScan);
    if (e != cudaSuccess) return e;
    attrs = true;
  }
  const int NC = (T + kChunk - 1) / kChunk;
  gated_delta_chunk<DK, DV><<<dim3(NC, Hv, B), kChunkThreads, L::kPrep, st>>>(
      q, k, v, g, beta, W, U0, P, Gs, T, Hk, Hv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  gated_delta_chunk_scan<DK, DV>
      <<<dim3(DV / kCols, Hv, B), kChunkThreads, L::kScan, st>>>(
          q, k, W, U0, P, Gs, state, o, T, Hk, Hv);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K9 on `stream` (see above). dk is 32, 64, 128 or 256; Hv a multiple of
// Hk; B and Hv at most 65535. Returns the first CUDA error (an argument
// the kernel does not take: cudaErrorInvalidValue, nothing launched).
int ominix_gated_delta(const void* q, const void* k, const void* v,
                       const void* g, const void* beta, void* state, void* o,
                       int B, int T, int Hk, int Hv, int dk, int dv,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || T < 1 || Hk < 1 || Hv < 1 || dv < 1 || Hv % Hk != 0 ||
      B > 65535 || Hv > 65535)
    return (int)cudaErrorInvalidValue;
  const float* fq = (const float*)q;
  const float* fk = (const float*)k;
  const float* fv = (const float*)v;
  const float* fg = (const float*)g;
  const float* fb = (const float*)beta;
  float* fs = (float*)state;
  float* fo = (float*)o;
  switch (dk) {
    case 32:
      return (int)launch<32>(fq, fk, fv, fg, fb, fs, fo, B, T, Hk, Hv, dv, st);
    case 64:
      return (int)launch<64>(fq, fk, fv, fg, fb, fs, fo, B, T, Hk, Hv, dv, st);
    case 128:
      return (int)launch<128>(fq, fk, fv, fg, fb, fs, fo, B, T, Hk, Hv, dv,
                              st);
    case 256:
      return (int)launch<256>(fq, fk, fv, fg, fb, fs, fo, B, T, Hk, Hv, dv,
                              st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The chunked form on `stream` (see above): dk = dv = 128 (k9_plan), Hv a
// multiple of Hk, B and Hv at most 65535. W, U0, P and G are the float32
// scratch of NC = ceil(T / 64) chunks a (row, value head): B Hv NC x
// (64 dk, 64 dv, 64 x 64, 64) floats, every element written by phase 1
// before phase 2 reads it. Returns the first CUDA error.
int ominix_gated_delta_chunked(const void* q, const void* k, const void* v,
                               const void* g, const void* beta, void* state,
                               void* o, void* W, void* U0, void* P, void* G,
                               int B, int T, int Hk, int Hv, int dk, int dv,
                               void* stream) {
  if (B < 1 || T < 1 || Hk < 1 || Hv < 1 || Hv % Hk != 0 || B > 65535 ||
      Hv > 65535 || dk != 128 || dv != 128)
    return (int)cudaErrorInvalidValue;
  return (int)launch_chunked<128, 128>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)g,
      (const float*)beta, (float*)state, (float*)o, (float*)W, (float*)U0,
      (float*)P, (float*)G, B, T, Hk, Hv, (cudaStream_t)stream);
}

}  // extern "C"
