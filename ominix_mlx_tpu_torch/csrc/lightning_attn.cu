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
// The chunked form (prompts, D = 128), chunks of C = 64 tokens, in ONE
// launch with no scratch in device memory. With a scalar decay per head it
// needs no UT transform: per (row, head) and chunk of n tokens, with S the
// state at the chunk's start,
//   O = (Q K^T * M) V + diag(lambda^(i+1)) Q S,  M_ij = lambda^(i-j), j <= i
//   S <- lambda^n S + K^T diag(lambda^(n-1-j)) V
// A short final chunk is masked (its rows past n read as zeros, its decays
// those of length n), not zero-padded: the JAX package's pad-and-correct's
// function. Grid (D / 32, head, row), 8 warps: a CTA walks the chunks of
// its (row, head) in order for 32 value columns, the state's column block
// in its mma accumulators from the first chunk to the last, so no
// increment goes to device memory; o is written once and the state read
// and written once. Q K^T is recomputed by each of the four CTAs of a head
// (about a fifth of the products): 128 CTAs at MiniCPM-SALA's 32 heads at
// B = 1, one wave of 132 SMs.
//   * Precision: bf16 q, k and v are exact bf16 operands, so Q K^T is exact
//     products summed in float32. The float32 operands (P, rev * V and the
//     state) are split ONCE a chunk into three bf16 pieces (hi, mid, lo:
//     about 2^-24 relative together) and each piece meets the bf16 operand:
//     three products for about float32's precision (the pieces of a
//     product are stacked as extra columns of one wgmma where they are
//     the B operand, so the A operand is read once for all three).
//   * lightning_chunk_bf16 (bf16 inputs, the model's path) runs on wgmma:
//     two warpgroups, each holding 64 of the state's 128 rows. After one
//     barrier warpgroup 0 issues Q K^T (m64n64k16) and warpgroup 1 Q S
//     (m64n96k16 over the state's three pieces) while every warp writes
//     V^T and rev * V's pieces (ldmatrix .trans, stmatrix); after a second,
//     warpgroup 0 masks and decays Q K^T in registers into P's pieces as
//     the A operand of P V, each warpgroup updates its state rows with
//     K^T (rev * V) (A = K^T read transposed from the stage as landed),
//     warpgroup 1 hands lambda^(i+1) Q S to warpgroup 0 through shared
//     memory (a named barrier) and warpgroup 0 writes o; the new state's
//     pieces go, transposed by stmatrix, to the other of two state
//     buffers. The next chunk's q, k, v are copied by cp.async into the
//     other stage of a two-stage ring meanwhile. About 145 KiB of shared
//     memory (128-byte swizzled tiles).
//   * lightning_chunk_f32 (float32 inputs) keeps the same walk on mma.sync
//     m16n8k16 (ldmatrix from 16-byte padded rows), q, k and v split into
//     pieces too (six piece pairs a product), one stage.
// What bounds it on an H100: at MiniCPM-SALA's 32 heads of 128, T = 2048,
// the bytes (q, k, v in bf16, o in float32 and the state once: 26.3 us at
// 3.35 TB/s) against the products (6.4 GFLOP: 13 us at the TF32 peak; the
// bf16 pieces make about 2.5 M multiply-adds a chunk and CTA); the chunks
// of a CTA are serial. On an H100 80GB HBM3 at 700.00 W (PERF.md section 6)
// the bf16 form takes about 2.5 us a chunk, against about 0.7 us for its
// products at the bf16 peak.
//
// The decode mixer (lightning_decode, counter k10_decode): a lightning
// layer's whole step at T = 1 between its projections and o_proj, in one
// launch: QK-RMSNorm, RoPE, q * D^-0.5, the state step, the cast of o to
// bf16, the output RMSNorm over the row's H * D values and the gate
// sigmoid(z) (ominix_mlx_tpu/models/minicpm_sala.py:158-184 at T = 1;
// the plain version ops/lightning_attention.py lightning_decode_reference
// runs some 65 PyTorch ops for it). What bounds it on an H100: bytes, the
// state read and written once (2 MiB each way at 32 heads of 128, B = 1);
// in a host-bound decode step, the launches it replaces. Each step rounds
// where the plain path rounds (bf16 after each norm, the weight, RoPE's
// float32 rotation, the scale, the cast, the gate; float32 expf, cosf,
// sinf and rsqrtf, no intrinsics), and the two RMSNorms sum their squares
// in the order PyTorch's CUDA reduction does (ATen/native/cuda/Reduce.cuh:
// a 128-wide row by one warp, a lane's 4-vector in order then a
// shuffle-down tree; the output row by a block of norm_bw threads that the
// wrapper derives from the same heuristic), so q, k and the state come out
// bit for bit as the plain path's and the output differs only where o's
// float32 sum (another order than cuBLAS's) rounds to another bf16. Grid
// (D / 32, head, row) of 128 threads, at most 64 registers (8 CTAs an SM:
// B = 8 in one wave): a thread owns 4 adjacent value columns x 8 state
// rows, loaded first as 16-byte vectors (before the dependent-launch wait
// where the caller allows it: nothing just before on the stream writes
// the state); two warps normalize q and k while the other two compute
// RoPE's 64 cos and sin once (accurate sinf / cosf: position 524287 takes
// their slow path) and the gates of the CTA's columns; the update keeps
// the plain version's two roundings (lambda S, then + k v), S^T q folds
// the 16 row groups by two shuffles and a fixed sum over the 4 warps. The
// output norm spans the row: each CTA writes its 32 bf16 values and
// gates, draws a ticket of its row and only then writes its state (so the
// ticket's fence waits for none of it); the last drawer reads the row,
// the weights and the gates at once, sums the squares in PyTorch's order,
// normalizes, gates and writes the row, and sets the ticket back to zero
// (tickets and gates kept per device by the wrapper: no memset,
// graph-replayable). On an H100 80GB HBM3 at 700.00 W (PERF.md section 6)
// it takes about 6.3 us alone at B = 1: 2.3 to the new state, 1.7 for the
// ticket, 2.5 for the last CTA's row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kCols = 32;          // value columns a CTA
constexpr int kThreads = 4 * kCols;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kChunk = 64;         // tokens a chunk

// element strides of a [B, H, T, D] input (unit stride along D)
struct Strides {
  long long b, h, t;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// ------------------------------------------------------------ decode mixer

constexpr int kDecD = 128;
constexpr int kDecMaxRow = 4096;   // H * D of an output row (H <= 32)
constexpr int kDecVecs = kDecMaxRow / 8 / 128;   // 16-byte pieces a thread
constexpr int kDecMaxBw = 512;     // PyTorch's reduction block, at most

struct DecodeArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  long long qb, qh, kb, kh, vb, vh;      // element strides (row, head)
  const __nv_bfloat16* z;                // gate input, row stride zb; or null
  long long zb;
  const __nv_bfloat16* q_norm;           // [D] each, or both null
  const __nv_bfloat16* k_norm;
  const __nv_bfloat16* o_norm;           // [H D] or null
  const long long* offsets;              // [B] positions, or null: pos0
  long long pos0;
  const float* slopes;
  float* state;
  __nv_bfloat16* out;                    // [B, H D]
  __nv_bfloat16* qk_out;                 // [B, 2, H D] q and k, or null
  int* tickets;                          // [B], zero (o_norm only)
  __nv_bfloat16* gates;                  // [B, H D] scratch (o_norm, z)
  float eps, rope_c, scale, o_factor;
  int H, rope, norm_bw;
};

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
// torch.sigmoid of a bf16 value: 1 / (1 + exp(-z)) in float32, to bf16
__device__ __forceinline__ float sigmoid_bf16(float z) {
  return bf16r(1.f / (1.f + expf(-z)));
}

// Adds one to a ticket after the CTA's writes (a barrier before it) and
// returns the ticket's old value: a release fence before the atomic and an
// acquire fence after it at GPU scope, so the drawer of the last ticket
// sees every other CTA's writes.
__device__ __forceinline__ int draw_ticket(int* t) {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  const int old = atomicAdd(t, 1);
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
  return old;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__global__ void __launch_bounds__(kThreads, 8)   // 8 CTAs an SM: B = 8
    lightning_decode(const DecodeArgs a) {         // in one wave
  constexpr int D = kDecD;
  static_assert(kThreads == 128 && kCols == 32,
                "8 column quads x 16 row groups");
  __shared__ float s_qk[2][D];
  __shared__ float s_cos[D / 2], s_sin[D / 2];
  __shared__ float s_red[4][kCols];
  __shared__ float s_part[kThreads];
  __shared__ __align__(16) __nv_bfloat16 s_row[kDecMaxRow];
  __shared__ float s_inv;
  __shared__ bool s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cq = tid & 7, rg = tid >> 3;     // column quad, row group
  const int h = blockIdx.y, b = blockIdx.z, H = a.H, N = H * D;
  const int c0 = blockIdx.x * kCols + 4 * cq;
  const int col = h * D + blockIdx.x * kCols + lane;    // warp 0's column

  // the state strip first: rows rg + 16 i, columns c0..c0+3
  float* S = a.state + ((size_t)b * H + h) * D * D + c0;
  float s[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 t =
        *reinterpret_cast<const float4*>(S + (size_t)(rg + 16 * i) * D);
    s[i][0] = t.x;
    s[i][1] = t.y;
    s[i][2] = t.z;
    s[i][3] = t.w;
  }
  const float lam = expf(a.slopes[h]);
  // the row's last CTA reads the whole row's o_norm and z: each CTA pulls
  // its own columns' into L2
  if (tid == 96 && a.o_norm != nullptr) prefetch_l2(a.o_norm + col - lane);
  griddep_wait();

  float x[4];
  if (warp < 2) {      // warp 0: q, warp 1: k of head h, 4 values a lane
    const __nv_bfloat16* src = warp == 0 ? a.q + b * a.qb + h * a.qh
                                         : a.k + b * a.kb + h * a.kh;
    const uint2 u = *reinterpret_cast<const uint2*>(src + 4 * lane);
    x[0] = bf16_lo(u.x);
    x[1] = bf16_hi(u.x);
    x[2] = bf16_lo(u.y);
    x[3] = bf16_hi(u.y);
    const __nv_bfloat16* w = warp == 0 ? a.q_norm : a.k_norm;
    if (w != nullptr) {
      // mean(x^2) as PyTorch reduces a 128-wide row: the lane's vector in
      // order, then a shuffle-down tree
      float p = __fmul_rn(x[0], x[0]);
#pragma unroll
      for (int j = 1; j < 4; ++j) p = __fadd_rn(p, __fmul_rn(x[j], x[j]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        p = __fadd_rn(p, __shfl_down_sync(kFull, p, o));
      const float mean = __fmul_rn(__shfl_sync(kFull, p, 0), 1.f / D);
      const float inv = rsqrtf(__fadd_rn(mean, a.eps));
      const uint2 wu = *reinterpret_cast<const uint2*>(w + 4 * lane);
      const float wf[4] = {bf16_lo(wu.x), bf16_hi(wu.x), bf16_lo(wu.y),
                           bf16_hi(wu.y)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[j] = bf16r(__fmul_rn(bf16r(__fmul_rn(x[j], inv)), wf[j]));
    }
  } else if (a.rope) { // warps 2 and 3: RoPE's cos and sin, one angle a lane
    const int f = (warp - 2) * 32 + lane;
    const float pos =
        a.offsets != nullptr ? (float)a.offsets[b] : (float)a.pos0;
    const float ang = __fmul_rn(pos, expf(__fmul_rn(-(float)f, a.rope_c)));
    s_cos[f] = cosf(ang);
    s_sin[f] = sinf(ang);
  }
  const uint2 vu =
      *reinterpret_cast<const uint2*>(a.v + b * a.vb + h * a.vh + c0);
  const float vv[4] = {bf16_lo(vu.x), bf16_hi(vu.x), bf16_lo(vu.y),
                       bf16_hi(vu.y)};
  if (warp == 3 && a.o_norm != nullptr && a.z != nullptr)   // for the last
    a.gates[(size_t)b * N + col] =                           // CTA
        __float2bfloat16(sigmoid_bf16(__bfloat162float(a.z[b * a.zb + col])));
  __syncthreads();
  if (warp < 2) {
    if (a.rope) {      // half-split pairs (i, i + 64): lanes l and l ^ 16
      float other[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) other[j] = __shfl_xor_sync(kFull, x[j], 16);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = (4 * lane + j) & (D / 2 - 1);
        const float xc = __fmul_rn(x[j], s_cos[f]);
        const float os = __fmul_rn(other[j], s_sin[f]);
        x[j] = bf16r(lane < 16 ? __fsub_rn(xc, os) : __fadd_rn(xc, os));
      }
    }
    if (warp == 0) {
#pragma unroll
      for (int j = 0; j < 4; ++j) x[j] = bf16r(__fmul_rn(x[j], a.scale));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) s_qk[warp][4 * lane + j] = x[j];
    if (a.qk_out != nullptr)
      *reinterpret_cast<uint2*>(a.qk_out + ((size_t)b * 2 + warp) * N +
                                h * D + 4 * lane) =
          make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
  }
  __syncthreads();

  // S = lambda S + k v^T (the plain version's two roundings); o = S^T q
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rg + 16 * i;
    const float kr = s_qk[1][r], qr = s_qk[0][r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = __fadd_rn(__fmul_rn(s[i][j], lam), __fmul_rn(kr, vv[j]));
      acc[j] = fmaf(s[i][j], qr, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    acc[j] += __shfl_xor_sync(kFull, acc[j], 8);
    acc[j] += __shfl_xor_sync(kFull, acc[j], 16);
    if (lane < 8) s_red[warp][4 * cq + j] = acc[j];
  }
  __syncthreads();

  __nv_bfloat16* orow = a.out + (size_t)b * N;
  if (warp == 0) {
    float y =
        bf16r(((s_red[0][lane] + s_red[1][lane]) + s_red[2][lane]) +
              s_red[3][lane]);
    if (a.o_norm == nullptr && a.z != nullptr)
      y = bf16r(__fmul_rn(y, sigmoid_bf16(__bfloat162float(
                                 a.z[b * a.zb + col]))));
    orow[col] = __float2bfloat16(y);
  }
  if (a.o_norm != nullptr) {   // the output norm spans the row: a ticket
    __syncthreads();
    if (tid == 0)              // the CTA's values published, the others' seen
      s_last = draw_ticket(a.tickets + b) == (int)(gridDim.x * gridDim.y) - 1;
  }
  // the new state after the ticket, so the fence waits for none of it
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(S + (size_t)(rg + 16 * i) * D) =
        make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
  if (a.o_norm == nullptr) return;
  __syncthreads();
  if (!s_last) return;

  // the row's last CTA: the row, its o_norm weights and gates (each CTA's
  // sigmoid(z) of its columns) read at once, 16 bytes a piece; the row
  // staged in shared memory
  const __nv_bfloat16* grow = a.z != nullptr ? a.gates + (size_t)b * N
                                             : nullptr;
  uint4 xr[kDecVecs], wr[kDecVecs], gr[kDecVecs];
#pragma unroll
  for (int m = 0; m < kDecVecs; ++m) {
    const int e0 = 8 * (tid + kThreads * m);
    if (e0 < N) {
      xr[m] = __ldcg(reinterpret_cast<const uint4*>(orow + e0));
      wr[m] = *reinterpret_cast<const uint4*>(a.o_norm + e0);
      gr[m] = grow != nullptr
                  ? __ldcg(reinterpret_cast<const uint4*>(grow + e0))
                  : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(s_row + e0) = xr[m];
    }
  }
  __syncthreads();
  // mean(x^2) in the order of PyTorch's reduction over a block of norm_bw
  // threads along the row: thread vt sums its 4-vectors vt, vt + bw, ...
  // lane by lane, then its 4 lanes in order; then the tree of halving
  // offsets (here: those of 128 and up within a thread, which holds vt =
  // tid + 128 m; 64 and 32 in shared memory; then the warp's)
  const int bw = a.norm_bw;
  float v[kDecMaxBw / kThreads];
#pragma unroll
  for (int m = 0; m < kDecMaxBw / kThreads; ++m) {
    const int vt = tid + kThreads * m;
    float p[4] = {0.f, 0.f, 0.f, 0.f};
    if (vt < bw) {
      for (int vi = vt; 4 * vi < N; vi += bw) {
        const uint2 u = *reinterpret_cast<const uint2*>(s_row + 4 * vi);
        const float xv[4] = {bf16_lo(u.x), bf16_hi(u.x), bf16_lo(u.y),
                             bf16_hi(u.y)};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p[j] = __fadd_rn(p[j], __fmul_rn(xv[j], xv[j]));
      }
    }
    v[m] = __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), p[2]), p[3]);
  }
#pragma unroll
  for (int off = kDecMaxBw / 2; off >= kThreads; off >>= 1) {
    if (off < bw) {
#pragma unroll
      for (int m = 0; m < off / kThreads; ++m)
        v[m] = __fadd_rn(v[m], v[m + off / kThreads]);
    }
  }
  const int bx = min(bw, kThreads);
  if (tid < bx) s_part[tid] = v[0];
  __syncthreads();
  for (int off = bx / 2; off >= 32; off >>= 1) {
    if (tid < off) s_part[tid] = __fadd_rn(s_part[tid], s_part[tid + off]);
    __syncthreads();
  }
  if (warp == 0) {
    float p = s_part[lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      p = __fadd_rn(p, __shfl_down_sync(kFull, p, o));
    if (lane == 0) s_inv = rsqrtf(__fadd_rn(__fmul_rn(p, a.o_factor), a.eps));
  }
  __syncthreads();
  const float inv = s_inv;
#pragma unroll
  for (int m = 0; m < kDecVecs; ++m) {
    const int e0 = 8 * (tid + kThreads * m);
    if (e0 >= N) continue;
    const uint32_t xw[4] = {xr[m].x, xr[m].y, xr[m].z, xr[m].w};
    const uint32_t ww[4] = {wr[m].x, wr[m].y, wr[m].z, wr[m].w};
    const uint32_t gw[4] = {gr[m].x, gr[m].y, gr[m].z, gr[m].w};
    uint32_t yw[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float y0 = bf16r(__fmul_rn(bf16r(__fmul_rn(bf16_lo(xw[j]), inv)),
                                 bf16_lo(ww[j])));
      float y1 = bf16r(__fmul_rn(bf16r(__fmul_rn(bf16_hi(xw[j]), inv)),
                                 bf16_hi(ww[j])));
      if (grow != nullptr) {
        y0 = __fmul_rn(y0, bf16_lo(gw[j]));
        y1 = __fmul_rn(y1, bf16_hi(gw[j]));
      }
      yw[j] = pack_bf16(y0, y1);
    }
    *reinterpret_cast<uint4*>(orow + e0) = make_uint4(yw[0], yw[1], yw[2],
                                                      yw[3]);
  }
  if (tid == 0) a.tickets[b] = 0;
}

// ---------------------------------------------------------------- chunked

constexpr int kFThreads = 256;     // 8 warps
constexpr int kPieces = 3;         // bf16 pieces of a float32 operand

// 16-byte asynchronous copy global -> shared; src_bytes 0 zero-fills the
// destination without reading (the source stays a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// c += A (16 x 16) B (16 x 8), bf16 in, float32 accumulators (not
// volatile: the compiler may interleave independent products)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x0, x1 each as three bf16 pieces hi + mid + lo (word p holds piece p of
// both, x0 in the low half): hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid). Both differences are exact in float32, so the
// pieces carry x to about 2^-24 relative, and a product of a piece with a
// bf16 value is exact in the float32 accumulator.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t (&w)[3]) {
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    w[p] = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= __low2float(h);
    x1 -= __high2float(h);
  }
}

// d[nt] += (sum of a's NA pieces) (sum of b's NB pieces) over the piece
// pairs whose orders sum to at most 2 (a 1-piece operand is exact bf16),
// the small terms first
template <int NA, int NB, int NT>
__device__ __forceinline__ void mma_pieces(float (&d)[NT][4],
                                           const uint32_t (&a)[NA][4],
                                           const uint32_t (&b)[NB][NT][2]) {
#pragma unroll
  for (int s = 2; s >= 0; --s)
#pragma unroll
    for (int ia = 0; ia < NA; ++ia) {
      const int ib = s - ia;
      if (ib < 0 || ib >= NB) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16(d[nt], a[ia], b[ib][nt][0], b[ib][nt][1]);
    }
}

// Byte offsets of the ldmatrix.x4 rows a lane addresses in a bf16 tile
// with rows of `ld` bytes (every tile's rows are padded by 16 bytes, so the
// eight rows of one 8 x 8 matrix fall in eight bank groups):
// the A fragment (rows m0 .. + 15, columns k0 .. + 15) of a [m][k] tile
__device__ __forceinline__ int a_off(int ld, int m0, int k0, int lane) {
  return (m0 + (lane & 15)) * ld + (k0 + (lane >> 4) * 8) * 2;
}
// the A fragment of A = X^T for a [k][m] tile X (with ldmatrix .trans)
__device__ __forceinline__ int at_off(int ld, int m0, int k0, int lane) {
  const int mi = lane >> 3;
  return (k0 + (mi >> 1) * 8 + (lane & 7)) * ld + (m0 + (mi & 1) * 8) * 2;
}
// the B fragments of two n8 tiles (columns n0 .. + 15, k0 .. + 15) of
// B = X^T for a [n][k] tile X
__device__ __forceinline__ int bn_off(int ld, int n0, int k0, int lane) {
  const int mi = lane >> 3;
  return (n0 + (mi >> 1) * 8 + (lane & 7)) * ld + (k0 + (mi & 1) * 8) * 2;
}
// the same of a [k][n] tile (with ldmatrix .trans)
__device__ __forceinline__ int bk_off(int ld, int k0, int n0, int lane) {
  const int mi = lane >> 3;
  return (k0 + (mi & 1) * 8 + (lane & 7)) * ld + (n0 + (mi >> 1) * 8) * 2;
}

// Shared memory of the float32 form (bytes): the chunk's Q, K [C][D] and
// V's column block [C][32], each in NI = 3 pieces; P [C][C], rev * V [C]
// [32] and two buffers of the state's column block [D][32], each in three
// pieces; the powers lambda^d.
struct ChunkPlan {
  static constexpr int D = 128;
  static constexpr int NI = kPieces;
  static constexpr int kLdQ = D * 2 + 16;
  static constexpr int kLdV = kCols * 2 + 16;   // V, rev * V, the state
  static constexpr int kLdP = kChunk * 2 + 16;
  static constexpr int kQ = kChunk * kLdQ;      // one piece of Q or K
  static constexpr int kV = kChunk * kLdV;
  static constexpr int kS = D * kLdV;
  static constexpr int kP = kChunk * kLdP;
  static constexpr int oK = NI * kQ;
  static constexpr int oV = 2 * NI * kQ;
  static constexpr int oP = NI * (2 * kQ + kV);
  static constexpr int oVR = oP + kPieces * kP;
  static constexpr int oS = oVR + kPieces * kV;
  static constexpr int oPow = oS + 2 * kPieces * kS;
  static constexpr int kBytes = oPow + 4 * (kChunk + 4);
  static_assert(kBytes <= 232448, "one CTA's shared memory");
};

// The float32 form (float32 q, k, v, off the model's path): one CTA per
// (32 value columns, head, row) walks the chunks in order, the state's
// column block in its warps' mma.sync accumulators from the first chunk to
// the last (warp w: rows 16 w .. + 15); q, k and v are loaded and split
// into three pieces each a chunk (one stage).
__global__ void __launch_bounds__(kFThreads, 1)
    lightning_chunk_f32(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ slopes,
                        float* __restrict__ state, float* __restrict__ o,
                        int H, int T, Strides sq, Strides sk, Strides sv) {
  using L = ChunkPlan;
  constexpr int D = L::D, NI = L::NI;
  constexpr int LQ = L::kLdQ, LV = L::kLdV, LP = L::kLdP;
  extern __shared__ __align__(16) unsigned char smem[];
  float* pw = reinterpret_cast<float*>(smem + L::oPow);    // lambda^d
  const uint32_t sb = smem_u32(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * kCols, h = blockIdx.y, b = blockIdx.z;
  const int NC = (T + kChunk - 1) / kChunk;
  const size_t bh = (size_t)b * H + h;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h + c0;
  if (tid <= kChunk) pw[tid] = expf(slopes[h] * (float)tid);

  // the state's pieces into buffer `buf`, for the next chunk's Q S
  auto put_state = [&](const float (&s)[4][4], int buf) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t w[kPieces];
        split3(s[nt][2 * hf], s[nt][2 * hf + 1], w);
        const int off = L::oS + buf * kPieces * L::kS +
                        (16 * warp + g + 8 * hf) * LV + (8 * nt + 2 * t) * 2;
#pragma unroll
        for (int p = 0; p < kPieces; ++p)
          *reinterpret_cast<uint32_t*>(smem + off + p * L::kS) = w[p];
      }
  };
  float* Sg = state + bh * D * D + c0;
  float sacc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float2 x = *reinterpret_cast<const float2*>(
          Sg + (size_t)(16 * warp + g + 8 * hf) * D + 8 * nt + 2 * t);
      sacc[nt][2 * hf] = x.x;
      sacc[nt][2 * hf + 1] = x.y;
    }
  put_state(sacc, 0);

  // chunk c's Q, K and V block read into registers and stored as three
  // pieces each
  auto load_split = [&](int c) {
    const int t0 = c * kChunk, n = min(kChunk, T - t0);
    auto put = [&](const float* src, int r, int off, int piece_bytes) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < n) x = *reinterpret_cast<const float4*>(src);
      uint32_t lo[kPieces], hi[kPieces];
      split3(x.x, x.y, lo);
      split3(x.z, x.w, hi);
#pragma unroll
      for (int p = 0; p < kPieces; ++p)
        *reinterpret_cast<uint2*>(smem + off + p * piece_bytes) =
            make_uint2(lo[p], hi[p]);
    };
#pragma unroll 4
    for (int m = 0; m < kChunk * D / 4 / kFThreads; ++m) {
      const int idx = tid + m * kFThreads, r = idx / (D / 4),
                pc = idx % (D / 4);
      const int tr = r < n ? t0 + r : 0;
      put(qb + tr * sq.t + 4 * pc, r, r * LQ + pc * 8, L::kQ);
      put(kb + tr * sk.t + 4 * pc, r, L::oK + r * LQ + pc * 8, L::kQ);
    }
#pragma unroll
    for (int m = 0; m < kChunk * kCols / 4 / kFThreads; ++m) {
      const int idx = tid + m * kFThreads, r = idx / (kCols / 4),
                pc = idx % (kCols / 4);
      const int tr = r < n ? t0 + r : 0;
      put(vb + tr * sv.t + 4 * pc, r, L::oV + r * LV + pc * 8, L::kV);
    }
  };

  const int mb = warp >> 1, nh = warp & 1;
  for (int c = 0; c < NC; ++c) {
    const int t0 = c * kChunk, n = min(kChunk, T - t0);
    __syncthreads();              // chunk c - 1 is consumed by every warp
    load_split(c);
    __syncthreads();
    const uint32_t sQ = sb, sK = sQ + L::oK, sV = sQ + L::oV;
    const uint32_t sP = sb + L::oP, sVR = sb + L::oVR;
    const uint32_t sS = sb + L::oS + (c & 1) * kPieces * L::kS;

    // rev * V (rev_j = lambda^(n-1-j), 0 past n) in three pieces: a thread
    // per 8 columns of a row
    {
      const int r = tid >> 2, pc = tid & 3;
      const float rev = r < n ? pw[n - 1 - r] : 0.f;
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int p = 0; p < NI; ++p) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            smem + L::oV + p * L::kV + r * LV + pc * 16);
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[2 * i] += __uint_as_float(w[i] << 16);
          x[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
        }
      }
      uint32_t w[4][kPieces];
#pragma unroll
      for (int i = 0; i < 4; ++i) split3(x[2 * i] * rev, x[2 * i + 1] * rev,
                                         w[i]);
#pragma unroll
      for (int p = 0; p < kPieces; ++p)
        *reinterpret_cast<uint4*>(smem + L::oVR + p * L::kV + r * LV +
                                  pc * 16) =
            make_uint4(w[0][p], w[1][p], w[2][p], w[3][p]);
    }

    // Q K^T: warp (mb, nh) rows 16 mb .. + 15, columns 32 nh .. + 31,
    // unless every one lies above the diagonal; masked and decayed
    // (P_ij = lambda^(i-j) (Q K^T)_ij for j <= i, else 0) into P's pieces
    if (32 * nh <= 16 * mb + 15) {
      float acc[4][4] = {};
#pragma unroll 2
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t a[NI][4], bq[NI][4][2];
#pragma unroll
        for (int p = 0; p < NI; ++p) {
          ldsm_x4(sQ + p * L::kQ + a_off(LQ, 16 * mb, 16 * ks, lane), a[p]);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            uint32_t f[4];
            ldsm_x4(sK + p * L::kQ +
                        bn_off(LQ, 32 * nh + 16 * hh, 16 * ks, lane),
                    f);
            bq[p][2 * hh][0] = f[0];
            bq[p][2 * hh][1] = f[1];
            bq[p][2 * hh + 1][0] = f[2];
            bq[p][2 * hh + 1][1] = f[3];
          }
        }
        mma_pieces<NI, NI, 4>(acc, a, bq);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = 16 * mb + g + 8 * hf, j = 32 * nh + 8 * nt + 2 * t;
          uint32_t w[kPieces];
          split3(j <= i ? pw[i - j] * acc[nt][2 * hf] : 0.f,
                 j + 1 <= i ? pw[i - j - 1] * acc[nt][2 * hf + 1] : 0.f, w);
#pragma unroll
          for (int p = 0; p < kPieces; ++p)
            *reinterpret_cast<uint32_t*>(smem + L::oP + p * L::kP + i * LP +
                                         j * 2) = w[p];
        }
    }
    __syncthreads();              // P and rev * V are written

    // O = diag(lambda^(i+1)) Q S + P V: warp (mb, nh) rows 16 mb .. + 15,
    // columns 16 nh .. + 15 of the block; P is zero past column 16 mb + 15
    {
      float oacc[2][4] = {};
#pragma unroll 2
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t a[NI][4], bs[kPieces][2][2];
#pragma unroll
        for (int p = 0; p < NI; ++p)
          ldsm_x4(sQ + p * L::kQ + a_off(LQ, 16 * mb, 16 * ks, lane), a[p]);
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
          uint32_t f[4];
          ldsm_x4_t(sS + p * L::kS + bk_off(LV, 16 * ks, 16 * nh, lane), f);
          bs[p][0][0] = f[0];
          bs[p][0][1] = f[1];
          bs[p][1][0] = f[2];
          bs[p][1][1] = f[3];
        }
        mma_pieces<NI, kPieces, 2>(oacc, a, bs);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float dec = pw[16 * mb + g + 8 * hf + 1];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          oacc[nt][2 * hf] *= dec;
          oacc[nt][2 * hf + 1] *= dec;
        }
      }
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        if (ks > mb) break;
        uint32_t a[kPieces][4], bv[NI][2][2];
#pragma unroll
        for (int p = 0; p < kPieces; ++p)
          ldsm_x4(sP + p * L::kP + a_off(LP, 16 * mb, 16 * ks, lane), a[p]);
#pragma unroll
        for (int p = 0; p < NI; ++p) {
          uint32_t f[4];
          ldsm_x4_t(sV + p * L::kV + bk_off(LV, 16 * ks, 16 * nh, lane), f);
          bv[p][0][0] = f[0];
          bv[p][0][1] = f[1];
          bv[p][1][0] = f[2];
          bv[p][1][1] = f[3];
        }
        mma_pieces<kPieces, NI, 2>(oacc, a, bv);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 16 * mb + g + 8 * hf;
        if (i < n) {
          float* orow = o + (bh * T + t0 + i) * D + c0 + 16 * nh + 2 * t;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            *reinterpret_cast<float2*>(orow + 8 * nt) =
                make_float2(oacc[nt][2 * hf], oacc[nt][2 * hf + 1]);
        }
      }
    }

    // S <- lambda^n S + K^T (rev * V): warp w rows 16 w .. + 15, all 32
    // columns, in its accumulators
    {
      const float blk = pw[n];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[nt][e] *= blk;
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks) {
        uint32_t a[NI][4], bw[kPieces][4][2];
#pragma unroll
        for (int p = 0; p < NI; ++p)
          ldsm_x4_t(sK + p * L::kQ + at_off(LQ, 16 * warp, 16 * ks, lane),
                    a[p]);
#pragma unroll
        for (int p = 0; p < kPieces; ++p)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            uint32_t f[4];
            ldsm_x4_t(sVR + p * L::kV + bk_off(LV, 16 * ks, 16 * hh, lane),
                      f);
            bw[p][2 * hh][0] = f[0];
            bw[p][2 * hh][1] = f[1];
            bw[p][2 * hh + 1][0] = f[2];
            bw[p][2 * hh + 1][1] = f[3];
          }
        mma_pieces<NI, kPieces, 4>(sacc, a, bw);
      }
      if (c + 1 < NC) put_state(sacc, (c + 1) & 1);
    }
  }

#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(Sg + (size_t)(16 * warp + g + 8 * hf) * D +
                                 8 * nt + 2 * t) =
          make_float2(sacc[nt][2 * hf], sacc[nt][2 * hf + 1]);
}

// ------------------------------------------ chunked, bf16 inputs: wgmma

// D[64 x 96] += A[64 x 16] . B[16 x 96], A MN-major in shared memory (the
// transpose of a tile stored K-rows by M-columns), B K-major
__device__ __forceinline__ void wgmma_n96_ta(float (&d)[48], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

// store four 8 x 8 b16 matrices from their fragments (lanes 8 i .. 8 i + 7
// address the rows of matrix i), as they are or transposed
__device__ __forceinline__ void stsm_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1,%2,%3,%4};\n" ::"r"(
          addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}
__device__ __forceinline__ void stsm_x4_t(uint32_t addr,
                                          const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1,%2,%3,%4};\n" ::
          "r"(addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 128-byte swizzle of an offset inside 1024-byte aligned 8-row groups
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & 7) << 4);
}

// Shared memory of the bf16 form (bytes from a 1024-aligned base; every
// wgmma operand 128-byte swizzled, K-major unless said): two stages of the
// chunk's Q and K [2 column blocks of 64][C][64] and V's column block [C]
// [32] (row-major, read by threads only); V^T [32][C]; the three pieces of
// rev * V, transposed and stacked [3 x 32][C]; two buffers of the state's
// three pieces, transposed and stacked [2 blocks of 64 d][3 x 32][64]; the
// exchange of Q S between the warpgroups; the powers lambda^d.
struct WgPlan {
  static constexpr int D = 128;
  static constexpr int kQ = 2 * kChunk * 128;          // Q or K
  static constexpr int kLdV = kCols * 2 + 16;          // V's rows, padded
  static constexpr int kStage = (2 * kQ + kChunk * kLdV + 1023) / 1024 * 1024;
  static constexpr int oVt = 2 * kStage;
  static constexpr int oVR = oVt + kCols * 128;
  static constexpr int kStBlk = kPieces * kCols * 128;  // one 64-d block
  static constexpr int kSt = 2 * kStBlk;
  static constexpr int oSt = oVR + kStBlk;
  static constexpr int oX = oSt + 2 * kSt;
  static constexpr int oPow = oX + 16 * 128 * 4;
  static constexpr int kBytes = oPow + 4 * (kChunk + 4) + 1024;
  static_assert(kStage % 1024 == 0 && oVt % 1024 == 0 && oSt % 1024 == 0,
                "swizzled tiles start at 1024-byte boundaries");
  static_assert(kBytes <= 232448, "one CTA's shared memory");
};

// The bf16 form: the same walk as lightning_chunk_f32, on wgmma. Two
// warpgroups; the state's column block [D][32] is split between them by
// rows (warpgroup h holds d = 64 h .. + 63 in an m64n32 accumulator). A
// chunk, after one barrier: warpgroup 0 issues Q K^T (m64n64k16, both
// operands from the stage as landed), warpgroup 1 Q S (m64n96k16: B is the
// state's three pieces stacked as 96 columns, so Q is read once for all
// three); every thread meanwhile writes V^T and rev * V's pieces; a second
// barrier; then warpgroup 0 masks and decays Q K^T in registers into P's
// three pieces as the A operand of P V (m64n32k16, A from registers), and
// each warpgroup updates its state rows with K^T (rev * V) (m64n96k16, A =
// K^T read transposed from the stage); warpgroup 1 hands lambda^(i+1) Q S
// to warpgroup 0 through shared memory, which adds it to P V and writes o.
// The new state's pieces go to the other state buffer.
__global__ void __launch_bounds__(kFThreads, 1)
    lightning_chunk_bf16(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ slopes,
                       float* __restrict__ state, float* __restrict__ o,
                       int H, int T, Strides sq, Strides sk, Strides sv) {
  using L = WgPlan;
  constexpr int D = L::D;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_u32(sm);
  float* pw = reinterpret_cast<float*>(sm + L::oPow);        // lambda^d
  float* ox = reinterpret_cast<float*>(sm + L::oX);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wt = tid & 127;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * kCols, h = blockIdx.y, b = blockIdx.z;
  const int NC = (T + kChunk - 1) / kChunk;
  const size_t bh = (size_t)b * H + h;
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h + c0;
  if (tid <= kChunk) pw[tid] = expf(slopes[h] * (float)tid);

  // accumulator element e of an m64nN tile: row 16 (warp % 4) + g + 8
  // ((e >> 1) & 1), column 8 (e >> 2) + 2 t + (e & 1)
  const int r0 = 16 * (warp & 3) + g;
  // the state's pieces, transposed ([col][d]) into buffer `buf`, block wg,
  // by stmatrix .trans: the fragment of rows d = 16 (warp % 4) + 8 hf ..
  // + 7 and columns 8 j .. + 7 is one 8 x 8 matrix (lanes 8 i .. 8 i + 7
  // address matrix i: hf = i % 2, j = 2 x + i / 2 in store x)
  const int mi = lane >> 3, mr = lane & 7;
  auto put_state = [&](const float (&s)[16], int buf) {
    const uint32_t base = sb + L::oSt + buf * L::kSt + wg * L::kStBlk;
    uint32_t w[8][kPieces];                 // [2 j + hf][piece]
#pragma unroll
    for (int e = 0; e < 16; e += 2) split3(s[e], s[e + 1], w[e >> 1]);
#pragma unroll
    for (int p = 0; p < kPieces; ++p)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const uint32_t r[4] = {w[4 * x][p], w[4 * x + 1][p],
                               w[4 * x + 2][p], w[4 * x + 3][p]};
        stsm_x4_t(base + swz((p * kCols + 8 * (2 * x + (mi >> 1)) + mr) *
                                 128 +
                             (2 * (warp & 3) + (mi & 1)) * 16),
                  r);
      }
  };
  float* Sg = state + bh * D * D + (size_t)64 * wg * D + c0;
  float s[16];
#pragma unroll
  for (int e = 0; e < 16; e += 2) {
    const float2 x = *reinterpret_cast<const float2*>(
        Sg + (size_t)(r0 + 8 * ((e >> 1) & 1)) * D + 8 * (e >> 2) + 2 * t);
    s[e] = x.x;
    s[e + 1] = x.y;
  }
  put_state(s, 0);

  // chunk c's Q and K (swizzled) and V's block (row-major) into stage st by
  // cp.async, rows past the chunk's n zero-filled
  auto issue = [&](int c, int st) {
    const int t0 = c * kChunk, n = min(kChunk, T - t0);
    const uint32_t base = sb + st * L::kStage;
#pragma unroll
    for (int m = 0; m < kChunk * D / 8 / kFThreads; ++m) {
      const int idx = tid + m * kFThreads, r = idx >> 4, c16 = idx & 15;
      const int ok = r < n ? 16 : 0, tr = r < n ? t0 + r : 0;
      const uint32_t off =
          (c16 >> 3) * (kChunk * 128) + swz(r * 128 + (c16 & 7) * 16);
      cp_async16(base + off, qb + tr * sq.t + c16 * 8, ok);
      cp_async16(base + L::kQ + off, kb + tr * sk.t + c16 * 8, ok);
    }
    const int r = tid >> 2, c4 = tid & 3;
    const int ok = r < n ? 16 : 0, tr = r < n ? t0 + r : 0;
    cp_async16(base + 2 * L::kQ + r * L::kLdV + c4 * 16,
               vb + tr * sv.t + c4 * 8, ok);
    cp_async_commit();
  };

  issue(0, 0);
  for (int c = 0; c < NC; ++c) {
    const int t0 = c * kChunk, n = min(kChunk, T - t0), st = c & 1;
    cp_async_wait_all();          // chunk c has landed, ...
    fence_proxy_async();          // ... is visible to wgmma, as are the
    __syncthreads();              // state's pieces; chunk c - 1 is done
    if (c + 1 < NC) issue(c + 1, st ^ 1);
    const uint32_t sQ = sb + st * L::kStage, sK = sQ + L::kQ;
    const uint32_t sSt = sb + L::oSt + st * L::kSt;
    const uint32_t sVt = sb + L::oVt, sVR = sb + L::oVR;

    // Q K^T (warpgroup 0) and Q S (warpgroup 1), issued now, waited for
    // after the V pass
    float acc[48];
#pragma unroll
    for (int e = 0; e < 48; ++e) acc[e] = 0.f;
    keep(acc);
    wgmma_fence();
    if (wg == 0) {
      float(&a64)[32] = reinterpret_cast<float(&)[32]>(acc);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks >> 2) * (kChunk * 128) + (ks & 3) * 32;
        wgmma_ss_k<64>(a64, gmma_desc(sQ + off, 16), gmma_desc(sK + off, 16));
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_k<96>(acc,
                       gmma_desc(sQ + (ks >> 2) * (kChunk * 128) +
                                     (ks & 3) * 32, 16),
                       gmma_desc(sSt + (ks >> 2) * L::kStBlk + (ks & 3) * 32,
                                 16));
    }
    wgmma_commit();

    // V^T and the three pieces of rev * V (rev_j = lambda^(n-1-j), 0 past
    // n): warp w reads rows j = 8 w .. + 7 of V transposed (ldmatrix .trans:
    // matrix i is columns 8 i .. + 7), scales and splits them, and stores
    // them as rows of V^T and of the pieces (stmatrix)
    {
      uint32_t f[4];
      ldsm_x4_t(sQ + 2 * L::kQ + (8 * warp + mr) * L::kLdV + mi * 16, f);
      const int row = (8 * mi + mr) * 128 + warp * 16;
      stsm_x4(sVt + swz(row), f);
      const int j = 8 * warp + 2 * t;
      const float rv0 = j < n ? pw[n - 1 - j] : 0.f;
      const float rv1 = j + 1 < n ? pw[n - 2 - j] : 0.f;
      uint32_t w[4][kPieces];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split3(__uint_as_float(f[i] << 16) * rv0,
               __uint_as_float(f[i] & 0xffff0000u) * rv1, w[i]);
#pragma unroll
      for (int p = 0; p < kPieces; ++p) {
        const uint32_t r[4] = {w[0][p], w[1][p], w[2][p], w[3][p]};
        stsm_x4(sVR + swz(p * kCols * 128 + row), r);
      }
    }
    fence_proxy_async();
    __syncthreads();              // V^T and rev * V are written

    // S <- lambda^n S + K^T (rev * V) for this warpgroup's 64 state rows:
    // A = K^T (the stage's K read transposed, block wg), B = rev * V's
    // three pieces stacked
    float inc[48];
#pragma unroll
    for (int e = 0; e < 48; ++e) inc[e] = 0.f;
    float oacc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) oacc[e] = 0.f;
    if (wg == 0) {
      wgmma_wait<0>();
      keep(acc);
      // P = (Q K^T) * M into three pieces as P V's A fragments: k16 step
      // ks takes the accumulator's n8 tiles 2 ks and 2 ks + 1
      unsigned pa[kPieces][4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = r0 + 8 * hf, j = 8 * nt + 2 * t;
          uint32_t w[kPieces];
          split3(j <= i ? pw[i - j] * acc[4 * nt + 2 * hf] : 0.f,
                 j + 1 <= i ? pw[i - j - 1] * acc[4 * nt + 2 * hf + 1] : 0.f,
                 w);
#pragma unroll
          for (int p = 0; p < kPieces; ++p)
            pa[p][nt >> 1][(nt & 1) * 2 + hf] = w[p];
        }
      keep(oacc);
      keep(inc);
#pragma unroll
      for (int p = 0; p < kPieces; ++p) keep(pa[p]);
      wgmma_fence();
#pragma unroll
      for (int p = kPieces - 1; p >= 0; --p)
#pragma unroll
        for (int ks = 0; ks < kChunk / 16; ++ks)
          wgmma_rs_k<32>(oacc, pa[p][ks], gmma_desc(sVt + ks * 32, 16));
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks)
        wgmma_n96_ta(inc, gmma_desc(sK + ks * 2048, kChunk * 128),
                     gmma_desc(sVR + ks * 32, 16));
      wgmma_commit();
      wgmma_wait<0>();
      keep(oacc);
      keep(inc);
#pragma unroll
      for (int p = 0; p < kPieces; ++p) keep(pa[p]);
    } else {
      keep(inc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kChunk / 16; ++ks)
        wgmma_n96_ta(inc,
                     gmma_desc(sK + kChunk * 128 + ks * 2048, kChunk * 128),
                     gmma_desc(sVR + ks * 32, 16));
      wgmma_commit();
      wgmma_wait<1>();            // Q S has finished
      keep(acc);
      // lambda^(i+1) Q S, its three column blocks summed, to warpgroup 0
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float x = (acc[32 + e] + acc[16 + e]) + acc[e];
        ox[e * 128 + wt] = x * pw[r0 + 8 * ((e >> 1) & 1) + 1];
      }
      asm volatile("bar.arrive 1, 256;\n" ::: "memory");
      wgmma_wait<0>();
      keep(inc);
    }
    const float blk = pw[n];
#pragma unroll
    for (int e = 0; e < 16; ++e)
      s[e] = fmaf(blk, s[e], (inc[32 + e] + inc[16 + e]) + inc[e]);
    if (c + 1 < NC) put_state(s, st ^ 1);
    if (wg == 0) {
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = r0 + 8 * hf;
        if (i < n) {
          float* orow = o + (bh * T + t0 + i) * D + c0 + 2 * t;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int e = 4 * nt + 2 * hf;
            *reinterpret_cast<float2*>(orow + 8 * nt) =
                make_float2(oacc[e] + ox[e * 128 + wt],
                            oacc[e + 1] + ox[(e + 1) * 128 + wt]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int e = 0; e < 16; e += 2)
    *reinterpret_cast<float2*>(
        Sg + (size_t)(r0 + 8 * ((e >> 1) & 1)) * D + 8 * (e >> 2) + 2 * t) =
        make_float2(s[e], s[e + 1]);
}

// the chunked form on `st`: the bf16 kernel for bf16 q, k, v, else the
// float32 one; D = 128
cudaError_t launch_chunked(bool bf16, const void* q, const void* k,
                           const void* v, const float* slopes, float* state,
                           float* o, int B, int H, int T, Strides sq,
                           Strides sk, Strides sv, cudaStream_t st) {
  static bool attrs = false;
  if (!attrs) {
    cudaError_t e = cudaFuncSetAttribute(
        lightning_chunk_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
        WgPlan::kBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(lightning_chunk_f32,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               ChunkPlan::kBytes);
    if (e != cudaSuccess) return e;
    attrs = true;
  }
  const dim3 grid(128 / kCols, H, B);
  if (bf16)
    lightning_chunk_bf16<<<grid, kFThreads, WgPlan::kBytes, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, slopes, state, o, H, T, sq, sk, sv);
  else
    lightning_chunk_f32<<<grid, kFThreads, ChunkPlan::kBytes, st>>>(
        (const float*)q, (const float*)k, (const float*)v, slopes, state, o,
        H, T, sq, sk, sv);
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

// The chunked form on `stream` (see above): D = 128 (k10_plan), one
// launch. Returns the first CUDA error.
int ominix_lightning_chunked(const void* q, const void* k, const void* v,
                             const void* slopes, void* state, void* o, int B,
                             int H, int T, int D, int bf16, long long qb,
                             long long qh, long long qt, long long kb,
                             long long kh, long long kt, long long vb,
                             long long vh, long long vt, void* stream) {
  if (bad_args(B, H, T) || D != 128) return (int)cudaErrorInvalidValue;
  const Strides sq{qb, qh, qt}, sk{kb, kh, kt}, sv{vb, vh, vt};
  return (int)launch_chunked(bf16 != 0, q, k, v, (const float*)slopes,
                             (float*)state, (float*)o, B, H, T, sq, sk, sv,
                             (cudaStream_t)stream);
}

// The decode mixer on `stream` (see above), one launch: q, k, v [B, H, 1,
// D] bf16 through their (row, head) element strides; z [B, H D] bf16 with
// row stride zb, or null (no gate); q_norm and k_norm [D] bf16 (both or
// neither), o_norm [H D] bf16 or null; rope != 0 rotates at the positions
// offsets[b] (int64) or pos0, with rope_c the float32 of ln(theta) / (D /
// 2); scale the float32 of D^-0.5; o_factor the float32 of 1 / (H D) as
// PyTorch's mean computes it, norm_bw the x-width of its reduction block
// (a power of two, 32..512); state [B, H, D, D] float32 in place; out [B,
// H D] bf16; qk_out [B, 2, H D] bf16 or null (q and k as the state step
// reads them); tickets [B] int32, zero (left zero), where o_norm is given,
// and gates [B, H D] bf16 (scratch: sigmoid(z)) where z is too.
// pdl != 0 launches behind the work before it by programmatic dependent
// launch: the state is then read before that work ends, so it must not
// write the state. D = 128, H D <= 4096. Returns the first CUDA error.
int ominix_lightning_decode(
    const void* q, const void* k, const void* v, long long qb, long long qh,
    long long kb, long long kh, long long vb, long long vh, const void* z,
    long long zb, const void* q_norm, const void* k_norm, const void* o_norm,
    float eps, int rope, float rope_c, float scale, float o_factor,
    long long pos0, const void* offsets, const void* slopes, void* state,
    void* out, void* qk_out, void* tickets, void* gates, int B, int H, int D,
    int norm_bw, int pdl, void* stream) {
  if (bad_args(B, H, 1) || D != kDecD || H * D > kDecMaxRow ||
      (q_norm == nullptr) != (k_norm == nullptr) ||
      (o_norm != nullptr && (tickets == nullptr || norm_bw < 32 ||
                             (z != nullptr && gates == nullptr) ||
                             norm_bw > kDecMaxBw ||
                             (norm_bw & (norm_bw - 1)) != 0)))
    return (int)cudaErrorInvalidValue;
  DecodeArgs a;
  a.q = (const __nv_bfloat16*)q;
  a.k = (const __nv_bfloat16*)k;
  a.v = (const __nv_bfloat16*)v;
  a.qb = qb;
  a.qh = qh;
  a.kb = kb;
  a.kh = kh;
  a.vb = vb;
  a.vh = vh;
  a.z = (const __nv_bfloat16*)z;
  a.zb = zb;
  a.q_norm = (const __nv_bfloat16*)q_norm;
  a.k_norm = (const __nv_bfloat16*)k_norm;
  a.o_norm = (const __nv_bfloat16*)o_norm;
  a.offsets = (const long long*)offsets;
  a.pos0 = pos0;
  a.slopes = (const float*)slopes;
  a.state = (float*)state;
  a.out = (__nv_bfloat16*)out;
  a.qk_out = (__nv_bfloat16*)qk_out;
  a.tickets = (int*)tickets;
  a.gates = (__nv_bfloat16*)gates;
  a.eps = eps;
  a.rope_c = rope_c;
  a.scale = scale;
  a.o_factor = o_factor;
  a.H = H;
  a.rope = rope;
  a.norm_bw = norm_bw;
  static bool carveout = false;     // shared memory for 8 CTAs an SM
  if (!carveout) {
    const cudaError_t e = cudaFuncSetAttribute(
        lightning_decode, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    carveout = true;
  }
  return (int)launch_kernel(lightning_decode, dim3(D / kCols, H, B),
                            dim3(kThreads), 0, pdl != 0,
                            (cudaStream_t)stream, a);
}

}  // extern "C"
