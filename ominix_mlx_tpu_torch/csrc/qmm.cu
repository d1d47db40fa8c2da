// K1 and K6: quantized skinny matmuls y[M, N] = x[M, K] @ W^T with the P
// formula, W group-affine 4- or 8-bit (per-group bf16 scale and bias).
//
// Replaces two TPU kernels of ominix_mlx_tpu/ops/quant_matmul.py:
//   * _pt_kernel (A1; M = 1 over transposed panels, w4/w8, a8/a16, RMSNorm
//     fused for 4-bit): K1 at M = 1;
//   * _pm_kernel (A4; row-major, M <= 16, w4a8 / w8a8 / w8a16): K6, the P
//     formula over M rows.
// K1 at 2 <= M <= 16 (A3, the dq formula) runs on the tensor cores in
// qmm_tc.cu. The port keeps one row-major layout for all of them;
// ops/quant_matmul.py route() picks the formula the JAX package would.
//
// Weight layout (ops/quant_matmul.py prepare): 4-bit data uint8 [N, K/2],
// byte j of a row = u[2j] | u[2j+1] << 4 with unsigned codes u = q + 8,
// biases b' = b - 8s; 8-bit data int8 [N, K] (centred codes q), biases b.
// Scales and biases bf16 [N, G]. Below, c is the stored code (u or q) and
// b* the stored bias.
//
// The P formula (qmm_p; the plain version is qmm_p_reference): per row m,
// a8: sx = max|x| / 127 + 1e-12, cx = rint(x / sx) as int8, P_g =
// sum_{k in g} c_k * cx_k in int32 (__dp4a, exact like the MXU's int32);
// a16: sx = 1, P_g = sum c_k * x_k in f32. Then
// y = sx * sum_g s_g * P_g + sum_g b*_g * xg_g, xg the bf16-rounded group
// sums of x (of the normed x when K1 fuses the norm).
//
// What bounds it on an H100: bytes. At M = 1 every weight byte is read once
// and used for one or two multiply-adds, far below the card's ~295
// FLOP/byte ridge, so the kernel is a stream of the code bytes plus 4 bytes
// of scale and bias per group. One warp per output row, lanes on
// consecutive 16-byte chunks (a warp reads 512 contiguous bytes), codes
// dequantised in registers, no intermediate in device memory. The
// activation prologue (norm, group sums, int8 quantisation) runs once per
// call in a small kernel, not once per output tile. Each lane reuses its
// chunk for every row of x, but x is read again for every output row (from
// L1/L2), which is what limits K6 at M = 16. Reductions are warp
// butterflies in a fixed order with no atomics, so greedy decode is
// deterministic.

#include "qmm_common.cuh"

namespace {

constexpr int kWarps = 8;                 // output rows per CTA
constexpr int kThreads = kWarps * 32;

// The chunk's codes as floats: 4-bit unsigned u in natural order, 8-bit q.
template <int BITS>
__device__ __forceinline__ void unpack_chunk(const uint4 w, float* c) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t byte = (words[i] >> (8 * j)) & 0xFFu;
      if constexpr (BITS == 4) {
        c[8 * i + 2 * j] = (float)(byte & 15u);
        c[8 * i + 2 * j + 1] = (float)(byte >> 4);
      } else {
        c[4 * i + j] = (float)(int8_t)byte;
      }
    }
  }
}

// sum_i c[i] * x[i] over the chunk's codes, x bf16 at xr (16-byte aligned),
// accumulated into acc in order.
template <int NC>
__device__ __forceinline__ float dot_bf16(const float* c,
                                          const __nv_bfloat16* xr,
                                          float acc) {
  const uint4* xv = reinterpret_cast<const uint4*>(xr);
#pragma unroll
  for (int q = 0; q < NC / 8; ++q) {
    const uint4 xx = __ldg(xv + q);
    const uint32_t xw[4] = {xx.x, xx.y, xx.z, xx.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xw[t]));
      acc = fmaf(c[8 * q + 2 * t], f.x, acc);
      acc = fmaf(c[8 * q + 2 * t + 1], f.y, acc);
    }
  }
  return acc;
}

// The P formula over M <= MT rows of x: xq int8 [M, K] (a8) or xa bf16
// [M, K] (a16), xg f32 [M, G], sx [M] (a8).
template <int BITS, bool A8, int MT>
__global__ void __launch_bounds__(kThreads)
qmm_p(const uint8_t* __restrict__ data, const __nv_bfloat16* __restrict__ sc,
      const __nv_bfloat16* __restrict__ bs, const int8_t* __restrict__ xq,
      const __nv_bfloat16* __restrict__ xa, const float* __restrict__ xg,
      const float* __restrict__ sx, __nv_bfloat16* __restrict__ y, int M,
      int N, int K, int gs) {
  constexpr int NC = BITS == 4 ? 32 : 16;   // codes a chunk
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;
  const int G = K / gs, chunks = K / NC;
  const uint4* wrow =
      reinterpret_cast<const uint4*>(data + (size_t)n * (K / 8 * BITS));
  const __nv_bfloat16* srow = sc + (size_t)n * G;
  const __nv_bfloat16* brow = bs + (size_t)n * G;
  float acc_p[MT], acc_b[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc_p[m] = acc_b[m] = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const uint4 w = __ldg(wrow + c);
    const int k0 = c * NC, g = k0 / gs;
    const float s = __bfloat162float(srow[g]);
    const bool first = k0 % gs == 0;       // the lane that adds the bias
    const float b = first ? __bfloat162float(brow[g]) : 0.f;
    float cw[NC];
    if constexpr (!A8) unpack_chunk<BITS>(w, cw);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        float p;
        if constexpr (A8) {
          const int4* xv =
              reinterpret_cast<const int4*>(xq + (size_t)m * K + k0);
          int ip;
          if constexpr (BITS == 4) {
            const int4 xa4 = __ldg(xv), xb4 = __ldg(xv + 1);
            ip = dot8(w.x, xa4.x, xa4.y, 0);
            ip = dot8(w.y, xa4.z, xa4.w, ip);
            ip = dot8(w.z, xb4.x, xb4.y, ip);
            ip = dot8(w.w, xb4.z, xb4.w, ip);
          } else {
            const int4 x4 = __ldg(xv);
            ip = __dp4a((int)w.x, x4.x, 0);
            ip = __dp4a((int)w.y, x4.y, ip);
            ip = __dp4a((int)w.z, x4.z, ip);
            ip = __dp4a((int)w.w, x4.w, ip);
          }
          p = (float)ip;
        } else {
          p = dot_bf16<NC>(cw, xa + (size_t)m * K + k0, 0.f);
        }
        acc_p[m] = fmaf(s, p, acc_p[m]);
        if (first) acc_b[m] = fmaf(b, xg[(size_t)m * G + g], acc_b[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float p = warp_sum(acc_p[m]), b = warp_sum(acc_b[m]);
    if (lane == 0 && m < M)
      y[(size_t)m * N + n] = __float2bfloat16(fmaf(A8 ? sx[m] : 1.f, p, b));
  }
}

template <int BITS, bool A8, int MT>
void launch_p(const uint8_t* d, const __nv_bfloat16* sc,
              const __nv_bfloat16* bs, const int8_t* xq,
              const __nv_bfloat16* xa, const float* xg, const float* sx,
              __nv_bfloat16* y, int M, int N, int K, int gs,
              cudaStream_t st) {
  qmm_p<BITS, A8, MT><<<(N + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      d, sc, bs, xq, xa, xg, sx, y, M, N, K, gs);
}

template <int BITS, bool A8>
void launch_p_rows(const uint8_t* d, const __nv_bfloat16* sc,
                   const __nv_bfloat16* bs, const int8_t* xq,
                   const __nv_bfloat16* xa, const float* xg, const float* sx,
                   __nv_bfloat16* y, int M, int N, int K, int gs,
                   cudaStream_t st) {
  if (M == 1) launch_p<BITS, A8, 1>(d, sc, bs, xq, xa, xg, sx, y, M, N, K, gs, st);
  else if (M <= 2) launch_p<BITS, A8, 2>(d, sc, bs, xq, xa, xg, sx, y, M, N, K, gs, st);
  else if (M <= 4) launch_p<BITS, A8, 4>(d, sc, bs, xq, xa, xg, sx, y, M, N, K, gs, st);
  else if (M <= 8) launch_p<BITS, A8, 8>(d, sc, bs, xq, xa, xg, sx, y, M, N, K, gs, st);
  else launch_p<BITS, A8, 16>(d, sc, bs, xq, xa, xg, sx, y, M, N, K, gs, st);
}

}  // namespace

extern "C" {

const char* ominix_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The P formula (K1 at M = 1, K6 at M <= 16) on `stream`: the prologue
// (norm when norm_w is given, group sums, a8 quantisation) then the rows.
// Scratch xg [M, G] f32 always, xq [M, K] int8 and sx [M] f32 for a8, xn
// [M, K] bf16 for a16 with a norm, all allocated by the caller. Returns
// cudaGetLastError().
int ominix_qmm_p(const void* x, const void* norm_w, float eps,
                 const void* data, const void* scales, const void* biases,
                 void* y, void* xq, void* xg, void* sx, void* xn, int M,
                 int N, int K, int gs, int bits, int a8, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* nw = (const __nv_bfloat16*)norm_w;
  const auto* d = (const uint8_t*)data;
  const auto* sc = (const __nv_bfloat16*)scales;
  const auto* bs = (const __nv_bfloat16*)biases;
  auto* yb = (__nv_bfloat16*)y;
  const bool norm_out = !a8 && nw != nullptr;
  qmm_prep<<<M, kPrepThreads, 0, st>>>(
      xb, nw, eps, K, gs, a8 ? (int8_t*)xq : nullptr, (float*)xg,
      a8 ? (float*)sx : nullptr, norm_out ? (__nv_bfloat16*)xn : nullptr);
  const auto* xa = norm_out ? (const __nv_bfloat16*)xn : xb;
  const auto* q8 = (const int8_t*)xq;
  const auto* g = (const float*)xg;
  const auto* s = (const float*)sx;
  if (bits == 4 && a8) launch_p_rows<4, true>(d, sc, bs, q8, xa, g, s, yb, M, N, K, gs, st);
  else if (bits == 4) launch_p_rows<4, false>(d, sc, bs, q8, xa, g, s, yb, M, N, K, gs, st);
  else if (a8) launch_p_rows<8, true>(d, sc, bs, q8, xa, g, s, yb, M, N, K, gs, st);
  else launch_p_rows<8, false>(d, sc, bs, q8, xa, g, s, yb, M, N, K, gs, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
