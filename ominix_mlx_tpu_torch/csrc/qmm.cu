// K1: quantized skinny matmul y[M, N] = x[M, K] @ W^T for M in [1, 16],
// W group-affine 4-bit (per-group bf16 scale and bias).
//
// Replaces two TPU kernels of ominix_mlx_tpu/ops/quant_matmul.py:
//   * _pt_kernel (M = 1 decode, w4a8 with RMSNorm fused into the prologue)
//   * _dq_kernel (2 <= M <= 16, exact bf16 activations)
//
// Weight layout (ops/quant_matmul.py prepare): data uint8 [N, K/2], byte j
// of a row = u[2j] | u[2j+1] << 4 with unsigned codes u = q + 8 in [0, 15];
// scales [N, G] bf16; biases [N, G] bf16 holding b - 8s, so that
// w = s * u + (b - 8s) (the zero-point fold the TPU kernel uses too).
//
// Modes (same formulas as quantized_matmul_reference):
//   a8  (M = 1): optional RMSNorm xn = bf16(bf16(x * inv) * w_norm);
//       sx = max|xn| / 127 + 1e-12; cx = rint(xn / sx) as int8;
//       y = sx * sum_g s_g * P_g + sum_g b'_g * bf16(xg_g), with
//       P_g = sum_{k in g} cx_k * u_k in int32 (__dp4a) and xg_g the group
//       sums of xn (quant_matmul.py:771-827, 914-927).
//   a16 (M <= 16): y = sum_k bf16(s * u_k + b') * x_k with f32 accumulation
//       (the rounding of the JAX package's exact dequant path, _dense_tn);
//       M = 1 keeps the fused norm, M > 1 takes an already-normed x.
//
// What bounds it on an H100: bytes. At M = 1 every weight byte is read
// once and used for two multiply-adds, far below the card's ~295 FLOP/byte
// ridge, so the kernel is a stream of N*K/2 code bytes plus N*G*4 bytes of
// scales and biases. The design streams each row once with 16-byte loads
// (one warp per output row, lanes on consecutive 16-byte chunks so a warp
// reads 512 contiguous bytes), dequantises in registers, and never writes
// an intermediate to device memory. The activation prologue (norm, int8
// quantisation, group sums) runs once per call in a small kernel, not once
// per output tile. Reductions are warp butterflies in a fixed order with no
// atomics, so greedy decode is deterministic run to run.
// Later work: split-K for the small-N projections, cp.async/TMA pipelining.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                 // output rows per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kPrepThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Block-wide sum (kMax = false) or max of non-negative values (kMax = true);
// every thread gets the result. Fixed reduction order.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
  r = kMax ? warp_max(r) : warp_sum(r);
  __syncthreads();
  return r;
}

// Activation prologue, one CTA per row m of x [M, K] (bf16).
//   a8:  writes xq [M, K] int8, xg [M, G] f32 (bf16-rounded), sx [M] f32.
//   a16: writes xn [M, K] bf16 (only launched when a norm is fused).
__global__ void __launch_bounds__(kPrepThreads)
qmm_prep(const __nv_bfloat16* __restrict__ x,
         const __nv_bfloat16* __restrict__ norm_w, float eps, int K, int gs,
         int a8, int8_t* __restrict__ xq, float* __restrict__ xg,
         float* __restrict__ sx, __nv_bfloat16* __restrict__ xn) {
  __shared__ float red[32];
  const int m = blockIdx.x;
  const __nv_bfloat16* xr = x + (size_t)m * K;
  float inv = 1.f;
  if (norm_w != nullptr) {
    float ss = 0.f;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const float v = __bfloat162float(xr[k]);
      ss = fmaf(v, v, ss);
    }
    ss = block_reduce<false>(ss, red);
    inv = 1.f / sqrtf(ss / (float)K + eps);
  }
  auto norm_at = [&](int k) {
    const float v = __bfloat162float(xr[k]);
    if (norm_w == nullptr) return v;
    return bf16r(bf16r(v * inv) * __bfloat162float(norm_w[k]));
  };
  if (!a8) {
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      xn[(size_t)m * K + k] = __float2bfloat16(norm_at(k));
    return;
  }
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    amax = fmaxf(amax, fabsf(norm_at(k)));
  amax = block_reduce<true>(amax, red);
  const float s = amax / 127.f + 1e-12f;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    xq[(size_t)m * K + k] = (int8_t)rintf(norm_at(k) / s);
  const int G = K / gs, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = warp; g < G; g += blockDim.x >> 5) {
    float acc = 0.f;
    for (int t = lane; t < gs; t += 32) acc += norm_at(g * gs + t);
    acc = warp_sum(acc);
    if (lane == 0) xg[(size_t)m * G + g] = bf16r(acc);
  }
  if (threadIdx.x == 0) sx[m] = s;
}

// 8 int4 codes (one 32-bit word, natural nibble order) . 8 int8 activations
// (X0 = x0..x3, X1 = x4..x7), accumulated into acc.
__device__ __forceinline__ int dot8(uint32_t w, int X0, int X1, int acc) {
  const int lo = (int)(w & 0x0F0F0F0Fu);          // u0, u2, u4, u6
  const int hi = (int)((w >> 4) & 0x0F0F0F0Fu);   // u1, u3, u5, u7
  acc = __dp4a(lo, (int)__byte_perm(X0, X1, 0x6420), acc);
  return __dp4a(hi, (int)__byte_perm(X0, X1, 0x7531), acc);
}

// M = 1, int8 activations. One warp per output row; lane c handles the
// 16-byte chunk c (32 codes) of the row, stepping by 32 chunks.
__global__ void __launch_bounds__(kThreads)
qmm_a8(const uint8_t* __restrict__ data, const __nv_bfloat16* __restrict__ sc,
       const __nv_bfloat16* __restrict__ bs, const int8_t* __restrict__ xq,
       const float* __restrict__ xg, const float* __restrict__ sx,
       __nv_bfloat16* __restrict__ y, int N, int K, int gs) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;
  const int G = K / gs, chunks = K / 32;
  const uint4* wrow = reinterpret_cast<const uint4*>(data + (size_t)n * (K / 2));
  const int4* xv = reinterpret_cast<const int4*>(xq);
  const __nv_bfloat16* srow = sc + (size_t)n * G;
  const __nv_bfloat16* brow = bs + (size_t)n * G;
  float acc_p = 0.f, acc_b = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const uint4 w = __ldg(wrow + c);
    const int4 xa = __ldg(xv + 2 * c), xb = __ldg(xv + 2 * c + 1);
    int p = dot8(w.x, xa.x, xa.y, 0);
    p = dot8(w.y, xa.z, xa.w, p);
    p = dot8(w.z, xb.x, xb.y, p);
    p = dot8(w.w, xb.z, xb.w, p);
    const int g = (c * 32) / gs;
    acc_p = fmaf(__bfloat162float(srow[g]), (float)p, acc_p);
    if ((c * 32) % gs == 0)
      acc_b = fmaf(__bfloat162float(brow[g]), xg[g], acc_b);
  }
  acc_p = warp_sum(acc_p);
  acc_b = warp_sum(acc_b);
  if (lane == 0) y[n] = __float2bfloat16(fmaf(sx[0], acc_p, acc_b));
}

// Exact bf16 activations, M <= MT rows of x. Same row/chunk mapping; each
// lane dequantises its 32 weights once and reuses them for every row of x.
template <int MT>
__global__ void __launch_bounds__(kThreads)
qmm_a16(const uint8_t* __restrict__ data, const __nv_bfloat16* __restrict__ sc,
        const __nv_bfloat16* __restrict__ bs,
        const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y,
        int M, int N, int K, int gs) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;
  const int G = K / gs, chunks = K / 32;
  const uint4* wrow = reinterpret_cast<const uint4*>(data + (size_t)n * (K / 2));
  const __nv_bfloat16* srow = sc + (size_t)n * G;
  const __nv_bfloat16* brow = bs + (size_t)n * G;
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    const uint4 w4 = __ldg(wrow + c);
    const int g = (c * 32) / gs;
    const float s = __bfloat162float(srow[g]), b = __bfloat162float(brow[g]);
    const uint32_t words[4] = {w4.x, w4.y, w4.z, w4.w};
    float wd[32];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t byte = (words[i] >> (8 * j)) & 0xFFu;
        wd[8 * i + 2 * j] = bf16r(fmaf(s, (float)(byte & 15u), b));
        wd[8 * i + 2 * j + 1] = bf16r(fmaf(s, (float)(byte >> 4), b));
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < M) {
        const uint4* xr =
            reinterpret_cast<const uint4*>(x + (size_t)m * K + (size_t)c * 32);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint4 xx = __ldg(xr + q);
          const uint32_t xw[4] = {xx.x, xx.y, xx.z, xx.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&xw[t]));
            acc[m] = fmaf(wd[8 * q + 2 * t], f.x, acc[m]);
            acc[m] = fmaf(wd[8 * q + 2 * t + 1], f.y, acc[m]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const float v = warp_sum(acc[m]);
    if (lane == 0 && m < M) y[(size_t)m * N + n] = __float2bfloat16(v);
  }
}

template <int MT>
void launch_a16(const uint8_t* data, const __nv_bfloat16* sc,
                const __nv_bfloat16* bs, const __nv_bfloat16* x,
                __nv_bfloat16* y, int M, int N, int K, int gs,
                cudaStream_t st) {
  qmm_a16<MT><<<(N + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      data, sc, bs, x, y, M, N, K, gs);
}

}  // namespace

extern "C" {

const char* ominix_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches K1 on `stream`. Scratch (xq, xg, sx for a8; xn for a16 with a
// fused norm) is allocated by the caller. Returns cudaGetLastError().
int ominix_qmm_w4(const void* x, const void* norm_w, float eps,
                  const void* data, const void* scales, const void* biases,
                  void* y, void* xq, void* xg, void* sx, void* xn, int M,
                  int N, int K, int gs, int a8, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* nw = (const __nv_bfloat16*)norm_w;
  const auto* d = (const uint8_t*)data;
  const auto* sc = (const __nv_bfloat16*)scales;
  const auto* bs = (const __nv_bfloat16*)biases;
  auto* yb = (__nv_bfloat16*)y;
  const int grid = (N + kWarps - 1) / kWarps;
  if (a8) {
    qmm_prep<<<M, kPrepThreads, 0, st>>>(xb, nw, eps, K, gs, 1,
                                         (int8_t*)xq, (float*)xg,
                                         (float*)sx, nullptr);
    qmm_a8<<<grid, kThreads, 0, st>>>(d, sc, bs, (const int8_t*)xq,
                                      (const float*)xg, (const float*)sx, yb,
                                      N, K, gs);
    return (int)cudaGetLastError();
  }
  if (nw != nullptr) {
    qmm_prep<<<M, kPrepThreads, 0, st>>>(xb, nw, eps, K, gs, 0, nullptr,
                                         nullptr, nullptr,
                                         (__nv_bfloat16*)xn);
    xb = (const __nv_bfloat16*)xn;
  }
  if (M == 1) launch_a16<1>(d, sc, bs, xb, yb, M, N, K, gs, st);
  else if (M <= 2) launch_a16<2>(d, sc, bs, xb, yb, M, N, K, gs, st);
  else if (M <= 4) launch_a16<4>(d, sc, bs, xb, yb, M, N, K, gs, st);
  else if (M <= 8) launch_a16<8>(d, sc, bs, xb, yb, M, N, K, gs, st);
  else launch_a16<16>(d, sc, bs, xb, yb, M, N, K, gs, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
