// Device code shared by K1 and K6 (qmm.cu), K4 and K8 (gather_qmm.cu) and
// the dq kernel (qmm_tc.cu): warp and block reductions, the activation
// prologue of bf16 x (norm, group sums, a8 quantisation: qmm_prep_pdl,
// which K1, K6 and K4 launch ahead of their rows kernels, launched behind
// it by programmatic dependent launch), the 4-bit code dot, and the
// launch helpers of that pattern (launch_kernel, launch_prep_pdl).
//
// Everything here has internal linkage (an anonymous namespace), so each
// kernel source that includes it gets its own copy.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// Activation prologue of row m of x [M, K] (bf16; xat(k) reads x[m, k] as
// a float), run by one CTA of kPrepThreads, after an RMSNorm
// xn = bf16(bf16(x * inv) * w_norm) when norm_w is given. It writes
// whichever outputs it is given:
//   xn [M, K] bf16: the normed row;
//   xg [M, G] f32: the row's group sums, rounded to bf16;
//   xq [M, K] int8 and sx [M] f32: the a8 quantisation,
//       sx = max|xn| / 127 + 1e-12, xq = rint(xn / sx).
template <typename X>
__device__ __forceinline__ void prep_row(
    int m, X xat, const __nv_bfloat16* __restrict__ norm_w, float eps, int K,
    int gs, int8_t* __restrict__ xq, float* __restrict__ xg,
    float* __restrict__ sx, __nv_bfloat16* __restrict__ xn, float* red) {
  float inv = 1.f;
  if (norm_w != nullptr) {
    float ss = 0.f;
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      const float v = xat(k);
      ss = fmaf(v, v, ss);
    }
    ss = block_reduce<false>(ss, red);
    inv = 1.f / sqrtf(ss / (float)K + eps);
  }
  auto norm_at = [&](int k) {
    const float v = xat(k);
    if (norm_w == nullptr) return v;
    return bf16r(bf16r(v * inv) * __bfloat162float(norm_w[k]));
  };
  if (xn != nullptr)
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      xn[(size_t)m * K + k] = __float2bfloat16(norm_at(k));
  if (xq != nullptr) {
    float amax = 0.f;
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      amax = fmaxf(amax, fabsf(norm_at(k)));
    amax = block_reduce<true>(amax, red);
    const float s = amax / 127.f + 1e-12f;
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      xq[(size_t)m * K + k] = (int8_t)rintf(norm_at(k) / s);
    if (threadIdx.x == 0) sx[m] = s;
  }
  if (xg != nullptr) {
    const int G = K / gs, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int g = warp; g < G; g += blockDim.x >> 5) {
      float acc = 0.f;
      for (int t = lane; t < gs; t += 32) acc += norm_at(g * gs + t);
      acc = warp_sum(acc);
      if (lane == 0) xg[(size_t)m * G + g] = bf16r(acc);
    }
  }
}

// Waits until the grid this one depends on (programmatic dependent launch)
// has finished and its writes are visible; a no-op without one.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Lets the grids launched behind this one by programmatic dependent launch
// start now (each still waits in griddep_wait for this grid's writes).
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The prologue, one CTA per row, for a rows kernel launched behind it with
// programmatic dependent launch (K1 and K6 in qmm.cu, K4 in gather_qmm.cu;
// launch_prep_pdl): it lets that kernel start at once, so the kernel's
// weight loads are in flight while the prologue runs; the kernel reads the
// prologue's outputs after griddep_wait(). The row is staged in shared
// memory (K * 2 bytes, dynamic) with one round of 16-byte loads, so the
// passes over it wait on no global load.
__global__ void __launch_bounds__(kPrepThreads)
qmm_prep_pdl(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ norm_w, float eps, int K,
             int gs, int8_t* __restrict__ xq, float* __restrict__ xg,
             float* __restrict__ sx, __nv_bfloat16* __restrict__ xn) {
  __shared__ float red[32];
  extern __shared__ uint4 xs4[];           // the row, K / 8 pieces
  griddep_launch_dependents();
  const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)blockIdx.x * K);
  for (int i = threadIdx.x; i < K / 8; i += blockDim.x) xs4[i] = src[i];
  __syncthreads();
  const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(xs4);
  prep_row(blockIdx.x, [&](int k) { return __bfloat162float(xs[k]); },
           norm_w, eps, K, gs, xq, xg, sx, xn, red);
}

// Launches kernel on st with smem bytes of dynamic shared memory (first
// raising its limit where smem passes 48 KB). With pdl, behind the launch
// before it on st by programmatic dependent launch: it may start before
// that one ends, and waits for its writes in griddep_wait().
template <typename... Params, typename... Args>
cudaError_t launch_kernel(void (*kernel)(Params...), dim3 grid, dim3 block,
                          int smem, bool pdl, cudaStream_t st,
                          Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Launches qmm_prep_pdl over the M rows of bf16 x [M, K] on st, after the
// work before it (the rows kernel follows it with pdl).
inline cudaError_t launch_prep_pdl(const __nv_bfloat16* x,
                                   const __nv_bfloat16* norm_w, float eps,
                                   int M, int K, int gs, int8_t* xq,
                                   float* xg, float* sx, __nv_bfloat16* xn,
                                   cudaStream_t st) {
  return launch_kernel(qmm_prep_pdl, dim3(M), dim3(kPrepThreads), K * 2,
                       false, st, x, norm_w, eps, K, gs, xq, xg, sx, xn);
}

// 8 int4 codes (one 32-bit word, natural nibble order) . 8 int8 activations
// (X0 = x0..x3, X1 = x4..x7), accumulated into acc.
__device__ __forceinline__ int dot8(uint32_t w, int X0, int X1, int acc) {
  const int lo = (int)(w & 0x0F0F0F0Fu);          // u0, u2, u4, u6
  const int hi = (int)((w >> 4) & 0x0F0F0F0Fu);   // u1, u3, u5, u7
  acc = __dp4a(lo, (int)__byte_perm(X0, X1, 0x6420), acc);
  return __dp4a(hi, (int)__byte_perm(X0, X1, 0x7531), acc);
}

}  // namespace
