// MoE expert gathers at decode: y[t, j, :] = x[t] @ W[ids[t, j]]^T for every
// row t of x [T, K] and slot j of ids [T, k] (T * k <= 65535, the grid's y
// dimension), reading only the selected experts' rows of the stacked
// weights W [E, N, K].
//
// K4: group-affine 4- or 8-bit experts. Replaces the TPU decode kernel
// _gq_kernel (ominix_mlx_tpu/ops/quant_matmul.py:1606, bits 4 and 8; called
// by _gather_qmm_decode :1676 through gather_qmm :1721), and computes its
// a8 formula per row (K1's a8 mode): sx = max|x| / 127 + 1e-12,
// cx = rint(x / sx) as int8, xg = bf16 group sums of x, and
// y = sx * sum_g s_g * P_g + sum_g xg_g * b*_g with P_g the int32 dot of cx
// with the group's stored codes. Output bf16 [T, k, N].
// Layout (ops/quant_matmul.py PackedQuantizedExperts): 4-bit data uint8
// [E, N, K/2] in natural nibble order, b* = b - 8s; 8-bit data int8
// [E, N, K], the signed codes, b* = b; scales and biases [E, N, G] bf16.
//
// K8: channelwise w8a8 experts (ChannelQuantizedExperts: int8 data
// [E, N, K], f32 scale [E, N]). The port's own kernel: the JAX package
// computes this product as an XLA einsum (ops/quant_matmul.py:1523-1533,
// channel_gather_qmm), and PyTorch has no op for it. From float32 x:
// sx = max|x| / 127 + 1e-12 and cx = clip(rint(x / sx), -127, 127) with
// IEEE division (no reciprocal multiply: a one-ulp quotient moves a code),
// acc = the int32 dot of cx with the expert's row, then
// y = float(acc) * sx * scale[e, n] in float32 in that order, so the
// output equals the plain version's bit for bit. Output f32 [T, k, N].
//
// What bounds both on an H100: bytes. Only the selected experts' rows are
// read (k * N * (Kd + 4G) bytes per row of x for K4, k * N * (K + 4) for
// K8: 13.4 and 12.6 MB for the 8 experts of one Qwen3-30B-A3B gate at 8
// bits), each byte used for two multiply-adds, far below the ~295
// FLOP/byte ridge. The design keeps K1's shape: the activation prologue
// runs once per call (one CTA per row of x), then one warp per output row
// of one (row, slot) streams that expert's row with 16-byte loads and
// reduces with warp butterflies in a fixed order (no atomics: repeatable
// bits; K8's int32 sum is exact in any order). The TPU kernel's whole-slab
// DMA and block-diagonal activation matrix were Mosaic work-arounds and
// are not carried over. An expert id outside [0, E) writes NaN to its
// output row instead of reading out of bounds.
// Later work: rows of x that share an expert read its rows once.

#include "qmm_common.cuh"

namespace {

constexpr int kWarps = 8;                 // output rows per CTA
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// K4's rows. grid (ceil(N / kWarps), T * k): blockIdx.y is the (row t,
// slot j) pair.
template <int BITS>
__global__ void __launch_bounds__(kThreads)
gather_qmm_a8(const int* __restrict__ ids, const uint8_t* __restrict__ data,
              const __nv_bfloat16* __restrict__ sc,
              const __nv_bfloat16* __restrict__ bs,
              const int8_t* __restrict__ xq, const float* __restrict__ xg,
              const float* __restrict__ sx, __nv_bfloat16* __restrict__ y,
              int k, int E, int N, int K, int gs) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;
  const int pair = blockIdx.y, t = pair / k;
  const int e = __ldg(ids + pair);
  __nv_bfloat16* out = y + (size_t)pair * N + n;
  if (e < 0 || e >= E) {
    if (lane == 0) *out = __float2bfloat16(__int_as_float(0x7fc00000));
    return;
  }
  const int G = K / gs;
  const size_t r = (size_t)e * N + n;     // the expert's weight row
  const float v = a8_row_dot<BITS>(
      data + r * (K / 8 * BITS), sc + r * G, bs + r * G, xq + (size_t)t * K,
      xg + (size_t)t * G, sx[t], K, gs, lane);
  if (lane == 0) *out = __float2bfloat16(v);
}

// K8's prologue, one CTA per row t of float32 x [T, K]: sx[t] and the
// clipped int8 codes xq[t].
__global__ void __launch_bounds__(kPrepThreads)
chan_prep(const float* __restrict__ x, int K, int8_t* __restrict__ xq,
          float* __restrict__ sx) {
  __shared__ float red[32];
  const float* xr = x + (size_t)blockIdx.x * K;
  float amax = 0.f;
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    amax = fmaxf(amax, fabsf(xr[i]));
  amax = block_reduce<true>(amax, red);
  const float s = __fadd_rn(__fdiv_rn(amax, 127.f), 1e-12f);
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    xq[(size_t)blockIdx.x * K + i] =
        (int8_t)fminf(fmaxf(rintf(__fdiv_rn(xr[i], s)), -127.f), 127.f);
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
}

// K8's rows, grid (ceil(N / kWarps), T * k) as K4's. Lane c takes the
// 16-byte chunk c of the expert's row (16 codes), stepping by 32 chunks.
__global__ void __launch_bounds__(kThreads)
chan_gather_qmm(const int* __restrict__ ids, const int8_t* __restrict__ data,
                const float* __restrict__ scale,
                const int8_t* __restrict__ xq, const float* __restrict__ sx,
                float* __restrict__ y, int k, int E, int N, int K) {
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (n >= N) return;
  const int pair = blockIdx.y, t = pair / k;
  const int e = __ldg(ids + pair);
  float* out = y + (size_t)pair * N + n;
  if (e < 0 || e >= E) {
    if (lane == 0) *out = __int_as_float(0x7fc00000);
    return;
  }
  const size_t r = (size_t)e * N + n;
  const int4* wrow = reinterpret_cast<const int4*>(data + r * K);
  const int4* xv = reinterpret_cast<const int4*>(xq + (size_t)t * K);
  int acc = 0;
  for (int c = lane; c < K / 16; c += 32) {
    const int4 w = __ldg(wrow + c), xx = __ldg(xv + c);
    acc = __dp4a(w.x, xx.x, acc);
    acc = __dp4a(w.y, xx.y, acc);
    acc = __dp4a(w.z, xx.z, acc);
    acc = __dp4a(w.w, xx.w, acc);
  }
  acc = warp_sum_int(acc);
  if (lane == 0)
    *out = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx[t]), __ldg(scale + r));
}

template <int BITS>
int launch_gather(const void* x, const void* ids, const void* data,
                  const void* scales, const void* biases, void* y, void* xq,
                  void* xg, void* sx, int T, int k, int E, int N, int K,
                  int gs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  qmm_prep<<<T, kPrepThreads, 0, st>>>((const __nv_bfloat16*)x, nullptr, 0.f,
                                       K, gs, (int8_t*)xq, (float*)xg,
                                       (float*)sx, nullptr);
  const dim3 grid((N + kWarps - 1) / kWarps, T * k);
  gather_qmm_a8<BITS><<<grid, kThreads, 0, st>>>(
      (const int*)ids, (const uint8_t*)data, (const __nv_bfloat16*)scales,
      (const __nv_bfloat16*)biases, (const int8_t*)xq, (const float*)xg,
      (const float*)sx, (__nv_bfloat16*)y, k, E, N, K, gs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch K4 on `stream`: the prologue over the T rows of x, then the
// gathered products, on 4-bit (w4a8) or 8-bit (w8a8) experts. Scratch xq
// [T, K] int8, xg [T, G] f32 and sx [T] f32 is allocated by the caller.
// Each returns cudaGetLastError().
int ominix_gather_qmm_w4a8(const void* x, const void* ids, const void* data,
                           const void* scales, const void* biases, void* y,
                           void* xq, void* xg, void* sx, int T, int k, int E,
                           int N, int K, int gs, void* stream) {
  return launch_gather<4>(x, ids, data, scales, biases, y, xq, xg, sx, T, k,
                          E, N, K, gs, stream);
}

int ominix_gather_qmm_w8a8(const void* x, const void* ids, const void* data,
                           const void* scales, const void* biases, void* y,
                           void* xq, void* xg, void* sx, int T, int k, int E,
                           int N, int K, int gs, void* stream) {
  return launch_gather<8>(x, ids, data, scales, biases, y, xq, xg, sx, T, k,
                          E, N, K, gs, stream);
}

// Launch K8 on `stream`: the prologue over the T rows of float32 x, then the
// gathered products. Scratch xq [T, K] int8 and sx [T] f32 is allocated by
// the caller. Returns cudaGetLastError().
int ominix_channel_gather_qmm(const void* x, const void* ids,
                              const void* data, const void* scale, void* y,
                              void* xq, void* sx, int T, int k, int E, int N,
                              int K, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  chan_prep<<<T, kPrepThreads, 0, st>>>((const float*)x, K, (int8_t*)xq,
                                        (float*)sx);
  const dim3 grid((N + kWarps - 1) / kWarps, T * k);
  chan_gather_qmm<<<grid, kThreads, 0, st>>>(
      (const int*)ids, (const int8_t*)data, (const float*)scale,
      (const int8_t*)xq, (const float*)sx, (float*)y, k, E, N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
