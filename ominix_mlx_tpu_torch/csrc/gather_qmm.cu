// K4: MoE expert gather-qmm, y[t, j, :] = x[t] @ W[ids[t, j]]^T for every
// row t of x [T, K] (T <= 64) and slot j of ids [T, k], with stacked
// group-affine 4-bit experts W [E, N, K].
//
// Replaces the TPU decode kernel _gq_kernel (ominix_mlx_tpu/ops/
// quant_matmul.py:1606, called by _gather_qmm_decode :1676 through
// gather_qmm :1721), and computes its w4a8 formula per row (the same as
// K1's a8 mode): sx = max|x| / 127 + 1e-12, cx = rint(x / sx) as int8,
// xg = bf16 group sums of x, and
// y = sx * sum_g s_g * P_g + sum_g xg_g * (b - 8s)_g with P_g the int32
// dot of cx with the group's unsigned codes. Output bf16 [T, k, N].
//
// Layout (ops/quant_matmul.py PackedQuantizedExperts): data uint8
// [E, N, K/2] in natural nibble order, scales [E, N, G] bf16, biases
// [E, N, G] bf16 holding b - 8s.
//
// What bounds it on an H100: bytes. Only the selected experts' rows are
// read (k * N * (K/2 + 4G) bytes per row of x, 7.08 MB for the 8 experts
// of one Qwen3-30B-A3B gate, up or down projection), each byte used for
// two multiply-adds, far below the ~295 FLOP/byte ridge. The design keeps
// K1's shape: the activation prologue runs once per call (qmm_prep, one
// CTA per row of x), then one warp per output row of one (row, slot)
// streams that expert's packed row with 16-byte loads and reduces with
// warp butterflies in a fixed order (no atomics: repeatable bits). The
// TPU kernel's whole-slab DMA and block-diagonal activation matrix were
// Mosaic work-arounds and are not carried over. An expert id outside
// [0, E) writes NaN to its output row instead of reading out of bounds.
// Later work: rows of x that share an expert read its rows once.

#include "qmm_common.cuh"

namespace {

constexpr int kWarps = 8;                 // output rows per CTA
constexpr int kThreads = kWarps * 32;

// grid (ceil(N / kWarps), T * k): blockIdx.y is the (row t, slot j) pair.
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
  const float v = a8_row_dot(data + r * (K / 2), sc + r * G, bs + r * G,
                             xq + (size_t)t * K, xg + (size_t)t * G, sx[t],
                             K, gs, lane);
  if (lane == 0) *out = __float2bfloat16(v);
}

}  // namespace

extern "C" {

// Launches K4 on `stream`: the prologue over the T rows of x, then the
// gathered products. Scratch xq [T, K] int8, xg [T, G] f32 and sx [T] f32
// is allocated by the caller. Returns cudaGetLastError().
int ominix_gather_qmm_w4a8(const void* x, const void* ids, const void* data,
                           const void* scales, const void* biases, void* y,
                           void* xq, void* xg, void* sx, int T, int k, int E,
                           int N, int K, int gs, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  qmm_prep<<<T, kPrepThreads, 0, st>>>((const __nv_bfloat16*)x, nullptr, 0.f,
                                       K, gs, (int8_t*)xq, (float*)xg,
                                       (float*)sx, nullptr);
  const dim3 grid((N + kWarps - 1) / kWarps, T * k);
  gather_qmm_a8<<<grid, kThreads, 0, st>>>(
      (const int*)ids, (const uint8_t*)data, (const __nv_bfloat16*)scales,
      (const __nv_bfloat16*)biases, (const int8_t*)xq, (const float*)xg,
      (const float*)sx, (__nv_bfloat16*)y, k, E, N, K, gs);
  return (int)cudaGetLastError();
}

}  // extern "C"
