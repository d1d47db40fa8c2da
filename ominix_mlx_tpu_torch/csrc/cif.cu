// K12: CIF, Paraformer's continuous integrate-and-fire
// (models/paraformer.py cif; its plain version is ops/cif.py
// cif_reference). Per row b, a scalar `integrate` runs over the encoder
// frames t in float32:
//
//   completion = 1 - integrate;  integrate += a_t
//   fire = integrate >= threshold;  if fire: integrate -= 1
//   cur = fire ? completion : a_t;  rem = a_t - cur
//   frame = frame + cur * h_t
//   if fire: frames[idx] = frame; idx += 1; frame = rem * h_t
//
// and after the last frame, frames[idx] = frame (idx += 1) where
// integrate > tail_threshold. Writes land at min(idx, N - 1), as
// jax.lax.dynamic_update_slice clamps; rows from the count on are zero.
// Outputs: frames float32 [B, N, D], counts int32 [B].
//
// No TPU kernel computes this: the JAX package runs the loop as a
// jax.lax.scan (ominix_mlx_tpu/models/paraformer.py:110-155), which XLA
// compiles into one loop. In eager PyTorch the loop is about ten launches
// a frame (some 5000 for 30 s of audio, 501 frames after LFR), which is
// what this kernel is for.
//
// What bounds it on an H100: bytes, the hidden states read once and the
// frames written once, B*T*D*(2 + 4) bytes for bf16 hidden (about 0.46 us
// at T = 501, D = 512, at 3.35 TB/s). The scan over the alphas is a chain
// of T dependent float operations that no amount of bandwidth shortens.
//
// The design, simple first: the fire pattern depends on the alphas alone,
// so a CTA of 128 columns of one row (grid: columns x rows) stages the
// row's alphas in shared memory, its thread 0 runs the scalar scan and
// leaves each frame's weight (cur), its remainder (rem) and whether it
// fires in shared memory, and then every thread walks its own column
// through the frames in loop order, so each output is the loop's own
// sum: products and sums rounded apart (__fmul_rn, __fadd_rn: no fused
// multiply-add), the first frame from 0 + cur_0 h_0, each later one from
// the product rem * h itself. The frames are bit for bit the plain
// loop's, which PyTorch runs as separate multiply and add kernels. Both
// loops take the frames 32 at a time with their loads issued first (a
// frame at a time, each step waited on its own load: 129 us at T = 501,
// B = 1 on an H100 80GB HBM3 at 700 W). The CTAs of a row repeat its
// scan; hiding that chain behind the column walk is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;          // columns (threads) a CTA
constexpr int kBatch = 32;          // frames whose loads are issued together
constexpr int kMaxRows = 65535;     // grid.y

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename H, typename A>
__global__ void __launch_bounds__(kCols)
cif_kernel(const H* __restrict__ hidden, const A* __restrict__ alphas,
           float* __restrict__ frames, int* __restrict__ counts, int T,
           int D, int N, float threshold, float tail) {
  extern __shared__ float smem[];
  float* s_cur = smem;                 // the alphas, then each t's cur
  float* s_rem = smem + T;
  unsigned char* s_fire = reinterpret_cast<unsigned char*>(smem + 2 * T);
  __shared__ int s_tail;

  const int b = blockIdx.y;
  const A* a_row = alphas + (size_t)b * T;
  for (int t = threadIdx.x; t < T; t += kCols) s_cur[t] = widen(a_row[t]);
  __syncthreads();

  if (threadIdx.x == 0) {
    float integrate = 0.f;
    int fires = 0;
    for (int t0 = 0; t0 < T; t0 += kBatch) {
      const int n = min(kBatch, T - t0);
      float a[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) a[j] = j < n ? s_cur[t0 + j] : 0.f;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (j < n) {
          const float completion = __fsub_rn(1.0f, integrate);
          integrate = __fadd_rn(integrate, a[j]);
          const bool fire = integrate >= threshold;
          if (fire) integrate = __fsub_rn(integrate, 1.0f);
          const float cur = fire ? completion : a[j];
          s_cur[t0 + j] = cur;
          s_rem[t0 + j] = __fsub_rn(a[j], cur);
          s_fire[t0 + j] = fire;
          fires += fire;
        }
      }
    }
    const int tail_fire = integrate > tail;
    s_tail = tail_fire;
    if (blockIdx.x == 0) counts[b] = fires + tail_fire;
  }
  __syncthreads();

  const int d = blockIdx.x * kCols + threadIdx.x;
  if (d >= D) return;
  const H* h = hidden + (size_t)b * T * D + d;
  float* out = frames + (size_t)b * N * D + d;
  float frame = 0.f;
  int idx = 0;
  for (int t0 = 0; t0 < T; t0 += kBatch) {
    const int n = min(kBatch, T - t0);
    float hv[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      hv[j] = j < n ? widen(h[(size_t)(t0 + j) * D]) : 0.f;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (j < n) {
        const int t = t0 + j;
        frame = __fadd_rn(frame, __fmul_rn(s_cur[t], hv[j]));
        if (s_fire[t]) {
          out[(size_t)min(idx, N - 1) * D] = frame;
          ++idx;
          frame = __fmul_rn(s_rem[t], hv[j]);
        }
      }
    }
  }
  if (s_tail) {
    out[(size_t)min(idx, N - 1) * D] = frame;
    ++idx;
  }
  for (int n = idx; n < N; ++n) out[(size_t)n * D] = 0.f;
}

template <typename H, typename A>
int launch(const void* hidden, const void* alphas, void* frames,
           void* counts, int B, int T, int D, int N, float threshold,
           float tail, cudaStream_t stream) {
  const size_t smem = (size_t)T * (2 * sizeof(float) + 1);
  auto kernel = cif_kernel<H, A>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((D + kCols - 1) / kCols, B);
  kernel<<<grid, kCols, smem, stream>>>(
      static_cast<const H*>(hidden), static_cast<const A*>(alphas),
      static_cast<float*>(frames), static_cast<int*>(counts), T, D, N,
      threshold, tail);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K12 on `stream`: hidden [B, T, D] (bf16 when h_bf16, else float32) and
// alphas [B, T] (bf16 when a_bf16, else float32), both contiguous; frames
// float32 [B, N, D] and counts int32 [B] written (every frame row). The
// dynamic shared memory is T * 9 bytes: the wrapper keeps T within the
// card's 227 KB. Returns the first CUDA error (an argument the kernel does
// not take: cudaErrorInvalidValue, nothing launched).
int ominix_cif(const void* hidden, const void* alphas, void* frames,
               void* counts, int B, int T, int D, int N, int h_bf16,
               int a_bf16, float threshold, float tail, void* stream) {
  if (B < 1 || B > kMaxRows || T < 1 || D < 1 || N < 1 ||
      (size_t)T * (2 * sizeof(float) + 1) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (h_bf16 && a_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        hidden, alphas, frames, counts, B, T, D, N, threshold, tail, s);
  if (h_bf16)
    return launch<__nv_bfloat16, float>(hidden, alphas, frames, counts, B,
                                        T, D, N, threshold, tail, s);
  if (a_bf16)
    return launch<float, __nv_bfloat16>(hidden, alphas, frames, counts, B,
                                        T, D, N, threshold, tail, s);
  return launch<float, float>(hidden, alphas, frames, counts, B, T, D, N,
                              threshold, tail, s);
}

}  // extern "C"
