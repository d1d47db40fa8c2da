// k9_prep: K9's prologue, everything a Gated DeltaNet layer computes
// between its two input projections and the gated delta rule, in one
// launch (models/deltanet.py block; its plain version is
// ops/gated_delta.py deltanet_prep_reference):
//
//   mixed = [q | k | v] of qkvz (the per-key-head interleaved packing of
//           HF's fix_query_key_value_ordering, read in place)
//   y = silu(conv(window ++ mixed))   the depthwise causal conv over the
//           carried window of K - 1 = 3 inputs, each output a float32 sum
//           of its taps in tap order (products and sums rounded apart, no
//           fused multiply-add), rounded once to x's type; SiLU in float,
//           rounded to x's type
//   q^ = l2norm(y_q) * dk^-0.5, k^ = l2norm(y_k)   (float32, eps 1e-6)
//   v = y_v in float32 (exact: a value of x's type)
//   beta = sigmoid(b), g = -exp(A_log) * softplus(a + dt_bias)
//          (softplus as torch's: x past 20 is x)
//   window <- the last K - 1 rows of window ++ mixed, in place
//
// No TPU kernel computes this: the JAX package leaves it to XLA
// (ominix_mlx_tpu/models/deltanet.py:111-130). The plain version is some
// 36 small launches at a decode step (the cat, the conv's taps, the casts,
// the gates, the two l2norms), which is what this kernel is for: a decode
// step is host bound, and its device time is mostly launch gaps.
//
// What bounds it on an H100: bytes, qkvz and the window read once, the
// float32 q^, k^, v, g, beta written once: about 40 KB a row at decode
// (12 ns at 3.35 TB/s), so its floor is the launch itself.
//
// The design: a warp owns one head's worth of channels (a q, k or v head:
// 32 lanes x dk / 32 contiguous channels) for a tile of 16 tokens, so the
// l2norm's sum of squares is one warp butterfly; the last K - 1 inputs of
// each channel slide through registers from token to token. The window is
// read and written only by the CTAs of the first token tile, and each
// channel's reads and writes by one thread (the old window is read into
// registers first), so no CTA races another over it. The value heads'
// lane 0 computes that head's g and beta. Inputs bf16 or float32 (x's
// type, the window's and the taps'); A_log and dt_bias float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 4;        // the conv's K (Qwen3-Next's)
constexpr int kTile = 16;       // tokens a CTA
constexpr int kWarps = 4;       // heads a CTA
constexpr unsigned kFull = 0xffffffffu;

template <typename X>
struct Io;
template <>
struct Io<float> {
  static __device__ __forceinline__ float get(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void put(float* p, float x) { *p = x; }
};
template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float get(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

// C channels a lane: dk = dv = 32 C
template <typename X, int C>
__global__ void __launch_bounds__(32 * kWarps)
    k9_prep_kernel(const X* __restrict__ qkvz, const X* __restrict__ ba,
                   X* __restrict__ window, const X* __restrict__ conv_w,
                   const float* __restrict__ A_log,
                   const float* __restrict__ dt_bias, float* __restrict__ qo,
                   float* __restrict__ ko, float* __restrict__ vo,
                   float* __restrict__ go, float* __restrict__ betao, int T,
                   int Hk, int Hv, float q_scale) {
  using io = Io<X>;
  constexpr int D = 32 * C;
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int b = blockIdx.z;
  if (u >= 2 * Hk + Hv) return;
  const int r = Hv / Hk;
  const int row = (2 + 2 * r) * D;              // qkvz per key head
  const size_t xrow = (size_t)Hk * row;         // qkvz per token
  const int conv_dim = (2 * Hk + Hv) * D;
  const bool is_v = u >= 2 * Hk;
  const int hv = u - 2 * Hk;
  const int hk = is_v ? hv / r : u % Hk;
  // this lane's first channel: in qkvz's row, and in mixed / the window
  const int src = hk * row + lane * C +
                  (is_v ? 2 * D + (hv % r) * D : (u >= Hk ? D : 0));
  const int chan = u * D + lane * C;

  const X* xb = qkvz + (size_t)b * T * xrow;
  X* wb = window + (size_t)b * (kTaps - 1) * conv_dim;
  float w[kTaps][C];
#pragma unroll
  for (int e = 0; e < C; ++e)
#pragma unroll
    for (int j = 0; j < kTaps; ++j)
      w[j][e] = io::get(conv_w + (size_t)(chan + e) * kTaps + j);

  const int t0 = blockIdx.y * kTile, t1 = min(T, t0 + kTile);
  // the K - 1 inputs before t0, oldest first: x rows, or before the
  // sequence the window's rows (only the first tile's CTAs read it)
  float hist[kTaps - 1][C];
#pragma unroll
  for (int s = 0; s < kTaps - 1; ++s) {
    const int tt = t0 - (kTaps - 1) + s;
#pragma unroll
    for (int e = 0; e < C; ++e)
      hist[s][e] = tt >= 0
                       ? io::get(xb + (size_t)tt * xrow + src + e)
                       : io::get(wb + (size_t)(kTaps - 1 + tt) * conv_dim +
                                 chan + e);
  }
  float old[kTaps - 1][C];      // the old window (first tile)
#pragma unroll
  for (int s = 0; s < kTaps - 1; ++s)
#pragma unroll
    for (int e = 0; e < C; ++e) old[s][e] = hist[s][e];

  for (int t = t0; t < t1; ++t) {
    const size_t bt = (size_t)b * T + t;
    float y[C];
#pragma unroll
    for (int e = 0; e < C; ++e) {
      const float x = io::get(xb + (size_t)t * xrow + src + e);
      float acc = __fmul_rn(hist[0][e], w[0][e]);
#pragma unroll
      for (int j = 1; j < kTaps - 1; ++j)
        acc = __fadd_rn(acc, __fmul_rn(hist[j][e], w[j][e]));
      acc = __fadd_rn(acc, __fmul_rn(x, w[kTaps - 1][e]));
#pragma unroll
      for (int j = 0; j < kTaps - 2; ++j) hist[j][e] = hist[j + 1][e];
      hist[kTaps - 2][e] = x;
      const float cv = io::round(acc);
      y[e] = io::round(cv / (1.f + expf(-cv)));
    }
    if (!is_v) {
      float ss = 0.f;
#pragma unroll
      for (int e = 0; e < C; ++e) ss = __fadd_rn(ss, __fmul_rn(y[e], y[e]));
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) ss += __shfl_xor_sync(kFull, ss, m);
      const float inv = rsqrtf(ss + 1e-6f);
      const bool is_q = u < Hk;
      float* dst = (is_q ? qo : ko) + (bt * Hk + hk) * D + lane * C;
#pragma unroll
      for (int e = 0; e < C; ++e) {
        const float n = __fmul_rn(y[e], inv);
        dst[e] = is_q ? __fmul_rn(n, q_scale) : n;
      }
    } else {
      float* dst = vo + (bt * Hv + hv) * D + lane * C;
#pragma unroll
      for (int e = 0; e < C; ++e) dst[e] = y[e];
      if (lane == 0) {
        const X* bar = ba + bt * (2 * Hv) + hk * 2 * r;   // [b (r), a (r)]
        const float bv = io::get(bar + hv % r);
        const float av = io::get(bar + r + hv % r);
        betao[bt * Hv + hv] = 1.f / (1.f + expf(-bv));
        const float x = av + dt_bias[hv];
        const float sp = x > 20.f ? x : log1pf(expf(x));
        go[bt * Hv + hv] = -expf(A_log[hv]) * sp;
      }
    }
  }

  if (blockIdx.y == 0) {
    // the new window, row s = row T + s of window ++ mixed
#pragma unroll
    for (int s = 0; s < kTaps - 1; ++s) {
      const int f = T + s;
#pragma unroll
      for (int e = 0; e < C; ++e) {
        float val = 0.f;
        if (f >= kTaps - 1) {
          val = io::get(xb + (size_t)(f - (kTaps - 1)) * xrow + src + e);
        } else {
#pragma unroll
          for (int m = 0; m < kTaps - 1; ++m)
            if (m == f) val = old[m][e];
        }
        io::put(wb + (size_t)s * conv_dim + chan + e, val);
      }
    }
  }
}

template <typename X, int C>
cudaError_t launch(const void* qkvz, const void* ba, void* window,
                   const void* conv_w, const float* A_log,
                   const float* dt_bias, float* qo, float* ko, float* vo,
                   float* go, float* betao, int B, int T, int Hk, int Hv,
                   float q_scale, cudaStream_t st) {
  const int units = 2 * Hk + Hv;
  const dim3 grid((units + kWarps - 1) / kWarps, (T + kTile - 1) / kTile, B);
  k9_prep_kernel<X, C><<<grid, 32 * kWarps, 0, st>>>(
      (const X*)qkvz, (const X*)ba, (X*)window, (const X*)conv_w, A_log,
      dt_bias, qo, ko, vo, go, betao, T, Hk, Hv, q_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// k9_prep on `stream` (see above). bf16 (1) or float32 (0) x; dk = dv =
// 128; the conv's K = 4; Hv a multiple of Hk; B at most 65535 and
// ceil(T / 16) at most 65535. Outputs q, k [B, T, Hk, dk], v [B, T, Hv,
// dv], g, beta [B, T, Hv], float32; the window [B, 3, conv_dim] written in
// place. Returns the first CUDA error (cudaErrorInvalidValue, nothing
// launched, for what it does not take).
int ominix_k9_prep(const void* qkvz, const void* ba, void* window,
                   const void* conv_w, const void* A_log,
                   const void* dt_bias, void* q, void* k, void* v, void* g,
                   void* beta, int B, int T, int Hk, int Hv, int dk, int dv,
                   int conv_k, int bf16, float q_scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || T < 1 || Hk < 1 || Hv < 1 || Hv % Hk != 0 || dk != 128 ||
      dv != 128 || conv_k != kTaps || B > 65535 || (T + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  const float* al = (const float*)A_log;
  const float* db = (const float*)dt_bias;
  float *fq = (float*)q, *fk = (float*)k, *fv = (float*)v, *fg = (float*)g,
        *fb = (float*)beta;
  if (bf16)
    return (int)launch<__nv_bfloat16, 4>(qkvz, ba, window, conv_w, al, db, fq,
                                         fk, fv, fg, fb, B, T, Hk, Hv,
                                         q_scale, st);
  return (int)launch<float, 4>(qkvz, ba, window, conv_w, al, db, fq, fk, fv,
                               fg, fb, B, T, Hk, Hv, q_scale, st);
}

}  // extern "C"
