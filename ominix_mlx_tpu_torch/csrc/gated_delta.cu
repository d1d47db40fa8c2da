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
// What bounds it on an H100: at decode (T = 1) bytes, the state read and
// written once (2 MB a layer each way at Qwen3-Next's 32 x 128 x 128 per
// row); over a prompt, the 7 dk dv float32 operations of each token and
// value head, off the tensor cores. But the recurrence is serial in t, so
// a simple kernel is bound by each token's latency instead. The design:
//   * one CTA of 128 threads per (row, value head, 32 value columns): four
//     threads own one column of S, dk / 4 rows each (rows 4j + part, so
//     the four read four banks of the staged k and q), in registers for
//     the whole loop over T, which runs inside the kernel: one launch
//     serves decode and prefill, and S touches device memory twice;
//   * each token's q and k are staged once in shared memory (double
//     buffered: one barrier a token), and the next token's q, k, v, g and
//     beta are loaded into registers while this token computes;
//   * S^T k and S^T q are a thread's partial sums (four chains for
//     instruction-level parallelism) folded across the column's four lanes
//     by two shuffles, so all four hold the same sum and the same delta.
// The sums are float32 in another order than XLA's (and fused
// multiply-adds), so the kernel is held to its plain version with a
// relative bound, not bit for bit. Later work: the chunked (WY) form on
// the tensor cores for long prompts.

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // extern "C"
