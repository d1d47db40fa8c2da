// MoE expert gathers at decode: y[t, j, :] = x[t] @ W[ids[t, j]]^T for every
// row t of x [T, K] and slot j of ids [T, k] (T * k <= 65535, the grid's y
// dimension), reading only the selected experts' rows of the stacked
// weights W [E, N, K]. One launch takes one stack of experts, or two of
// the same shape against the same x and ids (a MoE layer's gate and up
// projections: one prologue, one rows launch, two outputs).
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
// channel_gather_qmm), and PyTorch has no op for it. From x in float32 or
// bf16 (widened exactly): sx = max|x| / 127 + 1e-12 and
// cx = clip(rint(x / sx), -127, 127) with IEEE division (no reciprocal
// multiply: a one-ulp quotient moves a code), acc = the int32 dot of cx
// with the expert's row, then y = float(acc) * sx * scale[e, n] in float32
// in that order, so the output equals the plain version's bit for bit.
// Output f32 [T, k, N].
//
// What bounds both on an H100: bytes. Only the selected experts' rows are
// read (k * N * (Kd + 4G) bytes per row of x for K4, k * N * (K + 4) for
// K8: 13.4 and 12.6 MB for the 8 experts of one Qwen3-30B-A3B gate at 8
// bits), each byte used for two multiply-adds, far below the ~295
// FLOP/byte ridge. The design (qmm_p's in qmm.cu, with an expert gather):
//   * the activation prologue (qmm_prep_pdl for K4, chan_prep for K8, one
//     CTA per row of x) lets its dependents start at once, and the rows
//     kernel follows it by programmatic dependent launch: it reads its
//     expert id, issues its first batch of weight (and scale and bias)
//     loads, and only then waits for the prologue (griddep_wait) before it
//     reads x's codes, group sums and sx;
//   * a warp's lanes form groups of L (16, or 8 where 16 does not divide
//     a row's chunks) that each own R = L / 4 consecutive output rows of
//     one (row, slot) pair and stack, 8 rows a warp (gather_plan in
//     ops/quant_matmul.py, from shapes alone): at the down projection's
//     24-chunk 4-bit rows 8 lanes take a row and no lane of the warp is
//     idle. A lane issues the loads of a batch of
//     chunk positions of all its R rows (8 chunks of 16 bytes in flight)
//     before it uses any, and reads x's codes for a chunk once for all R;
//   * K4 sums each output row in one order, a warp a row's: a group of L
//     lanes stands for the 32 lanes of a warp (its lane l for lanes l, l + L,
//     ..), each summing its chunks c, c + 32, .. in order with fmaf, folds
//     those partial sums in the order of the warp butterfly's first levels
//     (offsets 16, .., L) and finishes the butterfly over its own lanes, so
//     every plan gives the bits of a warp a row (no atomics: repeatable).
//     K8's int32 sums are exact in any order.
// The TPU kernel's whole-slab DMA and block-diagonal activation matrix
// were Mosaic work-arounds and are not carried over. An expert id outside
// [0, E) writes NaN to its output rows instead of reading out of bounds.
// Later work: rows of x that share an expert read its rows once.

#include <type_traits>

#include "qmm_common.cuh"

namespace {

constexpr int kWarps = 4;                 // warps a CTA
constexpr int kThreads = kWarps * 32;

// One launch's operands: stack s (0, or 1 for the second of a pair) reads
// data[s], scales and biases (K4) or scale (K8) and writes y[s].
struct GatherArgs {
  const int* ids;
  const uint8_t* data[2];
  const __nv_bfloat16* sc[2];
  const __nv_bfloat16* bs[2];
  __nv_bfloat16* y[2];
  const int8_t* xq;
  const float* xg;
  const float* sx;
  int k, E, N, K, gs;
};

struct ChanArgs {
  const int* ids;
  const int8_t* data[2];
  const float* scale[2];
  float* y[2];
  const int8_t* xq;
  const float* sx;
  int k, E, N, K;
};

// p0 or p1 for stack s (0 or 1): a pair of kernel parameters selected
// without indexing them (a runtime index copies the parameters to local
// memory).
template <typename P>
__device__ __forceinline__ P pick(P p0, P p1, int s) {
  return s == 0 ? p0 : p1;
}

// A lane's J partial sums, part j standing for warp lane l + L * j, folded
// in the order of the warp butterfly's levels at offsets 16, 8, .., L.
template <int J>
__device__ __forceinline__ float fold(float (&v)[J]) {
#pragma unroll
  for (int h = J / 2; h >= 1; h /= 2)
#pragma unroll
    for (int j = 0; j < h; ++j) v[j] += v[j + h];
  return v[0];
}

// The butterfly over a group of L lanes (offsets L/2, .., 1), mask the
// group's lanes.
template <int L, typename T>
__device__ __forceinline__ T group_sum(T v, unsigned mask) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// Where a lane group's rows lie. grid (warps / kWarps, pairs, stacks):
// blockIdx.y is the (row t, slot j) pair, blockIdx.z the stack.
template <int L, int R>
struct Rows {
  int l, n0;
  unsigned mask;
  __device__ __forceinline__ Rows() {
    const int lane = threadIdx.x & 31, grp = lane / L;
    l = lane % L;
    mask = L == 32 ? kFull : ((1u << L) - 1u) << (grp * L);
    n0 = ((blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / L) + grp) * R;
  }
};

// K4's rows, behind qmm_prep_pdl (xq, xg, sx read after griddep_wait).
template <int BITS, int L, int R>
__global__ void __launch_bounds__(kThreads)
gather_qmm_a8(const GatherArgs a) {
  constexpr int NC = BITS == 4 ? 32 : 16;   // codes a chunk
  constexpr int J = 32 / L;                 // warp lanes a lane stands for
  constexpr int U = 8 / R;                  // chunk positions a batch
  // a batch spans whole multiples of 32 chunks, so the warp lane that
  // chunk position u stands for is l + L * (u % J)
  static_assert(U % J == 0, "no template for these lanes and rows");
  const Rows<L, R> w;
  const int N = a.N;
  if (w.n0 >= N) return;
  const int pair = blockIdx.y, s = blockIdx.z;
  const int e = __ldg(a.ids + pair);
  __nv_bfloat16* out = pick(a.y[0], a.y[1], s) + (size_t)pair * N;
  if (e < 0 || e >= a.E) {
    if (w.l == 0)
      for (int r = 0; r < R && w.n0 + r < N; ++r)
        out[w.n0 + r] = __float2bfloat16(__int_as_float(0x7fc00000));
    return;
  }
  const int K = a.K, gs = a.gs, G = K / gs, chunks = K / NC, t = pair / a.k;
  const uint8_t* data = pick(a.data[0], a.data[1], s);
  const __nv_bfloat16* sc = pick(a.sc[0], a.sc[1], s);
  const __nv_bfloat16* bs = pick(a.bs[0], a.bs[1], s);
  const uint4* wrow[R];
  const __nv_bfloat16 *srow[R], *brow[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {             // rows past N repeat row N - 1
    const size_t row = (size_t)e * N + min(w.n0 + r, N - 1);
    wrow[r] = reinterpret_cast<const uint4*>(data + row * (K / 8 * BITS));
    srow[r] = sc + row * G;
    brow[r] = bs + row * G;
  }
  float acc_p[R][J], acc_b[R][J];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < J; ++j) acc_p[r][j] = acc_b[r][j] = 0.f;
  for (int base = 0; base < chunks; base += L * U) {
    uint4 wv[U][R];
    float sv[U][R], bv[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = base + w.l + L * u;
      if (c < chunks) {
        const int k0 = c * NC, g = k0 / gs;
        const bool first = k0 % gs == 0;     // the lane that adds the bias
#pragma unroll
        for (int r = 0; r < R; ++r) {
          wv[u][r] = __ldg(wrow[r] + c);
          sv[u][r] = __bfloat162float(srow[r][g]);
          bv[u][r] = first ? __bfloat162float(brow[r][g]) : 0.f;
        }
      }
    }
    if (base == 0) griddep_wait();          // x's codes and sums are ready
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = base + w.l + L * u;
      if (c >= chunks) continue;
      const int k0 = c * NC, g = k0 / gs, j = u % J;
      const bool first = k0 % gs == 0;
      const float xgv = first ? a.xg[(size_t)t * G + g] : 0.f;
      const int4* xv = reinterpret_cast<const int4*>(a.xq + (size_t)t * K + k0);
      const int4 xa4 = xv[0];
      const int4 xb4 = BITS == 4 ? xv[1] : xa4;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        int ip;
        if constexpr (BITS == 4) {
          ip = dot8(wv[u][r].x, xa4.x, xa4.y, 0);
          ip = dot8(wv[u][r].y, xa4.z, xa4.w, ip);
          ip = dot8(wv[u][r].z, xb4.x, xb4.y, ip);
          ip = dot8(wv[u][r].w, xb4.z, xb4.w, ip);
        } else {
          ip = __dp4a((int)wv[u][r].x, xa4.x, 0);
          ip = __dp4a((int)wv[u][r].y, xa4.y, ip);
          ip = __dp4a((int)wv[u][r].z, xa4.z, ip);
          ip = __dp4a((int)wv[u][r].w, xa4.w, ip);
        }
        acc_p[r][j] = fmaf(sv[u][r], (float)ip, acc_p[r][j]);
        if (first) acc_b[r][j] = fmaf(bv[u][r], xgv, acc_b[r][j]);
      }
    }
  }
  const float sx = a.sx[t];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float p = group_sum<L>(fold<J>(acc_p[r]), w.mask);
    const float b = group_sum<L>(fold<J>(acc_b[r]), w.mask);
    if (w.l == 0 && w.n0 + r < N)
      out[w.n0 + r] = __float2bfloat16(fmaf(sx, p, b));
  }
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// K8's prologue, one CTA per row t of x [T, K] (float32 or bf16), for the
// rows kernel launched behind it: sx[t] and the clipped int8 codes xq[t].
// The row is staged in shared memory (K * sizeof(X) bytes, dynamic).
template <typename X>
__global__ void __launch_bounds__(kPrepThreads)
chan_prep(const X* __restrict__ x, int K, int8_t* __restrict__ xq,
          float* __restrict__ sx) {
  __shared__ float red[32];
  extern __shared__ uint4 row4[];
  griddep_launch_dependents();
  const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)blockIdx.x * K);
  for (int i = threadIdx.x; i < K * (int)sizeof(X) / 16; i += blockDim.x)
    row4[i] = src[i];
  __syncthreads();
  const X* xr = reinterpret_cast<const X*>(row4);
  float amax = 0.f;
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    amax = fmaxf(amax, fabsf(widen(xr[i])));
  amax = block_reduce<true>(amax, red);
  const float s = __fadd_rn(__fdiv_rn(amax, 127.f), 1e-12f);
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    xq[(size_t)blockIdx.x * K + i] = (int8_t)fminf(
        fmaxf(rintf(__fdiv_rn(widen(xr[i]), s)), -127.f), 127.f);
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
}

// K8's rows, behind chan_prep (xq, sx read after griddep_wait). A chunk is
// 16 codes (16 bytes).
template <int L, int R>
__global__ void __launch_bounds__(kThreads)
chan_gather_qmm(const ChanArgs a) {
  constexpr int U = 8 / R;                  // chunk positions a batch
  const Rows<L, R> w;
  const int N = a.N;
  if (w.n0 >= N) return;
  const int pair = blockIdx.y, s = blockIdx.z;
  const int e = __ldg(a.ids + pair);
  float* out = pick(a.y[0], a.y[1], s) + (size_t)pair * N;
  if (e < 0 || e >= a.E) {
    if (w.l == 0)
      for (int r = 0; r < R && w.n0 + r < N; ++r)
        out[w.n0 + r] = __int_as_float(0x7fc00000);
    return;
  }
  const int K = a.K, chunks = K / 16, t = pair / a.k;
  const int8_t* data = pick(a.data[0], a.data[1], s);
  const float* scl = pick(a.scale[0], a.scale[1], s);
  const int4* wrow[R];
  float scale[R];
  int acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t row = (size_t)e * N + min(w.n0 + r, N - 1);
    wrow[r] = reinterpret_cast<const int4*>(data + row * K);
    scale[r] = __ldg(scl + row);
    acc[r] = 0;
  }
  const int4* xv = reinterpret_cast<const int4*>(a.xq + (size_t)t * K);
  for (int base = 0; base < chunks; base += L * U) {
    int4 wv[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = base + w.l + L * u;
      if (c < chunks)
#pragma unroll
        for (int r = 0; r < R; ++r) wv[u][r] = __ldg(wrow[r] + c);
    }
    if (base == 0) griddep_wait();          // x's codes are ready
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = base + w.l + L * u;
      if (c >= chunks) continue;
      const int4 xx = xv[c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc[r] = __dp4a(wv[u][r].x, xx.x, acc[r]);
        acc[r] = __dp4a(wv[u][r].y, xx.y, acc[r]);
        acc[r] = __dp4a(wv[u][r].z, xx.z, acc[r]);
        acc[r] = __dp4a(wv[u][r].w, xx.w, acc[r]);
      }
    }
  }
  const float sx = a.sx[t];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int v = group_sum<L>(acc[r], w.mask);
    if (w.l == 0 && w.n0 + r < N)
      out[w.n0 + r] =
          __fmul_rn(__fmul_rn(__int2float_rn(v), sx), scale[r]);
  }
}

// Calls f(lanes, rows) as integral constants for the plans with a
// template (gather_plan returns no other): 16 lanes a row with 4 rows, or
// 8 lanes with 2 (8 rows a warp).
template <typename F>
int by_plan(int lanes, int rows, F&& f) {
  using std::integral_constant;
  if (lanes == 16 && rows == 4)
    return f(integral_constant<int, 16>{}, integral_constant<int, 4>{});
  if (lanes == 8 && rows == 2)
    return f(integral_constant<int, 8>{}, integral_constant<int, 2>{});
  return (int)cudaErrorInvalidValue;
}

// by_plan(lanes, rows, KnownPlan{}) is 0 where the plan has a template.
struct KnownPlan {
  template <typename A, typename B>
  int operator()(A, B) const { return 0; }
};

// The rows launch's grid: lane groups of `lanes` own `rows` rows each.
dim3 rows_grid(int N, int lanes, int rows, int pairs, int stacks) {
  const int per_warp = 32 / lanes * rows;
  const int warps = (N + per_warp - 1) / per_warp;
  return dim3((warps + kWarps - 1) / kWarps, pairs, stacks);
}

}  // namespace

extern "C" {

// Launch K4 on `stream`: the prologue over the T rows of bf16 x, then the
// gathered products behind it by programmatic dependent launch, on 4-bit
// (w4a8) or 8-bit (w8a8) experts; with data_up given, also the second
// stack (scales_up, biases_up, of the same shape) into y_up in the same
// launch. lanes and rows are gather_plan's. Scratch xq [T, K] int8,
// xg [T, G] f32 and sx [T] f32 is allocated by the caller. Returns the
// first CUDA error.
int ominix_gather_qmm(const void* x, const void* ids, const void* data,
                      const void* scales, const void* biases, void* y,
                      const void* data_up, const void* scales_up,
                      const void* biases_up, void* y_up, void* xq, void* xg,
                      void* sx, int T, int k, int E, int N, int K, int gs,
                      int bits, int lanes, int rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((bits != 4 && bits != 8) || T < 1 || k < 1 || T * k > 65535 ||
      by_plan(lanes, rows, KnownPlan{}) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = launch_prep_pdl(
      (const __nv_bfloat16*)x, nullptr, 0.f, T, K, gs, (int8_t*)xq,
      (float*)xg, (float*)sx, nullptr, st);
  if (e != cudaSuccess) return (int)e;
  const int stacks = data_up != nullptr ? 2 : 1;
  const GatherArgs a{
      (const int*)ids,
      {(const uint8_t*)data, (const uint8_t*)data_up},
      {(const __nv_bfloat16*)scales, (const __nv_bfloat16*)scales_up},
      {(const __nv_bfloat16*)biases, (const __nv_bfloat16*)biases_up},
      {(__nv_bfloat16*)y, (__nv_bfloat16*)y_up},
      (const int8_t*)xq, (const float*)xg, (const float*)sx, k, E, N, K, gs};
  const dim3 grid = rows_grid(N, lanes, rows, T * k, stacks);
  return by_plan(lanes, rows, [&](auto l, auto r) {
    constexpr int L = decltype(l)::value, R = decltype(r)::value;
    return (int)(bits == 4 ? launch_kernel(gather_qmm_a8<4, L, R>, grid,
                                           dim3(kThreads), 0, true, st, a)
                           : launch_kernel(gather_qmm_a8<8, L, R>, grid,
                                           dim3(kThreads), 0, true, st, a));
  });
}

// Launch K8 on `stream`: the prologue over the T rows of x (bf16 where
// x_bf16, else float32), then the gathered products behind it by
// programmatic dependent launch; with data_up given, also the second stack
// (scale_up) into y_up in the same launch. lanes and rows are
// gather_plan's. Scratch xq [T, K] int8 and sx [T] f32 is allocated by
// the caller. Returns the first CUDA error.
int ominix_channel_gather_qmm(const void* x, int x_bf16, const void* ids,
                              const void* data, const void* scale, void* y,
                              const void* data_up, const void* scale_up,
                              void* y_up, void* xq, void* sx, int T, int k,
                              int E, int N, int K, int lanes, int rows,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (T < 1 || k < 1 || T * k > 65535 ||
      by_plan(lanes, rows, KnownPlan{}) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      x_bf16 ? launch_kernel(chan_prep<__nv_bfloat16>, dim3(T),
                             dim3(kPrepThreads), K * 2, false, st,
                             (const __nv_bfloat16*)x, K, (int8_t*)xq,
                             (float*)sx)
             : launch_kernel(chan_prep<float>, dim3(T), dim3(kPrepThreads),
                             K * 4, false, st, (const float*)x, K,
                             (int8_t*)xq, (float*)sx);
  if (e != cudaSuccess) return (int)e;
  const int stacks = data_up != nullptr ? 2 : 1;
  const ChanArgs a{(const int*)ids,
                   {(const int8_t*)data, (const int8_t*)data_up},
                   {(const float*)scale, (const float*)scale_up},
                   {(float*)y, (float*)y_up},
                   (const int8_t*)xq, (const float*)sx, k, E, N, K};
  const dim3 grid = rows_grid(N, lanes, rows, T * k, stacks);
  return by_plan(lanes, rows, [&](auto l, auto r) {
    constexpr int L = decltype(l)::value, R = decltype(r)::value;
    return (int)launch_kernel(chan_gather_qmm<L, R>, grid, dim3(kThreads), 0,
                              true, st, a);
  });
}

}  // extern "C"
