// k9_decode: a Gated DeltaNet layer's whole decode mixer (T = 1), from its
// two input projections' outputs to the input of out_proj, in one launch
// (models/deltanet.py block at T = 1; its plain version is
// ops/gated_delta.py deltanet_decode_reference):
//
//   q, k, v, z, b, a   read in place from qkvz and ba (the per-key-head
//                      interleaved packing of HF's
//                      fix_query_key_value_ordering)
//   y = silu(conv(window ++ [q | k | v]))   the depthwise causal conv over
//                      the carried window of K - 1 = 3 inputs, the window
//                      advanced in place
//   beta = sigmoid(b), g = -exp(A_log) softplus(a + dt_bias)   (float32)
//   q^ = l2norm(y_q) dk^-0.5, k^ = l2norm(y_k)                  (float32)
//   S = S exp(g); delta = (v - S^T k^) beta; S += k^ delta^T; o = S^T q^
//                      (value head h reads key head h / (Hv / Hk); the
//                      state [B, Hv, dk, dv] float32 advanced in place)
//   out = rmsnorm(o cast to x's type) * w * silu(z)   per value head over
//                      dv, each product rounded to x's type
//
// No TPU kernel computes this: the JAX package leaves it to XLA
// (ominix_mlx_tpu/models/deltanet.py:103-150 at T = 1). It replaces, at a
// decode step, k9_prep (k9_prep.cu), K9's recurrent form (gated_delta.cu)
// and the some ten launches of the glue after them (the cast, rms_norm,
// silu, the product): a decode step is host bound, and its device time is
// mostly launch gaps.
//
// What bounds it on an H100: bytes, the state read and written once (2 MiB
// each way a row at Qwen3-Next's 32 value heads of 128 x 128); qkvz, the
// window and the output are some 50 KB a row.
//
// The arithmetic is k9_prep's and K9's, so the state and the window come
// out bit for bit as k9_prep then K9 leave them: the conv a float32 sum of
// its taps in tap order (no fused multiply-add) rounded once to x's type,
// SiLU rounded to x's type; the l2norm's sum of squares as k9_prep's warp
// sums it (a lane's 4 channels in order, then a butterfly); the state step
// K9's fmaf chains with a column's four threads folded by two shuffles.
// The gated norm takes the plain path's roundings (the cast of o, the
// float32 mean of squares in the order of PyTorch's CUDA reduction of a
// 128-wide row: a lane's 4-vector in order, then a shuffle-down tree;
// rsqrtf(mean + eps), the cast, the weight, the gate: each product rounded
// to x's type).
//
// The design: a CTA of 256 threads per (64 value columns, value head,
// row), four threads a column holding dk / 4 state rows (K9's layout); the
// CTAs of one (row, key head), 2 halves x r value heads, form one thread
// block cluster (2 r <= 8 CTAs; grid (2 r, Hk, B)).
//   * The state strip (32 KiB a CTA) is copied first into shared memory
//     (cp.async, rows padded to 72 floats so the step's reads hit 32
//     banks), with the conv taps and the norm weights read beside it,
//     before griddepcontrol.wait: launched by programmatic dependent
//     launch (the model's call), these loads overlap the projection ahead
//     of it, which writes none of them. Staged there, the strip leaves the
//     prologue its registers; 4 CTAs an SM (64 registers, about 150 KiB of
//     shared memory) leave room for B = 8's 512 CTAs. The step reads k
//     and q from shared memory at each use: held in registers beside the
//     32 state values, they spilled at the 64-register cap.
//   * Every CTA computes its key head's 256 q | k channels itself (conv,
//     SiLU, l2norm: warp 0 q, warp 1 k, 4 channels a lane), warps 2-3 its
//     64 v channels, warps 4-5 its 64 silu(z), warp 6 the head's g and
//     beta; all of it stays in shared memory: nothing goes through global
//     memory between the prologue and the step.
//   * The gated norm spans a value head's 2 CTAs: each sends its 16
//     partial sums of squares (PyTorch's lanes 16 s .. 16 s + 15) into the
//     shared memory of both (distributed shared memory), and after one
//     cluster barrier each CTA folds the same 32 partials in the same tree.
//   * The window: a CTA's v channels are read and written by that CTA
//     alone; the q | k channels are read by all 2 r CTAs of the cluster, so
//     rank 0 writes them only after the cluster barrier, which each CTA
//     reaches after its reads (its arrive releases them). No ticket, no
//     scratch in device memory, no host read: a CUDA graph replays it.
// x (qkvz, ba, the window, the taps, the norm weight, the output) is bf16
// or float32; dk = dv = 128; the conv's K = 4; Hv / Hk in 1..4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_common.cuh"

namespace {

constexpr int kD = 128;              // dk = dv
constexpr int kTaps = 4;             // the conv's K
constexpr int kCols = 64;            // value columns a CTA
constexpr int kStrips = kD / kCols;  // CTAs a value head
constexpr int kThreads = 4 * kCols;  // four threads a column
constexpr int kRows = kD / 4;        // state rows a thread
constexpr int kMaxRatio = 4;         // Hv / Hk: clusters of 2 r <= 8 CTAs
constexpr int kLdS = kCols + 8;      // the staged strip's row: reads by
                                     // (row 4 j + part, column c) hit 32 banks
constexpr int kMinCtas = 4;          // CTAs an SM (at most 64 registers)
constexpr int kParts = kCols / 4;    // PyTorch's norm lanes a CTA

template <typename X>
struct Io;
template <>
struct Io<float> {
  static __device__ __forceinline__ float get(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float put(float x) { return x; }
};
template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float get(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 put(float x) {
    return __float2bfloat16_rn(x);
  }
};

// Four consecutive values of x's type, kept as loaded (bf16 stays packed
// until read, to spare registers beside the state strip).
template <typename X>
struct Vec4;
template <>
struct Vec4<float> {
  float4 f;
  __device__ __forceinline__ void load(const float* p) {
    f = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = f;
  }
  __device__ __forceinline__ float operator[](int e) const {
    return e == 0 ? f.x : e == 1 ? f.y : e == 2 ? f.z : f.w;
  }
};
template <>
struct Vec4<__nv_bfloat16> {
  uint2 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ void store(__nv_bfloat16* p) const {
    *reinterpret_cast<uint2*>(p) = u;
  }
  __device__ __forceinline__ float operator[](int e) const {
    const uint32_t w = e < 2 ? u.x : u.y;
    return (e & 1) ? __uint_as_float(w & 0xffff0000u)
                   : __uint_as_float(w << 16);
  }
};

// The cluster barrier in two halves (every thread of the cluster arrives
// and waits in turn): arrive.relaxed orders nothing, the plain arrive
// releases this thread's earlier memory operations, wait acquires.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
// Stores v at the shared-memory address of `p` in the cluster's CTA `rank`.
__device__ __forceinline__ void st_cluster(float* p, uint32_t rank, float v) {
  const uint32_t local = (uint32_t)__cvta_generic_to_shared(p);
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v)
               : "memory");
}

// 16-byte asynchronous copy global -> shared (cached in L2 only)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename X>
struct DecodeArgs {
  const X* qkvz;          // [B, 1, Hk (2 dk + 2 r dv)]
  const X* ba;            // [B, 1, 2 Hv]
  X* window;              // [B, K - 1, conv_dim], in place
  const X* conv_w;        // [conv_dim, K]
  const float* A_log;     // [Hv]
  const float* dt_bias;   // [Hv]
  float* state;           // [B, Hv, dk, dv], in place
  const X* norm_w;        // [dv]
  X* out;                 // [B, 1, Hv dv]
  int Hk, r;
  float q_scale, eps;
};

template <typename X>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    k9_decode_kernel(const DecodeArgs<X> a) {
  using io = Io<X>;
  __shared__ __align__(16) float s_state[kD * kLdS];   // the state strip
  __shared__ float s_q[kD], s_k[kD];
  __shared__ float s_v[kCols], s_o[kCols], s_gate[kCols], s_w[kCols];
  __shared__ float s_part[kStrips * kParts];   // the value head's 32
  __shared__ float s_g, s_beta;
  __shared__ __align__(16) X s_win[kTaps - 1][2 * kD];   // new q | k rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int part = tid & 3, c = tid >> 2;
  const int rank = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int r = a.r, Hk = a.Hk, Hv = Hk * r;
  const int vh = rank / kStrips, strip = rank % kStrips, hv = hk * r + vh;
  const int kd = Hk * kD, conv_dim = 2 * kd + Hv * kD;
  const int head = (2 + 2 * r) * kD;           // qkvz per key head
  const X* xh = a.qkvz + (size_t)b * Hk * head + (size_t)hk * head;
  X* win = a.window + (size_t)b * (kTaps - 1) * conv_dim;

  cluster_arrive_relaxed();   // this CTA runs (waited for before the sends)

  // the state strip (128 rows x 64 columns) into shared memory, 16 bytes
  // a copy, in flight through the prologue
  float* S = a.state + ((size_t)b * Hv + hv) * kD * kD + strip * kCols;
#pragma unroll
  for (int m = 0; m < kD * kCols / 4 / kThreads; ++m) {
    const int i = tid + kThreads * m, row = i / (kCols / 4),
              ch = i % (kCols / 4);
    cp_async16(&s_state[row * kLdS + 4 * ch], S + (size_t)row * kD + 4 * ch);
  }

  // the parameters: nothing on the stream writes them
  // warps 0, 1: q, k (4 channels a lane); 2, 3: v and 4, 5: z (a column
  // a lane); 6: g and beta
  Vec4<X> w[4];                  // a channel's 4 taps each
  const int qk_chan = (warp == 1 ? kd : 0) + hk * kD + 4 * lane;
  const int col = (warp & 1) * 32 + lane;         // warps 2-5's column
  const int v_chan = 2 * kd + hv * kD + strip * kCols + col;
  if (warp < 2) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e].load(a.conv_w + (size_t)(qk_chan + e) * kTaps);
  } else if (warp < 4) {
    w[0].load(a.conv_w + (size_t)v_chan * kTaps);
  } else if (warp < 6) {
    s_w[col] = io::get(a.norm_w[strip * kCols + col]);
  }

  griddep_wait();   // qkvz and ba are the projections' outputs

  X vwin[kTaps - 1];   // warps 2, 3: a v channel's new window rows

  if (warp < 2) {   // q (warp 0) or k (warp 1) of key head hk: 4 channels
    const int src = (warp == 1 ? kD : 0) + 4 * lane;   // in the head's block
    Vec4<X> h0, h1, h2, xv;
    h0.load(win + qk_chan);
    h1.load(win + conv_dim + qk_chan);
    h2.load(win + 2 * conv_dim + qk_chan);
    xv.load(xh + src);
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float acc = __fmul_rn(h0[e], w[e][0]);
      acc = __fadd_rn(acc, __fmul_rn(h1[e], w[e][1]));
      acc = __fadd_rn(acc, __fmul_rn(h2[e], w[e][2]));
      acc = __fadd_rn(acc, __fmul_rn(xv[e], w[e][3]));
      const float cv = io::round(acc);
      y[e] = io::round(cv / (1.f + expf(-cv)));
    }
    float ss = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) ss = __fadd_rn(ss, __fmul_rn(y[e], y[e]));
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) ss += __shfl_xor_sync(kFull, ss, m);
    const float inv = rsqrtf(ss + 1e-6f);
    float* dst = (warp == 0 ? s_q : s_k) + 4 * lane;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float n = __fmul_rn(y[e], inv);
      dst[e] = warp == 0 ? __fmul_rn(n, a.q_scale) : n;
    }
    // the new window rows of these channels, for rank 0 to write
    X* nw = &s_win[0][0] + warp * kD + 4 * lane;
    h1.store(nw);
    h2.store(nw + 2 * kD);
    xv.store(nw + 4 * kD);
  } else if (warp < 4) {    // v: column col of this strip
    const X h0 = win[v_chan];
    vwin[0] = win[conv_dim + v_chan];
    vwin[1] = win[2 * conv_dim + v_chan];
    vwin[2] = xh[2 * kD + vh * kD + strip * kCols + col];
    float acc = __fmul_rn(io::get(h0), w[0][0]);
#pragma unroll
    for (int t = 0; t < kTaps - 1; ++t)
      acc = __fadd_rn(acc, __fmul_rn(io::get(vwin[t]), w[0][t + 1]));
    const float cv = io::round(acc);
    s_v[col] = io::round(cv / (1.f + expf(-cv)));
  } else if (warp < 6) {    // silu(z) of column col
    const float zf =
        io::get(xh[2 * kD + r * kD + vh * kD + strip * kCols + col]);
    s_gate[col] = io::round(zf / (1.f + expf(-zf)));
  } else if (warp == 6) {   // the value head's g and beta
    if (lane == 0) {
      const X* bar = a.ba + (size_t)b * 2 * Hv + hk * 2 * r;   // [b, a]
      const float bv = io::get(bar[vh]);
      const float av = io::get(bar[r + vh]);
      s_beta = 1.f / (1.f + expf(-bv));
      const float x = av + a.dt_bias[hv];
      const float sp = x > 20.f ? x : log1pf(expf(x));
      s_g = -expf(a.A_log[hv]) * sp;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // the step (K9's arithmetic at T = 1): a thread's rows 4 j + part of
  // column c
  float s[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) s[j] = s_state[(4 * j + part) * kLdS + c];
  const float vt = s_v[c], beta_t = s_beta, decay = expf(s_g);
  // k and q read from shared memory at each use (volatile), so that the
  // compiler does not hold 64 of them in registers beside the 32 of s
  const volatile float* kk = s_k;
  const volatile float* qq = s_q;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    s[j] *= decay;
    acc[j & 3] = fmaf(s[j], kk[4 * j + part], acc[j & 3]);
  }
  float kv = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  kv += __shfl_xor_sync(kFull, kv, 1);
  kv += __shfl_xor_sync(kFull, kv, 2);
  const float delta = (vt - kv) * beta_t;
  float o4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    s[j] = fmaf(kk[4 * j + part], delta, s[j]);
    o4[j & 3] = fmaf(s[j], qq[4 * j + part], o4[j & 3]);
  }
  float o = (o4[0] + o4[1]) + (o4[2] + o4[3]);
  o += __shfl_xor_sync(kFull, o, 1);
  o += __shfl_xor_sync(kFull, o, 2);
  if (part == 0) s_o[c] = o;
  __syncthreads();

  // the strip's 16 partial sums of squares of o in x's type (PyTorch's
  // lanes 16 strip .. 16 strip + 15, a 4-vector each), sent to the value
  // head's 2 CTAs
  float p = 0.f;
  if (warp == 0 && lane < kParts) {
    const float y0 = io::round(s_o[4 * lane]);
    p = __fmul_rn(y0, y0);
#pragma unroll
    for (int e = 1; e < 4; ++e) {
      const float ye = io::round(s_o[4 * lane + e]);
      p = __fadd_rn(p, __fmul_rn(ye, ye));
    }
  }
  cluster_wait();             // every CTA of the cluster runs
  if (warp == 0 && lane < kParts) {
#pragma unroll
    for (int t = 0; t < kStrips; ++t)
      st_cluster(&s_part[strip * kParts + lane], vh * kStrips + t, p);
  }
  cluster_arrive();           // the partials sent, the window read
  // the new state and the v channels' window after the arrive, so its
  // release waits for none of it (this CTA alone reads and writes both)
#pragma unroll
  for (int j = 0; j < kRows; ++j) S[(size_t)(4 * j + part) * kD + c] = s[j];
  if (warp == 2 || warp == 3) {
#pragma unroll
    for (int t = 0; t < kTaps - 1; ++t)
      win[(size_t)t * conv_dim + v_chan] = vwin[t];
  }
  cluster_wait();             // every partial here, every window read done

  if (rank == 0) {            // the key head's q | k window channels
    constexpr int kPieces = kD * (int)sizeof(X) / 16;   // 16 B a piece
    for (int i = tid; i < (kTaps - 1) * 2 * kPieces; i += kThreads) {
      const int row = i / (2 * kPieces), seg = (i / kPieces) % 2,
                pc = i % kPieces;
      const uint4 val =
          reinterpret_cast<const uint4*>(&s_win[row][seg * kD])[pc];
      reinterpret_cast<uint4*>(win + (size_t)row * conv_dim + seg * kd +
                               hk * kD)[pc] = val;
    }
  }
  if (warp < 2) {             // the gated norm of column cn
    const int cn = warp * 32 + lane;
    float pp = s_part[lane];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
      pp = __fadd_rn(pp, __shfl_down_sync(kFull, pp, m));
    const float mean = __fmul_rn(__shfl_sync(kFull, pp, 0), 1.f / kD);
    const float inv = rsqrtf(__fadd_rn(mean, a.eps));
    const float y = io::round(s_o[cn]);
    const float n = io::round(__fmul_rn(y, inv));
    const float gw = io::round(__fmul_rn(n, s_w[cn]));
    a.out[((size_t)b * Hv + hv) * kD + strip * kCols + cn] =
        io::put(__fmul_rn(gw, s_gate[cn]));
  }
}

template <typename X>
cudaError_t launch(const DecodeArgs<X>& args, int B, bool pdl,
                   cudaStream_t st) {
  const int cluster = kStrips * args.r;
  static bool carveout = false;     // shared memory for 4 CTAs an SM
  if (!carveout) {
    const cudaError_t e = cudaFuncSetAttribute(
        k9_decode_kernel<X>, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    carveout = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, args.Hk, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = pdl ? 1 : 0;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, k9_decode_kernel<X>, args);
}

template <typename X>
int run(const void* qkvz, const void* ba, void* window, const void* conv_w,
        const void* A_log, const void* dt_bias, void* state,
        const void* norm_w, void* out, int B, int Hk, int Hv, float q_scale,
        float eps, int pdl, void* stream) {
  DecodeArgs<X> a;
  a.qkvz = (const X*)qkvz;
  a.ba = (const X*)ba;
  a.window = (X*)window;
  a.conv_w = (const X*)conv_w;
  a.A_log = (const float*)A_log;
  a.dt_bias = (const float*)dt_bias;
  a.state = (float*)state;
  a.norm_w = (const X*)norm_w;
  a.out = (X*)out;
  a.Hk = Hk;
  a.r = Hv / Hk;
  a.q_scale = q_scale;
  a.eps = eps;
  return (int)launch<X>(a, B, pdl != 0, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// k9_decode on `stream` (see above), one launch: qkvz [B, 1, Hk (2 dk + 2
// r dv)], ba [B, 1, 2 Hv], the window [B, 3, conv_dim] (advanced in
// place), the taps [conv_dim, 4], the norm weight [dv] and the output [B,
// 1, Hv dv], all bf16 (1) or all float32 (0), contiguous with 16-byte
// aligned bases; A_log and dt_bias [Hv] float32; the state [B, Hv, dk, dv]
// float32, advanced in place. q_scale is the float32 of dk^-0.5, eps the
// gated norm's. dk = dv = 128, conv_k = 4, Hv / Hk in 1..4, B and Hk at
// most 65535. pdl != 0 launches behind the work before it by programmatic
// dependent launch: the state, the taps and the norm weight are then read
// before that work ends, so it must write none of them. Returns the first
// CUDA error (cudaErrorInvalidValue, nothing launched, for what it does
// not take).
int ominix_k9_decode(const void* qkvz, const void* ba, void* window,
                     const void* conv_w, const void* A_log,
                     const void* dt_bias, void* state, const void* norm_w,
                     void* out, int B, int Hk, int Hv, int dk, int dv,
                     int conv_k, int bf16, float q_scale, float eps, int pdl,
                     void* stream) {
  if (B < 1 || Hk < 1 || Hv < Hk || Hv % Hk != 0 || Hv / Hk > kMaxRatio ||
      dk != kD || dv != kD || conv_k != kTaps || B > 65535 || Hk > 65535)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return run<__nv_bfloat16>(qkvz, ba, window, conv_w, A_log, dt_bias,
                              state, norm_w, out, B, Hk, Hv, q_scale, eps,
                              pdl, stream);
  return run<float>(qkvz, ba, window, conv_w, A_log, dt_bias, state, norm_w,
                    out, B, Hk, Hv, q_scale, eps, pdl, stream);
}

// The most clusters of k9_decode at Hv / Hk = r that the card holds at
// once (cudaOccupancyMaxActiveClusters), each of 2 r CTAs, or -1 where the
// query fails.
int ominix_k9_decode_clusters(int r, int bf16) {
  if (r < 1 || r > kMaxRatio) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kStrips * r, 1, 1);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kStrips * r;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  const cudaError_t e =
      bf16 ? cudaOccupancyMaxActiveClusters(
                 &n, k9_decode_kernel<__nv_bfloat16>, &cfg)
           : cudaOccupancyMaxActiveClusters(&n, k9_decode_kernel<float>,
                                            &cfg);
  return e == cudaSuccess ? n : -1;
}

}  // extern "C"
