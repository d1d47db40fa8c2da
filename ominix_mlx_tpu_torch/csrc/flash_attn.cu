// K2: causal flash-attention forward over a fresh prompt, with native GQA.
// K2c: the same kernel for a continuation chunk of a long prefill.
//
// K2 replaces the TPU flash kernel behind ominix_mlx_tpu/ops/flash_attention.py
// (_flash -> jax.experimental.pallas.ops.tpu.flash_attention, reached from
// flash_prefill). K2c replaces _flash_chunk (ops/flash_attention.py:116),
// which on the TPU makes two library flash calls (an unmasked prefix and a
// causal chunk) and merges them by LSE, because the library's causal flag
// is top-left aligned. Here one kernel shifts the causal diagonal instead.
//
// One kernel serves both: Tq queries at absolute positions pos..pos+Tq-1
// attend keys 0..pos+t (Tk = pos + Tq keys). K2 is the case pos = 0. q
// [B, H, Tq, D] bf16 contiguous; k/v bf16 with unit stride along D and any
// batch, head and sequence strides, so a chunk reads the [:pos+Tq] prefix of
// a capacity-sized cache in place (no per-chunk copy of the prefix); out
// [B, H, Tq, D] bf16 and lse [B, H, Tq] f32 (natural log of the softmax
// denominator of the scaled scores). Query head h reads KV head
// h / (H / Hkv): K/V are never repeated in memory. Any Tq and pos work: the
// ragged edges are masked, and the TPU's 128-alignment rules are gone.
//
// What bounds it on an H100: arithmetic at long T (4 * Tq * Tk * D FLOPs
// per head, about half of it masked away for a fresh prompt) against
// O(Tk * D) bytes, latency and launch cost at short T. This first version
// runs on the CUDA cores in f32, not the tensor cores: one CTA of 4 warps
// owns 16 query rows (4 per warp) and walks 32-key tiles of K and V staged
// in shared memory (f32, K rows padded by one word so a lane-per-key dot
// product is bank-conflict free). Each lane scores one key against its
// warp's 4 rows, the warp keeps an online softmax (running max and
// denominator) per row, and each lane accumulates D/32 output dims. Scores
// never reach device memory, and tiles past the CTA's last query are
// skipped. CTAs are issued heaviest first (last query tile first) so the
// causal tail does not run alone. Moving QK^T and PV onto wgmma is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 16;           // query rows per CTA
constexpr int kRows = 4;          // query rows per warp
constexpr int kBK = 32;           // keys per tile (one per lane)
constexpr int kThreads = 128;
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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * D + kBK * (D + 1) + kBK * D);
}

struct KVStrides {    // element strides of K and V (D has unit stride)
  long long kb, kh, kt, vb, vh, vt;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
          float* __restrict__ lse, int H, int Hkv, int Tq, int pos,
          KVStrides st, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                      // [kBQ][D], pre-scaled
  float* ks = qs + kBQ * D;              // [kBK][D + 1]
  float* vs = ks + kBK * (D + 1);        // [kBK][D]
  constexpr int DL = D / 32;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // heaviest first
  const int hk = h / (H / Hkv);
  const int Tk = pos + Tq;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const __nv_bfloat16* qb = q + ((size_t)b * H + h) * Tq * D;
  const __nv_bfloat16* kb = k + b * st.kb + hk * st.kh;
  const __nv_bfloat16* vb = v + b * st.vb + hk * st.vh;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int t = q0 + i / D;
    qs[i] = t < Tq ? __bfloat162float(qb[(size_t)t * D + i % D]) * scale : 0.f;
  }
  float acc[kRows][DL], m_run[kRows], l_run[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.f;
  }
  const int q_last = min(Tq, q0 + kBQ) - 1;
  const int n_tiles = (pos + q_last) / kBK + 1;
  const float* qw = qs + warp * kRows * D;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    __syncthreads();                     // previous tile fully consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, d = i % D, t = k0 + j;
      const bool in = t < Tk;
      ks[j * (D + 1) + d] = in ? __bfloat162float(kb[t * st.kt + d]) : 0.f;
      vs[j * D + d] = in ? __bfloat162float(vb[t * st.vt + d]) : 0.f;
    }
    __syncthreads();
    // scores of key (k0 + lane) against this warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* kr = ks + lane * (D + 1);
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = fmaf(qw[r * D + d], kd, s[r]);
    }
    const int kj = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + warp * kRows + r;
      const bool valid = kj < Tk && kj <= pos + qi;
      const float sr = valid ? s[r] : -INFINITY;
      // key 0 is valid for every row, so m_new is finite from tile 0 on
      const float m_new = fmaxf(m_run[r], warp_max(sr));
      const float alpha = expf(m_run[r] - m_new);
      const float p = valid ? expf(sr - m_new) : 0.f;
      l_run[r] = fmaf(l_run[r], alpha, warp_sum(p));
      m_run[r] = m_new;
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[r][i] *= alpha;
      for (int j = 0; j < kBK; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
        const float* vr = vs + j * D + lane;
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[r][i] = fmaf(pj, vr[32 * i], acc[r][i]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    if (qi >= Tq) continue;
    const float inv = 1.f / l_run[r];
    __nv_bfloat16* orow = o + (((size_t)b * H + h) * Tq + qi) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i)
      orow[lane + 32 * i] = __float2bfloat16(acc[r][i] * inv);
    if (lane == 0)
      lse[((size_t)b * H + h) * Tq + qi] = m_run[r] + logf(l_run[r]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Hkv, int Tq, int pos, KVStrides st, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // The limit is per device and costs little to set, so it is set on every
  // launch: a process that switches cards never meets the 48 KB default.
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_fwd<D><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, (float*)lse, H, Hkv, Tq,
      pos, st, scale);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int H, int Hkv, int Tq, int pos, int D, KVStrides st,
             float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64: return launch<64>(q, k, v, o, lse, B, H, Hkv, Tq, pos, st, scale, s);
    case 128: return launch<128>(q, k, v, o, lse, B, H, Hkv, Tq, pos, st, scale, s);
    case 256: return launch<256>(q, k, v, o, lse, B, H, Hkv, Tq, pos, st, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K2: contiguous q/k/v [B, H(kv), T, D], keys 0..t for query t.
extern "C" int ominix_flash_fwd(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int H, int Hkv,
                                int T, int D, float scale, void* stream) {
  const long long t = (long long)T * D;
  const KVStrides st{Hkv * t, t, D, Hkv * t, t, D};
  return dispatch(q, k, v, o, lse, B, H, Hkv, T, 0, D, st, scale, stream);
}

// K2c: Tq chunk queries at pos..pos+Tq-1 over the first pos+Tq keys of
// strided k/v (element strides per batch, head and position).
extern "C" int ominix_flash_chunk_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int Hkv, int Tq, int pos, int D, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st,
    float scale, void* stream) {
  const KVStrides st{k_sb, k_sh, k_st, v_sb, v_sh, v_st};
  return dispatch(q, k, v, o, lse, B, H, Hkv, Tq, pos, D, st, scale, stream);
}
