// K3: paged decode attention (one query token per row over a paged KV pool).
//
// Replaces the TPU kernel _pa_kernel in ominix_mlx_tpu/ops/paged_attention.py
// (launched by _paged_decode_call). q [B, H, D] bf16; k_pool and v_pool
// [P, Hkv, page_size, D], bf16 pages or int8 codes with f32 per-token
// scales k_scale / v_scale [P, Hkv, page_size]; page_table [B, MP] int32
// (page 0 is the null page); lengths [B] int32, the valid tokens of each
// row counting this step's; out [B, H, D] bf16. window > 0 keeps only the
// last `window` positions of each row. The int8 mode follows the TPU
// kernel's formula: scores times the key's scale, and each probability
// times the value's scale before the AV sum (the softmax denominator stays
// unscaled). Table entries past a row's length are never read.
//
// What bounds it on an H100: bytes. Each row streams its K and V once
// (2 * len * Hkv * D elements) and does 4 * G FLOPs per element read, far
// below the card's ratio of operations to bytes. The pool layout puts a
// page's tokens for one KV head in one contiguous [page_size, D] block, so
// a tile of keys is one coalesced read. This first version is simple: one
// CTA per (row, KV head) holding that head's G query rows (GQA: K/V are
// read once for all of them). Its 4 warps take 32-key tiles in turn; a
// warp copies its tile's K and V rows raw into shared memory with cp.async
// (16 bytes a copy, all of a tile's copies in flight at once, the next
// tile's copies issued before this tile is computed where shared memory
// holds two stages), scores one key per lane against the G rows, keeps an
// online softmax per query row in registers, accumulates D/32 output dims
// per lane, and the 4 warps merge their partial softmaxes through shared
// memory at the end. K rows are padded to an odd number of 16-byte units,
// so the lane-per-key reads are free of bank conflicts. At B=8, Hkv=8 that
// is 64 CTAs on 132 SMs: splitting the sequence across CTAs
// (flash-decoding) is the later speed work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 32;           // keys per tile (one per lane)
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

// N consecutive elements at p (aligned to N * sizeof(KV), global or
// shared) as floats, read in one vector load. bf16 widens exactly by a
// 16-bit shift; int8 codes convert exactly. Little-endian: element 0 sits
// in the low bytes.
template <typename KV, int N>
__device__ __forceinline__ void load_f32(const KV* p, float (&out)[N]) {
  constexpr int kBytes = N * (int)sizeof(KV);
  static_assert(kBytes == 2 || kBytes == 4 || kBytes == 8 || kBytes == 16,
                "vector width");
  unsigned w[4] = {0u, 0u, 0u, 0u};
  if constexpr (kBytes == 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else if constexpr (kBytes == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    w[0] = x.x; w[1] = x.y;
  } else if constexpr (kBytes == 4) {
    w[0] = *reinterpret_cast<const unsigned*>(p);
  } else {
    w[0] = *reinterpret_cast<const unsigned short*>(p);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (sizeof(KV) == 2) {
      const unsigned x = w[i / 2];
      out[i] = __uint_as_float(i % 2 ? x & 0xffff0000u : x << 16);
    } else {
      out[i] = (float)(signed char)((w[i / 4] >> (8 * (i % 4))) & 0xffu);
    }
  }
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 zero-fills the
// destination without reading (the source address stays a valid row).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared-memory plan of one (D, R, KV) instance, in bytes.
template <int D, int R, typename KV>
struct Plan {
  static constexpr int kRowBytes = D * (int)sizeof(KV);
  static constexpr int kChunks = kRowBytes / 16;        // 16 B per row
  static constexpr int kRowK = kRowBytes + 16;          // odd # of 16 B units
  static constexpr int kStage = kBK * (kRowK + kRowBytes);   // K then V
  static constexpr int kStages = kRowBytes > 256 ? 1 : 2;
  static constexpr int kQ = R * D * (int)sizeof(float);
  static constexpr size_t kBytes = kQ + (size_t)kWarps * kStages * kStage;
  static_assert((kRowK / 16) % 2 == 1, "K rows must be an odd # of 16 B");
  static_assert(kWarps * kStages * kStage >= kWarps * R * (D + 2) * 4,
                "merge area");
};

// One CTA per (row b, KV head j, group of R query heads of that KV head).
template <int D, int R, typename KV>
__global__ void __launch_bounds__(kThreads)
paged_decode(const __nv_bfloat16* __restrict__ q,
             const KV* __restrict__ k_pool, const KV* __restrict__ v_pool,
             const float* __restrict__ k_scale,
             const float* __restrict__ v_scale,
             const int* __restrict__ table, const int* __restrict__ lengths,
             __nv_bfloat16* __restrict__ out, int H, int Hkv, int ps, int MP,
             int window, float scale) {
  using P = Plan<D, R, KV>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int DL = D / 32;               // output dims per lane
  constexpr int VEC = 16 / sizeof(KV);     // elements per 16 B chunk
  constexpr bool kQuant = sizeof(KV) == 1;
  float* qs = reinterpret_cast<float*>(smem);               // [R][D]
  unsigned char* stages = smem + P::kQ;
  const int b = blockIdx.x, j = blockIdx.y;
  const int G = H / Hkv;
  const int h0 = j * G + blockIdx.z * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = lengths[b];
  const int start = window > 0 ? max(len - window, 0) : 0;
  const int* trow = table + (size_t)b * MP;

  for (int i = tid; i < R * D; i += kThreads)
    qs[i] = __bfloat162float(q[((size_t)b * H + h0) * D + i]) * scale;
  __syncthreads();

  // Element offset of token t's row for this KV head (start <= t < len).
  auto row_of = [&](int t) -> size_t {
    const int page = trow[t / ps];
    return (((size_t)page * Hkv + j) * ps + t % ps) * D;
  };
  unsigned char* mine = stages + (size_t)warp * P::kStages * P::kStage;
  // Queue the copies of the tile at t0 into stage s (keys outside
  // [start, len) are zero-filled from a clamped, valid row).
  auto issue = [&](int t0, int s) {
    unsigned char* ks = mine + s * P::kStage;
    unsigned char* vs = ks + kBK * P::kRowK;
#pragma unroll 4
    for (int i = lane; i < kBK * P::kChunks; i += 32) {
      const int kk = i / P::kChunks, c = i % P::kChunks, t = t0 + kk;
      const bool ok = t >= start && t < len;
      const size_t row = row_of(min(max(t, start), len - 1));
      const int n = ok ? 16 : 0;
      cp_async16(ks + kk * P::kRowK + c * 16, k_pool + row + c * VEC, n);
      cp_async16(vs + kk * P::kRowBytes + c * 16, v_pool + row + c * VEC, n);
    }
    cp_async_commit();
  };

  float acc[R][DL], m_run[R], l_run[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_run[r] = -INFINITY;
    l_run[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.f;
  }

  // Every tile visited holds a valid key: t0 <= start + 31 and t0 < len.
  const int first = (start / kBK) * kBK + warp * kBK;
  constexpr int kStride = kWarps * kBK;
  if (first < len) issue(first, 0);
  for (int t0 = first, n = 0; t0 < len; t0 += kStride, ++n) {
    const int s = P::kStages == 2 ? n & 1 : 0;
    if constexpr (P::kStages == 2) {
      if (t0 + kStride < len) issue(t0 + kStride, s ^ 1);
      else cp_async_commit();              // keep one group per tile
      cp_async_wait<1>();                  // this tile's group has landed
    } else {
      if (n > 0) issue(t0, 0);             // the last tile's stage is free
      cp_async_wait<0>();
    }
    __syncwarp();
    const int t = t0 + lane;
    const bool valid = t >= start && t < len;
    float ksc = 1.f, vsc = 1.f;
    if (kQuant && valid) {
      const size_t si = row_of(t) / D;
      ksc = k_scale[si];
      vsc = v_scale[si];
    }
    const unsigned char* ks = mine + s * P::kStage;
    const unsigned char* vs = ks + kBK * P::kRowK;
    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r] = 0.f;
    const KV* kr = reinterpret_cast<const KV*>(ks + lane * P::kRowK);
#pragma unroll 4
    for (int c = 0; c < P::kChunks; ++c) {
      float kv[VEC];
      load_f32<KV, VEC>(kr + c * VEC, kv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          sc[r] = fmaf(qs[r * D + c * VEC + e], kv[e], sc[r]);
      }
    }
    float pv[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float sr = valid ? sc[r] * ksc : -INFINITY;
      const float m_new = fmaxf(m_run[r], warp_max(sr));   // finite
      const float alpha = expf(m_run[r] - m_new);
      const float p = valid ? expf(sr - m_new) : 0.f;
      l_run[r] = fmaf(l_run[r], alpha, warp_sum(p));
      m_run[r] = m_new;
      pv[r] = p * vsc;
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[r][i] *= alpha;
    }
    // AV: each lane its D/32 dims of every key (zero rows add nothing)
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[DL];
      load_f32<KV, DL>(reinterpret_cast<const KV*>(
                           vs + kk * P::kRowBytes) + lane * DL, vv);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float pj = __shfl_sync(kFull, pv[r], kk);
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[r][i] = fmaf(pj, vv[i], acc[r][i]);
      }
    }
    __syncwarp();                          // stage consumed before reuse
  }
  cp_async_wait<0>();

  // merge the warps' partial softmaxes (the staging area is reused)
  __syncthreads();
  float* red_acc = reinterpret_cast<float*>(stages);   // [kWarps][R][D]
  float* red_ml = red_acc + kWarps * R * D;            // [kWarps][R][2]
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < DL; ++i)
      red_acc[(warp * R + r) * D + lane * DL + i] = acc[r][i];
    if (lane == 0) {
      red_ml[(warp * R + r) * 2] = m_run[r];
      red_ml[(warp * R + r) * 2 + 1] = l_run[r];
    }
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red_ml[(w * R + r) * 2]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = red_ml[(w * R + r) * 2];
      const float f = mw == -INFINITY ? 0.f : expf(mw - m);
      num = fmaf(f, red_acc[(w * R + r) * D + d], num);
      den = fmaf(f, red_ml[(w * R + r) * 2 + 1], den);
    }
    out[((size_t)b * H + h0 + r) * D + d] = __float2bfloat16(num / den);
  }
}

template <int D, int R, typename KV>
int launch(const void* q, const void* kp, const void* vp, const void* ksc,
           const void* vsc, const void* table, const void* lengths, void* out,
           int B, int H, int Hkv, int ps, int MP, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t smem = Plan<D, R, KV>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      paged_decode<D, R, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B, Hkv, (H / Hkv) / R);
  paged_decode<D, R, KV><<<grid, kThreads, smem, stream>>>(
      (const __nv_bfloat16*)q, (const KV*)kp, (const KV*)vp,
      (const float*)ksc, (const float*)vsc, (const int*)table,
      (const int*)lengths, (__nv_bfloat16*)out, H, Hkv, ps, MP, window,
      scale);
  return (int)cudaGetLastError();
}

template <int D, typename KV>
int by_rows(int R, const void* q, const void* kp, const void* vp,
            const void* ksc, const void* vsc, const void* table,
            const void* lengths, void* out, int B, int H, int Hkv, int ps,
            int MP, int window, float scale, cudaStream_t st) {
  switch (R) {
    case 1: return launch<D, 1, KV>(q, kp, vp, ksc, vsc, table, lengths, out, B, H, Hkv, ps, MP, window, scale, st);
    case 2: return launch<D, 2, KV>(q, kp, vp, ksc, vsc, table, lengths, out, B, H, Hkv, ps, MP, window, scale, st);
    case 4: return launch<D, 4, KV>(q, kp, vp, ksc, vsc, table, lengths, out, B, H, Hkv, ps, MP, window, scale, st);
    case 8: return launch<D, 8, KV>(q, kp, vp, ksc, vsc, table, lengths, out, B, H, Hkv, ps, MP, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename KV>
int by_dim(int D, int R, const void* q, const void* kp, const void* vp,
           const void* ksc, const void* vsc, const void* table,
           const void* lengths, void* out, int B, int H, int Hkv, int ps,
           int MP, int window, float scale, cudaStream_t st) {
  switch (D) {
    case 64: return by_rows<64, KV>(R, q, kp, vp, ksc, vsc, table, lengths, out, B, H, Hkv, ps, MP, window, scale, st);
    case 128: return by_rows<128, KV>(R, q, kp, vp, ksc, vsc, table, lengths, out, B, H, Hkv, ps, MP, window, scale, st);
    case 256: return by_rows<256, KV>(R, q, kp, vp, ksc, vsc, table, lengths, out, B, H, Hkv, ps, MP, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// rows_per_cta: query heads per CTA (1, 2, 4 or 8, dividing H / Hkv).
// quant != 0: int8 pools with k_scale / v_scale; else bf16 pools.
extern "C" int ominix_paged_decode(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* table,
    const void* lengths, void* out, int B, int H, int Hkv, int D, int ps,
    int MP, int window, int rows_per_cta, int quant, float scale,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (quant)
    return by_dim<int8_t>(D, rows_per_cta, q, k_pool, v_pool, k_scale,
                          v_scale, table, lengths, out, B, H, Hkv, ps, MP,
                          window, scale, st);
  return by_dim<__nv_bfloat16>(D, rows_per_cta, q, k_pool, v_pool, k_scale,
                               v_scale, table, lengths, out, B, H, Hkv, ps,
                               MP, window, scale, st);
}
