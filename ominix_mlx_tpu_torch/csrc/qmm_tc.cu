// K7: exact w4a16 matmul y[M, N] = x[M, K] @ W^T for 1 <= M <= 64 rows, W
// group-affine 4-bit in the port's packed layout (ops/quant_matmul.py
// prepare: data uint8 [N, K/2], natural nibble order, unsigned u = q + 8;
// bf16 scales and folded biases b' = b - 8s, [N, G]).
//
// Replaces the TPU kernel _vpu_kernel (ominix_mlx_tpu/ops/quant_matmul.py
// :1229, called by _qmm_vpu :1271; the row-major 4-bit branch of
// quantized_matmul at 17..64 rows, :1388) and computes its rounding, the dq
// formula: y = sum_k bf16((u_k - 8) * s_g) * x_k + sum_g xg_g * bh_g in f32,
// xg the bf16-rounded group sums of x and bh = bf16(b' + 8s) the unfolded
// bias (the plain version is qmm_dq_reference).
//
// What bounds it on an H100: bytes, still. At M = 64 a weight byte feeds
// 256 multiply-adds (two codes, 64 rows), under the ~295 FLOP/byte ridge,
// and the codes must be dequantised to bf16 before the tensor cores can
// take them. A K1-style warp per output row would re-read x for each row
// (K1 at M = 16 already streams only ~100 GB/s), so this kernel tiles:
// a CTA of 4 warps owns 64 output rows and all M rows of x, and walks K
// 32 at a time (one group never straddles a step: gs % 32 == 0). Each step
// stages the x tile (M padded to 16, zero rows) and the dequantised weight
// tile in shared memory, then each warp runs mma.sync m16n8k16 (bf16 in,
// f32 accumulators) over its 16 output columns, fragments read with
// ldmatrix (K5's mapping, grouped_mm.cu). The bias term is added to the
// accumulators at the first step of each group. No split of K and no
// atomics: the output is bitwise repeatable.
// Later work: cp.async double buffering of the packed bytes, wgmma, a
// split of K for the small-N projections.

#include "qmm_common.cuh"

namespace {

constexpr int BN = 64, BK = 32;
constexpr int kThreads = 128;        // 4 warps, 16 output columns each
constexpr int LDS = BK + 8;          // shared row pitch: 80 bytes, so the 8
                                     // rows of an ldmatrix hit 8 banks

__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* smem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// grid ceil(N / BN); MT16 = ceil(M / 16) row tiles of x.
template <int MT16>
__global__ void __launch_bounds__(kThreads)
qmm_w4a16_tc(const __nv_bfloat16* __restrict__ x,
             const uint8_t* __restrict__ data,
             const __nv_bfloat16* __restrict__ sc,
             const __nv_bfloat16* __restrict__ bs,
             const float* __restrict__ xg, __nv_bfloat16* __restrict__ y,
             int M, int N, int K, int gs) {
  __shared__ __align__(16) __nv_bfloat16 Xs[MT16 * 16][LDS];
  __shared__ __align__(16) __nv_bfloat16 Ws[BN][LDS];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int n0 = blockIdx.x * BN, G = K / gs;
  float acc[MT16][2][4];
#pragma unroll
  for (int mi = 0; mi < MT16; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  // this thread's weight half-row: row wr of the tile, codes wh*16..+16
  const int wr = tid >> 1, wh = tid & 1, wn = n0 + wr;
  for (int k0 = 0; k0 < K; k0 += BK) {
    const int g = k0 / gs;
    // x tile: MT16 * 16 rows x 4 chunks of 8 bf16; rows >= M are zero
    for (int i = tid; i < MT16 * 16 * 4; i += kThreads) {
      const int r = i >> 2, c = (i & 3) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < M)
        v = __ldg(reinterpret_cast<const uint4*>(x + (size_t)r * K + k0 + c));
      *reinterpret_cast<uint4*>(&Xs[r][c]) = v;
    }
    // weight tile: 16 codes (8 bytes) a thread, dequantised with the TPU
    // kernel's rounding bf16((u - 8) * s); rows past N are zero
    {
      uint4 out[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
      if (wn < N) {
        const uint2 b8 = __ldg(reinterpret_cast<const uint2*>(
            data + (size_t)wn * (K / 2) + k0 / 2 + wh * 8));
        const float s = __bfloat162float(sc[(size_t)wn * G + g]);
        const uint32_t words[2] = {b8.x, b8.y};
        uint32_t* o = reinterpret_cast<uint32_t*>(out);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t byte = (words[i] >> (8 * j)) & 0xFFu;
            o[4 * i + j] = pack_bf16(((float)(byte & 15u) - 8.f) * s,
                                     ((float)(byte >> 4) - 8.f) * s);
          }
      }
      *reinterpret_cast<uint4*>(&Ws[wr][wh * 16]) = out[0];
      *reinterpret_cast<uint4*>(&Ws[wr][wh * 16 + 8]) = out[1];
    }
    __syncthreads();
    if (k0 % gs == 0) {
      // the bias term of group g: xg[m, g] * bh[n, g] on each accumulator
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        float bh[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wid * 16 + ni * 8 + (lane & 3) * 2 + e;
          bh[e] = 0.f;
          if (n < N) {
            const size_t o = (size_t)n * G + g;
            bh[e] = bf16r(__bfloat162float(bs[o])
                          + 8.f * __bfloat162float(sc[o]));
          }
        }
#pragma unroll
        for (int mi = 0; mi < MT16; ++mi) {
          const int r = mi * 16 + (lane >> 2);
          const float x0 = r < M ? xg[(size_t)r * G + g] : 0.f;
          const float x1 = r + 8 < M ? xg[(size_t)(r + 8) * G + g] : 0.f;
          acc[mi][ni][0] = fmaf(x0, bh[0], acc[mi][ni][0]);
          acc[mi][ni][1] = fmaf(x0, bh[1], acc[mi][ni][1]);
          acc[mi][ni][2] = fmaf(x1, bh[0], acc[mi][ni][2]);
          acc[mi][ni][3] = fmaf(x1, bh[1], acc[mi][ni][3]);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned b[4];
      ldmatrix_x4(b, &Ws[wid * 16 + (lane & 7) + (lane >> 4) * 8]
                        [kk + ((lane >> 3) & 1) * 8]);
#pragma unroll
      for (int mi = 0; mi < MT16; ++mi) {
        unsigned a[4];
        ldmatrix_x4(a, &Xs[mi * 16 + (lane & 15)][kk + (lane >> 4) * 8]);
        mma_bf16(acc[mi][0], a, b[0], b[1]);
        mma_bf16(acc[mi][1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < MT16; ++mi) {
    const int r = mi * 16 + (lane >> 2);
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const int n = n0 + wid * 16 + ni * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 8 * h;
        if (rr >= M) continue;
        __nv_bfloat16* p = y + (size_t)rr * N + n;
        if (n < N) p[0] = __float2bfloat16(acc[mi][ni][2 * h]);
        if (n + 1 < N) p[1] = __float2bfloat16(acc[mi][ni][2 * h + 1]);
      }
    }
  }
}

template <int MT16>
void launch(const __nv_bfloat16* x, const uint8_t* d,
            const __nv_bfloat16* sc, const __nv_bfloat16* bs,
            const float* xg, __nv_bfloat16* y, int M, int N, int K, int gs,
            cudaStream_t st) {
  qmm_w4a16_tc<MT16><<<(N + BN - 1) / BN, kThreads, 0, st>>>(
      x, d, sc, bs, xg, y, M, N, K, gs);
}

}  // namespace

extern "C" {

// Launches K7 on `stream`: the group-sum prologue (scratch xg [M, G] f32
// from the caller), then the tiles. bits == 4, 1 <= M <= 64, K and gs
// multiples of 32 (the signature is ominix_qmm_dq's). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for another width.
int ominix_qmm_w4a16_tc(const void* x, const void* data, const void* scales,
                        const void* biases, void* y, void* xg, int M, int N,
                        int K, int gs, int bits, void* stream) {
  if (bits != 4 || M < 1 || M > 64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const auto* xb = (const __nv_bfloat16*)x;
  qmm_prep<<<M, kPrepThreads, 0, st>>>(xb, nullptr, 0.f, K, gs, nullptr,
                                       (float*)xg, nullptr, nullptr);
  const auto* d = (const uint8_t*)data;
  const auto* sc = (const __nv_bfloat16*)scales;
  const auto* bs = (const __nv_bfloat16*)biases;
  const auto* g = (const float*)xg;
  auto* yb = (__nv_bfloat16*)y;
  if (M <= 16) launch<1>(xb, d, sc, bs, g, yb, M, N, K, gs, st);
  else if (M <= 32) launch<2>(xb, d, sc, bs, g, yb, M, N, K, gs, st);
  else if (M <= 48) launch<3>(xb, d, sc, bs, g, yb, M, N, K, gs, st);
  else launch<4>(xb, d, sc, bs, g, yb, M, N, K, gs, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
