// K1 and K6: quantized skinny matmuls y[M, N] = x[M, K] @ W^T with the P
// formula, W group-affine 4- or 8-bit (per-group bf16 scale and bias).
//
// Replaces two TPU kernels of ominix_mlx_tpu/ops/quant_matmul.py:
//   * _pt_kernel (A1; M = 1 over transposed panels, w4/w8, a8/a16, RMSNorm
//     fused for 4-bit): K1 at M = 1;
//   * _pm_kernel (A4; row-major, M <= 16, w4a8 / w8a8 / w8a16): K6, the P
//     formula over M rows.
// K1 at 2 <= M <= 16 (A3, the dq formula) runs on the tensor cores in
// qmm_tc.cu. The port keeps one row-major layout for all of them;
// ops/quant_matmul.py route() picks the formula the JAX package would.
//
// Weight layout (ops/quant_matmul.py prepare): 4-bit data uint8 [N, K/2],
// byte j of a row = u[2j] | u[2j+1] << 4 with unsigned codes u = q + 8,
// biases b' = b - 8s; 8-bit data int8 [N, K] (centred codes q), biases b.
// Scales and biases bf16 [N, G]. Below, c is the stored code (u or q) and
// b* the stored bias.
//
// The P formula (qmm_p; the plain version is qmm_p_reference): per row m,
// a8: sx = max|x| / 127 + 1e-12, cx = rint(x / sx) as int8, P_g =
// sum_{k in g} c_k * cx_k in int32 (__dp4a, exact like the MXU's int32);
// a16: sx = 1, P_g = sum c_k * x_k in f32. Then
// y = sx * sum_g s_g * P_g + sum_g b*_g * xg_g, xg the bf16-rounded group
// sums of x (of the normed x when K1 fuses the norm).
//
// What bounds it on an H100: bytes. At M = 1 every weight byte is read once
// and used for one or two multiply-adds, far below the card's ~295
// FLOP/byte ridge, so the kernel is a stream of the code bytes plus 4 bytes
// of scale and bias per group. The design keeps that stream going:
//   * the activation prologue (norm, group sums, int8 quantisation) is a
//     kernel of M CTAs (qmm_prep_pdl, each staging its row of x in shared
//     memory with one round of loads) that the rows kernel follows by
//     programmatic dependent launch: the rows kernel starts at once, issues
//     its weight, scale and bias loads, and only then waits for the
//     prologue (griddep_wait) before it reads x's codes, so the prologue
//     runs under the first weight bytes instead of ahead of them (where
//     the host issues the rows kernel after the prologue has run, as in a
//     host-bound decode step, there is nothing to overlap). A prologue run
//     by every CTA itself at one row measured slower: its latency is
//     repeated in every wave of CTAs;
//   * a warp owns RW consecutive output rows (1, 2 or 4, from
//     qmm_p_rows_per_warp in ops/quant_matmul.py: as many as still leave
//     16 warps an SM), its lanes on 16-byte chunks of K (lane c takes
//     chunks c, c + 32, ...); a lane issues the loads of a batch of chunk
//     positions of all RW rows (8 chunks, 128 bytes, with int8 x up to 4
//     rows; fewer with bf16 x) before it uses any of them;
//   * with int8 x, each lane reads x's codes for a chunk once and applies
//     them to all RW rows, so x is read from L1 once per RW rows, not once
//     per row (bf16 x is read once a row: its unpacked codes come first).
// Each output row is summed in one fixed order whatever RW is (a lane's
// chunks in order, then a warp butterfly; no atomics), so greedy decode
// is deterministic and the plan does not change a bit of the output.

#include "qmm_common.cuh"

namespace {

constexpr int kWarps = 4;                 // warps a CTA
constexpr int kThreads = kWarps * 32;

// The chunk's codes as floats: 4-bit unsigned u in natural order, 8-bit q.
template <int BITS>
__device__ __forceinline__ void unpack_chunk(const uint4 w, float* c) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t byte = (words[i] >> (8 * j)) & 0xFFu;
      if constexpr (BITS == 4) {
        c[8 * i + 2 * j] = (float)(byte & 15u);
        c[8 * i + 2 * j + 1] = (float)(byte >> 4);
      } else {
        c[4 * i + j] = (float)(int8_t)byte;
      }
    }
  }
}

// sum_i c[i] * x[i] over the chunk's codes, x bf16 at xr (16-byte aligned),
// accumulated into acc in order.
template <int NC>
__device__ __forceinline__ float dot_bf16(const float* c,
                                          const __nv_bfloat16* xr,
                                          float acc) {
  const uint4* xv = reinterpret_cast<const uint4*>(xr);
#pragma unroll
  for (int q = 0; q < NC / 8; ++q) {
    const uint4 xx = __ldg(xv + q);
    const uint32_t xw[4] = {xx.x, xx.y, xx.z, xx.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&xw[t]));
      acc = fmaf(c[8 * q + 2 * t], f.x, acc);
      acc = fmaf(c[8 * q + 2 * t + 1], f.y, acc);
    }
  }
  return acc;
}

// The P formula over M <= MT rows of x: xq int8 [M, K] (a8) or xa bf16
// [M, K] (a16), xg f32 [M, G], sx [M] (a8), all read after griddep_wait().
// Warp w of CTA i owns rows (4i + w) * RW .. + RW - 1.
template <int BITS, bool A8, int MT, int RW>
__global__ void __launch_bounds__(kThreads)
qmm_p(const uint8_t* __restrict__ data, const __nv_bfloat16* __restrict__ sc,
      const __nv_bfloat16* __restrict__ bs, const int8_t* __restrict__ xq,
      const __nv_bfloat16* __restrict__ xa, const float* __restrict__ xg,
      const float* __restrict__ sx, __nv_bfloat16* __restrict__ y, int M,
      int N, int K, int gs) {
  constexpr int NC = BITS == 4 ? 32 : 16;   // codes a chunk
  // chunk positions a lane loads a batch: with int8 x, 8 chunks of 16
  // bytes in flight up to 4 rows of x, 4 past them (their accumulators
  // take the registers); 16 at one row measured slower (fewer warps an
  // SM). With bf16 x each chunk's unpacked codes take the registers: 2
  // chunks at one row of x and one row a warp, else 1 (8 chunks measured
  // slower at every one-row shape)
  constexpr int U =
      A8 ? (MT <= 4 ? 8 : 4) / RW : MT == 1 && RW == 1 ? 2 : 1;
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * RW;
  if (n0 >= N) return;
  const int G = K / gs, chunks = K / NC;
  const uint4* wrow[RW];
  const __nv_bfloat16 *srow[RW], *brow[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {            // rows past N repeat row N - 1
    const int n = min(n0 + r, N - 1);
    wrow[r] = reinterpret_cast<const uint4*>(data + (size_t)n * (K / 8 * BITS));
    srow[r] = sc + (size_t)n * G;
    brow[r] = bs + (size_t)n * G;
  }
  float acc_p[MT][RW], acc_b[MT][RW];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int r = 0; r < RW; ++r) acc_p[m][r] = acc_b[m][r] = 0.f;
  for (int base = 0; base < chunks; base += 32 * U) {
    uint4 w[U][RW];
    float s[U][RW], b[U][RW];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = base + lane + 32 * u;
      if (c < chunks) {
        const int k0 = c * NC, g = k0 / gs;
        const bool first = k0 % gs == 0;     // the lane that adds the bias
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          w[u][r] = __ldg(wrow[r] + c);
          s[u][r] = __bfloat162float(srow[r][g]);
          b[u][r] = first ? __bfloat162float(brow[r][g]) : 0.f;
        }
      }
    }
    if (base == 0) griddep_wait();          // x's codes and sums are ready
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = base + lane + 32 * u;
      if (c >= chunks) continue;
      const int k0 = c * NC, g = k0 / gs;
      const bool first = k0 % gs == 0;
      if constexpr (A8) {                   // x's codes read once a row
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m >= M) continue;
          const float xgv = first ? xg[(size_t)m * G + g] : 0.f;
          const int4* xv =
              reinterpret_cast<const int4*>(xq + (size_t)m * K + k0);
          const int4 xa4 = xv[0];
          const int4 xb4 = BITS == 4 ? xv[1] : xa4;
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            int ip;
            if constexpr (BITS == 4) {
              ip = dot8(w[u][r].x, xa4.x, xa4.y, 0);
              ip = dot8(w[u][r].y, xa4.z, xa4.w, ip);
              ip = dot8(w[u][r].z, xb4.x, xb4.y, ip);
              ip = dot8(w[u][r].w, xb4.z, xb4.w, ip);
            } else {
              ip = __dp4a((int)w[u][r].x, xa4.x, 0);
              ip = __dp4a((int)w[u][r].y, xa4.y, ip);
              ip = __dp4a((int)w[u][r].z, xa4.z, ip);
              ip = __dp4a((int)w[u][r].w, xa4.w, ip);
            }
            acc_p[m][r] = fmaf(s[u][r], (float)ip, acc_p[m][r]);
            if (first) acc_b[m][r] = fmaf(b[u][r], xgv, acc_b[m][r]);
          }
        }
      } else {                              // codes unpacked once a row
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          float cw[NC];
          unpack_chunk<BITS>(w[u][r], cw);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if (m >= M) continue;
            const float p = dot_bf16<NC>(cw, xa + (size_t)m * K + k0, 0.f);
            acc_p[m][r] = fmaf(s[u][r], p, acc_p[m][r]);
            if (first)
              acc_b[m][r] = fmaf(b[u][r], xg[(size_t)m * G + g], acc_b[m][r]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const float p = warp_sum(acc_p[m][r]), b = warp_sum(acc_b[m][r]);
      if (lane == 0 && m < M && n0 + r < N)
        y[(size_t)m * N + n0 + r] =
            __float2bfloat16(fmaf(A8 ? sx[m] : 1.f, p, b));
    }
  }
}

struct PArgs {
  const uint8_t* d;
  const __nv_bfloat16 *sc, *bs;
  const int8_t* xq;
  const __nv_bfloat16* xa;
  const float *xg, *sx;
  __nv_bfloat16* y;
  int M, N, K, gs;
};

// The rows kernel behind the prologue, by programmatic dependent launch.
template <int BITS, bool A8, int MT, int RW>
int launch_p(const PArgs& a, cudaStream_t st) {
  const int warps = (a.N + RW - 1) / RW;
  return (int)launch_kernel(qmm_p<BITS, A8, MT, RW>,
                            dim3((warps + kWarps - 1) / kWarps),
                            dim3(kThreads), 0, true, st, a.d, a.sc, a.bs,
                            a.xq, a.xa, a.xg, a.sx, a.y, a.M, a.N, a.K, a.gs);
}

template <int BITS, bool A8, int MT>
int launch_p_rw(int rw, const PArgs& a, cudaStream_t st) {
  if (rw == 1) return launch_p<BITS, A8, MT, 1>(a, st);
  if (rw == 2) return launch_p<BITS, A8, MT, 2>(a, st);
  if constexpr (MT <= 4)
    if (rw == 4) return launch_p<BITS, A8, MT, 4>(a, st);
  return (int)cudaErrorInvalidValue;
}

template <int BITS, bool A8>
int launch_p_rows(int rw, const PArgs& a, cudaStream_t st) {
  if (a.M == 1) return launch_p_rw<BITS, A8, 1>(rw, a, st);
  if constexpr (BITS == 4 && !A8) {       // w4a16 is K1's, at one row only
    return (int)cudaErrorInvalidValue;
  } else {
    if (a.M <= 2) return launch_p_rw<BITS, A8, 2>(rw, a, st);
    if (a.M <= 4) return launch_p_rw<BITS, A8, 4>(rw, a, st);
    if (a.M <= 8) return launch_p_rw<BITS, A8, 8>(rw, a, st);
    return launch_p_rw<BITS, A8, 16>(rw, a, st);
  }
}

}  // namespace

extern "C" {

const char* ominix_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The P formula (K1 at M = 1, K6 at M <= 16) on `stream`: the prologue
// (norm when norm_w is given, group sums, a8 quantisation), then the rows
// kernel behind it by programmatic dependent launch, rows_per_warp (1, 2,
// or 4 up to 4 rows of x) output rows a warp. Scratch xg [M, G] f32
// always, xq [M, K] int8 and sx [M] f32 for a8, xn [M, K] bf16 for a16
// with a norm, all allocated by the caller. Returns the first CUDA error.
int ominix_qmm_p(const void* x, const void* norm_w, float eps,
                 const void* data, const void* scales, const void* biases,
                 void* y, void* xq, void* xg, void* sx, void* xn, int M,
                 int N, int K, int gs, int bits, int a8, int rows_per_warp,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || M > 16 || (bits != 4 && bits != 8))
    return (int)cudaErrorInvalidValue;
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* nw = (const __nv_bfloat16*)norm_w;
  const bool norm_out = !a8 && nw != nullptr;
  const cudaError_t e = launch_prep_pdl(
      xb, nw, eps, M, K, gs, a8 ? (int8_t*)xq : nullptr, (float*)xg,
      a8 ? (float*)sx : nullptr, norm_out ? (__nv_bfloat16*)xn : nullptr, st);
  if (e != cudaSuccess) return (int)e;
  const PArgs a{(const uint8_t*)data, (const __nv_bfloat16*)scales,
                (const __nv_bfloat16*)biases, (const int8_t*)xq,
                norm_out ? (const __nv_bfloat16*)xn : xb, (const float*)xg,
                (const float*)sx, (__nv_bfloat16*)y, M, N, K, gs};
  if (bits == 4 && a8) return launch_p_rows<4, true>(rows_per_warp, a, st);
  if (bits == 4) return launch_p_rows<4, false>(rows_per_warp, a, st);
  if (a8) return launch_p_rows<8, true>(rows_per_warp, a, st);
  return launch_p_rows<8, false>(rows_per_warp, a, st);
}

}  // extern "C"
