// K2: causal flash-attention forward over a fresh prompt, with native GQA.
// K2c: the same kernel for a continuation chunk of a long prefill.
//
// K2 replaces the TPU flash kernel behind ominix_mlx_tpu/ops/flash_attention.py
// (_flash -> jax.experimental.pallas.ops.tpu.flash_attention, reached from
// flash_prefill). K2c replaces _flash_chunk (ops/flash_attention.py:117),
// which on the TPU makes two library flash calls (an unmasked prefix and a
// causal chunk) and merges them by LSE, because the library's causal flag
// is top-left aligned. Here one kernel shifts the causal diagonal instead.
//
// One kernel serves both: Tq queries at absolute positions pos..pos+Tq-1
// attend keys 0..pos+t (Tk = pos + Tq keys). K2 is the case pos = 0. With a
// sliding window w > 0 (Mistral's), query position p attends only keys
// p - w < k <= p: the masked sdpa that the JAX package computes with
// causal_mask(..., window) (ominix_mlx_tpu/core/attention.py:25-45). q
// [B, H, Tq, D] bf16 contiguous; k/v bf16 with unit stride along D and
// batch, head and sequence strides that are multiples of 16 bytes on a
// 16-byte aligned base (what TMA takes), so a chunk reads the [:pos+Tq]
// prefix of a capacity-sized cache in place; out [B, H, Tq, D] bf16 and
// lse [B, H, Tq] f32 (natural log of the softmax denominator of the scaled
// scores). Query head h reads KV head h / (H / Hkv): K/V are never repeated
// in memory. Any Tq >= 1 and pos >= 0 work: the ragged edges are masked in
// the kernel.
//
// Rounding, where the TPU kernel rounds: q is scaled in the kernel to
// bf16(q * scale) (the JAX package hands the library kernel q * scale in
// bf16, the scale rounded to bf16, which the wrapper does); Q.K^T is summed
// in f32; the softmax weights P are rounded to bf16 against the running
// row max before P.V, summed in f32. The row sums l come from the f32
// weights.
//
// What bounds it on an H100: operations at long T (4 * Tq * Tk * D FLOPs
// per head, about half of it masked away for a fresh prompt, against
// O(Tk * D) bytes): 989 TFLOP/s of bf16 on the tensor cores, reachable only
// through wgmma. Latency and launch at short T. The design, per CTA of 128
// query rows of one (b, h) and three warpgroups:
// - a producer warpgroup gives its registers back (setmaxnreg) and one of
//   its threads keeps the tiles in flight with TMA (cp.async.bulk.tensor,
//   4-D maps [D, T, heads, B] built on the host with the view's strides):
//   Q once, then K and V tiles of BK keys (128 at D <= 128, 64 at D = 256)
//   into a 2-stage ring of 128-byte-swizzled boxes of 64 columns, each
//   stage completing on its own mbarrier for K and for V; the consumers free
//   a stage through an "empty" barrier. TMA zero-fills rows past Tq or Tk;
// - two consumer warpgroups of 64 rows each scale their Q rows in place,
//   then per tile: S = Q.K^T with wgmma m64nBKk16 (both operands K-major in
//   shared memory), an online softmax in f32 on the accumulator registers
//   (a row spans a quad of lanes, two shuffles give its max; exp2 with
//   log2 e folded into the scores; only tiles that cross the diagonal or
//   Tk are masked), P rounded to bf16 in registers as wgmma's A operand,
//   and O += P.V with wgmma m64nDk16 reading V transposed (MN-major) from
//   shared memory;
// - a software pipeline in each consumer: Q.K^T of tile t is issued
//   together with P.V of tile t - 1, and the softmax of tile t runs while
//   that P.V does. K and V stages are freed separately (K after its Q.K^T,
//   V after its P.V), so the next K is in flight early;
// - the two consumers take turns to issue their products (named
//   barriers), so one's softmax runs while the other's products do. Both
//   walk every tile of the CTA in lockstep: a tile wholly past one
//   warpgroup's rows (at most one, when pos is not a multiple of BK) is
//   masked rather than skipped;
// - the epilogue writes O / l in bf16 and LSE = m + log(l) from registers.
// Key tiles sit at absolute multiples of BK, so K2c walks a query's keys in
// K2's tiles and order: a chunk's rows equal the single-shot rows bit for
// bit. With a window a CTA starts at the tile that holds the first key its
// first row sees, so the work is O(Tq * w), not O(Tq * Tk); the tiles that
// straddle a warpgroup's lower edge are masked beside the diagonal's, and a
// tile a row sees no key of leaves that row's running max, sum and output
// as they were (a fully masked row takes 0 as its reference max, never
// -inf - -inf). CTAs are issued heaviest first (last query tile first): a
// CTA's tile count does not fall with its first row, with a window or
// without. Later work: a persistent schedule over (head, query tile).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBQ = 128;          // query rows per CTA, 64 per consumer
constexpr int kThreads = 384;     // producer + two consumer warpgroups
constexpr int kStages = 2;        // K/V tiles in flight
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr int BK = D == 256 ? 64 : 128;    // keys per tile
  static constexpr int Q_BYTES = kBQ * D * 2;       // D / 64 boxes [kBQ][64]
  static constexpr int KV_BYTES = BK * D * 2;       // D / 64 boxes [BK][64]
  // 1024 bytes of slack to align the swizzled tiles to 1024
  static constexpr size_t smem = 1024 + Q_BYTES + 2 * kStages * KV_BYTES;
};

// The two consumer warpgroups take turns to issue their products (named
// barriers 3 and 4, all 256 consumer threads): one's softmax runs while
// the other's products do.
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + c) : "memory");
}

__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - c) : "memory");
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B K-major in shared
// memory; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B K-major in shared
// memory; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const unsigned (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const unsigned (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] . B[16 x 256], A in registers, B MN-major
// (transposed) in shared memory
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const unsigned (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const unsigned (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// grid (H, B, ceil(Tq / kBQ)): blockIdx.z counts query tiles from the last
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H,
          int Hkv, int Tq, int pos, int window, float scale) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 4 * kStages];
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = qs + C::Q_BYTES;                 // [kStages] K tiles
  uint8_t* vs = ks + kStages * C::KV_BYTES;      // [kStages] V tiles
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;
  uint64_t* v_empty = k_empty + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // heaviest first
  const int Tk = pos + Tq;
  // key tiles t_first .. t_last: the first holds the first key the CTA's
  // first row sees, the last the CTA's last row's own key
  const int t_first = window > 0 ? max(0, pos + q0 - window + 1) / BK : 0;
  const int n_tiles = (pos + min(Tq, q0 + kBQ) - 1) / BK + 1 - t_first;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 8);       // one arrival per consumer warp
      mbar_init(v_empty + s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {                       // producer: one thread issues TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (t == 0) {
      const int hk = h / (H / Hkv);
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int j = 0; j < D / 64; ++j)
        tma_load(qs + j * kBQ * 128, &tq, q_full, 64 * j, q0, h, b);
      for (int tile = 0; tile < n_tiles; ++tile) {
        const int s = tile % kStages, n = tile / kStages;
        const int k0 = (t_first + tile) * BK;
        if (n > 0) mbar_wait(k_empty + s, (n - 1) & 1);
        mbar_expect_tx(k_full + s, C::KV_BYTES);
        for (int j = 0; j < D / 64; ++j)
          tma_load(ks + s * C::KV_BYTES + j * BK * 128, &tk, k_full + s,
                   64 * j, k0, hk, b);
        if (n > 0) mbar_wait(v_empty + s, (n - 1) & 1);
        mbar_expect_tx(v_full + s, C::KV_BYTES);
        for (int j = 0; j < D / 64; ++j)
          tma_load(vs + s * C::KV_BYTES + j * BK * 128, &tv, v_full + s,
                   64 * j, k0, hk, b);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int c = wg - 1;                // consumer c: rows q0 + 64c ..
  const int warp = t >> 5, lane = t & 31;
  const int rq0 = q0 + 64 * c;         // this warpgroup's first row
  const int r0 = rq0 + warp * 16 + (lane >> 2);   // rows r0, r0 + 8

  // scale this warpgroup's Q rows in place to bf16(q * scale)
  mbar_wait(q_full, 0);
#pragma unroll
  for (int j = 0; j < D / 64; ++j) {
    uint4* p = reinterpret_cast<uint4*>(qs + j * kBQ * 128 + c * 64 * 128);
#pragma unroll
    for (int i = t; i < 64 * 128 / 16; i += 128) {
      uint4 raw = p[i];
      __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p2[e]);
        p2[e] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
      p[i] = raw;
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
  if (c == 1) turn_pass(1);            // warpgroup 0 issues first

  float acc[D / 2], sc[BK / 2];
  unsigned pa[BK / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const uint32_t q_addr = smem_u32(qs) + c * 64 * 128;

  auto issue_qk = [&](int tile) {      // sc = Q . K^T of the tile
    const uint32_t k_addr = smem_u32(ks + (tile % kStages) * C::KV_BYTES);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BK>(sc,
                   gmma_desc(q_addr + (kk / 4) * kBQ * 128 + (kk % 4) * 32, 16),
                   gmma_desc(k_addr + (kk / 4) * BK * 128 + (kk % 4) * 32, 16),
                   kk > 0);
    wgmma_commit();
  };
  auto issue_pv = [&](int tile) {      // acc += bf16(P) . V of the tile
    const uint32_t v_addr = smem_u32(vs + (tile % kStages) * C::KV_BYTES);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      wgmma_rs<D>(acc, pa[j], gmma_desc(v_addr + j * 16 * 128, BK * 128));
    wgmma_commit();
  };
  // the online softmax of the tile's scores, in place in sc; returns the
  // factor of the running output, alpha[r] for rows r0 and r0 + 8
  auto softmax = [&](int tile, float (&alpha)[2]) {
    const int k0 = (t_first + tile) * BK;
    // scores to the log2 domain; mask only tiles that cross the diagonal
    // of the warpgroup's first row, the end of the keys, or the window's
    // lower edge of the warpgroup's last row
    const bool edge = k0 + BK - 1 > pos + rq0 || k0 + BK > Tk ||
                      (window > 0 && k0 + window < pos + rq0 + 64);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = sc[i] * kLog2e;
      if (edge) {
        const int kj = k0 + (i / 4) * 8 + (lane & 3) * 2 + (i & 1);
        const int qi = r0 + ((i >> 1) & 1) * 8;
        if (kj >= Tk || kj > pos + qi ||
            (window > 0 && kj + window <= pos + qi))
          x = -INFINITY;
      }
      sc[i] = x;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
        mx = fmaxf(mx, fmaxf(sc[n * 4 + 2 * r], sc[n * 4 + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row that has seen no key yet (below its window) has m_new =
      // -inf: it takes 0 as its reference, so alpha and p are 0, not NaN.
      // Without a window key 0 is valid for every row and m_new is finite
      // from tile 0 on
      const float m_new = fmaxf(m_run[r], mx);
      const float m_ref = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m_run[r] - m_ref);
      m_run[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(sc[n * 4 + 2 * r + e] - m_ref);
          sc[n * 4 + 2 * r + e] = p;
          sum += p;
        }
      l_run[r] = l_run[r] * alpha[r] + sum;     // this lane's part of the row
    }
  };
  // the softmax weights of keys 16j..16j+15, rounded to bf16, are the A
  // fragment of that k-slice of P.V
  auto pack_p = [&]() {
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[j][e] = pack_bf16(sc[8 * j + 2 * e], sc[8 * j + 2 * e + 1]);
  };

  // Software pipeline: Q.K^T of tile t is issued with P.V of tile t - 1,
  // so the softmax of tile t overlaps that P.V.
  float alpha[2];
  mbar_wait(k_full, 0);
  turn_wait(c);
  wgmma_fence();
  issue_qk(0);
  turn_pass(c);
  wgmma_wait<0>();
  keep(sc);
  if (lane == 0) mbar_arrive(k_empty);
  softmax(0, alpha);
  pack_p();
  for (int tile = 1; tile < n_tiles; ++tile) {
    const int s = tile % kStages, sp = (tile - 1) % kStages;
    mbar_wait(k_full + s, (tile / kStages) & 1);
    mbar_wait(v_full + sp, ((tile - 1) / kStages) & 1);
    turn_wait(c);
    keep(acc);
    wgmma_fence();
    issue_qk(tile);
    issue_pv(tile - 1);
    turn_pass(c);
    wgmma_wait<1>();                   // Q.K^T done, P.V may run on
    keep(sc);
    if (lane == 0) mbar_arrive(k_empty + s);
    softmax(tile, alpha);
    wgmma_wait<0>();
    keep(acc);
    keep(pa);
    if (lane == 0) mbar_arrive(v_empty + sp);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    pack_p();
  }
  {
    const int sp = (n_tiles - 1) % kStages;
    mbar_wait(v_full + sp, ((n_tiles - 1) / kStages) & 1);
    turn_wait(c);
    keep(acc);
    wgmma_fence();
    issue_pv(n_tiles - 1);
    turn_pass(c);
    wgmma_wait<0>();
    keep(acc);
    keep(pa);
    if (lane == 0) mbar_arrive(v_empty + sp);
    if (c == 0) turn_wait(0);          // warpgroup 1's last pass
  }

  if (rq0 >= Tq) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = r0 + r * 8;
    if (qi >= Tq) continue;
    const float inv = 1.f / l;
    __nv_bfloat16* orow = o + (((size_t)b * H + h) * Tq + qi) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + (lane & 3) * 2) =
          __floats2bfloat162_rn(acc[n * 4 + 2 * r] * inv,
                                acc[n * 4 + 2 * r + 1] * inv);
    if ((lane & 3) == 0)
      lse[((size_t)b * H + h) * Tq + qi] = (m_run[r] + log2f(l)) * kLn2;
  }
}

// a 4-D map [D, T, heads, B] of bf16 with the given element strides of T,
// heads and B, 128-byte-swizzled boxes of 64 x rows
bool make_map(CUtensorMap* map, const void* base, int D, int T, int heads,
              int B, long long st, long long sh, long long sb, int rows) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct KVStrides {    // element strides of K and V (D has unit stride)
  long long kb, kh, kt, vb, vh, vt;
};

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Hkv, int Tq, int pos, int window, KVStrides st,
           float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv;
  const long long qt = (long long)Tq * D;
  if (!make_map(&tq, q, D, Tq, H, B, D, qt, H * qt, kBQ) ||
      !make_map(&tk, k, D, pos + Tq, Hkv, B, st.kt, st.kh, st.kb, C::BK) ||
      !make_map(&tv, v, D, pos + Tq, Hkv, B, st.vt, st.vh, st.vb, C::BK))
    return (int)cudaErrorInvalidValue;
  // The limit is per device and costs little to set, so it is set on every
  // launch: a process that switches cards never meets the 48 KB default.
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (Tq + kBQ - 1) / kBQ);
  flash_fwd<D><<<grid, kThreads, C::smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, (float*)lse, H, Hkv, Tq, pos, window,
      scale);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, void* o, void* lse,
             int B, int H, int Hkv, int Tq, int pos, int window, int D,
             KVStrides st, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (window < 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<64>(q, k, v, o, lse, B, H, Hkv, Tq, pos, window, st, scale, s);
    case 128:
      return launch<128>(q, k, v, o, lse, B, H, Hkv, Tq, pos, window, st, scale, s);
    case 256:
      return launch<256>(q, k, v, o, lse, B, H, Hkv, Tq, pos, window, st, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K2: contiguous q/k/v [B, H(kv), T, D], keys 0..t for query t (keys
// t - window + 1..t with a window > 0).
extern "C" int ominix_flash_fwd(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int H, int Hkv,
                                int T, int D, int window, float scale,
                                void* stream) {
  const long long t = (long long)T * D;
  const KVStrides st{Hkv * t, t, D, Hkv * t, t, D};
  return dispatch(q, k, v, o, lse, B, H, Hkv, T, 0, window, D, st, scale,
                  stream);
}

// K2c: Tq chunk queries at pos..pos+Tq-1 over the first pos+Tq keys of
// strided k/v (element strides per batch, head and position), and the
// window as in K2.
extern "C" int ominix_flash_chunk_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int Hkv, int Tq, int pos, int D, long long k_sb, long long k_sh,
    long long k_st, long long v_sb, long long v_sh, long long v_st,
    int window, float scale, void* stream) {
  const KVStrides st{k_sb, k_sh, k_st, v_sb, v_sh, v_st};
  return dispatch(q, k, v, o, lse, B, H, Hkv, Tq, pos, window, D, st, scale,
                  stream);
}
