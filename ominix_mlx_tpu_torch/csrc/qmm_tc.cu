// The dq formula on the tensor cores: y[M, N] = x[M, K] @ W^T for
// 1 <= M <= 64 rows of bf16 x, W group-affine 4- or 8-bit in the port's
// packed layout (ops/quant_matmul.py prepare: 4-bit data uint8 [N, K/2],
// natural nibble order, unsigned u = q + 8, biases b' = b - 8s; 8-bit data
// int8 [N, K], biases b; bf16 scales and biases [N, G]).
//
// Replaces two TPU kernels of ominix_mlx_tpu/ops/quant_matmul.py that
// compute one formula: _dq_kernel (A3, :1062, called by _qmm_dq :1141; 2 to
// 16 rows, 4 and 8 bits, panels or batched weights; the routes "k1_mn" and
// "k1_mn_w8") and _vpu_kernel (A5, :1229, called by _qmm_vpu :1253; up to
// 64 rows of row-major 4-bit weights; the route "k7"). The formula, with
// their rounding (:1110-1135, :1229-1250; the plain version is
// qmm_dq_reference):
//   y = sum_k bf16(d_k * s_g) * x_k + sum_g bf16(xg_g) * bh_g in f32,
// d = u - 8 or q the centred code, one rounding of the exact product;
// xg the f32 group sums of x; bh = bf16(b' + 8s) (4-bit) or b (8-bit).
//
// What bounds it on an H100: bytes. At M <= 64 a weight byte feeds at most
// 256 multiply-adds, under the card's ~295 FLOP/byte ridge, so the kernel
// should stream the codes once at 3.35 TB/s. The design:
// - A and B swapped: 64 output rows take the M side of wgmma m64nMPk16
//   and the MP = 8, 16, 32 or 64 rows of x (zero-padded) the narrow side.
//   A comes from registers: each lane dequantizes its codes straight into
//   the A fragment (4-bit: 0x4300 | u is bf16(128 + u), fma.rn.bf16x2 with
//   1 and -136 gives u - 8 exactly, then fma.rn.bf16x2 with the scale and
//   a -0.0 addend rounds d * s once, a zero product keeping its sign;
//   8-bit: the code under an f32 bit pattern and one exact FFMA, then one
//   bf16 rounding). No bf16 weight tile touches shared memory.
// - K is permuted inside each 128-wide step so that a lane's A fragment
//   for the step's eight k16 slices is one 16-byte chunk (4-bit) or two
//   (8-bit) of its own weight row, lane t of a quad owning codes
//   32t..32t+31, and so that one byte permute builds each A register
//   (dq_word4 / dq_word8 give the map). x is written into shared memory in
//   the same permuted order (K-major, 128-byte swizzle, the B operand of
//   wgmma), so the sum is unchanged.
// - x is staged once per CTA: the CTA's K slice of all M rows, read from
//   global memory once, permuted into shared memory; the same pass sums
//   each 32-column piece in f32, from which the CTA forms the bf16 group
//   sums of its slice. The bias term runs on the tensor cores as extra
//   k16 slices: bh [64 x groups] from registers against bf16(xg) in shared
//   memory. There is no separate prologue launch.
// - The packed codes and the 4-byte words that hold their scales stream
//   through a ring in shared memory with cp.async (16 bytes a thread for
//   codes, zero-filled past N and K): 4 stages of 128 columns where x has
//   at most 16 rows, 8 where it has more (its CTAs hold fewer warpgroups),
//   so 3 or 7 stages are in flight while one is dequantized and multiplied.
//   Each thread reads back only what it copied itself, so
//   cp.async.wait_group with the stage count orders load and use; no
//   barrier sits in the loop. Two sets of A registers let one stage be
//   dequantized while the last stage's wgmma run.
// - A CTA holds 1 to 4 warpgroups, each on its own 64-row tiles (one or
//   several in turn), all sharing the staged x. Where the row tiles alone
//   cannot fill the card, K is split into slices of whole groups and whole
//   128-column steps (ops/quant_matmul.py dq_plan chooses the slice, the
//   warpgroups a CTA, the tiles a warpgroup and the split); each slice
//   writes f32 partials and a second kernel sums them in slice order. No
//   float atomics: two launches on the same inputs are bit-equal, so greedy
//   decode stays deterministic.

#include "qmm_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kTileN = 64;      // output rows per warpgroup
constexpr int kStepK = 128;     // columns per pipeline stage
constexpr int kMaxWG = 4;       // warpgroups per CTA, 2 where MP > 16
constexpr int kSmemMax = 232448;

// The ring of a thread: kStages stages of kChunks 16-byte chunks of codes
// and two scale words. A CTA of few warpgroups (MP > 16, where x fills
// shared memory) keeps more stages in flight.
template <int BITS, int MP>
struct Ring {
  static constexpr int kStages = MP <= 16 ? 4 : 8;
  static constexpr int kChunks = BITS == 4 ? 2 : 4;
  static constexpr int kBytes = kStages * (kChunks * 16 + 8);
};

// 128-byte swizzle of an offset inside 1024-byte aligned 8-row groups
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & 7) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b,
                                               uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

constexpr uint32_t kOnes = 0x3F803F80u;     // bf16x2 (1, 1)
constexpr uint32_t kM136 = 0xC308C308u;     // bf16x2 (-136, -136)
constexpr uint32_t kNegZero = 0x80008000u;  // bf16x2 (-0, -0)

// A lane's 32 codes of a 128-column step, c = 8w + 2b + h (w its 4-bit
// word, b the byte, h the nibble; the same numbering at 8 bits), sit at
// MMA column 16 (2w + h) + 8 (b >> 1) + 2t + (b & 1) of the step, so each
// A register holds the pair (c, c + 2): one PRMT builds it. dq_word writes
// the four A registers that word w feeds, for one weight row: out[0] and
// out[1] (columns 2t.. and 2t + 8.. of k16 slice 2w), out[2] and out[3]
// (the same of slice 2w + 1).

// 4-bit: 0x4300 | u is bf16(128 + u); fma with 1 and -136 gives u - 8
// exactly, fma with the scale and -0.0 rounds (u - 8) * s once, a zero
// product keeping its sign
__device__ __forceinline__ void dq_word4(uint32_t w, uint32_t s2,
                                         uint32_t (&out)[4]) {
  const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
  const uint32_t v[4] = {__byte_perm(lo, 0x43434343u, 0x4140),
                         __byte_perm(lo, 0x43434343u, 0x4342),
                         __byte_perm(hi, 0x43434343u, 0x4140),
                         __byte_perm(hi, 0x43434343u, 0x4342)};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = fma_bf16x2(fma_bf16x2(v[i], kOnes, kM136), s2, kNegZero);
}

// 8-bit: words e0 (codes 8w..8w+3) and e1 (8w+4..8w+7) of the row. A
// code as v = q + 128 in bits 8..15 under the f32 pattern 0x47000000 is
// 2^15 + v; with c = -(2^15 + 128) s, exact in f32 (257 times an 8-bit
// mantissa), one FFMA gives q * s exactly (at most 16 significant bits),
// and the bf16 pack rounds it once
__device__ __forceinline__ void dq_word8(uint32_t e0, uint32_t e1, float s,
                                         uint32_t (&out)[4]) {
  const uint32_t x0 = e0 ^ 0x80808080u, x1 = e1 ^ 0x80808080u;
  const float c = -32896.f * s;
  auto qs = [&](uint32_t x, int byte) {
    return fmaf(__uint_as_float(__byte_perm(x, 0x47000000u,
                                            0x7404 | (byte << 4))),
                s, c);
  };
  out[0] = pack_bf16(qs(x0, 0), qs(x0, 2));
  out[1] = pack_bf16(qs(x1, 0), qs(x1, 2));
  out[2] = pack_bf16(qs(x0, 1), qs(x0, 3));
  out[3] = pack_bf16(qs(x1, 1), qs(x1, 3));
}

// Shared-memory bytes of a CTA (before the 1024-byte alignment slack):
// the x slice (2 swizzled boxes [MP][64] per stage), the bias operand
// (bf16(xg), boxes of 64 groups), the 32-column sums, the ring.
template <int BITS, int MP>
int smem_bytes(int nwg, int ks, int gs) {
  const int nst = (ks + kStepK - 1) / kStepK;
  const int nbb = (ks / gs + 63) / 64;
  return nst * MP * 256 + nbb * MP * 128 + MP * nst * 16 +
         Ring<BITS, MP>::kBytes * 128 * nwg;
}

// grid (ceil(N / (64 * warpgroups * tpw)), splits), block 128 *
// warpgroups. Warpgroup w of CTA c takes the 64-row tiles
// c * warpgroups * tpw + i * warpgroups + w, i < tpw; slice blockIdx.y
// covers columns [y * ks, min(K, (y + 1) * ks)). With part != nullptr it
// writes f32 partials part[y][M][N], else bf16 y.
template <int BITS, int MP>
__global__ void __launch_bounds__(MP <= 16 ? 128 * kMaxWG : 256)
qmm_dq_tc(const __nv_bfloat16* __restrict__ x,
          const uint8_t* __restrict__ data,
          const __nv_bfloat16* __restrict__ sc,
          const __nv_bfloat16* __restrict__ bs,
          __nv_bfloat16* __restrict__ y, float* __restrict__ part, int M,
          int N, int K, int gs, int ks, int tpw) {
  constexpr int ST = Ring<BITS, MP>::kStages, CH = Ring<BITS, MP>::kChunks;
  extern __shared__ uint8_t smem_raw[];
  const int NT = blockDim.x, tid = threadIdx.x;
  const int G = K / gs;
  const int kb = blockIdx.y * ks, kend = min(K, kb + ks);
  const int nst = (ks + kStepK - 1) / kStepK;          // layout stages
  const int nstc = (kend - kb + kStepK - 1) / kStepK;  // this slice's
  const int nbb = (ks / gs + 63) / 64;
  const int g0 = kb / gs, ng = (kend - kb) / gs;
  uint8_t* xs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* xgs = xs + nst * MP * 256;
  float* s32 = reinterpret_cast<float*>(xgs + nbb * MP * 128);
  uint8_t* ring = reinterpret_cast<uint8_t*>(s32 + MP * nst * 4);
  const uint32_t ring_u = smem_u32(ring);
  const uint32_t sring_u = ring_u + ST * CH * NT * 16;

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int tq = lane & 3, nwg = NT >> 7;
  const int tile0 = blockIdx.x * nwg * tpw + wg;       // + i * nwg
  // tiles of this warpgroup that hold rows
  const int ntw = min(tpw, max(0, ((N + kTileN - 1) / kTileN - tile0 +
                                   nwg - 1) / nwg));
  const int row_in_tile = warp * 16 + (lane >> 2);     // rows r, r + 8
  const int k0 = kb + 32 * tq;                         // this lane's column
  const int q128 = kStepK / gs, r128 = kStepK % gs;

  // this thread's weight rows in tile i (row 0 stands in past N, its
  // copies zero-filled); offsets in elements of data and of the scales
  // (the wrapper holds N * K and N * G under 2^31)
  struct Rows {
    uint32_t d[2], s[2];
    bool ok[2];
  };
  auto rows_of = [&](int i) {
    Rows r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = (tile0 + i * nwg) * kTileN + row_in_tile + 8 * h;
      r.ok[h] = row < N;
      const uint32_t rowc = r.ok[h] ? (uint32_t)row : 0u;
      r.d[h] = rowc * (uint32_t)(K / 8 * BITS);
      r.s[h] = rowc * (uint32_t)G;
    }
    return r;
  };

  // The producer side of the ring walks (tile, stage) in order: stage j of
  // tile i goes to slot f % ST, f = i * nstc + j. Its group is kept as
  // quotient and remainder so the loop divides by nothing.
  Rows pr = rows_of(0);
  int pi = 0, pj = 0, gi = k0 / gs, ri = k0 % gs;
  uint32_t par = 0;       // bit 2 * slot + h: which half of the scale word
  auto issue = [&](int f) {
    if (pi < ntw) {
      const int slot = f % ST;
      const int k = k0 + pj * kStepK;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = k < kend && pr.ok[h];
        const uint8_t* src = data + (ok ? pr.d[h] + k / 8 * BITS : 0u);
#pragma unroll
        for (int c = 0; c < CH / 2; ++c)
          cp_async16(ring_u + ((slot * CH + h * (CH / 2) + c) * NT + tid) * 16,
                     src + 16 * c, ok);
        const uint32_t e = ok ? pr.s[h] + gi : 0u;
        cp_async4(sring_u + ((slot * 2 + h) * NT + tid) * 4, sc + (e & ~1u),
                  ok);
        const uint32_t bit = 1u << (2 * slot + h);
        par = (e & 1) ? par | bit : par & ~bit;
      }
      gi += q128;
      ri += r128;
      if (ri >= gs) {
        ri -= gs;
        ++gi;
      }
      if (++pj == nstc) {
        pj = 0;
        gi = k0 / gs;
        ri = k0 % gs;
        if (++pi < ntw) pr = rows_of(pi);
      }
    }
    cp_async_commit();
  };

  // the bias term's A fragments of tile i, 16 groups a k16 slice, 4
  // slices from slice b0 on
  const int nbs = (ng + 15) / 16;
  auto bias_frags = [&](const Rows& r, int b0, unsigned (&ab)[4][4]) {
    // slices past nbs are not multiplied; a pair of groups is one 4-byte
    // load where it is aligned and inside the slice
    const unsigned short* bsu = reinterpret_cast<const unsigned short*>(bs);
    const unsigned short* scu = reinterpret_cast<const unsigned short*>(sc);
    auto pair = [&](const unsigned short* base, uint32_t o, bool whole) {
      if (whole && (o & 1) == 0)
        return __ldg(reinterpret_cast<const uint32_t*>(base + o));
      return (uint32_t)__ldg(base + o) |
             ((uint32_t)__ldg(base + o + (whole ? 1 : 0)) << 16);
    };
#pragma unroll
    for (int bb = 0; bb < 4; ++bb) {
      if (b0 + bb >= nbs) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gl = 16 * (b0 + bb) + 2 * tq + 8 * (e >> 1);
        const uint32_t o = r.s[e & 1] + g0 + min(gl, ng - 1);
        const bool whole = gl + 1 < ng;
        const uint32_t bw = pair(bsu, o, whole);
        const uint32_t sw = BITS == 4 ? pair(scu, o, whole) : 0u;
        float bv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v = __uint_as_float((bw >> (16 * i)) << 16);
          if constexpr (BITS == 4)
            v = bf16r(v + 8.f * __uint_as_float((sw >> (16 * i)) << 16));
          bv[i] = r.ok[e & 1] && gl + i < ng ? v : 0.f;
        }
        ab[bb][e] = pack_bf16(bv[0], bv[1]);
      }
    }
  };

  // x: the slice's M rows, 8 columns a thread and 8 loads in flight,
  // permuted into the swizzled B boxes; each 32-column piece summed in f32
  // (4 lanes). Item it = m * cpr + c8 is walked without division.
  constexpr int XU = 8;
  const int cpr = nst * 16, xn = MP * cpr;
  const int dm = NT / cpr, dc = NT % cpr;
  int xm = tid / cpr, xc = tid % cpr;   // item tid + it0 + u * NT
  uint4 v[XU];
  auto load_x = [&](int it0) {
    int m = xm, c = xc;
#pragma unroll
    for (int u = 0; u < XU; ++u) {
      const int e0 = kb + 8 * c;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (it0 + u * NT + tid < xn && m < M && e0 < kend)
        v[u] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * K + e0));
      m += dm;
      c += dc;
      if (c >= cpr) {
        c -= cpr;
        ++m;
      }
    }
  };
  load_x(0);
  unsigned ab[4][4];
  bias_frags(pr, 0, ab);   // its loads fly with the first x batch's
#pragma unroll
  for (int f = 0; f < ST - 1; ++f) issue(f);
  for (int it0 = 0; it0 < xn; it0 += XU * NT) {
    if (it0 > 0) load_x(it0);
#pragma unroll
    for (int u = 0; u < XU; ++u) {
      if (it0 + u * NT + tid < xn) {     // warp-uniform: xn % 32 == 0
        const int m = xm, c8 = xc;
        const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fl = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
          sum += fl.x;
          sum += fl.y;
        }
        // columns 8c8 .. 8c8 + 7 are codes c = 8w' .. 8w' + 7 of lane t of
        // their step; the pairs (c, c + 2) go to MMA columns 32w' + 2t
        // + {0, 8, 16, 24}
        const int cc = c8 & 15, t = cc >> 2, kk = 32 * (cc & 3) + 2 * t;
        const uint32_t pw[4] = {__byte_perm(w[0], w[1], 0x5410),
                                __byte_perm(w[2], w[3], 0x5410),
                                __byte_perm(w[0], w[1], 0x7632),
                                __byte_perm(w[2], w[3], 0x7632)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = kk + 8 * e;
          const int box = 2 * (c8 >> 4) + (col >> 6);
          *reinterpret_cast<uint32_t*>(
              xs + swz(box * MP * 128 + m * 128 + (col & 63) * 2)) = pw[e];
        }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        if ((c8 & 3) == 0) s32[m * nst * 4 + (c8 >> 2)] = sum;
      }
      xm += dm;
      xc += dc;
      if (xc >= cpr) {
        xc -= cpr;
        ++xm;
      }
    }
  }
  __syncthreads();
  // the bias operand: bf16 group sums of the slice, zero past M and ng
  for (int m0 = 0; m0 < MP; m0 += 4)
    for (int gl = tid; gl < nbb * 64; gl += NT) {
#pragma unroll
      for (int m = m0; m < m0 + 4; ++m) {
        float bsum = 0.f;
        if (m < M && gl < ng)
          for (int p = 0; p < gs / 32; ++p)
            bsum += s32[m * nst * 4 + gl * (gs / 32) + p];
        *reinterpret_cast<__nv_bfloat16*>(
            xgs + swz((gl >> 6) * MP * 128 + m * 128 + (gl & 63) * 2)) =
            __float2bfloat16(bsum);
      }
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const uint32_t xs_u = smem_u32(xs), xgs_u = smem_u32(xgs);
  int f = 0;                         // the consumer's (tile, stage) index
  for (int i = 0; i < ntw; ++i) {
    const Rows cr = rows_of(i);
    float acc[MP / 2];
#pragma unroll
    for (int q = 0; q < MP / 2; ++q) acc[q] = 0.f;
    for (int b0 = 0; b0 < nbs; b0 += 4) {
      if (i > 0 || b0 > 0) bias_frags(cr, b0, ab);
      keep(acc);
      keep(ab);
      wgmma_fence();
#pragma unroll
      for (int bb = 0; bb < 4; ++bb)
        if (b0 + bb < nbs)
          wgmma_rs_k<MP>(acc, ab[bb],
                         gmma_desc(xgs_u + ((b0 + bb) >> 2) * MP * 128 +
                                       ((b0 + bb) & 3) * 32,
                                   16));
      wgmma_commit();
      wgmma_wait<0>();
      keep(acc);
      keep(ab);
    }

    // stage j: its codes from the ring dequantized into a, its 8 wgmma
    // issued and committed, not waited for
    auto stage = [&](int j, unsigned (&a)[8][4]) {
      cp_async_wait<ST - 2>();
      const int slot = f % ST;
      uint4 c[CH];
      uint32_t sw[2];
#pragma unroll
      for (int q = 0; q < CH; ++q)
        c[q] = *reinterpret_cast<const uint4*>(
            ring + ((slot * CH + q) * NT + tid) * 16);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sw[h] = *reinterpret_cast<const uint32_t*>(
            ring + (sring_u - ring_u) + ((slot * 2 + h) * NT + tid) * 4);
      uint32_t s2[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t sv =
            (sw[h] >> (16 * ((par >> (2 * slot + h)) & 1))) & 0xFFFFu;
        s2[h] = sv | (sv << 16);
      }
      issue(f + ST - 1);
      ++f;
      const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&c[0]);
      const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&c[CH / 2]);
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
        uint32_t o0[4], o1[4];
        if constexpr (BITS == 4) {
          dq_word4(w0[wd], s2[0], o0);
          dq_word4(w1[wd], s2[1], o1);
        } else {
          dq_word8(w0[2 * wd], w0[2 * wd + 1], __uint_as_float(s2[0] << 16),
                   o0);
          dq_word8(w1[2 * wd], w1[2 * wd + 1], __uint_as_float(s2[1] << 16),
                   o1);
        }
        // rows r / r + 8 are registers 0 / 1 (columns 2t..) and 2 / 3
        // (columns 2t + 8..) of the A fragment
        a[2 * wd][0] = o0[0];
        a[2 * wd][1] = o1[0];
        a[2 * wd][2] = o0[1];
        a[2 * wd][3] = o1[1];
        a[2 * wd + 1][0] = o0[2];
        a[2 * wd + 1][1] = o1[2];
        a[2 * wd + 1][2] = o0[3];
        a[2 * wd + 1][3] = o1[3];
      }
      keep(acc);
      keep(a);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 8; ++s)
        wgmma_rs_k<MP>(acc, a[s],
                       gmma_desc(xs_u + (2 * j + (s >> 2)) * MP * 128 +
                                     (s & 3) * 32,
                                 16));
      wgmma_commit();
    };
    // two A buffers: stage j + 1 is dequantized while stage j multiplies;
    // a buffer is pinned until the wait that retires its wgmma
    unsigned ae[8][4], ao[8][4];
    for (int j = 0; j < nstc; j += 2) {
      stage(j, ae);
      wgmma_wait<1>();
      keep(ao);
      if (j + 1 < nstc) {
        stage(j + 1, ao);
        wgmma_wait<1>();
        keep(ae);
      }
    }
    wgmma_wait<0>();
    keep(acc);
    keep(ae);
    keep(ao);

    // accumulator q: output row r + 8 * ((q >> 1) & 1), x row
    // (q >> 2) * 8 + 2 * tq + (q & 1)
    const int r0 = (tile0 + i * nwg) * kTileN + row_in_tile;
#pragma unroll
    for (int q = 0; q < MP / 2; ++q) {
      const int n = r0 + 8 * ((q >> 1) & 1);
      const int m = (q >> 2) * 8 + 2 * tq + (q & 1);
      if (n < N && m < M) {
        if (part != nullptr)
          part[((size_t)blockIdx.y * M + m) * N + n] = acc[q];
        else
          y[(size_t)m * N + n] = __float2bfloat16(acc[q]);
      }
    }
  }
  cp_async_wait<0>();
}

// y = bf16(sum_s part[s]) over the splits in order
__global__ void __launch_bounds__(256)
qmm_dq_reduce(const float* __restrict__ part, __nv_bfloat16* __restrict__ y,
              int MN, int splits) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < MN;
       i += gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < splits; ++s) v += part[(size_t)s * MN + i];
    y[i] = __float2bfloat16(v);
  }
}

template <int BITS, int MP>
int launch(const __nv_bfloat16* x, const uint8_t* d, const __nv_bfloat16* sc,
           const __nv_bfloat16* bs, __nv_bfloat16* y, float* part, int M,
           int N, int K, int gs, int nwg, int tpw, int splits, int ks,
           cudaStream_t st) {
  static int smem_set = 0;     // the largest dynamic size granted so far
  const int smem = 1024 + smem_bytes<BITS, MP>(nwg, ks, gs);
  if (smem > kSmemMax || (MP > 16 && nwg > 2)) return (int)cudaErrorInvalidValue;
  auto kern = qmm_dq_tc<BITS, MP>;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const int rows = kTileN * nwg * tpw;
  kern<<<dim3((N + rows - 1) / rows, splits), 128 * nwg, smem, st>>>(
      x, d, sc, bs, y, splits > 1 ? part : nullptr, M, N, K, gs, ks, tpw);
  if (splits > 1) {
    const int MN = M * N;
    qmm_dq_reduce<<<min((MN + 255) / 256, 1024), 256, 0, st>>>(part, y, MN,
                                                               splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The dq formula (K1 at 2 <= M <= 16, K7 up to 64 rows) on `stream`, by
// the plan of ops/quant_matmul.py dq_plan: MP rows of x padded (8, 16, 32
// or 64, M <= MP), `nwg` warpgroups a CTA, `tpw` 64-row tiles a
// warpgroup, `splits` slices of `ks` columns
// (a multiple of 128 and of gs; the last may be shorter). part: f32
// scratch [splits, M, N] from the caller where splits > 1. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape or plan the
// kernel does not take.
int ominix_qmm_dq_tc(const void* x, const void* data, const void* scales,
                     const void* biases, void* y, void* part, int M, int N,
                     int K, int gs, int bits, int mp, int nwg, int tpw,
                     int splits, int ks, void* stream) {
  if ((bits != 4 && bits != 8) || M < 1 || M > mp || N < 1 || K < 32 ||
      K % 32 || gs < 32 || gs % 32 || K % gs || nwg < 1 || nwg > kMaxWG ||
      tpw < 1 ||
      splits < 1 || ks < kStepK || ks % kStepK || ks % gs ||
      (long long)splits * ks < K || (long long)(splits - 1) * ks >= K ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const auto* xb = (const __nv_bfloat16*)x;
  const auto* d = (const uint8_t*)data;
  const auto* sc = (const __nv_bfloat16*)scales;
  const auto* bs = (const __nv_bfloat16*)biases;
  auto* yb = (__nv_bfloat16*)y;
  auto* pt = (float*)part;
#define OMINIX_DQ(B, P)                                                     \
  if (bits == B && mp == P)                                                 \
    return launch<B, P>(xb, d, sc, bs, yb, pt, M, N, K, gs, nwg, tpw, \
                        splits, ks, st);
  OMINIX_DQ(4, 8) OMINIX_DQ(4, 16) OMINIX_DQ(4, 32) OMINIX_DQ(4, 64)
  OMINIX_DQ(8, 8) OMINIX_DQ(8, 16) OMINIX_DQ(8, 32) OMINIX_DQ(8, 64)
#undef OMINIX_DQ
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
