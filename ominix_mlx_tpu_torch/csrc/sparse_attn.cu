// K11: InfLLMv2's sparse decode attention (MiniCPM-SALA's "minicpm4"
// layers at one query token a row), in two launches:
//
//   sparse_select (counter k11_select): the block scores, float32 sums of
//     the products of the group's scoring query (its first query head) and
//     the mean-pooled keys comp [B, Hkv, nb, D] bf16 (a block outside
//     [init_end, window_start - ks] scores NEG_INF; window_start =
//     max(total - window, init_end)), and their top k, sorted, equal
//     scores by block index. sparse_score (counter k11_score) computes the
//     same scores alone, bit for bit; the decode path no longer launches
//     it.
//   sparse_attend (counter k11_attend; one launch): attention of each (row,
//     KV head) over its init slots, its selected blocks and its window, K
//     and V read in place from the cache [B, Hkv, S, D] bf16 through the
//     indices.
//
// No TPU kernel computes either: the JAX package scores with an einsum on
// a float32 copy of comp, takes lax.top_k, gathers init + top-k blocks +
// window (4160 slots a KV head at the production config) and runs a masked
// sdpa (ominix_mlx_tpu/models/sparse_attention.py:131-197), all XLA.
//
// What bounds them on an H100: bytes. The scores read comp once in bf16
// (8 MiB a layer at a 524288-token cache; the plain version first copies
// it to float32) and only the blocks that can be valid: the rest get
// NEG_INF unread, so a short context in a long cache costs what it holds.
// The selector's top k replaces torch.topk (a radix select and a sort,
// 19-77 us at 4096-524288 tokens on an H100 80GB HBM3 at 700.00 W, PERF.md
// section 6) by a sort of 64-bit keys on chip (see sparse_select); a (row,
// KV head) past 512 blocks pays one ticket and the last CTA's merge of up
// to 32 lists, about 3 us of its 15 at 524288 tokens.
// sparse_attend reads each valid slot's K and V rows once (4160 slots x 2
// KV heads x 512 B at B = 1) and does 4 R FLOPs a byte, R = 16 query heads
// a KV head: far below the card's ratio of operations to bytes, and at B =
// 1 so few bytes (4.3 MB) that a launch and a chain of dependent reads set
// its time. Its design is K3's split-KV flash-decoding (paged_attn.cu) over
// a slot list instead of a page table, in one launch:
//   * the valid slots of a (row, KV head) are numbered densely: the init
//     slots below min(init_end, total), then the selected blocks whose score
//     is finite (in top-k order: a block's rank is the count of finite
//     scores before it, by a ballot over the scores), then the window
//     [window_start, total). A slot that is not valid is never read: the
//     same function as the NEG_INF mask, since slot 0 is always valid. The
//     list is cut into splits of whole 64-slot tiles, at least two a split
//     (ops/sparse_attention k11_plan, from shapes only); a split past the
//     row's count exits at once, so the work follows the valid slots;
//   * a CTA issues every load that needs nothing else at once (the row's
//     total, the top-k scores and ids, the query heads), so its first K/V
//     copy waits on one read of the indices;
//   * one CTA per (split, KV head, row) holds all R <= 16 query heads of
//     its KV head as the A operand of mma.sync m16n8k16 (bf16 in, float32
//     accumulators), so K and V are read once; a CTA-wide ring of three
//     64-slot tiles, rows copied by cp.async through the slot's position
//     (16-byte pieces XOR-swizzled by the row for ldmatrix), each of the 4
//     warps taking 16 slots of a tile with an online softmax per query
//     row; the probabilities are rounded to bf16 for the P.V product, as
//     the plain version rounds its softmax weights;
//   * with more than one split a CTA writes a float32 partial (row max in
//     log2 units, denominator, numerator) and takes a ticket of its group
//     of `group` (8) splits; the CTA that draws a group's last ticket
//     merges the group's partials in split order, then, if the row has
//     more than one group, takes a ticket of the (row, KV head), and the
//     CTA that draws its last merges the groups' partials in group order
//     and writes the output. A fixed tree, never arrival order:
//     bit-repeatable. Each last drawer sets its ticket back to zero. The
//     partials and tickets are buffers the wrapper keeps per device: no
//     allocation, memset or second launch a call, so a CUDA graph can
//     replay it.
// On an H100 80GB HBM3 at 700.00 W (PERF.md section 6) a chain of
// dependent reads sets the time at B = 1, each about 1 us (a timeline of
// the CTAs by %globaltimer): the indices, the K/V tiles, the partial, the
// tickets and the partials read back. One CTA merging all 33-65 partials
// takes 0.2 us a partial; two levels of at most 8 cost less. Splits of two
// tiles, at most two CTAs an SM (a CTA of a second wave delays its row's
// merge by a CTA's time).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;
// core/attention.py NEG_INF: -0.7 * the largest float32
constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;

// ------------------------------------------------------------------ score

constexpr int kScoreWarps = 8;
constexpr int kScoreIters = 4;     // blocks a lane group, unrolled

// The scoring query of KV head g (query head g H / Hkv) of row b: the 8
// values (16 bytes) of lane ls of a lane group, in float32.
template <int D>
__device__ __forceinline__ void load_query(const __nv_bfloat16* q, int b,
                                           int g, int H, int Hkv, int ls,
                                           float (&qf)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(
      q + ((size_t)b * H + (size_t)g * (H / Hkv)) * D + ls * 8);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qf[2 * i] = __uint_as_float(w[i] << 16);
    qf[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// A block's score: the lane's 8 products from zero as one fma chain, then
// a butterfly over the group's LPB lanes (smask); every lane of the group
// gets the same sum. k11_score and k11_select both score with it.
template <int LPB>
__device__ __forceinline__ float group_dot(const float (&qf)[8], uint4 u,
                                           unsigned smask) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(qf[2 * i], __uint_as_float(w[i] << 16), acc);
    acc = fmaf(qf[2 * i + 1], __uint_as_float(w[i] & 0xffff0000u), acc);
  }
#pragma unroll
  for (int off = LPB / 2; off >= 1; off >>= 1)
    acc += __shfl_xor_sync(smask, acc, off);
  return acc;
}

// One CTA per (run of blocks, KV head, row); a group of D / 8 lanes per
// block, 8 elements (16 bytes) a lane.
template <int D>
__global__ void __launch_bounds__(32 * kScoreWarps)
    sparse_score(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ comp,
                 const int* __restrict__ total, float* __restrict__ scores,
                 int H, int Hkv, int nb, int init_end, int window, int ks) {
  constexpr int LPB = D / 8;              // lanes a block
  constexpr int PW = 32 / LPB;            // blocks a warp at once
  constexpr int PER_CTA = kScoreWarps * PW * kScoreIters;
  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / LPB, ls = lane % LPB;
  const unsigned smask = ((1u << LPB) - 1u) << (sub * LPB);
  const int tot = total[b];
  const int ws = max(tot - window, init_end);
  const int lo = (init_end + ks - 1) / ks;      // first block >= init_end
  const int hi = ws / ks;                       // blocks ending <= ws

  float qf[8];
  load_query<D>(q, b, g, H, Hkv, ls, qf);
  const __nv_bfloat16* crow = comp + ((size_t)b * Hkv + g) * nb * D + ls * 8;
  float* srow = scores + ((size_t)b * Hkv + g) * nb;
  const int base = blockIdx.x * PER_CTA + warp * PW + sub;

  uint4 u[kScoreIters];
  bool ok[kScoreIters];
#pragma unroll
  for (int r = 0; r < kScoreIters; ++r) {
    const int n = base + r * kScoreWarps * PW;
    ok[r] = n >= lo && n < hi && n < nb;
    if (ok[r]) u[r] = *reinterpret_cast<const uint4*>(crow + (size_t)n * D);
  }
#pragma unroll
  for (int r = 0; r < kScoreIters; ++r) {
    const int n = base + r * kScoreWarps * PW;
    if (n >= nb) continue;
    // ok is the same for the group's lanes
    const float s = ok[r] ? group_dot<LPB>(qf, u[r], smask) : kNegInf;
    if (ls == 0) srow[n] = s;
  }
}

// ----------------------------------------------------------------- select

constexpr int kSelWarps = 16;
constexpr int kSelThreads = 32 * kSelWarps;
constexpr int kSelSpan = 512;      // blocks a round: 16 loads a lane
constexpr int kSelMaxCtas = 32;    // a pair's lists: the last CTA's level 1

// A block's sort key: the score's bits made order-preserving (-0 as +0)
// above the complement of its index, so that keys are distinct, a larger
// key is a larger score, and among equal scores the lower index wins
// (jax.lax.top_k's tie rule). A position n past the last block is padding:
// ~n alone, below every block's key and distinct too.
__device__ __forceinline__ unsigned long long block_key(float s, int n) {
  uint32_t u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (uint32_t)~(uint32_t)n;
}
__device__ __forceinline__ float key_score(unsigned long long key) {
  const uint32_t u = (uint32_t)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}
__device__ __forceinline__ long long key_index(unsigned long long key) {
  return (long long)(uint32_t)~(uint32_t)key;
}

// One compare-exchange stage of a bitonic network over a warp's 32 KPL
// keys (position p = lane KPL + r): p and p ^ d meet, the larger goes to
// the lower position where p & s is 0 (descending runs) and to the upper
// one elsewhere.
template <int KPL>
__device__ __forceinline__ void bitonic_stage(unsigned long long (&v)[KPL],
                                              int lane, int s, int d) {
  if (d >= KPL) {
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const int p = lane * KPL + r;
      const unsigned long long o = __shfl_xor_sync(kFull, v[r], d / KPL);
      const bool larger = ((p & s) == 0) == ((p & d) == 0);
      v[r] = larger ? (v[r] > o ? v[r] : o) : (v[r] < o ? v[r] : o);
    }
  } else {
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      if (r & d) continue;
      const unsigned long long x = v[r], y = v[r | d];
      if (((lane * KPL + r) & s) == 0 ? x < y : x > y) {
        v[r] = y;
        v[r | d] = x;
      }
    }
  }
}

// Sort a warp's chunk of 32 KPL distinct keys in shared memory (16-byte
// aligned) into descending order in place: a key's rank is the count of
// larger ones (the chunk read as broadcasts, no dependent shuffles), and
// it is written there.
template <int KPL>
__device__ __forceinline__ void chunk_sort(unsigned long long* c, int lane) {
  constexpr int L = 32 * KPL;
  unsigned long long mine[KPL];
  int rank[KPL];
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    mine[r] = c[lane + 32 * r];
    rank[r] = 0;
  }
#pragma unroll 8
  for (int j = 0; j < L; j += 2) {
    const ulonglong2 o = *reinterpret_cast<const ulonglong2*>(c + j);
#pragma unroll
    for (int r = 0; r < KPL; ++r)
      rank[r] += (int)(o.x > mine[r]) + (int)(o.y > mine[r]);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < KPL; ++r) c[rank[r]] = mine[r];
  __syncwarp();
}

// The top 32 KPL of two descending lists a and b, descending, into out:
// max(a[p], b[L - 1 - p]) is bitonic and holds them; one merge sorts it.
// out may be a.
template <int KPL, bool kGlobal>
__device__ __forceinline__ void merge_top(const unsigned long long* a,
                                          const unsigned long long* b,
                                          unsigned long long* out, int lane) {
  constexpr int L = 32 * KPL;
  unsigned long long v[KPL];
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int p = lane * KPL + r;
    const unsigned long long x = kGlobal ? __ldcg(a + p) : a[p];
    const unsigned long long y = kGlobal ? __ldcg(b + L - 1 - p) : b[L - 1 - p];
    v[r] = x > y ? x : y;
  }
#pragma unroll
  for (int d = L >> 1; d > 0; d >>= 1) bitonic_stage<KPL>(v, lane, 2 * L, d);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < KPL; ++r) out[lane * KPL + r] = v[r];
}

// Two chains of a block's 16-lane sum (chains gl and gl + 8 of the group
// dot, 8 products each from zero) held by one of 8 lanes: their sum is
// the butterfly's first level, the other three are shuffles within the 8
// lanes. The same sums in the same order as group_dot<16>, so the same
// score (the adds commute).
__device__ __forceinline__ float pair_dot(const float (&q0)[8],
                                          const float (&q1)[8], uint4 u0,
                                          uint4 u1) {
  const uint32_t w0[4] = {u0.x, u0.y, u0.z, u0.w};
  const uint32_t w1[4] = {u1.x, u1.y, u1.z, u1.w};
  float a = 0.f, c = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a = fmaf(q0[2 * i], __uint_as_float(w0[i] << 16), a);
    a = fmaf(q0[2 * i + 1], __uint_as_float(w0[i] & 0xffff0000u), a);
    c = fmaf(q1[2 * i], __uint_as_float(w1[i] << 16), c);
    c = fmaf(q1[2 * i + 1], __uint_as_float(w1[i] & 0xffff0000u), c);
  }
  float acc = a + c;
#pragma unroll
  for (int off = 4; off >= 1; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  return acc;
}

// The key of position n of a (row, KV head) whose block is not valid:
// NEG_INF, or padding past the last block; a run of them is in descending
// order.
__device__ __forceinline__ unsigned long long masked_key(int n, int nb) {
  return n < nb ? block_key(kNegInf, n) : (uint32_t)~(uint32_t)n;
}

// k11_select: the masked block scores of k11_score, bit for bit, and their
// top k (descending; equal scores by index), one launch. Grid (ctas, Hkv,
// B); a CTA scores `rounds` runs of 512 blocks: a warp 32 of them, 8
// lanes a block holding two of its 16 sum chains (pair_dot: 3 shuffles a
// block, not 4), all 16 16-byte loads of a lane issued at once, only
// blocks that can be valid read, and no branch around a block's sum (so
// the 8 blocks of a lane overlap). Each run is sorted in chunks of L = 32
// KPL keys (chunk_sort: ranks by counting), the chunks merged (a warp's
// bitonic merge in registers) in index order, neighbours first, into the
// run's top L, and the runs folded
// into the CTA's top L. A chunk, run or list whose blocks hold no valid
// one is already in order (NEG_INF by index) and loses every merge to the
// lower-indexed list beside it, so it is neither sorted nor merged. With
// one CTA a (row, KV head) it writes the result; otherwise it writes its
// list to cands, draws the pair's ticket, and the last drawer merges the
// ctas lists the same way (the first level from cands by up to 16 warps,
// then in shared memory), writes the top k and sets the ticket back to
// zero.
template <int KPL>
__global__ void __launch_bounds__(kSelThreads, 1)
    sparse_select(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ comp,
                  const int* __restrict__ total, float* __restrict__ top_val,
                  long long* __restrict__ top_idx,
                  unsigned long long* __restrict__ cands,
                  int* __restrict__ tickets, int H, int Hkv, int nb,
                  int init_end, int window, int ks, int k, int rounds) {
  constexpr int D = 128, L = 32 * KPL, CHUNKS = kSelSpan / L;
  static_assert(kSelSpan == 32 * kSelWarps && D == 128, "32 blocks a warp");
  __shared__ __align__(16) unsigned long long s_key[kSelSpan];
  __shared__ unsigned long long s_list[kSelMaxCtas / 2][L];
  __shared__ bool s_last;

  const int g = blockIdx.y, b = blockIdx.z, ctas = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 3, gl = lane & 7;     // 4 blocks of 8 lanes
  const int tot = total[b];
  const int ws = max(tot - window, init_end);
  const int lo = (init_end + ks - 1) / ks;      // first block >= init_end
  const int hi = min(ws / ks, nb);              // blocks ending <= ws
  auto holds_valid = [&](int n0, int n1) { return n0 < hi && n1 > lo; };
  float q0[8], q1[8];                           // chains gl and gl + 8
  {
    const __nv_bfloat16* qs =
        q + ((size_t)b * H + (size_t)g * (H / Hkv)) * D + gl * 8;
    const uint4 u0 = *reinterpret_cast<const uint4*>(qs);
    const uint4 u1 = *reinterpret_cast<const uint4*>(qs + 64);
    const uint32_t w0[4] = {u0.x, u0.y, u0.z, u0.w};
    const uint32_t w1[4] = {u1.x, u1.y, u1.z, u1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      q0[2 * i] = __uint_as_float(w0[i] << 16);
      q0[2 * i + 1] = __uint_as_float(w0[i] & 0xffff0000u);
      q1[2 * i] = __uint_as_float(w1[i] << 16);
      q1[2 * i + 1] = __uint_as_float(w1[i] & 0xffff0000u);
    }
  }
  const size_t pair = (size_t)b * Hkv + g;
  const __nv_bfloat16* crow = comp + pair * nb * D + gl * 8;
  unsigned long long* best = s_list[0];

  for (int rnd = 0; rnd < rounds; ++rnd) {
    const int start = (blockIdx.x * rounds + rnd) * kSelSpan;
    const bool scored = holds_valid(start, start + kSelSpan);
    if (!scored) {
      if (rnd == 0)
        for (int p = tid; p < L; p += kSelThreads)
          best[p] = masked_key(start + p, nb);
      continue;
    }
    {
      // a block that is not valid reads the nearest valid one instead (the
      // run holds one): no branch, so all 16 loads are in flight at once
      const int n0 = start + warp * 32 + grp;
      uint4 u[8][2];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int n = min(max(n0 + 4 * r, lo), hi - 1);
        const uint4* src =
            reinterpret_cast<const uint4*>(crow + (size_t)n * D);
        u[r][0] = src[0];
        u[r][1] = src[8];
      }
      float sc[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) sc[r] = pair_dot(q0, q1, u[r][0], u[r][1]);
      if (gl == 0) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int n = n0 + 4 * r;
          s_key[n - start] = n >= lo && n < hi ? block_key(sc[r], n)
                                                : masked_key(n, nb);
        }
      }
    }
    __syncthreads();
    if (warp < CHUNKS && holds_valid(start + warp * L, start + warp * L + L))
      chunk_sort<KPL>(s_key + warp * L, lane);
    for (int st = 1; st < CHUNKS; st <<= 1) {   // chunks c and c + st
      __syncthreads();
      const int c = warp * 2 * st;
      if (c + st < CHUNKS &&
          holds_valid(start + (c + st) * L, start + (c + 2 * st) * L))
        merge_top<KPL, false>(s_key + c * L, s_key + (c + st) * L,
                              s_key + c * L, lane);
    }
    __syncthreads();
    if (warp == 0) {       // fold the run's top L into the CTA's
      if (rnd == 0) {
#pragma unroll
        for (int r = 0; r < KPL; ++r)
          best[lane * KPL + r] = s_key[lane * KPL + r];
      } else {
        merge_top<KPL, false>(best, s_key, best, lane);
      }
    }
    __syncthreads();
  }
  __syncthreads();

  if (ctas > 1) {
    const int span = rounds * kSelSpan;        // blocks a CTA
    unsigned long long* mine = cands + (pair * ctas + blockIdx.x) * L;
    for (int p = tid; p < L; p += kSelThreads) mine[p] = best[p];
    __syncthreads();
    if (tid == 0) {        // the CTA's writes published, the others' seen
      asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
      s_last = atomicAdd(tickets + pair, 1) == ctas - 1;
      asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
    }
    __syncthreads();
    if (!s_last) return;
    // level 1 from cands, lists 2w and 2w + 1 into s_list[w]; then in
    // shared memory, lists i and i + st into i
    const unsigned long long* lists = cands + pair * ctas * L;
    const int n1 = (ctas + 1) / 2;
    if (warp < n1) {
      const int i = 2 * warp;
      if (i + 1 < ctas && holds_valid((i + 1) * span, (i + 2) * span)) {
        merge_top<KPL, true>(lists + i * L, lists + (i + 1) * L,
                             s_list[warp], lane);
      } else {
#pragma unroll
        for (int r = 0; r < KPL; ++r)
          s_list[warp][lane * KPL + r] = __ldcg(lists + i * L + lane * KPL + r);
      }
    }
    for (int st = 1; st < n1; st <<= 1) {
      __syncthreads();
      const int i = warp * 2 * st;
      if (i + st < n1 &&
          holds_valid((2 * (i + st)) * span, (2 * (i + 2 * st)) * span))
        merge_top<KPL, false>(s_list[i], s_list[i + st], s_list[i], lane);
    }
    __syncthreads();
    if (tid == 0) tickets[pair] = 0;
  }
  for (int i = tid; i < k; i += kSelThreads) {
    top_val[pair * k + i] = key_score(best[i]);
    top_idx[pair * k + i] = key_index(best[i]);
  }
}

// ----------------------------------------------------------------- attend

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;          // slots a tile, 16 a warp
constexpr int kRows = 16;          // query rows a CTA (the mma's 16 rows)
constexpr int kMaxTopk = 256;
constexpr int kBatch = 8;          // partials loaded at once in a merge

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += A (16 x 16) . B (16 x 8), bf16 in, f32 accumulators; a0 / a2 rows g
// (columns 2t, 2t+1 / 2t+8, 2t+9), a1 / a3 rows g + 8
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of 16-byte piece c of row r in a bf16 tile [kTile][D]: the
// piece index's low 3 bits XORed with the row's (as K3's tiles)
template <int D>
__device__ __forceinline__ int at(int r, int c) {
  return r * (D * 2) + ((c ^ (r & 7)) << 4);
}

template <int D>
struct Plan {
  static constexpr int kRowBytes = D * 2;
  static constexpr int kPieces = kRowBytes / 16;
  static constexpr int kSide = kTile * kRowBytes;        // K or V of a tile
  static constexpr int kStage = 2 * kSide;
  static constexpr int kStages = 3;
  static constexpr int kMerge = kWarps * kRows * (D + 2) * 4;
  static constexpr int kRing = kStages * kStage;
  static constexpr size_t kBytes = kRing > kMerge ? kRing : kMerge;
  static constexpr int kCopies = kTile * kPieces / kThreads;
  static_assert(kTile * kPieces % kThreads == 0, "copy split");
};

// Thread 0 adds one to *ticket, releasing the CTA's writes before the
// call (ordered by the barrier) and acquiring those that other CTAs
// released with their tickets, at gpu scope; true, in every thread, for
// the drawer of the last of n tickets, which sets the ticket back to zero.
__device__ __forceinline__ bool draw_last(int* ticket, int n, int* s_flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int t;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(t)
                 : "l"(ticket)
                 : "memory");
    if (t == n - 1) *ticket = 0;
    *s_flag = t == n - 1;
  }
  __syncthreads();
  return *s_flag;
}

// Merge the n partials at slots first, first + stride, ... of a (row, KV
// head) (slot s of the partials from `acc` / `ml`: kRows query heads' row
// max in log2 units and denominator [kRows][2], numerator [kRows][D], the
// first R used), in slot order: into out (bf16, R heads) if to_out, else
// into slot first. A thread per (head, 16 dims) loads kBatch partials at
// once from L2, the running sums rescaled to each batch's max. Every
// thread of the CTA calls it (it has a barrier).
template <int D>
__device__ __forceinline__ void merge_partials(
    float* __restrict__ acc, float* __restrict__ ml,
    __nv_bfloat16* __restrict__ out, int R, int first, int stride, int n,
    bool to_out) {
  constexpr int kPer = kRows * D / kThreads;
  const int tid = threadIdx.x;
  const int r = tid / (D / kPer), d0 = tid % (D / kPer) * kPer;
  float m = -INFINITY, den = 0.f, num[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) num[e] = 0.f;
  for (int s0 = 0; s0 < (r < R ? n : 0); s0 += kBatch) {
    float ms[kBatch], ls[kBatch];
    float4 a[kBatch][kPer / 4];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const bool ok = s0 + i < n;
      const size_t sl = (size_t)(first + (s0 + i) * stride) * kRows + r;
      ms[i] = ok ? __ldcg(ml + sl * 2) : -INFINITY;
      ls[i] = ok ? __ldcg(ml + sl * 2 + 1) : 0.f;
#pragma unroll
      for (int e = 0; e < kPer / 4; ++e)
        a[i][e] = ok ? __ldcg(reinterpret_cast<const float4*>(
                           acc + sl * D + d0) + e)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float mb = m;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) mb = fmaxf(mb, ms[i]);
    if (mb == -INFINITY) continue;
    const float fr = exp2f(m - mb);     // 0 while nothing is summed
    den *= fr;
#pragma unroll
    for (int e = 0; e < kPer; ++e) num[e] *= fr;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (ms[i] == -INFINITY) continue;
      const float f = exp2f(ms[i] - mb);
      den = fmaf(f, ls[i], den);
#pragma unroll
      for (int e = 0; e < kPer / 4; ++e) {
        num[4 * e] = fmaf(f, a[i][e].x, num[4 * e]);
        num[4 * e + 1] = fmaf(f, a[i][e].y, num[4 * e + 1]);
        num[4 * e + 2] = fmaf(f, a[i][e].z, num[4 * e + 2]);
        num[4 * e + 3] = fmaf(f, a[i][e].w, num[4 * e + 3]);
      }
    }
    m = mb;
  }
  __syncthreads();                // every read of slot first is done
  if (r >= R) return;
  if (to_out) {
#pragma unroll
    for (int e = 0; e < kPer; e += 2)
      *reinterpret_cast<__nv_bfloat162*>(out + r * D + d0 + e) =
          __floats2bfloat162_rn(num[e] / den, num[e + 1] / den);
  } else {
    const size_t sl = (size_t)first * kRows + r;
#pragma unroll
    for (int e = 0; e < kPer; e += 4)
      *reinterpret_cast<float4*>(acc + sl * D + d0 + e) =
          make_float4(num[e], num[e + 1], num[e + 2], num[e + 3]);
    if (d0 == 0) {
      ml[sl * 2] = m;
      ml[sl * 2 + 1] = den;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    sparse_attend(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const long long* __restrict__ top_idx,
                  const float* __restrict__ top_val,
                  const int* __restrict__ total,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int* __restrict__ tickets,
                  int H, int Hkv, int S, int topk, int init_end, int window,
                  int ks, int sps, int group, float scale) {
  using P = Plan<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_sel[kMaxTopk];
  __shared__ int s_nsel, s_last;
  const int split = blockIdx.x, splits = gridDim.x;
  const int g = blockIdx.y, b = blockIdx.z;
  const int R = H / Hkv, h0 = g * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, t4 = lane & 3;
  const size_t bg = (size_t)b * Hkv + g;
  const size_t bh0 = (size_t)b * H + h0;

  // Every load that needs nothing else is issued first: the row's total,
  // the (row, KV head)'s top-k scores and ids (warp 0, all at once), and
  // the query heads as the A operand (rows gq and gq + 8, zero past R).
  const int tot = total[b];
  constexpr int kSel = kMaxTopk / 32;
  float sv[kSel];
  long long si[kSel];
  if (warp == 0) {
#pragma unroll
    for (int r = 0; r < kSel; ++r) {
      const int i = r * 32 + lane;
      sv[r] = i < topk ? top_val[bg * topk + i] : kNegInf;
      si[r] = i < topk ? top_idx[bg * topk + i] : 0;
    }
  }
  uint32_t qa[D / 16][4];
  {
    const bool r0 = gq < R, r1 = gq + 8 < R;
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(
        q + (bh0 + (r0 ? gq : 0)) * D);
    const uint32_t* q1 = reinterpret_cast<const uint32_t*>(
        q + (bh0 + (r1 ? gq + 8 : 0)) * D);
#pragma unroll
    for (int s = 0; s < D / 16; ++s) {
      qa[s][0] = r0 ? q0[8 * s + t4] : 0u;
      qa[s][1] = r1 ? q1[8 * s + t4] : 0u;
      qa[s][2] = r0 ? q0[8 * s + 4 + t4] : 0u;
      qa[s][3] = r1 ? q1[8 * s + 4 + t4] : 0u;
    }
  }
  // the selected blocks with a finite score, in top-k order: each one's
  // rank is the count of finite scores before it (a ballot a 32 entries)
  if (warp == 0) {
    int cnt = 0;
#pragma unroll
    for (int r = 0; r < kSel; ++r) {
      const bool ok = sv[r] > 0.5f * kNegInf;
      const unsigned bal = __ballot_sync(kFull, ok);
      if (ok) s_sel[cnt + __popc(bal & ((1u << lane) - 1u))] = (int)si[r];
      cnt += __popc(bal);
    }
    if (lane == 0) s_nsel = cnt;
  }
  const int ws = max(tot - window, init_end);
  const int n_init = min(init_end, tot);
  const int n_win = max(tot - ws, 0);
  __syncthreads();
  const int sel_end = n_init + s_nsel * ks;
  const int count = sel_end + n_win;
  const int used = (count + sps - 1) / sps;       // splits with a slot
  const int lo = split * sps, hi = min(lo + sps, count);
  if (lo >= hi) return;                     // nothing of this row here
  const int n_tiles = (hi - lo + kTile - 1) / kTile;

  // cache position of valid slot i
  auto pos_of = [&](int i) -> int {
    int p;
    if (i < n_init) {
      p = i;
    } else if (i < sel_end) {
      const int u = i - n_init;
      p = s_sel[u / ks] * ks + u % ks;
    } else {
      p = ws + (i - sel_end);
    }
    return min(p, S - 1);
  };
  const unsigned char* kbase =
      reinterpret_cast<const unsigned char*>(k + bg * S * D);
  const unsigned char* vbase =
      reinterpret_cast<const unsigned char*>(v + bg * S * D);
  auto stage = [&](int s) { return smem + (size_t)s * P::kStage; };
  // queue tile i's copies into stage s; slots past hi are zero-filled
  auto issue = [&](int i, int s) {
    const unsigned kst = smem_u32(stage(s)), vst = kst + P::kSide;
    const int s0 = lo + i * kTile;
#pragma unroll
    for (int c4 = 0; c4 < P::kCopies; ++c4) {
      const int idx = tid + c4 * kThreads;
      const int r = idx / P::kPieces, c = idx % P::kPieces, sl = s0 + r;
      const int n = sl < hi ? 16 : 0;
      const size_t off =
          (size_t)pos_of(min(sl, hi - 1)) * P::kRowBytes + c * 16;
      cp_async16(kst + at<D>(r, c), kbase + off, n);
      cp_async16(vst + at<D>(r, c), vbase + off, n);
    }
    cp_async_commit();
  };
  const float qk = scale * kLog2e;     // scores in log2 units, f32

  float o[D / 8][4], m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;

#pragma unroll
  for (int s = 0; s < P::kStages - 1; ++s) {
    if (s < n_tiles) issue(s, s);
    else cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<P::kStages - 2>();      // tile i has landed
    __syncthreads();                      // ... for every thread; tile i-1
                                          // is consumed by every warp
    if (i + P::kStages - 1 < n_tiles)
      issue(i + P::kStages - 1, (i + P::kStages - 1) % P::kStages);
    else
      cp_async_commit();
    const unsigned kb = smem_u32(stage(i % P::kStages));
    const unsigned vb = kb + P::kSide;
    const int s0 = lo + i * kTile;

    // S = Q K^T over this warp's 16 slots (two n8 tiles)
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const int r = 16 * warp + (lane >> 4) * 8 + (lane & 7);
      const int hh = (lane >> 3) & 1;
#pragma unroll
      for (int s = 0; s < D / 16; ++s) {
        uint32_t f[4];
        ldsm_x4(kb + at<D>(r, 2 * s + hh), f);
        mma16(sc[0], qa[s], f[0], f[1]);
        mma16(sc[1], qa[s], f[2], f[3]);
      }
    }
    // online softmax of rows gq (e = 0, 1) and gq + 8 (e = 2, 3)
    float x[2][2][2], mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sl = s0 + 16 * warp + 8 * n + 2 * t4 + (e & 1);
        const float val = sl < hi ? sc[n][e] * qk : -INFINITY;
        x[e >> 1][n][e & 1] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float alpha[2], m_new[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(kFull, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(kFull, mx[rr], 2));
      m_new[rr] = fmaxf(m_run[rr], mx[rr]);
      alpha[rr] = m_new[rr] == -INFINITY ? 1.f : exp2f(m_run[rr] - m_new[rr]);
      m_run[rr] = m_new[rr];
    }
    float p[2][2][2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float xv = x[rr][n][e];
          p[rr][n][e] = xv == -INFINITY ? 0.f : exp2f(xv - m_new[rr]);
          sum += p[rr][n][e];
        }
      l_run[rr] = fmaf(l_run[rr], alpha[rr], sum);
    }
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }
    // O += P . V over the same 16 slots (one k16 step)
    const uint32_t pa[4] = {pack_bf16(p[0][0][0], p[0][0][1]),
                            pack_bf16(p[1][0][0], p[1][0][1]),
                            pack_bf16(p[0][1][0], p[0][1][1]),
                            pack_bf16(p[1][1][0], p[1][1][1])};
    {
      const int r = 16 * warp + ((lane >> 3) & 1) * 8 + (lane & 7);
      const int hh = lane >> 4;
#pragma unroll
      for (int c = 0; c < D / 8; c += 2) {
        uint32_t f[4];
        ldsm_x4_t(vb + at<D>(r, c + hh), f);
        mma16(o[c], pa, f[0], f[1]);
        mma16(o[c + 1], pa, f[2], f[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                        // the ring is free for the merge

  // merge the warps' softmaxes (the ring's memory is reused)
  float* red_acc = reinterpret_cast<float*>(smem);      // [warp][row][D]
  float* red_ml = red_acc + kWarps * kRows * D;         // [warp][row][2]
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = l_run[rr];
    l += __shfl_xor_sync(kFull, l, 1);
    l += __shfl_xor_sync(kFull, l, 2);
    const int row = gq + 8 * rr;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      red_acc[(warp * kRows + row) * D + 8 * d + 2 * t4] = o[d][2 * rr];
      red_acc[(warp * kRows + row) * D + 8 * d + 2 * t4 + 1] =
          o[d][2 * rr + 1];
    }
    if (t4 == 0) {
      red_ml[(warp * kRows + row) * 2] = m_run[rr];
      red_ml[(warp * kRows + row) * 2 + 1] = l;
    }
  }
  __syncthreads();
  // a query head's factors (its warps' maxima against the largest) and its
  // max and denominator, once, by a thread a head
  __shared__ float s_f[kRows][kWarps + 2];
  if (tid < R) {
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      m = fmaxf(m, red_ml[(w * kRows + tid) * 2]);
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = red_ml[(w * kRows + tid) * 2];
      const float f = mw == -INFINITY ? 0.f : exp2f(mw - m);
      s_f[tid][w] = f;
      den = fmaf(f, red_ml[(w * kRows + tid) * 2 + 1], den);
    }
    s_f[tid][kWarps] = m;
    s_f[tid][kWarps + 1] = den;
  }
  __syncthreads();
  // the CTA's partial (or, with one split, the output): a thread a (head,
  // 16 dims)
  constexpr int kPer = kRows * D / kThreads;
  float* acc = part_acc + bg * splits * kRows * D;     // this row's partials
  float* ml = part_ml + bg * splits * kRows * 2;
  {
    const int r = tid / (D / kPer), d0 = tid % (D / kPer) * kPer;
    if (r < R) {
      const size_t pi = (size_t)split * kRows + r;
#pragma unroll
      for (int e = 0; e < kPer; e += 4) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float f = s_f[r][w];
          const float4 y = *reinterpret_cast<const float4*>(
              red_acc + (w * kRows + r) * D + d0 + e);
          x.x = fmaf(f, y.x, x.x);
          x.y = fmaf(f, y.y, x.y);
          x.z = fmaf(f, y.z, x.z);
          x.w = fmaf(f, y.w, x.w);
        }
        if (used == 1) {
          const float den = s_f[r][kWarps + 1];
          __nv_bfloat16* o2 = out + (bh0 + r) * D + d0 + e;
          *reinterpret_cast<__nv_bfloat162*>(o2) =
              __floats2bfloat162_rn(x.x / den, x.y / den);
          *reinterpret_cast<__nv_bfloat162*>(o2 + 2) =
              __floats2bfloat162_rn(x.z / den, x.w / den);
        } else {
          *reinterpret_cast<float4*>(acc + pi * D + d0 + e) = x;
        }
      }
      if (used > 1 && d0 == 0) {
        ml[pi * 2] = s_f[r][kWarps];
        ml[pi * 2 + 1] = s_f[r][kWarps + 1];
      }
    }
  }
  if (used == 1) return;

  // The partials are merged in a tree of fixed shape: the splits in groups
  // of `group`, each merged by the CTA that draws its group's last ticket
  // (into the group's first partial), then, if there is more than one
  // group, the groups' partials by the CTA that draws the row's last
  // ticket. Each merge sums in split (group) order, never in arrival
  // order, so the bits do not depend on which CTA finishes when.
  // tickets: [B * Hkv] rows, then [B * Hkv][groups] groups.
  const int groups = (splits + group - 1) / group;
  const int used_groups = (used + group - 1) / group;
  const int first = split / group * group;
  int* gticket = tickets + (size_t)gridDim.y * gridDim.z + bg * groups +
                 split / group;
  if (!draw_last(gticket, min(group, used - first), &s_last)) return;
  merge_partials<D>(acc, ml, out + bh0 * D, R, first, 1,
                    min(group, used - first), used_groups == 1);
  if (used_groups == 1) return;
  if (!draw_last(tickets + bg, used_groups, &s_last)) return;
  merge_partials<D>(acc, ml, out + bh0 * D, R, 0, group, used_groups, true);
}

template <int D>
int launch_attend(const void* q, const void* k, const void* v,
                  const void* idx, const void* val, const void* total,
                  void* out, void* part_acc, void* part_ml, void* tickets,
                  int B, int H, int Hkv, int S, int topk, int init_end,
                  int window, int ks, int splits, int sps, int group,
                  float scale, cudaStream_t st) {
  constexpr size_t smem = Plan<D>::kBytes;
  static bool attrs = false;
  if (!attrs) {
    const cudaError_t e = cudaFuncSetAttribute(
        sparse_attend<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    attrs = true;
  }
  sparse_attend<D><<<dim3(splits, Hkv, B), kThreads, smem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const long long*)idx, (const float*)val,
      (const int*)total, (__nv_bfloat16*)out, (float*)part_acc,
      (float*)part_ml, (int*)tickets, H, Hkv, S, topk, init_end, window, ks,
      sps, group, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_score(const void* q, const void* comp, const void* total,
                 void* scores, int B, int H, int Hkv, int nb, int init_end,
                 int window, int ks, cudaStream_t st) {
  constexpr int per_cta = kScoreWarps * (32 / (D / 8)) * kScoreIters;
  const dim3 grid((nb + per_cta - 1) / per_cta, Hkv, B);
  sparse_score<D><<<grid, 32 * kScoreWarps, 0, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)comp,
      (const int*)total, (float*)scores, H, Hkv, nb, init_end, window, ks);
  return (int)cudaGetLastError();
}

template <int KPL>
int launch_select(const void* q, const void* comp, const void* total,
                  void* top_val, void* top_idx, void* cands, void* tickets,
                  int B, int H, int Hkv, int nb, int init_end, int window,
                  int ks, int k, int ctas, int rounds, cudaStream_t st) {
  sparse_select<KPL><<<dim3(ctas, Hkv, B), kSelThreads, 0, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)comp,
      (const int*)total, (float*)top_val, (long long*)top_idx,
      (unsigned long long*)cands, (int*)tickets, H, Hkv, nb, init_end,
      window, ks, k, rounds);
  return (int)cudaGetLastError();
}

bool bad_heads(int B, int H, int Hkv) {
  return B < 1 || B > 65535 || Hkv < 1 || Hkv > 65535 || H % Hkv ||
         H / Hkv > kRows;
}

}  // namespace

extern "C" {

// k11_score on `stream`: q [B, H, D] bf16 (the decode step's queries; the
// scoring query of KV head g is query head g H / Hkv), comp [B, Hkv, nb, D]
// bf16, total [B] int32 (tokens including this step's); scores [B, Hkv,
// nb] float32. D = 128 (MiniCPM-SALA's). Returns the first CUDA error.
int ominix_sparse_score(const void* q, const void* comp, const void* total,
                        void* scores, int B, int H, int Hkv, int nb, int D,
                        int init_end, int window, int ks, void* stream) {
  if (bad_heads(B, H, Hkv) || nb < 1 || ks < 1 || init_end < 0 ||
      window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D != 128) return (int)cudaErrorInvalidValue;
  return launch_score<128>(q, comp, total, scores, B, H, Hkv, nb, init_end,
                           window, ks, st);
}

// k11_select on `stream`, one launch: the scores of ominix_sparse_score
// (the same arguments) and their top k, k <= 256 and k <= nb: top_val [B,
// Hkv, k] float32 and top_idx [B, Hkv, k] int64, descending, equal scores
// by index (the blocks that are not valid score NEG_INF). The blocks are
// cut into ctas runs of rounds x 512 a (row, KV head) (ctas <= 32, ctas x
// rounds x 512 >= nb; ops/sparse_attention.py k11_select_plan); with ctas
// > 1, cands [B, Hkv, ctas, L] (L = 64, 128 or 256, the least power of two
// >= max(k, 64)) holds each CTA's top L and tickets [B Hkv] int32 (zero;
// left zero) count a pair's finished CTAs. Returns the first CUDA error.
int ominix_sparse_select(const void* q, const void* comp, const void* total,
                         void* top_val, void* top_idx, void* cands,
                         void* tickets, int B, int H, int Hkv, int nb, int D,
                         int init_end, int window, int ks, int k, int ctas,
                         int rounds, void* stream) {
  if (bad_heads(B, H, Hkv) || D != 128 || nb < 1 || ks < 1 ||
      init_end < 0 || window < 0 || k < 1 || k > kMaxTopk || k > nb ||
      ctas < 1 || ctas > kSelMaxCtas || rounds < 1 ||
      (long long)ctas * rounds * kSelSpan < nb ||
      (ctas > 1 && (cands == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 64)
    return launch_select<2>(q, comp, total, top_val, top_idx, cands, tickets,
                            B, H, Hkv, nb, init_end, window, ks, k, ctas,
                            rounds, st);
  if (k <= 128)
    return launch_select<4>(q, comp, total, top_val, top_idx, cands, tickets,
                            B, H, Hkv, nb, init_end, window, ks, k, ctas,
                            rounds, st);
  return launch_select<8>(q, comp, total, top_val, top_idx, cands, tickets, B,
                          H, Hkv, nb, init_end, window, ks, k, ctas, rounds,
                          st);
}

// k11_attend on `stream`, one launch: q [B, H, D] bf16; k, v [B, Hkv, S,
// D] bf16; top_idx [B, Hkv, topk] int64 and top_val [B, Hkv, topk] float32
// (as torch.topk returns them); total [B] int32; out [B, H, D] bf16. The
// slots are cut into `splits` runs of `slots_per_split` (a multiple of 64;
// the plan of ops/sparse_attention.py k11_plan); with more than one split,
// part_acc [B, Hkv, splits, 16, D] and part_ml [.., 2] (float32) hold
// the partials and tickets (int32, B Hkv (1 + ceil(splits / 8)) of them,
// zero; the kernel leaves them zero) the counts of a row's finished splits
// and groups of splits. D = 128, H / Hkv <= 16, topk <= 256, init_end +
// window >= 1 (a row's first slot is valid).
int ominix_sparse_attend(const void* q, const void* k, const void* v,
                         const void* top_idx, const void* top_val,
                         const void* total, void* out, void* part_acc,
                         void* part_ml, void* tickets, int B, int H, int Hkv,
                         int S, int D, int topk, int init_end, int window,
                         int ks, int splits, int slots_per_split, int group,
                         float scale, void* stream) {
  if (bad_heads(B, H, Hkv) || S < 1 || topk < 0 || topk > kMaxTopk ||
      ks < 1 || init_end < 0 || window < 0 || init_end + window < 1 ||
      splits < 1 || slots_per_split < kTile || slots_per_split % kTile ||
      group < 2 ||
      (long long)splits * slots_per_split <
          (long long)init_end + (long long)topk * ks + window ||
      (splits > 1 &&
       (part_acc == nullptr || part_ml == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D != 128) return (int)cudaErrorInvalidValue;
  return launch_attend<128>(q, k, v, top_idx, top_val, total, out, part_acc,
                            part_ml, tickets, B, H, Hkv, S, topk, init_end,
                            window, ks, splits, slots_per_split, group, scale,
                            st);
}

}  // extern "C"
