// Coded IVF group scan + per-(cluster, query) top-kk for Hopper (sm_90a).
//
// Replaces: vecgo_tpu/ops/pallas_scan.py `pallas_coded_group_scan` (body
// `_coded_scan_kernel`) together with the query gather of its driver
// `_ivf_scan_fused` (vecgo_tpu/ops/ivf.py). For every cluster c of a coded
// IVF table and every query probing it, the kernel scores the cluster's S
// SQ8 residual codes and keeps the query's kk nearest slots:
//
//   qr  = q - cent[c]                     (f32)
//   dd  = |qr|^2 + bn[c, s] - 2 * (scale[c] * (bf16(qr) . codes[c, s]))
//
// The int8 codes are exact in bf16, so every product bf16(qr) * code is exact
// in f32; sums accumulate in f32. The scale multiplies the finished product,
// as in the Pallas kernel. bn is +inf at padded and masked slots. Ties go to
// the lower column, as `lax.top_k` does; entries that are not finite or are
// >= 3e38 never enter a list, and empty list slots come back as (+inf, -1).
//
// The TPU kernel walked cluster groups in grid order and needed the probing
// queries materialised as [K, qcap, d] by an XLA gather. Here block
// (cluster c, query group g) reads its slots of the inverted table qtab
// [K, qcap] (query index, or B for an empty slot), compacts the live query
// ids and gathers and centres those queries itself. A group with no live
// query writes (+inf, -1) and exits before it reads a code byte.
//
// What bounds it on the H100: the codes' bytes, each probed cluster's S x d
// codes read once. At the serving shape (B = 4096, d = 128, K = 3,008
// clusters of S = 1,024, 4 probes, kk 16) that is ~0.38 GB (0.12 ms at
// 3.35 TB/s) against ~3.2 GFLOP of bf16 products (3 us at the tensor cores'
// peak); at the segment's default knobs (20 probes, qcap 96, kk 8) the bytes
// are about the same (~0.39 GB) and the products ~7.3 GFLOP. Measured, the
// SMs' instruction throughput holds it back rather than memory: converting every
// code byte to bf16 (2.75 instructions a byte) and the per-query selection
// chains (PERF.md). The design, against each part:
//
// * One read of a cluster for all its queries. A block holds up to QG = 64
//   query slots (fewer only for d > 704, where 64 bf16 query rows would not
//   fit the query tile's budget, and never more than qcap rounded up to 16),
//   so a cluster probed by up to 64 queries is read once a batch; one with
//   more is read once per group of 64 (one block per group, adjacent).
// * An asynchronous copy ring. The cluster's codes stream through STAGES = 3
//   shared-memory stages of RT = 64 rows x TD = 128 bytes. One warp starts
//   each unit as TMA bulk copies (`cp.async.bulk`, one copy of 8 KB when rows
//   are 128 bytes, else one per row) onto the stage's mbarrier, with the
//   tile's bn beside it, so two units are in flight while one is scored and
//   no other thread spends an instruction on the copies. A d that is not a
//   multiple of 16, an S that is not a multiple of 4, or a misaligned codes
//   or bn pointer takes plain element loads into the same layout.
// * The product on the tensor cores. `mma.sync` m16n8k16 bf16 x bf16 -> f32:
//   A is the block's bf16 query residuals, built once per (cluster, query)
//   into shared memory; B is the staged codes. Each warp owns 8 code rows
//   of a unit and every query tile (16 queries), so each code byte is
//   converted to bf16 once per block (a byte permute plus a magic-number
//   subtraction, exact) and reused for every query. A lane reads 16
//   consecutive code bytes of its row and feeds them to four k16 steps; the
//   query residuals are stored in the matching permuted depth order, which
//   leaves the dot product unchanged. The unit loop is specialised for 1-4
//   query tiles. `wgmma` would multiply mostly padding here: a cluster has
//   about 5-30 live queries.
// * Selection in the epilogue. Each thread forms its scores from the
//   accumulator fragments and tests them against its query's kk-th score
//   (a bar in shared memory); only survivors are written to shared memory,
//   with a 64-bit survivor mask per query. Then one warp per query folds
//   the survivors of each 32-row half into the query's sorted list of 32 W
//   entries, W = 1 for kk <= 32 and 2 for kk <= 64 (lane l holds entries l
//   and 32 + l; in registers for the whole scan when a block has at most 8
//   queries, else in shared memory between units): a half with few
//   survivors inserts them one at a time (ballot + shuffle), a half with
//   many (the list's fill) is bitonic-sorted in registers and merged in one
//   bitonic step (at W = 2, one compare between a lane's two registers
//   first). Past kk = 64 (any kk <= S), each (cluster, query slot) keeps an
//   unsorted pool of keys in a global scratch instead (select_wide.cuh,
//   shared with scan_topk's selection): the same epilogue and bar, one warp
//   per query appends its survivors and shrinks the pool by a radix select
//   when the next unit could overflow it, and a second kernel selects and
//   sorts each pair's exact kk. No engine default reaches that shape.
// * One launch. Blocks run in cluster order, so a heavy cluster that starts
//   late can leave the card idle behind it (PERF.md); ordering the clusters
//   heaviest first would take more launches on a host-bound batch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "select_wide.cuh"

namespace {

constexpr int THREADS = 256;    // 8 warps
constexpr int NWARPS = THREADS / 32;
constexpr int RT = 64;          // code rows per unit: one n8 tile per warp
constexpr int TD = 128;         // code bytes (depth) per unit
constexpr int STAGES = 3;       // ring depth
constexpr int QG_MAX = 64;      // query slots per block
constexpr int QS_BUDGET = 96 * 1024;  // shared bytes for the bf16 query tile
constexpr int BARS = (STAGES * 8 + 15) / 16 * 16;  // mbarrier bytes, 16-byte aligned
constexpr int SORT_MIN = 8;     // survivors in a half above which it is sorted
constexpr float BIG = 3.0e38f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_LIST_KK = 64;  // list entries of two a lane; wider kk pools its survivors

// The launch layout of a (d, qcap, kk): depth padded to 64, the bf16 query
// row (padded by 8 so ldmatrix rows hit distinct banks), query slots per
// block, and the block's dynamic shared memory. The wrapper asks for it
// (vecgo_coded_group_scan_layout) to check its limits.
struct Layout {
  int dp, qs, qg;
  size_t smem;
};

__host__ __device__ inline Layout layout(int d, int qcap, int kk) {
  const bool pooled = kk > MAX_LIST_KK;
  Layout L;
  L.dp = (d + 63) / 64 * 64;
  L.qs = L.dp + 8;
  int qg = qcap > 16 ? (qcap + 15) / 16 * 16 : 16;
  qg = qg < QG_MAX ? qg : QG_MAX;
  while (qg > 16 && (size_t)qg * L.qs * 2 > QS_BUDGET) qg -= 16;
  L.qg = qg;
  L.smem = (size_t)STAGES * RT * TD            // ring: codes
           + (size_t)STAGES * RT * 4           // ring: bn of the unit's rows
           + BARS                              // ring: one mbarrier a stage
           + (size_t)qg * L.qs * 2             // bf16 query residuals
           + (size_t)qg * RT * 4               // survivor scores
           + (pooled ? (size_t)NWARPS * wsel::BINS * 4 + (size_t)qg * 4  // radix counters, pool counts
                     : (size_t)qg * kk * 8)    // lists (d, i)
           + (size_t)qg * 8                    // survivor masks
           + (size_t)qg * 4 * 4                // |qr|^2, bar, slot, query
           + 8;                                // live-slot masks
  return L;
}

// (da, ia) ranks before (db, ib); an empty entry holds id -1, which as an
// unsigned value ranks after every real column among equal scores.
__device__ __forceinline__ bool better(float da, int ia, float db, int ib) {
  return da < db || (da == db && (unsigned)ia < (unsigned)ib);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// One TMA bulk copy global -> shared, completing on the barrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Byte i of a word of biased codes (int8 ^ 0x80 = code + 128) as an exact
// f32: the byte lands in the mantissa of 2^23, and 2^23 + 128 comes off.
__device__ __forceinline__ float code_f32(uint32_t biased, int i) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u + i)) - 8388736.f;
}

// Four int8 codes (one word) -> the two bf16x2 B registers of one k16 step:
// bytes 0, 1 -> b0 (low half first), bytes 2, 3 -> b1. Exact: |code| <= 128.
__device__ __forceinline__ void codes_bf16(uint32_t w, uint32_t& b0, uint32_t& b1) {
  const uint32_t u = w ^ 0x80808080u;
  const __nv_bfloat162 lo = __floats2bfloat162_rn(code_f32(u, 0), code_f32(u, 1));
  const __nv_bfloat162 hi = __floats2bfloat162_rn(code_f32(u, 2), code_f32(u, 3));
  b0 = *reinterpret_cast<const uint32_t*>(&lo);
  b1 = *reinterpret_cast<const uint32_t*>(&hi);
}

// Where depth p of a query residual sits in its bf16 row. A lane (group g,
// thread tg) reads code bytes 16 tg .. 16 tg + 15 of each 64-byte block;
// word s of those feeds k16 step s as B rows k = 2 tg, 2 tg + 1 (bytes 0, 1)
// and 2 tg + 8, 2 tg + 9 (bytes 2, 3). The A operand must hold the same
// depth at that (step, k).
__device__ __forceinline__ int qcol(int p) {
  const int pp = p & 63, tg = pp >> 4, s = (pp >> 2) & 3, h = (pp >> 1) & 1, j = pp & 1;
  return (p & ~63) + 16 * s + 8 * h + 2 * tg + j;
}

// Bitonic compare-exchange across lanes at `stride`: the lane keeps the
// lower entry when `keep_low`.
__device__ __forceinline__ void cx_lanes(float& d, int& i, int stride, bool keep_low) {
  const float od = __shfl_xor_sync(FULL, d, stride);
  const int oi = __shfl_xor_sync(FULL, i, stride);
  if (keep_low ? better(od, oi, d, i) : better(d, i, od, oi)) {
    d = od;
    i = oi;
  }
}

// Sort 32 entries, one per lane, ascending.
__device__ __forceinline__ void sort32(float& d, int& i, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      cx_lanes(d, i, stride, ((lane & stride) == 0) == ((lane & size) == 0));
}

// Fold 32 sorted candidates (cd, ci) into the sorted list (ld, li) of 32 W
// entries: the lower of list[32 (W - 1) + lane] and candidates[31 - lane]
// (the list's other entries face padding) are the 32 W best of both and
// form a bitonic sequence, which a compare at stride 32 (inside a lane, at
// W = 2) and five steps across lanes sort.
template <int W>
__device__ __forceinline__ void merge_in(float (&ld)[W], int (&li)[W], float cd, int ci,
                                         int lane) {
  const float rd = __shfl_sync(FULL, cd, 31 - lane);
  const int ri = __shfl_sync(FULL, ci, 31 - lane);
  if (better(rd, ri, ld[W - 1], li[W - 1])) {
    ld[W - 1] = rd;
    li[W - 1] = ri;
  }
  if (W == 2 && better(ld[W - 1], li[W - 1], ld[0], li[0])) {
    const float td = ld[0];
    const int ti = li[0];
    ld[0] = ld[W - 1];
    li[0] = li[W - 1];
    ld[W - 1] = td;
    li[W - 1] = ti;
  }
#pragma unroll
  for (int w = 0; w < W; ++w)
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1)
      cx_lanes(ld[w], li[w], stride, (lane & stride) == 0);
}

// Insert one candidate that beats the list's kk-th entry: the entries from
// its position on move one place up (lane 0 of register w takes the last
// entry of register w - 1) and the last one drops.
template <int W>
__device__ __forceinline__ void insert(float (&ld)[W], int (&li)[W], float cd, int ci,
                                       int lane) {
  int pos = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) pos += __popc(__ballot_sync(FULL, better(ld[w], li[w], cd, ci)));
#pragma unroll
  for (int w = W - 1; w >= 0; --w) {
    float up_d = __shfl_up_sync(FULL, ld[w], 1);
    int up_i = __shfl_up_sync(FULL, li[w], 1);
    if (w > 0) {
      const float pd = __shfl_sync(FULL, ld[w > 0 ? w - 1 : 0], 31);
      const int pi = __shfl_sync(FULL, li[w > 0 ? w - 1 : 0], 31);
      if (lane == 0) {
        up_d = pd;
        up_i = pi;
      }
    }
    const int e = 32 * w + lane;
    if (e == pos) {
      ld[w] = cd;
      li[w] = ci;
    } else if (e > pos) {
      ld[w] = up_d;
      li[w] = up_i;
    }
  }
}

// The list's kk-th entry (entry kk - 1), shuffled to every lane.
template <int W>
__device__ __forceinline__ void kth(const float (&ld)[W], const int (&li)[W], int kk, float& d,
                                    int& i) {
  const bool hi = W > 1 && kk > 32;
  d = __shfl_sync(FULL, hi ? ld[W - 1] : ld[0], (kk - 1) & 31);
  i = __shfl_sync(FULL, hi ? li[W - 1] : li[0], (kk - 1) & 31);
}

// The block's shared state, carved from dynamic shared memory.
struct Smem {
  unsigned char* ring;  // [STAGES][RT][TD] codes
  float* bn_s;          // [STAGES][RT] bn of each unit's rows
  uint64_t* bars;       // [STAGES] the ring's mbarriers
  __nv_bfloat16* qs;    // [QG][QS] bf16 query residuals, permuted depth order
  float* sc;            // [QG][RT] survivor scores of the current unit
  float* ls_d;          // [QG][kk] lists (when a warp serves several queries)
  int* ls_i;
  unsigned* hist;       // kk > 64: [NWARPS][256] radix counters
  int* pcnt;            // kk > 64: [QG] keys in each query's pool
  uint8_t* sbits;       // [QG][8] survivor masks: bit r = unit row r
  float* qn;            // [QG] |q - c|^2
  float* thr;           // [QG] the list's kk-th score (the epilogue's bar)
  int* slot_of;         // [QG] the query's slot in qtab
  int* qid_of;          // [QG] the query's index in q
  unsigned* live_mask;  // [2] live slots of the group
};

// The copy ring. Unit u (row tile u / nch, depth chunk u % nch) lands in
// stage u % STAGES, whose mbarrier completes its (u / STAGES)-th phase when
// the unit is in. With TMA, warp 0 starts the unit as bulk copies: one of
// 64 x 128 bytes when rows are 128 bytes, else one per row, plus one for the
// tile's bn with its last chunk; rows past S are not copied (the epilogue
// drops them) and bytes past d meet zero query residuals. Otherwise (d not a
// multiple of 16, or unaligned tensors) every thread loads its share with
// plain loads and thread 0 arrives on the barrier itself; those stores are
// ordered by the block barriers between copy and use.
struct Ring {
  const int8_t* cbase;
  const float* bnc;
  unsigned char* ring;
  float* bn_s;
  uint32_t bars;
  int S, d, nch, units;
  bool tma;
  int u = 0, r0 = 0, ch = 0;  // the next unit to copy

  __device__ Ring(const Smem& sm, const int8_t* cb, const float* bb, int S_, int d_, int DP,
                  bool tma_)
      : cbase(cb), bnc(bb), ring(sm.ring), bn_s(sm.bn_s), bars(smem_u32(sm.bars)), S(S_),
        d(d_), nch((DP + TD - 1) / TD), units((S_ + RT - 1) / RT * ((DP + TD - 1) / TD)),
        tma(tma_) {}

  __device__ __forceinline__ void copy_next() {
    const int tid = threadIdx.x, lane = tid & 31;
    if (u < units) {
      const int stage = u % STAGES, d0 = ch * TD;
      const int rows = min(RT, S - r0), w = min(TD, d - d0);
      const bool last = ch == nch - 1;
      const uint32_t bar = bars + stage * 8;
      unsigned char* st = ring + stage * RT * TD;
      if (tma) {
        if (tid < 32) {
          if (lane == 0) mbar_expect_tx(bar, rows * w + (last ? rows * 4 : 0));
          __syncwarp();
          if (d == TD) {
            if (lane == 0) bulk_copy(smem_u32(st), cbase + (size_t)r0 * d, rows * d, bar);
          } else {
            for (int r = lane; r < rows; r += 32)
              bulk_copy(smem_u32(st + r * TD), cbase + (size_t)(r0 + r) * d + d0, w, bar);
          }
          if (last && lane == 0) bulk_copy(smem_u32(bn_s + stage * RT), bnc + r0, rows * 4, bar);
        }
      } else {
        for (int e = tid; e < RT * TD / 4; e += THREADS) {
          const int row = e / (TD / 4), col = d0 + 4 * (e % (TD / 4));
          uint32_t v = 0;
          if (row < rows)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              if (col + b < d) v |= (uint32_t)(uint8_t)cbase[(size_t)(r0 + row) * d + col + b] << (8 * b);
          *reinterpret_cast<uint32_t*>(st + 4 * e) = v;
        }
        if (last && tid < RT) bn_s[stage * RT + tid] = tid < rows ? bnc[r0 + tid] : INFINITY;
        if (tid == 0) mbar_arrive(bar);
      }
    }
    ++u;
    if (++ch == nch) {
      ch = 0;
      r0 += RT;
    }
  }

  __device__ __forceinline__ void wait(int unit) const {
    mbar_wait(bars + (unit % STAGES) * 8, (unit / STAGES) & 1);
  }
};

// Fold query m's survivors of one unit (mask bit r = row r0 + r) into its
// sorted list (ld, li) of 32 W entries, W per lane; (th_d, th_i) is the
// list's kk-th entry. A half with many survivors is bitonic-sorted and
// merged in one step; a sparse half inserts them one at a time. Inserts are
// tested against the bar as it stood before the half, so a candidate may
// land past kk, which leaves the first kk entries exact.
template <int W>
__device__ __forceinline__ void fold(float (&ld)[W], int (&li)[W], float& th_d, int& th_i,
                                     unsigned long long mask, const float* scm, int r0,
                                     int kk, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    unsigned hm = (unsigned)(mask >> (32 * half));
    if (!hm) continue;
    const int base = 32 * half;
    if (__popc(hm) > SORT_MIN) {
      const bool in = (hm >> lane) & 1u;
      float cd = in ? scm[base + lane] : INFINITY;
      int ci = in ? r0 + base + lane : -1;
      sort32(cd, ci, lane);
      merge_in(ld, li, cd, ci, lane);
    } else {
      do {
        const int r = __ffs(hm) - 1;
        hm &= hm - 1;
        const float cd = scm[base + r];
        const int ci = r0 + base + r;
        if (!better(cd, ci, th_d, th_i)) continue;  // warp-uniform
        insert(ld, li, cd, ci, lane);
      } while (hm);
    }
    kth(ld, li, kk, th_d, th_i);
  }
}

// The unit loop of one block, for MT query tiles of 16 and lists of 32 W
// entries. ONE: at most 8 live queries, warp w < nq owns query w and keeps
// its list in registers for the whole scan; otherwise warp w serves queries
// w, w + 8, ... with their lists in shared memory between units.
template <int MT, bool ONE, int W>
__device__ __forceinline__ void scan_units(const Smem& sm, Ring& ring, float scl, int S,
                                           int DP, int QS, int nq, int kk, float (&my_ld)[W],
                                           int (&my_li)[W]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int nch = ring.nch, units = ring.units;
  // This lane's B operand: 16 bytes of code row warp * 8 + g per 64-byte block.
  const int b_off = (warp * 8 + g) * TD + 16 * tg;
  const uint32_t a_base = smem_u32(sm.qs + (lane & 15) * QS + ((lane >> 4) << 3));
  float th_d = INFINITY;  // ONE: this warp's query's bar
  int th_i = -1;
  float acc[MT][4];
  int ch = 0, r0 = 0;

#pragma unroll 1
  for (int u = 0; u < units; ++u) {
    ring.wait(u);
    __syncthreads();  // the stage read two units ago is free; lists and bars are current
    ring.copy_next();
    const int stage = u % STAGES, d0 = ch * TD;
    if (ch == 0) {
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[t][j] = 0.f;
    }

    // The product: 64-byte blocks of this unit's depth, four k16 steps each.
    const unsigned char* st = sm.ring + stage * RT * TD + b_off;
    const int nb = min(TD, DP - d0) / 64;
#pragma unroll
    for (int b = 0; b < TD / 64; ++b) {
      if (b < nb) {
        const uint4 raw = *reinterpret_cast<const uint4*>(st + 64 * b);
        const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          uint32_t b0, b1;
          codes_bf16(words[s], b0, b1);
          const uint32_t a_addr = a_base + (uint32_t)(d0 + 64 * b + 16 * s) * 2;
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            uint32_t a0, a1, a2, a3;
            ldmatrix_x4(a0, a1, a2, a3, a_addr + (uint32_t)(t * 16 * QS) * 2);
            mma_bf16(acc[t], a0, a1, a2, a3, b0, b1);
          }
        }
      }
    }
    if (++ch < nch) continue;
    ch = 0;

    // Epilogue: c0, c1 are query 16 t + g at rows 2 tg, 2 tg + 1 of the
    // warp's 8; c2, c3 query 16 t + g + 8. Survivors go to shared memory and
    // set their bit (row = bit index) in the query's 64-bit mask.
    float bnr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = warp * 8 + 2 * tg + j;
      bnr[j] = r0 + r < S ? sm.bn_s[stage * RT + r] : INFINITY;
    }
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int h = 0; h < (ONE ? 1 : 2); ++h) {
        const int m = 16 * t + g + 8 * h;
        const bool live = m < nq;
        const float th = live ? sm.thr[m] : 0.f, qnm = live ? sm.qn[m] : 0.f;
        unsigned bits = 0;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float s = qnm + bnr[j] - 2.f * (scl * acc[t][2 * h + j]);
          if (live && s < th && s < BIG && s > -INFINITY) {  // s < th rules out NaN
            sm.sc[m * RT + warp * 8 + 2 * tg + j] = s;
            bits |= 1u << (2 * tg + j);
          }
        }
        bits |= __shfl_xor_sync(FULL, bits, 1);
        bits |= __shfl_xor_sync(FULL, bits, 2);
        if (tg == 0) sm.sbits[m * 8 + warp] = (uint8_t)bits;
      }
    __syncthreads();

    // Selection.
    if (ONE) {
      if (warp < nq) {
        const unsigned long long mask =
            *reinterpret_cast<const unsigned long long*>(sm.sbits + warp * 8);
        if (mask) {
          fold(my_ld, my_li, th_d, th_i, mask, sm.sc + warp * RT, r0, kk, lane);
          if (lane == 0) sm.thr[warp] = th_d;
        }
      }
    } else {
      for (int m = warp; m < nq; m += NWARPS) {
        const unsigned long long mask =
            *reinterpret_cast<const unsigned long long*>(sm.sbits + m * 8);
        if (!mask) continue;
        // Entries past kk are not kept between units: +inf, as if empty.
        float ld[W];
        int li[W];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const int e = 32 * w + lane;
          ld[w] = e < kk ? sm.ls_d[m * kk + e] : INFINITY;
          li[w] = e < kk ? sm.ls_i[m * kk + e] : -1;
        }
        float md;
        int mi;
        kth(ld, li, kk, md, mi);
        fold(ld, li, md, mi, mask, sm.sc + m * RT, r0, kk, lane);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const int e = 32 * w + lane;
          if (e < kk) {
            sm.ls_d[m * kk + e] = ld[w];
            sm.ls_i[m * kk + e] = li[w];
          }
        }
        if (lane == 0) sm.thr[m] = md;
      }
    }
    r0 += RT;
    // The next unit's __syncthreads orders these lists and bars before the
    // next epilogue reads them.
  }
}

// The unit loop of kk > 64 for MT query tiles of 16: the same copies,
// product and epilogue as scan_units, then warp w appends the survivors of
// queries w, w + 8, ... to their pools (pool row c * qcap + slot, keys of
// score and column) and shrinks a pool that the next unit could overflow
// (more than cap - 64 keys) to at most (kk + cap) / 2, its bound the
// query's new bar. cap >= kk + 128, or cap = S, which holds every slot.
template <int MT>
__device__ __forceinline__ void scan_units_pooled(const Smem& sm, Ring& ring, float scl, int S,
                                                  int DP, int QS, int nq, int kk,
                                                  unsigned long long* pools, int cap) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int nch = ring.nch, units = ring.units;
  const int b_off = (warp * 8 + g) * TD + 16 * tg;
  const uint32_t a_base = smem_u32(sm.qs + (lane & 15) * QS + ((lane >> 4) << 3));
  const int limit = (kk + cap) / 2;
  float acc[MT][4];
  int ch = 0, r0 = 0;

#pragma unroll 1
  for (int u = 0; u < units; ++u) {
    ring.wait(u);
    __syncthreads();  // the stage read two units ago is free; pools and bars are current
    ring.copy_next();
    const int stage = u % STAGES, d0 = ch * TD;
    if (ch == 0) {
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[t][j] = 0.f;
    }
    const unsigned char* st = sm.ring + stage * RT * TD + b_off;
    const int nb = min(TD, DP - d0) / 64;
#pragma unroll
    for (int b = 0; b < TD / 64; ++b) {
      if (b < nb) {
        const uint4 raw = *reinterpret_cast<const uint4*>(st + 64 * b);
        const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          uint32_t b0, b1;
          codes_bf16(words[s], b0, b1);
          const uint32_t a_addr = a_base + (uint32_t)(d0 + 64 * b + 16 * s) * 2;
#pragma unroll
          for (int t = 0; t < MT; ++t) {
            uint32_t a0, a1, a2, a3;
            ldmatrix_x4(a0, a1, a2, a3, a_addr + (uint32_t)(t * 16 * QS) * 2);
            mma_bf16(acc[t], a0, a1, a2, a3, b0, b1);
          }
        }
      }
    }
    if (++ch < nch) continue;
    ch = 0;

    float bnr[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = warp * 8 + 2 * tg + j;
      bnr[j] = r0 + r < S ? sm.bn_s[stage * RT + r] : INFINITY;
    }
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * t + g + 8 * h;
        const bool live = m < nq;
        const float th = live ? sm.thr[m] : 0.f, qnm = live ? sm.qn[m] : 0.f;
        unsigned bits = 0;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float s = qnm + bnr[j] - 2.f * (scl * acc[t][2 * h + j]);
          if (live && s < th && s < BIG && s > -INFINITY) {
            sm.sc[m * RT + warp * 8 + 2 * tg + j] = s;
            bits |= 1u << (2 * tg + j);
          }
        }
        bits |= __shfl_xor_sync(FULL, bits, 1);
        bits |= __shfl_xor_sync(FULL, bits, 2);
        if (tg == 0) sm.sbits[m * 8 + warp] = (uint8_t)bits;
      }
    __syncthreads();

    for (int m = warp; m < nq; m += NWARPS) {
      const unsigned long long mask =
          *reinterpret_cast<const unsigned long long*>(sm.sbits + m * 8);
      if (!mask) continue;
      unsigned long long* p = pools + (size_t)sm.slot_of[m] * cap;
      int n = sm.pcnt[m];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const unsigned hm = (unsigned)(mask >> (32 * half));
        if ((hm >> lane) & 1u)
          p[n + __popc(hm & ((1u << lane) - 1))] =
              wsel::ckey(sm.sc[m * RT + 32 * half + lane], r0 + 32 * half + lane);
        n += __popc(hm);
      }
      __syncwarp();
      if (n > cap - RT && n > limit) {
        float t;
        n = wsel::warp_compact_pool(p, n, kk, cap, sm.hist + warp * wsel::BINS, lane, t);
        if (lane == 0) sm.thr[m] = t;
      }
      if (lane == 0) sm.pcnt[m] = n;
      __syncwarp();
    }
    r0 += RT;
  }
}

// The unit loop at the block's query-tile count, then the register lists
// (one query a warp) to shared memory.
template <int W>
__device__ __forceinline__ void scan_block(const Smem& sm, Ring& ring, float scl, int S, int DP,
                                           int QS, int nq, int kk) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mt = (nq + 15) >> 4;  // query tiles of 16
  float my_ld[W];  // the one-query-per-warp mode's list entries
  int my_li[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    my_ld[w] = INFINITY;
    my_li[w] = -1;
  }
  const bool one = nq <= NWARPS;
  if (one)
    scan_units<1, true, W>(sm, ring, scl, S, DP, QS, nq, kk, my_ld, my_li);
  else if (mt == 1)
    scan_units<1, false, W>(sm, ring, scl, S, DP, QS, nq, kk, my_ld, my_li);
  else if (mt == 2)
    scan_units<2, false, W>(sm, ring, scl, S, DP, QS, nq, kk, my_ld, my_li);
  else if (mt == 3)
    scan_units<3, false, W>(sm, ring, scl, S, DP, QS, nq, kk, my_ld, my_li);
  else
    scan_units<4, false, W>(sm, ring, scl, S, DP, QS, nq, kk, my_ld, my_li);
  if (one && warp < nq)
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int e = 32 * w + lane;
      if (e < kk) {
        sm.ls_d[warp * kk + e] = my_ld[w];
        sm.ls_i[warp * kk + e] = my_li[w];
      }
    }
}

// Block b scans query group b % ngroups of cluster b / ngroups.
// MINB: the blocks an SM should hold, which caps the registers a thread
// may use: 4 where shared memory lets 4 blocks share an SM, else 3 (more
// registers, fewer spills). W: list entries a lane (kk <= 32 W); each W is
// its own build, so the two-entry lists cost the one-entry path nothing.
// W = 0 is kk > 64: the block writes each live slot's pool (pool rows
// c * qcap + slot of pool_cap keys) and its count in pool_n (0 for the
// group's empty slots), and wsel::finish_rows writes out_d / out_i.
template <int MINB, int W>
__global__ void __launch_bounds__(THREADS, MINB)
coded_scan_kernel(const float* __restrict__ q, const int* __restrict__ qtab,
                  const int8_t* __restrict__ codes, const float* __restrict__ bn,
                  const float* __restrict__ scale, const float* __restrict__ cent,
                  int ngroups, int B, int qcap, int S, int d, int kk, Layout lay,
                  unsigned long long* __restrict__ pool, int* __restrict__ pool_n, int pool_cap,
                  float* __restrict__ out_d, int* __restrict__ out_i) {
  const int DP = lay.dp, QS = lay.qs, QG = lay.qg;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem sm;
  sm.ring = smem;
  sm.bn_s = reinterpret_cast<float*>(sm.ring + STAGES * RT * TD);
  sm.bars = reinterpret_cast<uint64_t*>(sm.bn_s + STAGES * RT);
  sm.qs = reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<unsigned char*>(sm.bars) + BARS);
  sm.sc = reinterpret_cast<float*>(sm.qs + (size_t)QG * QS);
  if constexpr (W == 0) {
    sm.hist = reinterpret_cast<unsigned*>(sm.sc + QG * RT);
    sm.pcnt = reinterpret_cast<int*>(sm.hist + NWARPS * wsel::BINS);
    sm.sbits = reinterpret_cast<uint8_t*>(sm.pcnt + QG);
  } else {
    sm.ls_d = sm.sc + QG * RT;
    sm.ls_i = reinterpret_cast<int*>(sm.ls_d + QG * kk);
    sm.sbits = reinterpret_cast<uint8_t*>(sm.ls_i + QG * kk);
  }
  sm.qn = reinterpret_cast<float*>(sm.sbits + QG * 8);
  sm.thr = sm.qn + QG;
  sm.slot_of = reinterpret_cast<int*>(sm.thr + QG);
  sm.qid_of = sm.slot_of + QG;
  sm.live_mask = reinterpret_cast<unsigned*>(sm.qid_of + QG);

  const int c = blockIdx.x / ngroups;
  const int slot0 = (blockIdx.x % ngroups) * QG;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Compact the group's live slots, keeping slot order.
  const int my_slot = slot0 + tid;
  int my_q = B;
  if (tid < QG && my_slot < qcap) my_q = qtab[(size_t)c * qcap + my_slot];
  const bool my_live = tid < QG && my_q >= 0 && my_q < B;
  if (warp < 2) {
    const unsigned m = __ballot_sync(FULL, my_live);
    if (lane == 0) sm.live_mask[warp] = m;
  }
  if (tid < STAGES) mbar_init(smem_u32(sm.bars + tid), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  if (my_live) {
    const int rank = __popc(sm.live_mask[warp] & ((1u << lane) - 1)) +
                     (warp ? __popc(sm.live_mask[0]) : 0);
    sm.slot_of[rank] = my_slot;
    sm.qid_of[rank] = my_q;
  }
  const int nq = __popc(sm.live_mask[0]) + __popc(sm.live_mask[1]);
  // Empty slots of the group come back as (+inf, -1).
  auto write_empty = [&]() {
    if constexpr (W == 0) {
      for (int j = tid; j < QG; j += THREADS) {
        const bool live = (sm.live_mask[j >> 5] >> (j & 31)) & 1u;
        if (slot0 + j < qcap && !live) pool_n[(size_t)c * qcap + slot0 + j] = 0;
      }
      return;
    }
    for (int e = tid; e < QG * kk; e += THREADS) {
      const int j = e / kk, slot = slot0 + j;
      const bool live = (sm.live_mask[j >> 5] >> (j & 31)) & 1u;
      if (slot < qcap && !live) {
        const size_t o = ((size_t)c * qcap + slot) * kk + e % kk;
        out_d[o] = INFINITY;
        out_i[o] = -1;
      }
    }
  };
  if (nq == 0) {  // block-uniform: no code byte is read
    write_empty();
    return;
  }

  // The first units' copies fly while the queries are gathered.
  const bool tma = d % 16 == 0 && S % 4 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(bn) & 15) == 0;
  Ring ring(sm, codes + (size_t)c * S * d, bn + (size_t)c * S, S, d, DP, tma);
#pragma unroll 1
  for (int u = 0; u < STAGES - 1; ++u) ring.copy_next();
  write_empty();
  __syncthreads();  // slot_of, qid_of

  // Warp w centres queries w, w + 8, ...: bf16 residuals in permuted depth
  // order (zero past d and in the padding rows of the last query tile),
  // |q - c|^2 in f32; bars and lists start empty.
  const int mt = (nq + 15) >> 4;  // query tiles of 16
  const float* cc = cent + (size_t)c * d;
  for (int m = warp; m < mt * 16; m += NWARPS) {
    const bool live = m < nq;
    const float* qq = q + (size_t)(live ? sm.qid_of[m] : 0) * d;
    float s = 0.f;
    for (int p0 = 0; p0 < DP; p0 += 128) {  // four loads in flight per lane
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + 32 * i + lane;
        v[i] = live && p < d ? __ldg(qq + p) - __ldg(cc + p) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + 32 * i + lane;
        s = fmaf(v[i], v[i], s);
        if (p < DP) sm.qs[m * QS + qcol(p)] = __float2bfloat16(v[i]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if (live) {
      if constexpr (W == 0) {
        if (lane == 0) sm.pcnt[m] = 0;
      } else {
        for (int e = lane; e < kk; e += 32) {
          sm.ls_d[m * kk + e] = INFINITY;
          sm.ls_i[m * kk + e] = -1;
        }
      }
      if (lane == 0) {
        sm.qn[m] = s;
        sm.thr[m] = INFINITY;
      }
    }
  }

  if constexpr (W == 0) {
    unsigned long long* pools = pool + (size_t)c * qcap * pool_cap;
    const float scl = scale[c];
    if (mt == 1)
      scan_units_pooled<1>(sm, ring, scl, S, DP, QS, nq, kk, pools, pool_cap);
    else if (mt == 2)
      scan_units_pooled<2>(sm, ring, scl, S, DP, QS, nq, kk, pools, pool_cap);
    else if (mt == 3)
      scan_units_pooled<3>(sm, ring, scl, S, DP, QS, nq, kk, pools, pool_cap);
    else
      scan_units_pooled<4>(sm, ring, scl, S, DP, QS, nq, kk, pools, pool_cap);
    __syncthreads();
    for (int m = tid; m < nq; m += THREADS)
      pool_n[(size_t)c * qcap + sm.slot_of[m]] = sm.pcnt[m];
    return;
  } else {
    scan_block<W>(sm, ring, scale[c], S, DP, QS, nq, kk);
  }
  __syncthreads();

  for (int e = tid; e < nq * kk; e += THREADS) {
    const int m = e / kk, j = e % kk;
    const int li = sm.ls_i[m * kk + j];
    const size_t o = ((size_t)c * qcap + sm.slot_of[m]) * kk + j;
    out_d[o] = li >= 0 ? sm.ls_d[m * kk + j] : INFINITY;
    out_i[o] = li >= 0 ? li : -1;
  }
}

}  // namespace

// The pool entries of a (cluster, query slot) at kk > 64: wsel's pool for a
// list of kk, or S, which holds every slot (then no pool is ever compacted).
__host__ __device__ inline int pooled_cap(int S, int kk) {
  return S < wsel::pool_cap(kk) ? S : wsel::pool_cap(kk);
}

extern "C" {

// The launch layout of a (d, qcap, kk) over clusters of S slots: query
// slots per block, dynamic shared memory in bytes, and the pool entries of
// each (cluster, query slot) past kk = 64 (0 up to it). Host arithmetic only.
int vecgo_coded_group_scan_layout(int d, int qcap, int kk, int S, int* qg, int* smem,
                                  int* pool) {
  const Layout L = layout(d, qcap, kk);
  *qg = L.qg;
  *smem = (int)L.smem;
  *pool = kk > MAX_LIST_KK ? pooled_cap(S, kk) : 0;
  return 0;
}

// Lets the kernels use the current device's whole opt-in shared memory; the
// caller asks once per device. Returns a CUDA error code.
int vecgo_coded_group_scan_prepare(void) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const void* builds[] = {
      reinterpret_cast<const void*>(coded_scan_kernel<4, 1>),
      reinterpret_cast<const void*>(coded_scan_kernel<3, 1>),
      reinterpret_cast<const void*>(coded_scan_kernel<4, 2>),
      reinterpret_cast<const void*>(coded_scan_kernel<3, 2>),
      reinterpret_cast<const void*>(coded_scan_kernel<4, 0>),
      reinterpret_cast<const void*>(coded_scan_kernel<3, 0>),
      reinterpret_cast<const void*>(wsel::finish_rows)};
  for (const void* fn : builds)
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  return (int)e;
}

// q [B, d] f32; qtab [K, qcap] int32 (query index, B = empty slot); codes
// [K, S, d] int8; bn [K, S] f32 (+inf = padded or masked); scale [K] f32;
// cent [K, d] f32. Writes out_d [K, qcap, kk] f32 and out_i [K, qcap, kk]
// int32 (in-cluster column, -1 empty). 1 <= kk <= min(64, S);
// K * ceil(qcap / query slots) < 2^31; the layout's shared memory must fit
// the device (vecgo_coded_group_scan_prepare run on it). Returns the CUDA
// error code of the launch (0 on success).
int vecgo_coded_group_scan(const void* q, const void* qtab, const void* codes,
                           const void* bn, const void* scale, const void* cent,
                           int B, int K, int qcap, int S, int d, int kk,
                           void* out_d, void* out_i, void* stream) {
  const Layout L = layout(d, qcap, kk);
  const int ngroups = (qcap + L.qg - 1) / L.qg;
  // An SM has 228 KB of shared memory, 1 KB of it reserved per block.
  const bool four = 4 * (L.smem + 1024) <= 228 * 1024;
  auto kernel = kk > 32 ? (four ? coded_scan_kernel<4, 2> : coded_scan_kernel<3, 2>)
                        : (four ? coded_scan_kernel<4, 1> : coded_scan_kernel<3, 1>);
  kernel<<<(unsigned)K * ngroups, THREADS, L.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int*>(qtab),
      static_cast<const int8_t*>(codes), static_cast<const float*>(bn),
      static_cast<const float*>(scale), static_cast<const float*>(cent), ngroups, B, qcap, S,
      d, kk, L, nullptr, nullptr, 0, static_cast<float*>(out_d), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

// The same at 64 < kk <= S, with pool [K, qcap, pool entries] 64-bit and
// pool_n [K, qcap] int32 scratch (pool entries from the layout): the scan,
// then one finishing block per (cluster, query slot). Returns the CUDA
// error code of the launches (0 on success).
int vecgo_coded_group_scan_pooled(const void* q, const void* qtab, const void* codes,
                                  const void* bn, const void* scale, const void* cent,
                                  int B, int K, int qcap, int S, int d, int kk, void* pool,
                                  void* pool_n, void* out_d, void* out_i, void* stream) {
  const Layout L = layout(d, qcap, kk);
  const int ngroups = (qcap + L.qg - 1) / L.qg;
  const int cap = pooled_cap(S, kk);
  const bool four = 4 * (L.smem + 1024) <= 228 * 1024;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* pl = static_cast<unsigned long long*>(pool);
  int* pn = static_cast<int*>(pool_n);
  auto kernel = four ? coded_scan_kernel<4, 0> : coded_scan_kernel<3, 0>;
  kernel<<<(unsigned)K * ngroups, THREADS, L.smem, st>>>(
      static_cast<const float*>(q), static_cast<const int*>(qtab),
      static_cast<const int8_t*>(codes), static_cast<const float*>(bn),
      static_cast<const float*>(scale), static_cast<const float*>(cent), ngroups, B, qcap, S,
      d, kk, L, pl, pn, cap, nullptr, nullptr);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wsel::finish_rows<<<(unsigned)K * qcap, wsel::FIN_THREADS, wsel::fin_smem(kk, 1), st>>>(
      pl, pn, K * qcap, 1, cap, kk, static_cast<float*>(out_d), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // extern "C"
