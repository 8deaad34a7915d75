// Fused distance scan + running top-k for Hopper (sm_90a).
//
// Replaces: vecgo_tpu/ops/pallas_scan.py `pallas_l2_topk` (body `_scan_kernel`,
// helpers `_tile_topk` and `_merge_sorted_2k`). The TPU kernel walked the
// corpus tiles of one query tile in grid order and kept the running top-k in
// VMEM scratch. Here blocks run in parallel and in no order, so the corpus is
// split across blocks: block (query tile, split) scans its row range and keeps
// a pool of candidates per query; a second kernel selects and sorts each
// query's k from its splits' pools. Query tiles run along the grid's x dimension,
// so the blocks resident at one time share a split's rows and read them from
// L2.
//
// Five products, chosen by `vecgo_scan_topk_plan` from the table type, d, k
// and the table's alignment (no option picks one):
//
// * The short product (bf16 tables TMA can read, d <= 256, k <= 1024: the flat
//   segment's pool scan, compact-gather and masked scans, every decoded
//   block and probed partition, the vector half of hybrid search). At
//   B = 4096, N = 1M, d = 128 the scan is 1.1 TFLOP against a 256 MB table,
//   so the tensor cores bound it (1.11 ms); what the earlier tile product
//   spent its time on was the score pass (about 4.3e9 scores), not the
//   product. Here the queries are rounded to bf16 once (a first pass, which
//   also takes |q|^2) and the block's query tile is loaded by TMA into
//   shared memory for the whole unit; corpus tiles of 128 rows come through
//   a TMA ring fed by one producer warp, which also stores each tile's row
//   terms (|x|^2, the mask and the padding folded into one float) in shared
//   memory. Three consumer warpgroups (two past d = 192 or k = 64) each run
//   wgmma m64n128k16 for 64 queries and take turns at the tensor cores, so
//   the others score while one's product runs. The fast test costs an FMA and a compare a score (|q|^2 folded
//   into the threshold); a warp votes before any pool work and skips a pass
//   none of its 16 queries' rows survive; the few that do score exactly and
//   push. A compaction's threshold is published to a bound that the query's
//   splits share (any split's pool threshold bounds the k-th score over all
//   rows). Blocks are persistent and walk (query tile, split) units. With
//   the score pass skipped the kernel runs at its product bound; what is
//   left is the score pass (PERF.md).
// * The tile product (bf16 tables TMA cannot read: d not a multiple of 8, or
//   a row pointer not 16-byte aligned, such as a view that starts mid-row;
//   and pools past k = 1024 up to d = 128).
//   64 queries x 64 rows a tile, mma.sync m16n8k16, the query tile rounded
//   to bf16 once and resident while it fits (else its depth chunks ride
//   beside the corpus), corpus chunks staged through registers with element
//   loads where rows are unaligned.
// * The deep product (bf16 tables past d = 256, and pools past k = 1024
//   past d = 128: the device BM25 sweep at d = 4096, 3,072-d and 1,536-d
//   embeddings). There a tile is 24-64 depth
//   chunks and the product is the work: B 4096 x N 1M x d 4096 is 35 TFLOP,
//   35.6 ms on the tensor cores, against 8.6 GB of table (2.6 ms). What
//   bounds a block is feeding the tensor cores from L2: every query tile
//   re-reads the whole table, so the tile is large (128 queries x 256 rows:
//   87 flop per staged byte), and the operands come in by TMA. The queries
//   are rounded to bf16 once per call into a scratch (a first pass, which
//   also takes |q|^2), so the main loop never touches f32 queries. One
//   producer thread streams 128 x 64 query and 256 x 64 corpus chunks
//   (128-byte swizzled, the layout wgmma reads) through a ring of three stages
//   onto mbarriers; two consumer warpgroups each run wgmma m64n256k16 for 64
//   queries, with the 128 accumulators a thread holds in registers across
//   all d / 16 steps, and release a stage as soon as its products retire.
//   Selection runs once a tile on the accumulator fragments, in four passes
//   of 64 rows so that a pass adds at most 64 candidates a query, and each
//   warp compacts the pools of the 16 queries whose rows it holds, so selection needs no
//   block barrier. Measured, it runs near a third of the bound;
//   sharing each corpus chunk between two blocks of a cluster (TMA
//   multicast, half the bytes from L2) measured slower (PERF.md).
// * The f32 product (f32 tables TMA can read, d % 4 == 0 and 16-byte aligned
//   rows: the memtable chunks, ShardedFlat, streamed decodes, f32 tables).
//   The JAX package scans f32 at Precision.HIGH (a 3-pass bf16 product on
//   the TPU's matrix unit, not fp32-class); here fp32-class accuracy comes
//   from a split-precision product on the tensor cores: each operand in a
//   tf32 high part and a low part, hi.hi + lo.hi + hi.lo on wgmma
//   m64n128k8 (tf32), the small terms summed before the large one. The
//   tensor cores ignore an f32 operand's low 13 bits, so a raw row is its
//   own high part and only its low part, rna(x - trunc(x)), is formed: three
//   splitter warps write it beside each ring stage once TMA landed it. The
//   queries split once in a first pass (hi = rna(q), lo = rna(q - hi), and
//   |q|^2). B 4096 x N 1M x d 128 is three passes of 1.1 TFLOP at 495
//   TFLOP/s (6.7 ms) against the FMA units' 16.4 ms for one. The tensor
//   cores truncate their f32 sums at each step, so each 32-deep chunk's sum
//   starts from zero and joins the tile's total in registers (round to
//   nearest): the scores land nearer the float64 answer than an IEEE fp32
//   sum's (PERF.md). What a staged chunk costs (its TMA landing, its split
//   into low parts, a multiplier's turn from issue to add) is about three
//   times its tensor work for 64 queries (PERF.md), so each staged chunk
//   and its low parts serve 128 queries: two consumer
//   warpgroups of 64 (resident, or streamed chunk by chunk past d 96) read
//   every stage of 128-row tiles that come chunk by chunk through a TMA ring
//   fed by one producer warp, and each scores its own tile from registers
//   as the short product does (fast test, vote, a bound the splits share,
//   persistent blocks) while the other's products run. A warpgroup whose queries all lie past
//   B multiplies nothing. The producer's warpgroup gives the consumers
//   registers (setmaxnreg: 56 and 224 a thread, no spill at either).
// * The FMA f32 product (f32 tables TMA cannot read: d % 4 != 0, such as
//   GloVe's 25 and 50, or a view that starts mid-row). IEEE fp32 on the
//   FMA units: the 128-query tile stays resident in shared memory for the
//   whole scan where it fits (d up to ~170 at small k; past that its depth
//   chunks ride the ring beside the corpus, each loaded once a tile), corpus
//   chunks of 128 rows x 32 depth stream through a three-stage cp.async
//   ring, and each thread keeps an 8 x 8 register micro-tile fed by 16-byte
//   shared loads (16 loads per 256 FMAs, each a broadcast across the warp).
//   Each warp holds all 128 rows of its 16 queries and selects in two passes
//   of 64 rows, so selection needs no block barrier either.
//
// Selection is the same for all five, and no thread inserts serially. Scores
// are formed in registers from the accumulators (a row term carries |x|^2,
// the mask and the padding as +inf), each thread tests them against its
// query's threshold (in shared memory) and survivors go to the query's pool
// in a global scratch through one shared atomic per (thread, query)
// (select_wide.cuh; any k <= N). Each (query, split) keeps an unsorted pool
// of about 2k candidates, one 64-bit key each (score key above row id). When
// the next tile (or pass) could overflow a pool, its query's warp shrinks it
// in place to between k and 1.5k entries by a radix select (a bound guessed
// from 256 samples and counted, for pools of 4,096 and more) and the
// greatest kept score becomes the threshold. The scan writes only the pools'
// counts; one block per query then keeps the best of all its splits' pools,
// sorts them in shared memory and writes the first k (`finish_rows`), so
// there is no split merge of its own. Thresholds tighten as the scan goes, so
// it costs O(candidates) pool traffic. It measured faster at every k in
// every product than sorted lists (in shared memory up to k = 256, in global
// memory past it; PERF.md).

// Scores are smaller-is-better: l2 = |q|^2 + |x|^2 - 2 q.x, dot = -q.x,
// cos = 1 - q.x over normalized storage. Ties order by the lower row id, as
// `lax.top_k` does. Masked, padded and non-finite rows never enter a list;
// empty slots come back as (+inf, -1).

#include <cuda.h>  // CUtensorMap; its encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "select_wide.cuh"

namespace {

constexpr int THREADS = 256;  // 8 warps (tile and FMA f32 products)
constexpr int TQ = 64;        // queries per block (tile product)
constexpr int TN = 64;        // corpus rows per tile (tile product)
// Tile product: two stages of TN rows x TD depth.
constexpr int TD = 64;
constexpr int LDT = TD + 8;  // padded chunk row (bf16): conflict-free ldmatrix
constexpr unsigned FULL = 0xffffffffu;

// Deep product: 128 queries (two consumer warpgroups of 64) x 256 rows a
// tile, 64-deep stages.
constexpr int DQ = 128;
constexpr int DN = 256;
constexpr int DK = 64;                     // 128 bytes of bf16: one swizzled row
constexpr int DTHREADS = 288;              // two consumer warpgroups + a producer warp
constexpr int DA_BYTES = DQ * DK * 2;      // 16 KB of queries a stage
constexpr int DSTAGE = DA_BYTES + DN * DK * 2;  // + 32 KB of corpus
constexpr int DPASS = 64;                  // tile rows one selection pass scores
// The ring: three stages measured faster than four (BM25 rows at d = 4096
// by a third, dense rows the same within the spread, PERF.md).
constexpr int DSTAGES = 3;

// Short product: 64 resident queries a consumer warpgroup (NWG of them:
// three up to d = 192 and k = 64, else two) x 128 rows a tile; the query
// tile is nch = ceil(d / 64) chunks of 64 NWG rows x 64 bf16, a stage nch
// chunks of 128 rows x 64 bf16 (16 KB each), and the ring takes as many
// stages (up to four) as fit beside the queries in SRING bytes.
constexpr int SN = 128;
constexpr int SCHUNK = SN * DK * 2;
constexpr int SMAX_CH = 4;  // d <= 256
constexpr int SMAX_WG = 3;
constexpr int SRING = 12 * SCHUNK;
constexpr int SMAX_STAGES = 4;
constexpr int STERMS = 8;  // row-term slots (>= stages + 2)
constexpr int SPASS = 64;  // tile rows one selection pass scores
// Consumer warpgroups of the short product at nch depth chunks and pool k:
// three while two ring stages fit beside the 192-row query tile and k is at
// most SHORT_WG3_MAX_K, else two (where most passes run the rare path, the
// two-warpgroup build, with 168 registers a thread against 128, measured
// as fast at k 64 and faster from k 82; scripts/torch_scan_profile.py,
// PERF.md).
constexpr int SHORT_WG3_MAX_K = 64;
__host__ __device__ constexpr int short_wgs(int nch, int k) {
  return nch <= 3 && k <= SHORT_WG3_MAX_K ? 3 : 2;
}
__host__ __device__ constexpr int short_stages(int nch, int nwg) {
  return (SRING - nch * 64 * nwg * DK * 2) / (nch * SCHUNK) < SMAX_STAGES
             ? (SRING - nch * 64 * nwg * DK * 2) / (nch * SCHUNK)
             : SMAX_STAGES;
}
static_assert(STERMS >= SMAX_STAGES + 2, "row terms outlive their stage");
// bf16 tables that TMA can read take the short product up to this depth and
// this k (it measured faster than the deep and tile products at every d <=
// 256 and k <= 1000 of the sweep in scripts/torch_scan_ab.py, and slower
// than the tile product at k 4096 over 65,536 rows, where each split's
// pool holds half its rows; PERF.md). Past them the earlier rule: the tile
// product up to TILE_MAX_D, the deep product past it.
constexpr int SHORT_MAX_D = 256;
constexpr int SHORT_MAX_K = 1024;
constexpr int TILE_MAX_D = 128;

// FMA f32 product (f32 rows TMA cannot read): 128 queries x 128 rows a
// tile, 32-deep stages.
constexpr int FQ = 128;
constexpr int FN = 128;
constexpr int FK = 32;
constexpr int FLD = FK + 4;  // padded stage row (floats): conflict-free 16-byte reads
constexpr int FSTAGES = 3;

// Split f32 product: 128 queries (two consumer warpgroups of 64) x 128 rows
// a tile; a ring stage is one 32-deep chunk of the tile (128 bytes of f32 a
// row: one 128-byte swizzled row), its raw rows and their low parts, plus
// (queries streamed) the chunk's query high and low parts. The queries and
// the ring share XBUF bytes.
constexpr int XQ = 128;
constexpr int XN = 128;
constexpr int XK = 32;
// Warpgroups 0 and 1 multiply and score, 2 is the producer warp and 3
// splitter warps.
constexpr int XTHREADS = 384;
constexpr int XSPLITTERS = 3;
// 16-byte groups of a stage a splitter thread loads before it writes their
// low parts, so that their shared-memory reads overlap.
constexpr int XSPLIT_BATCH = 4;
constexpr int XQCHUNK = XQ * XK * 4;        // 16 KB: one part of 128 queries x 32
constexpr int XCHUNK = XN * XK * 4;         // 16 KB: 128 rows x 32
constexpr int XBUF = 208 * 1024;
constexpr int XMAX_STAGES = 5;
// Row-term slots: the producer runs up to `stages` chunks ahead of the
// oldest stage a warpgroup has not released, and a warpgroup releases the
// next tile's first chunk only after scoring its tile.
constexpr int XSTERMS = 8;
static_assert(XSTERMS >= XMAX_STAGES + 2, "row terms outlive their tile's scoring");
// Ring stages beside the queries: resident (both parts of every chunk of
// the 128-query tile, nch chunks) while three stages fit, else streamed.
__host__ __device__ constexpr int split_stages(int nch, int resident) {
  return resident ? ((XBUF - 2 * nch * XQCHUNK) / (2 * XCHUNK) < XMAX_STAGES
                         ? (XBUF - 2 * nch * XQCHUNK) / (2 * XCHUNK)
                         : XMAX_STAGES)
                  : XBUF / (2 * XCHUNK + 2 * XQCHUNK);
}
__host__ __device__ constexpr int split_resident(int nch) {
  return (XBUF - 2 * nch * XQCHUNK) / (2 * XCHUNK) >= 3;
}

enum Metric { kL2 = 0, kDot = 1, kCos = 2 };
enum Product { kTile = 0, kDeep = 1, kF32Fma = 2, kShort = 3, kF32 = 4 };
// The plan's fields (vecgo_scan_topk_plan's out array).
enum PlanField { P_PRODUCT, P_TQ, P_TN, P_RESIDENT, P_SMEM, P_BPS, P_POOL, P_FIELDS };
// A tensor map that could not be encoded (or no encoder to call).
constexpr int kEncodeFailed = 10001;

// Selection state of NQ queries (select_wide.cuh): thresholds, pool counts
// and each merging warp's 256 radix counters in shared memory; the unsorted
// pools of `cap` keys per query in a global scratch of their own.
template <int NQ>
struct Pools {
  float* thr;                // [NQ] score a candidate must beat (+inf until the first compaction)
  int* cnt;                  // [NQ] pooled candidates
  unsigned* hist;            // [merging warps][wsel::BINS]
  unsigned long long* pool;  // [NQ][cap] (global)
  int* pool_n;               // [NQ] counts for the finishing kernel (global)
  int k, cap;

  __device__ void init(int tid, int nthr) {
    for (int m = tid; m < NQ; m += nthr) {
      thr[m] = INFINITY;
      cnt[m] = 0;
    }
  }

  // Append one (thread, query)'s scores whose bits are set to the query's
  // pool; one shared atomic reserves the slots. row_of(j) is score j's row.
  template <int NS, class RowOf>
  __device__ __forceinline__ void push(int m, unsigned bits, const float (&s)[NS],
                                       RowOf row_of) {
    if (!bits) return;
    int pos = atomicAdd(&cnt[m], __popc(bits));
    unsigned long long* p = pool + (size_t)m * cap;
#pragma unroll
    for (int j = 0; j < NS; ++j)
      if (bits >> j & 1u) p[pos++] = wsel::ckey(s[j], row_of(j));
  }

  // One warp shrinks the pools of queries [m0, m0 + nq) that have no room
  // for `room` more candidates (cap >= k + 2 room, so each holds more than
  // the (k + cap) / 2 a compaction may keep).
  __device__ void merge_range(int m0, int nq, int room, int slot, int lane) {
    unsigned todo = __ballot_sync(FULL, lane < nq && cnt[m0 + lane] > cap - room);
    while (todo) {
      const int m = m0 + __ffs(todo) - 1;
      todo &= todo - 1;
      float t;
      const int n = wsel::warp_compact_pool(pool + (size_t)m * cap, cnt[m], k, cap,
                                            hist + slot * wsel::BINS, lane, t);
      __syncwarp();
      if (lane == 0) {
        thr[m] = t;
        cnt[m] = n;
      }
      __syncwarp();
    }
  }

  // After a tile of tn rows (all pushes done, a block barrier between): warp
  // w of 8 shrinks those of its NQ / 8 queries' pools that the next tile
  // could overflow.
  __device__ void merge_tile(int warp, int lane, int tn) {
    merge_range(warp * (NQ / 8), NQ / 8, tn, warp, lane);
  }

  // The pools' counts, for the finishing kernel, which selects from the
  // pools as they are.
  __device__ void write_out(int tid, int nthr) {
    for (int m = tid; m < NQ; m += nthr) pool_n[m] = cnt[m];
  }
};

// Shared memory of nq queries' selection state with nw merging warps.
__host__ __device__ constexpr size_t pools_bytes(int nq, int nw) {
  return (size_t)nq * 8 + (size_t)nw * wsel::BINS * 4;
}

// The selection state at p in shared memory, and `slot`'s pools (pool_cap
// entries each) and their counts in the global scratch.
template <int NQ>
__device__ __forceinline__ Pools<NQ> carve_pools(char* p, int k, size_t slot,
                                                 unsigned long long* pool, int* pool_n,
                                                 int pool_cap) {
  Pools<NQ> L;
  L.k = k;
  L.cap = pool_cap;
  L.thr = reinterpret_cast<float*>(p);
  L.cnt = reinterpret_cast<int*>(L.thr + NQ);
  L.hist = reinterpret_cast<unsigned*>(L.cnt + NQ);
  L.pool = pool + slot * NQ * pool_cap;
  L.pool_n = pool_n + slot * NQ;
  return L;
}

__device__ __forceinline__ size_t block_slot() {
  return (size_t)blockIdx.y * gridDim.x + blockIdx.x;
}

// The additive term of each of a thread's NS tile rows: |x|^2 for l2, 1 for
// cos, 0 for dot, and +inf for a masked or padded row. The loads are
// unconditional (rows clamped into the table) so they issue together.
template <int NS>
__device__ __forceinline__ void row_terms(const int (&row)[NS], int r_end, int N, int metric,
                                          const float* __restrict__ xnorm2,
                                          const uint8_t* __restrict__ mask,
                                          float (&xa)[NS]) {
  int rc[NS];
#pragma unroll
  for (int j = 0; j < NS; ++j) rc[j] = min(row[j], N - 1);
  if (metric == kL2) {
#pragma unroll
    for (int j = 0; j < NS; ++j) xa[j] = __ldg(xnorm2 + rc[j]);
  } else {
#pragma unroll
    for (int j = 0; j < NS; ++j) xa[j] = metric == kCos ? 1.f : 0.f;
  }
  if (mask != nullptr) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
      if (!__ldg(mask + rc[j])) xa[j] = INFINITY;
  }
#pragma unroll
  for (int j = 0; j < NS; ++j)
    if (row[j] >= r_end) xa[j] = INFINITY;
}

// Scores of one (thread, query) from its accumulators and row terms, the
// survivors' bits, and the push.
template <int NS, class L_t>
__device__ __forceinline__ void score_and_push(L_t& L, int m, bool live, float qn, int metric,
                                               const float (&p)[NS], const float (&xa)[NS],
                                               const int (&row)[NS]) {
  const float th = L.thr[m];
  const float qa = metric == kL2 ? qn : 0.f, pm = metric == kL2 ? 2.f : 1.f;
  float s[NS];
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    s[j] = qa + xa[j] - pm * p[j];
    if (isfinite(s[j]) && s[j] < th) bits |= 1u << j;
  }
  if (!live) bits = 0;
  L.push(m, bits, s, [&](int j) { return row[j]; });
}

__device__ __forceinline__ float query_norm(const float* __restrict__ q, int qi, int B, int d) {
  float s = 0.f;
  if (qi < B)
    for (int j = 0; j < d; ++j) {
      const float v = q[(size_t)qi * d + j];
      s = fmaf(v, v, s);
    }
  return s;
}

// |q|^2 of every query (f32, from the f32 rows) and, when qb is set, the
// rows rounded to bf16 once, zero-padded to dp columns: one warp a query.
// When bound is set, each query's shared bound starts as +inf's key.
__global__ void prep_queries_kernel(const float* __restrict__ q, int B, int d, int dp,
                                    __nv_bfloat16* __restrict__ qb, float* __restrict__ qn,
                                    unsigned* __restrict__ bound) {
  const int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (w >= B) return;
  if (bound != nullptr && lane == 0) bound[w] = wsel::fkey(INFINITY);
  const float* row = q + (size_t)w * d;
  float s = 0.f;
  for (int c = lane; c < dp; c += 32) {
    const float v = c < d ? row[c] : 0.f;
    s = fmaf(v, v, s);
    if (qb != nullptr) qb[(size_t)w * dp + c] = __float2bfloat16(v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane == 0) qn[w] = s;
}

// ---------------------------------------------------------------- async copies

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

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the barrier's phase with this parity has completed. A wait past
// 2^34 cycles (seconds: no copy takes that long) traps, so a broken ring
// fails the launch instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// One TMA tile copy global -> shared of the box at (column c0, row c1),
// completing on the barrier; out-of-range elements arrive as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Copy 4 floats src[0, n) to 16-byte aligned shared dst, zeros past n: one
// cp.async (vec: src 16-byte aligned, n 0 or 4) or element loads.
__device__ __forceinline__ void copy4(float* dst, const float* src, int n, bool vec) {
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n * 4) : "memory");
  } else {
    float4 v;
    v.x = n > 0 ? src[0] : 0.f;
    v.y = n > 1 ? src[1] : 0.f;
    v.z = n > 2 ? src[2] : 0.f;
    v.w = n > 3 ? src[3] : 0.f;
    *reinterpret_cast<float4*>(dst) = v;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------- tile product (bf16)

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3, uint32_t addr) {
  // The memory clobber keeps the compiler from moving the next stage's
  // shared-memory stores (and so the wait for their global loads) above
  // the product.
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
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

__host__ __device__ constexpr int pad_depth(int d) { return (d + 15) & ~15; }

__host__ __device__ constexpr size_t tile_smem(int resident, int d) {
  return (size_t)2 * (TN + (resident ? 0 : TQ)) * LDT * 2 +
         (resident ? (size_t)TQ * (pad_depth(d) + 8) * 2 : 0) + (size_t)(TQ + 2 * TN) * 4 +
         pools_bytes(TQ, 8);
}

// Warps: 4 along the queries (16 each) x 2 along the rows (32 each, four
// n8-tiles), so each thread holds 2 queries x 8 rows of every tile.
__global__ void __launch_bounds__(THREADS)
scan_tile_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ xnorm2, const uint8_t* __restrict__ mask,
                 int B, int N, int d, int k, int metric, int rows_per_split, int resident,
                 unsigned long long* pool, int* pool_n, int pool_cap) {
  constexpr int WQ = 4, NT = 4, NS = 2 * NT;
  extern __shared__ __align__(16) char smem[];
  const int DP = pad_depth(d), QS = DP + 8;
  const int stage_rows = TN + (resident ? 0 : TQ);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qs = ring + (size_t)2 * stage_rows * LDT;  // resident query
  float* qn = reinterpret_cast<float*>(qs + (resident ? (size_t)TQ * QS : 0));
  float* terms = qn + TQ;  // [2][TN] row terms of the current and next tile
  auto L = carve_pools<TQ>(reinterpret_cast<char*>(terms + 2 * TN), k, block_slot(), pool,
                           pool_n, pool_cap);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wq = warp % WQ, wn = warp / WQ;
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = blockIdx.x * TQ;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);
  const int n_chunks = (DP + TD - 1) / TD;
  const int units = (r_end - r_begin + TN - 1) / TN * n_chunks;
  const bool vec_ok = (d % 8 == 0) && ((reinterpret_cast<uintptr_t>(x) & 15) == 0);

  L.init(tid, THREADS);
  if (tid < TQ) qn[tid] = query_norm(q, q0 + tid, B, d);
  if (resident)
    for (int e = tid; e < TQ * DP; e += THREADS) {
      const int r = e / DP, c = e % DP, qi = q0 + r;
      qs[r * QS + c] = __float2bfloat16(qi < B && c < d ? q[(size_t)qi * d + c] : 0.f);
    }

  // Stage u % 2 holds depth chunk (u % n_chunks) of tile (u / n_chunks): TN
  // corpus rows, then (streaming) the TQ query rows, each LDT bf16 wide. The
  // next unit's corpus chunk is loaded into registers (two 16-byte loads a
  // thread) before this unit's product and stored after it, so the loads
  // are in flight during the product; rows that are not 16-byte aligned take
  // element loads at store time. With a tile's first chunk, threads < TN
  // also load their row's |x|^2 and mask byte; the store turns them into the
  // tile's row terms (+inf for masked and padded rows).
  struct Next {
    uint4 v[2];
    float xn;
    int keep;
  };
  auto gload = [&](int u, Next& nx) {
    const int row0 = r_begin + (u / n_chunks) * TN, d0 = (u % n_chunks) * TD;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = tid + i * THREADS, row = row0 + (p >> 3), c = d0 + (p & 7) * 8;
      nx.v[i] = make_uint4(0, 0, 0, 0);
      if (vec_ok && row < r_end && c < d)
        nx.v[i] = __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * d + c));
    }
    if (d0 == 0 && tid < TN) {
      const int row = min(row0 + tid, N - 1);
      nx.xn = metric == kL2 ? __ldg(xnorm2 + row) : metric == kCos ? 1.f : 0.f;
      nx.keep = mask == nullptr ? 1 : __ldg(mask + row);
    }
  };
  auto sstore = [&](int u, const Next& nx) {
    __nv_bfloat16* st = ring + (size_t)(u & 1) * stage_rows * LDT;
    const int row0 = r_begin + (u / n_chunks) * TN, d0 = (u % n_chunks) * TD;
    if (vec_ok) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = tid + i * THREADS;
        *reinterpret_cast<uint4*>(st + (p >> 3) * LDT + (p & 7) * 8) = nx.v[i];
      }
    } else {
      for (int e = tid; e < TN * TD; e += THREADS) {
        const int r = e / TD, c = e % TD, row = row0 + r;
        st[r * LDT + c] = (row < r_end && d0 + c < d) ? x[(size_t)row * d + d0 + c]
                                                       : __float2bfloat16(0.f);
      }
    }
    if (!resident) {
      __nv_bfloat16* sq = st + TN * LDT;
      for (int e = tid; e < TQ * TD; e += THREADS) {
        const int r = e / TD, c = e % TD, qi = q0 + r;
        sq[r * LDT + c] =
            __float2bfloat16(qi < B && d0 + c < d ? q[(size_t)qi * d + d0 + c] : 0.f);
      }
    }
    if (d0 == 0 && tid < TN)
      terms[((u / n_chunks) & 1) * TN + tid] =
          row0 + tid < r_end && nx.keep ? nx.xn : INFINITY;
  };

  Next next;
  gload(0, next);
  sstore(0, next);

  float acc[NT][4];
#pragma unroll 1
  for (int u = 0; u < units; ++u) {
    __syncthreads();
    const bool more = u + 1 < units;
    if (more) gload(u + 1, next);

    const int ch = u % n_chunks, d0 = ch * TD;
    if (ch == 0) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[t][j] = 0.f;
    }
    const bool last = ch == n_chunks - 1;

    const __nv_bfloat16* st = ring + (size_t)(u & 1) * stage_rows * LDT;
    const __nv_bfloat16* As = resident ? qs + d0 : st + TN * LDT;
    const int AS = resident ? QS : LDT;
    // ldmatrix row addresses: A rows (lane & 15), column half (lane >> 4);
    // B rows (lane & 7) + 8 * (lane >> 4), column half ((lane >> 3) & 1).
    const uint32_t a_addr =
        smem_u32(As + (wq * 16 + (lane & 15)) * AS + ((lane >> 4) << 3));
    const uint32_t b_addr = smem_u32(st + (wn * 32 + (lane & 7) + ((lane >> 4) << 3)) * LDT +
                                     (((lane >> 3) & 1) << 3));
    const int nks = min(TD, DP - d0) / 16;
#pragma unroll
    for (int ks = 0; ks < TD / 16; ++ks) {
      if (ks < nks) {
        uint32_t a0, a1, a2, a3;
        ldmatrix_x4(a0, a1, a2, a3, a_addr + ks * 32);
#pragma unroll
        for (int t = 0; t < NT; t += 2) {
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4(b0, b1, b2, b3, b_addr + (t * 8 * LDT + ks * 16) * 2);
          mma_bf16(acc[t], a0, a1, a2, a3, b0, b1);
          mma_bf16(acc[t + 1], a0, a1, a2, a3, b2, b3);
        }
      }
    }
    if (more) sstore(u + 1, next);
    if (!last) continue;

    // C fragment: c0, c1 are query g's columns 2 tg, 2 tg + 1; c2, c3 query
    // g + 8's. Column j of the thread's fragments is tile row nl[j].
    const int row0 = r_begin + (u / n_chunks) * TN;
    const float* tt = terms + ((u / n_chunks) & 1) * TN;
    int row[NS];
    float xa[NS];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int nl = wn * 32 + 8 * (j >> 1) + 2 * tg + (j & 1);
      row[j] = row0 + nl;
      xa[j] = tt[nl];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wq * 16 + g + 8 * h;
      float p[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) p[j] = acc[j >> 1][2 * h + (j & 1)];
      score_and_push(L, m, q0 + m < B, qn[m], metric, p, xa, row);
    }
    __syncthreads();
    L.merge_tile(warp, lane, TN);
    // The next unit's __syncthreads orders these merges before the next
    // tile's threshold reads and pool writes.
  }
  __syncthreads();
  L.write_out(tid, THREADS);
}

// ---------------------------------------------------------------- deep product (bf16)

// A wgmma operand of rows x 64 bf16 in shared memory as TMA's 128-byte
// swizzle lays it (1024-byte aligned groups of 8 rows): K-major, the
// leading offset unused, 1024 bytes between 8-row groups, swizzle 128B.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d[64 x 256] (+)= A[64 x 16] . B[256 x 16]^T, both K-major bf16 in shared
// memory; scale_d 0 overwrites d. Thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1):
// d[4 j + 2 h + e] is (row + 8 h, column 8 j + 2 (t % 4) + e).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
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
      "}, "
      "%128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, as wgmma_m64n256k16 with 16
// column blocks: d[4 j + 2 h + e] is (row + 8 h, column 8 j + 2 (t % 4) + e).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Pins accumulator registers to this point of the program: reads placed
// after it cannot be hoisted above a preceding wgmma wait.
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void wg_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// Shared memory of the deep product: the ring, its barriers, the row terms
// and two warpgroups' selection state, plus 1 KB to align the ring to the
// swizzle's 1024 bytes.
constexpr size_t DEEP_SMEM =
    1024 + (size_t)DSTAGES * DSTAGE + (size_t)DSTAGES * 16 + (size_t)2 * 2 * DN * 4 +
    2 * pools_bytes(64, 4);

// Warp 8 produces: its lane 0 issues every unit's two TMA copies (the
// 128 x 64 query chunk and the 256 x 64 corpus chunk of unit u = tile *
// n_chunks + chunk) into stage u % stages once both consumers released it.
// `stages` (DSTAGES) is a launch argument, not a constant: compiled with the
// ring's depth known, the kernel measured 3-12% slower (PERF.md).
// Warpgroups 0 and 1 consume: each multiplies its 64 queries by the 256
// rows, chunk by chunk, then scores the tile. Threads of a consumer hold
// queries 16 w + g and 16 w + g + 8 (warp w of 4, g = lane / 4), so warp w
// holds every row of its 16 queries: it pushes and merges them alone.
__global__ void __launch_bounds__(DTHREADS, 1)
scan_deep_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap xmap, const float* __restrict__ qn_g,
                 const float* __restrict__ xnorm2, const uint8_t* __restrict__ mask, int B,
                 int N, int d, int k, int metric, int rows_per_split, int stages,
                 unsigned long long* pool, int* pool_n, int pool_cap) {
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + (size_t)stages * DSTAGE);
  uint64_t* empty = full + stages;
  float* terms = reinterpret_cast<float*>(empty + stages);  // [2 consumers][2][DN]
  char* lists_p = reinterpret_cast<char*>(terms + 4 * DN);

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int q0 = blockIdx.x * DQ;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);
  const int n_chunks = (d + DK - 1) / DK;
  const int n_tiles = (r_end - r_begin + DN - 1) / DN;
  const int units = n_tiles * n_chunks;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    if (tid == 256) {
      int s = 0;
      uint32_t ph = 0;
      for (int u = 0; u < units; ++u) {
        mbar_wait(smem_u32(empty + s), ph ^ 1);
        const uint32_t bar = smem_u32(full + s);
        mbar_expect_tx(bar, DSTAGE);
        const uint32_t st = smem_u32(smem + (size_t)s * DSTAGE);
        const int c0 = (u % n_chunks) * DK, row0 = r_begin + (u / n_chunks) * DN;
        tma_load_2d(st, &qmap, c0, q0, bar);
        tma_load_2d(st + DA_BYTES, &xmap, c0, row0, bar);
        if (++s == stages) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  const int cw = wg, ctid = tid - 128 * wg, warp = ctid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  auto L = carve_pools<64>(lists_p + cw * pools_bytes(64, 4), k, block_slot() * 2 + cw, pool,
                           pool_n, pool_cap);
  L.init(ctid, 128);
  float* tt = terms + cw * 2 * DN;
  const int qw0 = q0 + 64 * cw;
  float qa[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qw0 + 16 * warp + g + 8 * h;
    live[h] = qi < B;
    qa[h] = metric == kL2 && live[h] ? qn_g[qi] : 0.f;
  }
  const float pm = metric == kL2 ? 2.f : 1.f;
  const float base_term = metric == kCos ? 1.f : 0.f;

  // Row terms: thread ctid loads rows ctid and ctid + 128 of a tile a tile
  // ahead (the loads fly during the product) and stores them after the
  // tile's barrier, into the buffer the barrier freed.
  float xv[2];
  int kv[2];
  auto load_terms = [&](int t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = min(r_begin + t * DN + ctid + 128 * i, N - 1);
      xv[i] = metric == kL2 ? __ldg(xnorm2 + row) : base_term;
      kv[i] = mask == nullptr ? 1 : __ldg(mask + row);
    }
  };
  auto store_terms = [&](int t) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ctid + 128 * i;
      tt[(t & 1) * DN + r] = r_begin + t * DN + r < r_end && kv[i] ? xv[i] : INFINITY;
    }
  };
  load_terms(0);
  store_terms(0);

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int s = 0, prev_s = 0;
  uint32_t ph = 0;
  const uint32_t a_off = cw * 64 * 128;  // this warpgroup's 64 query rows of a stage

#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_terms(t + 1);
#pragma unroll 1
    for (int c = 0; c < n_chunks; ++c) {
      mbar_wait(smem_u32(full + s), ph);
      const uint32_t st = smem_u32(smem + (size_t)s * DSTAGE);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk)
        wgmma_m64n256k16(acc, sw128_desc(st + a_off + kk * 32),
                         sw128_desc(st + DA_BYTES + kk * 32), c > 0 || kk > 0);
      wgmma_commit();
      if (c > 0) {  // the previous chunk's products have retired: free its stage
        wgmma_wait<1>();
        if (ctid == 0) mbar_arrive(smem_u32(empty + prev_s));
      }
      prev_s = s;
      if (++s == stages) { s = 0; ph ^= 1; }
    }
    wgmma_wait<0>();
    if (ctid == 0) mbar_arrive(smem_u32(empty + prev_s));

    wg_barrier(1 + cw);  // tile t's terms are stored; tile t - 1's are read
    if (t + 1 < n_tiles) store_terms(t + 1);
    const float* tc = tt + (t & 1) * DN;
    const int row0 = r_begin + t * DN;
    // Pass p scores tile rows [64 p, 64 p + 64): the thread's n8 blocks
    // j = 8 p + jj, columns 8 j + 2 tg + e. A pass adds at most 64
    // candidates a query, so a buffer without room for 64 is merged after it.
#pragma unroll
    for (int p = 0; p < DN / DPASS; ++p) {
      float xa[16];
#pragma unroll
      for (int v = 0; v < 16; ++v) xa[v] = tc[64 * p + 8 * (v >> 1) + 2 * tg + (v & 1)];
      const int rbase = row0 + 64 * p + 2 * tg;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = 16 * warp + g + 8 * h;
        const float th = L.thr[m];
        float sc[16];
        unsigned bits = 0;
#pragma unroll
        for (int v = 0; v < 16; ++v) {
          const int j = 8 * p + (v >> 1);
          sc[v] = qa[h] + xa[v] - pm * acc[4 * j + 2 * h + (v & 1)];
          if (isfinite(sc[v]) && sc[v] < th) bits |= 1u << v;
        }
        if (!live[h]) bits = 0;
        L.push(m, bits, sc, [&](int v) { return rbase + 8 * (v >> 1) + (v & 1); });
      }
      __syncwarp();
      L.merge_range(16 * warp, 16, DPASS, warp, lane);
      __syncwarp();
    }
  }
  wg_barrier(1 + cw);
  L.write_out(ctid, 128);
}

// ---------------------------------------------------------------- short product (bf16)

// Shared memory of the short product: the resident query tile and the ring
// share SRING bytes (chunks of 128 rows x 64 bf16, 128-byte swizzled), then
// the row terms, the barriers and up to three warpgroups' selection state, plus 1 KB
// to align the chunks to the swizzle's 1024 bytes. The size does not depend
// on d, so one plan serves every depth the kernel takes.
constexpr size_t SHORT_SMEM = 1024 + (size_t)SRING + (size_t)STERMS * SN * 4 +
                              (size_t)(2 * SMAX_STAGES + 2) * 8 + SMAX_WG * pools_bytes(64, 4);

// The score pass of one warp over one tile (SN rows, in two passes of
// SPASS) from the accumulators of its 16 queries. The fast test costs one
// FMA and one compare a score: xa - pm p against tf = th - qa, widened by
// 2^-18 (qa + |th|), which covers the rounding of both sides for any row
// whose score reaches th (with xnorm2 the rows' squared norms, such a row
// has |x|^2 <= 2.02 qa + 2 |th|), so it never drops one; -inf for a query
// past B. Only a warp whose vote finds a survivor scores the candidates of
// the query halves that voted exactly, as the other products do, and
// pushes those below th, each lane only its set bits; the rest go on to
// the next pass. The pools' own compaction runs only when a
// push left a pool without room for the next pass, and a compaction that
// lowers a query's pool threshold (own) publishes it to the query's bound
// shared by all its splits.
template <class L_t>
__device__ __forceinline__ void short_score(L_t& L, const float (&acc)[64], const float* tc,
                                            int row0, int w, int g, int tg, int lane,
                                            const float (&qa)[2], const bool (&live)[2],
                                            const int (&qi)[2], float (&own)[2], float (&th)[2],
                                            float pm, unsigned* bound) {
  float tf[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    tf[h] = isfinite(th[h]) ? th[h] - qa[h] + 0x1p-18f * (qa[h] + fabsf(th[h])) : th[h];
#pragma unroll
  for (int p = 0; p < SN / SPASS; ++p) {
    float xa[16];
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const float2 t2 = *reinterpret_cast<const float2*>(tc + SPASS * p + 8 * v + 2 * tg);
      xa[2 * v] = t2.x;
      xa[2 * v + 1] = t2.y;
    }
    bool hit[2][2] = {{false, false}, {false, false}};  // two flags a query half
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int v = 0; v < 16; ++v)
        hit[h][v & 1] |= fmaf(-pm, acc[4 * (8 * p + (v >> 1)) + 2 * h + (v & 1)], xa[v]) < tf[h];
    const unsigned vote0 = __ballot_sync(FULL, hit[0][0] || hit[0][1]);
    const unsigned vote1 = __ballot_sync(FULL, hit[1][0] || hit[1][1]);
    if (!(vote0 | vote1)) continue;
    const int rbase = row0 + SPASS * p + 2 * tg;
    bool over = false;  // a push of this lane left a pool without room for a pass
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!(h ? vote1 : vote0)) continue;  // no lane's fast test passed in this query half
      float sc[16];
      unsigned bits = 0;
#pragma unroll
      for (int v = 0; v < 16; ++v) {
        sc[v] = qa[h] + xa[v] - pm * acc[4 * (8 * p + (v >> 1)) + 2 * h + (v & 1)];
        if (isfinite(sc[v]) && sc[v] < th[h]) bits |= 1u << v;
      }
      if (bits) {  // one shared atomic reserves the lane's slots (as Pools::push)
        const int m = 16 * w + g + 8 * h;
        const int pos = atomicAdd(&L.cnt[m], __popc(bits));
        over |= pos + __popc(bits) > L.cap - SPASS;
        unsigned long long* pp = L.pool + (size_t)m * L.cap + pos;
        // Only the set bits, each score fetched from the 16 registers by a
        // select on the bits of its index.
        while (bits) {
          const int v = __ffs(bits) - 1;
          bits &= bits - 1;
          float s8[8], s4[4], s2[2];
#pragma unroll
          for (int i = 0; i < 8; ++i) s8[i] = v & 1 ? sc[2 * i + 1] : sc[2 * i];
#pragma unroll
          for (int i = 0; i < 4; ++i) s4[i] = v & 2 ? s8[2 * i + 1] : s8[2 * i];
#pragma unroll
          for (int i = 0; i < 2; ++i) s2[i] = v & 4 ? s4[2 * i + 1] : s4[2 * i];
          *pp++ = wsel::ckey(v & 8 ? s2[1] : s2[0], rbase + 8 * (v >> 1) + (v & 1));
        }
      }
    }
    if (!__any_sync(FULL, over)) continue;
    __syncwarp();
    L.merge_range(16 * w, 16, SPASS, w, lane);
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float t = live[h] ? L.thr[16 * w + g + 8 * h] : -INFINITY;
      if (t < own[h]) {
        own[h] = t;
        th[h] = fminf(th[h], t);
        tf[h] = th[h] - qa[h] + 0x1p-18f * (qa[h] + fabsf(th[h]));
        if (tg == 0) atomicMin(bound + qi[h], wsel::fkey(t));
      }
    }
  }
}

// The row terms of tile rows row0 + lane + 32 i: |x|^2 (l2) or base (1 for
// cos, 0 for dot), +inf for masked rows and rows past the split.
__device__ __forceinline__ void short_terms(float (&tv)[SN / 32], int row0, int r_end, int N,
                                            int lane, int metric, float base,
                                            const float* __restrict__ xnorm2,
                                            const uint8_t* __restrict__ mask) {
#pragma unroll
  for (int i = 0; i < SN / 32; ++i) {
    const int row = row0 + lane + 32 * i, rc = min(row, N - 1);
    float v = metric == kL2 ? __ldg(xnorm2 + rc) : base;
    if (row >= r_end || (mask != nullptr && !__ldg(mask + rc))) v = INFINITY;
    tv[i] = v;
  }
}

// The shared bounds a tile scores with (key), loaded a tile before
// (next_key), so the load's latency hides behind that tile.
__device__ __forceinline__ void next_bounds(unsigned (&key)[2], unsigned (&next_key)[2],
                                            const bool (&live)[2], const int (&qi)[2],
                                            const unsigned* bound) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key[h] = next_key[h];
    next_key[h] = live[h] ? __ldcg(bound + qi[h]) : wsel::fkey(INFINITY);
  }
}

// A ring position: stage s in phase parity ph, t tiles loaded (or consumed)
// so far, which also names the tile's row-term slot.
struct Ring {
  int s, t;
  uint32_t ph;
  int stages;
  __device__ __forceinline__ void next() {
    ++t;
    if (++s == stages) { s = 0; ph ^= 1; }
  }
};

// One warpgroup's products of its 64 resident queries (chunk c at q + c *
// qchunk) and the tile in the stage at sb, into acc (overwritten), as one
// committed group: NCH chunks of four k16 steps (columns past d are zeros
// in both operands), with no branch between the wgmmas.
template <int NCH>
__device__ __forceinline__ void short_issue(float (&acc)[64], uint32_t q, uint32_t qchunk,
                                            uint32_t sb) {
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)
      wgmma_m64n128k16(acc, sw128_desc(q + c * qchunk + kk * 32),
                       sw128_desc(sb + c * SCHUNK + kk * 32), c > 0 || kk > 0);
  wgmma_commit();
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

// Persistent blocks: block b walks units b, b + gridDim.x, ... of
// q_tiles x splits, unit u being query tile u % q_tiles over split
// u / q_tiles (so the blocks resident at once share a split's rows), with
// its pools at slot u as a grid of (query tile, split) blocks would have
// them. The last warp produces: per unit the query tile (NCH chunks of
// 64 NWG rows, by TMA) once the previous unit's products retired; per tile
// the NCH corpus chunks into the ring stage and the tile's row terms (|x|^2,
// 1 or 0, +inf for masked, padded and out-of-split rows), which its lanes
// load a tile ahead and store into slot (tile count % STERMS). Warpgroups
// 0 .. NWG - 1 consume 64 queries each and take turns at the tensor cores
// in a ring of named barriers (warpgroup i issues tile t's wgmma after i - 1
// issued its own, and warpgroup 0 after NWG - 1 issued tile t - 1's), so
// the tensor cores run one warpgroup's product while the others score. A
// stage is released as soon as its products retire (each warp arrives);
// its row terms outlive it in their slot (the producer runs at most
// `stages` tiles ahead of the oldest unretired product, and a warp retires
// tile t + 1 only after scoring tile t, so STERMS >= stages + 2 slots are
// never overwritten while read). One accumulator set of 64 registers a
// thread: NWG warpgroups and the producer warp leave each thread 128 (three)
// or 168 (two) registers.
template <int NCH, int NWG>
__global__ void __launch_bounds__(128 * NWG + 32, 1)
scan_short_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap xmap, const float* __restrict__ qn_g,
                  unsigned* __restrict__ bound, const float* __restrict__ xnorm2,
                  const uint8_t* __restrict__ mask, int B, int N, int k, int metric,
                  int rows_per_split, int q_tiles, int units,
                  unsigned long long* pool, int* pool_n, int pool_cap) {
  constexpr int SQ = 64 * NWG;
  constexpr int stages = short_stages(NCH, NWG);
  static_assert(stages >= 2, "two ring stages fit beside the query tile");
  constexpr uint32_t qchunk = (uint32_t)SQ * DK * 2;
  constexpr uint32_t stage_bytes = (uint32_t)NCH * SCHUNK;
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t qbuf = smem_u32(smem), ring = qbuf + NCH * qchunk;
  float* terms = reinterpret_cast<float*>(smem + SRING);  // [STERMS][SN]
  uint64_t* full = reinterpret_cast<uint64_t*>(terms + STERMS * SN);
  uint64_t* empty = full + SMAX_STAGES;
  uint64_t* qfull = empty + SMAX_STAGES;
  uint64_t* qempty = qfull + 1;
  char* pools_p = reinterpret_cast<char*>(qempty + 1);

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 4 * NWG);  // every consumer warp
    }
    mbar_init(smem_u32(qfull), 1);
    mbar_init(smem_u32(qempty), 4 * NWG);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    const float base_term = metric == kCos ? 1.f : 0.f;
    Ring r{0, 0, 0u, stages};
    int j = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++j) {
      const int r_begin = (u / q_tiles) * rows_per_split;
      const int r_end = min(N, r_begin + rows_per_split);
      const int n_tiles = (r_end - r_begin + SN - 1) / SN;
      if (lane == 0) {
        if (j > 0) mbar_wait(smem_u32(qempty), (j - 1) & 1);
        mbar_expect_tx(smem_u32(qfull), NCH * qchunk);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          tma_load_2d(qbuf + c * qchunk, &qmap, c * DK, (u % q_tiles) * SQ, smem_u32(qfull));
      }
      float tv[SN / 32];
      short_terms(tv, r_begin, r_end, N, lane, metric, base_term, xnorm2, mask);
      for (int t = 0; t < n_tiles; ++t) {
        const int row0 = r_begin + t * SN;
        mbar_wait(smem_u32(empty + r.s), r.ph ^ 1);
        float* tt = terms + (r.t % STERMS) * SN;
#pragma unroll
        for (int i = 0; i < SN / 32; ++i) tt[lane + 32 * i] = tv[i];
        __syncwarp();  // every lane's terms precede lane 0's release of the stage
        if (lane == 0) {
          const uint32_t bar = smem_u32(full + r.s);
          mbar_expect_tx(bar, stage_bytes);
#pragma unroll
          for (int c = 0; c < NCH; ++c)
            tma_load_2d(ring + r.s * stage_bytes + c * SCHUNK, &xmap, c * DK, row0, bar);
        }
        // The next tile's terms load while this warp waits for its stage.
        if (t + 1 < n_tiles)
          short_terms(tv, row0 + SN, r_end, N, lane, metric, base_term, xnorm2, mask);
        r.next();
      }
    }
    return;
  }

  const int cw = wg, w = (tid & 127) >> 5, g = lane >> 2, tg = lane & 3;
  const float pm = metric == kL2 ? 2.f : 1.f;
  const uint32_t qa_base = qbuf + cw * 64 * 128;  // this warpgroup's 64 query rows of a chunk
  char* lp = pools_p + cw * pools_bytes(64, 4);
  Ring r{0, 0, 0u, stages};
  int j = 0;
  bool first = true;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int u = blockIdx.x; u < units; u += gridDim.x, ++j) {
    const int qt = u % q_tiles;
    const int r_begin = (u / q_tiles) * rows_per_split;
    const int r_end = min(N, r_begin + rows_per_split);
    const int n_tiles = (r_end - r_begin + SN - 1) / SN;
    const int qw0 = qt * SQ + 64 * cw;
    auto L = carve_pools<64>(lp, k, (size_t)u * NWG + cw, pool, pool_n, pool_cap);
    if (lane < 16) {  // each warp keeps the state of its own 16 queries
      L.thr[16 * w + lane] = INFINITY;
      L.cnt[16 * w + lane] = 0;
    }
    __syncwarp();
    float qa[2], own[2], th[2];
    int qi[2];
    bool live[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qi[h] = qw0 + 16 * w + g + 8 * h;
      live[h] = qi[h] < B;
      qa[h] = metric == kL2 && live[h] ? qn_g[qi[h]] : 0.f;
      own[h] = live[h] ? INFINITY : -INFINITY;
    }
    // A warpgroup with no live query (B <= 64 past the tile's start)
    // multiplies zero rows all the same, to keep its turns, and scores none.
    const bool scores = qw0 < B;
    mbar_wait(smem_u32(qfull), j & 1);
    // The shared bounds: a split's pool threshold bounds the k-th score over
    // all rows, so a row must beat its own split's threshold and reach the
    // least any split published (ties included: an earlier split's row may
    // win one; key + 1 is the next float up in the keys' order). Each tile
    // scores with the bounds loaded a tile before, so the load's latency
    // hides behind that tile.
    unsigned key[2], next_key[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      next_key[h] = live[h] ? __ldcg(bound + qi[h]) : wsel::fkey(INFINITY);
#pragma unroll 1
    for (int t = 0; t < n_tiles; ++t) {
      next_bounds(key, next_key, live, qi, bound);
      if (cw != 0 || !first) named_sync(1 + cw);
      first = false;
      mbar_wait(smem_u32(full + r.s), r.ph);
      short_issue<NCH>(acc, qa_base, qchunk, ring + r.s * stage_bytes);
      named_arrive(1 + (cw + 1) % NWG);
      wgmma_wait<0>();
      fence_operand(acc);
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(smem_u32(empty + r.s));
        if (t + 1 == n_tiles) mbar_arrive(smem_u32(qempty));
      }
      if (scores) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          th[h] = fminf(own[h], wsel::fval(key[h] + (key[h] < wsel::fkey(INFINITY))));
        short_score(L, acc, terms + (r.t % STERMS) * SN, r_begin + t * SN, w, g, tg, lane, qa,
                    live, qi, own, th, pm, bound);
      }
      r.next();
    }
    __syncwarp();
    if (lane < 16) L.pool_n[16 * w + lane] = L.cnt[16 * w + lane];
  }
  if (cw == 0 && !first) named_sync(1);  // the last warpgroup's last turn
}

// The short product's build for (d, k): its chunk count and warpgroups.
const void* short_kernel(int d, int k) {
  const int nch = (d + DK - 1) / DK;
  if (short_wgs(nch, k) == 3) {
    if (nch == 1) return reinterpret_cast<const void*>(scan_short_kernel<1, 3>);
    if (nch == 2) return reinterpret_cast<const void*>(scan_short_kernel<2, 3>);
    return reinterpret_cast<const void*>(scan_short_kernel<3, 3>);
  }
  if (nch == 1) return reinterpret_cast<const void*>(scan_short_kernel<1, 2>);
  if (nch == 2) return reinterpret_cast<const void*>(scan_short_kernel<2, 2>);
  if (nch == 3) return reinterpret_cast<const void*>(scan_short_kernel<3, 2>);
  return reinterpret_cast<const void*>(scan_short_kernel<4, 2>);
}

// ---------------------------------------------------------------- FMA f32 product

// A resident query row (floats): d rounded up to the 32-deep stage, plus 4,
// so 8 consecutive rows fall on distinct banks.
__host__ __device__ constexpr int f32_qld(int d) { return ((d + FK - 1) / FK) * FK + 4; }

__host__ __device__ constexpr size_t f32_smem(int resident, int d) {
  return (resident ? (size_t)FQ * f32_qld(d) * 4 : 0) +
         (size_t)FSTAGES * (FN + (resident ? 0 : FQ)) * FLD * 4 + (size_t)FQ * 4 +
         pools_bytes(FQ, 8);
}

// Warp w holds queries 16 w .. 16 w + 15 against all FN rows of a tile, so
// it pushes and merges them alone. Lane (qg, rg) = (lane / 16, lane % 16)
// holds queries 16 w + qg + 2 i and rows rg + 16 j, i, j < 8: 64
// accumulators. At each depth step the 8 lanes of a quarter-warp read 8
// consecutive stage rows (one conflict-free 128-byte wavefront) and one
// query row (a broadcast). Selection runs in two passes of 64 rows (j < 4,
// then j >= 4), so a pass adds at most 64 candidates a query.
__global__ void __launch_bounds__(THREADS)
scan_f32_kernel(const float* __restrict__ q, const float* __restrict__ x,
                const float* __restrict__ qn_g, const float* __restrict__ xnorm2,
                const uint8_t* __restrict__ mask, int B, int N, int d, int k, int metric,
                int rows_per_split, int resident, int vec,
                unsigned long long* pool, int* pool_n, int pool_cap) {
  extern __shared__ __align__(16) char smem[];
  const int QLD = f32_qld(d);
  const int stage_rows = FN + (resident ? 0 : FQ);
  float* qs = reinterpret_cast<float*>(smem);                     // [FQ][QLD] (resident)
  float* ring = qs + (resident ? (size_t)FQ * QLD : 0);           // [FSTAGES][stage_rows][FLD]
  float* qn = ring + (size_t)FSTAGES * stage_rows * FLD;          // [FQ]
  auto L = carve_pools<FQ>(reinterpret_cast<char*>(qn + FQ), k, block_slot(), pool, pool_n,
                           pool_cap);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qg = lane >> 4, rg = lane & 15;
  const int q0 = blockIdx.x * FQ;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);
  const int n_chunks = (d + FK - 1) / FK;
  const int units = (r_end - r_begin + FN - 1) / FN * n_chunks;

  L.init(tid, THREADS);
  if (tid < FQ) qn[tid] = q0 + tid < B ? qn_g[q0 + tid] : 0.f;
  if (resident) {  // zero past d (to the stage's depth) and past B
    const int c4n = (QLD - 4) / 4;
    for (int e = tid; e < FQ * c4n; e += THREADS) {
      const int r = e / c4n, c = (e % c4n) * 4, qi = q0 + r;
      const int nv = qi < B ? max(0, min(4, d - c)) : 0;
      copy4(qs + r * QLD + c, nv ? q + (size_t)qi * d + c : q, nv, vec);
    }
    cp_async_commit();
  }
  // Stage u % FSTAGES holds depth chunk (u % n_chunks) of tile (u / n_chunks):
  // FN corpus rows, then (streaming) the FQ query rows, FLD floats each.
  auto load_unit = [&](int u) {
    float* st = ring + (size_t)(u % FSTAGES) * stage_rows * FLD;
    const int row0 = r_begin + (u / n_chunks) * FN, d0 = (u % n_chunks) * FK;
#pragma unroll
    for (int i = 0; i < FN * FK / 4 / THREADS; ++i) {
      const int e = tid + i * THREADS, r = e >> 3, c = d0 + (e & 7) * 4, row = row0 + r;
      const int nv = row < r_end ? max(0, min(4, d - c)) : 0;
      copy4(st + r * FLD + (e & 7) * 4, nv ? x + (size_t)row * d + c : x, nv, vec);
    }
    if (!resident) {
      float* sq = st + FN * FLD;
#pragma unroll
      for (int i = 0; i < FQ * FK / 4 / THREADS; ++i) {
        const int e = tid + i * THREADS, r = e >> 3, c = d0 + (e & 7) * 4, qi = q0 + r;
        const int nv = qi < B ? max(0, min(4, d - c)) : 0;
        copy4(sq + r * FLD + (e & 7) * 4, nv ? q + (size_t)qi * d + c : q, nv, vec);
      }
    }
  };
#pragma unroll 1
  for (int u = 0; u < FSTAGES - 1; ++u) {
    if (u < units) load_unit(u);
    cp_async_commit();
  }

  const float pm = metric == kL2 ? 2.f : 1.f;
  float acc[8][8];
  int row[8];
  float xa[8];
#pragma unroll 1
  for (int u = 0; u < units; ++u) {
    cp_async_wait<FSTAGES - 2>();
    __syncthreads();  // unit u landed for every thread; unit u - 1's stage is free
    if (u + FSTAGES - 1 < units) load_unit(u + FSTAGES - 1);
    cp_async_commit();
    const int ch = u % n_chunks;
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      // The tile's row terms, loaded before the product so they land during it.
#pragma unroll
      for (int j = 0; j < 8; ++j) row[j] = r_begin + (u / n_chunks) * FN + rg + 16 * j;
      row_terms(row, r_end, N, metric, xnorm2, mask, xa);
    }
    const float* st = ring + (size_t)(u % FSTAGES) * stage_rows * FLD;
    const float* xs = st + rg * FLD;
    const int ld = resident ? QLD : FLD;
    const float* qsrc = (resident ? qs + ch * FK : st + FN * FLD) + (16 * warp + qg) * ld;
#pragma unroll
    for (int c = 0; c < FK; c += 4) {
      float4 b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float4*>(xs + 16 * j * FLD + c);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(qsrc + 2 * i * ld + c);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
        }
      }
    }
    if (ch != n_chunks - 1) continue;

#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = 16 * warp + qg + 2 * i;
        const float th = L.thr[m];
        const float qa = metric == kL2 ? qn[m] : 0.f;
        float sc[4];
        unsigned bits = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[j] = qa + xa[4 * p + j] - pm * acc[i][4 * p + j];
          if (isfinite(sc[j]) && sc[j] < th) bits |= 1u << j;
        }
        if (q0 + m >= B) bits = 0;
        L.push(m, bits, sc, [&](int j) { return row[4 * p + j]; });
      }
      __syncwarp();
      L.merge_range(16 * warp, 16, 64, warp, lane);
      __syncwarp();
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  L.write_out(tid, THREADS);
}

// ---------------------------------------------------------------- split f32 product

// tf32's round to nearest (ties away): the f32 container of the value, its
// low 13 bits zero.
__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// The low part of x. The tensor cores read an f32 operand as tf32 by
// ignoring its low 13 bits, so a raw row is its own high part trunc(x); its
// low part x - trunc(x) is exact in f32 and is rounded to tf32 here by an
// integer add and mask: round to nearest, ties away, as cvt.rna.tf32 gives
// for every finite value, on the integer pipes (the splitter warps waited
// on the conversion: the d 96 scan ran ~5% faster without it, PERF.md). A
// non-finite x makes its high part inf or NaN, so its row never scores
// whatever its low part.
__device__ __forceinline__ float tf32_low(float x) {
  const float d = x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
  return __uint_as_float((__float_as_uint(d) + 0x1000u) & 0xffffe000u);
}

// |q|^2 of every query (f32), each query's bound shared by its splits (+inf's
// key), and the query in two tf32 parts, hi = rna(q) and lo = rna(q - hi),
// zero-padded to dp columns: one warp a query.
__global__ void prep_split_queries_kernel(const float* __restrict__ q, int B, int d, int dp,
                                          float* __restrict__ qh, float* __restrict__ ql,
                                          float* __restrict__ qn, unsigned* __restrict__ bound) {
  const int w = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (w >= B) return;
  if (lane == 0) bound[w] = wsel::fkey(INFINITY);
  const float* row = q + (size_t)w * d;
  float s = 0.f;
  for (int c = lane; c < dp; c += 32) {
    const float v = c < d ? row[c] : 0.f;
    s = fmaf(v, v, s);
    const float h = tf32_round(v);
    qh[(size_t)w * dp + c] = h;
    ql[(size_t)w * dp + c] = tf32_round(v - h);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if (lane == 0) qn[w] = s;
}

// d[64 x 128] (+)= A[64 x 8] . B[128 x 8]^T, tf32 operands K-major in shared
// memory as TMA's 128-byte swizzle lays them (f32 containers), f32
// accumulators in wgmma_m64n128k16's layout.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The products of one chunk (4 k8 steps) into acc (overwritten) as one
// committed group: the two small terms first, lo(q).x and hi(q).lo(x), then
// the large one, hi(q).x. The tensor cores truncate their f32 sums at each
// step, so a chunk's sum starts from zero and joins the tile's total in
// registers (rounded to nearest): the truncations stay on chunk-sized sums.
// Each operand's descriptor is formed once; a k8 step 32 bytes on is the
// same descriptor plus 2 (its address field counts 16 bytes), so the
// wgmmas issue without address arithmetic between them.
__device__ __forceinline__ void split_issue(float (&acc)[64], uint32_t qh, uint32_t ql,
                                            uint32_t raw, uint32_t lo) {
  const uint64_t dql = sw128_desc(ql), dqh = sw128_desc(qh), dx = sw128_desc(raw),
                 dlo = sw128_desc(lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < XK / 8; ++kk)
    wgmma_m64n128k8_tf32(acc, dql + 2 * kk, dx + 2 * kk, kk > 0);
#pragma unroll
  for (int kk = 0; kk < XK / 8; ++kk)
    wgmma_m64n128k8_tf32(acc, dqh + 2 * kk, dlo + 2 * kk, 1);
#pragma unroll
  for (int kk = 0; kk < XK / 8; ++kk)
    wgmma_m64n128k8_tf32(acc, dqh + 2 * kk, dx + 2 * kk, 1);
  wgmma_commit();
}

// tot += acc once acc's products retired.
__device__ __forceinline__ void split_add(float (&tot)[64], float (&acc)[64]) {
  fence_operand(acc);
#pragma unroll
  for (int i = 0; i < 64; ++i) tot[i] += acc[i];
}

// Shared memory of the split product: the queries and the ring in XBUF
// bytes (chunks of 128 bytes a row, 128-byte swizzled), the row terms, the
// barriers and two warpgroups' selection state, plus 1 KB to align the
// chunks to the swizzle's 1024 bytes. One size for every depth.
constexpr size_t SPLIT_SMEM = 1024 + (size_t)XBUF + (size_t)XSTERMS * XN * 4 +
                              (size_t)(3 * XMAX_STAGES + 2) * 8 + 2 * pools_bytes(64, 4);

// Persistent blocks over (query tile, split) units as the short product's,
// 128 queries a unit. Warpgroup 2 runs at 56 registers a thread and gives the
// two consumer warpgroups 224 (setmaxnreg; they fit in 168 too, without a
// spill, and measured 1.4-2.0% slower there on the long scans, PERF.md; at 40
// the producer spills). Warp 8 produces: per unit the query tile's hi and lo
// chunks (resident: by TMA once the previous unit's products retired), per
// ring stage one 32-deep chunk of a 128-row tile (and, streamed, the chunk's
// query parts for all 128 queries), and per tile the row terms, which its
// lanes load a tile ahead into slot (tile count % XSTERMS). Warps 9-11 split:
// once a stage landed they write its rows' low parts beside them, once for
// both consumers, and fence them for the tensor cores. Warpgroups 0 and 1
// each multiply 64 of the unit's queries by every stage: per chunk the three
// products on wgmma m64n128k8 (tf32), the first chunk's into the tile's total
// and each later one's into a second accumulator set that joins the total as
// soon as its products retire, which frees the stage (its empty barrier
// counts the warps of both). Each issues as soon as its stage is ready, so
// the tensor cores run one's products while the other adds, waits or scores
// (named barriers that made them alternate chunk by chunk, as the short
// product's warpgroups do tile by tile, measured the same, PERF.md); after a
// tile's last chunk each scores its own total from registers as the short
// product does (fast test, vote, exact score, its own pools, the shared
// bound). A warpgroup whose 64 queries all lie past B multiplies nothing and
// scores nothing: it releases each stage once it landed, and the other
// multiplies alone.
__global__ void __launch_bounds__(XTHREADS, 1)
scan_split_kernel(const __grid_constant__ CUtensorMap qhmap,
                  const __grid_constant__ CUtensorMap qlmap,
                  const __grid_constant__ CUtensorMap xmap, const float* __restrict__ qn_g,
                  unsigned* __restrict__ bound, const float* __restrict__ xnorm2,
                  const uint8_t* __restrict__ mask, int B, int N, int d, int k, int metric,
                  int rows_per_split, int q_tiles, int units, int resident,
                  unsigned long long* pool, int* pool_n, int pool_cap) {
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int nch = (d + XK - 1) / XK;
  const int stages = split_stages(nch, resident);
  const uint32_t qres = smem_u32(smem);  // resident: the hi chunks, then the lo chunks
  const uint32_t ring_off = resident ? 2 * nch * XQCHUNK : 0;
  const uint32_t ring = qres + ring_off;
  // A stage: the raw rows, their low parts, then (streamed) the query chunk's two parts.
  const uint32_t stage_bytes = 2 * XCHUNK + (resident ? 0 : 2 * XQCHUNK);
  float* terms = reinterpret_cast<float*>(smem + XBUF);  // [XSTERMS][XN]
  uint64_t* full = reinterpret_cast<uint64_t*>(terms + XSTERMS * XN);
  uint64_t* split = full + XMAX_STAGES;
  uint64_t* empty = split + XMAX_STAGES;
  uint64_t* qfull = empty + XMAX_STAGES;
  uint64_t* qempty = qfull + 1;
  char* pools_p = reinterpret_cast<char*>(qempty + 1);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(split + s), XSPLITTERS);
      mbar_init(smem_u32(empty + s), 8);  // every consumer warp
    }
    mbar_init(smem_u32(qfull), 1);
    mbar_init(smem_u32(qempty), 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (warp == 8) {
      const float base_term = metric == kCos ? 1.f : 0.f;
      Ring r{0, 0, 0u, stages};
      int tiles = 0, j = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x, ++j) {
        const int q0 = (u % q_tiles) * XQ;
        const int r_begin = (u / q_tiles) * rows_per_split;
        const int r_end = min(N, r_begin + rows_per_split);
        const int n_tiles = (r_end - r_begin + XN - 1) / XN;
        if (resident && lane == 0) {
          if (j > 0) mbar_wait(smem_u32(qempty), (j - 1) & 1);
          mbar_expect_tx(smem_u32(qfull), 2 * nch * XQCHUNK);
          for (int c = 0; c < nch; ++c) {
            tma_load_2d(qres + c * XQCHUNK, &qhmap, c * XK, q0, smem_u32(qfull));
            tma_load_2d(qres + (nch + c) * XQCHUNK, &qlmap, c * XK, q0, smem_u32(qfull));
          }
        }
        float tv[XN / 32];
        short_terms(tv, r_begin, r_end, N, lane, metric, base_term, xnorm2, mask);
        for (int t = 0; t < n_tiles; ++t, ++tiles) {
          const int row0 = r_begin + t * XN;
          for (int c = 0; c < nch; ++c) {
            mbar_wait(smem_u32(empty + r.s), r.ph ^ 1);
            if (c == 0) {
              float* tt = terms + (tiles % XSTERMS) * XN;
#pragma unroll
              for (int i = 0; i < XN / 32; ++i) tt[lane + 32 * i] = tv[i];
              __syncwarp();  // every lane's terms precede lane 0's arrival
            }
            if (lane == 0) {
              const uint32_t bar = smem_u32(full + r.s), sb = ring + r.s * stage_bytes;
              mbar_expect_tx(bar, stage_bytes - XCHUNK);  // all but the low parts come by TMA
              tma_load_2d(sb, &xmap, c * XK, row0, bar);
              if (!resident) {
                tma_load_2d(sb + 2 * XCHUNK, &qhmap, c * XK, q0, bar);
                tma_load_2d(sb + 2 * XCHUNK + XQCHUNK, &qlmap, c * XK, q0, bar);
              }
            }
            // The next tile's terms load while this warp waits for its stages.
            if (c == 0 && t + 1 < n_tiles)
              short_terms(tv, row0 + XN, r_end, N, lane, metric, base_term, xnorm2, mask);
            r.next();
          }
        }
      }
    } else {
      const int sp = tid - 288;
      Ring r{0, 0, 0u, stages};
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int r_begin = (u / q_tiles) * rows_per_split;
        const int r_end = min(N, r_begin + rows_per_split);
        const int n = (r_end - r_begin + XN - 1) / XN * nch;
        for (int i = 0; i < n; ++i) {
          mbar_wait(smem_u32(full + r.s), r.ph);
          float4* raw = reinterpret_cast<float4*>(smem + ring_off + r.s * stage_bytes);
          float4* lo = raw + XCHUNK / 16;
          constexpr int step = 32 * XSPLITTERS;
          for (int e0 = sp; e0 < XCHUNK / 16; e0 += XSPLIT_BATCH * step) {
            float4 v[XSPLIT_BATCH];
#pragma unroll
            for (int b = 0; b < XSPLIT_BATCH; ++b)
              if (e0 + b * step < XCHUNK / 16) v[b] = raw[e0 + b * step];
#pragma unroll
            for (int b = 0; b < XSPLIT_BATCH; ++b)
              if (e0 + b * step < XCHUNK / 16)
                lo[e0 + b * step] = make_float4(tf32_low(v[b].x), tf32_low(v[b].y),
                                                tf32_low(v[b].z), tf32_low(v[b].w));
          }
          // The low parts, written by threads, become visible to wgmma's reads.
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
          if (lane == 0) mbar_arrive(smem_u32(split + r.s));
          r.next();
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    const int cw = wg, w = (tid & 127) >> 5, g = lane >> 2, tg = lane & 3;
    const float pm = metric == kL2 ? 2.f : 1.f;
    const uint32_t q_off = cw * 64 * 128;  // this warpgroup's 64 query rows of a chunk
    char* lp = pools_p + cw * pools_bytes(64, 4);
    Ring r{0, 0, 0u, stages};
    int tiles = 0, j = 0;
    float acc[64], tot[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++j) {
      const int q0 = (u % q_tiles) * XQ, qw0 = q0 + 64 * cw;
      const int r_begin = (u / q_tiles) * rows_per_split;
      const int r_end = min(N, r_begin + rows_per_split);
      const int n_tiles = (r_end - r_begin + XN - 1) / XN;
      if (qw0 >= B) {  // no live query: release each stage once it landed
        for (int i = 0; i < n_tiles * nch; ++i) {
          mbar_wait(smem_u32(full + r.s), r.ph);
          __syncwarp();
          if (lane == 0) mbar_arrive(smem_u32(empty + r.s));
          r.next();
        }
        if (resident && lane == 0) mbar_arrive(smem_u32(qempty));
        tiles += n_tiles;
        continue;
      }
      auto L = carve_pools<64>(lp, k, (size_t)u * 2 + cw, pool, pool_n, pool_cap);
      if (lane < 16) {  // each warp keeps the state of its own 16 queries
        L.thr[16 * w + lane] = INFINITY;
        L.cnt[16 * w + lane] = 0;
      }
      __syncwarp();
      float qa[2], own[2], th[2];
      int qi[2];
      bool live[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        qi[h] = qw0 + 16 * w + g + 8 * h;
        live[h] = qi[h] < B;
        qa[h] = metric == kL2 && live[h] ? qn_g[qi[h]] : 0.f;
        own[h] = live[h] ? INFINITY : -INFINITY;
      }
      // The shared bounds, loaded a tile ahead (as the short product's).
      unsigned key[2], next_key[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        next_key[h] = live[h] ? __ldcg(bound + qi[h]) : wsel::fkey(INFINITY);
      if (resident) mbar_wait(smem_u32(qfull), j & 1);
      // Chunk c's three products into dst, retired.
      auto chunk = [&](int c, float(&dst)[64]) {
        mbar_wait(smem_u32(full + r.s), r.ph);
        mbar_wait(smem_u32(split + r.s), r.ph);
        const uint32_t sb = ring + r.s * stage_bytes;
        const uint32_t qh = (resident ? qres + c * XQCHUNK : sb + 2 * XCHUNK) + q_off;
        const uint32_t ql =
            (resident ? qres + (nch + c) * XQCHUNK : sb + 2 * XCHUNK + XQCHUNK) + q_off;
        split_issue(dst, qh, ql, sb, sb + XCHUNK);
        wgmma_wait<0>();
      };
      auto release = [&]() {
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_u32(empty + r.s));
        r.next();
      };
#pragma unroll 1
      for (int t = 0; t < n_tiles; ++t, ++tiles) {
        next_bounds(key, next_key, live, qi, bound);
        chunk(0, tot);  // the first chunk's sums are the tile's total
        fence_operand(tot);
        release();
#pragma unroll 1
        for (int c = 1; c < nch; ++c) {
          chunk(c, acc);
          split_add(tot, acc);
          release();
        }
        if (resident && lane == 0 && t + 1 == n_tiles) mbar_arrive(smem_u32(qempty));
#pragma unroll
        for (int h = 0; h < 2; ++h)
          th[h] = fminf(own[h], wsel::fval(key[h] + (key[h] < wsel::fkey(INFINITY))));
        short_score(L, tot, terms + (tiles % XSTERMS) * XN, r_begin + t * XN, w, g, tg, lane, qa,
                    live, qi, own, th, pm, bound);
      }
      __syncwarp();
      if (lane < 16) L.pool_n[16 * w + lane] = L.cnt[16 * w + lane];
    }
  }
}

const void* kernel_of(int product, int d, int k) {
  if (product == kDeep) return reinterpret_cast<const void*>(scan_deep_kernel);
  if (product == kShort) return short_kernel(d, k);
  if (product == kF32) return reinterpret_cast<const void*>(scan_split_kernel);
  if (product == kF32Fma) return reinterpret_cast<const void*>(scan_f32_kernel);
  return reinterpret_cast<const void*>(scan_tile_kernel);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime's entry
// point query (so the library links no libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [rows, cols] bf16 (or f32) row-major tensor, its row pitch a multiple
// of 16 bytes, read in boxes of box_rows x 128 bytes (64 bf16, 32 f32),
// 128-byte swizzled; zeros outside.
int encode_2d(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
              uint32_t box_rows, bool f32 = false) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kEncodeFailed;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * (f32 ? 4 : 2)};
  const cuuint32_t box[2] = {f32 ? (cuuint32_t)XK : (cuuint32_t)DK, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed;
}

}  // namespace

extern "C" {

// The launch plan of a (table type, d, k) on the current device, for a bf16
// table whose rows are 16-byte aligned (aligned = 1) or not: out[P_FIELDS]
// gets the product (0 tile, 1 deep, 2 f32 FMA, 3 short, 4 f32 split), queries and
// corpus rows a tile,
// whether the query tile stays resident in shared memory, the block's
// dynamic shared memory, how many blocks fit on one SM, and the pool entries
// per (query, split). It also lets the kernels use that much shared memory
// on this device, so the caller asks once per (device, shape) and passes the
// plan to every launch. Returns a CUDA error code.
int vecgo_scan_topk_plan(int x_bf16, int d, int k, int aligned, int* out) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t cap = (size_t)optin;
  int product, tq, tn, resident, threads;
  size_t smem;
  // TMA reads rows whose pitch is a multiple of 16 bytes from a 16-byte
  // aligned base; other bf16 tables (d % 8 != 0, or a view that starts
  // mid-row) take the tile product's register-staged loads, other f32
  // tables (d % 4 != 0, unaligned) the FMA product's.
  if (!x_bf16)
    product = d % 4 != 0 || !aligned ? kF32Fma : kF32;
  else if (d % 8 != 0 || !aligned)
    product = kTile;
  else if (d <= SHORT_MAX_D && k <= SHORT_MAX_K)
    product = kShort;
  else if (d <= TILE_MAX_D)
    product = kTile;
  else
    product = kDeep;
  if (product == kF32) {
    tq = XQ, tn = XN, threads = XTHREADS, resident = split_resident((d + XK - 1) / XK);
    smem = SPLIT_SMEM;
  } else if (product == kF32Fma) {  // resident queries where they fit, else streamed
    tq = FQ, tn = FN, threads = THREADS;
    resident = f32_smem(1, d) <= cap;
    smem = f32_smem(resident, d);
  } else if (product == kTile) {
    tq = TQ, tn = TN, threads = THREADS;
    resident = tile_smem(1, d) <= cap;
    smem = tile_smem(resident, d);
  } else if (product == kShort) {
    const int nwg = short_wgs((d + DK - 1) / DK, k);
    tq = 64 * nwg, tn = SN, threads = 128 * nwg + 32, resident = 1;
    smem = SHORT_SMEM;
  } else {
    tq = DQ, tn = DN, threads = DTHREADS, resident = 0;
    smem = DEEP_SMEM;
  }
  const void* fn = kernel_of(product, d, k);
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(wsel::finish_rows),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e != cudaSuccess) return (int)e;
  out[P_PRODUCT] = product;
  out[P_TQ] = tq;
  out[P_TN] = tn;
  out[P_RESIDENT] = resident;
  out[P_SMEM] = (int)smem;
  out[P_POOL] = wsel::pool_cap(k);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + P_BPS, fn, threads,
                                                            (int)smem);
}

// q [B,d] f32; x [N,d] f32 or bf16, as the plan's product takes it; xnorm2
// [N] f32 (read for l2 only); mask [N] bytes or NULL. plan is the host array
// vecgo_scan_topk_plan filled for this (table type, d, k, alignment) on this
// device. qb is a [B, pad16(d)] bf16 scratch (deep and short products), a
// [2, B, pad32(d)] f32 scratch (the split product: the queries' tf32 high
// and low parts), else NULL; qn a [B] f32 scratch (deep and FMA products;
// [2B] for the short and split products, whose second half holds the bound
// each query's splits share).
// With blocks = ceil(B / tq) *
// splits, pool is a [blocks, tq, plan pool] 64-bit scratch and pool_n a
// [blocks, tq] int32 scratch; a finishing kernel writes out_d/out_i [B, k].
// Returns the CUDA error code of the launches (0 on success).
int vecgo_scan_topk(const void* q, const void* x, const void* xnorm2, const void* mask, int B,
                    int N, int d, int k, int metric, int rows_per_split, int splits,
                    const int* plan, void* qb, void* qn, void* pool, void* pool_n, void* out_d,
                    void* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int product = plan[P_PRODUCT], smem = plan[P_SMEM], pcap = plan[P_POOL];
  const float* qf = static_cast<const float*>(q);
  const float* xn = static_cast<const float*>(xnorm2);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  float* qnf = static_cast<float*>(qn);
  unsigned long long* pl = static_cast<unsigned long long*>(pool);
  int* pn = static_cast<int*>(pool_n);
  const dim3 grid((B + plan[P_TQ] - 1) / plan[P_TQ], splits);
  if (product == kShort) {
    if (d > SMAX_CH * DK || d % 8 != 0) return (int)cudaErrorInvalidValue;
    const int dp = pad_depth(d);
    __nv_bfloat16* qbb = static_cast<__nv_bfloat16*>(qb);
    // qn holds |q|^2 and then each query's bound shared by its splits.
    unsigned* bound = reinterpret_cast<unsigned*>(qnf + B);
    prep_queries_kernel<<<(B + 7) / 8, 256, 0, st>>>(qf, B, d, dp, qbb, qnf, bound);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    CUtensorMap qmap, xmap;
    int r = encode_2d(&qmap, qbb, B, dp, plan[P_TQ]);
    if (r == 0) r = encode_2d(&xmap, x, N, d, SN);
    if (r != 0) return r;
    int dev = 0, sms = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const int units = (int)grid.x * splits;
    const int blocks = units < plan[P_BPS] * sms ? units : plan[P_BPS] * sms;
    const int nwg = short_wgs((d + DK - 1) / DK, k);
    if (plan[P_TQ] != 64 * nwg) return (int)cudaErrorInvalidValue;
    int q_tiles = (int)grid.x, units_a = units, cap_a = pcap;
    void* args[] = {&qmap, &xmap, &qnf, &bound, &xn, &mk, &B, &N, &k, &metric,
                    &rows_per_split, &q_tiles, &units_a, &pl, &pn, &cap_a};
    e = cudaLaunchKernel(short_kernel(d, k), dim3(blocks), dim3(128 * nwg + 32), args, smem, st);
    if (e != cudaSuccess) return (int)e;
  } else if (product == kDeep) {
    const int dp = pad_depth(d);
    __nv_bfloat16* qbb = static_cast<__nv_bfloat16*>(qb);
    prep_queries_kernel<<<(B + 7) / 8, 256, 0, st>>>(qf, B, d, dp, qbb, qnf, nullptr);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    CUtensorMap qmap, xmap;
    int r = encode_2d(&qmap, qbb, B, dp, DQ);
    if (r == 0) r = encode_2d(&xmap, x, N, d, DN);
    if (r != 0) return r;
    scan_deep_kernel<<<grid, DTHREADS, smem, st>>>(qmap, xmap, qnf, xn, mk, B, N, d, k, metric,
                                                   rows_per_split, DSTAGES, pl, pn, pcap);
  } else if (product == kF32) {
    if (d % 4 != 0) return (int)cudaErrorInvalidValue;
    const int nch = (d + XK - 1) / XK, dp = nch * XK;
    float* qh = static_cast<float*>(qb);
    float* ql = qh + (size_t)B * dp;
    // qn holds |q|^2 and then each query's bound shared by its splits.
    unsigned* bound = reinterpret_cast<unsigned*>(qnf + B);
    prep_split_queries_kernel<<<(B + 7) / 8, 256, 0, st>>>(qf, B, d, dp, qh, ql, qnf, bound);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    CUtensorMap qhmap, qlmap, xmap;
    int r = encode_2d(&qhmap, qh, B, dp, XQ, true);
    if (r == 0) r = encode_2d(&qlmap, ql, B, dp, XQ, true);
    if (r == 0) r = encode_2d(&xmap, x, N, d, XN, true);
    if (r != 0) return r;
    int dev = 0, sms = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (plan[P_TQ] != XQ) return (int)cudaErrorInvalidValue;
    const int units = (int)grid.x * splits;
    const int blocks = units < plan[P_BPS] * sms ? units : plan[P_BPS] * sms;
    scan_split_kernel<<<blocks, XTHREADS, smem, st>>>(
        qhmap, qlmap, xmap, qnf, bound, xn, mk, B, N, d, k, metric, rows_per_split, (int)grid.x,
        units, plan[P_RESIDENT], pl, pn, pcap);
  } else if (product == kF32Fma) {
    prep_queries_kernel<<<(B + 7) / 8, 256, 0, st>>>(qf, B, d, d, nullptr, qnf, nullptr);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int vec = d % 4 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0 &&
                    (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    scan_f32_kernel<<<grid, THREADS, smem, st>>>(qf, static_cast<const float*>(x), qnf, xn, mk,
                                                 B, N, d, k, metric, rows_per_split,
                                                 plan[P_RESIDENT], vec, pl, pn, pcap);
  } else {
    scan_tile_kernel<<<grid, THREADS, smem, st>>>(qf, static_cast<const __nv_bfloat16*>(x), xn,
                                                  mk, B, N, d, k, metric, rows_per_split,
                                                  plan[P_RESIDENT], pl, pn, pcap);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wsel::finish_rows<<<B, wsel::FIN_THREADS, wsel::fin_smem(k, splits), st>>>(
      pl, pn, grid.x * plan[P_TQ], splits, pcap, k, static_cast<float*>(out_d),
      static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

const char* vecgo_cuda_error_string(int code) {
  if (code == kEncodeFailed) return "cuTensorMapEncodeTiled failed or is not available";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
