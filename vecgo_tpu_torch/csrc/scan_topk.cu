// Fused distance scan + running top-k for Hopper (sm_90a).
//
// Replaces: vecgo_tpu/ops/pallas_scan.py `pallas_l2_topk` (body `_scan_kernel`,
// helpers `_tile_topk` and `_merge_sorted_2k`). The TPU kernel walked the
// corpus tiles of one query tile in grid order and kept the running top-k in
// VMEM scratch. Here blocks run in parallel and in no order, so the corpus is
// split across blocks: block (query tile, split) scans its row range and keeps
// a sorted top-k per query in shared memory; a second kernel merges the
// [B, splits, k] partial lists into the final [B, k]. Query tiles run along
// the grid's x dimension, so the blocks resident at one time share a split's
// rows and read them from L2.
//
// What bounds it on the H100: at B=4096, N=1M, d=128 the scan is about
// 1.1 TFLOP per batch while the table is 256 MB (bf16), so its bound is
// arithmetic (1.11 ms on the tensor cores). Two products, one per table
// type, over 64-query x 64-row tiles:
//
// * bf16 tables: the product runs on the tensor cores with mma.sync
//   m16n8k16 (bf16 x bf16 -> fp32; bf16 products are exact in fp32). A
//   wgmma m64n32k16 product in this same tile loop measured slower: the
//   loop is bound by latency, and wgmma pays only once a producer/consumer
//   split overlaps selection with the product (PERF.md). The query tile is
//   rounded to bf16 once and stays in shared memory for the whole scan when
//   it fits (else its depth chunks ride beside the corpus). Corpus chunks of
//   64 rows x 64 depth are double-buffered: the next chunk's 16-byte loads
//   go to registers before a chunk's product and to shared memory after it.
// * f32 tables: the port's precision contract is IEEE fp32 (no TF32), so the
//   product stays on the FMA units: 4x4 register micro-tiles over k-chunks of
//   32 staged in shared memory.
//
// Selection is the same for both, and no thread inserts serially. Scores are
// formed in registers from the accumulators (a row term carries |x|^2, the
// mask and the padding as +inf), each thread tests them against its query's
// current k-th score (a threshold in shared memory, refreshed at every merge)
// and survivors go to the query's candidate buffer through one shared atomic
// per (thread, query). A buffer is merged only when the next tile could
// overflow it (and at the end), so a merge takes many candidates at once:
// one warp sorts them with a bitonic network in registers, then every
// candidate and every list entry finds its new position by a binary search,
// and all lanes write at once. While a list fills (threshold +inf) whole
// tiles are candidates; merging them in bulk is what keeps that phase cheap.
// The buffers (64 KB a block) live in a global scratch, so shared memory
// holds only the lists and the tiles, and two blocks share an SM at the
// engine's pools. Measured, the tile loop is bound by latency, not by the
// tensor cores: each tile's score pass and barriers cost more than its
// product (PERF.md).
//
// Two shapes of the lists, chosen by k. Up to KS = 256 a block's 64 lists
// (512 k bytes) stay in shared memory and a merge moves every list entry in
// registers (the narrow shape above). Past it, for any k <= N (a pool of
// 1,000 for a coarse quantizer, k = N for an exhaustive answer), the lists
// live in a global scratch of the block's own and shared memory holds only
// the thresholds, the counts and the list lengths: the same tiles, product,
// scores and candidate buffers, but a merge ranks each candidate by a binary
// search of ceil(log2(k + 1)) steps and moves only the entries at or above
// the first candidate's rank, from the top down, 128 at a time (each chunk is
// read whole before it is written, and an entry only moves up, so no write
// lands on an entry not yet read). The split merge searches the same way.

// Scores are smaller-is-better: l2 = |q|^2 + |x|^2 - 2 q.x, dot = -q.x,
// cos = 1 - q.x over normalized storage. Ties order by the lower row id, as
// `lax.top_k` does. Masked, padded and non-finite rows never enter a list;
// empty slots come back as (+inf, -1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int TQ = 64;        // queries per block
constexpr int TN = 64;        // corpus rows per tile
constexpr int QPW = TQ / 8;   // queries each warp merges
// bf16 product: two stages of TN rows x TD depth.
constexpr int TD = 64;
constexpr int LDT = TD + 8;  // padded chunk row (bf16): conflict-free ldmatrix
// f32 product: k-chunks of FD, transposed with a padded row.
constexpr int FD = 32;
constexpr int FLD = TN + 1;
constexpr int CAP = 128;  // candidates a buffer holds (a merge when > CAP - TN)
constexpr int KS = 256;   // the widest k whose lists stay in shared memory
constexpr int WU = 4;     // list entries a lane moves at once in a wide merge
constexpr unsigned FULL = 0xffffffffu;

enum Metric { kL2 = 0, kDot = 1, kCos = 2 };

// (da, ia) ranks before (db, ib). An empty slot holds id -1, which as an
// unsigned value is larger than any row id, so it ranks last among equals.
__device__ __forceinline__ bool better(float da, int ia, float db, int ib) {
  return da < db || (da == db && (unsigned)ia < (unsigned)ib);
}

// Entries of sorted (d, i)[0, n) that rank before (dv, iv), n <= 256: a
// fixed nine-step binary search (it can return n itself), so independent
// searches interleave.
__device__ __forceinline__ int rank_in(const float* d, const int* i, int n, float dv, int iv) {
  int pos = 0;
#pragma unroll
  for (int s = 256; s > 0; s >>= 1)
    if (pos + s <= n && better(d[pos + s - 1], i[pos + s - 1], dv, iv)) pos += s;
  return pos;
}

// The same for any n >= 0: floor(log2 n) + 1 = ceil(log2(n + 1)) steps.
__device__ __forceinline__ int rank_in_any(const float* d, const int* i, int n, float dv,
                                           int iv) {
  int pos = 0;
  for (int s = n > 0 ? 1 << (31 - __clz(n)) : 0; s > 0; s >>= 1)
    if (pos + s <= n && better(d[pos + s - 1], i[pos + s - 1], dv, iv)) pos += s;
  return pos;
}

// Entries of non-decreasing r[0, n) that are <= v, n <= 128 (CAP): a fixed
// eight-step binary search (it can return n itself).
__device__ __forceinline__ int count_le(const int* r, int n, int v) {
  int pos = 0;
#pragma unroll
  for (int s = 128; s > 0; s >>= 1)
    if (pos + s <= n && r[pos + s - 1] <= v) pos += s;
  return pos;
}

// Compare-exchange of two elements one lane holds (registers a < b).
__device__ __forceinline__ void cx_regs(float (&kd)[CAP / 32], int (&ki)[CAP / 32],
                                        int a, int b, bool up) {
  const bool swap = up ? better(kd[b], ki[b], kd[a], ki[a]) : better(kd[a], ki[a], kd[b], ki[b]);
  if (swap) {
    const float td = kd[a];
    const int ti = ki[a];
    kd[a] = kd[b]; ki[a] = ki[b];
    kd[b] = td; ki[b] = ti;
  }
}

// Bitonic sort, ascending, of nr * 32 elements held as element r * 32 + lane
// in register r of each lane (nr = 1, 2 or 4). Strides below 32 exchange with
// a shuffle, the others inside a lane.
__device__ __forceinline__ void warp_sort(float (&kd)[CAP / 32], int (&ki)[CAP / 32],
                                          int nr, int lane) {
  const int n = nr * 32;
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        // e and e + stride share their direction bit (size > stride).
        const bool up0 = ((0 * 32 + lane) & size) == 0, up1 = ((1 * 32 + lane) & size) == 0;
        if (stride == 64) {
          cx_regs(kd, ki, 0, 2, up0);
          cx_regs(kd, ki, 1, 3, up1);
        } else {
          const bool up2 = ((2 * 32 + lane) & size) == 0;
          cx_regs(kd, ki, 0, 1, up0);
          if (nr > 2) cx_regs(kd, ki, 2, 3, up2);
        }
      } else {
        const bool lower = (lane & stride) == 0;
#pragma unroll
        for (int r = 0; r < CAP / 32; ++r)
          if (r < nr) {
            const float od = __shfl_xor_sync(FULL, kd[r], stride);
            const int oi = __shfl_xor_sync(FULL, ki[r], stride);
            const bool up = ((r * 32 + lane) & size) == 0;
            const bool take = lower == up ? better(od, oi, kd[r], ki[r])
                                          : better(kd[r], ki[r], od, oi);
            if (take) { kd[r] = od; ki[r] = oi; }
          }
      }
    }
}

// Per-query selection state: thresholds and counts in shared memory; the
// lists there too (narrow) or in a global scratch of the block's own (WIDE);
// the candidate buffers in a global scratch of the block's own (writes are
// fire-and-forget, and a merge reads each candidate once).
template <bool WIDE>
struct Lists {
  float* thr;     // [TQ] current k-th score (+inf while the list fills)
  int* cnt;       // [TQ] candidates buffered
  float* lst_d;   // [TQ][k] sorted lists
  int* lst_i;
  int* lrank;     // [8][CAP] per warp: each sorted candidate's rank in the list
  int* nlist;     // [TQ] WIDE: entries listed (the rest of the list is empty)
  float* cand_d;  // [TQ][CAP] candidate buffers (global)
  int* cand_i;
  int k;

  __device__ void init(int tid) {
    for (int e = tid; e < TQ * k; e += THREADS) {
      lst_d[e] = INFINITY;
      lst_i[e] = -1;
    }
    for (int m = tid; m < TQ; m += THREADS) {
      thr[m] = INFINITY;
      cnt[m] = 0;
      if (WIDE) nlist[m] = 0;
    }
  }

  // Buffer one (thread, query)'s scores whose bits are set; one shared
  // atomic reserves the slots. Rows of a tile are all above the rows already
  // listed, so a score equal to the threshold never ranks before it: the
  // strict test is exact.
  template <int NS>
  __device__ __forceinline__ void push(int m, unsigned bits, const float (&s)[NS],
                                       const int (&row)[NS]) {
    if (!bits) return;
    int pos = atomicAdd(&cnt[m], __popc(bits));
#pragma unroll
    for (int j = 0; j < NS; ++j)
      if (bits >> j & 1u) {
        cand_d[m * CAP + pos] = s[j];
        cand_i[m * CAP + pos] = row[j];
        ++pos;
      }
  }

  // One warp merges query m's c buffered candidates into its sorted list: a
  // register bitonic sort of the buffer (padded with empty slots), then
  // every element's new position, its own index plus the entries of the
  // other list before it (ids are distinct, so positions are too): a
  // candidate's by a binary search of the list; a list entry j's is the
  // number of candidates whose list rank is at most j, a binary search of
  // those (non-decreasing) ranks. One write each.
  __device__ void merge_one(int m, int warp, int lane) {
    const int c = cnt[m];
    float* ld = lst_d + (size_t)m * k;
    int* li = lst_i + (size_t)m * k;
    const float* cd = cand_d + m * CAP;
    const int* ci = cand_i + m * CAP;
    int* lr = lrank + warp * CAP;
    // Sort the fewest registers that hold c: 1, 2 or 4 per lane.
    const int nr = c <= 32 ? 1 : c <= 64 ? 2 : 4;
    float kd[CAP / 32];
    int ki[CAP / 32];
#pragma unroll
    for (int r = 0; r < CAP / 32; ++r) {
      const int e = r * 32 + lane;
      kd[r] = INFINITY;
      ki[r] = -1;
      if (r < nr && e < c) { kd[r] = cd[e]; ki[r] = ci[e]; }
    }
    warp_sort(kd, ki, nr, lane);
    int vp[CAP / 32];
#pragma unroll
    for (int r = 0; r < CAP / 32; ++r) {
      const int e = r * 32 + lane;
      vp[r] = k;
      if (r < nr && e < c) {
        const int rank = WIDE ? rank_in_any(ld, li, nlist[m], kd[r], ki[r])
                              : rank_in(ld, li, k, kd[r], ki[r]);
        lr[e] = rank;
        vp[r] = e + rank;
      }
    }
    __syncwarp();
    if (WIDE) {
      // Entries [lr[0], listed) move up; the chunk [top - 32 WU, top) is
      // read whole before any of it is written.
      const int lo = lr[0], listed = nlist[m];
      for (int top = listed; top > lo; top -= 32 * WU) {
        float v[WU];
        int vi[WU], p[WU];
#pragma unroll
        for (int u = 0; u < WU; ++u) {
          const int j = top - 32 * WU + 32 * u + lane;
          p[u] = k;
          if (j >= lo) {
            v[u] = ld[j];
            vi[u] = li[j];
            p[u] = j + count_le(lr, c, j);
          }
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < WU; ++u)
          if (p[u] < k) { ld[p[u]] = v[u]; li[p[u]] = vi[u]; }
        __syncwarp();
      }
    } else {
      const int kt = (k + 31) >> 5;  // list entries per lane (k <= KS)
      int lp[8];
      float ldv[8];
      int liv[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int j = lane + 32 * t;
        lp[t] = k;
        if (t < kt && j < k) {
          ldv[t] = ld[j];
          liv[t] = li[j];
          if (liv[t] >= 0) lp[t] = j + count_le(lr, c, j);
        }
      }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 8; ++t)
        if (lp[t] < k) { ld[lp[t]] = ldv[t]; li[lp[t]] = liv[t]; }
    }
    // Every position below min(k, listed + c) is written exactly once;
    // positions past that were empty and stay so.
#pragma unroll
    for (int r = 0; r < CAP / 32; ++r)
      if (vp[r] < k) { ld[vp[r]] = kd[r]; li[vp[r]] = ki[r]; }
    __syncwarp();
    if (lane == 0) {
      thr[m] = ld[k - 1];
      cnt[m] = 0;
      if (WIDE) nlist[m] = min(k, nlist[m] + c);
    }
  }

  // After a tile (all pushes done): warp w merges those of its queries whose
  // buffer the next tile could overflow, or every non-empty one at the end.
  __device__ void merge_tile(bool flush, int warp, int lane) {
    const int m0 = warp * QPW;
    const int limit = flush ? 0 : CAP - TN;
    unsigned todo = __ballot_sync(FULL, lane < QPW && cnt[m0 + lane] > limit);
    while (todo) {
      const int j = __ffs(todo) - 1;
      todo &= todo - 1;
      merge_one(m0 + j, warp, lane);
    }
  }

  __device__ void write_out(int q0, int B, int split, int splits, int tid, float* part_d,
                            int* part_i) {
    for (int e = tid; e < TQ * k; e += THREADS) {
      const int m = e / k, j = e % k, qi = q0 + m;
      if (qi < B) {
        const size_t o = ((size_t)qi * splits + split) * k + j;
        part_d[o] = lst_d[e];
        part_i[o] = lst_i[e];
      }
    }
  }
};

// Shared memory of a block's selection state: the lists themselves only up
// to KS.
__host__ __device__ constexpr size_t lists_bytes(int k) {
  return (k > KS ? (size_t)TQ * 4 : (size_t)TQ * k * 8) + (size_t)TQ * 8 +
         (size_t)8 * CAP * 4;
}

// The block's state: thresholds, counts and per-warp ranks in shared memory
// at p (the lists there too, or at the block's slice of the global list
// scratch when WIDE); its candidate buffers at its slice of that scratch.
template <bool WIDE>
__device__ __forceinline__ Lists<WIDE> carve_lists(char* p, int k, float* cand_d, int* cand_i,
                                                   float* glist_d, int* glist_i) {
  Lists<WIDE> L;
  L.k = k;
  const size_t block = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  if (WIDE) {
    L.lst_d = glist_d + block * TQ * k;
    L.lst_i = glist_i + block * TQ * k;
    L.thr = reinterpret_cast<float*>(p);
  } else {
    L.lst_d = reinterpret_cast<float*>(p);
    L.lst_i = reinterpret_cast<int*>(L.lst_d + TQ * k);
    L.thr = reinterpret_cast<float*>(L.lst_i + TQ * k);
  }
  L.cnt = reinterpret_cast<int*>(L.thr + TQ);
  L.lrank = L.cnt + TQ;
  L.nlist = L.lrank + 8 * CAP;
  L.cand_d = cand_d + block * TQ * CAP;
  L.cand_i = cand_i + block * TQ * CAP;
  return L;
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
  L.push(m, bits, s, row);
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

// ---------------------------------------------------------------- bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__host__ __device__ constexpr size_t bf16_smem(int resident, int d, int k) {
  return (size_t)2 * (TN + (resident ? 0 : TQ)) * LDT * 2 +
         (resident ? (size_t)TQ * (pad_depth(d) + 8) * 2 : 0) + (size_t)(TQ + 2 * TN) * 4 +
         lists_bytes(k);
}

// Warps: 4 along the queries (16 each) x 2 along the rows (32 each, four
// n8-tiles), so each thread holds 2 queries x 8 rows of every tile.
template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
scan_bf16_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ x,
                 const float* __restrict__ xnorm2, const uint8_t* __restrict__ mask,
                 int B, int N, int d, int k, int metric, int rows_per_split, int resident,
                 float* cand_d, int* cand_i, float* glist_d, int* glist_i,
                 float* __restrict__ part_d, int* __restrict__ part_i) {
  constexpr int WQ = 4, NT = 4, NS = 2 * NT;
  extern __shared__ __align__(16) char smem[];
  const int DP = pad_depth(d), QS = DP + 8;
  const int stage_rows = TN + (resident ? 0 : TQ);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qs = ring + (size_t)2 * stage_rows * LDT;  // resident query
  float* qn = reinterpret_cast<float*>(qs + (resident ? (size_t)TQ * QS : 0));
  float* terms = qn + TQ;  // [2][TN] row terms of the current and next tile
  auto L = carve_lists<WIDE>(reinterpret_cast<char*>(terms + 2 * TN), k, cand_d, cand_i,
                            glist_d, glist_i);

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

  L.init(tid);
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
    L.merge_tile(false, warp, lane);
    // The next unit's __syncthreads orders these merges before the next
    // tile's threshold reads and buffer writes.
  }
  __syncthreads();
  L.merge_tile(true, warp, lane);
  __syncthreads();
  L.write_out(q0, B, split, gridDim.y, tid, part_d, part_i);
}

// ---------------------------------------------------------------- f32

__host__ __device__ constexpr size_t f32_smem(int k) {
  return (size_t)(2 * FD * FLD + TQ) * 4 + lists_bytes(k);
}

// 16 x 16 threads, each a 4 x 4 micro-tile: queries ty + 16 i, rows tx + 16 j.
template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
scan_f32_kernel(const float* __restrict__ q, const float* __restrict__ x,
                const float* __restrict__ xnorm2, const uint8_t* __restrict__ mask,
                int B, int N, int d, int k, int metric, int rows_per_split,
                float* cand_d, int* cand_i, float* glist_d, int* glist_i,
                float* __restrict__ part_d, int* __restrict__ part_i) {
  extern __shared__ __align__(16) char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [FD][FLD] query chunk, transposed
  float* xs = qs + FD * FLD;                   // [FD][FLD] corpus chunk, transposed
  float* qn = xs + FD * FLD;                   // [TQ] |q|^2
  auto L = carve_lists<WIDE>(reinterpret_cast<char*>(qn + TQ), k, cand_d, cand_i, glist_d,
                            glist_i);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * TQ;
  const int split = blockIdx.y;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);

  L.init(tid);
  if (tid < TQ) qn[tid] = query_norm(q, q0 + tid, B, d);
  __syncthreads();

#pragma unroll 1
  for (int n0 = r_begin; n0 < r_end; n0 += TN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    // The tile's row terms, loaded before the product so they land during it.
    int row[4];
    float xa[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) row[j] = n0 + tx + 16 * j;
    row_terms(row, r_end, N, metric, xnorm2, mask, xa);

    for (int d0 = 0; d0 < d; d0 += FD) {
      for (int e = tid; e < TQ * FD; e += THREADS) {
        const int r = e / FD, c = e % FD;
        const int qi = q0 + r, dc = d0 + c;
        qs[c * FLD + r] = (qi < B && dc < d) ? q[(size_t)qi * d + dc] : 0.f;
      }
      for (int e = tid; e < TN * FD; e += THREADS) {
        const int r = e / FD, c = e % FD;
        const int rr = n0 + r, dc = d0 + c;
        xs[c * FLD + r] = (rr < r_end && dc < d) ? x[(size_t)rr * d + dc] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < FD; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[c * FLD + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = xs[c * FLD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = ty + 16 * i;
      score_and_push(L, m, q0 + m < B, qn[m], metric, acc[i], xa, row);
    }
    __syncthreads();
    L.merge_tile(false, warp, lane);
    // The next tile's first __syncthreads orders these merges before its
    // threshold reads and buffer writes.
  }
  __syncthreads();
  L.merge_tile(true, warp, lane);
  __syncthreads();
  L.write_out(q0, B, split, gridDim.y, tid, part_d, part_i);
}

// One block per query: each valid candidate's final rank is its position in
// its own sorted list plus, for every other list, the number of entries that
// rank before it (a binary search: nine steps up to KS, ceil(log2(k + 1))
// past it). Row ranges of the splits are disjoint, so ranks are distinct and
// every rank < k is written exactly once.
template <bool WIDE>
__global__ void merge_kernel(const float* __restrict__ part_d,
                             const int* __restrict__ part_i, int splits, int k,
                             float* __restrict__ out_d, int* __restrict__ out_i) {
  const size_t b = blockIdx.x;
  const float* pd = part_d + b * splits * k;
  const int* pi = part_i + b * splits * k;
  float* od = out_d + b * k;
  int* oi = out_i + b * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    od[j] = INFINITY;
    oi[j] = -1;
  }
  __syncthreads();
  const int m = splits * k;
  for (int c = threadIdx.x; c < m; c += blockDim.x) {
    const int ic = pi[c];
    if (ic < 0) continue;
    const float dc = pd[c];
    const int s = c / k;
    int rank = c % k;
    for (int t = 0; t < splits && rank < k; ++t)
      if (t != s)
        rank += WIDE ? rank_in_any(pd + (size_t)t * k, pi + (size_t)t * k, k, dc, ic)
                     : rank_in(pd + t * k, pi + t * k, k, dc, ic);
    if (rank < k) {
      od[rank] = dc;
      oi[rank] = ic;
    }
  }
}

const void* kernel_of(int x_bf16, bool wide) {
  auto bf = wide ? scan_bf16_kernel<true> : scan_bf16_kernel<false>;
  auto f32 = wide ? scan_f32_kernel<true> : scan_f32_kernel<false>;
  return x_bf16 ? reinterpret_cast<const void*>(bf) : reinterpret_cast<const void*>(f32);
}

}  // namespace

extern "C" {

// The launch configuration of a (table type, d, k) on the current device:
// queries per block, candidates buffered per query, whether a bf16 query
// tile stays resident in shared memory (it does when it fits), the block's
// dynamic shared memory, how many blocks fit on one SM, and whether the
// lists live in a global scratch (k > KS; the caller allocates TQ * k
// entries a block). It also lets the kernel use that much shared memory on
// this device, so the caller asks once per (device, shape) and passes
// resident and smem to every launch. Returns a CUDA error code.
int vecgo_scan_topk_plan(int x_bf16, int d, int k, int* tq, int* cap, int* resident,
                         int* smem, int* blocks_per_sm, int* wide) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const void* fn = kernel_of(x_bf16, k > KS);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e != cudaSuccess) return (int)e;
  *tq = TQ;
  *cap = CAP;
  *wide = k > KS;
  *resident = x_bf16 && bf16_smem(1, d, k) <= (size_t)optin;
  *smem = (int)(x_bf16 ? bf16_smem(*resident, d, k) : f32_smem(k));
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, THREADS, *smem);
}

// q [B,d] f32; x [N,d] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); xnorm2 [N] f32
// (read for l2 only); mask [N] bytes or NULL. resident and smem come from
// vecgo_scan_topk_plan for this (x_bf16, d, k) on this device. cand_d/cand_i
// are the candidate buffers, [blocks, TQ, CAP] f32 / int32 scratch with
// blocks = ceil(B / TQ) * splits; list_d/list_i the lists, [blocks, TQ, k]
// scratch when k > KS, else NULL. With splits > 1, part_d/part_i are
// [B, splits, k] scratch and the merge writes out_d/out_i [B, k]; with
// splits == 1 the scan writes out_d/out_i directly. Returns the CUDA error
// code of the launches (0 on success).
int vecgo_scan_topk(const void* q, const void* x, int x_bf16,
                    const void* xnorm2, const void* mask, int B, int N, int d,
                    int k, int metric, int rows_per_split, int splits, int resident,
                    int smem, void* cand_d, void* cand_i, void* list_d, void* list_i,
                    void* part_d, void* part_i, void* out_d, void* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool direct = splits == 1, wide = k > KS;
  float* pd = static_cast<float*>(direct ? out_d : part_d);
  int* pi = static_cast<int*>(direct ? out_i : part_i);
  const float* qf = static_cast<const float*>(q);
  const float* xn = static_cast<const float*>(xnorm2);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  float* cdd = static_cast<float*>(cand_d);
  int* cii = static_cast<int*>(cand_i);
  float* gld = static_cast<float*>(list_d);
  int* gli = static_cast<int*>(list_i);
  const dim3 grid((B + TQ - 1) / TQ, splits);
  if (x_bf16) {
    auto kern = wide ? scan_bf16_kernel<true> : scan_bf16_kernel<false>;
    kern<<<grid, THREADS, smem, st>>>(qf, static_cast<const __nv_bfloat16*>(x), xn, mk, B, N, d,
                                      k, metric, rows_per_split, resident, cdd, cii, gld, gli,
                                      pd, pi);
  } else {
    auto kern = wide ? scan_f32_kernel<true> : scan_f32_kernel<false>;
    kern<<<grid, THREADS, smem, st>>>(qf, static_cast<const float*>(x), xn, mk, B, N, d, k,
                                      metric, rows_per_split, cdd, cii, gld, gli, pd, pi);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || direct) return (int)e;
  auto merge = wide ? merge_kernel<true> : merge_kernel<false>;
  merge<<<B, 128, 0, st>>>(pd, pi, splits, k, static_cast<float*>(out_d),
                           static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

const char* vecgo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
