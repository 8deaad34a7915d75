// The device BM25 sweep as a sparse product for Hopper (sm_90a): each query
// is a list of at most 16 columns of a bf16 table, and a row's score is the
// f32 sum of the query's own columns of that row, negated (dot: smaller is
// better), with a running top-k per query.
//
// Replaces no TPU kernel of its own. The JAX package sweeps the BM25 table
// with an XLA einsum of the multi-hot query against it and a blockwise top-k
// (vecgo_tpu/lexical/device_bm25.py `_scan_topk`); the port ran that through
// `scan_topk`'s dense deep product (scan_topk.cu), whose multiply-adds are
// more than 99.6% by zero there (3-16 ones among 4,096 columns). This kernel
// computes the same function from the columns: for every alive row n, the
// sum over j of x[n, cols[b, j]] (pads -1 add nothing, a repeated column
// counts each time), then the k best, ties to the lower row.
//
// What bounds it: the table's bytes. At the smoke's sweep (4,096 queries of
// about three columns over 1,049,576 rows x 4,096) the gather-sum is about
// 2.6e10 operations against 8.6 GB of table (2.587 ms at 3.35 TB/s), so the
// tensor cores have nothing to do; the work between the bytes is about
// 1.3e10 reads of one bf16 weight from shared memory. The design:
//
// * Table traffic. One persistent block a streaming multiprocessor, each
//   owning a contiguous range of rows (a split), so the table comes from
//   device memory once. One producer warp streams stages of R rows (R = 4
//   at H <= 4096: 32 KB a stage) through a ring of three: each stage is the
//   rows' contiguous bytes, its 16-byte aligned middle by one TMA bulk copy
//   completing on the stage's mbarrier, the ragged ends of a table TMA
//   cannot read whole (an odd width, a view) by the producer's own loads.
//   The producer also writes each stage's row terms (0 for a row that
//   scores, NaN for a dead, padded or foreign row).
// * Columns. A first kernel packs the batch's columns in groups of 32
//   queries, each query's columns in ascending order, column j of query
//   32 g + l at entry 32 j + l of the group, each group as deep as its
//   deepest query (pads point at a zero column), and opens each query's
//   shared bounds. A block copies a query tile of up to 128 groups (4,096
//   queries) to shared memory once a tile: the smoke's batch is one tile of
//   about 12,288 entries (24 KB); where the columns outgrow shared memory
//   (16 columns for every query of 4,096: 128 KB) the queries are tiled,
//   and each tile re-reads the block's rows.
// * Scoring. Eight consumer warps first transpose each landed stage into a
//   column-major copy (a column's R rows in 2R contiguous bytes,
//   XOR-swizzled so the transposing stores hit distinct banks), in two
//   buffers so one block barrier a stage suffices, and release the ring
//   stage. (Two dedicated transposing warps with a ring of three copies,
//   the consumers free of the block barrier, measured 4% slower: PERF.md.)
//   Lane l of warp w holds query 32 g + l of the groups g = w, w + 8, ...,
//   four groups at a time, so that their reads are in flight together: per
//   column one 2-byte read of its packed position (consecutive lanes:
//   conflict-free) and one 2R-byte read of the column's R rows, summed in
//   f32 in ascending column order. The reads at random columns are where
//   bank conflicts fall (several lanes of a phase on one bank); ascending
//   order puts the frequent columns (the hot vocabulary is ordered by
//   document frequency) at the same step across lanes, where a shared
//   column is one broadcast read.
// * Selection. Each (query, split) keeps an unsorted pool in a global
//   scratch (select_wide.cuh: about 2k keys, compacted by a warp's radix
//   select, the k best of all splits' pools sorted by `finish_rows`). The
//   bound a row must beat is one 64-bit key per query (score above row id)
//   in registers. With 132 splits a split's own pool bounds it weakly (its
//   k-th best is the query's 132 k-th), so the splits share a better one:
//   each publishes the least key it pushed to bucket (split mod k) of its
//   query by atomicMin, and the greatest of the k buckets is the key of a
//   row with k distinct rows (one a bucket) at or below it: a valid bound
//   near the query's k-th best over the rows seen so far (where splits >= k;
//   else a pool's greatest kept key after a compaction, published by
//   atomicMin, bounds the others). Both are read at stages 1, 2, 4, ..., 64
//   and every 64 after. A row of a later split that ties a bound's score
//   ranks after its row, one of an earlier split before it, so the key
//   compare keeps exactly the rows that can still make the top k (BM25's
//   many zero scores too). The fast test is one compare a score; a warp
//   that votes a survivor runs the exact test and pushes, and compacts a
//   full pool (a call, not inlined: a few a (query, split)).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "select_wide.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NCW = 8;                 // consumer warps
constexpr int CTHREADS = NCW * 32;     // consumer threads
constexpr int THREADS = CTHREADS + 32;  // + the producer warp
constexpr int QPT = 16;                // query groups a consumer warp holds in a tile
static_assert(QPT % 4 == 0, "slots are scored four at a time");
constexpr int GMAX = NCW * QPT;        // groups of 32 queries a tile
constexpr int STAGES = 3;              // ring stages
constexpr int TMAX = 16;               // columns a query
constexpr int REFRESH = 64;            // stages between reads of the shared bounds
constexpr int MAX_WIDTH = 65528;       // packed positions are 16-bit
// The plan's fields (vecgo_scan_columns_plan's out array).
enum PlanField { P_ROWS, P_SMEM, P_EMAX, P_BPS, P_POOL, P_FIELDS };

__host__ __device__ constexpr size_t align_up(size_t v, size_t a) { return (v + a - 1) / a * a; }
// A ring stage: R rows' bytes and 16 more, the offset of an unaligned start.
__host__ __device__ constexpr size_t ring_pitch(int r, int h) {
  return align_up((size_t)r * h * 2 + 16, 128);
}
// The column-major copy of a stage: a chunk of 2R bytes a column position,
// positions up to the zero column at round8(h).
__host__ __device__ constexpr int zero_col(int h) { return (h + 7) / 8 * 8; }
__host__ __device__ constexpr size_t tb_pitch(int r, int h) {
  return align_up((size_t)(zero_col(h) + 1) * 2 * r, 128);
}
// Dynamic shared memory of a block at R rows a stage, width h, emax packed
// column entries: 128 bytes of alignment slack, the ring, two column-major
// buffers, the ring's row terms and barriers, a 256-bin histogram a
// consumer warp (its compactions), the columns.
__host__ __device__ constexpr size_t columns_smem(int r, int h, int emax) {
  return 128 + STAGES * ring_pitch(r, h) + 2 * tb_pitch(r, h) + STAGES * 16 + 2 * STAGES * 8 +
         (size_t)NCW * wsel::BINS * 4 + (size_t)emax * 2;
}

// The position of column c in the column-major copy: c with its low three
// bits XORed by higher ones, so that the transposing stores (lane l
// writing column 8 l + i at step i) fall on distinct banks for chunks of 8
// (R 4), 4 (R 2) and 2 (R 1) bytes. A bijection within each group of 8.
__host__ __device__ __forceinline__ int col_pos(int c, int r) {
  return c ^ (r == 4 ? (c >> 4) & 7 : r == 2 ? (c >> 5) & 7 : (c >> 5) & 6);
}

// A query's bound before any compaction (+inf, above every row), and a
// dead lane's (-inf, below every row).
constexpr unsigned long long KEY_OPEN = 0xff800000ffffffffull;
constexpr unsigned long long KEY_DEAD = 0x007fffff00000000ull;

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

// Wait until the barrier's phase with this parity has completed; a wait
// past 2^34 cycles (seconds) traps, so a broken ring fails the launch
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// One TMA bulk copy global -> shared (16-byte aligned ends), completing on
// the barrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// A barrier of the consumer warps alone.
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(CTHREADS) : "memory");
}

// A ring position: stage s in phase parity ph.
struct Ring {
  int s = 0;
  uint32_t ph = 0;
  __device__ __forceinline__ void next() {
    if (++s == STAGES) { s = 0; ph ^= 1; }
  }
};

// The last group of the query tile that starts at group ga: at most GMAX
// groups, their packed entries at most emax (one group, at most 32 x 16,
// always fits).
__device__ __forceinline__ int tile_end(const int* __restrict__ gstart, int G, int ga, int emax) {
  const int base = gstart[ga];
  int lo = ga + 1, hi = min(G, ga + GMAX);
  if (gstart[hi] - base <= emax) return hi;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (gstart[mid] - base <= emax) lo = mid; else hi = mid;
  }
  return lo;
}

// One block: each warp's groups' depths (the deepest query's valid
// columns), their exclusive prefix sum of 32 x depth as gstart[0 .. G], the
// packed positions (the j-th smallest valid column of query 32 g + l at
// gstart[g] + 32 j + l, the zero column past a query's columns), and every
// query's shared bound and best-key buckets (bucket-major, [nb, B]) opened.
// Columns outside [0, H) other than the -1 pads are read as pads.
__global__ void __launch_bounds__(1024)
prep_columns_kernel(const void* __restrict__ cols, int cols64, int B, int T, int H, int R,
                    int* __restrict__ gstart, uint16_t* __restrict__ gcols,
                    unsigned long long* __restrict__ bound, unsigned long long* __restrict__ best,
                    int nb) {
  __shared__ int carry_s, wsum[32];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, G = (B + 31) / 32;
  auto col = [&](int q, int j) -> int {
    const long long c = cols64 ? static_cast<const long long*>(cols)[(size_t)q * T + j]
                               : static_cast<const int*>(cols)[(size_t)q * T + j];
    return c >= 0 && c < H ? (int)c : -1;
  };
  for (int g = w; g < G; g += 32) {
    const int q = 32 * g + lane;
    int n = 0;
    if (q < B)
      for (int j = 0; j < T; ++j) n += col(q, j) >= 0;
    const int m = __reduce_max_sync(FULL, n);
    if (lane == 0) gstart[g + 1] = 32 * m;
  }
  for (int q = tid; q < B; q += blockDim.x) bound[q] = KEY_OPEN;
  for (size_t i = tid; i < (size_t)nb * B; i += blockDim.x) best[i] = KEY_OPEN;
  if (tid == 0) {
    gstart[0] = 0;
    carry_s = 0;
  }
  __syncthreads();
  // Inclusive scan of gstart[1 .. G] in chunks of blockDim.x.
  for (int base = 0; base < G; base += blockDim.x) {
    const int g = base + tid;
    const int v = g < G ? gstart[g + 1] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) wsum[w] = incl;
    __syncthreads();
    int before = carry_s;
    for (int i = 0; i < w; ++i) before += wsum[i];
    if (g < G) gstart[g + 1] = before + incl;
    __syncthreads();
    if (tid == blockDim.x - 1) carry_s = before + incl;
    __syncthreads();
  }
  const int zp = zero_col(H);
  for (int g = w; g < G; g += 32) {
    const int q = 32 * g + lane, e0 = gstart[g], m = (gstart[g + 1] - e0) / 32;
    int c[TMAX], n = 0;
    if (q < B)
      for (int t = 0; t < T; ++t) {
        const int v = col(q, t);
        if (v < 0) continue;
        int i = n++;
        for (; i > 0 && c[i - 1] > v; --i) c[i] = c[i - 1];  // ascending
        c[i] = v;
      }
    for (int j = 0; j < m; ++j)
      gcols[e0 + 32 * j + lane] = (uint16_t)(j < n ? col_pos(c[j], R) : zp);
  }
}

// One stage's rows into the column-major buffer tb, by the consumer warps:
// rows r of the raw stage at raw + off0 + (r H + c) 2.
// Vector path (rows 16-byte aligned in shared memory, H % 8 == 0): a thread
// reads 8 columns of each of the R rows by 16-byte loads and stores 8
// chunks; else 2-byte loads, a column a thread.
template <int R>
__device__ __forceinline__ void transpose_stage(const char* raw, int off0, int H, char* tb,
                                                int tid) {
  constexpr int NT = CTHREADS;
  if (off0 == 0 && H % 8 == 0) {
    for (int gi = tid; gi < H / 8; gi += NT) {
      uint4 a[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        a[r] = *reinterpret_cast<const uint4*>(raw + ((size_t)r * H + 8 * gi) * 2);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t v[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          v[r] = p == 0 ? a[r].x : p == 1 ? a[r].y : p == 2 ? a[r].z : a[r].w;
        const int c0 = 8 * gi + 2 * p;
        char* lo = tb + (size_t)col_pos(c0, R) * 2 * R;
        char* hi = tb + (size_t)col_pos(c0 + 1, R) * 2 * R;
        if constexpr (R == 4) {
          *reinterpret_cast<uint2*>(lo) =
              make_uint2(__byte_perm(v[0], v[1], 0x5410), __byte_perm(v[2], v[3], 0x5410));
          *reinterpret_cast<uint2*>(hi) =
              make_uint2(__byte_perm(v[0], v[1], 0x7632), __byte_perm(v[2], v[3], 0x7632));
        } else if constexpr (R == 2) {
          *reinterpret_cast<uint32_t*>(lo) = __byte_perm(v[0], v[1], 0x5410);
          *reinterpret_cast<uint32_t*>(hi) = __byte_perm(v[0], v[1], 0x7632);
        } else {
          *reinterpret_cast<uint16_t*>(lo) = (uint16_t)(v[0] & 0xffffu);
          *reinterpret_cast<uint16_t*>(hi) = (uint16_t)(v[0] >> 16);
        }
      }
    }
  } else {
    for (int c = tid; c < H; c += NT) {
      uint16_t v[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        v[r] = *reinterpret_cast<const uint16_t*>(raw + off0 + ((size_t)r * H + c) * 2);
      char* dst = tb + (size_t)col_pos(c, R) * 2 * R;
#pragma unroll
      for (int r = 0; r < R; ++r) reinterpret_cast<uint16_t*>(dst)[r] = v[r];
    }
  }
}

// The R rows of one column position, as f32, subtracted from a.
template <int R>
__device__ __forceinline__ void sub_column(float (&a)[R], const char* tb, int pos) {
  if constexpr (R == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(tb + (size_t)pos * 8);
    a[0] -= __uint_as_float(v.x << 16);
    a[1] -= __uint_as_float(v.x & 0xffff0000u);
    a[2] -= __uint_as_float(v.y << 16);
    a[3] -= __uint_as_float(v.y & 0xffff0000u);
  } else if constexpr (R == 2) {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(tb + (size_t)pos * 4);
    a[0] -= __uint_as_float(v << 16);
    a[1] -= __uint_as_float(v & 0xffff0000u);
  } else {
    const uint32_t v = *reinterpret_cast<const uint16_t*>(tb + (size_t)pos * 2);
    a[0] -= __uint_as_float(v << 16);
  }
}

// A query's selection state, held by its lane: its bound, the least key it
// pushed in this split and its pool's count.
struct Slot {
  unsigned long long key, best;
  int cnt;
};

struct Compacted {
  unsigned long long top;
  int kept;
};

// One warp compacts a pool of cnt keys (select_wide.cuh): the count kept
// and the greatest kept key. A call, not inlined: it runs a few times a
// (query, split), while its callers are unrolled over a warp's 16 groups.
__device__ __noinline__ Compacted compact_pool(unsigned long long* p, int cnt, int k, int cap,
                                               unsigned* hist, int lane) {
  Compacted c;
  float thr;
  c.kept = wsel::warp_compact_pool(p, cnt, k, cap, hist, lane, thr, c.top);
  return c;
}

// The rare path of one slot, entered by the whole warp when a lane's fast
// test passed: the exact test (finite, key below the bound), the push of
// the lane's survivors to its query's pool (a new least key published to
// the split's bucket, qbucket, where there are buckets), and the
// compaction of every lane's pool that the next stage could overflow (by
// the whole warp, one pool at a time): its count, its bound (the greatest
// kept key) and the published bound of its query.
template <int R>
__device__ __forceinline__ void rare_path(Slot& st, const float (&a)[R], int row0,
                                          unsigned long long* qpool, unsigned long long* qbound,
                                          unsigned long long* qbucket, int k, int cap,
                                          unsigned* hist, int lane) {
  const unsigned long long best = st.best;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const unsigned long long key = wsel::ckey(a[r], row0 + r);
    if (isfinite(a[r]) && key < st.key) {
      qpool[st.cnt++] = key;
      st.best = min(st.best, key);
    }
  }
  if (qbucket != nullptr && st.best < best) atomicMin(qbucket, st.best);
  __syncwarp();  // the pushes precede the compactions' reads by other lanes
  unsigned todo = __ballot_sync(FULL, st.cnt > cap - R);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    unsigned long long* p = reinterpret_cast<unsigned long long*>(
        __shfl_sync(FULL, reinterpret_cast<long long>(qpool), src));
    const Compacted c = compact_pool(p, __shfl_sync(FULL, st.cnt, src), k, cap, hist, lane);
    if (lane == src) {
      st.cnt = c.kept;
      st.key = c.top;
      atomicMin(qbound, c.top);
    }
    __syncwarp();
  }
}

// One block a split (blockIdx.x): rows [split rows_per_split, + rows_per_split)
// of x [N, H] bf16, any alignment of 2 bytes. Query tiles of the packed
// columns in turn; per tile the producer warp streams the split's stages
// and the consumer warps transpose and score them. Pools and counts as
// finish_rows reads them: (split, query) at pool + (split B + q) cap.
template <int R>
__global__ void __launch_bounds__(THREADS, 1)
scan_columns_kernel(const char* __restrict__ x, const uint8_t* __restrict__ mask, int N, int H,
                    const int* __restrict__ gstart, const uint16_t* __restrict__ gcols, int B,
                    int k, int rows_per_split, int emax, unsigned long long* bound,
                    unsigned long long* best, int nb, unsigned long long* __restrict__ pool,
                    int* __restrict__ pool_n, int cap) {
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const size_t rp = ring_pitch(R, H), tp = tb_pitch(R, H);
  char* ring = smem;
  char* tbuf = ring + STAGES * rp;
  float* terms = reinterpret_cast<float*>(tbuf + 2 * tp);  // [STAGES][4]
  uint64_t* full = reinterpret_cast<uint64_t*>(terms + STAGES * 4);
  uint64_t* empty = full + STAGES;
  unsigned* hist = reinterpret_cast<unsigned*>(empty + STAGES);  // [NCW][BINS]
  uint16_t* qcols = reinterpret_cast<uint16_t*>(hist + NCW * wsel::BINS);

  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, G = (B + 31) / 32, zp = zero_col(H);
  const int r_begin = split * rows_per_split, r_end = min(N, r_begin + rows_per_split);
  const int n_st = (r_end - r_begin + R - 1) / R;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 2 * R)  // the zero column of both buffers: what pads read
    reinterpret_cast<uint16_t*>(tbuf + (tid / R) * tp + (size_t)zp * 2 * R)[tid % R] = 0;
  __syncthreads();

  if (w == NCW) {  // the producer warp
    const size_t row_bytes = (size_t)H * 2;
    Ring ring_at;
    auto term_of = [&](int row) {
      const bool live = row < r_end && (mask == nullptr || __ldg(mask + row));
      return live ? 0.f : __int_as_float(0x7fc00000);
    };
    for (int ga = 0; ga < G; ga = tile_end(gstart, G, ga, emax)) {
      float tv = lane < R ? term_of(r_begin + lane) : 0.f;
      for (int t = 0; t < n_st; ++t) {
        const int row0 = r_begin + t * R, nrows = min(R, N - row0);
        mbar_wait(smem_u32(empty + ring_at.s), ring_at.ph ^ 1);
        if (lane < R) terms[ring_at.s * 4 + lane] = tv;
        __syncwarp();  // every lane's terms precede lane 0's release of the stage
        if (lane == 0) {
          const uintptr_t a = reinterpret_cast<uintptr_t>(x) + row0 * row_bytes;
          const uintptr_t b = a + nrows * row_bytes, fl = a & ~(uintptr_t)15;
          const uintptr_t a16 = (a + 15) & ~(uintptr_t)15, b16 = b & ~(uintptr_t)15;
          char* dst = ring + ring_at.s * rp;
          const bool bulk = a16 < b16;
          // The ragged ends (< 16 bytes each), or a stage too small for a
          // bulk copy, by this lane's own loads.
          for (uintptr_t p = a; p < (bulk ? a16 : b); p += 2)
            *reinterpret_cast<uint16_t*>(dst + (p - fl)) = *reinterpret_cast<const uint16_t*>(p);
          if (bulk)
            for (uintptr_t p = b16; p < b; p += 2)
              *reinterpret_cast<uint16_t*>(dst + (p - fl)) =
                  *reinterpret_cast<const uint16_t*>(p);
          const uint32_t bar = smem_u32(full + ring_at.s);
          mbar_expect_tx(bar, bulk ? (uint32_t)(b16 - a16) : 0u);
          if (bulk)
            bulk_copy(smem_u32(dst + (a16 - fl)), reinterpret_cast<const void*>(a16),
                      (uint32_t)(b16 - a16), bar);
        }
        // The next stage's terms load while this warp waits for its stage.
        if (lane < R && t + 1 < n_st) tv = term_of(row0 + R + lane);
        ring_at.next();
      }
    }
    return;
  }

  // Consumer warps.
  unsigned* whist = hist + w * wsel::BINS;
  Ring ring_at;
  int tt = 0;  // stages consumed, over all tiles: which column-major buffer
  for (int ga = 0; ga < G;) {
    const int gb = tile_end(gstart, G, ga, emax);
    const int e0 = gstart[ga], ne = gstart[gb] - e0;
    named_sync();  // every consumer is done with the previous tile's columns
    for (int i = 8 * tid; i < ne; i += 8 * CTHREADS)
      *reinterpret_cast<uint4*>(qcols + i) = *reinterpret_cast<const uint4*>(gcols + e0 + i);
    Slot st[QPT];
    unsigned offm[QPT];  // packed entry offset << 5 | depth
#pragma unroll
    for (int s = 0; s < QPT; ++s) {
      const int g = ga + w + s * NCW, q = 32 * g + lane;
      const unsigned depth = g < gb ? (unsigned)(gstart[g + 1] - gstart[g]) >> 5 : 0u;
      offm[s] = g < gb ? (unsigned)(gstart[g] - e0) << 5 | depth : 0u;
      st[s].key = g < gb && q < B ? __ldcg(bound + q) : KEY_DEAD;
      st[s].best = KEY_OPEN;
      st[s].cnt = 0;
    }
    named_sync();  // the tile's columns are in shared memory
    for (int t = 0; t < n_st; ++t, ++tt) {
      const int row0 = r_begin + t * R;
      mbar_wait(smem_u32(full + ring_at.s), ring_at.ph);
      float term[R];
#pragma unroll
      for (int r = 0; r < R; ++r) term[r] = terms[ring_at.s * 4 + r];
      // Two column-major buffers, so that one barrier a stage suffices: a
      // warp transposes stage t + 1 only after every warp passed this
      // barrier of stage t, after scoring stage t - 1.
      char* tb = tbuf + (tt & 1) * tp;
      const int off0 = (int)((reinterpret_cast<uintptr_t>(x) + (size_t)row0 * H * 2) & 15);
      transpose_stage<R>(ring + ring_at.s * rp, off0, H, tb, tid);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(empty + ring_at.s));
      ring_at.next();
      named_sync();  // the column-major stage is whole
      // The shared bounds at stages 1, 2, 4, ..., 64, then every 64: every
      // slot's loads of one bucket in flight together (buckets are
      // bucket-major, so a slot's 32 lanes read 256 contiguous bytes).
      if (t > 0 && (t % REFRESH == 0 || (t < REFRESH && (t & (t - 1)) == 0))) {
        unsigned long long most[QPT];
#pragma unroll
        for (int s = 0; s < QPT; ++s) {
          const int q = 32 * (ga + w + s * NCW) + lane;
          most[s] = st[s].key == KEY_DEAD ? KEY_DEAD : __ldcg(bound + q);
        }
#pragma unroll
        for (int s = 0; s < QPT; ++s) st[s].key = min(st[s].key, most[s]);
        if (nb) {
#pragma unroll
          for (int s = 0; s < QPT; ++s) most[s] = 0;
#pragma unroll 2
          for (int i = 0; i < nb; ++i) {
#pragma unroll
            for (int s = 0; s < QPT; ++s) {
              const int q = 32 * (ga + w + s * NCW) + lane;
              if (st[s].key != KEY_DEAD) most[s] = max(most[s], __ldcg(best + (size_t)i * B + q));
            }
          }
#pragma unroll
          for (int s = 0; s < QPT; ++s)
            if (st[s].key != KEY_DEAD) st[s].key = min(st[s].key, most[s]);
        }
      }
      // The warp's slots four at a time: the four groups' columns in one
      // loop to the deepest of them (a shallower group reads the zero
      // column), so that their reads are in flight together; one vote a
      // quad, the rare path for the slots that need it.
#pragma unroll
      for (int s0 = 0; s0 < QPT; s0 += 4) {
        if (ga + w + s0 * NCW >= gb) break;
        float a[4][R];
        const uint16_t* e[4];
        int m[4], mq = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          m[i] = offm[s0 + i] & 31;
          e[i] = qcols + (offm[s0 + i] >> 5) + lane;
          mq = max(mq, m[i]);
#pragma unroll
          for (int r = 0; r < R; ++r) a[i][r] = term[r];
        }
#pragma unroll 2
        for (int j = 0; j < mq; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) sub_column<R>(a[i], tb, j < m[i] ? e[i][32 * j] : zp);
        }
        bool pass[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float bs = wsel::fval((uint32_t)(st[s0 + i].key >> 32));
          const uint32_t br = (uint32_t)st[s0 + i].key;
          pass[i] = false;
#pragma unroll
          for (int r = 0; r < R; ++r)
            pass[i] |= a[i][r] < bs || (a[i][r] == bs && (uint32_t)(row0 + r) < br);
        }
        if (!__any_sync(FULL, pass[0] || pass[1] || pass[2] || pass[3])) continue;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (!__any_sync(FULL, pass[i])) continue;
          const int s = s0 + i;
          const int q = st[s].key != KEY_DEAD ? 32 * (ga + w + s * NCW) + lane : 0;
          rare_path<R>(st[s], a[i], row0, pool + ((size_t)split * B + q) * cap, bound + q,
                       nb ? best + (size_t)(split % nb) * B + q : nullptr, k, cap, whist, lane);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < QPT; ++s) {
      const int q = 32 * (ga + w + s * NCW) + lane;
      if (ga + w + s * NCW < gb && q < B) pool_n[(size_t)split * B + q] = st[s].cnt;
    }
    ga = gb;
  }
}

const void* kernel_of(int r) {
  if (r == 4) return reinterpret_cast<const void*>(scan_columns_kernel<4>);
  if (r == 2) return reinterpret_cast<const void*>(scan_columns_kernel<2>);
  return reinterpret_cast<const void*>(scan_columns_kernel<1>);
}

}  // namespace

extern "C" {

// The launch plan of a table of width H at k on the current device:
// out[P_FIELDS] gets the rows a stage (4, 2 or 1: the most whose ring and
// column-major stages leave room for at least 512 packed columns), the
// block's dynamic shared memory, the packed column entries a query tile
// holds, blocks an SM holds and the pool entries per (query, split). It
// also lets the kernel and the finishing kernel use that much shared
// memory. Returns a CUDA error code (cudaErrorInvalidValue past the widest
// table it takes).
int vecgo_scan_columns_plan(int H, int k, int* out) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (H < 1 || H > MAX_WIDTH || k < 1) return (int)cudaErrorInvalidValue;
  int r = 4;
  while (r > 1 && columns_smem(r, H, 512) > (size_t)optin) r /= 2;
  if (columns_smem(r, H, 512) > (size_t)optin) return (int)cudaErrorInvalidValue;
  // As many entries as fit, rounded to whole 8-entry copies, at most a full
  // tile of 16 columns.
  int emax = (int)(((size_t)optin - columns_smem(r, H, 0)) / 2) / 8 * 8;
  emax = min(emax, GMAX * 32 * TMAX);
  const size_t smem = columns_smem(r, H, emax);
  const void* fn = kernel_of(r);
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(reinterpret_cast<const void*>(wsel::finish_rows),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (e != cudaSuccess) return (int)e;
  out[P_ROWS] = r;
  out[P_SMEM] = (int)smem;
  out[P_EMAX] = emax;
  out[P_POOL] = wsel::pool_cap(k);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + P_BPS, fn, THREADS, (int)smem);
}

// cols [B, T] int32 (cols64 = 0) or int64, T <= 16, -1 pads; x [N, H] bf16
// with rows 2-byte aligned; mask [N] bytes or NULL. plan is the host array
// vecgo_scan_columns_plan filled for (H, k) on this device. Scratch: gstart
// [ceil(B / 32) + 1] int32, gcols [ceil(B / 32) * 32 * max(T, 1)] uint16,
// bound [B] uint64, best [k, B] uint64 (read where splits >= k), pool
// [splits, B, plan pool] uint64, pool_n [splits, B] int32; a finishing
// kernel writes out_d / out_i [B, k]. Returns the CUDA error code of the
// launches (0 on success).
int vecgo_scan_columns(const void* cols, int cols64, int B, int T, const void* x,
                       const void* mask, int N, int H, int k, int rows_per_split, int splits,
                       const int* plan, void* gstart, void* gcols, void* bound, void* best,
                       void* pool, void* pool_n, void* out_d, void* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int r = plan[P_ROWS], cap = plan[P_POOL];
  if (T < 0 || T > TMAX || H < 1 || H > MAX_WIDTH || rows_per_split % r != 0 ||
      (reinterpret_cast<uintptr_t>(x) & 1) != 0)
    return (int)cudaErrorInvalidValue;
  int* gs = static_cast<int*>(gstart);
  unsigned long long* bd = static_cast<unsigned long long*>(bound);
  unsigned long long* bk = static_cast<unsigned long long*>(best);
  unsigned long long* pl = static_cast<unsigned long long*>(pool);
  int* pn = static_cast<int*>(pool_n);
  const int nb = splits >= k ? k : 0;
  prep_columns_kernel<<<1, 1024, 0, st>>>(cols, cols64, B, T, H, r, gs,
                                          static_cast<uint16_t*>(gcols), bd, bk, nb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const char* xb = static_cast<const char*>(x);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  const uint16_t* gc = static_cast<const uint16_t*>(gcols);
  int emax = plan[P_EMAX], pool_cap = cap, n_buckets = nb;
  void* args[] = {&xb, &mk, &N, &H, &gs, &gc, &B, &k, &rows_per_split, &emax, &bd, &bk,
                  &n_buckets, &pl, &pn, &pool_cap};
  e = cudaLaunchKernel(kernel_of(r), dim3(splits), dim3(THREADS), args, plan[P_SMEM], st);
  if (e != cudaSuccess) return (int)e;
  wsel::finish_rows<<<B, wsel::FIN_THREADS, wsel::fin_smem(k, splits), st>>>(
      pl, pn, B, splits, cap, k, static_cast<float*>(out_d), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // extern "C"
