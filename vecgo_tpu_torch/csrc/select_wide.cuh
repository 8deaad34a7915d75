// Exact top-k selection over unsorted candidate pools in global memory, for
// lists too wide for shared memory (sm_90a). Shared by `scan_topk.cu` (its
// selection at every k) and `coded_group_scan.cu` (kk past 64).
//
// A candidate is one 64-bit composite key: an order-preserving 32-bit key of
// its score (-0 folded into +0) above its id, so unsigned order is the
// selection's order (smaller score first, ties to the lower id) and one
// compare ranks two candidates. Ids of one selection are distinct.
//
// A scan appends the survivors of its threshold test to a pool of
// `pool_cap(k)` entries (about 2k). When the next tile could overflow it,
// one warp compacts the pool in place (`warp_compact_pool`): it finds a
// bound that at least k and at most (k + cap) / 2 entries do not pass, the
// pool keeps those, and the bound's score becomes the threshold. The bound
// is guessed from 256 sampled entries and checked by one counting pass; a
// radix select finds it where the guess fails. Each compaction costs two or
// three reads of the pool, and thresholds tighten as the scan goes, so the
// fill phase is linear in the candidates, not quadratic in k. At the end
// `finish_rows` keeps between k and 1.25 k of every split's pool for one
// output row the same way (or exactly k by the radix select), sorts them
// in shared memory (in the pool when they outgrow it) and writes the first
// k as the sorted (score, id) row, (+inf, -1) past the candidates.
//
// The radix select: a pass over the candidates takes their least and
// greatest key; each further pass counts the candidates inside the current
// window into 256 equal bins (in shared memory) and narrows the window to
// the bin that holds the k-th, until the candidates at or below the bin's
// upper edge number between `need` and `limit`. A window of 256 keys or
// fewer has single-key bins, and keys are distinct, so the exact select
// ends there: at most eight passes of 8 bits, usually two or three.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {
namespace wsel {

constexpr int BINS = 256;
constexpr unsigned WFULL = 0xffffffffu;
// Threads of a finishing block, and the widest row whose survivors it sorts
// in shared memory (64 KB); wider rows sort in their pool.
constexpr int FIN_THREADS = 256;
constexpr int FIN_SMEM_ENTRIES = 8192;
constexpr int FIN_WARPS = FIN_THREADS / 32;

// Pool entries a (query, split) gets for a list of k: about 2k, and room
// for two 64-row passes above k, rounded to 32.
__host__ __device__ constexpr int pool_cap(int k) {
  return ((k + (k > 128 ? k : 128)) + 31) / 32 * 32;
}

// The most a finishing block keeps to sort for a row of k: a sampled bound
// lands between k and this, or the exact select keeps k.
__host__ __device__ constexpr int fin_limit(int k) { return k + k / 4 + 32; }

// Dynamic shared memory of a finishing block for a row of k over `splits`
// pools (their offsets, and a sort buffer of fin_limit(k) entries, at most
// FIN_SMEM_ENTRIES).
__host__ __device__ constexpr size_t fin_smem(int k, int splits) {
  return (size_t)BINS * 4 + (size_t)(2 * FIN_WARPS + 4) * 8 + (size_t)FIN_WARPS * 4 +
         (size_t)(splits + 2) / 2 * 8 +
         (size_t)(fin_limit(k) < FIN_SMEM_ENTRIES ? fin_limit(k) : FIN_SMEM_ENTRIES) * 8;
}

__device__ __forceinline__ uint32_t fkey(float s) {
  const uint32_t u = __float_as_uint(s == 0.f ? 0.f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float fval(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ unsigned long long ckey(float s, int id) {
  return ((unsigned long long)fkey(s) << 32) | (uint32_t)id;
}

// The score threshold of a bound: a later candidate passes if its score is
// below it. Later candidates carry higher ids than every pooled one, so one
// whose key equals the bound's ranks after all kept entries.
__device__ __forceinline__ float bound_score(unsigned long long upper) {
  return fval((uint32_t)(upper >> 32));
}

// The bin among 256 (hist, in shared memory) where the running count
// reaches t >= 1 (the counts sum to at least t), found by one warp: lane l
// sums bins 8 l .. 8 l + 7, a warp scan, and the first lane that reaches t
// walks its bins. Every lane gets the bin, the count before it and its own.
__device__ __forceinline__ void warp_find_bin(const unsigned* hist, unsigned t, int lane, int& bin,
                                              unsigned& before, unsigned& count) {
  unsigned h[8], s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    h[i] = hist[lane * 8 + i];
    s += h[i];
  }
  unsigned incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned v = __shfl_up_sync(WFULL, incl, o);
    if (lane >= o) incl += v;
  }
  const int src = __ffs(__ballot_sync(WFULL, incl >= t)) - 1;
  unsigned e = incl - s, c = 0;
  int b = 0;
  bool found = false;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (!found) {
      if (e + h[i] >= t) {
        b = i;
        c = h[i];
        found = true;
      } else {
        e += h[i];
      }
    }
  bin = __shfl_sync(WFULL, lane * 8 + b, src);
  before = __shfl_sync(WFULL, e, src);
  count = __shfl_sync(WFULL, c, src);
}

// A group of threads that selects together: one warp (its histogram of its
// own) or a whole block (FIN_THREADS threads, scratch in shared memory).
struct WarpGroup {
  unsigned* hist;  // [BINS]
  int lane;
  __device__ int rank() const { return lane; }
  __device__ int size() const { return 32; }
  __device__ void sync() const { __syncwarp(); }
  __device__ void minmax(unsigned long long& lo, unsigned long long& hi) const {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(WFULL, lo, o));
      hi = max(hi, __shfl_xor_sync(WFULL, hi, o));
    }
  }
  __device__ void find(unsigned t, int& bin, unsigned& before, unsigned& count) const {
    warp_find_bin(hist, t, lane, bin, before, count);
  }
};

struct BlockGroup {
  unsigned* hist;           // [BINS]
  unsigned long long* red;  // [2 * FIN_WARPS + 4]
  __device__ int rank() const { return threadIdx.x; }
  __device__ int size() const { return FIN_THREADS; }
  __device__ void sync() const { __syncthreads(); }
  __device__ void minmax(unsigned long long& lo, unsigned long long& hi) const {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(WFULL, lo, o));
      hi = max(hi, __shfl_xor_sync(WFULL, hi, o));
    }
    if (lane == 0) {
      red[w] = lo;
      red[FIN_WARPS + w] = hi;
    }
    __syncthreads();
    for (int i = 0; i < FIN_WARPS; ++i) {
      lo = min(lo, red[i]);
      hi = max(hi, red[FIN_WARPS + i]);
    }
    __syncthreads();
  }
  __device__ void find(unsigned t, int& bin, unsigned& before, unsigned& count) const {
    unsigned long long* res = red + 2 * FIN_WARPS;
    if (threadIdx.x < 32) {
      warp_find_bin(hist, t, threadIdx.x, bin, before, count);
      if (threadIdx.x == 0) {
        res[0] = (unsigned)bin;
        res[1] = before;
        res[2] = count;
      }
    }
    __syncthreads();
    bin = (int)res[0];
    before = (unsigned)res[1];
    count = (unsigned)res[2];
    __syncthreads();
  }
};

// The bound: `upper` such that need <= #(candidates <= upper) <= limit,
// for n > limit >= need >= 1 distinct candidates. each(f) calls f(key) on
// this thread's share of the candidates.
template <class G, class Each>
__device__ unsigned long long select_bound(const G& g, Each each, unsigned need,
                                           unsigned limit) {
  unsigned long long lo = ~0ull, hi = 0;
  each([&](unsigned long long c) {
    lo = min(lo, c);
    hi = max(hi, c);
  });
  g.minmax(lo, hi);
  unsigned below = 0;  // candidates under the window, all kept
  while (true) {
    const unsigned long long w = hi - lo;
    const int shift = w < BINS ? 0 : 56 - __clzll(w);  // w >> shift < 256
    for (int i = g.rank(); i < BINS; i += g.size()) g.hist[i] = 0;
    g.sync();
    each([&](unsigned long long c) {
      if (c >= lo && c <= hi) atomicAdd(&g.hist[(c - lo) >> shift], 1u);
    });
    g.sync();
    int bin;
    unsigned before, count;
    g.find(need - below, bin, before, count);
    const unsigned long long blo = lo + ((unsigned long long)bin << shift);
    const unsigned long long bhi =
        ((hi - blo) >> shift) == 0 ? hi : blo + ((1ull << shift) - 1);
    if (below + before + count <= limit) return bhi;
    below += before;
    lo = blo;
    hi = bhi;
    g.sync();  // every lane has read the histogram before it is cleared
  }
}

// Loads a lane (or thread) keeps in flight in a pass over a pool.
constexpr int PASS_U = 8;
// Candidates sampled to guess a bound, and the fewest candidates for which
// a guess pays: ranking the samples costs about as much as one pass over
// this many (measured, PERF.md); below it the radix select runs alone.
constexpr int SAMPLES = 256;
constexpr int GUESS_MIN = 4096;

// One warp's pass over pool[0, n): f(key) for each, PASS_U loads in flight.
template <class F>
__device__ __forceinline__ void warp_pass(const unsigned long long* pool, int n, int lane, F f) {
  for (int base = 0; base < n; base += 32 * PASS_U) {
    unsigned long long v[PASS_U];
#pragma unroll
    for (int u = 0; u < PASS_U; ++u) {
      const int e = base + 32 * u + lane;
      v[u] = e < n ? pool[e] : 0ull;
    }
#pragma unroll
    for (int u = 0; u < PASS_U; ++u)
      if (base + 32 * u + lane < n) f(v[u]);
  }
}

// The score key of sample rank rho (0-based) among SAMPLES score keys in
// sk (shared), as the bound that keeps every id of that key. Each of the
// group's `size` threads ranks SAMPLES / size of them against all; the one
// holding the rho-th smallest value publishes it in *out.
__device__ __forceinline__ void rank_samples(const unsigned* sk, int rho, int rank, int size,
                                             unsigned* out) {
  for (int j = rank; j < SAMPLES; j += size) {
    const unsigned mine = sk[j];
    int lt = 0, le = 0;
    for (int i = 0; i < SAMPLES; ++i) {
      const unsigned h = sk[i];
      lt += h < mine;
      le += h <= mine;
    }
    if (lt <= rho && rho < le) *out = mine;  // every holder writes the same value
  }
}

__device__ __forceinline__ unsigned long long key_bound(unsigned score_key) {
  return ((unsigned long long)score_key << 32) | 0xffffffffull;
}

// One warp compacts pool[0, n) in place to the entries <= upper; returns
// their count and sets top to the greatest of them. A chunk is read whole
// before any of it is written, and an entry only moves down, so no write
// lands on an entry not yet read.
__device__ __forceinline__ int warp_compact(unsigned long long* pool, int n,
                                            unsigned long long upper, int lane,
                                            unsigned long long& top) {
  int out = 0;
  top = 0;
  for (int base = 0; base < n; base += 32 * PASS_U) {
    unsigned long long v[PASS_U];
    bool keep[PASS_U];
#pragma unroll
    for (int u = 0; u < PASS_U; ++u) {
      const int e = base + 32 * u + lane;
      v[u] = e < n ? pool[e] : ~0ull;
      keep[u] = e < n && v[u] <= upper;
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < PASS_U; ++u) {
      const unsigned bits = __ballot_sync(WFULL, keep[u]);
      if (keep[u]) {
        pool[out + __popc(bits & ((1u << lane) - 1))] = v[u];
        top = max(top, v[u]);
      }
      out += __popc(bits);
    }
    __syncwarp();
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) top = max(top, __shfl_xor_sync(WFULL, top, o));
  return out;
}

// One warp shrinks a full pool of n > limit entries (limit = (k + cap) / 2)
// to between k and limit of its best, in place; returns the new count and
// sets top to the greatest kept entry and thr to the score a later
// candidate must beat: that entry's, not the bound's (a bin's edge can lie far above the k-th score
// where scores are few and far apart, as BM25's are). From GUESS_MIN
// entries up, first a guess from SAMPLES evenly spaced entries (the score
// key that should keep about a third of the way from k to limit), checked
// by one counting pass; below it, or where the count falls outside [k,
// limit] (ties, or a sample far off), the radix select. sk: the warp's 256
// words of shared memory.
__device__ __forceinline__ int warp_compact_pool(unsigned long long* pool, int n, int k, int cap,
                                                 unsigned* sk, int lane, float& thr,
                                                 unsigned long long& top) {
  const int limit = (k + cap) / 2, target = k + (limit - k) / 3;
  unsigned long long upper = 0;
  bool guessed = false;
  if (n >= GUESS_MIN) {
    for (int i = lane; i < SAMPLES; i += 32)
      sk[i] = (unsigned)(pool[(long long)i * n / SAMPLES] >> 32);
    __syncwarp();
    unsigned guess = 0;
    rank_samples(sk, min(SAMPLES - 1, (int)((long long)SAMPLES * target / n)), lane, 32,
                 &guess);
    const unsigned any = __ballot_sync(WFULL, guess != 0);
    upper = key_bound(__shfl_sync(WFULL, guess, any ? __ffs(any) - 1 : 0));
    int c = 0;
    warp_pass(pool, n, lane, [&](unsigned long long v) { c += v <= upper; });
    c = __reduce_add_sync(WFULL, c);
    guessed = any && c >= k && c <= limit;
    __syncwarp();  // the samples are read before the radix select reuses sk
  }
  if (!guessed)
    upper = select_bound(WarpGroup{sk, lane},
                         [&](auto f) { warp_pass(pool, n, lane, f); }, (unsigned)k,
                         (unsigned)limit);
  const int kept = warp_compact(pool, n, upper, lane, top);
  thr = bound_score(top);
  return kept;
}

__device__ __forceinline__ int warp_compact_pool(unsigned long long* pool, int n, int k, int cap,
                                                 unsigned* sk, int lane, float& thr) {
  unsigned long long top;
  return warp_compact_pool(pool, n, k, cap, sk, lane, thr, top);
}

// Block-wide ascending sort of buf[0, m) (shared or global memory): a
// bitonic network whose merges first compare each entry with its mirror in
// the block, so every comparator puts the smaller key first and the missing
// entries past m act as +inf without being stored.
__device__ __forceinline__ void block_sort(unsigned long long* buf, int m) {
  int mp = 1;
  while (mp < m) mp <<= 1;
  for (int size = 2; size <= mp; size <<= 1) {
    const int half = size >> 1;
    for (int t = threadIdx.x; t < mp / 2; t += FIN_THREADS) {
      const int i = t / half * size + t % half, j = i - t % half + size - 1 - t % half;
      if (j < m) {
        const unsigned long long a = buf[i], b = buf[j];
        if (b < a) { buf[i] = b; buf[j] = a; }
      }
    }
    __syncthreads();
    for (int stride = half >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < mp / 2; t += FIN_THREADS) {
        const int i = t / stride * 2 * stride + t % stride, j = i + stride;
        if (j < m) {
          const unsigned long long a = buf[i], b = buf[j];
          if (b < a) { buf[i] = b; buf[j] = a; }
        }
      }
      __syncthreads();
    }
  }
}

// One block per output row r < out_rows: the candidates of pools (split s,
// row r) at pool + (s * rows + r) * cap, counts at pool_n[s * rows + r];
// writes the sorted best k as out_d / out_i [out_rows, k], (+inf, -1) past
// the candidates. FIN_THREADS threads, fin_smem(k, splits) bytes of shared
// memory. The splits' counts are read at once and their prefix kept in
// shared memory, so every pass reads all pools as one range of candidates
// (a thread finds an entry's pool by a binary search of the prefix), not
// pool after pool.
// From GUESS_MIN candidates up, the bound is guessed from SAMPLES of them
// as in warp_compact_pool and checked by a count (between k and
// fin_limit(k) kept); otherwise the exact radix select keeps k. The kept
// entries are sorted and the first k written, so the answer is exact
// either way.
__global__ void __launch_bounds__(FIN_THREADS)
finish_rows(unsigned long long* __restrict__ pool, const int* __restrict__ pool_n, int rows,
            int splits, int cap, int k, float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char fsm[];
  unsigned* hist = reinterpret_cast<unsigned*>(fsm);
  unsigned long long* red = reinterpret_cast<unsigned long long*>(hist + BINS);
  unsigned* wcnt = reinterpret_cast<unsigned*>(red + 2 * FIN_WARPS + 4);
  int* off = reinterpret_cast<int*>(wcnt + FIN_WARPS);  // [splits + 1] pool offsets
  unsigned long long* sbuf = reinterpret_cast<unsigned long long*>(off) + (splits + 2) / 2;
  const int r = blockIdx.x, tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  // off[s] = the candidates of splits before s: a block scan of the counts,
  // FIN_THREADS at a time.
  for (int base = 0; base < splits; base += FIN_THREADS) {
    const int s = base + tid;
    const int c = s < splits ? pool_n[(size_t)s * rows + r] : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(WFULL, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) wcnt[w] = incl;
    __syncthreads();
    int before = base == 0 ? 0 : off[base];
    for (int i = 0; i < w; ++i) before += (int)wcnt[i];
    if (s < splits) off[s + 1] = before + incl;
    if (base == 0 && tid == 0) off[0] = 0;
    __syncthreads();
  }
  const int n = off[splits];
  const int mk = min(n, k);
  float* od = out_d + (size_t)r * k;
  int* oi = out_i + (size_t)r * k;
  for (int j = mk + tid; j < k; j += FIN_THREADS) {
    od[j] = INFINITY;
    oi[j] = -1;
  }
  if (mk == 0) return;
  // The split s >= lo of candidate e (0 <= e < n): off[s] <= e < off[s + 1],
  // by a binary search; the candidate is entry e - off[s] of its pool.
  auto split_of = [&](int e, int lo) {
    int hi = splits;
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (off[mid] <= e) lo = mid; else hi = mid;
    }
    return lo;
  };
  auto at = [&](int e, int s) { return pool[((size_t)s * rows + r) * cap + (e - off[s])]; };
  // f(key) on this thread's share of the row's candidates, PASS_U loads in
  // flight; chunk(v, ok) on each chunk of FIN_THREADS * PASS_U. A thread's
  // candidates come in ascending order, so it searches for a split only
  // when a candidate lies past its current one.
  auto chunks = [&](auto chunk) {
    int s = 0;
    for (int base = 0; base < n; base += FIN_THREADS * PASS_U) {
      unsigned long long v[PASS_U];
      bool ok[PASS_U];
#pragma unroll
      for (int u = 0; u < PASS_U; ++u) {
        const int e = base + u * FIN_THREADS + tid;
        ok[u] = e < n;
        if (ok[u] && off[s + 1] <= e) s = split_of(e, s + 1);
        v[u] = ok[u] ? at(e, s) : ~0ull;
      }
      chunk(v, ok);
    }
  };
  auto each = [&](auto f) {
    chunks([&](const unsigned long long(&v)[PASS_U], const bool(&ok)[PASS_U]) {
#pragma unroll
      for (int u = 0; u < PASS_U; ++u)
        if (ok[u]) f(v[u]);
    });
  };
  unsigned long long upper = ~0ull;
  int m = n;  // entries kept
  if (n > k) {
    const int flim = fin_limit(k), target = k + (flim - k) / 3;
    bool guessed = false;
    if (n >= GUESS_MIN) {
      for (int i = tid; i < SAMPLES; i += FIN_THREADS)
        hist[i] = (unsigned)(at((int)((long long)i * n / SAMPLES),
                                split_of((int)((long long)i * n / SAMPLES), 0)) >> 32);
      unsigned* guess = wcnt;  // scratch until the compaction below
      if (tid == 0) *guess = 0;
      __syncthreads();
      rank_samples(hist, min(SAMPLES - 1, (int)((long long)SAMPLES * target / n)), tid,
                   FIN_THREADS, guess);
      __syncthreads();
      const unsigned g = *guess;
      upper = key_bound(g);
      int c = 0;
      each([&](unsigned long long v) { c += v <= upper; });
      c = __reduce_add_sync(WFULL, c);
      if (lane == 0) red[w] = (unsigned)c;
      __syncthreads();
      c = 0;
      for (int i = 0; i < FIN_WARPS; ++i) c += (int)red[i];
      __syncthreads();
      guessed = g != 0 && c >= k && c <= flim;
      m = c;
    }
    if (!guessed) {
      upper = select_bound(BlockGroup{hist, red}, each, (unsigned)k, (unsigned)k);
      m = k;
    }
  }
  // The m kept entries into the sort buffer, chunk by chunk: read, block
  // prefix of the kept, write. In the pool itself (rows wider than the
  // shared buffer) writes land below what the chunks have read.
  unsigned long long* buf = m <= FIN_SMEM_ENTRIES ? sbuf : pool + (size_t)r * cap;
  int out = 0;
  chunks([&](const unsigned long long(&v)[PASS_U], const bool(&ok)[PASS_U]) {
    int mine = 0;
#pragma unroll
    for (int u = 0; u < PASS_U; ++u) mine += ok[u] && v[u] <= upper;
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(WFULL, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) wcnt[w] = incl;
    __syncthreads();
    int pos = out + incl - mine, total = 0;
    for (int i = 0; i < FIN_WARPS; ++i) {
      const int c = wcnt[i];
      pos += i < w ? c : 0;
      total += c;
    }
#pragma unroll
    for (int u = 0; u < PASS_U; ++u)
      if (ok[u] && v[u] <= upper) buf[pos++] = v[u];
    out += total;
    __syncthreads();
  });
  block_sort(buf, m);
  for (int j = tid; j < mk; j += FIN_THREADS) {
    const unsigned long long c = buf[j];
    od[j] = fval((uint32_t)(c >> 32));
    oi[j] = (int)(uint32_t)c;
  }
}

}  // namespace wsel
}  // namespace
