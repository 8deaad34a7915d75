// Fused distance scan + running top-k for Hopper (sm_90a).
//
// Replaces: vecgo_tpu/ops/pallas_scan.py `pallas_l2_topk` (body `_scan_kernel`,
// helpers `_tile_topk` and `_merge_sorted_2k`). The TPU kernel walked the
// corpus tiles of one query tile in grid order and kept the running top-k in
// VMEM scratch. Here blocks run in parallel and in no order, so the corpus is
// split across blocks: block (split, query tile) scans its row range and keeps
// a sorted top-k per query in shared memory; a second kernel merges the
// [B, splits, k] partial lists into the final [B, k].
//
// What bounds it on the H100: at B=4096, N=1M, d=128 the scan is about
// 1.07 TFLOP per batch while the table is 256 MB (bf16), so it is bound by
// arithmetic, not by HBM. This first version computes on the SIMT fp32 units
// (a 64x64 block tile, 4x4 register micro-tiles, k-chunks of 32 staged in
// shared memory), so it is bound by FMA issue and shared-memory loads; the
// tensor cores (wgmma + TMA) are the next step. The score matrix never leaves
// the chip: each 64x64 score tile lives in shared memory only until the
// per-query owner thread has folded it into its sorted list, and a cheap
// threshold test (the current k-th entry, kept in a register) rejects almost
// every candidate once the list is full.
//
// Scores are smaller-is-better: l2 = |q|^2 + |x|^2 - 2 q.x, dot = -q.x,
// cos = 1 - q.x over normalized storage. For a bf16 table the query is
// rounded to bf16 before the product (bf16 x bf16 products are exact in
// fp32) and sums accumulate in fp32. Ties order by the lower row id, as
// `lax.top_k` does. Masked, padded and non-finite rows never enter a list;
// empty slots come back as (+inf, -1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;       // queries per block
constexpr int TN = 64;       // corpus rows per tile
constexpr int TD = 32;       // depth of one staged k-chunk
constexpr int THREADS = 256; // 16 x 16 threads, each a 4 x 4 micro-tile
constexpr int LDS = TQ + 1;  // padded shared-memory row (TQ == TN)

enum Metric { kL2 = 0, kDot = 1, kCos = 2 };

// (da, ia) ranks before (db, ib). An empty slot holds id -1, which as an
// unsigned value is larger than any row id, so it ranks last among equals.
__device__ __forceinline__ bool better(float da, int ia, float db, int ib) {
  return da < db || (da == db && (unsigned)ia < (unsigned)ib);
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The query operand in the table's precision.
__device__ __forceinline__ float query_operand(float v, const float*) { return v; }
__device__ __forceinline__ float query_operand(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const float* __restrict__ q, const T* __restrict__ x,
            const float* __restrict__ xnorm2, const uint8_t* __restrict__ mask,
            int B, int N, int d, int k, int metric, int rows_per_split,
            float* __restrict__ part_d, int* __restrict__ part_i) {
  extern __shared__ float smem[];
  float* qs = smem;              // [TD][LDS] query chunk, transposed
  float* xs = qs + TD * LDS;     // [TD][LDS] corpus chunk, transposed
  float* sc = xs + TD * LDS;     // [TQ][LDS] score tile
  float* qn = sc + TQ * LDS;     // [TQ] |q|^2
  float* lst_d = qn + TQ;        // [TQ][k] sorted lists
  int* lst_i = reinterpret_cast<int*>(lst_d + TQ * k);

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.y * TQ;
  const int split = blockIdx.x;
  const int r_begin = split * rows_per_split;
  const int r_end = min(N, r_begin + rows_per_split);

  for (int e = tid; e < TQ * k; e += THREADS) {
    lst_d[e] = INFINITY;
    lst_i[e] = -1;
  }
  if (tid < TQ) {
    float s = 0.f;
    const int qi = q0 + tid;
    if (qi < B)
      for (int j = 0; j < d; ++j) {
        const float v = q[(size_t)qi * d + j];
        s = fmaf(v, v, s);
      }
    qn[tid] = s;
  }
  // The owner thread's k-th entry: the bar a candidate must beat.
  float th_d = INFINITY;
  int th_i = -1;
  __syncthreads();

  for (int n0 = r_begin; n0 < r_end; n0 += TN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += TD) {
      for (int e = tid; e < TQ * TD; e += THREADS) {
        const int r = e / TD, c = e % TD;
        const int qi = q0 + r, dc = d0 + c;
        const float v = (qi < B && dc < d) ? q[(size_t)qi * d + dc] : 0.f;
        qs[c * LDS + r] = query_operand(v, x);
      }
      for (int e = tid; e < TN * TD; e += THREADS) {
        const int r = e / TD, c = e % TD;
        const int row = n0 + r, dc = d0 + c;
        xs[c * LDS + r] =
            (row < r_end && dc < d) ? load_f(x + (size_t)row * d + dc) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < TD; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[c * LDS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = xs[c * LDS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = ty + 16 * i, nn = tx + 16 * j, row = n0 + nn;
        float s = INFINITY;
        if (row < r_end && (mask == nullptr || mask[row])) {
          const float p = acc[i][j];
          s = metric == kL2 ? qn[m] + xnorm2[row] - 2.f * p
              : metric == kDot ? -p
                               : 1.f - p;
        }
        sc[m * LDS + nn] = s;
      }
    __syncthreads();

    if (tid < TQ && q0 + tid < B) {
      float* dl = lst_d + tid * k;
      int* il = lst_i + tid * k;
      for (int nn = 0; nn < TN; ++nn) {
        const float s = sc[tid * LDS + nn];
        const int row = n0 + nn;
        if (!isfinite(s) || !better(s, row, th_d, th_i)) continue;
        int p = k - 1;
        while (p > 0 && better(s, row, dl[p - 1], il[p - 1])) {
          dl[p] = dl[p - 1];
          il[p] = il[p - 1];
          --p;
        }
        dl[p] = s;
        il[p] = row;
        th_d = dl[k - 1];
        th_i = il[k - 1];
      }
    }
    __syncthreads();
  }

  const int splits = gridDim.x;
  for (int e = tid; e < TQ * k; e += THREADS) {
    const int m = e / k, j = e % k, qi = q0 + m;
    if (qi < B) {
      const size_t o = ((size_t)qi * splits + split) * k + j;
      part_d[o] = lst_d[e];
      part_i[o] = lst_i[e];
    }
  }
}

// One block per query: each valid candidate's final rank is its position in
// its own sorted list plus, for every other list, the number of entries that
// rank before it (a binary search). Row ranges of the splits are disjoint,
// so ranks are distinct and every rank < k is written exactly once.
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
    for (int t = 0; t < splits && rank < k; ++t) {
      if (t == s) continue;
      const float* td = pd + t * k;
      const int* ti = pi + t * k;
      int lo = 0, hi = k;
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (better(td[mid], ti[mid], dc, ic))
          lo = mid + 1;
        else
          hi = mid;
      }
      rank += lo;
    }
    if (rank < k) {
      od[rank] = dc;
      oi[rank] = ic;
    }
  }
}

template <typename T>
cudaError_t launch_scan(const float* q, const T* x, const float* xnorm2,
                        const uint8_t* mask, int B, int N, int d, int k,
                        int metric, int rows_per_split, int splits,
                        float* pd, int* pi, cudaStream_t st) {
  const size_t smem =
      (size_t)(2 * TD * LDS + TQ * LDS + TQ) * sizeof(float) +
      (size_t)TQ * k * (sizeof(float) + sizeof(int));
  cudaError_t e = cudaFuncSetAttribute(
      scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(splits, (B + TQ - 1) / TQ);
  scan_kernel<T><<<grid, THREADS, smem, st>>>(q, x, xnorm2, mask, B, N, d, k,
                                              metric, rows_per_split, pd, pi);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B,d] f32; x [N,d] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); xnorm2 [N] f32
// (read for l2 only); mask [N] bytes or NULL. With splits > 1, part_d/part_i
// are [B, splits, k] scratch and the merge writes out_d/out_i [B, k]; with
// splits == 1 the scan writes out_d/out_i directly. Returns the CUDA error
// code of the launches (0 on success).
int vecgo_scan_topk(const void* q, const void* x, int x_bf16,
                    const void* xnorm2, const void* mask, int B, int N, int d,
                    int k, int metric, int rows_per_split, int splits,
                    void* part_d, void* part_i, void* out_d, void* out_i,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool direct = splits == 1;
  float* pd = static_cast<float*>(direct ? out_d : part_d);
  int* pi = static_cast<int*>(direct ? out_i : part_i);
  const float* qf = static_cast<const float*>(q);
  const float* xn = static_cast<const float*>(xnorm2);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  cudaError_t e =
      x_bf16 ? launch_scan(qf, static_cast<const __nv_bfloat16*>(x), xn, mk, B,
                           N, d, k, metric, rows_per_split, splits, pd, pi, st)
             : launch_scan(qf, static_cast<const float*>(x), xn, mk, B, N, d,
                           k, metric, rows_per_split, splits, pd, pi, st);
  if (e != cudaSuccess || direct) return (int)e;
  merge_kernel<<<B, 128, 0, st>>>(pd, pi, splits, k, static_cast<float*>(out_d),
                                  static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

const char* vecgo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
