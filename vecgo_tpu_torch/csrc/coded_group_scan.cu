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
// (cluster c, tile t) reads its own query ids from the inverted table
// qtab [K, qcap] (query index, or B for an empty slot) and gathers the
// queries itself; a tile with no real query exits after writing (+inf, -1).
//
// What bounds it on the H100: at the main shapes (B = 4096, d = 128,
// K ~ 3,000 clusters of S = 1024, 4 probes) a batch reads ~0.4 GB of codes
// and does ~4.3 GFLOP, so the codes' bytes bound it (~0.12 ms at 3.35 TB/s);
// the arithmetic is small (about 5 queries probe a cluster). The design
// reads each cluster's codes once per 8-query tile, 4 bytes a thread,
// coalesced, into shared memory (rows padded to an odd word count so that
// the 64 row-owning lanes hit distinct banks), scores them on the SIMT f32
// units, and keeps one warp per query whose kk <= 32 list lives in
// registers, one entry per lane: a candidate is tested against the list's
// last entry, and an insertion is one ballot plus one shuffle. 16-byte loads,
// TMA and tensor cores are later steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 8;              // query slots per block, one warp each
constexpr int THREADS = QT * 32;   // 256
constexpr int ROWS = 64;           // code rows per staged chunk
constexpr int GROUPS = THREADS / ROWS;  // query groups in the scoring pass
constexpr float BIG = 3.0e38f;
constexpr unsigned FULL = 0xffffffffu;

// (da, ia) ranks before (db, ib); an empty entry holds id -1, which as an
// unsigned value ranks after every real column among equal scores.
__device__ __forceinline__ bool better(float da, int ia, float db, int ib) {
  return da < db || (da == db && (unsigned)ia < (unsigned)ib);
}

__device__ __forceinline__ float code_at(int packed, int byte) {
  return (float)((int)((unsigned)packed << (24 - 8 * byte)) >> 24);  // int8, sign-extended
}

// dp = d rounded up to a multiple of 4; ws = words per staged code row (odd).
__global__ void __launch_bounds__(THREADS)
coded_scan_kernel(const float* __restrict__ q, const int* __restrict__ qtab,
                  const int8_t* __restrict__ codes, const float* __restrict__ bn,
                  const float* __restrict__ scale, const float* __restrict__ cent,
                  int B, int qcap, int S, int d, int dp, int ws, int kk,
                  float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                         // [QT][dp] bf16-rounded residuals
  float* qn = qs + QT * dp;                 // [QT] |q - c|^2
  float* sc = qn + QT;                      // [QT][ROWS] chunk scores
  int* cs = reinterpret_cast<int*>(sc + QT * ROWS);  // [ROWS][ws] packed codes
  __shared__ int qidx[QT];

  const int c = blockIdx.x;
  const int slot0 = blockIdx.y * QT;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const size_t cbase = (size_t)c * S;

  if (tid < QT) {
    const int slot = slot0 + tid;
    const int qi = slot < qcap ? qtab[(size_t)c * qcap + slot] : B;
    qidx[tid] = (qi >= 0 && qi < B) ? qi : -1;
  }
  __syncthreads();
  int nact = 0;
#pragma unroll
  for (int j = 0; j < QT; ++j) nact += qidx[j] >= 0;

  const int my_q = qidx[warp];
  float ld = INFINITY;  // this lane's list entry (lanes < kk)
  int li = -1;

  if (nact > 0) {
    if (my_q >= 0) {
      float s = 0.f;
      for (int i = lane; i < dp; i += 32) {
        const float v = i < d ? q[(size_t)my_q * d + i] - cent[(size_t)c * d + i] : 0.f;
        s = fmaf(v, v, s);
        qs[warp * dp + i] = __bfloat162float(__float2bfloat16(v));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
      if (lane == 0) qn[warp] = s;
    }
    const float scl = scale[c];
    const int wd = dp / 4;
    float th_d = INFINITY;  // the list's kk-th entry: the bar to beat
    int th_i = -1;

    for (int r0 = 0; r0 < S; r0 += ROWS) {
      // Stage ROWS code rows, 4 bytes a thread, zero past d and past S.
      for (int e = tid; e < ROWS * wd; e += THREADS) {
        const int row = e / wd, w = e % wd;
        int v = 0;
        if (r0 + row < S) {
          const int8_t* src = codes + (cbase + r0 + row) * d;
          if ((d & 3) == 0) {
            v = reinterpret_cast<const int*>(src)[w];
          } else {
#pragma unroll
            for (int b = 0; b < 4; ++b)
              if (4 * w + b < d) v |= (int)(uint8_t)src[4 * w + b] << (8 * b);
          }
        }
        cs[row * ws + w] = v;
      }
      __syncthreads();

      // Score: thread -> one row of the chunk for every GROUPS-th query slot.
      {
        const int r = tid % ROWS;
        const bool row_ok = r0 + r < S;
        const float bnr = row_ok ? bn[cbase + r0 + r] : INFINITY;
        for (int j = tid / ROWS; j < QT; j += GROUPS) {
          float s = INFINITY;
          if (qidx[j] >= 0 && row_ok) {
            const float4* qv = reinterpret_cast<const float4*>(qs + j * dp);
            const int* cr = cs + r * ws;
            float acc = 0.f;
            for (int w = 0; w < wd; ++w) {
              const float4 a = qv[w];
              const int p = cr[w];
              acc = fmaf(a.x, code_at(p, 0), acc);
              acc = fmaf(a.y, code_at(p, 1), acc);
              acc = fmaf(a.z, code_at(p, 2), acc);
              acc = fmaf(a.w, code_at(p, 3), acc);
            }
            s = qn[j] + bnr - 2.f * (scl * acc);
          }
          sc[j * ROWS + r] = s;
        }
      }
      __syncthreads();

      // Select: warp `warp` folds the chunk into its query's list.
      if (my_q >= 0) {
#pragma unroll
        for (int half = 0; half < ROWS / 32; ++half) {
          const int r = half * 32 + lane;
          const float s = sc[warp * ROWS + r];
          const int col = r0 + r;
          const bool pass = r0 + r < S && isfinite(s) && s < BIG &&
                            better(s, col, th_d, th_i);
          unsigned m = __ballot_sync(FULL, pass);
          while (m) {
            const int src = __ffs(m) - 1;
            m &= m - 1;
            const float cd = __shfl_sync(FULL, s, src);
            const int ci = __shfl_sync(FULL, col, src);
            if (!better(cd, ci, th_d, th_i)) continue;  // warp-uniform
            const bool before = lane < kk && better(ld, li, cd, ci);
            const int pos = __popc(__ballot_sync(FULL, before));
            const float up_d = __shfl_up_sync(FULL, ld, 1);
            const int up_i = __shfl_up_sync(FULL, li, 1);
            if (lane == pos) {
              ld = cd;
              li = ci;
            } else if (lane > pos) {
              ld = up_d;
              li = up_i;
            }
            th_d = __shfl_sync(FULL, ld, kk - 1);
            th_i = __shfl_sync(FULL, li, kk - 1);
          }
        }
      }
      __syncthreads();
    }
  }

  const int slot = slot0 + warp;
  if (slot < qcap && lane < kk) {
    const size_t o = ((size_t)c * qcap + slot) * kk + lane;
    const bool found = li >= 0;
    out_d[o] = found ? ld : INFINITY;
    out_i[o] = found ? li : -1;
  }
}

}  // namespace

extern "C" {

// q [B, d] f32; qtab [K, qcap] int32 (query index, B = empty slot); codes
// [K, S, d] int8; bn [K, S] f32 (+inf = padded or masked); scale [K] f32;
// cent [K, d] f32. Writes out_d [K, qcap, kk] f32 and out_i [K, qcap, kk]
// int32 (in-cluster column, -1 empty). 1 <= kk <= min(32, S). Returns the
// CUDA error code of the launch (0 on success).
int vecgo_coded_group_scan(const void* q, const void* qtab, const void* codes,
                           const void* bn, const void* scale, const void* cent,
                           int B, int K, int qcap, int S, int d, int kk,
                           void* out_d, void* out_i, void* stream) {
  const int dp = (d + 3) / 4 * 4;
  const int ws = (dp / 4) | 1;
  const size_t smem = (size_t)(QT * dp + QT + QT * ROWS) * sizeof(float) +
                      (size_t)ROWS * ws * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      coded_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(K, (qcap + QT - 1) / QT);
  coded_scan_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int*>(qtab),
      static_cast<const int8_t*>(codes), static_cast<const float*>(bn),
      static_cast<const float*>(scale), static_cast<const float*>(cent), B, qcap,
      S, d, dp, ws, kk, static_cast<float*>(out_d), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // extern "C"
