// The selection that K1, K2 and K3 share: a streamed running top-k per query
// row, and the gather + per-channel max over the winners.
//
// It replaces the body that the Pallas TPU kernels
// nextou_tpu/kernels/knn.py::_kernel, ::_idx_kernel and ::_maxidx_kernel have
// in common. For every query row n of graph b:
//
//   dist[m] = (x_sq[n] - 2 * <xn[n], yn[m]>) + y_sq[m]  (+ rel[n, m])
//   S       = the k smallest dist by (distance, index): ties -> lowest index
//
// Square-sums and the inner product accumulate in f32 from coordinate-dtype
// inputs (bf16 or f32) as f32 FMAs, never on the tensor cores: bf16 products
// are exact in f32, and f32 coordinates (training) stay full f32, not TF32.
//
// Design. A Pallas block keeps all M candidates in VMEM; an SM's 227 KB
// cannot hold them (the enc3 candidate block alone is 1344 x 264 bf16), so:
//   - one CTA per (graph b, tile of TQ = 32 query rows), 8 warps;
//   - candidates stream through shared memory in chunks of TM = 64, the
//     channel axis in slabs of KC = 32 (a tiled f32 GEMM, 2 x 4 per thread);
//   - each warp owns 4 query rows and keeps, per row, a sorted running top-k
//     spread over its lanes (lane j holds the j-th nearest). Candidates are
//     offered in increasing index order; one is inserted only when strictly
//     nearer than the current k-th, after every entry that is not farther.
//     That keeps the order by (distance, index): the TPU kernels' k rounds
//     of first-occurrence argmin select the same set in the same order.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>

namespace knn {

constexpr int TQ = 32;       // query rows per CTA
constexpr int TM = 64;       // candidates per chunk
constexpr int KC = 32;       // channels per slab of the distance product
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = TQ / WARPS;
constexpr int KMAX = 32;     // the running top-k lives in one warp's lanes
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct SelectSmem {
  float qs[KC][TQ + 1];      // query slab, channel-major
  float ys[KC][TM + 1];      // candidate slab, channel-major
  float dist[TQ][TM + 1];    // the chunk's distances
  float xsq[TQ];
  float ysq[TM];
};

// Every thread of the CTA calls this. On return, for each of the warp's rows
// rr (query row n0 + warp * ROWS_PER_WARP + rr, where that is < N), lane
// j < k holds the j-th nearest candidate's index in topi[rr].
template <typename T, bool HAS_REL>
__device__ __forceinline__ void select_topk(
    const T* __restrict__ xb, const T* __restrict__ yb,
    const float* __restrict__ rel, int N, int M, int C, int k, int n0,
    SelectSmem& s, int (&topi)[ROWS_PER_WARP]) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // GEMM micro-tile: rows 2*ty + {0, 1}, candidates tx + 16*{0..3}
  const int ty = tid >> 4;
  const int tx = tid & 15;

  float topd[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    topd[r] = INFINITY;
    topi[r] = 0;
  }

  for (int m0 = 0; m0 < M; m0 += TM) {
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    // threads [0, TQ) sum x_sq of query row tid, [TQ, TQ+TM) y_sq of
    // candidate tid-TQ, in the same channel order as the inner products
    // (so a self-graph's own distance is exactly 0)
    float sq = 0.f;

    for (int c0 = 0; c0 < C; c0 += KC) {
      for (int i = tid; i < TQ * KC; i += THREADS) {
        const int r = i / KC, kk = i % KC;
        const int n = n0 + r, c = c0 + kk;
        s.qs[kk][r] = (n < N && c < C) ? to_f32(xb[(size_t)n * C + c]) : 0.f;
      }
      for (int i = tid; i < TM * KC; i += THREADS) {
        const int r = i / KC, kk = i % KC;
        const int m = m0 + r, c = c0 + kk;
        s.ys[kk][r] = (m < M && c < C) ? to_f32(yb[(size_t)m * C + c]) : 0.f;
      }
      __syncthreads();
      if (tid < TQ) {
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) sq = fmaf(s.qs[kk][tid], s.qs[kk][tid], sq);
      } else if (tid < TQ + TM) {
        const int r = tid - TQ;
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) sq = fmaf(s.ys[kk][r], s.ys[kk][r], sq);
      }
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float a0 = s.qs[kk][2 * ty];
        const float a1 = s.qs[kk][2 * ty + 1];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bv = s.ys[kk][tx + 16 * j];
          acc[0][j] = fmaf(a0, bv, acc[0][j]);
          acc[1][j] = fmaf(a1, bv, acc[1][j]);
        }
      }
      __syncthreads();
    }

    if (tid < TQ) {
      s.xsq[tid] = sq;
    } else if (tid < TQ + TM) {
      s.ysq[tid - TQ] = sq;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 2 * ty + i, col = tx + 16 * j;
        const int n = n0 + r, m = m0 + col;
        float d = (s.xsq[r] - 2.f * acc[i][j]) + s.ysq[col];
        if (HAS_REL && n < N && m < M) d += rel[(size_t)n * M + m];
        s.dist[r][col] = (m < M) ? d : INFINITY;  // padding never selected
      }
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      if (n0 + r >= N) continue;  // warp-uniform
#pragma unroll
      for (int g = 0; g < TM; g += 32) {
        const float dl = s.dist[r][g + lane];
        float worst = __shfl_sync(FULL, topd[rr], k - 1);
        unsigned pass = __ballot_sync(FULL, dl < worst);
        while (pass) {  // lowest lane (= lowest index) first
          const int src = __ffs(pass) - 1;
          const float d = __shfl_sync(FULL, dl, src);
          // entries not farther than d stay ahead of it
          const int pos = __popc(__ballot_sync(FULL, lane < k && topd[rr] <= d));
          const float pd = __shfl_up_sync(FULL, topd[rr], 1);
          const int pi = __shfl_up_sync(FULL, topi[rr], 1);
          if (lane > pos) {
            topd[rr] = pd;
            topi[rr] = pi;
          } else if (lane == pos) {
            topd[rr] = d;
            topi[rr] = m0 + g + src;
          }
          worst = __shfl_sync(FULL, topd[rr], k - 1);
          pass &= ~((2u << src) - 1u);  // drop lanes <= src
          pass &= __ballot_sync(FULL, dl < worst);
        }
      }
    }
    __syncthreads();  // dist / xsq / ysq are rewritten by the next chunk
  }
}

// One warp: the per-channel max over the k rows of vb that the lanes' topi
// name, written to orow (C floats). The rows are read by index, so the
// gather is exact.
template <typename TV>
__device__ __forceinline__ void gather_max(
    const TV* __restrict__ vb, int topi, int k, int C, float* __restrict__ orow) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    float mx = -INFINITY;
    for (int j = 0; j < k; ++j) {
      const int m = __shfl_sync(FULL, topi, j);
      if (c < C) mx = fmaxf(mx, to_f32(vb[(size_t)m * C + c]));
    }
    if (c < C) orow[c] = mx;
  }
}

// Arguments every forward entry point refuses.
inline bool bad_shape(int B, int N, int M, int C, int k) {
  return B < 1 || N < 1 || M < 1 || C < 1 || k < 1 || k > KMAX || k > M ||
         (long long)B * ((N + TQ - 1) / TQ) > 0x7fffffffLL;
}

}  // namespace knn
