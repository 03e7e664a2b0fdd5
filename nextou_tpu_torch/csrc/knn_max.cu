// K1 on Hopper: fused kNN + per-channel neighbour max (inference forward).
//
// Replaces the Pallas TPU kernel nextou_tpu/kernels/knn.py::_kernel
// (launched by _knn_max_pallas). For every query row n of graph b:
//
//   dist[m] = (x_sq[n] - 2 * <xn[n], yn[m]>) + y_sq[m]  (+ rel[n, m])
//   S       = the k smallest dist by (distance, index): ties -> lowest index
//   out[n]  = per-channel max over m in S of yv[m]       (f32, from -inf)
//
// Square-sums and the inner product accumulate in f32 from coordinate-dtype
// inputs (bf16 or f32): bf16 products are exact in f32. The gather reads the
// selected rows of yv by index, so it is exact. Distances, indices and the
// gathered rows never reach device memory.
//
// What bounds it on the card: the distance product is N*M*C multiply-adds
// per graph (15 G at the largest flagship call, 4 x 10752 x 1344 x 264), the
// gather N*k*C reads (from L2: one graph's yv is at most ~0.9 MB). This first
// design is simple and right, and leaves on the table:
//   - the tensor cores: the product runs as f32 FMAs from shared memory
//     (about a third of the f32 FMA peak at best, bound by shared-memory
//     loads); a wgmma/mma.sync bf16 product would be ~10x faster;
//   - TMA / cp.async double buffering of the candidate chunks;
//   - the recomputation of the query tile's square-sums per chunk.
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
//     That keeps the order by (distance, index): the TPU kernel's k rounds
//     of first-occurrence argmin select the same set;
//   - then each warp gathers its rows' k winners by index, 32 channels per
//     step, and writes the max.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>

namespace {

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

template <typename T, bool HAS_REL>
__global__ void __launch_bounds__(THREADS) knn_max_kernel(
    const T* __restrict__ xn, const T* __restrict__ yn,
    const T* __restrict__ yv, const float* __restrict__ rel,
    float* __restrict__ out, int N, int M, int C, int k, int n_tiles) {
  __shared__ float qs[KC][TQ + 1];      // query slab, channel-major
  __shared__ float ys[KC][TM + 1];      // candidate slab, channel-major
  __shared__ float dist[TQ][TM + 1];    // the chunk's distances
  __shared__ float xsq[TQ];
  __shared__ float ysq[TM];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * TQ;
  const T* xb = xn + (size_t)b * N * C;
  const T* yb = yn + (size_t)b * M * C;
  const T* vb = yv + (size_t)b * M * C;

  // GEMM micro-tile: rows 2*ty + {0, 1}, candidates tx + 16*{0..3}
  const int ty = tid >> 4;
  const int tx = tid & 15;

  float topd[ROWS_PER_WARP];
  int topi[ROWS_PER_WARP];
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
        qs[kk][r] = (n < N && c < C) ? to_f32(xb[(size_t)n * C + c]) : 0.f;
      }
      for (int i = tid; i < TM * KC; i += THREADS) {
        const int r = i / KC, kk = i % KC;
        const int m = m0 + r, c = c0 + kk;
        ys[kk][r] = (m < M && c < C) ? to_f32(yb[(size_t)m * C + c]) : 0.f;
      }
      __syncthreads();
      if (tid < TQ) {
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) sq = fmaf(qs[kk][tid], qs[kk][tid], sq);
      } else if (tid < TQ + TM) {
        const int r = tid - TQ;
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) sq = fmaf(ys[kk][r], ys[kk][r], sq);
      }
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float a0 = qs[kk][2 * ty];
        const float a1 = qs[kk][2 * ty + 1];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bv = ys[kk][tx + 16 * j];
          acc[0][j] = fmaf(a0, bv, acc[0][j]);
          acc[1][j] = fmaf(a1, bv, acc[1][j]);
        }
      }
      __syncthreads();
    }

    if (tid < TQ) {
      xsq[tid] = sq;
    } else if (tid < TQ + TM) {
      ysq[tid - TQ] = sq;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 2 * ty + i, col = tx + 16 * j;
        const int n = n0 + r, m = m0 + col;
        float d = (xsq[r] - 2.f * acc[i][j]) + ysq[col];
        if (HAS_REL && n < N && m < M) d += rel[(size_t)n * M + m];
        dist[r][col] = (m < M) ? d : INFINITY;  // padding never selected
      }
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      if (n0 + r >= N) continue;  // warp-uniform
#pragma unroll
      for (int g = 0; g < TM; g += 32) {
        const float dl = dist[r][g + lane];
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

#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int n = n0 + warp * ROWS_PER_WARP + rr;
    if (n >= N) continue;  // warp-uniform
    float* orow = out + ((size_t)b * N + n) * C;
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      float mx = -INFINITY;
      for (int j = 0; j < k; ++j) {
        const int m = __shfl_sync(FULL, topi[rr], j);
        if (c < C) mx = fmaxf(mx, to_f32(vb[(size_t)m * C + c]));
      }
      if (c < C) orow[c] = mx;
    }
  }
}

template <typename T>
void launch(const void* xn, const void* yn, const void* yv, const float* rel,
            float* out, int B, int N, int M, int C, int k, cudaStream_t stream) {
  const int n_tiles = (N + TQ - 1) / TQ;
  const dim3 grid((unsigned)B * (unsigned)n_tiles);
  if (rel != nullptr) {
    knn_max_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        (const T*)xn, (const T*)yn, (const T*)yv, rel, out, N, M, C, k, n_tiles);
  } else {
    knn_max_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        (const T*)xn, (const T*)yn, (const T*)yv, rel, out, N, M, C, k, n_tiles);
  }
}

}  // namespace

// xn (B,N,C), yn (B,M,C): normalized coordinates; yv (B,M,C): raw candidate
// values; all three bf16 (bf16 != 0) or all three f32. rel: (N,M) f32 or
// NULL; out (B,N,C) f32. All contiguous, on the device of `stream`.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int knn_max_forward(const void* xn, const void* yn, const void* yv,
                               const void* rel, void* out, int B, int N, int M,
                               int C, int k, int bf16, void* stream) {
  if (B < 1 || N < 1 || M < 1 || C < 1 || k < 1 || k > KMAX || k > M ||
      (long long)B * ((N + TQ - 1) / TQ) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const float* r = (const float*)rel;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    launch<__nv_bfloat16>(xn, yn, yv, r, o, B, N, M, C, k, s);
  } else {
    launch<float>(xn, yn, yv, r, o, B, N, M, C, k, s);
  }
  return (int)cudaGetLastError();
}
