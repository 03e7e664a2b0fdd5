// K1 on Hopper: fused kNN + per-channel neighbour max (inference forward).
//
// Replaces the Pallas TPU kernel nextou_tpu/kernels/knn.py::_kernel
// (launched by _knn_max_pallas). For every query row n of graph b:
//
//   S       = the k nearest candidates by (distance, index), knn_select.cuh
//   out[n]  = per-channel max over m in S of yv[m]       (f32, from -inf)
//
// The gather reads the selected rows of yv by index, so it is exact.
// Distances, indices and the gathered rows never reach device memory.
//
// What bounds it on the card: the distance product is N*M*C multiply-adds
// per graph (15 G at the largest flagship call, 4 x 10752 x 1344 x 264), the
// gather N*k*C reads (from L2: one graph's yv is at most ~0.9 MB). By bytes
// alone the card would need 0.04 ms at that call; this first design is
// simple and right, and leaves on the table:
//   - the tensor cores: the product runs as f32 FMAs from shared memory
//     (about a third of the f32 FMA peak at best, bound by shared-memory
//     loads); a wgmma/mma.sync bf16 product would be ~10x faster;
//   - TMA / cp.async double buffering of the candidate chunks;
//   - the recomputation of the query tile's square-sums per chunk.
//
// Design: one CTA per (graph, 32 query rows) runs the shared streamed
// selection (knn_select.cuh), then each warp gathers its rows' k winners by
// index, 32 channels per step, and writes the max.

#include "knn_select.cuh"

namespace {

using namespace knn;

template <typename T, bool HAS_REL>
__global__ void __launch_bounds__(THREADS) knn_max_kernel(
    const T* __restrict__ xn, const T* __restrict__ yn,
    const T* __restrict__ yv, const float* __restrict__ rel,
    float* __restrict__ out, int N, int M, int C, int k, int n_tiles) {
  __shared__ SelectSmem smem;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * TQ;
  int topi[ROWS_PER_WARP];
  select_topk<T, HAS_REL>(xn + (size_t)b * N * C, yn + (size_t)b * M * C, rel,
                          N, M, C, k, n0, smem, topi);
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int n = n0 + warp * ROWS_PER_WARP + rr;
    if (n >= N) continue;  // warp-uniform
    gather_max(yv + (size_t)b * M * C, topi[rr], k, C,
               out + ((size_t)b * N + n) * C);
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
  if (bad_shape(B, N, M, C, k)) return (int)cudaErrorInvalidValue;
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
