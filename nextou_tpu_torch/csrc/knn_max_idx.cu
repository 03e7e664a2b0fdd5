// K3 and K2 on Hopper: the training forward of the kNN neighbour max, which
// also emits the selected indices, and the same selection with the indices
// as its only output.
//
// K3 (knn_max_idx_forward) replaces the Pallas TPU kernel
// nextou_tpu/kernels/knn.py::_maxidx_kernel (launched by
// _knn_max_idx_pallas); K2 (knn_indices_forward) replaces ::_idx_kernel
// (launched by _knn_indices_pallas). For every query row n of graph b:
//
//   S        = the k nearest candidates by (distance, index), knn_select.cuh
//   idx[n]   = S in selection order, nearest first (int32)
//   out[n]   = per-channel max over m in S of yv[m]   (f32; K3 only)
//
// Coordinates are f32 and the distance product is full f32 FMAs, never
// TF32: training selects on f32 coordinates, and a selection that differs
// between the forward and the saved indices would misroute the gradient.
// The values may be bf16 (a bf16 model) or f32; the gather is by index and
// exact either way.
//
// What bounds them on the card: operations. The distance product is
// 2*B*N*M*C f32 operations (15 GFLOP at the largest flagship train call,
// 2 x 10752 x 1344 x 264), 0.23 ms at the card's 67 TFLOP/s f32 rate, against
// 0.03 ms for its bytes. The design is K1's (one CTA per graph and 32 query
// rows, candidates streamed through shared memory, a sorted running top-k in
// one warp's lanes); the index output costs one coalesced store per row.
// Left for later: the product reaches a fraction of the f32 FMA peak (bound
// by shared-memory loads), Swin windows are not batched per CTA, and no
// TMA / cp.async double buffering.

#include "knn_select.cuh"

namespace {

using namespace knn;

// WITH_MAX = false is K2: yv and out are unused.
template <typename TV, bool HAS_REL, bool WITH_MAX>
__global__ void __launch_bounds__(THREADS) knn_idx_kernel(
    const float* __restrict__ xn, const float* __restrict__ yn,
    const TV* __restrict__ yv, const float* __restrict__ rel,
    float* __restrict__ out, int* __restrict__ idx, int N, int M, int C, int k,
    int n_tiles) {
  __shared__ SelectSmem smem;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * TQ;
  int topi[ROWS_PER_WARP];
  select_topk<float, HAS_REL>(xn + (size_t)b * N * C, yn + (size_t)b * M * C,
                              rel, N, M, C, k, n0, smem, topi);
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int n = n0 + warp * ROWS_PER_WARP + rr;
    if (n >= N) continue;  // warp-uniform
    if (lane < k) idx[((size_t)b * N + n) * k + lane] = topi[rr];
    if constexpr (WITH_MAX) {
      gather_max(yv + (size_t)b * M * C, topi[rr], k, C,
                 out + ((size_t)b * N + n) * C);
    }
  }
}

template <typename TV, bool WITH_MAX>
void launch(const float* xn, const float* yn, const void* yv, const float* rel,
            float* out, int* idx, int B, int N, int M, int C, int k,
            cudaStream_t stream) {
  const int n_tiles = (N + TQ - 1) / TQ;
  const dim3 grid((unsigned)B * (unsigned)n_tiles);
  if (rel != nullptr) {
    knn_idx_kernel<TV, true, WITH_MAX><<<grid, THREADS, 0, stream>>>(
        xn, yn, (const TV*)yv, rel, out, idx, N, M, C, k, n_tiles);
  } else {
    knn_idx_kernel<TV, false, WITH_MAX><<<grid, THREADS, 0, stream>>>(
        xn, yn, (const TV*)yv, rel, out, idx, N, M, C, k, n_tiles);
  }
}

}  // namespace

// K3. xn (B,N,C), yn (B,M,C): normalized f32 coordinates; yv (B,M,C): raw
// candidate values, bf16 (values_bf16 != 0) or f32; rel: (N,M) f32 or NULL;
// out (B,N,C) f32; idx (B,N,k) int32. All contiguous, on the device of
// `stream`. Returns the cudaError_t of the launch (0 on success).
extern "C" int knn_max_idx_forward(const void* xn, const void* yn,
                                   const void* yv, const void* rel, void* out,
                                   void* idx, int B, int N, int M, int C, int k,
                                   int values_bf16, void* stream) {
  if (bad_shape(B, N, M, C, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (values_bf16) {
    launch<__nv_bfloat16, true>((const float*)xn, (const float*)yn, yv,
                                (const float*)rel, (float*)out, (int*)idx, B, N,
                                M, C, k, s);
  } else {
    launch<float, true>((const float*)xn, (const float*)yn, yv,
                        (const float*)rel, (float*)out, (int*)idx, B, N, M, C,
                        k, s);
  }
  return (int)cudaGetLastError();
}

// K2. As K3 without values: idx (B,N,k) int32 is the only output.
extern "C" int knn_indices_forward(const void* xn, const void* yn,
                                   const void* rel, void* idx, int B, int N,
                                   int M, int C, int k, void* stream) {
  if (bad_shape(B, N, M, C, k)) return (int)cudaErrorInvalidValue;
  launch<float, false>((const float*)xn, (const float*)yn, nullptr,
                       (const float*)rel, nullptr, (int*)idx, B, N, M, C, k,
                       (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
