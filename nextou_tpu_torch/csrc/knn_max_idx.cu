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
// Coordinates are f32 and the distance product keeps f32 accuracy: 3xTF32
// on mma.sync (knn_select.cuh, with its error bound), never one TF32 pass:
// training selects on f32 coordinates, and a selection that differs between
// the forward and the saved indices would misroute the gradient. The values
// may be bf16 (a bf16 model) or f32; the gather is by index and exact either
// way.
//
// What bounds them on the card: operations. The distance product is
// 2*B*N*M*C terms (15 GFLOP at the largest flagship train call, 2 x 10752 x
// 1344 x 264, 57 over a train step's 14 calls), each three TF32 products at
// 495 TFLOP/s: 0.34 ms a step, against 0.2 ms for the bytes. The design is
// K1's (knn_select.cuh); the index output costs one coalesced store per
// row. Measured on an H100 (PERF.md): K3 takes 6.4 ms of device time per
// train step (10.0 in its first design, f32 FMAs). As in K1, the product
// of the pool graphs runs far under the tensor cores' rate (one barrier per
// 288-byte slab, and the split's conversions: 24 per k step and warp
// beside 6 mma), and the Swin windows are held by the top-k and the gather.
// Left as for K1: wgmma / TMA / warp specialisation, a top-k that inserts
// several candidates at once, a persistent grid.

#include "knn_select.cuh"

namespace {

using namespace knn;

// WITH_MAX = false is K2: yv and out are unused.
template <typename TV, bool WITH_MAX>
struct IdxEmit {
  const TV* yv;
  float* out;
  int* idx;
  int N, M, C, k;
  __device__ void operator()(int b, int n, float, int topi) const {
    if ((int)(threadIdx.x & 31) < k) idx[((size_t)b * N + n) * k + (threadIdx.x & 31)] = topi;
    if constexpr (WITH_MAX) {
      gather_max(yv + (size_t)b * M * C, topi, k, C, out + ((size_t)b * N + n) * C);
    }
  }
};

template <typename TV, bool WITH_MAX, int TQ, bool WINDOW>
__global__ void __launch_bounds__(THREADS, 2) knn_idx_kernel(Args a, const TV* __restrict__ yv,
                                                          float* __restrict__ out,
                                                          int* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned char smem[];
  select_rows<float, TQ, WINDOW, true>(
      a, smem, IdxEmit<TV, WITH_MAX>{yv, out, idx, a.N, a.M, a.C, a.k});
}

template <typename TV, bool WITH_MAX>
cudaError_t launch(const Plan& p, const Args& a, const void* yv, float* out, int* idx,
                   cudaStream_t stream) {
  return with_plan(p, [&](auto tq, auto window) {
    return launch_planned(
        knn_idx_kernel<TV, WITH_MAX, decltype(tq)::value, decltype(window)::value>, p, stream,
        a, (const TV*)yv, out, idx);
  });
}

bool plan_for(const void* xn, const void* yn, int B, int N, int M, int C, Plan& p) {
  return make_plan(B, N, M, C, 4, xn == yn && N == M, xn, yn, p);
}

}  // namespace

// K3. xn (B,N,C), yn (B,M,C): normalized f32 coordinates (yn == xn for a
// self-graph); yv (B,M,C): raw candidate values, bf16 (values_bf16 != 0)
// or f32; rel: (N,M) f32 or NULL; out (B,N,C) f32; idx (B,N,k) int32. All
// contiguous, on the device of `stream`. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int knn_max_idx_forward(const void* xn, const void* yn,
                                   const void* yv, const void* rel, void* out,
                                   void* idx, int B, int N, int M, int C, int k,
                                   int values_bf16, void* stream) {
  Plan p;
  if (bad_shape(B, N, M, C, k) || !plan_for(xn, yn, B, N, M, C, p)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{xn, yn, (const float*)rel, B, N, M, C, k, p.vec};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(values_bf16
                   ? launch<__nv_bfloat16, true>(p, a, yv, (float*)out, (int*)idx, s)
                   : launch<float, true>(p, a, yv, (float*)out, (int*)idx, s));
}

// K2. As K3 without values: idx (B,N,k) int32 is the only output.
extern "C" int knn_indices_forward(const void* xn, const void* yn,
                                   const void* rel, void* idx, int B, int N,
                                   int M, int C, int k, void* stream) {
  Plan p;
  if (bad_shape(B, N, M, C, k) || !plan_for(xn, yn, B, N, M, C, p)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{xn, yn, (const float*)rel, B, N, M, C, k, p.vec};
  return (int)launch<float, false>(p, a, nullptr, nullptr, (int*)idx, (cudaStream_t)stream);
}
