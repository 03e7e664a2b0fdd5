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
// Design: the shared selection of knn_select.cuh (the distance product on
// mma.sync, bf16 for bf16 coordinates and 3xTF32 for f32; the query tile
// staged once; candidates through a cp.async ring; Swin windows one per
// CTA), then each warp gathers its rows' k winners by index, two channels
// per lane and load, and writes the max.
//
// What bounds it on the card: the product is 2*B*N*M*C operations (61
// GFLOP over the two s3 pool calls of a batch-4 flagship forward, 114 in
// all: 0.12 ms at the bf16 tensor-core peak), its bytes (coordinates,
// values, the bias once, the f32 max) 0.4 ms per forward. Measured on an
// H100 (PERF.md, chip_smoke.py and tools/exp_knn_dissect.py), it takes 6.7
// ms of device time per forward, 17 times that bound (19.3 in its first
// design, f32 FMAs from shared memory). What holds it there, by T1's
// dissection (f32 coordinates):
//   - the pool graphs (N = 10752): the product, about three quarters of the
//     time, at 17 TFLOP/s of f32-accurate product (52 of TF32). Each
//     288-byte slab is a cp.async wait, a CTA barrier and 9 k steps of a 16
//     x 32 block per warp: too little work per barrier for 16 warps per SM
//     to hide the latencies;
//   - the Swin windows (M = 168): the running top-k and the gather, over
//     half the time (candidates are inserted one at a time, each a chain of
//     warp shuffles), the product under half;
//   - the s5 self-graph (4 x 168 rows, 44 CTAs on 132 SMs): too few CTAs;
//     it did not get faster.
// Left for later: wgmma with TMA and warp-specialised producers in place of
// mma.sync, cp.async and a barrier per slab; a top-k that inserts several
// candidates at once; a persistent grid; candidates split across CTAs for
// the smallest graphs.

#include "knn_select.cuh"

namespace {

using namespace knn;

template <typename T>
struct MaxEmit {
  const T* yv;
  float* out;
  int N, M, C, k;
  __device__ void operator()(int b, int n, float, int topi) const {
    gather_max(yv + (size_t)b * M * C, topi, k, C, out + ((size_t)b * N + n) * C);
  }
};

template <typename T, int TQ, bool WINDOW>
__global__ void __launch_bounds__(THREADS, 2) knn_max_kernel(Args a, const T* __restrict__ yv,
                                                          float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  select_rows<T, TQ, WINDOW, true>(a, smem, MaxEmit<T>{yv, out, a.N, a.M, a.C, a.k});
}

template <typename T>
cudaError_t launch(const Plan& p, const Args& a, const void* yv, float* out,
                   cudaStream_t stream) {
  return with_plan(p, [&](auto tq, auto window) {
    return launch_planned(knn_max_kernel<T, decltype(tq)::value, decltype(window)::value>, p,
                          stream, a, (const T*)yv, out);
  });
}

bool plan_for(const void* xn, const void* yn, int B, int N, int M, int C, int bf16, Plan& p) {
  return make_plan(B, N, M, C, bf16 ? 2 : 4, xn == yn && N == M, xn, yn, p);
}

}  // namespace

// xn (B,N,C), yn (B,M,C): normalized coordinates (yn == xn for a
// self-graph); yv (B,M,C): raw candidate values; all three bf16 (bf16 != 0)
// or all three f32. rel: (N,M) f32 or NULL; out (B,N,C) f32. All
// contiguous, on the device of `stream`. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int knn_max_forward(const void* xn, const void* yn, const void* yv,
                               const void* rel, void* out, int B, int N, int M,
                               int C, int k, int bf16, void* stream) {
  Plan p;
  if (bad_shape(B, N, M, C, k) || !plan_for(xn, yn, B, N, M, C, bf16, p)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{xn, yn, (const float*)rel, B, N, M, C, k, p.vec};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch<__nv_bfloat16>(p, a, yv, (float*)out, s)
                    : launch<float>(p, a, yv, (float*)out, s));
}

// The plan a launch with these arguments takes, for the report: out[5] =
// {query rows per tile, window mode, CTAs, shared memory bytes, CTAs
// resident per SM}. self_graph: the launch passes yn == xn. K2, K3 and T1
// take K1's f32 plan (bf16 = 0). Returns 0, or cudaErrorInvalidValue where
// the launch would be refused.
extern "C" int knn_max_plan(int B, int N, int M, int C, int k, int bf16, int self_graph,
                            void* out) {
  Plan p;
  // addresses aligned as torch allocates; one for a self-graph
  const void* x = (const void*)256;
  const void* y = self_graph ? x : (const void*)512;
  if (bad_shape(B, N, M, C, k) || !plan_for(x, y, B, N, M, C, bf16, p)) {
    return (int)cudaErrorInvalidValue;
  }
  int* o = (int*)out;
  with_plan(p, [&](auto tq, auto window) {
    constexpr int TQ = decltype(tq)::value;
    constexpr bool W = decltype(window)::value;
    if (bf16) {
      report_plan(knn_max_kernel<__nv_bfloat16, TQ, W>, p, o);
    } else {
      report_plan(knn_max_kernel<float, TQ, W>, p, o);
    }
    return cudaSuccess;
  });
  return (int)cudaGetLastError();
}
