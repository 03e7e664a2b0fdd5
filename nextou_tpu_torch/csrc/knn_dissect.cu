// T1 on Hopper: the fused kNN + neighbour max with one mechanism taken out
// per mode, to see where its time goes.
//
// Replaces the Pallas TPU probe tools/exp_knn_dissect.py::_kernel (launched
// by run). As there, the inputs are f32 coordinates, bf16 values and an
// (N, M) f32 bias, the output is (B, N, C) f32, and only mode `full` computes
// the real function; the others write something cheap that depends on what
// they did compute, so that the compiler keeps it. The kernel's body is the
// one K1, K2 and K3 share (knn_select.cuh): the streamed f32 distance
// product, the running top-k in a warp's lanes, the gather by index and the
// max. The modes, named after the TPU probe's:
//
//   0 full      product + top-k + gather and max: K1's function
//   1 nosel     product + top-k, no gather: every channel gets the row's
//               k-th distance
//   2 nominext  product + gather and max of candidates 0..k-1, no top-k (the
//               row's least distance is computed instead, and written only
//               where it is NaN)
//   3 distonly  product alone: every channel gets the row's least distance
//
// (`half_k` of the TPU probe is mode 0 launched with k / 2.)
//
// What bounds it: as K1, the product's f32 FMAs from shared memory.

#include "knn_select.cuh"

namespace {

using namespace knn;

enum Mode { MODE_FULL = 0, MODE_NOSEL = 1, MODE_NOMINEXT = 2, MODE_DISTONLY = 3 };

template <int MODE>
__global__ void __launch_bounds__(THREADS) knn_dissect_kernel(
    const float* __restrict__ xn, const float* __restrict__ yn,
    const __nv_bfloat16* __restrict__ yv, const float* __restrict__ rel,
    float* __restrict__ out, int N, int M, int C, int k, int n_tiles) {
  __shared__ SelectSmem smem;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * TQ;
  constexpr bool INSERT = MODE == MODE_FULL || MODE == MODE_NOSEL;
  float topd[ROWS_PER_WARP];
  int topi[ROWS_PER_WARP];
  select_rows<float, true, INSERT>(xn + (size_t)b * N * C, yn + (size_t)b * M * C,
                                   rel, N, M, C, k, n0, smem, topd, topi);
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int n = n0 + warp * ROWS_PER_WARP + rr;
    if (n >= N) continue;  // warp-uniform
    float* orow = out + ((size_t)b * N + n) * C;
    if (MODE == MODE_FULL) {
      gather_max(yv + (size_t)b * M * C, topi[rr], k, C, orow);
      continue;
    }
    // one distance of the row: its k-th (lane k-1 holds it), or its least
    // (the least over the lanes' own)
    float d = topd[rr];
    if (INSERT) {
      d = __shfl_sync(FULL, d, k - 1);
    } else {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) d = fminf(d, __shfl_xor_sync(FULL, d, off));
    }
    if (MODE == MODE_NOMINEXT) {
      gather_max(yv + (size_t)b * M * C, lane, k, C, orow);
      if (d != d) orow[lane % C] = d;
    } else {
      for (int c = lane; c < C; c += 32) orow[c] = d;
    }
  }
}

template <int MODE>
void launch(const void* xn, const void* yn, const void* yv, const void* rel, void* out,
            int B, int N, int M, int C, int k, cudaStream_t stream) {
  const int n_tiles = (N + TQ - 1) / TQ;
  const dim3 grid((unsigned)B * (unsigned)n_tiles);
  knn_dissect_kernel<MODE><<<grid, THREADS, 0, stream>>>(
      (const float*)xn, (const float*)yn, (const __nv_bfloat16*)yv, (const float*)rel,
      (float*)out, N, M, C, k, n_tiles);
}

}  // namespace

// xn (B,N,C), yn (B,M,C): f32 coordinates; yv (B,M,C): bf16 values; rel
// (N,M) f32; out (B,N,C) f32; mode as listed above. All contiguous, on the
// device of `stream`. Returns the cudaError_t of the launch (0 on success).
extern "C" int knn_dissect_forward(const void* xn, const void* yn, const void* yv,
                                   const void* rel, void* out, int B, int N, int M,
                                   int C, int k, int mode, void* stream) {
  if (bad_shape(B, N, M, C, k) || rel == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case MODE_FULL: launch<MODE_FULL>(xn, yn, yv, rel, out, B, N, M, C, k, s); break;
    case MODE_NOSEL: launch<MODE_NOSEL>(xn, yn, yv, rel, out, B, N, M, C, k, s); break;
    case MODE_NOMINEXT: launch<MODE_NOMINEXT>(xn, yn, yv, rel, out, B, N, M, C, k, s); break;
    case MODE_DISTONLY: launch<MODE_DISTONLY>(xn, yn, yv, rel, out, B, N, M, C, k, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
