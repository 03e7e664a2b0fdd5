// T1 on Hopper: the fused kNN + neighbour max with one mechanism taken out
// per mode, to see where its time goes.
//
// Replaces the Pallas TPU probe tools/exp_knn_dissect.py::_kernel (launched
// by run). As there, the inputs are f32 coordinates, bf16 values and an
// (N, M) f32 bias, the output is (B, N, C) f32, and only mode `full` computes
// the real function; the others write something cheap that depends on what
// they did compute, so that the compiler keeps it. The kernel's body is the
// one K1, K2 and K3 share (knn_select.cuh): the distance product, the
// running top-k in a warp's lanes, the gather by index and the max. The
// modes, named after the TPU probe's:
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
// The body is K1's as it now is: the product on mma.sync (3xTF32, since the
// coordinates are f32), the query tile staged once, the candidates through
// the cp.async ring, Swin windows one per CTA. What bounds it: as K1.

#include "knn_select.cuh"

namespace {

using namespace knn;

enum Mode { MODE_FULL = 0, MODE_NOSEL = 1, MODE_NOMINEXT = 2, MODE_DISTONLY = 3 };

template <int MODE>
struct DissectEmit {
  const __nv_bfloat16* yv;
  float* out;
  int N, M, C, k;
  __device__ void operator()(int b, int n, float topd, int topi) const {
    constexpr bool INSERT = MODE == MODE_FULL || MODE == MODE_NOSEL;
    const int lane = threadIdx.x & 31;
    float* orow = out + ((size_t)b * N + n) * C;
    if (MODE == MODE_FULL) {
      gather_max(yv + (size_t)b * M * C, topi, k, C, orow);
      return;
    }
    // one distance of the row: its k-th (lane k-1 holds it), or its least
    // (the least over the lanes' own)
    float d = topd;
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
};

template <int MODE, int TQ, bool WINDOW>
__global__ void __launch_bounds__(THREADS, 2) knn_dissect_kernel(
    Args a, const __nv_bfloat16* __restrict__ yv, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool INSERT = MODE == MODE_FULL || MODE == MODE_NOSEL;
  select_rows<float, TQ, WINDOW, INSERT>(a, smem,
                                         DissectEmit<MODE>{yv, out, a.N, a.M, a.C, a.k});
}

template <int MODE>
cudaError_t launch(const Plan& p, const Args& a, const void* yv, void* out,
                   cudaStream_t stream) {
  return with_plan(p, [&](auto tq, auto window) {
    return launch_planned(knn_dissect_kernel<MODE, decltype(tq)::value, decltype(window)::value>,
                          p, stream, a, (const __nv_bfloat16*)yv, (float*)out);
  });
}

}  // namespace

// xn (B,N,C), yn (B,M,C): f32 coordinates; yv (B,M,C): bf16 values; rel
// (N,M) f32; out (B,N,C) f32; mode as listed above. All contiguous, on the
// device of `stream`. Returns the cudaError_t of the launch (0 on success).
extern "C" int knn_dissect_forward(const void* xn, const void* yn, const void* yv,
                                   const void* rel, void* out, int B, int N, int M,
                                   int C, int k, int mode, void* stream) {
  Plan p;
  if (bad_shape(B, N, M, C, k) || rel == nullptr ||
      !make_plan(B, N, M, C, 4, xn == yn && N == M, xn, yn, p)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{xn, yn, (const float*)rel, B, N, M, C, k, p.vec};
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case MODE_FULL: return (int)launch<MODE_FULL>(p, a, yv, out, s);
    case MODE_NOSEL: return (int)launch<MODE_NOSEL>(p, a, yv, out, s);
    case MODE_NOMINEXT: return (int)launch<MODE_NOMINEXT>(p, a, yv, out, s);
    case MODE_DISTONLY: return (int)launch<MODE_DISTONLY>(p, a, yv, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
