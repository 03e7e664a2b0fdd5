// K4 on Hopper: backward of the kNN neighbour max with respect to the
// candidate values.
//
// Replaces the Pallas TPU kernel nextou_tpu/kernels/knn.py::_bwd_kernel
// (launched by _knn_max_bwd_pallas). With idx (B,N,k) the forward's
// selection, maxv (B,N,C) its f32 output and g (B,N,C) the cotangent:
//
//   eq[n,j,c] = (yv[idx[n,j], c] == maxv[n,c])
//   cnt[n,c]  = sum_j eq[n,j,c]
//   gy[m,c]   = sum over (n,j) with idx[n,j] == m of eq[n,j,c] * g[n,c] / cnt[n,c]
//
// which is the VJP of a max over the selected rows: tied maxima share the
// gradient evenly. Every contribution and every sum is f32. No (B,N,k,C)
// tensor is written.
//
// What bounds it on the card: bytes. Each input is read once and gy written
// once (52 MB at the largest flagship call, 2 x 10752 x 264 with M = 1344:
// 0.016 ms at 3.35 TB/s); the arithmetic is N*k*C compares and adds.
//
// Design. The TPU kernel accumulates gy over query tiles along a sequential
// grid axis; CTAs have no order, and f32 atomicAdd would make the add order,
// and so the last bits of the gradient, change from run to run. This kernel
// is DETERMINISTIC instead, in two passes without float atomics:
//   1. one warp per query row (b, n): count the ties per channel and write
//      the row's share w[n,c] = g[n,c] / cnt[n,c] to a (B,N,C) f32 scratch;
//      lane j also sets bit n in candidate idx[n,j]'s row of a (B, M, N/32)
//      bitmap (atomicOr on integers: the result does not depend on order).
//      A selection names each candidate at most once per row, so the bitmap
//      loses nothing;
//   2. one CTA per candidate (b, m), one thread per channel: the candidate's
//      own value v = yv[m,c] is what the forward gathered, so walk the set
//      bits in ascending n and add w[n,c] where maxv[n,c] == v. The order is
//      fixed by the indices alone, and gy is written once, not accumulated.
// Left for later: pass 2 reads w and maxv once per (n, j) pair (from L2), and
// a candidate chosen by very many rows is one long serial walk.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

namespace {

constexpr int WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename TV>
__global__ void __launch_bounds__(WARPS * 32) bwd_share_kernel(
    const TV* __restrict__ yv, const int* __restrict__ idx,
    const float* __restrict__ maxv, const float* __restrict__ g,
    float* __restrict__ w, unsigned* __restrict__ bitmap, long long rows,
    int N, int M, int C, int k, int words) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform
  const int b = (int)(row / N);
  const int n = (int)(row % N);
  int mine = -1;
  if (lane < k) {
    mine = idx[row * k + lane];
    if ((unsigned)mine < (unsigned)M) {  // an index outside [0, M) is dropped
      atomicOr(&bitmap[((size_t)b * M + mine) * words + (n >> 5)], 1u << (n & 31));
    } else {
      mine = -1;
    }
  }
  const TV* vb = yv + (size_t)b * M * C;
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    const float mx = (c < C) ? maxv[row * C + c] : 0.f;
    int cnt = 0;
    for (int j = 0; j < k; ++j) {
      const int m = __shfl_sync(FULL, mine, j);
      if (c < C && m >= 0 && to_f32(vb[(size_t)m * C + c]) == mx) ++cnt;
    }
    if (c < C) w[row * C + c] = g[row * C + c] / (float)(cnt > 1 ? cnt : 1);
  }
}

template <typename TV>
__global__ void bwd_reduce_kernel(
    const TV* __restrict__ yv, const float* __restrict__ maxv,
    const float* __restrict__ w, const unsigned* __restrict__ bitmap,
    float* __restrict__ gy, int N, int M, int C, int words) {
  const size_t bm = blockIdx.x;  // b * M + m
  const size_t b = bm / M;
  const unsigned* bits = bitmap + bm * words;
  const float* mb = maxv + b * N * C;
  const float* wb = w + b * N * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float v = to_f32(yv[bm * C + c]);
    float acc = 0.f;
    for (int wd = 0; wd < words; ++wd) {
      unsigned word = bits[wd];
      while (word) {  // ascending n: a fixed add order
        const size_t n = (size_t)wd * 32 + (__ffs(word) - 1);
        word &= word - 1;
        if (mb[n * C + c] == v) acc += wb[n * C + c];
      }
    }
    gy[bm * C + c] = acc;
  }
}

template <typename TV>
int launch(const void* yv, const int* idx, const float* maxv, const float* g,
           float* gy, float* w, unsigned* bitmap, int B, int N, int M, int C,
           int k, cudaStream_t stream) {
  const int words = (N + 31) / 32;
  cudaError_t err =
      cudaMemsetAsync(bitmap, 0, (size_t)B * M * words * sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * N;
  bwd_share_kernel<TV><<<(unsigned)((rows + WARPS - 1) / WARPS), WARPS * 32, 0, stream>>>(
      (const TV*)yv, idx, maxv, g, w, bitmap, rows, N, M, C, k, words);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int threads = ((C + 31) / 32) * 32;
  if (threads > 512) threads = 512;
  bwd_reduce_kernel<TV><<<(unsigned)((long long)B * M), threads, 0, stream>>>(
      (const TV*)yv, maxv, w, bitmap, gy, N, M, C, words);
  return (int)cudaGetLastError();
}

}  // namespace

// yv (B,M,C): candidate values, bf16 (values_bf16 != 0) or f32; idx (B,N,k)
// int32, each row naming k distinct candidates; maxv, g (B,N,C) f32;
// gy (B,M,C) f32, the output, written everywhere. Scratch: w (B,N,C) f32 and
// bitmap (B, M, ceil(N/32)) 32-bit words, both overwritten. All contiguous,
// on the device of `stream`. Returns a cudaError_t (0 on success).
extern "C" int knn_max_backward(const void* yv, const void* idx,
                                const void* maxv, const void* g, void* gy,
                                void* w, void* bitmap, int B, int N, int M,
                                int C, int k, int values_bf16, void* stream) {
  if (B < 1 || N < 1 || M < 1 || C < 1 || k < 1 || k > 32 ||
      (long long)B * M > 0x7fffffffLL ||
      ((long long)B * N + WARPS - 1) / WARPS > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (values_bf16) {
    return launch<__nv_bfloat16>(yv, (const int*)idx, (const float*)maxv,
                                 (const float*)g, (float*)gy, (float*)w,
                                 (unsigned*)bitmap, B, N, M, C, k, s);
  }
  return launch<float>(yv, (const int*)idx, (const float*)maxv, (const float*)g,
                       (float*)gy, (float*)w, (unsigned*)bitmap, B, N, M, C, k, s);
}
