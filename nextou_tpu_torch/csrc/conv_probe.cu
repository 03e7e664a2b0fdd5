// T2 on Hopper: the conv design's row-patch probe.
//
// Replaces the Pallas TPU probe tools/exp_mosaic_probe.py::kern (launched by
// run). That probe asked whether Mosaic supports the steps a row-tiled conv
// kernel needs: view a ((TH+2)*C, W) slab as (TH+2, C, W) rows, assemble the
// three kh-shifted row groups into a (TH, 3C, W) patch buffer, take TH dots
// with a (3C, Co) weight matrix, and store the result as (TH, W, Co) or,
// transposed in the kernel, as (TH, Co, W). The function is
//
//   out[h, wc, o] = sum over kh < 3 and c < C of
//       x[(h + kh) * C + c, wc] * w[kh * C + c, o]
//
// On this card none of the steps is in question: the patch of one output
// row is rows h*C .. (h+3)*C of the slab, already contiguous, and either
// output order is index arithmetic at the store. What the probe keeps is the
// function, its oracle, and the time of each output order: the (TH, Co, W)
// store puts neighbouring lanes on neighbouring addresses, the (TH, W, Co)
// store puts them Co floats apart.
//
// What bounds it: launch overhead (0.2 MB moved, 6.7 MFLOP at the probe's
// size). Design: one CTA per (output row h, block of 128 columns); it stages
// the row's (3C, 128) patch and the weights in shared memory; a thread owns
// one column and sums 8 output channels at a time as f32 FMAs.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int COLS = 128;  // columns per CTA, one per thread
constexpr int OB = 8;      // output channels summed at a time

__global__ void __launch_bounds__(COLS) conv_probe_kernel(
    const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
    int TH, int C, int W, int Co, int transpose_out) {
  extern __shared__ float smem[];
  const int K = 3 * C;
  float* pat = smem;             // [K][COLS]
  float* ws = smem + K * COLS;   // [K][Co]
  const int h = blockIdx.x;
  const int col = blockIdx.y * COLS + threadIdx.x;
  for (int k = 0; k < K; ++k)
    pat[k * COLS + threadIdx.x] = col < W ? x[((size_t)h * C + k) * W + col] : 0.f;
  for (int i = threadIdx.x; i < K * Co; i += COLS) ws[i] = w[i];
  __syncthreads();
  if (col >= W) return;
  for (int o0 = 0; o0 < Co; o0 += OB) {
    float acc[OB];
#pragma unroll
    for (int i = 0; i < OB; ++i) acc[i] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float xv = pat[k * COLS + threadIdx.x];
#pragma unroll
      for (int i = 0; i < OB; ++i)
        if (o0 + i < Co) acc[i] = fmaf(xv, ws[k * Co + o0 + i], acc[i]);
    }
#pragma unroll
    for (int i = 0; i < OB; ++i) {
      const int o = o0 + i;
      if (o >= Co) break;
      if (transpose_out) {
        out[((size_t)h * Co + o) * W + col] = acc[i];
      } else {
        out[((size_t)h * W + col) * Co + o] = acc[i];
      }
    }
  }
}

}  // namespace

// x ((TH+2)*C, W), w (3*C, Co), out (TH, W, Co) or, with transpose_out != 0,
// (TH, Co, W): all f32, contiguous, on the device of `stream`.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int conv_probe_forward(const void* x, const void* w, void* out, int TH, int C,
                                  int W, int Co, int transpose_out, void* stream) {
  if (TH < 1 || C < 1 || W < 1 || Co < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)3 * C * (COLS + Co) * sizeof(float);
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)TH, (unsigned)((W + COLS - 1) / COLS));
  conv_probe_kernel<<<grid, COLS, bytes, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)out, TH, C, W, Co, transpose_out);
  return (int)cudaGetLastError();
}
