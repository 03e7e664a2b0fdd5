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
// store would put them Co floats apart if written as computed.
//
// What bounds it: launch overhead (0.2 MB moved, 6.7 MFLOP at the probe's
// size). Design: one CTA per (output row h, 32 columns, 8 output channels),
// 160 CTAs at the probe's size, so that the grid covers the card's 132 SMs;
// it stages the rows' (3C, 32) patch and the (3C, 8) weights in shared
// memory, and a thread sums one output as 3C f32 FMAs (99 in series). The
// (TH, Co, W) store is coalesced as it stands (lanes on columns); the
// (TH, W, Co) one goes through shared memory, so that neighbouring threads
// write neighbouring output channels of a column.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int COLS = 32;  // columns per CTA, one per lane
constexpr int OB = 8;     // output channels per CTA, one per warp

__global__ void __launch_bounds__(COLS * OB) conv_probe_kernel(
    const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
    int C, int W, int Co, int transpose_out) {
  extern __shared__ float smem[];
  const int K = 3 * C;
  float* pat = smem;             // [K][COLS]
  float* ws = pat + K * COLS;    // [K][OB]
  float* res = ws + K * OB;      // [COLS][OB + 1]
  const int h = blockIdx.x, col0 = blockIdx.y * COLS, o0 = blockIdx.z * OB;
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * COLS + tx;
  const int col = col0 + tx, o = o0 + ty;
  for (int k = ty; k < K; k += OB)
    pat[k * COLS + tx] = col < W ? x[((size_t)h * C + k) * W + col] : 0.f;
  for (int i = t; i < K * OB; i += COLS * OB) {
    const int oo = o0 + i % OB;
    ws[i] = oo < Co ? w[(size_t)(i / OB) * Co + oo] : 0.f;
  }
  __syncthreads();
  float acc = 0.f;
  for (int k = 0; k < K; ++k) acc = fmaf(pat[k * COLS + tx], ws[k * OB + ty], acc);
  if (transpose_out) {
    if (col < W && o < Co) out[((size_t)h * Co + o) * W + col] = acc;
    return;
  }
  res[tx * (OB + 1) + ty] = acc;
  __syncthreads();
  const int c2 = col0 + t / OB, o2 = o0 + t % OB;
  if (c2 < W && o2 < Co) out[((size_t)h * W + c2) * Co + o2] = res[(t / OB) * (OB + 1) + t % OB];
}

__global__ void empty_kernel() {}

}  // namespace

// x ((TH+2)*C, W), w (3*C, Co), out (TH, W, Co) or, with transpose_out != 0,
// (TH, Co, W): all f32, contiguous, on the device of `stream`.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int conv_probe_forward(const void* x, const void* w, void* out, int TH, int C,
                                  int W, int Co, int transpose_out, void* stream) {
  if (TH < 1 || C < 1 || W < 1 || Co < 1 || TH > 65535) return (int)cudaErrorInvalidValue;
  const size_t bytes = ((size_t)3 * C * (COLS + OB) + COLS * (OB + 1)) * sizeof(float);
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)TH, (unsigned)((W + COLS - 1) / COLS), (unsigned)((Co + OB - 1) / OB));
  conv_probe_kernel<<<grid, dim3(COLS, OB), bytes, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)out, C, W, Co, transpose_out);
  return (int)cudaGetLastError();
}

// One CTA of an empty kernel on `stream`: the launch floor the probe's time
// stands beside. Returns the cudaError_t of the launch.
extern "C" int conv_probe_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
