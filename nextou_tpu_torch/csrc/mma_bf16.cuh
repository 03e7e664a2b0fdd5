// The tensor-core code that the two bf16 conv kernels share (K5 in
// conv3d.cu, the channels-last conv in conv_cl.cu): one mma.sync.m16n8k16
// with f32 accumulators, the packing of two bf16 into the 32-bit word that
// its fragments take, the swizzle of the staged weights and the kernel that
// repacks the weights once per launch. The two kernels differ only in how
// they stage the input halo.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

constexpr int MMA_KC = 16;           // input channels per k16 step
constexpr int MMA_KW2 = MMA_KC / 2;  // ... as 32-bit words of two bf16

__device__ __forceinline__ unsigned pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (unsigned)__bfloat16_as_ushort(lo) | ((unsigned)__bfloat16_as_ushort(hi) << 16);
}

// Word j (channels 2j, 2j+1 of a chunk) of output channel co's row of staged
// weights sits at j ^ swizzle(co): rows 4 apart would else fall on the same
// banks when a B fragment is loaded.
__device__ __forceinline__ int swizzle(int co) { return ((co >> 2) & 1) << 2; }

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Words of the repacked weights of a conv with C input and Co output
// channels, taps taps and TCO output channels per CTA.
template <int TCO>
size_t packed_weight_words(int C, int Co, int taps) {
  return (size_t)((Co + TCO - 1) / TCO) * ((C + MMA_KC - 1) / MMA_KC) * taps * TCO * MMA_KW2;
}

// Bytes of scratch a launch needs for the repacked weights: 0 for f32, -1
// where they are too large.
template <int TCO>
int packed_weight_bytes(int C, int Co, int taps, int bf16) {
  if (!bf16 || C < 1 || Co < 1) return 0;
  const size_t bytes = packed_weight_words<TCO>(C, Co, taps) * sizeof(unsigned);
  return bytes > 0x7fffffffULL ? -1 : (int)bytes;
}

// The weights as the CTAs stage them: [co tile][chunk][tap][TCO][MMA_KW2]
// words of two bf16 (channels c, c+1 of one tap and output channel), zero
// beyond C and Co, swizzled. One thread per word. The weight of (tap, c, co)
// is w[tap * s_tap + c * s_c + co * s_co]: K5's (Co, C, taps) and T3's
// (taps, C, Co) differ only in these strides.
template <int TCO>
__global__ void pack_weights_kernel(const __nv_bfloat16* __restrict__ w,
                                    unsigned* __restrict__ wp, int C, int Co, int taps,
                                    int n_chunks, int n_words, int s_tap, int s_c, int s_co) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_words) return;
  int t = i;
  const int js = t % MMA_KW2;
  t /= MMA_KW2;
  const int co_l = t % TCO;
  t /= TCO;
  const int tap = t % taps;
  t /= taps;
  const int chunk = t % n_chunks;
  const int cot = t / n_chunks;
  const int co = cot * TCO + co_l;
  const int c = chunk * MMA_KC + 2 * (js ^ swizzle(co_l));
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  __nv_bfloat16 lo = zero, hi = zero;
  if (co < Co) {
    const __nv_bfloat16* src = w + (size_t)tap * s_tap + (size_t)c * s_c + (size_t)co * s_co;
    if (c < C) lo = src[0];
    if (c + 1 < C) hi = src[s_c];
  }
  wp[i] = pack2(lo, hi);
}

// Repacks w into wp (packed_weight_words<TCO> words) on stream.
template <int TCO>
cudaError_t pack_weights(const void* w, void* wp, int C, int Co, int taps, int s_tap, int s_c,
                         int s_co, cudaStream_t stream) {
  const size_t n_words = packed_weight_words<TCO>(C, Co, taps);
  if (n_words > 0x7fffffffULL) return cudaErrorInvalidValue;
  const int n_chunks = (C + MMA_KC - 1) / MMA_KC;
  pack_weights_kernel<TCO><<<(unsigned)((n_words + 255) / 256), 256, 0, stream>>>(
      (const __nv_bfloat16*)w, (unsigned*)wp, C, Co, taps, n_chunks, (int)n_words, s_tap, s_c,
      s_co);
  return cudaGetLastError();
}
