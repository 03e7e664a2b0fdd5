// T3 on Hopper: the channels-last 3D convolution (forward).
//
// Replaces the two Pallas TPU kernels of tools/exp_conv_kernel.py:
// ::pallas_conv (kernel ::_conv_kernel, an im2col slab per grid step and one
// MXU matmul with K = taps x C, any stride in {1, 2}) and ::csub_conv (kernel
// ::_csub_kernel, the same conv at stride 1 with C on the sublanes). It
// computes, for x (N, D, H, W, C) and w (kd, kh, kw, C, Co),
//
//   out[n, od, oh, ow, co] = sum over c and the taps (kd, kh, kw) of
//       x[n, sd*od + kd - pd, sh*oh + kh - ph, sw*ow + kw - pw, c] * w[kd, kh, kw, c, co]
//
// with symmetric padding p = (k - 1) / 2 per axis (positions outside x count
// as zero), kernel dims in {1, 3}, strides in {1, 2}, and T3's output extents
// D / sd, H / sh, W / sw (rounded down: for an odd extent under a stride one
// output fewer than a library conv's). The sum is kept in f32 and rounded
// once, to x's type, at the store. out is (N, Do, Ho, Wo, Co).
//
// What the TPU kernels do for Mosaic has no counterpart here: the (N, D, H,
// W*C) flat slab and its even/odd phase reshapes for a stride, csub_conv's
// (N, D, H*C, W) transpose with W padded to 128 lanes and its 8-row aligned
// DMAs. A stride is index arithmetic, and both entry points run this kernel.
//
// What bounds it on the card, at 989 TFLOP/s of bf16 products and 3.35 TB/s:
// at T3's e1b, e2b and d4 the operations, 2 N Do Ho Wo taps C Co, take 3 to
// 6 times as long as the bytes; at e1a and e2a the two are about even (1.0
// and 1.2 times); at e0b and d0 (kd = 1, 33 output channels) the bytes bound
// it (0.22 and 0.33 ms against 0.11 and 0.22 ms of operations). So the design
// spends its effort on the products: an implicit GEMM on mma.sync with the
// operands in shared memory. For the bytes it reads x in contiguous channel
// runs, about 1.3 times over at e0b and d0 (the halos of neighbouring tiles
// overlap; one tile of 72 output channels covers all 33), and writes each
// output once. There it still runs 8 to 10 times its bound, because padding
// C and Co to the tiles multiplies the products 3.2 and 2.6 times (below).
//
// One CTA computes, for one (n, od), RH = 8 output rows x TW = 32 output
// columns x TCO = 72 output channels. The input channels go by in chunks;
// per chunk the CTA stages the input halo (kd depths x the rows and columns
// the tile's taps reach, zero outside x) and the chunk's weights, then
// multiplies.
//
// bf16 (conv_cl_mma_kernel): M is 16 output columns of a row, N 8 output
// channels, K the 16 channels of a chunk at one tap: every tap is one k-step,
// and C pads up to a multiple of 16 in shared memory (33 to 48, 66 to 80).
// A warp owns one output row: 2 m-tiles x 9 n-tiles, 72 sums a thread.
// Channels-last puts the channel pairs that the fragments want into one
// 32-bit word of x already, so the halo is staged a word at a time (K5, on
// NCDHW, interleaves two channel planes); a position of the halo holds its 8
// words in S words, with S = 12 at column stride 1 and 10 at stride 2, so
// that the 8 positions of a fragment load fall on 8 distinct groups of 4
// banks. The weights are repacked once per launch (pack_weights in
// mma_bf16.cuh, shared with K5) into the order the CTAs stage them, and
// staged as 16-byte copies.
// Left for later: staging and products do not overlap inside a CTA (no
// cp.async or TMA ring), wgmma, K padded to 16 channels, TCO = 72 wastes
// 54% of the products at Co = 33, and a strided tile stages a halo four
// times the size (one CTA per SM).
//
// f32 (conv_cl_fma_kernel): the same sum as f32 FMAs, never TF32. A warp owns
// 8 output channels and a lane one output column, so a thread holds 8 rows x
// 8 channels = 64 sums; the chunk is as many channels as fit 96 KB.

#include <stddef.h>

#include "mma_bf16.cuh"

namespace {

constexpr int TW = 32;   // output columns per CTA
constexpr int RH = 8;    // output rows per CTA
constexpr int TCO = 72;  // output channels per CTA
constexpr int RCO = 8;   // the f32 kernel: output channels per warp
constexpr int FMA_WARPS = TCO / RCO;
constexpr int FMA_THREADS = FMA_WARPS * 32;
constexpr int SMEM_FLOATS = 24 * 1024;  // the f32 kernel: 96 KB

struct Geometry {
  int C, D, H, W;          // input channels and extent
  int Co, Do, Ho, Wo;      // output channels and extent
  int kd, kh, kw;          // kernel dims, each 1 or 3
  int sd, sh, sw;          // strides, each 1 or 2
  int in_rows, in_cols;    // the halo of one tile: (RH-1)*sh + kh, (TW-1)*sw + kw
  int chunk;               // the f32 kernel: input channels staged at a time
  int n_wt, n_ht;          // column and row tiles per output plane
};

// The CTA's tile and where its halo starts in x (it may start outside x: the
// padding), from blockIdx.
struct Tile {
  int ow0, oh0, od, co0, n, d_in0, h_in0, w_in0;
};

__device__ __forceinline__ Tile tile_of(const Geometry& g) {
  Tile t;
  int b = blockIdx.x;
  t.ow0 = (b % g.n_wt) * TW;
  b /= g.n_wt;
  t.oh0 = (b % g.n_ht) * RH;
  t.od = b / g.n_ht;
  t.co0 = blockIdx.y * TCO;
  t.n = blockIdx.z;
  t.d_in0 = t.od * g.sd - (g.kd - 1) / 2;
  t.h_in0 = t.oh0 * g.sh - (g.kh - 1) / 2;
  t.w_in0 = t.ow0 * g.sw - (g.kw - 1) / 2;
  return t;
}

// ---- f32: the FMA kernel -------------------------------------------------------------

__global__ void __launch_bounds__(FMA_THREADS, 2) conv_cl_fma_kernel(
    const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
    Geometry g) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int taps = g.kd * g.kh * g.kw;
  const int plane = g.kd * g.in_rows * g.in_cols;  // one channel of the halo
  float* ws = smem;                                // [chunk][taps][TCO]
  float* xs = smem + g.chunk * taps * TCO;         // [chunk][kd][in_rows][in_cols]
  const Tile t = tile_of(g);
  const float* xb = x + (size_t)t.n * g.D * g.H * g.W * g.C;

  float acc[RH][RCO];
#pragma unroll
  for (int j = 0; j < RH; ++j)
#pragma unroll
    for (int i = 0; i < RCO; ++i) acc[j][i] = 0.f;

  const int row_step = g.sh * g.in_cols;
  for (int c0 = 0; c0 < g.C; c0 += g.chunk) {
    const int cn = min(g.chunk, g.C - c0);
    // the halo: consecutive threads on consecutive channels of one position
    for (int e = threadIdx.x; e < plane * cn; e += FMA_THREADS) {
      const int c = e % cn;
      const int pos = e / cn;
      const int col = pos % g.in_cols;
      const int r = pos / g.in_cols;
      const int d = t.d_in0 + r / g.in_rows;
      const int h = t.h_in0 + r % g.in_rows;
      const int wi = t.w_in0 + col;
      const bool inside = d >= 0 && d < g.D && h >= 0 && h < g.H && wi >= 0 && wi < g.W;
      xs[c * plane + pos] =
          inside ? xb[(((size_t)d * g.H + h) * g.W + wi) * g.C + c0 + c] : 0.f;
    }
    // the weights: consecutive threads on consecutive output channels
    for (int e = threadIdx.x; e < cn * taps * TCO; e += FMA_THREADS) {
      const int co = e % TCO;
      const int ct = e / TCO;  // c * taps + tap
      const int tap = ct % taps;
      const int c = ct / taps;
      ws[e] = (t.co0 + co < g.Co) ? w[((size_t)tap * g.C + c0 + c) * g.Co + t.co0 + co] : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < cn; ++c) {
      for (int kdi = 0; kdi < g.kd; ++kdi) {
        for (int khi = 0; khi < g.kh; ++khi) {
          const float* xrow = xs + c * plane + (kdi * g.in_rows + khi) * g.in_cols + lane * g.sw;
          const float* wrow = ws + ((c * g.kd + kdi) * g.kh + khi) * g.kw * TCO + warp * RCO;
          for (int kwi = 0; kwi < g.kw; ++kwi) {
            const float4 w0 = *reinterpret_cast<const float4*>(wrow + kwi * TCO);
            const float4 w1 = *reinterpret_cast<const float4*>(wrow + kwi * TCO + 4);
            const float wv[RCO] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int j = 0; j < RH; ++j) {
              const float xv = xrow[j * row_step + kwi];
#pragma unroll
              for (int i = 0; i < RCO; ++i) acc[j][i] = fmaf(xv, wv[i], acc[j][i]);
            }
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites xs and ws
  }

  const int ow = t.ow0 + lane;
  if (ow >= g.Wo) return;
#pragma unroll
  for (int j = 0; j < RH; ++j) {
    const int oh = t.oh0 + j;
    if (oh >= g.Ho) break;
    float* dst = out + ((((size_t)t.n * g.Do + t.od) * g.Ho + oh) * g.Wo + ow) * g.Co;
#pragma unroll
    for (int i = 0; i < RCO; ++i) {
      const int co = t.co0 + warp * RCO + i;
      if (co < g.Co) dst[co] = acc[j][i];
    }
  }
}

cudaError_t launch_fma(const void* x, const void* w, void* out, int N, Geometry g,
                       cudaStream_t stream) {
  const int taps = g.kd * g.kh * g.kw;
  const int per_channel = g.kd * g.in_rows * g.in_cols + taps * TCO;
  g.chunk = SMEM_FLOATS / per_channel;  // at least 4: per_channel is at most 5,259 floats
  if (g.chunk > g.C) g.chunk = g.C;
  const size_t bytes = (size_t)g.chunk * per_channel * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      conv_cl_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(g.n_wt * g.n_ht * g.Do), (unsigned)((g.Co + TCO - 1) / TCO),
                  (unsigned)N);
  conv_cl_fma_kernel<<<grid, FMA_THREADS, bytes, stream>>>(
      (const float*)x, (const float*)w, (float*)out, g);
  return cudaGetLastError();
}

// ---- bf16: the tensor-core kernel ------------------------------------------------

constexpr int MMA_WARPS = RH;   // one output row of the tile each
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int KC = MMA_KC;      // input channels per chunk: one k16 step per tap
constexpr int KW2 = MMA_KW2;    // ... as 32-bit words of two bf16
constexpr int NT = TCO / 8;     // n8 tiles of output channels per CTA
constexpr int MT = TW / 16;     // m16 tiles of output columns per warp
constexpr int STAGE_U = 8;      // halo words a thread loads before it stores any
constexpr int POS_STEP = MMA_THREADS / KW2;  // halo positions staged per pass

// Words per halo position: an odd multiple of 4 once multiplied by the column
// stride, so that positions g * sw (g = 0..7) start 8 distinct groups of 4 banks.
__host__ __device__ __forceinline__ int pos_words(int sw) { return sw == 1 ? 12 : 10; }

__global__ void __launch_bounds__(MMA_THREADS, 2) conv_cl_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const unsigned* __restrict__ wp,
    __nv_bfloat16* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) unsigned smem_u[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2;  // the fragment's row (A, C) or column (B)
  const int tig = lane & 3;   // the fragment's pair of k (A, B) or of columns (C)
  const int taps = g.kd * g.kh * g.kw;
  const int S = pos_words(g.sw);
  const int n_rows = g.kd * g.in_rows;      // (depth, row) rows of the halo
  const int n_pos = n_rows * g.in_cols;
  const int ws_words = taps * TCO * KW2;
  unsigned* ws = smem_u;                    // [taps][TCO][KW2], swizzled
  unsigned* xs = smem_u + ws_words;         // [n_pos][S]: words 0..7 used
  int* row_off = reinterpret_cast<int*>(xs + (size_t)n_pos * S);  // [n_rows]

  const Tile t = tile_of(g);
  const __nv_bfloat16* xb = x + (size_t)t.n * g.D * g.H * g.W * g.C;
  const int n_chunks = (g.C + KC - 1) / KC;
  const uint4* wsrc = reinterpret_cast<const uint4*>(wp + (size_t)blockIdx.y * n_chunks * ws_words);
  const bool even_c = (g.C & 1) == 0;

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  // where each (depth, row) of the halo starts in x (column 0 of x, channel
  // 0), or -1 outside x: the same for every chunk
  for (int r = threadIdx.x; r < n_rows; r += MMA_THREADS) {
    const int d = t.d_in0 + r / g.in_rows;
    const int h = t.h_in0 + r % g.in_rows;
    const bool inside = d >= 0 && d < g.D && h >= 0 && h < g.H;
    row_off[r] = inside ? (int)(((size_t)d * g.H + h) * g.W * g.C) : -1;
  }
  __syncthreads();

  // a thread stages word j (channels 2j, 2j+1 of the chunk) of every
  // POS_STEP-th position: in_cols >= TW = POS_STEP, so a position's column
  // wraps at most once per step
  const int j = threadIdx.x % KW2;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int c = chunk * KC + 2 * j;
    {
      int col = threadIdx.x / KW2, r = 0;
      for (int p0 = threadIdx.x / KW2; p0 < n_pos; p0 += STAGE_U * POS_STEP) {
        unsigned word[STAGE_U];
#pragma unroll
        for (int u = 0; u < STAGE_U; ++u) {
          word[u] = 0u;
          const int wi = t.w_in0 + col;
          if (p0 + u * POS_STEP < n_pos && c < g.C && wi >= 0 && wi < g.W) {
            const int off = row_off[r];
            if (off >= 0) {
              const __nv_bfloat16* src = xb + off + (size_t)wi * g.C + c;
              if (even_c) {
                word[u] = *reinterpret_cast<const unsigned*>(src);
              } else {
                word[u] = pack2(src[0], c + 1 < g.C ? src[1] : __float2bfloat16(0.f));
              }
            }
          }
          col += POS_STEP;
          if (col >= g.in_cols) {
            col -= g.in_cols;
            ++r;
          }
        }
#pragma unroll
        for (int u = 0; u < STAGE_U; ++u) {
          const int p = p0 + u * POS_STEP;
          if (p < n_pos) xs[p * S + j] = word[u];
        }
      }
    }
    // the chunk's weights, already in their shared-memory order: 16-byte copies
    {
      const uint4* src = wsrc + (size_t)chunk * (ws_words / 4);
      uint4* dst = reinterpret_cast<uint4*>(ws);
#pragma unroll 4
      for (int i = threadIdx.x; i < ws_words / 4; i += MMA_THREADS) dst[i] = src[i];
    }
    __syncthreads();

    const int swz = swizzle(grp);
    for (int kdi = 0; kdi < g.kd; ++kdi) {
      for (int khi = 0; khi < g.kh; ++khi) {
        const int row = (kdi * g.in_rows + warp * g.sh + khi) * g.in_cols;
        const unsigned* wtap = ws + ((kdi * g.kh + khi) * g.kw * TCO + grp) * KW2;
        for (int kwi = 0; kwi < g.kw; ++kwi) {
          unsigned a[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            // rows grp and grp + 8 of the m-tile: output columns m*16 + grp (+8)
            const unsigned* p = xs + (row + kwi + (m * 16 + grp) * g.sw) * S + tig;
            a[m][0] = p[0];
            a[m][1] = p[8 * g.sw * S];
            a[m][2] = p[4];
            a[m][3] = p[8 * g.sw * S + 4];
          }
          const unsigned* wrow = wtap + kwi * TCO * KW2;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const unsigned b0 = wrow[n * 8 * KW2 + (tig ^ swz)];
            const unsigned b1 = wrow[n * 8 * KW2 + ((tig + 4) ^ swz)];
#pragma unroll
            for (int m = 0; m < MT; ++m) mma_bf16(acc[m][n], a[m], b0, b1);
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites xs and ws
  }

  const int oh = t.oh0 + warp;
  if (oh >= g.Ho) return;
  __nv_bfloat16* dst_row = out + (((size_t)t.n * g.Do + t.od) * g.Ho + oh) * g.Wo * g.Co;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ow = t.ow0 + m * 16 + grp + 8 * half;
      if (ow >= g.Wo) continue;
      __nv_bfloat16* dst = dst_row + (size_t)ow * g.Co;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int co = t.co0 + n * 8 + 2 * tig + i;
          if (co < g.Co) dst[co] = __float2bfloat16(acc[m][n][2 * half + i]);
        }
      }
    }
  }
}

cudaError_t launch_mma(const void* x, const void* w, void* out, void* scratch, int N,
                       const Geometry& g, cudaStream_t stream) {
  const int taps = g.kd * g.kh * g.kw;
  const int n_rows = g.kd * g.in_rows;
  const size_t bytes = ((size_t)taps * TCO * KW2 + (size_t)n_rows * g.in_cols * pos_words(g.sw) +
                        n_rows) * sizeof(unsigned);
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  // w is (taps, C, Co)
  cudaError_t err = pack_weights<TCO>(w, scratch, g.C, g.Co, taps, g.C * g.Co, g.Co, 1, stream);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(conv_cl_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(g.n_wt * g.n_ht * g.Do), (unsigned)((g.Co + TCO - 1) / TCO),
                  (unsigned)N);
  conv_cl_mma_kernel<<<grid, MMA_THREADS, bytes, stream>>>(
      (const __nv_bfloat16*)x, (const unsigned*)scratch, (__nv_bfloat16*)out, g);
  return cudaGetLastError();
}

bool one_of(int v, int a, int b) { return v == a || v == b; }

}  // namespace

// Bytes of scratch that conv_cl_forward needs for bf16 inputs (the packed
// weights); 0 for f32, -1 where they are too large.
extern "C" int conv_cl_scratch_bytes(int C, int Co, int kd, int kh, int kw, int bf16) {
  return packed_weight_bytes<TCO>(C, Co, kd * kh * kw, bf16);
}

// x (N, D, H, W, C), w (kd, kh, kw, C, Co), out (N, D / sd, H / sh, W / sw,
// Co): all bf16 (bf16 != 0) or all f32, contiguous, on the device of
// `stream`; scratch: conv_cl_scratch_bytes bytes on that device, 16-byte
// aligned (unused for f32). Returns the cudaError_t of the launch.
extern "C" int conv_cl_forward(const void* x, const void* w, void* out, void* scratch, int N,
                               int D, int H, int W, int C, int Co, int kd, int kh, int kw,
                               int sd, int sh, int sw, int bf16, void* stream) {
  if (N < 1 || C < 1 || D < 1 || H < 1 || W < 1 || Co < 1 || N > 65535 ||
      !one_of(kd, 1, 3) || !one_of(kh, 1, 3) || !one_of(kw, 1, 3) ||
      !one_of(sd, 1, 2) || !one_of(sh, 1, 2) || !one_of(sw, 1, 2) ||
      D < sd || H < sh || W < sw)
    return (int)cudaErrorInvalidValue;
  // one batch element's offsets fit the halo table's 32 bits
  if ((size_t)D * H * W * C > 0x7fffffffULL) return (int)cudaErrorInvalidValue;
  Geometry g;
  g.C = C, g.D = D, g.H = H, g.W = W, g.Co = Co;
  g.kd = kd, g.kh = kh, g.kw = kw, g.sd = sd, g.sh = sh, g.sw = sw;
  g.Do = D / sd, g.Ho = H / sh, g.Wo = W / sw;
  g.in_rows = (RH - 1) * sh + kh;
  g.in_cols = (TW - 1) * sw + kw;
  g.n_wt = (g.Wo + TW - 1) / TW;
  g.n_ht = (g.Ho + RH - 1) / RH;
  g.chunk = 0;
  if ((long long)g.n_wt * g.n_ht * g.Do > 0x7fffffffLL || (g.Co + TCO - 1) / TCO > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    return (int)launch_mma(x, w, out, scratch, N, g, s);
  }
  return (int)launch_fma(x, w, out, N, g, s);
}
