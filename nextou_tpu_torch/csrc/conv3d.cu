// K5 on Hopper: the tap-list 3D convolution (forward).
//
// Replaces the Pallas TPU kernel nextou_tpu/kernels/conv.py::_kernel
// (launched by conv_cf_flat, reached through pallas_conv). It computes
//
//   out[b, co, od, oh, ow] = sum over c and the real taps (kd, kh, kw) of
//       x[b, c, sd*od + kd - pd, sh*oh + kh - ph, sw*ow + kw - pw] * w[co, c, kd, kh, kw]
//
// with symmetric padding p = (k - 1) / 2 per axis (positions outside x count
// as zero), kernel dims in {1, 3}, strides in {1, 2}, the sum kept in f32 and
// rounded once, to x's type, at the store. No bias.
//
// It is not the TPU kernel carried over. That one works on "channel-first
// flat" slabs padded to 128 lanes, folds a strided conv space-to-depth and
// lists its real taps so that no zero weight is multiplied, and has three
// ways to assemble patches around Mosaic's relayouts. Here x is read as NCDHW
// and out written as NCDHW, a stride is index arithmetic (so there are no
// zero taps to begin with), and one kernel serves every mode.
//
// What bounds it on the card: operations. The five flagship convs do 769
// GFLOP per patch against about 0.5 GB moved, so the bf16 tensor cores would
// need about 0.8 ms per patch and the memory 0.15 ms.
//
// Two kernels share one tiling: one CTA computes, for one (batch, output
// depth), RH = 8 output rows x TW = 32 output columns x TCO = 72 output
// channels (66 and 132, the flagship's, are 1 and 2 such tiles with 8% to
// spare). The input channels go by in chunks; per chunk the CTA stages in
// shared memory the input halo (kd depths x the rows and columns the tile's
// taps reach, zero outside x) and the chunk's weights, and then multiplies.
//
// bf16 (conv3d_mma_kernel): an implicit GEMM on the tensor cores,
// mma.sync.m16n8k16 with f32 accumulators. M is 16 output columns of a row,
// N is 8 output channels, K is 16 input channels of one tap: a chunk is 16
// channels and every tap is one k-step (C = 33 pads to 48, 66 to 80, 132 to
// 144). A warp owns one output row: 2 m-tiles x 9 n-tiles, 72 sums a
// thread. Both fragments want pairs of neighbouring k, that is channels,
// in one 32-bit word, and NCDHW keeps channels farthest apart: the halo is
// staged two channels to a word (two 2-byte loads, one store), with one
// plane of (depth, row, column) words per channel pair, padded so that the
// four pairs a fragment load touches fall 8 banks apart. The weights are
// repacked once per launch by pack_weights_kernel into the order the CTAs
// stage them, [tap][output channel][8 words], swizzled against bank
// conflicts, so that staging them is 16-byte copies. The halo's loads are
// started 8 elements a thread before the first is stored: with one load in
// flight per thread the staging took nine tenths of the kernel's time.
// Left on the table: staging and products do not overlap inside a CTA (no
// cp.async or TMA ring; two CTAs share an SM at stride 1, one at stride 2,
// whose halo is four times the size), wgmma, a 32-column m-tile's A
// fragments are not reused across kw, and K pads to 16.
//
// f32 (conv3d_fma_kernel): the same sum as f32 FMAs, never TF32. A warp owns 8
// output channels and a lane one output column, so a thread holds 8 rows x
// 8 channels = 64 sums; per (channel, tap) it reads 8 input values (lanes on
// neighbouring addresses) and 8 weights (two 16-byte loads, the same for
// every lane) for 64 FMAs. The chunk is as many channels as fit 96 KB, so
// two CTAs share an SM and one stages while the other multiplies.

#include <stddef.h>

#include "mma_bf16.cuh"

namespace {

constexpr int TW = 32;   // output columns per CTA
constexpr int RH = 8;    // output rows per CTA
constexpr int TCO = 72;  // output channels per CTA
// the f32 kernel: a warp per 8 output channels, a lane per output column
constexpr int RCO = 8;
constexpr int WARPS = TCO / RCO;
constexpr int THREADS = WARPS * 32;
constexpr int SMEM_FLOATS = 24 * 1024;  // 96 KB: two CTAs per SM

struct Geometry {
  int C, D, H, W;          // input channels and extent
  int Co, Do, Ho, Wo;      // output channels and extent
  int kd, kh, kw;          // kernel dims, each 1 or 3
  int sd, sh, sw;          // strides, each 1 or 2
  int in_rows, in_cols;    // the halo of one tile: (RH-1)*sh + kh, (TW-1)*sw + kw
  int chunk;               // the f32 kernel: input channels staged at a time
  int n_wt, n_ht;          // column and row tiles per output plane
};

// ---- f32: the FMA kernel -------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 2) conv3d_fma_kernel(
    const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out,
    Geometry g) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int taps = g.kd * g.kh * g.kw;
  const int plane = g.in_rows * g.in_cols;    // one (channel, depth) of the halo
  float* xs = smem;                           // [chunk][kd][in_rows][in_cols]
  float* ws = smem + g.chunk * g.kd * plane;  // [chunk][taps][TCO]; a multiple of 4 floats in

  int t = blockIdx.x;
  const int ow0 = (t % g.n_wt) * TW;
  t /= g.n_wt;
  const int oh0 = (t % g.n_ht) * RH;
  const int od = t / g.n_ht;
  const int co0 = blockIdx.y * TCO;
  const int b = blockIdx.z;
  // where the halo starts in x (may lie outside it: the padding)
  const int d_in0 = od * g.sd - (g.kd - 1) / 2;
  const int h_in0 = oh0 * g.sh - (g.kh - 1) / 2;
  const int w_in0 = ow0 * g.sw - (g.kw - 1) / 2;
  const size_t hw = (size_t)g.H * g.W;
  const float* xb = x + (size_t)b * g.C * g.D * hw;

  float acc[RH][RCO];
#pragma unroll
  for (int j = 0; j < RH; ++j)
#pragma unroll
    for (int i = 0; i < RCO; ++i) acc[j][i] = 0.f;

  const int row_step = g.sh * g.in_cols;
  for (int c0 = 0; c0 < g.C; c0 += g.chunk) {
    const int cn = min(g.chunk, g.C - c0);
    // the input halo: a warp per (channel, depth, row), lanes along the row
    const int n_rows = cn * g.kd * g.in_rows;
    for (int r = warp; r < n_rows; r += WARPS) {
      const int hr = r % g.in_rows;
      const int cd = r / g.in_rows;
      const int c = c0 + cd / g.kd;
      const int d = d_in0 + cd % g.kd;
      const int h = h_in0 + hr;
      const bool inside = d >= 0 && d < g.D && h >= 0 && h < g.H;
      const float* src = xb + ((size_t)c * g.D + (inside ? d : 0)) * hw + (size_t)(inside ? h : 0) * g.W;
      float* dst = xs + (size_t)r * g.in_cols;
      for (int col = lane; col < g.in_cols; col += 32) {
        const int wi = w_in0 + col;
        dst[col] = (inside && wi >= 0 && wi < g.W) ? src[wi] : 0.f;
      }
    }
    // the weights: for one output channel the chunk's (channel, tap) values
    // are contiguous in w (Co, C, kd, kh, kw); a warp per output channel
    const int nk = cn * taps;
    for (int co = warp; co < TCO; co += WARPS) {
      const bool real = co0 + co < g.Co;
      const float* src = w + ((size_t)(real ? co0 + co : 0) * g.C + c0) * taps;
      for (int k = lane; k < nk; k += 32) ws[k * TCO + co] = real ? src[k] : 0.f;
    }
    __syncthreads();

    for (int c = 0; c < cn; ++c) {
      for (int kdi = 0; kdi < g.kd; ++kdi) {
        for (int khi = 0; khi < g.kh; ++khi) {
          const float* xrow = xs + ((c * g.kd + kdi) * g.in_rows + khi) * g.in_cols + lane * g.sw;
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

  const int ow = ow0 + lane;
  if (ow >= g.Wo) return;
  const size_t ohw = (size_t)g.Ho * g.Wo;
#pragma unroll
  for (int i = 0; i < RCO; ++i) {
    const int co = co0 + warp * RCO + i;
    if (co >= g.Co) break;  // warp-uniform
    float* dst = out + (((size_t)b * g.Co + co) * g.Do + od) * ohw + ow;
#pragma unroll
    for (int j = 0; j < RH; ++j) {
      const int oh = oh0 + j;
      if (oh < g.Ho) dst[(size_t)oh * g.Wo] = acc[j][i];
    }
  }
}

cudaError_t launch_fma(const void* x, const void* w, void* out, int B, Geometry g,
                       cudaStream_t stream) {
  const int per_channel = g.kd * g.in_rows * g.in_cols + g.kd * g.kh * g.kw * TCO;
  g.chunk = SMEM_FLOATS / per_channel;  // at least 4: per_channel is at most 5,412 floats
  if (g.chunk > g.C) g.chunk = g.C;
  const size_t bytes = (size_t)g.chunk * per_channel * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(g.n_wt * g.n_ht * g.Do), (unsigned)((g.Co + TCO - 1) / TCO),
                  (unsigned)B);
  conv3d_fma_kernel<<<grid, THREADS, bytes, stream>>>((const float*)x, (const float*)w, (float*)out, g);
  return cudaGetLastError();
}

// ---- bf16: the tensor-core kernel ------------------------------------------------

constexpr int MMA_WARPS = 8;    // one output row of the tile each
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int KC = MMA_KC;      // input channels per chunk: one k16 step per tap
constexpr int KW2 = MMA_KW2;    // ... as 32-bit words of two bf16
constexpr int NT = TCO / 8;     // n8 tiles of output channels per CTA
constexpr int MT = TW / 16;     // m16 tiles of output columns per warp
constexpr int STAGE_U = 8;      // halo elements a thread loads before it stores any

// plane is the padded size of one channel pair's halo, in words.
__global__ void __launch_bounds__(MMA_THREADS, 2) conv3d_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const unsigned* __restrict__ wp,
    __nv_bfloat16* __restrict__ out, Geometry g, int plane) {
  extern __shared__ __align__(16) unsigned smem_u[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2;  // the fragment's row (A, C) or column (B)
  const int tig = lane & 3;   // the fragment's pair of k (A, B) or of columns (C)
  const int taps = g.kd * g.kh * g.kw;
  unsigned* xs = smem_u;                 // [KW2][plane]: (kd, in_rows, in_cols) per pair
  unsigned* ws = smem_u + KW2 * plane;   // [taps][TCO][KW2], swizzled
  const int n_rows = KW2 * g.kd * g.in_rows;
  int* row_off = reinterpret_cast<int*>(ws + taps * TCO * KW2);  // [n_rows]
  int* row_dst = row_off + n_rows;                               // [n_rows]

  int t = blockIdx.x;
  const int ow0 = (t % g.n_wt) * TW;
  t /= g.n_wt;
  const int oh0 = (t % g.n_ht) * RH;
  const int od = t / g.n_ht;
  const int co0 = blockIdx.y * TCO;
  const int b = blockIdx.z;
  const int d_in0 = od * g.sd - (g.kd - 1) / 2;
  const int h_in0 = oh0 * g.sh - (g.kh - 1) / 2;
  const int w_in0 = ow0 * g.sw - (g.kw - 1) / 2;
  const size_t hw = (size_t)g.H * g.W;
  const size_t chw = (size_t)g.D * hw;
  const __nv_bfloat16* xb = x + (size_t)b * g.C * chw;
  const int n_chunks = (g.C + KC - 1) / KC;
  const int ws_words = taps * TCO * KW2;
  const uint4* wsrc = reinterpret_cast<const uint4*>(wp + (size_t)blockIdx.y * n_chunks * ws_words);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  // where each (pair, depth, row) of the halo starts in x, relative to the
  // chunk's first channel, or -1 outside x: the same for every chunk
  for (int r = threadIdx.x; r < n_rows; r += MMA_THREADS) {
    const int hr = r % g.in_rows;
    const int pd = r / g.in_rows;
    const int d = d_in0 + pd % g.kd;
    const int h = h_in0 + hr;
    const bool inside = d >= 0 && d < g.D && h >= 0 && h < g.H;
    row_off[r] = inside ? (int)(2 * (pd / g.kd) * chw + (size_t)d * hw + (size_t)h * g.W) : -1;
    row_dst[r] = (pd / g.kd) * plane + (pd % g.kd * g.in_rows + hr) * g.in_cols;
  }
  __syncthreads();

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int c0 = chunk * KC;
    // the input halo, two channels to a word. A thread takes every
    // MMA_THREADS-th element of the (row, column) grid, STAGE_U at a time: all
    // their loads are in flight before the first is packed and stored.
    {
      const __nv_bfloat16* xc = xb + (size_t)c0 * chw;
      const int n_elems = n_rows * g.in_cols;
      const int step_r = MMA_THREADS / g.in_cols, step_c = MMA_THREADS % g.in_cols;
      // rows of channel pairs that lie below C: both channels, the first alone
      const int r_both = min(KW2, (g.C - c0) / 2) * g.kd * g.in_rows;
      const int r_first = min(KW2, (g.C - c0 + 1) / 2) * g.kd * g.in_rows;
      int r = threadIdx.x / g.in_cols, col = threadIdx.x % g.in_cols;
      for (int e0 = threadIdx.x; e0 < n_elems; e0 += STAGE_U * MMA_THREADS) {
        __nv_bfloat16 lo[STAGE_U], hi[STAGE_U];
        int dst[STAGE_U];
#pragma unroll
        for (int u = 0; u < STAGE_U; ++u) {
          lo[u] = hi[u] = zero;
          dst[u] = -1;
          if (e0 + u * MMA_THREADS < n_elems) {
            const int off = row_off[r];
            const int wi = w_in0 + col;
            dst[u] = row_dst[r] + col;
            if (off >= 0 && wi >= 0 && wi < g.W && r < r_first) {
              lo[u] = xc[off + wi];
              if (r < r_both) hi[u] = xc[off + chw + wi];
            }
          }
          col += step_c;
          r += step_r;
          if (col >= g.in_cols) {
            col -= g.in_cols;
            ++r;
          }
        }
#pragma unroll
        for (int u = 0; u < STAGE_U; ++u)
          if (dst[u] >= 0) xs[dst[u]] = pack2(lo[u], hi[u]);
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

    const unsigned* xlo = xs + tig * plane + grp * g.sw;
    const unsigned* xhi = xlo + 4 * plane;
    const int swz = swizzle(grp);
    for (int kdi = 0; kdi < g.kd; ++kdi) {
      for (int khi = 0; khi < g.kh; ++khi) {
        const int row = (kdi * g.in_rows + warp * g.sh + khi) * g.in_cols;
        const unsigned* wtap = ws + ((kdi * g.kh + khi) * g.kw * TCO + grp) * KW2;
        for (int kwi = 0; kwi < g.kw; ++kwi) {
          unsigned a[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int o = row + kwi + m * 16 * g.sw;
            a[m][0] = xlo[o];
            a[m][1] = xlo[o + 8 * g.sw];
            a[m][2] = xhi[o];
            a[m][3] = xhi[o + 8 * g.sw];
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

  const int oh = oh0 + warp;
  if (oh >= g.Ho) return;
  const size_t ohw = (size_t)g.Ho * g.Wo;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int co = co0 + n * 8 + 2 * tig + i;
      if (co >= g.Co) continue;
      __nv_bfloat16* dst = out + (((size_t)b * g.Co + co) * g.Do + od) * ohw + (size_t)oh * g.Wo;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int ow = ow0 + m * 16 + grp;
        if (ow < g.Wo) dst[ow] = __float2bfloat16(acc[m][n][i]);
        if (ow + 8 < g.Wo) dst[ow + 8] = __float2bfloat16(acc[m][n][2 + i]);
      }
    }
  }
}

int mma_plane(const Geometry& g) {
  // words of one channel pair's halo, padded so that the four pairs a
  // fragment load touches fall 8 banks apart
  const int raw = g.kd * g.in_rows * g.in_cols;
  return raw + ((8 - raw % 16) + 16) % 16;
}

cudaError_t launch_mma(const void* x, const void* w, void* out, void* scratch, int B,
                       const Geometry& g, cudaStream_t stream) {
  const int taps = g.kd * g.kh * g.kw;
  // w is (Co, C, taps)
  cudaError_t err = pack_weights<TCO>(w, scratch, g.C, g.Co, taps, 1, taps, g.C * taps, stream);
  if (err != cudaSuccess) return err;
  const int plane = mma_plane(g);
  const size_t bytes = ((size_t)KW2 * plane + (size_t)taps * TCO * KW2 +
                        2 * (size_t)KW2 * g.kd * g.in_rows) * sizeof(unsigned);
  // a channel's offset in x must fit the halo table's 32 bits
  if (bytes > 227 * 1024 || (size_t)KC * g.D * g.H * g.W > 0x7fffffffULL)
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(conv3d_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(g.n_wt * g.n_ht * g.Do), (unsigned)((g.Co + TCO - 1) / TCO),
                  (unsigned)B);
  conv3d_mma_kernel<<<grid, MMA_THREADS, bytes, stream>>>(
      (const __nv_bfloat16*)x, (const unsigned*)scratch, (__nv_bfloat16*)out, g, plane);
  return cudaGetLastError();
}

bool one_of(int v, int a, int b) { return v == a || v == b; }

}  // namespace

// Bytes of scratch that conv3d_forward needs for bf16 inputs (the packed
// weights); 0 for f32, -1 where they are too large.
extern "C" int conv3d_scratch_bytes(int C, int Co, int kd, int kh, int kw, int bf16) {
  return packed_weight_bytes<TCO>(C, Co, kd * kh * kw, bf16);
}

// x (B, C, D, H, W), w (Co, C, kd, kh, kw), out (B, Co, Do, Ho, Wo) with
// each output extent (n + 2 * ((k - 1) / 2) - k) / s + 1: all bf16
// (bf16 != 0) or all f32, contiguous, on the device of `stream`; scratch:
// conv3d_scratch_bytes bytes on that device, 16-byte aligned (unused for f32).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int conv3d_forward(const void* x, const void* w, void* out, void* scratch, int B,
                              int C, int D, int H, int W, int Co, int kd, int kh, int kw,
                              int sd, int sh, int sw, int bf16, void* stream) {
  if (B < 1 || C < 1 || D < 1 || H < 1 || W < 1 || Co < 1 || B > 65535 ||
      !one_of(kd, 1, 3) || !one_of(kh, 1, 3) || !one_of(kw, 1, 3) ||
      !one_of(sd, 1, 2) || !one_of(sh, 1, 2) || !one_of(sw, 1, 2))
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.C = C, g.D = D, g.H = H, g.W = W, g.Co = Co;
  g.kd = kd, g.kh = kh, g.kw = kw, g.sd = sd, g.sh = sh, g.sw = sw;
  g.Do = (D + 2 * ((kd - 1) / 2) - kd) / sd + 1;
  g.Ho = (H + 2 * ((kh - 1) / 2) - kh) / sh + 1;
  g.Wo = (W + 2 * ((kw - 1) / 2) - kw) / sw + 1;
  g.in_rows = (RH - 1) * sh + kh;
  // a multiple of 4 columns keeps the weights behind the halo 16-byte aligned
  g.in_cols = ((TW - 1) * sw + kw + 3) / 4 * 4;
  g.n_wt = (g.Wo + TW - 1) / TW;
  g.n_ht = (g.Ho + RH - 1) / RH;
  g.chunk = 0;
  if ((long long)g.n_wt * g.n_ht * g.Do > 0x7fffffffLL || (g.Co + TCO - 1) / TCO > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    return (int)launch_mma(x, w, out, scratch, B, g, s);
  }
  return (int)launch_fma(x, w, out, B, g, s);
}
