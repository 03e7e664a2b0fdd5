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
// spends its effort on the products, and for the bytes reads x in
// contiguous channel runs and writes each output once.
//
// bf16: the wgmma implicit GEMM of conv_sm90.cuh (a staging ring, N tiles as
// wide as Co, K in granules of 8 channels, so C = 33 pads to 40 and Co = 33
// takes a 40-wide tile); this file gives it NDHWC's halo and store.
// Channels-last puts a granule's 8 channels side by side in x already, so the
// halo needs no transpose, and the plan picks one of three routes by C:
// - C % 8 == 0 (d4's 648): one 16-byte cp.async per granule, zero-filled
//   outside x, counted on the stage's barrier by cp.async.mbarrier.arrive;
// - C even (66, 132: a position is 4-byte aligned, not 16): four 4-byte
//   cp.asyncs per granule, likewise;
// - C odd (33): the producer loads the granule's 8 channels in registers,
//   PRODUCER_BATCH granules in flight at once, and stores 16 bytes.
// The store: the block's tile is kept [position][channel] in shared memory
// and written along Co, 16 bytes a store where Co and the tile's width are
// multiples of 8, else 4 (C even) or 2.
//
// f32 (conv_cl_fma_kernel): the same sum as f32 FMAs, never TF32. A warp owns
// 8 output channels and a lane one output column, so a thread holds 8 rows x
// 8 channels = 64 sums; the chunk is as many channels as fit 96 KB.

#include <stddef.h>

#include "conv_sm90.cuh"

namespace {

constexpr int TW = 32;   // the f32 kernel: output columns per CTA
constexpr int RH = 8;    // ... output rows per CTA
constexpr int TCO = 72;  // ... output channels per CTA
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

// ---- bf16: NDHWC's halo and store for the wgmma core ---------------------------------

struct Ndhwc {
  // Granule gr of halo position (dd, r, col): channels c0 + 8 gr .. + 7 of
  // one (d, h, w), contiguous in x.
  static __device__ __forceinline__ void stage_halo(const __nv_bfloat16* __restrict__ x,
                                                    const sm90::Geom& g, const sm90::Tile& t,
                                                    unsigned char* halo, int c0, int gpc, int ptid,
                                                    uint32_t full) {
    constexpr int U = sm90::PRODUCER_BATCH, P = sm90::STAGERS;
    const unsigned short* xb =
        reinterpret_cast<const unsigned short*>(x) + (size_t)t.b * g.D * g.H * g.W * g.C;
    const int n_tasks = gpc * g.kd * g.in_rows * g.in_cols;
    for (int task0 = ptid; task0 < n_tasks; task0 += U * P) {
      unsigned short e[U][8];
      int dst[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int task = task0 + u * P;
        dst[u] = -1;
#pragma unroll
        for (int i = 0; i < 8; ++i) e[u][i] = 0;
        if (task >= n_tasks) continue;
        const int gr = task % gpc;
        int rest = task / gpc;
        const int col = rest % g.in_cols;
        rest /= g.in_cols;
        const int r = rest % g.in_rows, dd = rest / g.in_rows;
        const int d = t.d0 + dd, h = t.h0 + r, w = t.w0 + col;
        const int c = c0 + gr * 8;
        const bool inside = d >= 0 && d < g.D && h >= 0 && h < g.H && w >= 0 && w < g.W;
        const unsigned short* src = xb + (((size_t)d * g.H + h) * g.W + w) * g.C + c;
        dst[u] = sm90::granule_offset(g, sm90::halo_pos(g, dd, r, col), gr);
        if (g.route != sm90::ROUTE_REGS) {  // asynchronous copies, zero-filled outside x
          const uint32_t sd = sm90::smem_addr(halo + dst[u]);
          dst[u] = -1;
          if (g.route == sm90::ROUTE_CP16 || !inside) {
            sm90::cp_async16(sd, inside ? (const void*)src : (const void*)x, inside ? 16 : 0);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              sm90::cp_async4(sd + 4 * i, src + 2 * i, c + 2 * i < g.C ? 4 : 0);
          }
          continue;
        }
        if (inside) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (c + i < g.C) e[u][i] = src[i];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (dst[u] < 0) continue;
        unsigned v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = (unsigned)e[u][2 * i] | ((unsigned)e[u][2 * i + 1] << 16);
        *reinterpret_cast<uint4*>(halo + dst[u]) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    if (g.route == sm90::ROUTE_REGS)
      sm90::mbar_arrive(full);
    else
      sm90::cp_async_arrive(full);
  }

  // [position][channel], a row of n + 8 (16-byte rows, fewer bank conflicts)
  static __device__ __forceinline__ int tile_index(int m, int co, int n) { return m * (n + 8) + co; }

  // Runs along Co: out[n, od, oh, ow, co0 ..], V channels a store.
  template <int V>
  static __device__ __forceinline__ void store_runs(__nv_bfloat16* out, const sm90::Geom& g,
                                                    const sm90::Tile& t,
                                                    const __nv_bfloat16* tile, int tid) {
    const int tw = min(g.tw, g.Wo - t.ow0), th = min(g.th, g.Ho - t.oh0);
    const int n = min(g.n, g.Co - t.co0);
    __nv_bfloat16* ob =
        out + ((((size_t)t.b * g.Do + t.od) * g.Ho + t.oh0) * g.Wo + t.ow0) * g.Co + t.co0;
    const int units = n / V, items = th * tw * units;
    for (int it = tid; it < items; it += sm90::CONSUMER_WARPS * 32) {
      const int u = it % units, rest = it / units;
      const int c = rest % tw, r = rest / tw;
      sm90::copy_bf16<V>(ob + ((size_t)r * g.Wo + c) * g.Co + u * V,
                         tile + tile_index(r * g.tw + c, u * V, g.n));
    }
  }

  static __device__ __forceinline__ void store(__nv_bfloat16* out, const sm90::Geom& g,
                                               const sm90::Tile& t, const __nv_bfloat16* tile,
                                               int, int tid) {
    const int n = min(g.n, g.Co - t.co0);
    if (g.Co % 8 == 0 && n % 8 == 0)
      store_runs<8>(out, g, t, tile, tid);
    else if (g.Co % 2 == 0 && n % 2 == 0)
      store_runs<2>(out, g, t, tile, tid);
    else
      store_runs<1>(out, g, t, tile, tid);
  }
};

bool one_of(int v, int a, int b) { return v == a || v == b; }

bool valid(int N, int D, int H, int W, int C, int Co, int kd, int kh, int kw, int sd, int sh,
           int sw) {
  // one batch element's offsets fit 32 bits where the f32 kernel keeps them
  return N >= 1 && C >= 1 && D >= 1 && H >= 1 && W >= 1 && Co >= 1 && N <= 65535 &&
         one_of(kd, 1, 3) && one_of(kh, 1, 3) && one_of(kw, 1, 3) && one_of(sd, 1, 2) &&
         one_of(sh, 1, 2) && one_of(sw, 1, 2) && D >= sd && H >= sh && W >= sw &&
         (size_t)D * H * W * C <= 0x7fffffffULL;
}

}  // namespace

// The bf16 kernel's plan for this conv: out[14] = {th, tw, n, n_tiles,
// granules, cs, stages, splits, route, chunks, ctas, smem, k_steps,
// scratch} (conv_sm90_plan). Returns a cudaError_t (0 on success).
extern "C" int conv_cl_plan(int N, int D, int H, int W, int C, int Co, int kd, int kh, int kw,
                            int sd, int sh, int sw, int* out) {
  sm90::Geom g;
  if (!valid(N, D, H, W, C, Co, kd, kh, kw, sd, sh, sw) ||
      !sm90::conv_sm90_plan(sm90::NDHWC, N, C, D, H, W, Co, kd, kh, kw, sd, sh, sw, g, out))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The bf16 weights w (kd, kh, kw, C, Co) packed as the kernel stages them,
// into wp (the plan's scratch bytes): what conv_cl_forward does first.
extern "C" int conv_cl_pack_weights(const void* w, void* wp, int N, int D, int H, int W, int C,
                                    int Co, int kd, int kh, int kw, int sd, int sh, int sw,
                                    void* stream) {
  sm90::Geom g;
  int plan[sm90::PLAN_INTS];
  if (!valid(N, D, H, W, C, Co, kd, kh, kw, sd, sh, sw) ||
      !sm90::conv_sm90_plan(sm90::NDHWC, N, C, D, H, W, Co, kd, kh, kw, sd, sh, sw, g, plan))
    return (int)cudaErrorInvalidValue;
  return (int)sm90::pack_weights(w, wp, g, C * Co, Co, 1, (cudaStream_t)stream);
}

// x (N, D, H, W, C), w (kd, kh, kw, C, Co), out (N, D / sd, H / sh, W / sw,
// Co): all bf16 (bf16 != 0) or all f32, contiguous, on the device of
// `stream`; scratch: the plan's scratch bytes on that device, 16-byte
// aligned (unused for f32). Returns the cudaError_t of the launch.
extern "C" int conv_cl_forward(const void* x, const void* w, void* out, void* scratch, int N,
                               int D, int H, int W, int C, int Co, int kd, int kh, int kw,
                               int sd, int sh, int sw, int bf16, void* stream) {
  if (!valid(N, D, H, W, C, Co, kd, kh, kw, sd, sh, sw)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    sm90::Geom g;
    int plan[sm90::PLAN_INTS];
    if (scratch == nullptr ||
        !sm90::conv_sm90_plan(sm90::NDHWC, N, C, D, H, W, Co, kd, kh, kw, sd, sh, sw, g, plan))
      return (int)cudaErrorInvalidValue;
    return (int)sm90::conv_sm90_launch<Ndhwc>(x, w, out, scratch, g, plan[11], C * Co, Co, 1,
                                              s);
  }
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
  return (int)launch_fma(x, w, out, N, g, s);
}
