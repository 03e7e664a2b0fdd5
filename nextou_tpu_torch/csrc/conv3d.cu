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
// bf16: the wgmma implicit GEMM of conv_sm90.cuh (a staging ring, N tiles as
// wide as Co, K in granules of 8 channels); this file gives it NCDHW's halo
// and store. The halo: the channel-inner granules that ldmatrix reads have
// to be gathered from 8 channel planes, in one of two routes that the plan
// picks from W:
// - W % 8 == 0 (the flagship's; ROUTE_VEC): a thread takes 8 columns of one
//   (depth, row) that start at a multiple of 8 in x, loads them 16 bytes a
//   channel (8 loads), and transposes the 8 x 8 block in registers
//   (byte_perm) into 8 granules: an eighth of the loads of a granule at a
//   time, and at stride 2 the run of columns the halo needs is read whole;
// - otherwise (ROUTE_REGS): a thread loads a granule's 8 values (one per
//   plane; neighbouring threads on neighbouring columns, so each load is
//   coalesced), PRODUCER_BATCH granules in flight at once, packs them in
//   registers and stores 16 bytes.
// The store: the block's bf16 tile is kept [channel][position] in shared
// memory, and written along W, 16 bytes a store where W and the block's
// columns are multiples of 8 (the flagship's are).
//
// f32 (conv3d_fma_kernel): the same sum as f32 FMAs, never TF32. A warp owns 8
// output channels and a lane one output column, so a thread holds 8 rows x
// 8 channels = 64 sums; per (channel, tap) it reads 8 input values (lanes on
// neighbouring addresses) and 8 weights (two 16-byte loads, the same for
// every lane) for 64 FMAs. The chunk is as many channels as fit 96 KB, so
// two CTAs share an SM and one stages while the other multiplies.

#include <stddef.h>

#include "conv_sm90.cuh"

namespace {

constexpr int TW = 32;   // the f32 kernel: output columns per CTA
constexpr int RH = 8;    // ... output rows per CTA
constexpr int TCO = 72;  // ... output channels per CTA
constexpr int RCO = 8;   // ... a warp per 8 output channels, a lane per output column
constexpr int WARPS = TCO / RCO;
constexpr int THREADS = WARPS * 32;
constexpr int SMEM_FLOATS = 24 * 1024;  // 96 KB: two CTAs per SM

struct Geometry {
  int C, D, H, W;          // input channels and extent
  int Co, Do, Ho, Wo;      // output channels and extent
  int kd, kh, kw;          // kernel dims, each 1 or 3
  int sd, sh, sw;          // strides, each 1 or 2
  int in_rows, in_cols;    // the halo of one tile: (RH-1)*sh + kh, (TW-1)*sw + kw
  int chunk;               // input channels staged at a time
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

// ---- bf16: NCDHW's halo and store for the wgmma core ---------------------------------

struct Ncdhw {
  // Granule gr of halo position (dd, r, col): channels c0 + 8 gr .. + 7 at
  // one (d, h, w), 8 loads from 8 planes, packed into 16 bytes.
  // W % 8 == 0 (ROUTE_VEC): a thread takes 8 columns of one (depth, row)
  // that start at a multiple of 8 in x, loads them 16 bytes a channel, and
  // transposes the 8 x 8 block in registers into 8 granules; columns that
  // fall outside the halo are not stored.
  static __device__ __forceinline__ void stage_vec(const unsigned short* __restrict__ xb,
                                                   const sm90::Geom& g, const sm90::Tile& t,
                                                   unsigned char* halo, int c0, int gpc,
                                                   int ptid) {
    constexpr int P = sm90::STAGERS;
    const size_t hw = (size_t)g.H * g.W, chw = (size_t)g.D * hw;
    const int gw0 = (t.w0 >= 0 ? t.w0 : t.w0 - 7) / 8 * 8;  // floor to a multiple of 8
    const int n_groups = (t.w0 + g.in_cols - gw0 + 7) / 8;
    const int n_tasks = gpc * g.kd * g.in_rows * n_groups;
    for (int task = ptid; task < n_tasks; task += P) {
      const int grp = task % n_groups;
      int rest = task / n_groups;
      const int r = rest % g.in_rows;
      rest /= g.in_rows;
      const int dd = rest % g.kd, gr = rest / g.kd;
      const int w = gw0 + 8 * grp;
      const int d = t.d0 + dd, h = t.h0 + r, c = c0 + gr * 8;
      const bool inside = d >= 0 && d < g.D && h >= 0 && h < g.H && w >= 0 && w < g.W;
      const uint4* src = reinterpret_cast<const uint4*>(
          xb + (size_t)c * chw + (size_t)d * hw + (size_t)h * g.W + w);
      uint4 v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = inside && c + i < g.C ? src[i * chw / 8] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = w + j - t.w0;
        if (col < 0 || col >= g.in_cols) continue;
        // position j of channels 2k and 2k + 1: one 32-bit word of the granule
        const unsigned sel = j & 1 ? 0x7632 : 0x5410;
        unsigned word[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint4 lo = v[2 * k], hi = v[2 * k + 1];
          const unsigned a = (j >> 1) == 0 ? lo.x : (j >> 1) == 1 ? lo.y : (j >> 1) == 2 ? lo.z : lo.w;
          const unsigned b = (j >> 1) == 0 ? hi.x : (j >> 1) == 1 ? hi.y : (j >> 1) == 2 ? hi.z : hi.w;
          word[k] = __byte_perm(a, b, sel);
        }
        const int pos = sm90::halo_pos(g, dd, r, col);
        *reinterpret_cast<uint4*>(halo + sm90::granule_offset(g, pos, gr)) =
            make_uint4(word[0], word[1], word[2], word[3]);
      }
    }
  }

  static __device__ __forceinline__ void stage_halo(const __nv_bfloat16* __restrict__ x,
                                                    const sm90::Geom& g, const sm90::Tile& t,
                                                    unsigned char* halo, int c0, int gpc, int ptid,
                                                    uint32_t full) {
    constexpr int U = sm90::PRODUCER_BATCH, P = sm90::STAGERS;
    const size_t hw = (size_t)g.H * g.W, chw = (size_t)g.D * hw;
    const unsigned short* xb =
        reinterpret_cast<const unsigned short*>(x) + (size_t)t.b * g.C * chw;
    if (g.route == sm90::ROUTE_VEC) {
      stage_vec(xb, g, t, halo, c0, gpc, ptid);
      sm90::mbar_arrive(full);
      return;
    }
    const int n_tasks = gpc * g.kd * g.in_rows * g.in_cols;
    // U granules' 8 loads each are in flight before the first is stored
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
        const int col = task % g.in_cols;
        int rest = task / g.in_cols;
        const int r = rest % g.in_rows;
        rest /= g.in_rows;
        const int dd = rest % g.kd, gr = rest / g.kd;
        const int d = t.d0 + dd, h = t.h0 + r, w = t.w0 + col;
        const int c = c0 + gr * 8;
        dst[u] = sm90::granule_offset(g, sm90::halo_pos(g, dd, r, col), gr);
        if (d >= 0 && d < g.D && h >= 0 && h < g.H && w >= 0 && w < g.W) {
          const unsigned short* src = xb + (size_t)c * chw + (size_t)d * hw + (size_t)h * g.W + w;
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (c + i < g.C) e[u][i] = src[i * chw];
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
    sm90::mbar_arrive(full);
  }

  // [channel][position], a row of TM + 8 (16-byte rows, fewer bank conflicts)
  static __device__ __forceinline__ int tile_index(int m, int co, int) {
    return co * (sm90::TM + 8) + m;
  }

  // Runs along W: out[b, co, od, oh, ow0 ..].
  template <int V>
  static __device__ __forceinline__ void store_runs(__nv_bfloat16* out, const sm90::Geom& g,
                                                    const sm90::Tile& t,
                                                    const __nv_bfloat16* tile, int tid) {
    const int tw = min(g.tw, g.Wo - t.ow0), th = min(g.th, g.Ho - t.oh0);
    const int n = min(g.n, g.Co - t.co0);
    const size_t plane = (size_t)g.Ho * g.Wo, ch = (size_t)g.Do * plane;
    __nv_bfloat16* ob = out + ((size_t)t.b * g.Co + t.co0) * ch + t.od * plane +
                        (size_t)t.oh0 * g.Wo + t.ow0;
    const int units = tw / V, items = n * th * units;
    for (int it = tid; it < items; it += sm90::CONSUMER_WARPS * 32) {
      const int u = it % units, rest = it / units;
      const int r = rest % th, co = rest / th;
      sm90::copy_bf16<V>(ob + co * ch + (size_t)r * g.Wo + u * V,
                         tile + tile_index(r * g.tw + u * V, co, 0));
    }
  }

  static __device__ __forceinline__ void store(__nv_bfloat16* out, const sm90::Geom& g,
                                               const sm90::Tile& t, const __nv_bfloat16* tile,
                                               int, int tid) {
    if (g.Wo % 8 == 0 && g.tw % 8 == 0)
      store_runs<8>(out, g, t, tile, tid);
    else
      store_runs<1>(out, g, t, tile, tid);
  }
};

bool one_of(int v, int a, int b) { return v == a || v == b; }

bool valid(int B, int C, int D, int H, int W, int Co, int kd, int kh, int kw, int sd, int sh,
           int sw) {
  return B >= 1 && C >= 1 && D >= 1 && H >= 1 && W >= 1 && Co >= 1 && B <= 65535 &&
         one_of(kd, 1, 3) && one_of(kh, 1, 3) && one_of(kw, 1, 3) && one_of(sd, 1, 2) &&
         one_of(sh, 1, 2) && one_of(sw, 1, 2);
}

}  // namespace

// The bf16 kernel's plan for this conv: out[14] = {th, tw, n, n_tiles,
// granules, cs, stages, splits, route, chunks, ctas, smem, k_steps,
// scratch} (conv_sm90_plan). Returns a cudaError_t (0 on success).
extern "C" int conv3d_plan(int B, int C, int D, int H, int W, int Co, int kd, int kh, int kw,
                           int sd, int sh, int sw, int* out) {
  sm90::Geom g;
  if (!valid(B, C, D, H, W, Co, kd, kh, kw, sd, sh, sw) ||
      !sm90::conv_sm90_plan(sm90::NCDHW, B, C, D, H, W, Co, kd, kh, kw, sd, sh, sw, g, out))
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The bf16 weights w (Co, C, kd, kh, kw) packed as the kernel stages them,
// into wp (the plan's scratch bytes): what conv3d_forward does first.
extern "C" int conv3d_pack_weights(const void* w, void* wp, int B, int C, int D, int H, int W,
                                   int Co, int kd, int kh, int kw, int sd, int sh, int sw,
                                   void* stream) {
  sm90::Geom g;
  int plan[sm90::PLAN_INTS];
  if (!valid(B, C, D, H, W, Co, kd, kh, kw, sd, sh, sw) ||
      !sm90::conv_sm90_plan(sm90::NCDHW, B, C, D, H, W, Co, kd, kh, kw, sd, sh, sw, g, plan))
    return (int)cudaErrorInvalidValue;
  const int taps = kd * kh * kw;
  return (int)sm90::pack_weights(w, wp, g, 1, taps, C * taps, (cudaStream_t)stream);
}

// x (B, C, D, H, W), w (Co, C, kd, kh, kw), out (B, Co, Do, Ho, Wo) with
// each output extent (n + 2 * ((k - 1) / 2) - k) / s + 1: all bf16
// (bf16 != 0) or all f32, contiguous, on the device of `stream`; scratch:
// the plan's scratch bytes on that device, 16-byte aligned (unused for f32).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int conv3d_forward(const void* x, const void* w, void* out, void* scratch, int B,
                              int C, int D, int H, int W, int Co, int kd, int kh, int kw,
                              int sd, int sh, int sw, int bf16, void* stream) {
  if (!valid(B, C, D, H, W, Co, kd, kh, kw, sd, sh, sw)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    sm90::Geom g;
    int plan[sm90::PLAN_INTS];
    if (scratch == nullptr ||
        !sm90::conv_sm90_plan(sm90::NCDHW, B, C, D, H, W, Co, kd, kh, kw, sd, sh, sw, g, plan))
      return (int)cudaErrorInvalidValue;
    // the 16-byte loads of ROUTE_VEC need x 16-byte aligned
    if (g.route == sm90::ROUTE_VEC && reinterpret_cast<uintptr_t>(x) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    const int taps = kd * kh * kw;
    return (int)sm90::conv_sm90_launch<Ncdhw>(x, w, out, scratch, g, plan[11], 1, taps,
                                              C * taps, s);
  }
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
  return (int)launch_fma(x, w, out, B, g, s);
}
