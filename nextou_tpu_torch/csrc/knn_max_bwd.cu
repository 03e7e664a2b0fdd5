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
// tensor is written. An index outside [0, M) is dropped.
//
// What bounds it on the card: bytes. Each input is read once and gy written
// once (52 MB at the largest flagship call, 2 x 10752 x 264 with M = 1344:
// 0.016 ms at 3.35 TB/s); the arithmetic is N*k*C compares and adds.
//
// Design: a scatter into shared memory that reads each query row's g and
// maxv once, deterministic without float atomics. A CTA owns one batch
// entry b, a slice of 32 channels (one per lane: a warp's 32 addresses in a
// row of a tile fall in 32 banks), a chunk of query rows and the f32 tile
// gy_s (candidates x 32) of its gradient. Two kernels, by the tile's size:
//   walk (the tiles of gy and yv fit in 56 KB: M <= 224 in f32, 298 in
//     bf16): one warp per CTA, with the (M x 32) tile of yv staged beside
//     gy_s by cp.async, every row's copy in flight at once. The warp walks
//     its rows in ascending n, G at a time, the next G rows' reads in flight
//     meanwhile. Per row, lane j < k holds idx[n,j]; a lane of channel c
//     loads the k candidates' values (indices by shuffle, all loads issued
//     before any compare) and keeps the tie mask; the G rows' masks come
//     first, then their adds of the share g/cnt into gy_s[m][lane], tied
//     candidates in ascending j;
//   scatter (larger M: the 172 KB tile at M = 1344 leaves no room for yv,
//     which is read through L1/L2): 20 warps share the tile, 16 that count
//     and 4 that add (every adding warp scans every row, so few of them).
//     The rows go in blocks of RB, double-buffered, one CTA barrier per
//     block. Count: warp w takes rows w and w + 16 of the block, all their
//     value loads issued together, and writes to the block's buffer the
//     share, the first tied candidate, the other tied bits and the row's
//     indices. Add: each adding warp owns a range of candidates and walks
//     every row of the block in ascending n, adding into its candidates.
//     The count of block i+1 runs while the adding warps add block i, the
//     row reads of block i+2 in flight.
// In both a (candidate, channel) has one writer and its adds come in
// ascending n (ascending j within a row): the order is fixed by the indices
// alone, as in a walk per candidate. Swin windows (N = M = 168) take one
// CTA per (window, slice), which writes the gradient in one pass. Pool
// graphs (N >> M) split the rows into chunks to fill the card: each chunk's
// CTA writes its partial tile, and a second kernel sums the partials in
// chunk order (deterministic again). Where one chunk covers a batch entry,
// the adds are those of a walk per candidate in ascending n from 0: the
// bits of the first design's two-pass kernel. A scatter tile too large for
// shared memory (M above 1,560) is split into candidate ranges, each with
// its own CTAs, which each count every row of their chunk.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

namespace {

constexpr int S = 32;    // channels per CTA, one per lane
constexpr int RB = 32;   // scatter: rows per block of the double buffer
constexpr int CW = 16;   // scatter: warps that count ties
constexpr int AW = 4;    // scatter: warps that add, each into its candidates
constexpr int SW = CW + AW;
constexpr int G = 4;     // walk: rows whose ties are found together, and
                         // whose reads are in flight meanwhile
constexpr unsigned FULL = 0xffffffffu;
// scatter, per buffer and row: the indices, the first tied candidate, the
// other tied bits and the share, one 32-bit word per lane each
constexpr int BUF_WORDS = 4 * RB * S;
constexpr int BUF_BYTES = 2 * BUF_WORDS * 4;
// walk: at most this much shared memory per CTA (four CTAs on an SM); the
// most a CTA can take
constexpr int WALK_MAX_BYTES = 56 * 1024;
constexpr int SMEM_MAX_BYTES = 227 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The tie mask of one row in this lane's channel: bit j where candidate j
// (`index(j)`, -1 if none) holds the max `mx`. `load(m)` reads candidate
// m's value and must be safe for m = 0; every load is issued
// unconditionally, all of them before the first compare.
template <int KMAX, typename Index, typename Load>
__device__ __forceinline__ unsigned tie_mask(Index index, float mx, bool on, Load load) {
  int m[KMAX];
  float v[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    m[j] = index(j);
    v[j] = load(m[j] < 0 ? 0 : m[j]);
  }
  unsigned mask = 0;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) mask |= (m[j] >= 0 && v[j] == mx) ? 1u << j : 0u;
  return on ? mask : 0u;
}

__device__ __forceinline__ float share_of(unsigned mask, float g) {
  const int cnt = __popc(mask);
  return cnt > 1 ? g / (float)cnt : g;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename TV, int BYTES>
__device__ __forceinline__ void stage_async(TV* dst, const TV* src, int rows, int C, int width,
                                            int lane) {
  constexpr int E = BYTES / (int)sizeof(TV);  // elements per copy
  const int per_row = width / E;
  for (int q = lane; q < rows * per_row; q += 32) {
    const int m = q / per_row, e = q % per_row * E;
    cp_async<BYTES>(dst + m * S + e, src + (size_t)m * C + e);
  }
  cp_async_commit();
  cp_async_wait<0>();
}

// The (rows x width) block at src (row stride C) to dst (row stride S), by
// the lanes of one warp: all copies in flight at once, `copy_bytes` each
// (16, 8 or 4: a divisor of the row's bytes and of src's alignment), or
// element by element where no such size exists (0).
template <typename TV>
__device__ __forceinline__ void stage(TV* dst, const TV* src, int rows, int C, int width,
                                      int copy_bytes, int lane) {
  if (copy_bytes == 16) {
    stage_async<TV, 16>(dst, src, rows, C, width, lane);
  } else if (copy_bytes == 8) {
    stage_async<TV, 8>(dst, src, rows, C, width, lane);
  } else if (copy_bytes == 4) {
    stage_async<TV, 4>(dst, src, rows, C, width, lane);
  } else {
    for (int q = lane; q < rows * width; q += 32) {
      dst[q / width * S + q % width] = src[(size_t)(q / width) * C + q % width];
    }
  }
}

template <typename TV, int KMAX>
__global__ void __launch_bounds__(32) bwd_walk_kernel(
    const TV* __restrict__ yv, const int* __restrict__ idx, const float* __restrict__ maxv,
    const float* __restrict__ g, float* __restrict__ out, int B, int N, int M, int C, int k,
    int slices, int chunk_rows, int copy_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  const int s = blockIdx.x % slices, b = blockIdx.x / slices;
  const int c = s * S + lane;
  const bool has_c = c < C;
  const int n0 = blockIdx.y * chunk_rows, n1 = min(N, n0 + chunk_rows);
  float* gy_s = (float*)smem;
  TV* yv_s = (TV*)(smem + (size_t)M * S * 4);
  const TV* yb = yv + (size_t)b * M * C;
#pragma unroll 8
  for (int m = 0; m < M; ++m) gy_s[m * S + lane] = 0.f;
  stage(yv_s, yb + s * S, M, C, min(S, C - s * S), copy_bytes, lane);
  __syncwarp();

  // the reads of G rows from n: lane j < k's index, the lane's max and g
  int pm[G], qm[G];
  float pmx[G], pg[G], qmx[G], qg[G];
  auto fetch = [&](int n, int* im, float* mx, float* gg) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      im[i] = -1;
      mx[i] = gg[i] = 0.f;
      if (n + i < n1) {
        const size_t row = (size_t)b * N + n + i;
        if (lane < k) im[i] = idx[row * k + lane];
        if (has_c) {
          mx[i] = maxv[row * C + c];
          gg[i] = g[row * C + c];
        }
      }
    }
  };
  fetch(n0, pm, pmx, pg);
  for (int n = n0; n < n1; n += G) {
    fetch(n + G, qm, qmx, qg);
    // the G rows' ties first (a row past n1 has no index and no tie), then
    // their adds in ascending n
    int mine[G], first[G];
    unsigned rest[G], any_rest = 0;
    float w[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      mine[i] = (unsigned)pm[i] < (unsigned)M ? pm[i] : -1;
      const unsigned mask = tie_mask<KMAX>(
          [&](int j) { return __shfl_sync(FULL, mine[i], j); }, pmx[i], has_c,
          [&](int m) { return to_f32(yv_s[m * S + lane]); });
      const int f = __shfl_sync(FULL, mine[i], mask ? __ffs(mask) - 1 : 0);
      first[i] = mask ? f : -1;
      rest[i] = mask & (mask - 1);
      any_rest |= rest[i];
      w[i] = share_of(mask, pg[i]);
    }
    if (!__any_sync(FULL, any_rest != 0)) {
      // one tied candidate per row: the G reads first, then the adds in
      // order (a row whose candidate an earlier row of the group also
      // names adds onto that row's sum), then the stores in order
      float acc[G];
#pragma unroll
      for (int i = 0; i < G; ++i) acc[i] = first[i] >= 0 ? gy_s[first[i] * S + lane] : 0.f;
#pragma unroll
      for (int i = 0; i < G; ++i) {
#pragma unroll
        for (int j = 0; j < i; ++j) {
          if (first[j] == first[i]) acc[i] = acc[j];
        }
        acc[i] += w[i];
      }
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (first[i] >= 0) gy_s[first[i] * S + lane] = acc[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (first[i] >= 0) gy_s[first[i] * S + lane] += w[i];
        // the other tied candidates, ascending j (a shuffle needs every lane)
        while (__any_sync(FULL, rest[i] != 0)) {
          const int m = __shfl_sync(FULL, mine[i], rest[i] ? __ffs(rest[i]) - 1 : 0);
          if (rest[i]) {
            gy_s[m * S + lane] += w[i];
            rest[i] &= rest[i] - 1;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      pm[i] = qm[i];
      pmx[i] = qmx[i];
      pg[i] = qg[i];
    }
  }
  __syncwarp();
  // the tile (a partial one where the rows are chunked) to out[chunk][b]
  float* dst = out + ((size_t)blockIdx.y * B + b) * M * C;
  if (has_c) {
#pragma unroll 8
    for (int m = 0; m < M; ++m) dst[(size_t)m * C + c] = gy_s[m * S + lane];
  }
}

struct Buf {
  int* idx;
  int* first;
  unsigned* rest;
  float* share;
};

__device__ __forceinline__ Buf buffer(unsigned char* base, int which) {
  int* p = (int*)base + which * BUF_WORDS;
  return {p, p + RB * S, (unsigned*)(p + 2 * RB * S), (float*)(p + 3 * RB * S)};
}

template <typename TV, int KMAX>
__global__ void __launch_bounds__(SW * 32, 1) bwd_scatter_kernel(
    const TV* __restrict__ yv, const int* __restrict__ idx, const float* __restrict__ maxv,
    const float* __restrict__ g, float* __restrict__ out, int B, int N, int M, int C, int k,
    int slices, int ranges, int mrange, int chunk_rows) {
  constexpr int ROWS = RB / CW;  // rows per counting warp per block
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = blockIdx.x % slices;
  const int r = (blockIdx.x / slices) % ranges;
  const int b = blockIdx.x / (slices * ranges);
  const int c = s * S + lane;
  const bool has_c = c < C;
  const int mlo = r * mrange, mr = min(M, mlo + mrange) - mlo;
  // warps [0, CW) count, warps [CW, SW) add: the candidates this one adds into
  const bool counts = warp < CW;
  const int aw = warp - CW;
  const int wlo = mlo + mr * aw / AW, whi = mlo + mr * (aw + 1) / AW;
  const int n0 = blockIdx.y * chunk_rows, n1 = min(N, n0 + chunk_rows);
  const int blocks = (n1 - n0 + RB - 1) / RB;

  float* gy_s = (float*)smem;
  unsigned char* bufs = smem + (size_t)mrange * S * 4;
  const TV* yb = yv + (size_t)b * M * C;
  const int cl = has_c ? c : C - 1;  // a lane past C reads a valid address, unused
  for (int i = threadIdx.x; i < mr * S; i += SW * 32) gy_s[i] = 0.f;

  // the row reads of one block: lane j < k's index, the lane's max and g
  int pm[ROWS];
  float pmx[ROWS], pg[ROWS];
  auto fetch = [&](int blk) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int n = n0 + blk * RB + warp + i * CW;
      pm[i] = -1;
      pmx[i] = pg[i] = 0.f;
      if (n < n1) {
        const size_t row = (size_t)b * N + n;
        if (lane < k) pm[i] = idx[row * k + lane];
        if (has_c) {
          pmx[i] = maxv[row * C + c];
          pg[i] = g[row * C + c];
        }
      }
    }
  };
  auto count = [&](int blk) {
    const Buf bf = buffer(bufs, blk & 1);
    unsigned mask[ROWS];
    int mine[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {  // a row past n1 has no index: no load
      mine[i] = (unsigned)pm[i] < (unsigned)M ? pm[i] : -1;
      mask[i] = tie_mask<KMAX>([&](int j) { return __shfl_sync(FULL, mine[i], j); }, pmx[i],
                               has_c, [&](int m) { return to_f32(yb[(size_t)m * C + cl]); });
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int rl = warp + i * CW;
      const int first = __shfl_sync(FULL, mine[i], mask[i] ? __ffs(mask[i]) - 1 : 0);
      if (n0 + blk * RB + rl < n1) {
        bf.idx[rl * S + lane] = mine[i];
        bf.first[rl * S + lane] = mask[i] ? first : -1;
        bf.rest[rl * S + lane] = mask[i] & (mask[i] - 1);
        bf.share[rl * S + lane] = share_of(mask[i], pg[i]);
      }
    }
  };
  auto add = [&](int blk) {
    const Buf bf = buffer(bufs, blk & 1);
    const int rows = min(RB, n1 - n0 - blk * RB);
    constexpr int U = 4;  // rows whose buffer reads are in flight together
    for (int r0 = 0; r0 < rows; r0 += U) {
      int m[U];
      unsigned rest[U];
      float w[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rl = r0 + u < rows ? r0 + u : r0;
        m[u] = r0 + u < rows ? bf.first[rl * S + lane] : -1;
        rest[u] = r0 + u < rows ? bf.rest[rl * S + lane] : 0u;
        w[u] = bf.share[rl * S + lane];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (m[u] >= wlo && m[u] < whi) gy_s[(m[u] - mlo) * S + lane] += w[u];
        while (rest[u]) {  // a tie: the other tied candidates, ascending j
          const int m2 = bf.idx[(r0 + u) * S + __ffs(rest[u]) - 1];
          rest[u] &= rest[u] - 1;
          if (m2 >= wlo && m2 < whi) gy_s[(m2 - mlo) * S + lane] += w[u];
        }
      }
    }
  };

  // a counting warp's row reads for block i + 1 are in flight while the
  // adding warps add block i - 1
  if (counts && blocks > 0) fetch(0);
  __syncthreads();  // gy_s zeroed
  if (counts && blocks > 0) {
    count(0);
    if (blocks > 1) fetch(1);
  }
  __syncthreads();
  for (int blk = 0; blk < blocks; ++blk) {
    if (!counts) {
      add(blk);
    } else if (blk + 1 < blocks) {
      count(blk + 1);
      if (blk + 2 < blocks) fetch(blk + 2);
    }
    __syncthreads();
  }

  // the tile (a partial one where the rows are chunked) to out[chunk][b]
  float* dst = out + (((size_t)blockIdx.y * B + b) * M + mlo) * C;
  for (int i = threadIdx.x; i < mr * S; i += SW * 32) {
    const int cc = s * S + (i & (S - 1));
    if (cc < C) dst[(size_t)(i / S) * C + cc] = gy_s[i];
  }
}

// gy = the partials summed in chunk order
__global__ void bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ gy,
                               size_t total, int chunks) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    float acc = part[e];
    for (int p = 1; p < chunks; ++p) acc += part[(size_t)p * total + e];
    gy[e] = acc;
  }
}

// How a launch runs: the walk kernel (1) or the scatter kernel (0), warps
// per CTA, channel slices, candidate ranges of mrange rows, query rows per
// chunk and chunks, shared memory per CTA and CTAs resident per SM.
struct Plan {
  int walk, warps, slices, ranges, mrange, chunk_rows, chunks, smem, per_sm;
};

struct Args {
  const void* yv;
  const int* idx;
  const float* maxv;
  const float* g;
  float* gy;
  float* part;
  int B, N, M, C, k;
  cudaStream_t stream;
};

// Opt the kernel in to `bytes` of shared memory on the current device, once
// per kernel, device and size.
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static int allowed[64] = {};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) allowed[dev] = bytes;
  return err;
}

// Occupancy and the chunks of rows: chunks where (batch entry, slice,
// range) alone leave SMs idle, never more than one wave of CTAs; a chunk's
// rows a multiple of `step`.
template <auto Kernel>
cudaError_t choose_chunks(Plan& p, const Args& a, int step) {
  cudaError_t err = allow_smem<Kernel>(p.smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.per_sm, Kernel, p.warps * 32, p.smem);
  if (err != cudaSuccess) return err;
  int dev, sms;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (p.per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long base = (long long)a.B * p.slices * p.ranges, resident = (long long)p.per_sm * sms;
  const int chunks = base >= resident ? 1 : (int)(resident / base);
  const int per_chunk = (a.N + chunks - 1) / chunks;
  p.chunk_rows = (per_chunk + step - 1) / step * step;
  p.chunks = (a.N + p.chunk_rows - 1) / p.chunk_rows;
  return cudaSuccess;
}

cudaError_t sum_partials(const Plan& p, const Args& a) {
  if (p.chunks == 1) return cudaSuccess;
  const size_t total = (size_t)a.B * a.M * a.C;
  const unsigned blocks = (unsigned)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  bwd_sum_kernel<<<blocks, 256, 0, a.stream>>>(a.part, a.gy, total, p.chunks);
  return cudaGetLastError();
}

// Without `launch`, the chunks of the plan; with it, the launch of the plan
// whose chunks the caller passes (checked against N and the kernel's step).
template <typename TV, int KMAX>
cudaError_t launch_k(bool launch, Plan& p, const Args& a) {
  const int step = p.walk ? G : RB;
  if (!launch) {
    return p.walk ? choose_chunks<bwd_walk_kernel<TV, KMAX>>(p, a, step)
                  : choose_chunks<bwd_scatter_kernel<TV, KMAX>>(p, a, step);
  }
  if (p.chunk_rows < 1 || p.chunk_rows % step != 0 ||
      p.chunks != (a.N + p.chunk_rows - 1) / p.chunk_rows || (p.chunks > 1 && !a.part)) {
    return cudaErrorInvalidValue;
  }
  float* out = p.chunks > 1 ? a.part : a.gy;
  cudaError_t err;
  if (p.walk) {
    if ((err = allow_smem<bwd_walk_kernel<TV, KMAX>>(p.smem)) != cudaSuccess) return err;
    // the widest copy that divides a row's bytes and the tensor's alignment
    const size_t row_bytes = (size_t)a.C * sizeof(TV), addr = (size_t)a.yv;
    int copy_bytes = 16;
    while (copy_bytes >= 4 && (row_bytes % copy_bytes || addr % copy_bytes)) copy_bytes /= 2;
    if (copy_bytes < 4) copy_bytes = 0;
    bwd_walk_kernel<TV, KMAX><<<dim3((unsigned)(a.B * p.slices), (unsigned)p.chunks), 32,
                                p.smem, a.stream>>>(
        (const TV*)a.yv, a.idx, a.maxv, a.g, out, a.B, a.N, a.M, a.C, a.k, p.slices,
        p.chunk_rows, copy_bytes);
  } else {
    if ((err = allow_smem<bwd_scatter_kernel<TV, KMAX>>(p.smem)) != cudaSuccess) return err;
    bwd_scatter_kernel<TV, KMAX><<<dim3((unsigned)(a.B * p.slices * p.ranges),
                                        (unsigned)p.chunks),
                                   SW * 32, p.smem, a.stream>>>((const TV*)a.yv, a.idx,
                                                                a.maxv, a.g, out, a.B, a.N,
                                                                a.M, a.C, a.k, p.slices,
                                                                p.ranges, p.mrange,
                                                                p.chunk_rows);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return sum_partials(p, a);
}

template <typename TV>
cudaError_t launch_tv(bool launch, Plan& p, const Args& a) {
  p.slices = (a.C + S - 1) / S;
  const long long walk_bytes = (long long)a.M * S * (4 + (int)sizeof(TV));
  p.walk = walk_bytes <= WALK_MAX_BYTES;
  p.warps = p.walk ? 1 : SW;
  p.ranges = 1;
  p.mrange = a.M;
  if (!p.walk) {
    const int fit = (SMEM_MAX_BYTES - BUF_BYTES) / (S * 4);
    p.ranges = (a.M + fit - 1) / fit;
    p.mrange = (a.M + p.ranges - 1) / p.ranges;
  }
  p.smem = p.walk ? (int)walk_bytes : p.mrange * S * 4 + BUF_BYTES;
  if ((long long)a.B * p.slices * p.ranges > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (a.k <= 8) return launch_k<TV, 8>(launch, p, a);
  if (a.k <= 16) return launch_k<TV, 16>(launch, p, a);
  return launch_k<TV, 32>(launch, p, a);
}

cudaError_t plan_or_launch(bool launch, Plan& p, const Args& a, int values_bf16) {
  if (a.B < 1 || a.N < 1 || a.M < 1 || a.C < 1 || a.k < 1 || a.k > 32) {
    return cudaErrorInvalidValue;
  }
  return values_bf16 ? launch_tv<__nv_bfloat16>(launch, p, a) : launch_tv<float>(launch, p, a);
}

}  // namespace

// The plan of a launch with these arguments on the current device, as 9
// ints at `out`: the walk kernel (1) or the scatter kernel (0), warps per
// CTA, channel slices, candidate ranges, candidates per range, query rows
// per chunk, chunks, shared memory bytes per CTA, CTAs resident per SM.
// Returns a cudaError_t.
extern "C" int knn_max_bwd_plan(int B, int N, int M, int C, int k, int values_bf16, void* out) {
  Plan p;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, B, N, M, C, k, nullptr};
  const cudaError_t err = plan_or_launch(false, p, a, values_bf16);
  if (err == cudaSuccess) {
    const int v[9] = {p.walk, p.warps, p.slices, p.ranges, p.mrange,
                      p.chunk_rows, p.chunks, p.smem, p.per_sm};
    for (int i = 0; i < 9; ++i) ((int*)out)[i] = v[i];
  }
  return (int)err;
}

// yv (B,M,C): candidate values, bf16 (values_bf16 != 0) or f32; idx (B,N,k)
// int32, each row naming distinct candidates; maxv, g (B,N,C) f32; gy
// (B,M,C) f32, the output, written everywhere. chunk_rows and chunks: the
// plan's (knn_max_bwd_plan with the same arguments); part: scratch of
// (chunks, B, M, C) f32 where chunks > 1 (else unused). All contiguous, on
// the current device, launched on `stream`. Returns a cudaError_t (0 on
// success).
extern "C" int knn_max_backward(const void* yv, const void* idx, const void* maxv,
                                const void* g, void* gy, void* part, int B, int N, int M,
                                int C, int k, int values_bf16, int chunk_rows, int chunks,
                                void* stream) {
  Plan p;
  p.chunk_rows = chunk_rows;
  p.chunks = chunks;
  const Args a{yv, (const int*)idx, (const float*)maxv, (const float*)g, (float*)gy,
               (float*)part, B, N, M, C, k, (cudaStream_t)stream};
  return (int)plan_or_launch(true, p, a, values_bf16);
}
