// The selection that K1, K2 and K3 share: a running top-k per query row over
// candidate chunks whose distances come from the tensor cores, and the
// gather + per-channel max over the winners.
//
// It replaces the body that the Pallas TPU kernels
// nextou_tpu/kernels/knn.py::_kernel, ::_idx_kernel and ::_maxidx_kernel have
// in common. For every query row n of graph b:
//
//   dist[m] = (x_sq[n] - 2 * <xn[n], yn[m]>) + y_sq[m]  (+ rel[n, m])
//   S       = the k smallest dist by (distance, index): ties -> lowest index
//
// The inner product runs on mma.sync with f32 accumulators:
//   - bf16 coordinates (K1 at inference): m16n8k16 bf16 -> f32. bf16
//     products are exact in f32, so this is the reference's one bf16 MXU
//     pass; only the order and rounding of the f32 sums differ, within the
//     1e-4 near ties that chip_smoke.py's phase 3 allows.
//   - f32 coordinates (K2, K3, K1's f32 instantiation, T1): 3xTF32 on
//     m16n8k8, a = hi + lo with hi = cvt.rna.tf32(a), lo = cvt.rna.tf32(a -
//     hi), and <a, b> = sum lo*hi + hi*lo + hi*hi. hi and lo keep 11
//     significant bits each, so a - hi - lo is within 2^-22 |a| and the
//     dropped lo*lo within 2^-22 |a b|: per term about 2^-21 |a b|, which on
//     unit-norm rows (sum |a b| <= 1) bounds the product's error by about
//     5e-7 beside the f32 sums' own rounding. Each k step's three products
//     are summed from zero and then added into the f32 accumulator: the
//     tensor cores do not round their sums to nearest, and an accumulator
//     carried across the steps drifted with C. One TF32 pass (2^-11 per
//     term) is never used: tests/test_torch_knn_split.py shows it off by
//     more than 1e-5, and the selection must stay at f32 accuracy, since
//     phases 3 and 4 of chip_smoke.py allow 1e-4 near ties only.
// The square sums accumulate in f32 FMAs from the coordinate-dtype values,
// never in the split, and query and candidate rows go through one routine
// (row_sq): rows with equal values get equal square sums and equal
// products whatever their place in an mma tile, so duplicate candidates
// tie bit for bit and the lowest index wins. CT has large constant regions
// whose feature rows are identical.
//
// Design. A Pallas block keeps all M candidates in VMEM; an SM's 227 KB
// holds a tile of queries and a few slabs of candidates:
//   - streamed mode: one CTA per (query tile of TQ = 64, 32 or 16 rows,
//     graph b), the B graphs of one tile next to each other so that the
//     bias rows they share are read from L2. The query tile is staged once
//     (cp.async) with its square sums; the candidates come in chunks of TM
//     = 64 rows, each chunk in slabs of 288 bytes of every row (two slabs
//     at C = 264 in bf16, 9 k steps of the product between barriers),
//     through a ring of STAGES = 3 slots of cp.async copies (16 bytes where
//     the rows' alignment allows, else 8, 4, or plain 2-byte loads for odd
//     bf16 C): the copies of the next two slabs overlap this slab's product
//     and the chunk's top-k. (128-byte slabs in 4 slots, and 8 slots, were
//     slower on an H100: more barriers per chunk, and one CTA per SM);
//   - window mode (a self-graph with N = M <= 192 and at least one graph
//     per SM: the Swin windows): one CTA per window stages its rows once
//     and runs every query tile of 32 rows against every chunk from there
//     (32 rows keep the f32 s2 windows at two CTAs per SM);
//   - small grids (the s4/s5 self-graphs, fewer than two CTAs per SM at 64
//     rows) split the query rows finer: 32, else 16 rows per CTA;
//   - C is padded with zeros in shared memory to the 32-byte k step (16
//     bf16, 8 f32); staged rows are 16 bytes longer than that, so the eight
//     rows of an ldmatrix fall on distinct banks;
//   - 8 warps: warp w computes a 16 x 8*TQ/16 block of the TQ x 64 chunk of
//     distances (A and B fragments by ldmatrix), writes it to shared
//     memory, then owns TQ/8 query rows of the running top-k, reading the
//     bias row-wise (coalesced) as it reads the chunk;
//   - the running top-k is spread over a warp's lanes (lane j holds the
//     j-th nearest). Candidates are offered in increasing index order; one
//     is inserted only when strictly nearer than the current k-th, after
//     every entry that is not farther. That keeps the order by (distance,
//     index): the TPU kernels' k rounds of first-occurrence argmin select
//     the same set in the same order.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "mma_bf16.cuh"

namespace knn {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TM = 64;           // candidates per chunk
constexpr int KSTEP_B = 32;      // bytes of a row per mma k step: 16 bf16 or 8 f32
constexpr int SLAB_B = 288;      // bytes of a row per ring slot
constexpr int STAGES = 3;        // ring slots
constexpr int ROW_PAD_B = 16;    // staged rows are this much longer than their data
constexpr int SLOT_LD = SLAB_B + ROW_PAD_B;
constexpr int DIST_LD = TM + 4;  // row stride (floats) of the chunk's distances
constexpr int WIN_MAX = 192;     // the largest self-graph one CTA stages whole
constexpr int WIN_TQ = 32;       // query rows per tile in window mode
constexpr int KMAX = 32;         // the running top-k lives in one warp's lanes
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// --- what a launch runs: the plan ----------------------------------------------------

// Bytes of a staged row: the data padded to the k step, plus ROW_PAD_B.
__host__ __device__ inline int row_ld(int C, int elem) {
  return (C * elem + KSTEP_B - 1) / KSTEP_B * KSTEP_B + ROW_PAD_B;
}

inline size_t smem_bytes(int tq, bool window, int C, int elem, int M) {
  const size_t ld = row_ld(C, elem), dist = (size_t)tq * DIST_LD * sizeof(float);
  if (window) {
    const size_t rows = (size_t)(M + 15) / 16 * 16;
    return rows * ld + dist + rows * sizeof(float);
  }
  return tq * ld + (size_t)STAGES * TM * SLOT_LD + dist + (tq + TM) * sizeof(float);
}

struct Plan {
  int tq;       // query rows per tile
  int window;   // 1: one CTA per self-graph, staged whole
  int grid;     // CTAs
  int smem;     // dynamic shared memory per CTA, bytes
  int vec;      // bytes per copy of a staged row: 16, 8, 4 (cp.async) or 2
};

// Arguments every forward entry point refuses.
inline bool bad_shape(int B, int N, int M, int C, int k) {
  return B < 1 || N < 1 || M < 1 || C < 1 || k < 1 || k > KMAX || k > M ||
         (long long)B * ((N + 15) / 16) > 0x7fffffffLL;
}

// What a plan needs of the current device: SMs, shared memory per SM and
// per block. Read once per device.
struct Device {
  int sms, per_sm, per_block;
};

inline Device current_device() {
  static Device known[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  Device d = dev < 64 ? known[dev] : Device{};
  if (d.sms == 0) {
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&d.per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    cudaDeviceGetAttribute(&d.per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (dev < 64) known[dev] = d;
  }
  return d;
}

// The plan of a launch on the current device. Returns false where no tile
// fits in shared memory.
inline bool make_plan(int B, int N, int M, int C, int elem, bool self_graph, const void* x,
                      const void* y, Plan& p) {
  const auto [sms, per_sm, per_block] = current_device();
  const int row_bytes = C * elem;
  p.vec = 16;
  while (p.vec > 2 && (row_bytes % p.vec || (uintptr_t)x % p.vec || (uintptr_t)y % p.vec)) {
    p.vec /= 2;
  }
  // window mode: a self-graph small enough to stage whole, and enough of
  // them to give every SM one
  if (self_graph && N == M && M <= WIN_MAX && B >= sms) {
    const size_t s = smem_bytes(WIN_TQ, true, C, elem, M);
    if (s <= (size_t)per_block) {
      p = {WIN_TQ, 1, B, (int)s, p.vec};
      return true;
    }
  }
  // streamed: the widest tile that gives two CTAs per SM, two of them on
  // each SM at once; else 16 rows
  for (int tq : {64, 32}) {
    const size_t s = smem_bytes(tq, false, C, elem, M);
    const long long ctas = (long long)B * ((N + tq - 1) / tq);
    if (ctas >= 2LL * sms && 2 * (s + 1024) <= (size_t)per_sm) {
      p = {tq, 0, (int)ctas, (int)s, p.vec};
      return true;
    }
  }
  const size_t s = smem_bytes(16, false, C, elem, M);
  p = {16, 0, B * ((N + 15) / 16), (int)s, p.vec};
  return s <= (size_t)per_block;
}

// Calls f(integral_constant<int, TQ>, bool_constant<WINDOW>) with the
// plan's instantiation.
template <typename F>
cudaError_t with_plan(const Plan& p, F&& f) {
  if (p.window) return f(std::integral_constant<int, WIN_TQ>{}, std::true_type{});
  switch (p.tq) {
    case 64: return f(std::integral_constant<int, 64>{}, std::false_type{});
    case 32: return f(std::integral_constant<int, 32>{}, std::false_type{});
    default: return f(std::integral_constant<int, 16>{}, std::false_type{});
  }
}

// Sets the kernel's shared memory and launches it with the plan.
template <typename Kernel, typename... Ts>
cudaError_t launch_planned(Kernel kernel, const Plan& p, cudaStream_t stream, Ts... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (e != cudaSuccess) return e;
  kernel<<<p.grid, THREADS, p.smem, stream>>>(args...);
  return cudaGetLastError();
}

// The plan and the kernel's residency, for the report: {TQ, window, CTAs,
// shared memory bytes, CTAs resident per SM}.
template <typename Kernel>
void report_plan(Kernel kernel, const Plan& p, int* out) {
  int per_sm = 0;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, p.smem);
  out[0] = p.tq;
  out[1] = p.window;
  out[2] = p.grid;
  out[3] = p.smem;
  out[4] = per_sm;
}

struct Args {
  const void* x;     // (B, N, C) query coordinates
  const void* y;     // (B, M, C) candidate coordinates
  const float* rel;  // (N, M) bias or NULL
  int B, N, M, C, k;
  int vec;           // Plan::vec
};

// --- copies, fragments, products -----------------------------------------------------

__device__ __forceinline__ void copy_piece(unsigned char* dst, const unsigned char* src, int vec) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (vec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else if (vec == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  } else if (vec == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  } else {  // odd C in bf16: rows are 2-byte aligned only
    *(unsigned short*)dst = *(const unsigned short*)src;
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A thread's share of the copies that stage a block of rows: pieces of vec
// bytes, `pieces` to a row, piece tid + j * THREADS for j = 0, 1, ...; its
// row and piece advance by (dr, dp) from (r, p), so no copy divides.
struct Share {
  int r, p, dr, dp, pieces;
  __device__ explicit Share(int pieces)
      : r(threadIdx.x / pieces), p(threadIdx.x % pieces), dr(THREADS / pieces),
        dp(THREADS % pieces), pieces(pieces) {}
};

// Bytes [0, bytes) of `rows` rows of src (stride src_ld) to dst (stride
// dst_ld): the thread's share of the copies.
__device__ __forceinline__ void stage(unsigned char* dst, int dst_ld, const unsigned char* src,
                                      size_t src_ld, int rows, int bytes, int vec,
                                      const Share& c) {
  for (int r = c.r, p = c.p; r < rows;) {
    if (p * vec < bytes) copy_piece(dst + r * dst_ld + p * vec, src + r * src_ld + p * vec, vec);
    r += c.dr;
    p += c.dp;
    if (p >= c.pieces) p -= c.pieces, ++r;
  }
}

// Zeros bytes [from, to) of `rows` staged rows (the pad to the k step).
__device__ __forceinline__ void zero_cols(unsigned char* dst, int dst_ld, int rows, int from,
                                          int to) {
  const int per_row = (to - from) / 2;
  for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
    const int r = i / per_row, p = i - r * per_row;
    *(unsigned short*)(dst + r * dst_ld + from + 2 * p) = 0;
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(unsigned& r0, unsigned& r1, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ unsigned tf32_rna(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo (+ at most 2^-22 |v|), both TF32.
__device__ __forceinline__ void split_tf32(unsigned v, unsigned& hi, unsigned& lo) {
  const float f = __uint_as_float(v);
  hi = tf32_rna(f);
  lo = tf32_rna(f - __uint_as_float(hi));
}

// d += a (16 x 8, row-major) * b (8 x 8, column-major), TF32 in, f32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[j] += A (the warp's 16 query rows) * B (its NT * 8 candidate rows)^T
// over `ksteps` k steps of 32 bytes. a_row and b_row are the shared
// addresses of the first row of each at the first k step; rows are a_ld and
// b_ld bytes apart. ldmatrix serves both types: an 8 x 8 b16 matrix is 8
// rows of 16 bytes, which is 8 x 4 f32 as the TF32 fragments take them.
template <typename T, int NT>
__device__ __forceinline__ void mma_span(float (&acc)[NT][4], unsigned a_row, int a_ld,
                                         unsigned b_row, int b_ld, int ksteps) {
  const int lane = threadIdx.x & 31;
  // A, x4: matrices (rows 0-7, bytes 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31)
  const unsigned a_addr = a_row + ((lane & 7) + ((lane >> 3) & 1) * 8) * a_ld + (lane >> 4) * 16;
  // B, x4 per two n8 tiles: (rows 0-7, 0-15), (0-7, 16-31), (8-15, 0-15), (8-15, 16-31);
  // x2 for one: lanes 0-15 give the addresses
  const unsigned b_addr = NT >= 2
      ? b_row + ((lane & 7) + (lane >> 4) * 8) * b_ld + ((lane >> 3) & 1) * 16
      : b_row + (lane & 7) * b_ld + ((lane >> 3) & 1) * 16;
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ++ks) {
    unsigned a[4], b[NT][2];
    ldsm_x4(a, a_addr + ks * KSTEP_B);
    if constexpr (NT >= 2) {
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        unsigned r[4];
        ldsm_x4(r, b_addr + p * 16 * b_ld + ks * KSTEP_B);
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
    } else {
      ldsm_x2(b[0][0], b[0][1], b_addr + ks * KSTEP_B);
    }
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_bf16(acc[j], a, b[j][0], b[j][1]);
    } else {
      // the step's three products summed from zero, then one f32 add into
      // acc: the tensor cores do not round their sums to nearest, and
      // carried over every step their error grows with C (a row's own
      // distance came out 1e-5 off at C = 264)
      unsigned ahi[4], alo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(a[i], ahi[i], alo[i]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        unsigned bhi0, blo0, bhi1, blo1;
        split_tf32(b[j][0], bhi0, blo0);
        split_tf32(b[j][1], bhi1, blo1);
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        // the small terms first
        mma_tf32(t, alo, bhi0, bhi1);
        mma_tf32(t, ahi, blo0, blo1);
        mma_tf32(t, ahi, bhi0, bhi1);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] += t[i];
      }
    }
  }
}

// The square-sum routine of every row, query or candidate: channels in
// groups of four, group g to thread g % 4 of the row's quad, each thread's
// groups in increasing order, f32 FMAs from the coordinate-dtype values. A
// thread adds the groups of bytes [0, bytes) of one staged row to s; a
// slab-by-slab call gives the same sum as one call over the row, since a
// slab holds a multiple of four groups. quad_sum joins the quad's four.
template <typename T>
__device__ __forceinline__ float row_sq(const unsigned char* row, int bytes, int q, float s) {
  constexpr int GB = 4 * (int)sizeof(T);
  for (int g = q; g * GB < bytes; g += 4) {
    float v[4];
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      const uint2 w = *(const uint2*)(row + g * GB);
      const __nv_bfloat162 lo = *(const __nv_bfloat162*)&w.x, hi = *(const __nv_bfloat162*)&w.y;
      v[0] = __low2float(lo);
      v[1] = __high2float(lo);
      v[2] = __low2float(hi);
      v[3] = __high2float(hi);
    } else {
      const float4 w = *(const float4*)(row + g * GB);
      v[0] = w.x;
      v[1] = w.y;
      v[2] = w.z;
      v[3] = w.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) s = fmaf(v[i], v[i], s);
  }
  return s;
}

// (s0 + s1) + (s2 + s3) over the quad; the same bits in its four lanes.
__device__ __forceinline__ float quad_sum(float s) {
  s = s + __shfl_xor_sync(FULL, s, 1);
  return s + __shfl_xor_sync(FULL, s, 2);
}

// --- the chunk: distances, bias, running top-k -------------------------------------

// The warp's block of the chunk's distances to shared memory:
// (xsq[r] - 2 acc) + ysq[c], r and c within the chunk.
template <int TQ>
__device__ __forceinline__ void write_dist(const float (&acc)[TQ / 16][4], const float* xsq,
                                           const float* ysq, float* dist) {
  constexpr int WM = TQ / 16, NT = WM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = (warp % WM) * 16 + (lane >> 2);
  const float x0 = xsq[r], x1 = xsq[r + 8];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = (warp / WM) * NT * 8 + 8 * j + 2 * (lane & 3);
    const float y0 = ysq[c], y1 = ysq[c + 1];
    *(float2*)&dist[r * DIST_LD + c] =
        make_float2((x0 - 2.f * acc[j][0]) + y0, (x0 - 2.f * acc[j][1]) + y1);
    *(float2*)&dist[(r + 8) * DIST_LD + c] =
        make_float2((x1 - 2.f * acc[j][2]) + y0, (x1 - 2.f * acc[j][3]) + y1);
  }
}

// The bias of the warp's rows at the chunk's candidates, lane by lane
// (coalesced: one row's 32 consecutive floats per load); 0 without a bias.
template <int RPW>
__device__ __forceinline__ void load_rel(float (&rv)[RPW][TM / 32], const Args& a, int n_first,
                                         int m0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
#pragma unroll
    for (int g = 0; g < TM / 32; ++g) {
      const int n = n_first + rr, m = m0 + 32 * g + lane;
      rv[rr][g] = (a.rel != nullptr && n < a.N && m < a.M) ? __ldg(a.rel + (size_t)n * a.M + m)
                                                            : 0.f;
    }
  }
}

// Offers the chunk's candidates m0 + [0, TM) to the running top-k of the
// warp's rows (query rows n_first + rr of the tile's rows r_first + rr).
// With INSERT false each lane keeps only the least distance it saw.
template <int RPW, bool INSERT>
__device__ __forceinline__ void topk_chunk(const float* dist, const float (&rv)[RPW][TM / 32],
                                           int r_first, int n_first, int N, int M, int m0, int k,
                                           float (&topd)[RPW], int (&topi)[RPW]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    if (n_first + rr >= N) continue;  // warp-uniform
#pragma unroll
    for (int g = 0; g < TM / 32; ++g) {
      const int m = m0 + 32 * g + lane;
      // padding never selected
      const float dl =
          m < M ? dist[(r_first + rr) * DIST_LD + 32 * g + lane] + rv[rr][g] : INFINITY;
      if (!INSERT) {
        topd[rr] = fminf(topd[rr], dl);
        continue;
      }
      float worst = __shfl_sync(FULL, topd[rr], k - 1);
      unsigned pass = __ballot_sync(FULL, dl < worst);
      while (pass) {  // lowest lane (= lowest index) first
        const int src = __ffs(pass) - 1;
        const float d = __shfl_sync(FULL, dl, src);
        // entries not farther than d stay ahead of it
        const int pos = __popc(__ballot_sync(FULL, lane < k && topd[rr] <= d));
        const float pd = __shfl_up_sync(FULL, topd[rr], 1);
        const int pi = __shfl_up_sync(FULL, topi[rr], 1);
        if (lane > pos) {
          topd[rr] = pd;
          topi[rr] = pi;
        } else if (lane == pos) {
          topd[rr] = d;
          topi[rr] = m0 + 32 * g + src;
        }
        worst = __shfl_sync(FULL, topd[rr], k - 1);
        pass &= ~((2u << src) - 1u);  // drop lanes <= src
        pass &= __ballot_sync(FULL, dl < worst);
      }
    }
  }
}

// --- the two modes ----------------------------------------------------------------------

// Every thread of the CTA calls this; dynamic shared memory of
// smem_bytes(TQ, WINDOW, ...). For each query row n of the CTA's graph b,
// its warp calls emit(b, n, topd, topi) with lane j < k holding the j-th
// nearest candidate's distance in topd and index in topi. With INSERT
// false (the dissection tool's modes that take the running top-k out) the
// distances are computed all the same and each lane holds only the least
// of those it saw, in topd; topi is 0.
template <typename T, int TQ, bool WINDOW, bool INSERT, typename Emit>
__device__ __forceinline__ void select_rows(const Args& a, unsigned char* smem, const Emit& emit) {
  constexpr int SZ = sizeof(T), WM = TQ / 16, NT = WM, RPW = TQ / WARPS;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int row_b = a.C * SZ;
  const int ld = row_ld(a.C, SZ), cp_b = ld - ROW_PAD_B;
  const int chunks = (a.M + TM - 1) / TM;
  // the warp's block of the product and its rows of the top-k
  const int wr = (warp % WM) * 16, wc = (warp / WM) * NT * 8, r_first = warp * RPW;
  const unsigned base = (unsigned)__cvta_generic_to_shared(smem);

  float topd[RPW], rv[RPW][TM / 32], acc[NT][4];
  int topi[RPW];
  auto reset_topk = [&] {
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      topd[r] = INFINITY;
      topi[r] = 0;
    }
  };
  auto zero_acc = [&] {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  };
  auto emit_rows = [&](int b, int n0) {
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int n = n0 + r_first + rr;
      if (n < a.N) emit(b, n, topd[rr], topi[rr]);  // warp-uniform
    }
  };

  if constexpr (WINDOW) {
    // one self-graph per CTA: its rows staged once, queries and candidates
    // (rows rounded up to 16: a warp whose 16 rows or 16 columns lie past
    // them skips the product, and its distances are never read)
    const int b = blockIdx.x;
    const int rows = (a.M + 15) / 16 * 16;
    float* dist = (float*)(smem + (size_t)rows * ld);
    float* sq = dist + TQ * DIST_LD;
    stage(smem, ld, (const unsigned char*)a.x + (size_t)b * a.M * row_b, row_b, a.M, row_b, a.vec,
          Share(row_b / a.vec));
    if (cp_b > row_b) zero_cols(smem, ld, rows, row_b, cp_b);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    for (int i = tid; i < rows * 4; i += THREADS) {  // rows * 4: whole warps
      const float s = quad_sum(row_sq<T>(smem + (i >> 2) * ld, cp_b, i & 3, 0.f));
      if ((i & 3) == 0) sq[i >> 2] = s;
    }
    __syncthreads();
    for (int n0 = 0; n0 < a.N; n0 += TQ) {
      reset_topk();
      for (int m0 = 0; m0 < a.M; m0 += TM) {
        load_rel<RPW>(rv, a, n0 + r_first, m0);
        zero_acc();
        if (n0 + wr < rows && m0 + wc < rows) {
          mma_span<T, NT>(acc, base + (n0 + wr) * ld, ld, base + (m0 + wc) * ld, ld,
                          cp_b / KSTEP_B);
        }
        write_dist<TQ>(acc, sq + n0, sq + m0, dist);
        __syncthreads();
        topk_chunk<RPW, INSERT>(dist, rv, r_first, n0 + r_first, a.N, a.M, m0, a.k, topd, topi);
        __syncthreads();  // dist is rewritten by the next chunk
      }
      emit_rows(b, n0);
    }
  } else {
    // one query tile per CTA, the graphs of one tile next to each other
    const int b = blockIdx.x % a.B, n0 = blockIdx.x / a.B * TQ;
    unsigned char* ring = smem + TQ * ld;
    float* dist = (float*)(ring + STAGES * TM * SLOT_LD);
    float* xsq = dist + TQ * DIST_LD;
    float* ysq = xsq + TQ;
    const unsigned char* yg = (const unsigned char*)a.y + (size_t)b * a.M * row_b;
    const int slabs = (cp_b + SLAB_B - 1) / SLAB_B;
    const Share slab_share(SLAB_B / a.vec);

    stage(smem, ld, (const unsigned char*)a.x + ((size_t)b * a.N + n0) * row_b, row_b,
          min(TQ, a.N - n0), row_b, a.vec, Share(row_b / a.vec));
    if (cp_b > row_b) zero_cols(smem, ld, TQ, row_b, cp_b);
    cp_commit();
    // the slabs in order: chunk by chunk, each chunk's rows SLAB_B bytes at
    // a time, slab j to slot j % STAGES; one commit group per slab, empty
    // ones past the last
    int in_chunk = 0, in_slab = 0, in_slot = 0;  // the next slab to fetch
    auto fetch = [&] {
      if (in_chunk < chunks) {
        const int byte0 = in_slab * SLAB_B;
        const int width = min(SLAB_B, cp_b - byte0), real = min(width, row_b - byte0);
        unsigned char* slot = ring + in_slot * TM * SLOT_LD;
        stage(slot, SLOT_LD, yg + (size_t)in_chunk * TM * row_b + byte0, row_b,
              min(TM, a.M - in_chunk * TM), real, a.vec, slab_share);
        if (real < width) zero_cols(slot, SLOT_LD, TM, real, width);
        if (++in_slab == slabs) in_slab = 0, ++in_chunk;
        if (++in_slot == STAGES) in_slot = 0;
      }
      cp_commit();
    };
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) fetch();
    cp_wait<STAGES - 1>();  // the query tile is in
    __syncthreads();
    if (tid < TQ * 4) {  // whole warps
      const float s = quad_sum(row_sq<T>(smem + (tid >> 2) * ld, cp_b, tid & 3, 0.f));
      if ((tid & 3) == 0) xsq[tid >> 2] = s;
    }
    reset_topk();
    float ysq_part = 0.f;  // candidate tid / 4's square sum, by quarters
    int slot_i = 0;
    for (int m0 = 0; m0 < a.M; m0 += TM) {
      zero_acc();
      ysq_part = 0.f;
      for (int s = 0; s < slabs; ++s) {
        cp_wait<STAGES - 2>();
        __syncthreads();  // this slab is in; the slot before it is free
        fetch();
        const unsigned char* slot = ring + slot_i * TM * SLOT_LD;
        if (++slot_i == STAGES) slot_i = 0;
        const int width = min(SLAB_B, cp_b - s * SLAB_B);
        if (s == slabs - 1) load_rel<RPW>(rv, a, n0 + r_first, m0);
        mma_span<T, NT>(acc, base + wr * ld + s * SLAB_B, ld,
                        base + (unsigned)(slot - smem) + wc * SLOT_LD, SLOT_LD, width / KSTEP_B);
        ysq_part = row_sq<T>(slot + (tid >> 2) * SLOT_LD, width, tid & 3, ysq_part);
      }
      // the chunk's distances, then its top-k
      const float sq = quad_sum(ysq_part);
      if ((tid & 3) == 0) ysq[tid >> 2] = sq;
      __syncthreads();
      write_dist<TQ>(acc, xsq, ysq, dist);
      __syncthreads();
      topk_chunk<RPW, INSERT>(dist, rv, r_first, n0 + r_first, a.N, a.M, m0, a.k, topd, topi);
    }
    cp_wait<0>();
    emit_rows(b, n0);
  }
}

// --- the gather ---------------------------------------------------------------------------

// One warp: the per-channel max over the k rows of vb that the lanes' topi
// name, written to orow (C floats). The rows are read by index, so the
// gather is exact. Where C is even (and vb and orow aligned), a lane reads
// two channels at once (4 bytes of bf16, 8 of f32), and up to GATHER_PASSES
// pairs of a row (C <= 384) for eight winners at a time, so that all those
// loads are in flight together.
constexpr int GATHER_PASSES = 6;

template <typename TV>
__device__ __forceinline__ void gather_max(const TV* __restrict__ vb, int topi, int k, int C,
                                           float* __restrict__ orow) {
  const int lane = threadIdx.x & 31;
  if ((C & 1) == 0 && C <= 64 * GATHER_PASSES && (uintptr_t)vb % (2 * sizeof(TV)) == 0 &&
      (uintptr_t)orow % 8 == 0) {
    float mx[GATHER_PASSES][2];
#pragma unroll
    for (int p = 0; p < GATHER_PASSES; ++p) mx[p][0] = mx[p][1] = -INFINITY;
    for (int j0 = 0; j0 < k; j0 += 8) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int m = __shfl_sync(FULL, topi, (j0 + jj) & 31);
        if (j0 + jj >= k) break;  // warp-uniform
#pragma unroll
        for (int p = 0; p < GATHER_PASSES; ++p) {
          const int c = 64 * p + 2 * lane;
          if (c < C) {
            if constexpr (std::is_same<TV, __nv_bfloat16>::value) {
              const __nv_bfloat162 v = *(const __nv_bfloat162*)(vb + (size_t)m * C + c);
              mx[p][0] = fmaxf(mx[p][0], __low2float(v));
              mx[p][1] = fmaxf(mx[p][1], __high2float(v));
            } else {
              const float2 v = *(const float2*)(vb + (size_t)m * C + c);
              mx[p][0] = fmaxf(mx[p][0], v.x);
              mx[p][1] = fmaxf(mx[p][1], v.y);
            }
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < GATHER_PASSES; ++p) {
      const int c = 64 * p + 2 * lane;
      if (c < C) *(float2*)(orow + c) = make_float2(mx[p][0], mx[p][1]);
    }
    return;
  }
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    float mx = -INFINITY;
    for (int j = 0; j < k; ++j) {
      const int m = __shfl_sync(FULL, topi, j);
      if (c < C) mx = fmaxf(mx, to_f32(vb[(size_t)m * C + c]));
    }
    if (c < C) orow[c] = mx;
  }
}

}  // namespace knn
