// The Hopper core of the two bf16 conv kernels, K5 (conv3d.cu, NCDHW) and
// T3 (conv_cl.cu, NDHWC): one implicit GEMM on wgmma with a staging ring.
//
// Replaces, with conv3d.cu and conv_cl.cu, the Pallas TPU kernels
// nextou_tpu/kernels/conv.py::_kernel (conv_cf_flat) and
// tools/exp_conv_kernel.py::_conv_kernel / ::_csub_kernel (pallas_conv,
// csub_conv). Semantics are the callers': symmetric padding (k - 1) / 2,
// kernel dims in {1, 3}, strides in {1, 2}, the f32 sum rounded once to bf16,
// no bias.
//
// What bounds it: operations. The flagship convs do 0.4-3 TFLOP per call
// against well under 1 GB moved (2 B S_out taps C Co against the bytes of x,
// w and out), so the tensor cores' 989 TFLOP/s set the floor, not the
// memory's 3.35 TB/s. The design feeds wgmma from a ring that the halo's
// staging keeps ahead of it:
//
// - The GEMM. M is output positions: a block of th rows x tw columns of one
//   (batch, output depth), 128 rows, 64 for each of two consumer warpgroups.
//   N is output channels: one tile as wide as Co rounded up to 8, from the
//   instantiated widths N_WIDTHS (the flagship's and T3's CASES' Co = 33,
//   66, 132 and 324 / 2); a wider Co takes tiles of equal width. K is (tap,
//   input channel) in granules of 8 channels (16 bytes, one ldmatrix row):
//   a k16 step takes two granules, which may belong to two taps, so C pads
//   to a multiple of 8 only (33 -> 40, 66 -> 72, 132 -> 136). For C of at
//   most 32 the plan prefers one chunk padded to 16 channels a tap, so that
//   each k16 step holds one tap's channels as the library conv's steps do:
//   the f32 sums then round alike, bit for bit at the flagship's narrow
//   widths (c_pad_for).
// - wgmma.mma_async m64nNk16, f32 sums, A from registers, B from shared
//   memory by descriptor. Each warp loads its 16 rows of A with
//   ldmatrix.x4, one address per lane: the halo position of its output row
//   at the granule's tap, from a table of the chunk's granule slots. A
//   stride, a narrow plane (Wo = 12) or a ragged block is then an address
//   and not a layout. A warpgroup issues G steps back to back (7; 1 at N =
//   168, for registers) and waits for them together, while the other
//   warpgroup's group runs. Every wgmma sits on a path all threads take: a
//   group past a chunk's last step multiplies zero A by the chunk's first B.
// - The ring. The input channels go by in chunks of cs channels. A stage
//   holds one chunk: its weights for every tap ([granule][N][8] bf16, the
//   canonical K-major layout without swizzle: core matrices of 8 output
//   channels x 16 bytes, LBO = N x 16 bytes between the two granules of a k
//   step, SBO = 128 bytes between groups of 8 channels) and the input halo
//   the block's taps reach ([position][cs] bf16, zero outside x). Two
//   producer warpgroups take the chunks in turn, so that two are staged at
//   once: the weights, packed once per launch in that order, by one
//   cp.async.bulk on the stage's full mbarrier; the halo in a route that the
//   layout and the shape choose (conv3d.cu, conv_cl.cu). Consumers release
//   a stage on its empty mbarrier when its last group has retired.
// - Persistent CTAs, one per SM: a CTA walks its blocks, and the ring runs
//   on across them, so the next block's chunks are staged while a block's
//   epilogue is written. The epilogue rounds the sums to bf16 into a tile of
//   its own in shared memory and writes it along the output's contiguous
//   axis: W for K5's NCDHW, Co for T3's NDHWC, 16 bytes a store where the
//   extents allow it.
// - Bank conflicts. A position's granules are swizzled (granule g of
//   position p sits at g ^ f(p)) so that 8 consecutive positions fall on 8
//   distinct 16-byte bank groups whatever cs is; at column stride 2 the
//   halo's columns are stored even ones first, so that the positions an
//   ldmatrix reads are consecutive there too (else 32 bytes apart).
// - The plan (conv_sm90_plan, mirrored in kernels/conv.py) picks the N
//   tiles, the block (tw = min(Wo, 32), th = min(128 / tw, Ho)) and the
//   chunk among cs in {64, 32, 16, 8} that C needs: for C <= 32 one chunk of
//   16 channels a tap, else the largest cs that leaves room for three stages
//   beside the epilogue's tile in 227 KB, else for two. Where no chunk
//   leaves room for two (wide N at column stride 2, or a narrow C with wide
//   N), the block loses rows until one does; at th = 1 a chunk of 8 always
//   does, so every shape of kernel dims {1, 3} has a plan. K is not split
//   across CTAs.
//
// 512 threads: two consumer warpgroups, two producer warpgroups; the
// register limit of 128 a thread holds the widest accumulator (84 floats at
// N = 168) and a group's A fragments without spills. What holds it back
// (PERF.md): the halo's staging beside the products (a third of the time at
// stride 2) and the consumers' loop at N = 72, whose A and B reads use most
// of the shared memory's bandwidth per product.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace sm90 {

constexpr int CONSUMER_WARPS = 8;  // two warpgroups of 64 output positions
constexpr int PRODUCER_THREADS = 256;  // two warpgroups, taking chunks in turn
constexpr int STAGERS = 128;           // the threads that stage one chunk
constexpr int PRODUCER_BATCH = 4;       // halo granules a producer thread has in flight
constexpr int THREADS = CONSUMER_WARPS * 32 + PRODUCER_THREADS;
constexpr int TM = 128;            // output positions per CTA
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;  // 227 KB, a block's dynamic shared memory
constexpr int QMAX = 216;  // granule slots of a chunk: 2 ceil(27 taps x 8 granules / 2)
// barriers (2 x MAX_STAGES x 8 bytes), a zero granule, the granule tables
// (a full and the last chunk's, QMAX ints each)
constexpr int RESERVED = 2048;
constexpr int N_WIDTHS[4] = {40, 72, 136, 168};
constexpr int N_MAX = 168;
constexpr int CS_CHOICES[4] = {64, 32, 16, 8};
constexpr int PLAN_INTS = 14;

enum Layout { NCDHW = 0, NDHWC = 1 };
enum Route { ROUTE_REGS = 0, ROUTE_CP16 = 1, ROUTE_CP4 = 2, ROUTE_VEC = 3 };

// Everything a launch needs, from the shape and the plan.
struct Geom {
  int B, C, D, H, W, Co, Do, Ho, Wo;
  int kd, kh, kw, sd, sh, sw, taps;
  int th, tw, n_ht, n_wt;              // the M block and the blocks per plane
  int in_rows, in_cols, cols_phys;     // the halo: rows, columns, stored columns
  int cs, gpp, chunks, stages;         // channels per chunk, granules per position
  int swz_shift;                       // the granule swizzle: 3 - log2(gpp)
  int q2_full, q2_last, gpc_last;      // granule slots (even) of a full and the last chunk
  int w_stage, h_stage, stage;         // bytes of a stage's weights, halo, both (128-aligned)
  int n, n_tiles, route;
  int tile_bytes;                      // packed weights per N tile
  int epilogue;                        // bytes of the epilogue's bf16 tile (128-aligned)
};

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
inline int align128(int v) { return (v + 127) & ~127; }

// C padded for chunks of cs channels: to a granule (8), but to 16 where C <=
// 32 and a chunk holds 16 or more, so that each k16 step takes one tap's 16
// channels, as the library conv's steps do: the f32 sums of a narrow conv
// then round alike.
inline int c_pad_for(int C, int cs) {
  return C <= 32 && cs >= 16 ? ceil_div(C, 16) * 16 : ceil_div(C, 8) * 8;
}

// The plan for one conv. Fills g and out[PLAN_INTS] = {th, tw, n, n_tiles,
// granules, cs, stages, splits, route, chunks, ctas, smem, k_steps,
// scratch}; false where the shape has no plan. ctas counts the output
// blocks; the launch runs min(ctas, SMs) persistent CTAs that walk them.
inline bool conv_sm90_plan(int layout, int B, int C, int D, int H, int W, int Co, int kd, int kh,
                           int kw, int sd, int sh, int sw, Geom& g, int* out) {
  g.B = B, g.C = C, g.D = D, g.H = H, g.W = W, g.Co = Co;
  g.kd = kd, g.kh = kh, g.kw = kw, g.sd = sd, g.sh = sh, g.sw = sw;
  g.taps = kd * kh * kw;
  if (layout == NCDHW) {
    g.Do = (D + 2 * ((kd - 1) / 2) - kd) / sd + 1;
    g.Ho = (H + 2 * ((kh - 1) / 2) - kh) / sh + 1;
    g.Wo = (W + 2 * ((kw - 1) / 2) - kw) / sw + 1;
  } else {
    g.Do = D / sd, g.Ho = H / sh, g.Wo = W / sw;
  }
  if (g.Do < 1 || g.Ho < 1 || g.Wo < 1) return false;
  // N: one tile as wide as Co up to N_MAX, else tiles of equal width
  g.n_tiles = ceil_div(Co, N_MAX);
  const int need = ceil_div(ceil_div(Co, g.n_tiles), 8) * 8;
  g.n = 0;
  for (int w : N_WIDTHS)
    if (g.n == 0 && w >= need) g.n = w;
  g.epilogue = align128(layout == NCDHW ? g.n * (TM + 8) * 2 : TM * (g.n + 8) * 2);
  // The block and the chunk: the largest block (th rows, from min(TM / tw,
  // Ho) down) at which some chunk leaves room for a ring of two stages; at
  // it, first one chunk of 16 channels a tap where C <= 32 (c_pad_for), then
  // the largest chunk with room for three stages, then the largest with
  // room for two.
  g.tw = g.Wo < 32 ? g.Wo : 32;
  int pick = 0, fit_pick = 0, rank_pick = 4, c_pad = 0, n_pos = 0;
  for (g.th = TM / g.tw < g.Ho ? TM / g.tw : g.Ho; g.th >= 1; --g.th) {
    g.in_rows = (g.th - 1) * sh + kh;
    g.in_cols = (g.tw - 1) * sw + kw;
    g.cols_phys = sw == 1 ? g.in_cols : 2 * ceil_div(g.in_cols, 2);
    n_pos = kd * g.in_rows * g.cols_phys;
    for (int cs : CS_CHOICES) {
      const int cp = c_pad_for(C, cs);
      if (cs > 8 && cs / 2 >= cp) continue;
      const int q2 = 2 * ceil_div(g.taps * (cs / 8), 2);
      const int stage = align128(q2 * g.n * 16) + align128(n_pos * cs * 2);
      int fit = (SMEM_LIMIT - RESERVED - g.epilogue) / stage;
      if (fit > MAX_STAGES) fit = MAX_STAGES;
      const int rank = (C <= 32 && cs == cp && cs >= 16 ? 0 : 2) + (fit >= 3 ? 0 : 1);
      if (fit >= 2 && rank < rank_pick) pick = cs, fit_pick = fit, rank_pick = rank, c_pad = cp;
    }
    if (pick != 0) break;
  }
  if (pick == 0) return false;
  g.n_wt = ceil_div(g.Wo, g.tw);
  g.n_ht = ceil_div(g.Ho, g.th);
  g.cs = pick;
  g.gpp = pick / 8;
  g.swz_shift = g.gpp == 1 ? 3 : g.gpp == 2 ? 2 : g.gpp == 4 ? 1 : 0;
  g.chunks = ceil_div(c_pad, pick);
  g.stages = fit_pick;  // the ring runs on across a CTA's blocks
  g.gpc_last = (c_pad - (g.chunks - 1) * pick) / 8;
  g.q2_full = 2 * ceil_div(g.taps * g.gpp, 2);
  g.q2_last = 2 * ceil_div(g.taps * g.gpc_last, 2);
  g.w_stage = align128(g.q2_full * g.n * 16);
  g.h_stage = align128(n_pos * pick * 2);
  g.stage = g.w_stage + g.h_stage;
  if (layout == NCDHW)
    g.route = W % 8 == 0 ? ROUTE_VEC : ROUTE_REGS;
  else
    g.route = C % 2 ? ROUTE_REGS : C % 8 == 0 ? ROUTE_CP16 : ROUTE_CP4;
  const long long tile_bytes = ((long long)(g.chunks - 1) * g.q2_full + g.q2_last) * g.n * 16;
  const long long scratch = tile_bytes * g.n_tiles;
  const long long blocks = (long long)B * g.Do * g.n_ht * g.n_wt * g.n_tiles;
  if (scratch > 0x7fffffffLL || blocks > 0x7fffffffLL) return false;
  g.tile_bytes = (int)tile_bytes;
  const int vals[PLAN_INTS] = {g.th, g.tw, g.n, g.n_tiles, g.taps * (c_pad / 8), g.cs,
                               g.stages, 1, g.route, g.chunks, (int)blocks,
                               RESERVED + g.epilogue + g.stages * g.stage,
                               (g.chunks - 1) * g.q2_full / 2 + g.q2_last / 2, (int)scratch};
  for (int i = 0; i < PLAN_INTS; ++i) out[i] = vals[i];
  return true;
}

// ---- the weights, packed once per launch --------------------------------------------

// wp[tile][chunk][q][n][8]: granule q of a chunk is (tap q / gpc, channels
// 8 (q % gpc) .. + 7 of the chunk), gpc the chunk's granules per tap; zero
// past taps x gpc, C and Co. The weight of (tap, c, co) is w[tap * s_tap +
// c * s_c + co * s_co]: K5's (Co, C, taps) and T3's (taps, C, Co) differ
// only in these strides. One thread per element.
__global__ void pack_weights_kernel(const __nv_bfloat16* __restrict__ w,
                                    __nv_bfloat16* __restrict__ wp, Geom g, int s_tap, int s_c,
                                    int s_co, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int tile_elems = g.tile_bytes / 2;
  const int tile = (int)(i / tile_elems);
  const int r = (int)(i % tile_elems);
  const int chunk_elems = g.q2_full * g.n * 8;
  const int chunk = r / chunk_elems;
  const int rr = r % chunk_elems;
  const int q = rr / (g.n * 8);
  const int n = rr / 8 % g.n;
  const int e = rr % 8;
  const int gpc = chunk == g.chunks - 1 ? g.gpc_last : g.gpp;
  const int tap = q / gpc;
  const int c = chunk * g.cs + (q % gpc) * 8 + e;
  const int co = tile * g.n + n;
  __nv_bfloat16 v = __float2bfloat16(0.f);
  if (tap < g.taps && c < g.C && co < g.Co)
    v = w[(size_t)tap * s_tap + (size_t)c * s_c + (size_t)co * s_co];
  wp[i] = v;
}

inline cudaError_t pack_weights(const void* w, void* wp, const Geom& g, int s_tap, int s_c,
                                int s_co, cudaStream_t stream) {
  const long long total = (long long)g.tile_bytes / 2 * g.n_tiles;
  pack_weights_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      (const __nv_bfloat16*)w, (__nv_bfloat16*)wp, g, s_tap, s_c, s_co, total);
  return cudaGetLastError();
}

// ---- PTX -------------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One bulk copy of `bytes` (a multiple of 16) from global to shared memory,
// counted on the barrier's transaction count.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes from global (src_bytes of them; the rest zero) to shared memory.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// 4 bytes, likewise.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// The barrier counts one arrival once this thread's cp.asyncs have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Keeps the compiler from moving the accumulators across the asynchronous
// products (it sees only their asm statements).
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The descriptor of a K-major B without swizzle at shared address addr:
// start >> 4, LBO (between the two granules of a k step) >> 4, SBO
// (between groups of 8 rows) >> 4, layout type 0.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, int lbo, int sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMER_WARPS * 32) : "memory");
}

// d += A (64 x 16, this warpgroup's rows, in registers) x B (16 x N, desc).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const unsigned (&a)[4], uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<40>(float (&d)[20], const unsigned (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19 "
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<72>(float (&d)[36], const unsigned (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35 "
      "}, {%36, %37, %38, %39}, %40, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<136>(float (&d)[68], const unsigned (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67 "
      "}, {%68, %69, %70, %71}, %72, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<168>(float (&d)[84], const unsigned (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %89, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n168k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83 "
      "}, {%84, %85, %86, %87}, %88, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// ---- the kernel ------------------------------------------------------------------------

// An output block and where its halo starts in x (it may start outside x:
// the padding). Blocks are numbered N tile fastest, then columns, rows,
// output depth and batch, so that the CTAs at work at one time share halos
// and weights in L2.
struct Tile {
  int b, od, oh0, ow0, nt, co0, d0, h0, w0;
};

__device__ __forceinline__ Tile tile_of(const Geom& g, int i) {
  Tile t;
  t.nt = i % g.n_tiles;
  i /= g.n_tiles;
  t.ow0 = (i % g.n_wt) * g.tw;
  i /= g.n_wt;
  t.oh0 = (i % g.n_ht) * g.th;
  i /= g.n_ht;
  t.od = i % g.Do;
  t.b = i / g.Do;
  t.co0 = t.nt * g.n;
  t.d0 = t.od * g.sd - (g.kd - 1) / 2;
  t.h0 = t.oh0 * g.sh - (g.kh - 1) / 2;
  t.w0 = t.ow0 * g.sw - (g.kw - 1) / 2;
  return t;
}

// Where (depth dd, row r, column col) of the tile's halo is stored: at
// column stride 2 the even columns come first.
__device__ __forceinline__ int halo_pos(const Geom& g, int dd, int r, int col) {
  const int c = g.sw == 1 ? col : (col & 1) * (g.cols_phys >> 1) + (col >> 1);
  return (dd * g.in_rows + r) * g.cols_phys + c;
}

// Byte offset of granule gr of stored position pos: swizzled so that 8
// consecutive positions fall on 8 distinct 16-byte bank groups.
__device__ __forceinline__ int granule_offset(const Geom& g, int pos, int gr) {
  const int swz = (pos >> g.swz_shift) & (g.gpp - 1);
  return (pos * g.gpp + (gr ^ swz)) * 16;
}

// Group k steps p .. p + G - 1 of a chunk: this lane's A rows by
// ldmatrix (a slot past the chunk's last, q >= q2, reads the zero granule).
template <int G>
__device__ __forceinline__ void load_group(unsigned (&a)[G][4], int p, int q2, const int* qt,
                                           int khalf, uint32_t hst, int base, uint32_t zero_addr,
                                           const Geom& g) {
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int q = 2 * (p + j) + khalf;  // this lane's granule slot
    const int e = q < q2 ? qt[q] : -1;
    ldmatrix_x4(a[j], e >= 0 ? hst + granule_offset(g, base + (e >> 3), e & 7) : zero_addr);
  }
}

// The group's G wgmmas, committed as one group (B of a step past the
// chunk's last: the chunk's first, times zero A).
template <int N, int G>
__device__ __forceinline__ void mma_group(float (&acc)[N / 2], const unsigned (&a)[G][4],
                                          uint64_t desc0, int p, int steps) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < G; ++j)  // 2 N x 16 bytes of B per step, >> 4
    wgmma_rs<N>(acc, a[j], desc0 + (uint64_t)(p + j < steps ? (p + j) * 2 * N : 0));
  wgmma_commit();
}

// L (conv3d.cu's Ncdhw, conv_cl.cu's Ndhwc) provides
//   stage_halo(x, g, t, halo, c0, gpc, ptid, full): the producer thread ptid's
//     share of one chunk's halo (channels c0 .. c0 + 8 gpc - 1), ending with
//     its arrival on the stage's full barrier;
//   tile_index(m, co, n): where output position m, channel co of the block
//     lies in the epilogue's bf16 tile;
//   store(out, g, t, tile, n, tid): the consumer thread tid's share of the
//     tile's write to out.
// Persistent: a CTA walks the blocks blockIdx.x, + gridDim.x, ...; the ring
// runs on across blocks, so the producer stages the next block's first
// chunks while the consumers finish a block and write it out.
template <int N, class L>
__global__ void __launch_bounds__(THREADS, 1) conv_sm90_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wp,
    __nv_bfloat16* __restrict__ out, Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint4* zero = reinterpret_cast<uint4*>(smem + 16 * MAX_STAGES);
  int* qtab = reinterpret_cast<int*>(smem + 256);  // [2][QMAX]: a full chunk's, the last's
  __nv_bfloat16* epi = reinterpret_cast<__nv_bfloat16*>(smem + RESERVED);
  unsigned char* ring = smem + RESERVED + g.epilogue;
  const uint32_t full0 = smem_addr(smem), empty0 = full0 + 8 * MAX_STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_blocks = g.Do * g.n_ht * g.n_wt * g.n_tiles * g.B;

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(full0 + 8 * s, STAGERS + 1);
      mbar_init(empty0 + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    *zero = make_uint4(0u, 0u, 0u, 0u);
  }
  // granule slot q of a chunk: (the offset of its tap, in stored positions
  // from the output position's own) << 3 | its granule of the tap, or -1
  // for the zero slot that makes a chunk's count even
  for (int i = threadIdx.x; i < 2 * QMAX; i += THREADS) {
    const int gpc = i < QMAX ? g.gpp : g.gpc_last, q = i % QMAX, tap = q / gpc;
    const int a = tap / (g.kh * g.kw), b = tap / g.kw % g.kh, c = tap % g.kw;
    const int off = (a * g.in_rows + b) * g.cols_phys +
                    (g.sw == 1 ? c : (c & 1) * (g.cols_phys >> 1) + (c >> 1));
    qtab[i] = tap < g.taps ? off << 3 | q % gpc : -1;
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ---- the producer: one chunk per stage, round after round; its two
    // warpgroups take the chunks in turn, so that two are staged at once ----
    const int ptid = threadIdx.x - CONSUMER_WARPS * 32;
    const int pg = ptid / STAGERS, sid = ptid % STAGERS;
    int seq = 0;  // chunks staged so far, over all of this CTA's blocks
    for (int blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
      const Tile t = tile_of(g, blk);
      const unsigned char* wsrc =
          reinterpret_cast<const unsigned char*>(wp) + (size_t)t.nt * g.tile_bytes;
      for (int chunk = 0; chunk < g.chunks; ++chunk, ++seq) {
        if ((seq & 1) != pg) continue;
        const int s = seq % g.stages, round = seq / g.stages;
        if (round > 0) mbar_wait(empty0 + 8 * s, (round - 1) & 1);
        const bool last = chunk == g.chunks - 1;
        unsigned char* st = ring + (size_t)s * g.stage;
        if (sid == 0) {
          const int bytes = (last ? g.q2_last : g.q2_full) * N * 16;
          mbar_expect_tx(full0 + 8 * s, bytes);
          bulk_copy(smem_addr(st), wsrc + (size_t)chunk * g.q2_full * N * 16, bytes,
                    full0 + 8 * s);
        }
        L::stage_halo(x, g, t, st + g.w_stage, chunk * g.cs, last ? g.gpc_last : g.gpp, sid,
                      full0 + 8 * s);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // ---- the consumers: 64 output positions per warpgroup ----
    const int row = (warp >> 2) * 64 + (warp & 3) * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int m = row < g.th * g.tw ? row : g.th * g.tw - 1;  // rows past the block are not stored
    const int base = m / g.tw * g.sh * g.cols_phys + m % g.tw;
    const int khalf = lane >> 4;  // this lane's granule of a k step: the first or the second
    const uint32_t zero_addr = smem_addr(zero);
    // G k steps per group of wgmmas, issued back to back and waited for
    // together; the other warpgroup's group runs while one loads its next
    // group's A. A group is never cut short, so every wgmma is issued on a
    // path all threads take (the steps past a chunk's last multiply zero A
    // by the chunk's first B).
    constexpr int G = N <= 136 ? 7 : 1;
    float acc[N / 2];
    unsigned a[G][4];
    int seq = 0;
    for (int blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
      const Tile t = tile_of(g, blk);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      for (int chunk = 0; chunk < g.chunks; ++chunk, ++seq) {
        const int s = seq % g.stages;
        const bool last = chunk == g.chunks - 1;
        const int q2 = last ? g.q2_last : g.q2_full, steps = q2 / 2;
        const uint32_t wst = smem_addr(ring + (size_t)s * g.stage);
        const uint32_t hst = wst + g.w_stage;
        const uint64_t desc0 = b_desc(wst, N * 16, 128);
        const int* qt = qtab + (last ? QMAX : 0);
        mbar_wait(full0 + 8 * s, (seq / g.stages) & 1);
        for (int p = 0; p < steps; p += G) {
          load_group<G>(a, p, q2, qt, khalf, hst, base, zero_addr, g);
          fence_regs(acc);
          mma_group<N, G>(acc, a, desc0, p, steps);
          wgmma_wait<0>();
          fence_regs(acc);
        }
        if (lane == 0) mbar_arrive(empty0 + 8 * s);  // the stage is read: the producer may refill it
      }

      // ---- the epilogue: bf16 through shared memory ----
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const int mi = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
        const int co = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        epi[L::tile_index(mi, co, N)] = __float2bfloat16(acc[i]);
      }
      consumer_sync();
      L::store(out, g, t, epi, N, threadIdx.x);
      consumer_sync();  // the next block's epilogue overwrites epi
    }
  }
}

template <int N, class L>
cudaError_t launch_width(const void* x, const void* wp, void* out, const Geom& g, int smem,
                         cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(conv_sm90_kernel<N, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)g.Do * g.n_ht * g.n_wt * g.n_tiles * g.B;
  const unsigned grid = (unsigned)(blocks < sms ? blocks : sms);  // one CTA per SM
  conv_sm90_kernel<N, L><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)wp, (__nv_bfloat16*)out, g);
  return cudaGetLastError();
}

// Packs w into scratch (plan's scratch bytes, 16-byte aligned) and launches
// the kernel of the plan's width. The weight of (tap, c, co) is w[tap *
// s_tap + c * s_c + co * s_co].
template <class L>
cudaError_t conv_sm90_launch(const void* x, const void* w, void* out, void* scratch,
                             const Geom& g, int smem, int s_tap, int s_c, int s_co,
                             cudaStream_t stream) {
  cudaError_t err = pack_weights(w, scratch, g, s_tap, s_c, s_co, stream);
  if (err != cudaSuccess) return err;
  switch (g.n) {
    case 40: return launch_width<40, L>(x, scratch, out, g, smem, stream);
    case 72: return launch_width<72, L>(x, scratch, out, g, smem, stream);
    case 136: return launch_width<136, L>(x, scratch, out, g, smem, stream);
    case 168: return launch_width<168, L>(x, scratch, out, g, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Copies runs of V contiguous bf16 (V in {8, 2, 1}): 16, 4 or 2 bytes a store.
template <int V>
__device__ __forceinline__ void copy_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src) {
  if constexpr (V == 8) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else if constexpr (V == 2) {
    *reinterpret_cast<unsigned*>(dst) = *reinterpret_cast<const unsigned*>(src);
  } else {
    *dst = *src;
  }
}

}  // namespace sm90
