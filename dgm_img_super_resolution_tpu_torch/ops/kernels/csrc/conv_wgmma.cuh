// A 3x3 conv C -> C (C = 64, bf16, NHWC, stride 1) on Hopper's warpgroup MMA
// fed by TMA, with an epilogue hook: the conv core of conv3x3_wgmma.cu and of
// the bf16 C = 64 chain of block_chain_wgmma.cu, built so that the regions
// can move onto it one epilogue at a time. conv_wgmma_wide.cuh runs the same
// tile, stage and hooks at C = 128-256, streaming K and the weights.
//
// Design (sm_90a; every size below at C = 64, where one pixel's channels are
// exactly one 128-byte swizzle row):
// - Persistent grid, one block of two consumer warpgroups (256 threads) per
//   SM. A block walks output tiles of TH = 2 rows x 64 pixels; warpgroup w
//   computes row w of the tile as one M = 64 (pixels) x N = 64 (channels)
//   product, K = 9 taps x 64 input channels: 9 x 4 wgmma m64n64k16.
// - Weights: all 9 taps' (C_out, C_in) slabs stay in shared memory for the
//   block's life (73,728 B), loaded by TMA 128-byte swizzled: the B operand,
//   K-major, SBO 1024 B between 8-channel groups.
// - Input: a 4-D tensor map over NHWC (C, W, H, B), 128-byte swizzle. A
//   stage is one box of 64 channels x 72 pixels x 4 halo rows starting at
//   (x0 - 1, y0 - 1): the 66 pixels a row needs, widened to 72 so that each
//   halo row is 9,216 B and starts 1024-byte aligned. TMA fills pixels
//   outside the image with zeros, which is the zero border. A ring of 3
//   stages (36,864 B each) with "full" (TMA bytes landed) and "empty" (all
//   256 threads done) mbarriers; one consumer thread (thread 0) issues every
//   load, STAGES tiles ahead. A producer warp is left out: in flash it
//   capped the consumers' registers.
// - A operand of tap (dy, dx): 64 consecutive pixels of halo row w + dy,
//   starting at pixel dx, read straight from the stage by a descriptor whose
//   start moves by 128 dx bytes (and 32 B per K-step). The swizzle XOR is a
//   function of the address bits, as TMA wrote it, so the shifted start
//   reads the right chunks with the descriptor's base-offset field at 0.
//   Measured on the card: base offset 0 matches the plain version for a
//   single tap at dx = 1 and 2 (chip_smoke.py holds that check); setting it
//   to dx (the field's documented use) reads the wrong chunks.
// - Reflect border: a tile on the image's edge patches its halo in shared
//   memory once the TMA has landed (x = -1 from x = 1, x = W from x = W - 2,
//   the same for rows; each destination reads its reflected source, which
//   always lies inside the image, so one pass is enough), with the swizzle
//   applied to both addresses; then fence.proxy.async and a barrier of the
//   256 threads before any wgmma reads the stage.
// - Overlap: two accumulators. A warpgroup issues the MMAs of tile j + 1,
//   then runs the epilogue of tile j while they run; the loads of tile
//   j + 3 are in flight meanwhile. It drains them before it lands tile
//   j + 2 (mbarrier wait, reflect patch) and issues its products. Every
//   block walks the same even number of tiles (repeating the last tile,
//   unstored, where it runs out), so the loop issues every wgmma in
//   straight-line code and no wgmma is in flight across its back edge:
//   either makes ptxas serialise every wgmma (warnings C7518, C7514).
// - Epilogue: the hook maps each thread's f32 sums of a channel pair to a
//   bf16 pair, written into a 128-byte-swizzled staging row (8,192 B a
//   warpgroup; conflict-free), then one TMA store of 64 pixels x 128 B,
//   which clips the pixels and rows outside the image (ragged W and H).
//   The store's read of the staging row overlaps the next tile's MMAs.
// - Hooks that store for themselves (Epi::STORES, the tail's 1x1 down to a
//   few channels, which makes no TMA box): the hook reduces the sums in
//   registers and writes its pixels with plain stores; the staging row, its
//   TMA store and the wait for it are left out. The other hooks compile as
//   before.
// - Residuals: a hook may add one or two tensors of the output's shape at
//   the output pixel (Epi::NRES). They come in by TMA loads of the output
//   store's box: the first into the staging row itself, the second into a
//   row of its own, both swizzled as the store reads them, so the hook reads
//   each thread's pair where it then writes its result. The warpgroup's
//   leader issues tile j + 1's loads once tile j's store has read the
//   staging row. On the card that wait, more than the loads, is what a
//   residual costs; prefetching the residual rows into L2, holding them in
//   registers (16 a residual: ptxas spilled) and storing the row by the
//   threads instead of TMA were each no faster.
// Shared memory: 1024 (alignment) + 73,728 + 3 x 36,864 + 2 x 8,192 =
// 201,728 B of the 232,448 a block may use; 218,112 B with a second
// residual row per warpgroup.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace dgmsr {
namespace cw {

using namespace dgmsr::hopper;

constexpr int C = 64;                              // channels in and out
constexpr int PIX = C * 2;                         // bytes a pixel: one swizzle row
constexpr int TM = 64;                             // output pixels a warpgroup row (wgmma M)
constexpr int TH = 2;                              // output rows a tile: one a warpgroup
constexpr int HH = TH + 2;                         // halo rows a stage
constexpr int HW = 72;                             // halo pixels a row (66 used)
constexpr int STAGES = 3;
constexpr int NT = 128 * TH;                       // threads a block
constexpr uint32_t ROW_BYTES = HW * PIX;           // 9,216
constexpr uint32_t STAGE_BYTES = HH * ROW_BYTES;   // 36,864
constexpr uint32_t TAP_BYTES = C * PIX;            // 8,192: one tap's (C_out, C_in)
constexpr uint32_t W_BYTES = 9 * TAP_BYTES;        // 73,728
constexpr uint32_t OUT_BYTES = TM * PIX;           // 8,192: one warpgroup's output row
constexpr size_t SMEM_BYTES = 1024 + W_BYTES + STAGES * STAGE_BYTES + TH * OUT_BYTES;
constexpr int BAR_PATCH = 1;                       // named barriers: 1 for both warpgroups,
constexpr int BAR_OUT = 2;                         // 2 + w for warpgroup w's epilogue

// Round an f32 value to bf16 and back: the points where the reference rounds.
__device__ __forceinline__ float rnd(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// mish(x) = x * tanh(softplus(x)) = x * n(n + 2) / (n(n + 2) + 2), n = e^x,
// without a branch (one per element slowed the epilogue on the card): past
// x = 20 the quotient is 1 in f32 (as tanh(softplus) is), and n = e^20 keeps
// n(n + 2) inside __fdividef's range. The fast exp and division are within a
// few f32 ulp, far below the bf16 rounding that follows.
__device__ __forceinline__ float mish(float x) {
  const float n = __expf(fminf(x, 20.f));
  const float p = n * (n + 2.f);
  return x * __fdividef(p, p + 2.f);
}

// A bf16 pair (lower address first) and its f32 values.
__device__ __forceinline__ uint32_t pack(float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack(uint32_t u) { return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u)); }

// A hook's per-thread bias: channels 8 n + 2 t, + 1 at b[2 n], b[2 n + 1]
// (of the N slice whose bias starts at `bias`).
struct BiasRegs {
  float b[16];
};
__device__ __forceinline__ BiasRegs bias_regs(const float* bias, int t) {
  BiasRegs r;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    r.b[2 * n] = bias[8 * n + 2 * t];
    r.b[2 * n + 1] = bias[8 * n + 2 * t + 1];
  }
  return r;
}

#define CW_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define CW_F16(i) CW_F4(i), CW_F4(i + 4), CW_F4(i + 8), CW_F4(i + 12)

// d (64 x 64, f32) = (scale_d ? d : 0) + A (64 x 16) B (16 x 64); A and B
// K-major in shared memory. d[4 n + e]: row 16 warp + g + 8 (e / 2), column
// 8 n + 2 t + e % 2 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_m64n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : CW_F16(0), CW_F16(16)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef CW_F16
#undef CW_F4

// Issue (no wait) the 36 products of one output row: tap (dy, dx) reads
// halo row dy of the warpgroup's rows from pixel dx; K-step kk moves 32 B
// into each 128-byte row. da: the stage's halo row w; dw: tap 0's weights.
__device__ __forceinline__ void issue_row(float (&acc)[32], uint64_t da, uint64_t dw) {
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_m64n64(acc, da + (((tap / 3) * ROW_BYTES + (tap % 3) * PIX + kk * 32) >> 4),
                 dw + ((tap * TAP_BYTES + kk * 32) >> 4), tap > 0 || kk > 0);
  wgmma_commit();
}

// Halo index of the ReflectionPad(1) source of halo index i (image index
// i0 - 1 + i of an image n long); indices inside the image or past its
// reflected edge map to themselves.
__device__ __forceinline__ int reflect_halo(int i, int i0, int n) {
  const int v = i0 - 1 + i;
  return v == -1 ? i + 2 : v == n ? i - 2 : i;
}

// Overwrite the halo pixels of a stage that lie on the reflected border
// (column x = -1 and x = W, row y = -1 and y = H, where the box holds them)
// with their reflections, 16 bytes a thread and step, both addresses
// swizzled (chunk c of pixel p at c ^ (p % 8)).
__device__ __forceinline__ void patch_reflect(unsigned char* st, int y0, int x0, int H, int W) {
  const int cl = x0 == 0 ? 0 : -1;
  const int cr = W - x0 + 1 <= TM + 1 ? W - x0 + 1 : -1;
  const int rt = y0 == 0 ? 0 : -1;
  const int rb = H - y0 + 1 <= TH + 1 ? H - y0 + 1 : -1;
  auto copy = [&](int hr, int hc, int ch) {
    if (hr < 0 || hc < 0) return;
    const int sr = reflect_halo(hr, y0, H), sc = reflect_halo(hc, x0, W);
    const uint4 v = *reinterpret_cast<const uint4*>(st + sr * ROW_BYTES + sc * PIX + ((ch ^ (sc & 7)) << 4));
    *reinterpret_cast<uint4*>(st + hr * ROW_BYTES + hc * PIX + ((ch ^ (hc & 7)) << 4)) = v;
  };
  if (cl >= 0 || cr >= 0)
    for (int i = threadIdx.x; i < 2 * HH * 8; i += NT) copy((i >> 3) % HH, (i >> 3) < HH ? cl : cr, i & 7);
  if (rt >= 0 || rb >= 0)
    for (int i = threadIdx.x; i < 2 * (TM + 2) * 8; i += NT) {
      const int k = i >> 3;
      copy(k < TM + 2 ? rt : rb, k % (TM + 2), i & 7);
    }
}

// Write one warpgroup's accumulator through the epilogue hook into its
// swizzled staging row (pixel m at m * 128 B, channel chunk n at n ^ (m % 8);
// m % 8 = g). The hook sees output pixel (b, y, x0 + m), channels
// 8 n + 2 t, + 1, and the residuals' pairs there: the first from the staging
// row itself, which the result then overwrites, the second from res1.
template <class Epi>
__device__ __forceinline__ void stage_row(const Epi& epi, const typename Epi::Regs& regs, const float (&acc)[32],
                                          unsigned char* out, const unsigned char* res1, int b, int y, int x0) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = warp * 16 + g + 8 * h;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int off = m * PIX + ((n ^ g) << 4) + 4 * t;
      uint32_t* p = reinterpret_cast<uint32_t*>(out + off);
      const uint32_t r0 = Epi::NRES > 0 ? *p : 0u;
      const uint32_t r1 = Epi::NRES > 1 ? *reinterpret_cast<const uint32_t*>(res1 + off) : 0u;
      *p = epi(regs, n, b, y, x0 + m, acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1], r0, r1);
    }
  }
}

// Epi: a copyable struct with a type Regs (per-thread constants),
// `static constexpr int NRES` (0, 1 or 2 residual tensors read at the output
// pixel), `Regs setup(int t, int n0) const` (t = lane % 4; n0 the first
// output channel of the tile's N slice, 0 here) and
// `uint32_t operator()(const Regs&, int n, int b, int y, int x, float s0, float s1,
//                      uint32_t r0, uint32_t r1) const`,
// which maps the conv's f32 sums of channels (n0 + 8 n + 2 t, + 1) at pixel
// (b, y, x), and the residuals' packed bf16 pairs there (0 past NRES), to the
// packed bf16 pair stored there. A hook with `static constexpr bool STORES =
// true` (and NRES 0) has instead
// `void store(const Regs&, const float (&acc)[32], int b, int y, int x0, int H, int W) const`,
// called by every thread of the warpgroup with its accumulator of output row
// y, pixels x0 .. x0 + 63 (H, W the image's), which writes them itself.
template <class Epi, class = void> struct stores_self : std::false_type {};
template <class Epi> struct stores_self<Epi, std::void_t<decltype(Epi::STORES)>> : std::bool_constant<Epi::STORES> {};

template <bool REFLECT, class Epi>
__global__ void __launch_bounds__(NT, 1)
    conv_wgmma_kernel(const __grid_constant__ CUtensorMap tin, const __grid_constant__ CUtensorMap tw,
                      const __grid_constant__ CUtensorMap tout, const __grid_constant__ CUtensorMap tres0,
                      const __grid_constant__ CUtensorMap tres1, const Epi epi, int B, int H, int W) {
  constexpr int NRES = Epi::NRES;
  constexpr bool SELF = stores_self<Epi>::value;
  static_assert(NRES >= 0 && NRES <= 2, "a hook reads at most two residuals");
  static_assert(!SELF || NRES == 0, "a hook that stores for itself reads no residual");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_w, full[STAGES], empty[STAGES], bar_res[TH];
  const uint32_t base = smem_addr(smem_raw);
  unsigned char* sw = smem_raw + ((1024 - (base & 1023)) & 1023);  // 1024 B aligned: the swizzle atoms
  unsigned char* sx = sw + W_BYTES;                                 // stage s at s * STAGE_BYTES
  unsigned char* so = sx + STAGES * STAGE_BYTES;                    // warpgroup w's row at w * OUT_BYTES
  unsigned char* sr = so + TH * OUT_BYTES;                          // its second residual's row (NRES == 2)

  const int tiles_x = (W + TM - 1) / TM, tiles_y = (H + TH - 1) / TH;
  const long per_image = (long)tiles_x * tiles_y;
  const long ntiles = per_image * B;
  // This block's tiles: blockIdx.x + j * gridDim.x for j < n. n is the same
  // even count for every block (the grid is at most ntiles), so that the
  // main loop below issues every wgmma outside a branch; the slots past
  // ntiles compute tile ntiles - 1 again and store nothing.
  const int n = (int)((ntiles + gridDim.x - 1) / gridDim.x + 1) & ~1;
  auto coords = [&](int j, int& b, int& y0, int& x0) {
    long tile = blockIdx.x + (long)j * gridDim.x;
    const bool real = tile < ntiles;
    if (!real) tile = ntiles - 1;
    b = (int)(tile / per_image);
    const int rem = (int)(tile - b * per_image);
    y0 = (rem / tiles_x) * TH;
    x0 = (rem % tiles_x) * TM;
    return real;
  };
  const bool loader = threadIdx.x == 0;  // the one thread that issues the loads
  // Tile j into stage j % STAGES once all threads released tile j - STAGES
  // there (a fresh barrier passes parity 1).
  auto load = [&](int j) {
    const int s = j % STAGES;
    mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
    mbar_expect(&full[s], STAGE_BYTES);
    int b, y0, x0;
    coords(j, b, y0, x0);
    tma_load(&tin, sx + s * STAGE_BYTES, &full[s], 0, x0 - 1, y0 - 1, b);
  };
  if (loader) {
    mbar_init(&bar_w, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT);
    }
    for (int w = 0; w < TH; ++w) mbar_init(&bar_res[w], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bar_w, W_BYTES);
    for (int tap = 0; tap < 9; ++tap) tma_load(&tw, sw + tap * TAP_BYTES, &bar_w, 0, 0, tap, 0);
    for (int j = 0; j < STAGES && j < n; ++j) load(j);
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const bool leader = (threadIdx.x & 127) == 0;  // issues the warpgroup's stores
  const typename Epi::Regs regs = epi.setup(threadIdx.x & 3, 0);
  const uint64_t dw = desc(sw, 16, 1024);                // K-major: LBO unused, 1024 B between 8-row groups
  const uint64_t dx = desc(sx + wg * ROW_BYTES, 16, 1024);
  constexpr uint64_t stage_step = STAGE_BYTES >> 4;
  unsigned char* out = so + wg * OUT_BYTES;
  unsigned char* res1 = sr + wg * OUT_BYTES;
  // Tile j's residuals at the warpgroup's output row, into the staging rows
  // (by the leader, once the staging row is free). A row past the image
  // (odd H) loads nothing: its result is not stored.
  auto load_res = [&](int j) {
    int b, y0, x0;
    coords(j, b, y0, x0);
    if (y0 + wg >= H) {
      mbar_arrive(&bar_res[wg]);
      return;
    }
    mbar_expect(&bar_res[wg], NRES * OUT_BYTES);
    tma_load(&tres0, out, &bar_res[wg], 0, x0, y0 + wg, b);
    if constexpr (NRES > 1) tma_load(&tres1, res1, &bar_res[wg], 0, x0, y0 + wg, b);
  };
  if constexpr (NRES > 0)
    if (leader) load_res(0);
  // Wait for tile j's stage and patch its reflected border.
  auto land = [&](int j) {
    const int s = j % STAGES;
    mbar_wait_warp(&full[s], (j / STAGES) & 1);
    if constexpr (REFLECT) {
      int b, y0, x0;
      coords(j, b, y0, x0);
      if (x0 == 0 || x0 + TM >= W || y0 == 0 || y0 + TH >= H) {  // the same for the whole block
        patch_reflect(sx + s * STAGE_BYTES, y0, x0, H, W);
        fence_async_smem();
        named_sync(BAR_PATCH, NT);
        __syncwarp();  // converged for the .aligned wgmma ops
      }
    }
  };

  // Release tile j's stage (its products are done), run its epilogue into
  // the staging row and store it (or let the hook store it); then load tile
  // j + 1's residuals into the staging rows and tile j + STAGES into the
  // stage.
  auto finish = [&](int j, const float(&acc)[32]) {
    mbar_arrive(&empty[j % STAGES]);
    int b, y0, x0;
    const bool real = coords(j, b, y0, x0);
    if constexpr (SELF) {
      if (real) epi.store(regs, acc, b, y0 + wg, x0, H, W);
    } else {
      if constexpr (NRES > 0) {
        mbar_wait(&bar_res[wg], j & 1);  // loaded after the previous store was done reading the staging row
      } else {
        if (leader) bulk_wait_read<0>();  // the previous store is done reading the staging row
        named_sync(BAR_OUT + wg, 128);
      }
      stage_row(epi, regs, acc, out, res1, b, y0 + wg, x0);
      fence_async_smem();
      named_sync(BAR_OUT + wg, 128);
      if (leader && real) {
        tma_store(&tout, out, 0, x0, y0 + wg, b);
        bulk_commit();
      }
      if constexpr (NRES > 0) {
        if (leader && j + 1 < n) {
          bulk_wait_read<0>();
          load_res(j + 1);
        }
      }
    }
    if (loader && j + STAGES < n) load(j + STAGES);
    __syncwarp();
  };
  auto stage_desc = [&](int j) { return dx + (j % STAGES) * stage_step; };

  // Tile j + 1's products run under tile j's epilogue; even tiles
  // accumulate in acc0, odd ones in acc1. Each step drains its products
  // (wait_group 0) before the next: with a group in flight across the
  // loop's back edge, ptxas serialises every wgmma (warning C7514).
  float acc0[32], acc1[32];
  mbar_wait_warp(&bar_w, 0);
  land(0);
  issue_row(acc0, stage_desc(0), dw);
  wgmma_wait<0>();
  fence_regs(acc0);
  for (int j = 0; j + 2 < n; j += 2) {
    land(j + 1);
    issue_row(acc1, stage_desc(j + 1), dw);
    finish(j, acc0);
    wgmma_wait<0>();
    fence_regs(acc1);
    land(j + 2);
    issue_row(acc0, stage_desc(j + 2), dw);
    finish(j + 1, acc1);
    wgmma_wait<0>();
    fence_regs(acc0);
  }
  land(n - 1);
  issue_row(acc1, stage_desc(n - 1), dw);
  finish(n - 2, acc0);
  wgmma_wait<0>();
  fence_regs(acc1);
  finish(n - 1, acc1);
  if (leader) bulk_wait<0>();
}

// NHWC bf16 (c, W, H, B) as a 4-D map with a box of 64 channels (one
// 128-byte swizzle row) x box_w x box_h x 1, zeros outside. With step > 1
// the map sees every step-th pixel of a row from p (W / step of them): one
// column phase, as the stride-2 Downsample (head_ds_wgmma.cu) reads it.
inline int make_map(CUtensorMap* map, const void* p, int B, int H, int W, int box_w, int box_h, int c = C,
                    int step = 1) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t pix = 2ull * c;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)(W / step), (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {pix * step, (cuuint64_t)W * pix, (cuuint64_t)H * W * pix};
  const cuuint32_t box[4] = {(cuuint32_t)C, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// x, out and the residuals res0, res1 (the first Epi::NRES of them read):
// (B, H, W, 64) bf16, 16-byte aligned; w: (9, C_out, C_in) bf16. Returns
// cudaGetLastError() after the launch.
template <bool REFLECT, class Epi>
int launch_conv_wgmma(const void* x, const void* w, void* out, const Epi& epi, int B, int H, int W,
                      cudaStream_t stream, const void* res0 = nullptr, const void* res1 = nullptr) {
  auto kern = conv_wgmma_kernel<REFLECT, Epi>;
  constexpr size_t smem = SMEM_BYTES + (Epi::NRES > 1 ? TH * OUT_BYTES : 0);
  static_assert(smem <= 232448, "more shared memory than a block may use");
  static int nsm = 0;  // per instantiation
  if (nsm == 0) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  }
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  if ((Epi::NRES > 0 && !res0) || (Epi::NRES > 1 && !res1)) return (int)cudaErrorInvalidValue;
  CUtensorMap tin, tw, tout, tres0, tres1;
  int rc = make_map(&tin, x, B, H, W, HW, HH);
  if (!rc) rc = make_map(&tw, w, 1, 9, C, C, 1);  // the weights as (C_in, C_out, 9 taps, 1)
  if (!rc) rc = make_map(&tout, stores_self<Epi>::value ? x : out, B, H, W, TM, 1);  // a self-storing hook's is unused
  if (!rc) rc = make_map(&tres0, Epi::NRES > 0 ? res0 : out, B, H, W, TM, 1);
  if (!rc) rc = make_map(&tres1, Epi::NRES > 1 ? res1 : out, B, H, W, TM, 1);
  if (rc) return rc;
  const long ntiles = (long)B * ((H + TH - 1) / TH) * ((W + TM - 1) / TM);
  const unsigned grid = (unsigned)(ntiles < nsm ? ntiles : nsm);
  kern<<<grid, NT, smem, stream>>>(tin, tw, tout, tres0, tres1, epi, B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace cw
}  // namespace dgmsr
