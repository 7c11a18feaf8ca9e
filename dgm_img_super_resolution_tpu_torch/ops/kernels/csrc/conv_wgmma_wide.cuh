// The conv core of conv_wgmma.cuh at C = 128, 192 and 256: a 3x3 conv
// C -> C (bf16, NHWC, stride 1) on Hopper's warpgroup MMA fed by TMA, with
// the same tile, halo stage, reflect patch, staging rows and epilogue hooks,
// for the bf16 chain of block_chain_wgmma.cu at those widths.
//
// What differs from C = 64, where one pixel's channels are one 128-byte
// swizzle row and all nine taps' weights stay in shared memory:
// - Work item: (output tile of TH = 2 rows x 64 pixels, N slice of 64 output
//   channels), N slice fastest, so the C / 64 blocks that read one input box
//   run at once and all but the first read it from L2. Each warpgroup still
//   computes one m64n64 row product into one of two accumulators.
// - K is walked in 64-channel slices k, and within a slice in tap rows dy:
//   step (k, dy) is the 12 wgmma m64n64k16 of taps (dy, 0..2) over the
//   slice's 64 input channels. C is a template parameter, so the 3 C / 64
//   steps of a work item unroll into straight-line code (a wgmma under a
//   branch, or in flight across a loop's back edge, makes ptxas serialise
//   every wgmma: C7518, C7514).
// - Input ring: XSTAGES stages, each the core's halo box for one K slice
//   (64 channels x 72 pixels x 4 rows, 36,864 B), loaded at channel 64 k of
//   a map whose dim 0 is C, and reflect-patched on landing. A stage serves
//   the slice's three steps, so two stages keep one slice ahead.
// - Weight ring: WSTAGES slabs, each the three taps of one (k, dy) step,
//   64 output x 64 input channels (24,576 B): one TMA box (64, 64, 3) at
//   (64 k, n0, 3 dy) of the (9, C_out, C_in) taps seen as a map (C_in,
//   C_out, 9), 128-byte swizzled as the core's resident taps.
// - Pipeline: each step waits for its slab (and, at dy = 0, its slice),
//   issues its 12 wgmma, then waits for the step before (wgmma.wait_group 1)
//   and releases that step's slab (and slice, after dy = 2), so one group
//   is always queued behind the one running. Thread 0 reloads a released
//   stage at once, WSTAGES - 1 steps ahead. A tile's epilogue runs after
//   the next tile's first step is issued; every second tile drains its last
//   group (wait_group 0) so that none is in flight across the loop's back
//   edge.
// - Hooks: as in the core, with setup(t, n0) per work item (the bias and
//   time vector at the N slice's channels); the output and residual rows are
//   stored and loaded at channel n0.
// Shared memory: 1024 + 2 x 36,864 + 4 x 24,576 + 2 x 8,192 = 189,440 B,
// 205,824 B with a second residual row per warpgroup.
//
// Weight traffic: a work item reads 9 C x 64 x 2 B of weights (147 KB at
// C = 128, 295 KB at 256) from L2 for its 128 output pixels, twice what its
// input boxes bring in at every width; tools/torch_port_wide_ablation.py
// times the chain without it (PERF.md section 6).

#pragma once

#include "conv_wgmma.cuh"

namespace dgmsr {
namespace cw {

constexpr int XSTAGES = 2;                           // K-slice halo boxes in the ring
constexpr int WSTAGES = 4;                           // (K slice, tap row) weight slabs in the ring
constexpr uint32_t SLAB_BYTES = 3 * TAP_BYTES;       // 24,576: taps (dy, 0..2), 64 x 64
constexpr size_t WIDE_SMEM_BYTES = 1024 + XSTAGES * STAGE_BYTES + WSTAGES * SLAB_BYTES + TH * OUT_BYTES;

template <int M> struct Mode {
  static constexpr int value = M;
};

// The high word of every descriptor here: SBO 1024 B, 128-byte swizzle (see
// hopper.cuh's desc()); the low word is the start address >> 4 with LBO 16 B.
constexpr uint32_t DESC_HI = (1024 >> 4) | (1u << 30);
__device__ __forceinline__ uint32_t desc_lo(const void* p) { return (uint32_t)desc(p, 16, 1024); }

#define CW_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define CW_F16(i) CW_F4(i), CW_F4(i + 4), CW_F4(i + 8), CW_F4(i + 12)

// mma_m64n64 with each descriptor built from a 32-bit base (a, b: low
// words) and an immediate offset in 16-byte units (AOFF, BOFF; the start
// address field never carries into the high word below 256 KB), so that a
// step's 24 descriptors cost two live registers, not 24 64-bit ones.
template <int AOFF, int BOFF>
__device__ __forceinline__ void mma_wide(float (&d)[32], uint32_t a, uint32_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 al, bl, hi;\n.reg .b64 da, db;\n"
      "add.u32 al, %32, %34;\nadd.u32 bl, %33, %35;\nmov.b32 hi, %36;\n"
      "mov.b64 da, {al, hi};\nmov.b64 db, {bl, hi};\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1, 0, 0;\n}\n"
      : CW_F16(0), CW_F16(16)
      : "r"(a), "r"(b), "n"(AOFF), "n"(BOFF), "n"(DESC_HI), "r"(scale_d));
}

#undef CW_F16
#undef CW_F4

// The 12 products of step (k, DY) for one output row, from product (DX, KK)
// on: tap (DY, DX) reads halo row DY of the warpgroup's rows from pixel DX of
// the K slice's stage (a: its halo row w), K-step KK 32 B further into each
// 128-byte row; b: the step's slab. FIRST: the work item's first step, whose
// first product overwrites the accumulator.
template <bool FIRST, int DY, int DX = 0, int KK = 0>
__device__ __forceinline__ void step_products(float (&acc)[32], uint32_t a, uint32_t b) {
  constexpr int AOFF = (DY * ROW_BYTES + DX * PIX + KK * 32) >> 4, BOFF = (DX * TAP_BYTES + KK * 32) >> 4;
  mma_wide<AOFF, BOFF>(acc, a, b, !FIRST || DX > 0 || KK > 0);
  if constexpr (KK < 3) step_products<FIRST, DY, DX, KK + 1>(acc, a, b);
  else if constexpr (DX < 2) step_products<FIRST, DY, DX + 1, 0>(acc, a, b);
}

// Issue (no wait) the products of step (k, dy) as one wgmma group.
template <bool FIRST>
__device__ __forceinline__ void issue_step(float (&acc)[32], uint32_t a, uint32_t b, int dy) {
  wgmma_fence();
  if (dy == 0) step_products<FIRST, 0>(acc, a, b);  // dy is a constant where the step loop unrolls
  else if (dy == 1) step_products<FIRST, 1>(acc, a, b);
  else step_products<FIRST, 2>(acc, a, b);
  wgmma_commit();
}

template <int CW, bool REFLECT, class Epi>
__global__ void __launch_bounds__(NT, 1)
    conv_wide_kernel(const __grid_constant__ CUtensorMap tin, const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap tout, const __grid_constant__ CUtensorMap tres0,
                     const __grid_constant__ CUtensorMap tres1, const Epi epi, int B, int H, int W) {
  constexpr int NRES = Epi::NRES;
  constexpr int KS = CW / 64;  // K slices, and N slices
  constexpr int S = 3 * KS;    // (k, dy) steps a work item
  static_assert(CW % 64 == 0 && CW >= 128 && CW <= 256, "the wide core takes C = 128, 192, 256");
  static_assert(NRES >= 0 && NRES <= 2, "a hook reads at most two residuals");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t xfull[XSTAGES], xempty[XSTAGES], wfull[WSTAGES], wempty[WSTAGES], bar_res[TH];
  const uint32_t base = smem_addr(smem_raw);
  unsigned char* sx = smem_raw + ((1024 - (base & 1023)) & 1023);  // slice stage s at s * STAGE_BYTES
  unsigned char* sw = sx + XSTAGES * STAGE_BYTES;                   // weight slab s at s * SLAB_BYTES
  unsigned char* so = sw + WSTAGES * SLAB_BYTES;                    // warpgroup w's row at w * OUT_BYTES
  unsigned char* sr = so + TH * OUT_BYTES;                          // its second residual's row (NRES == 2)

  // 32-bit item arithmetic (the launcher keeps the item count below 2^30):
  // a 64-bit division here costs registers the products need.
  const int tiles_x = (W + TM - 1) / TM, tiles_y = (H + TH - 1) / TH;
  const int per_image = tiles_x * tiles_y;
  const int nitems = per_image * B * KS;
  // This block's work items: blockIdx.x + j * gridDim.x for j < n, the same
  // even n for every block (see conv_wgmma_kernel); slots past nitems
  // compute item nitems - 1 again and store nothing.
  const int n = ((nitems + (int)gridDim.x - 1) / (int)gridDim.x + 1) & ~1;
  const int nx = n * KS, nw = n * S;  // slices and slabs the block loads
  auto item_of = [&](int j) { return min((int)blockIdx.x + j * (int)gridDim.x, nitems - 1); };
  auto coords = [&](int j, int& b, int& y0, int& x0, int& n0) {
    const int item = item_of(j);
    n0 = (item % KS) * 64;
    const int tile = item / KS;
    b = tile / per_image;
    const int rem = tile - b * per_image;
    y0 = (rem / tiles_x) * TH;
    x0 = (rem % tiles_x) * TM;
    return (int)blockIdx.x + j * (int)gridDim.x < nitems;
  };
  const bool loader = threadIdx.x == 0;  // the one thread that issues the loads
  // Slice i (work item i / KS, K slice i % KS) into its stage once all
  // threads released slice i - XSTAGES there (a fresh barrier passes parity 1).
  auto load_x = [&](int i) {
    const int s = i % XSTAGES;
    mbar_wait(&xempty[s], ((i / XSTAGES) & 1) ^ 1);
    mbar_expect(&xfull[s], STAGE_BYTES);
    int b, y0, x0, n0;
    coords(i / KS, b, y0, x0, n0);
    tma_load(&tin, sx + s * STAGE_BYTES, &xfull[s], 64 * (i % KS), x0 - 1, y0 - 1, b);
  };
  // Slab q (work item q / S, step r = q % S: K slice r / 3, tap row r % 3).
  auto load_w = [&](int q) {
    const int s = q % WSTAGES, r = q % S;
    mbar_wait(&wempty[s], ((q / WSTAGES) & 1) ^ 1);
    mbar_expect(&wfull[s], SLAB_BYTES);
    tma_load(&tw, sw + s * SLAB_BYTES, &wfull[s], 64 * (r / 3), (item_of(q / S) % KS) * 64, 3 * (r % 3), 0);
  };
  if (loader) {
    for (int s = 0; s < XSTAGES; ++s) {
      mbar_init(&xfull[s], 1);
      mbar_init(&xempty[s], NT);
    }
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], NT);
    }
    for (int w = 0; w < TH; ++w) mbar_init(&bar_res[w], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < XSTAGES; ++i) load_x(i);
    for (int q = 0; q < WSTAGES; ++q) load_w(q);
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const bool leader = (threadIdx.x & 127) == 0;  // issues the warpgroup's stores
  const uint32_t dx0 = desc_lo(sx + wg * ROW_BYTES);  // slice stage 0, halo row wg
  const uint32_t dw0 = desc_lo(sw);                   // K-major: 1024 B between 8-row groups
  unsigned char* out = so + wg * OUT_BYTES;
  unsigned char* res1 = sr + wg * OUT_BYTES;
  // Item j's residuals at the warpgroup's output row and N slice, into the
  // staging rows (by the leader, once the staging row is free).
  auto load_res = [&](int j) {
    int b, y0, x0, n0;
    coords(j, b, y0, x0, n0);
    if (y0 + wg >= H) {
      mbar_arrive(&bar_res[wg]);
      return;
    }
    mbar_expect(&bar_res[wg], NRES * OUT_BYTES);
    tma_load(&tres0, out, &bar_res[wg], n0, x0, y0 + wg, b);
    if constexpr (NRES > 1) tma_load(&tres1, res1, &bar_res[wg], n0, x0, y0 + wg, b);
  };
  if constexpr (NRES > 0)
    if (leader) load_res(0);
  // Wait for slice i's stage and patch its reflected border.
  auto land_x = [&](int i) {
    const int s = i % XSTAGES;
    mbar_wait_warp(&xfull[s], (i / XSTAGES) & 1);
    if constexpr (REFLECT) {
      int b, y0, x0, n0;
      coords(i / KS, b, y0, x0, n0);
      if (x0 == 0 || x0 + TM >= W || y0 == 0 || y0 + TH >= H) {  // the same for the whole block
        patch_reflect(sx + s * STAGE_BYTES, y0, x0, H, W);
        fence_async_smem();
        named_sync(BAR_PATCH, NT);
        __syncwarp();  // converged for the .aligned wgmma ops
      }
    }
  };
  // Step q's products are done: release its slab (and its slice, after the
  // slice's last step) and load the stages' next contents.
  auto release = [&](int q, bool slice_done) {
    const int i = q / 3;  // q = (j S + 3 k + dy) and i = j KS + k
    mbar_arrive(&wempty[q % WSTAGES]);
    if (slice_done) mbar_arrive(&xempty[i % XSTAGES]);
    if (loader) {
      if (q + WSTAGES < nw) load_w(q + WSTAGES);
      if (slice_done && i + XSTAGES < nx) load_x(i + XSTAGES);
    }
    __syncwarp();
  };
  // Item j's epilogue into the staging row, stored at its N slice; then the
  // leader loads item j + 1's residuals once the store has read the row.
  auto finish = [&](int j, const float(&acc)[32]) {
    int b, y0, x0, n0;
    const bool real = coords(j, b, y0, x0, n0);
    if constexpr (NRES > 0) {
      mbar_wait(&bar_res[wg], j & 1);
    } else {
      if (leader) bulk_wait_read<0>();
      named_sync(BAR_OUT + wg, 128);
    }
    const typename Epi::Regs regs = epi.setup(threadIdx.x & 3, n0);
    stage_row(epi, regs, acc, out, res1, b, y0 + wg, x0);
    fence_async_smem();
    named_sync(BAR_OUT + wg, 128);
    if (leader && real) {
      tma_store(&tout, out, n0, x0, y0 + wg, b);
      bulk_commit();
    }
    if constexpr (NRES > 0) {
      if (leader && j + 1 < n) {
        bulk_wait_read<0>();
        load_res(j + 1);
      }
    }
    __syncwarp();
  };
  // Item j's S steps into acc. After its first step is issued: mode 1
  // finishes item j - 1 (drained already) from prev; mode 2 first waits for
  // item j - 1's last group and releases its stages; mode 0 (item 0) has
  // nothing to finish.
  auto item = [&](int j, float(&acc)[32], float(&prev)[32], auto mode) {
    constexpr int MODE = decltype(mode)::value;
#pragma unroll
    for (int st = 0; st < S; ++st) {
      const int q = j * S + st, i = j * KS + st / 3;
      if (st % 3 == 0) land_x(i);
      mbar_wait_warp(&wfull[q % WSTAGES], (q / WSTAGES) & 1);
      const uint32_t da = dx0 + (i % XSTAGES) * (STAGE_BYTES >> 4);
      const uint32_t dw = dw0 + (q % WSTAGES) * (SLAB_BYTES >> 4);
      if (st == 0) {
        issue_step<true>(acc, da, dw, 0);
        if constexpr (MODE == 2) {
          wgmma_wait<1>();
          fence_regs(prev);
          release(q - 1, true);
        }
        if constexpr (MODE != 0) finish(j - 1, prev);
      } else {
        issue_step<false>(acc, da, dw, st % 3);
        wgmma_wait<1>();
        release(q - 1, st % 3 == 0);
      }
    }
  };
  // Drain item j's last group and release its stages.
  auto drain = [&](int j, float(&acc)[32]) {
    wgmma_wait<0>();
    fence_regs(acc);
    release(j * S + S - 1, true);
  };

  float acc0[32], acc1[32];
  item(0, acc0, acc1, Mode<0>{});
  drain(0, acc0);
  for (int j = 0; j + 2 < n; j += 2) {
    item(j + 1, acc1, acc0, Mode<1>{});
    item(j + 2, acc0, acc1, Mode<2>{});
    drain(j + 2, acc0);
  }
  item(n - 1, acc1, acc0, Mode<1>{});
  drain(n - 1, acc1);
  finish(n - 1, acc1);
  if (leader) bulk_wait<0>();
}

// x, out and the residuals res0, res1 (the first Epi::NRES of them read):
// (B, H, W, CW) bf16, 16-byte aligned; w: (9, C_out, C_in) bf16. Returns
// cudaGetLastError() after the launch.
template <int CW, bool REFLECT, class Epi>
int launch_conv_wide(const void* x, const void* w, void* out, const Epi& epi, int B, int H, int W,
                     cudaStream_t stream, const void* res0 = nullptr, const void* res1 = nullptr) {
  auto kern = conv_wide_kernel<CW, REFLECT, Epi>;
  constexpr size_t smem = WIDE_SMEM_BYTES + (Epi::NRES > 1 ? TH * OUT_BYTES : 0);
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
  int rc = make_map(&tin, x, B, H, W, HW, HH, CW);
  if (!rc) rc = make_map(&tw, w, 1, 9, CW, 64, 3, CW);  // the weights as (C_in, C_out, 9 taps, 1)
  if (!rc) rc = make_map(&tout, out, B, H, W, TM, 1, CW);
  if (!rc) rc = make_map(&tres0, Epi::NRES > 0 ? res0 : out, B, H, W, TM, 1, CW);
  if (!rc) rc = make_map(&tres1, Epi::NRES > 1 ? res1 : out, B, H, W, TM, 1, CW);
  if (rc) return rc;
  const long items = (long)B * ((H + TH - 1) / TH) * ((W + TM - 1) / TM) * (CW / 64);
  if (items >= (1L << 30)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(items < nsm ? items : nsm);
  kern<<<grid, NT, smem, stream>>>(tin, tw, tout, tres0, tres1, epi, B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace cw
}  // namespace dgmsr
