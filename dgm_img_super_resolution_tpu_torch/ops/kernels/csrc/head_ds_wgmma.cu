// The two streamed convs of the chain regions' Downsample fold and head, in
// bf16, by hand for Hopper (sm_90a), on the warpgroup-MMA conv core of
// conv_wgmma.cuh and its streamed-K form conv_wgmma_wide.cuh.
//
// Replaces, for bfloat16, the convs in front of and behind the chain of
// dgm_img_super_resolution_tpu/ops/pallas/block_chain.py:
//   _block_chain3_stem_pallas with has_ds (down stage 0's Downsample, C = 64):
//     ds_out = rnd(reflect_conv3x3_stride2(out, wds) + bds)
//   _block_chain3_head_pallas (the head over [x || skip], C_s in {64, 128},
//   64 outputs), written as the chain's input h1 and residual r1:
//     a_pre = rnd(rnd(conv(x, wa_x) + ba) + rnd(conv(skip, wa_s)))
//     h1    = rnd(mish(a_pre) + tv1)
//     r1    = rnd(rnd(rnd(x . wr_x) + rnd(skip . wr_s)) + br)
// as block_chain3_stem_ds_reference / block_chain3_head_reference round
// them (ops/kernels/block_chain.py: ds_plain, head_h1_plain). float32, and
// the head at other C_s, stay on block_chain.cu's streamed conv; the chain
// itself runs on block_chain_wgmma.cu.
//
// Bound on the card at the main path's shapes (B = 8, bf16):
// - the Downsample, out (8, 64, 512, 512) -> (8, 64, 256, 256): 38.7 GFLOP
//   against 268 MB read and 67 MB written, 0.100 ms at 3.35 TB/s: bytes.
// - the head, x and skip (8, 128, 256, 256) -> h1, r1 (8, 64, 256, 256):
//   171.8 GFLOP (the 3x3 154.6, the 1x1 17.2) against 268 + 134 MB, 0.174
//   ms at 989 TFLOP/s: the tensor cores.
//
// The Downsample (ds_kernel). Output pixel (oy, ox) reads input rows
// 2 oy - 1 .. 2 oy + 1 and columns 2 ox - 1 .. 2 ox + 1 (H, W even). The
// input is read as its two column phases, through two tensor maps over the
// same NHWC tensor whose pixel stride is two pixels (256 B): the even map
// from the tensor's base (column 2 i at index i), the odd map from base +
// 128 B (column 2 i + 1). A stride argument of make_map gives them; TMA's
// elementStrides = 2 would load every other pixel of one box instead, but
// its box then counts the skipped pixels and both phases would need
// separate boxes all the same. For 64 output pixels from ox0 both boxes
// start at phase index ox0 - 1, 72 pixels wide, so that
// - tap dx = 1 (column 2 ox) reads the even box from pixel 1,
// - taps dx = 0 and 2 (columns 2 ox -/+ 1) read the odd box from pixels 0
//   and 1,
// each through the core's shifted descriptor (conv_wgmma.cuh: the start
// moved 128 B a pixel, base offset 0). The reflected border is only column
// -1 and row -1 (the last output reads column W - 1 and row H - 1): TMA
// zero-fills odd index -1 and row -1, and the consuming warpgroup copies
// odd index 0 (column 1) and row 1 over them before its products.
// Shared memory is what shapes the rest: a stage for the core's tile of 2
// output rows would be 5 input rows x 2 phases x 72 px x 128 B = 92,160 B,
// and two of them beside the resident weights do not fit. So a stage is one
// output row's 3 input rows (55,296 B), and each warpgroup owns one stage
// and walks its own items (1 output row x 64 pixels): land, patch, 36
// wgmma m64n64k16, drain, reload the stage at once, then the epilogue (bias,
// round, the core's staging row and TMA store) under the load and the other
// warpgroup's products.
// Shared memory: 1024 + 73,728 (weights) + 2 x 55,296 + 2 x 8,192 =
// 201,728 B of the 232,448 a block may use.
//
// The head (head_kernel<CS>), on the wide core's stream: work items are the
// core's tiles (2 rows x 64 pixels, one m64n64 row product a warpgroup; the
// 64 outputs are one N slice). K = 2 CS is walked in 64-channel slices k
// from two tensor maps: x's CS / 64 slices, then skip's; within a slice in
// tap rows dy, each step (k, dy) the 12 products of taps (dy, 0..2) against
// a streamed (k, dy) weight slab (the wide core's ring and TMA box). The
// halo stages are the core's, reflect-patched on landing.
// - The 1x1 is a second accumulator fed by the centre tap of the same
//   stages: at each step (k, 1) four more products read the stage where tap
//   (1, 1) does, against the 1x1's resident 64 x 64 slab of slice k (2 CS x
//   64 bf16, 32 KB at CS = 128). x and skip are read once for both convs.
// - The source boundary is a compile-time step of the unrolled step loop:
//   after x's last step the warpgroup drains its products, rounds both
//   sums (the 3x3's plus ba) to packed bf16 in registers (16 a sum), and
//   skip's first step restarts both accumulators (scale_d = 0).
// - The epilogue writes h1 and r1, each through its own staging row and
//   TMA store, so the chain's h1 pass drops out.
// - Registers: two accumulators (64) and the two stashes (32); the biases
//   and tv1 are read from L1 where they are used. A tile's epilogue does
//   not overlap the next tile's products: that would hold a second pair of
//   accumulators (128 registers before the stashes).
// Shared memory at CS = 128: 1024 + 2 x 36,864 (halo stages) + 3 x 24,576
// (weight slabs) + 32,768 (the 1x1) + 2 x 2 x 8,192 (staging rows) =
// 214,016 B (a fourth weight slab would not fit).

#include <utility>

#include "conv_wgmma_wide.cuh"

using namespace dgmsr::cw;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BAR_OWN = 4;  // named barriers 4 + w: warpgroup w alone (2 + w are the core's epilogue's)

// f(std::integral_constant<int, I>) for I = 0 .. N - 1 in straight-line code.
template <class F, int... I>
__device__ __forceinline__ void unroll(F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

// v = rnd(s + bias): the Downsample's epilogue hook (conv_wgmma.cuh's stage_row).
struct Bias {
  static constexpr int NRES = 0;
  const float* bias;
  using Regs = BiasRegs;
  __device__ __forceinline__ Regs setup(int t, int n0) const { return bias_regs(bias + n0, t); }
  __device__ __forceinline__ uint32_t operator()(const Regs& r, int n, int, int, int, float s0, float s1, uint32_t,
                                                 uint32_t) const {
    return pack(s0 + r.b[2 * n], s1 + r.b[2 * n + 1]);
  }
};

// ---------------------------------------------------------- the Downsample
constexpr int DS_ROWS = 3;                                // input rows a stage: one output row's taps
constexpr uint32_t DS_PHASE_BYTES = DS_ROWS * ROW_BYTES;  // 27,648: one column phase's box
constexpr uint32_t DS_STAGE_BYTES = 2 * DS_PHASE_BYTES;   // 55,296
constexpr size_t DS_SMEM_BYTES = 1024 + W_BYTES + TH * DS_STAGE_BYTES + TH * OUT_BYTES;
static_assert(DS_SMEM_BYTES <= 232448, "more shared memory than a block may use");

// Issue (no wait) the 36 products of one output row at stride 2: tap (dy,
// dx) reads row dy of the stage's even phase from pixel 1 (dx = 1) or of
// its odd phase from pixel dx / 2 (dx = 0, 2); K-step kk moves 32 B into
// each 128-byte row. da: the stage; dw: tap 0's weights.
__device__ __forceinline__ void issue_ds(float (&acc)[32], uint64_t da, uint64_t dw) {
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    const uint32_t a = (dx == 1 ? 0 : DS_PHASE_BYTES) + dy * ROW_BYTES + (dx == 1 ? 1 : dx / 2) * PIX;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_m64n64(acc, da + ((a + kk * 32) >> 4), dw + ((tap * TAP_BYTES + kk * 32) >> 4), tap > 0 || kk > 0);
  }
  wgmma_commit();
}

// The reflected border of a Downsample stage, by the 128 threads of its
// warpgroup (tid its thread): row -1 (stage row 0, at oy = 0) from row 1
// (stage row 2), both phases; column -1 (odd pixel 0, at ox0 = 0) from
// column 1 (odd pixel 1). Each destination reads its reflected source,
// which is never a destination, 16 bytes a thread and step, both addresses
// swizzled (chunk c of pixel p at c ^ (p % 8)).
__device__ __forceinline__ void patch_ds(unsigned char* st, bool top, bool left, int tid) {
  auto copy = [&](int ph, int r, int p, int ch) {
    const int sr = top && r == 0 ? 2 : r, sp = left && ph == 1 && p == 0 ? 1 : p;
    unsigned char* base = st + ph * DS_PHASE_BYTES;
    const uint4 v = *reinterpret_cast<const uint4*>(base + sr * ROW_BYTES + sp * PIX + ((ch ^ (sp & 7)) << 4));
    *reinterpret_cast<uint4*>(base + r * ROW_BYTES + p * PIX + ((ch ^ (p & 7)) << 4)) = v;
  };
  if (top)
    for (int i = tid; i < 2 * HW * 8; i += 128) copy(i / (HW * 8), 0, (i >> 3) % HW, i & 7);
  if (left)
    for (int i = tid + (top ? 8 : 0); i < DS_ROWS * 8; i += 128) copy(1, i >> 3, 0, i & 7);
}

// ds_out (B, Ho, Wo, 64) = rnd(reflect_conv3x3_stride2(x) + bias) over x
// (B, 2 Ho, 2 Wo, 64). teven / todd: x's column phases in boxes (64, 72, 3,
// 1); tw: the (9, C_out, C_in) taps as (C_in, C_out, 9, 1) in boxes of one
// tap; tout: ds_out in boxes (64, 64, 1, 1). Warpgroup w of block k takes
// items k + (2 i + w) gridDim.x (item: output row oy of image b, pixels ox0
// .. ox0 + 63).
__global__ void __launch_bounds__(NT, 1)
    ds_kernel(const __grid_constant__ CUtensorMap teven, const __grid_constant__ CUtensorMap todd,
              const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tout, const Bias epi,
              int B, int Ho, int Wo) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_w, full[TH];
  const uint32_t base = smem_addr(smem_raw);
  unsigned char* sw = smem_raw + ((1024 - (base & 1023)) & 1023);  // 1024 B aligned: the swizzle atoms
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  unsigned char* st = sw + W_BYTES + wg * DS_STAGE_BYTES;             // the warpgroup's stage
  unsigned char* out = sw + W_BYTES + TH * DS_STAGE_BYTES + wg * OUT_BYTES;  // and its staging row

  const int tiles_x = (Wo + TM - 1) / TM;
  const int nitems = tiles_x * Ho * B;  // the launcher keeps it below 2^30
  const int step = TH * (int)gridDim.x;
  const bool leader = tid == 0;  // loads the warpgroup's stage and stores its row
  auto coords = [&](int item, int& b, int& oy, int& ox0) {
    ox0 = (item % tiles_x) * TM;
    const int row = item / tiles_x;
    oy = row % Ho;
    b = row / Ho;
  };
  auto load = [&](int item) {
    int b, oy, ox0;
    coords(item, b, oy, ox0);
    mbar_expect(&full[wg], DS_STAGE_BYTES);
    tma_load(&teven, st, &full[wg], 0, ox0 - 1, 2 * oy - 1, b);
    tma_load(&todd, st + DS_PHASE_BYTES, &full[wg], 0, ox0 - 1, 2 * oy - 1, b);
  };
  if (threadIdx.x == 0) {
    mbar_init(&bar_w, 1);
    for (int w = 0; w < TH; ++w) mbar_init(&full[w], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bar_w, W_BYTES);
    for (int tap = 0; tap < 9; ++tap) tma_load(&tw, sw + tap * TAP_BYTES, &bar_w, 0, 0, tap, 0);
  }
  __syncthreads();
  const int first = (int)blockIdx.x + wg * (int)gridDim.x;
  if (leader && first < nitems) load(first);
  const Bias::Regs regs = epi.setup(threadIdx.x & 3, 0);
  const uint64_t dw = desc(sw, 16, 1024);
  const uint64_t da = desc(st, 16, 1024);
  mbar_wait_warp(&bar_w, 0);
  int i = 0;
  for (int item = first; item < nitems; item += step, ++i) {
    int b, oy, ox0;
    coords(item, b, oy, ox0);
    mbar_wait_warp(&full[wg], i & 1);
    if (oy == 0 || ox0 == 0) {  // the same for the whole warpgroup
      patch_ds(st, oy == 0, ox0 == 0, tid);
      fence_async_smem();
      named_sync(BAR_OWN + wg, 128);
      __syncwarp();  // converged for the .aligned wgmma ops
    }
    float acc[32];
    issue_ds(acc, da, dw);
    wgmma_wait<0>();
    fence_regs(acc);
    if (leader) bulk_wait_read<0>();  // the previous store is done reading the staging row
    named_sync(BAR_OUT + wg, 128);    // every thread's products are done: the stage is free
    if (leader && item + step < nitems) load(item + step);
    stage_row(epi, regs, acc, out, nullptr, b, oy, ox0);
    fence_async_smem();
    named_sync(BAR_OUT + wg, 128);
    if (leader) {
      tma_store(&tout, out, 0, ox0, oy, b);
      bulk_commit();
    }
    __syncwarp();
  }
  if (leader) bulk_wait<0>();
}

// x: (B, H, W, 64) bf16, H and W even; w: (9, C_out, C_in) bf16; bias (64,)
// float32; ds_out (B, H / 2, W / 2, 64) bf16; all 16-byte aligned.
int launch_ds(const void* x, const void* w, const float* bias, void* ds_out, int B, int H, int W, cudaStream_t s) {
  static int nsm = 0;
  if (nsm == 0) {
    cudaError_t err = cudaFuncSetAttribute(ds_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)DS_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  }
  if (B <= 0 || H < 2 || W < 2 || H % 2 || W % 2) return (int)cudaErrorInvalidValue;
  const int Ho = H / 2, Wo = W / 2;
  const long items = (long)B * Ho * ((Wo + TM - 1) / TM);
  if (items >= (1L << 30)) return (int)cudaErrorInvalidValue;
  CUtensorMap teven, todd, tw, tout;
  int rc = make_map(&teven, x, B, H, W, HW, DS_ROWS, C, 2);
  if (!rc) rc = make_map(&todd, static_cast<const unsigned char*>(x) + PIX, B, H, W, HW, DS_ROWS, C, 2);
  if (!rc) rc = make_map(&tw, w, 1, 9, C, C, 1);  // the weights as (C_in, C_out, 9 taps, 1)
  if (!rc) rc = make_map(&tout, ds_out, B, Ho, Wo, TM, 1);
  if (rc) return rc;
  const unsigned grid = (unsigned)(items < nsm ? items : nsm);
  ds_kernel<<<grid, NT, DS_SMEM_BYTES, s>>>(teven, todd, tw, tout, Bias{bias}, B, Ho, Wo);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- the head
constexpr int HD_XSTAGES = 2;  // K-slice halo boxes in the ring
constexpr int HD_WSTAGES = 3;  // (K slice, tap row) weight slabs in the ring
template <int CS> constexpr size_t head_smem() {
  return 1024 + HD_XSTAGES * STAGE_BYTES + HD_WSTAGES * SLAB_BYTES + 2 * CS / 64 * TAP_BYTES + 2 * TH * OUT_BYTES;
}

struct HeadArgs {
  const float* ba;   // (64,) the 3x3's bias
  const float* br;   // (64,) the 1x1's bias
  const float* tv1;  // (B, 64) the time vector added to h1
};

// The 4 products of the 1x1 for one output row and K slice: the stage's
// centre tap (halo row w + 1 from pixel 1; a: halo row w) against the 1x1's
// slab of the slice (b). FIRST: the part's first slice, which overwrites.
template <bool FIRST, int KK = 0>
__device__ __forceinline__ void centre_products(float (&acc)[32], uint32_t a, uint32_t b) {
  constexpr int AOFF = (ROW_BYTES + PIX + KK * 32) >> 4, BOFF = (KK * 32) >> 4;
  mma_wide<AOFF, BOFF>(acc, a, b, !FIRST || KK > 0);
  if constexpr (KK < 3) centre_products<FIRST, KK + 1>(acc, a, b);
}

// h1 and r1 (B, H, W, 64) from x and skip (B, H, W, CS). tx / tskip: x and
// skip in halo boxes (64, 72, 4, 1) at channel 64 k; tw: the 3x3's (9,
// C_out, 2 CS) taps as (2 CS, C_out, 9, 1) in slabs (64, 64, 3, 1); twr: the
// 1x1's (C_out, 2 CS) as (2 CS, C_out, 1, 1) in boxes (64, 64, 1, 1); th1 /
// tr1: the outputs in boxes (64, 64, 1, 1). Block k takes tiles k + j
// gridDim.x.
template <int CS>
__global__ void __launch_bounds__(NT, 1)
    head_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tskip,
                const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap twr,
                const __grid_constant__ CUtensorMap th1, const __grid_constant__ CUtensorMap tr1,
                const HeadArgs args, int B, int H, int W) {
  constexpr int KX = CS / 64;  // K slices of each source
  constexpr int KS = 2 * KX;   // K slices
  constexpr int S = 3 * KS;    // (k, dy) steps a tile
  constexpr int XS = HD_XSTAGES, WS = HD_WSTAGES;
  static_assert(CS == 64 || CS == 128, "the head kernel takes C_s = 64, 128");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t xfull[XS], xempty[XS], wfull[WS], wempty[WS], bar_wr;
  const uint32_t base = smem_addr(smem_raw);
  unsigned char* sx = smem_raw + ((1024 - (base & 1023)) & 1023);  // slice stage s at s * STAGE_BYTES
  unsigned char* sw = sx + XS * STAGE_BYTES;                        // weight slab s at s * SLAB_BYTES
  unsigned char* swr = sw + WS * SLAB_BYTES;                        // the 1x1's slab k at k * TAP_BYTES
  unsigned char* so = swr + KS * TAP_BYTES;                         // warpgroup w's h1 row at w * OUT_BYTES,
  unsigned char* sr = so + TH * OUT_BYTES;                          // its r1 row at w * OUT_BYTES

  // 32-bit tile arithmetic (the launcher keeps the tile count below 2^30)
  const int tiles_x = (W + TM - 1) / TM, tiles_y = (H + TH - 1) / TH;
  const int per_image = tiles_x * tiles_y;
  const int ntiles = per_image * B;
  const int n = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;  // >= 1: grid <= ntiles
  const int nx = n * KS, nw = n * S;  // slices and slabs the block loads
  auto coords = [&](int j, int& b, int& y0, int& x0) {
    const int tile = (int)blockIdx.x + j * (int)gridDim.x;
    b = tile / per_image;
    const int rem = tile - b * per_image;
    y0 = (rem / tiles_x) * TH;
    x0 = (rem % tiles_x) * TM;
  };
  const bool loader = threadIdx.x == 0;  // the one thread that issues the loads
  // Slice i (tile i / KS, K slice k = i % KS: x's channels 64 k, or skip's
  // 64 (k - KX)) into its stage once all threads released slice i - XS there.
  auto load_x = [&](int i) {
    const int s = i % XS, k = i % KS;
    mbar_wait(&xempty[s], ((i / XS) & 1) ^ 1);
    mbar_expect(&xfull[s], STAGE_BYTES);
    int b, y0, x0;
    coords(i / KS, b, y0, x0);
    if (k < KX) tma_load(&tx, sx + s * STAGE_BYTES, &xfull[s], 64 * k, x0 - 1, y0 - 1, b);
    else tma_load(&tskip, sx + s * STAGE_BYTES, &xfull[s], 64 * (k - KX), x0 - 1, y0 - 1, b);
  };
  // Slab q (step r = q % S: K slice r / 3, tap row r % 3).
  auto load_w = [&](int q) {
    const int s = q % WS, r = q % S;
    mbar_wait(&wempty[s], ((q / WS) & 1) ^ 1);
    mbar_expect(&wfull[s], SLAB_BYTES);
    tma_load(&tw, sw + s * SLAB_BYTES, &wfull[s], 64 * (r / 3), 0, 3 * (r % 3), 0);
  };
  if (loader) {
    for (int s = 0; s < XS; ++s) {
      mbar_init(&xfull[s], 1);
      mbar_init(&xempty[s], NT);
    }
    for (int s = 0; s < WS; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], NT);
    }
    mbar_init(&bar_wr, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bar_wr, KS * TAP_BYTES);
    for (int k = 0; k < KS; ++k) tma_load(&twr, swr + k * TAP_BYTES, &bar_wr, 64 * k, 0, 0, 0);
    for (int i = 0; i < XS; ++i) load_x(i);  // nx >= KS >= XS
    for (int q = 0; q < WS; ++q) load_w(q);  // nw >= S > WS
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;  // issues the warpgroup's stores
  const uint32_t dx0 = desc_lo(sx + wg * ROW_BYTES);  // slice stage 0, halo row wg
  const uint32_t dw0 = desc_lo(sw);
  const uint32_t dwr0 = desc_lo(swr);
  unsigned char* h1row = so + wg * OUT_BYTES;
  unsigned char* r1row = sr + wg * OUT_BYTES;
  // Wait for slice i's stage and patch its reflected border.
  auto land_x = [&](int i) {
    const int s = i % XS;
    mbar_wait_warp(&xfull[s], (i / XS) & 1);
    int b, y0, x0;
    coords(i / KS, b, y0, x0);
    if (x0 == 0 || x0 + TM >= W || y0 == 0 || y0 + TH >= H) {  // the same for the whole block
      patch_reflect(sx + s * STAGE_BYTES, y0, x0, H, W);
      fence_async_smem();
      named_sync(BAR_PATCH, NT);
      __syncwarp();  // converged for the .aligned wgmma ops
    }
  };
  // Step q's products are done: release its slab (and its slice, after the
  // slice's last step) and load the stages' next contents.
  auto release = [&](int q, bool slice_done) {
    const int i = q / 3;  // q = j S + 3 k + dy and i = j KS + k
    mbar_arrive(&wempty[q % WS]);
    if (slice_done) mbar_arrive(&xempty[i % XS]);
    if (loader) {
      if (q + WS < nw) load_w(q + WS);
      if (slice_done && i + XS < nx) load_x(i + XS);
    }
    __syncwarp();
  };

  float acc[32], accr[32];   // the 3x3's and the 1x1's sums of the current source
  uint32_t sx3[16], sxr[16];  // x's part of each, rounded (the 3x3's with ba), packed bf16
  mbar_wait_warp(&bar_wr, 0);
  for (int j = 0; j < n; ++j) {
    unroll(
        [&](auto stc) {
          constexpr int ST = decltype(stc)::value, K = ST / 3, DY = ST % 3;
          constexpr bool FIRST = K % KX == 0 && DY == 0;  // a source's first step: both sums restart
          const int q = j * S + ST, i = j * KS + K;
          if constexpr (DY == 0) land_x(i);
          mbar_wait_warp(&wfull[q % WS], (q / WS) & 1);
          const uint32_t da = dx0 + (i % XS) * (STAGE_BYTES >> 4);
          wgmma_fence();
          step_products<FIRST, DY>(acc, da, dw0 + (q % WS) * (SLAB_BYTES >> 4));
          if constexpr (DY == 1) centre_products<K % KX == 0>(accr, da, dwr0 + K * (TAP_BYTES >> 4));
          wgmma_commit();
          if constexpr (!FIRST) {
            wgmma_wait<1>();
            release(q - 1, DY == 0);
          }
          if constexpr (ST == 3 * KX - 1) {  // x's last step: drain, round and stash both sums
            wgmma_wait<0>();
            fence_regs(acc);
            fence_regs(accr);
            release(q, true);
#pragma unroll
            for (int m = 0; m < 8; ++m) {
              const float2 bv = __ldg(reinterpret_cast<const float2*>(args.ba + 8 * m + 2 * t));
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                sx3[2 * m + h] = pack(acc[4 * m + 2 * h] + bv.x, acc[4 * m + 2 * h + 1] + bv.y);
                sxr[2 * m + h] = pack(accr[4 * m + 2 * h], accr[4 * m + 2 * h + 1]);
              }
            }
          }
        },
        std::make_integer_sequence<int, S>{});
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(accr);
    release(j * S + S - 1, true);

    // The epilogue: h1 and r1 at the warpgroup's output row, pixels x0 +
    // m (m = 16 warp + g + 8 h), channels 8 m' + 2 t, + 1, into the
    // swizzled staging rows (chunk m' at m' ^ (m % 8)), then one TMA store
    // each (clipped at W and H).
    int b, y0, x0;
    coords(j, b, y0, x0);
    if (leader) bulk_wait_read<0>();  // the previous stores are done reading the staging rows
    named_sync(BAR_OUT + wg, 128);
    const float* tv = args.tv1 + b * C;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const float2 tv1 = __ldg(reinterpret_cast<const float2*>(tv + 8 * m + 2 * t));
      const float2 br = __ldg(reinterpret_cast<const float2*>(args.br + 8 * m + 2 * t));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = (warp * 16 + g + 8 * h) * PIX + ((m ^ g) << 4) + 4 * t;
        const float2 px = unpack(sx3[2 * m + h]), ps = unpack(pack(acc[4 * m + 2 * h], acc[4 * m + 2 * h + 1]));
        const float2 a = unpack(pack(px.x + ps.x, px.y + ps.y));  // a_pre
        *reinterpret_cast<uint32_t*>(h1row + off) = pack(mish(a.x) + tv1.x, mish(a.y) + tv1.y);
        const float2 rx = unpack(sxr[2 * m + h]), rs = unpack(pack(accr[4 * m + 2 * h], accr[4 * m + 2 * h + 1]));
        const float2 r = unpack(pack(rx.x + rs.x, rx.y + rs.y));
        *reinterpret_cast<uint32_t*>(r1row + off) = pack(r.x + br.x, r.y + br.y);
      }
    }
    fence_async_smem();
    named_sync(BAR_OUT + wg, 128);
    if (leader) {
      tma_store(&th1, h1row, 0, x0, y0 + wg, b);
      tma_store(&tr1, r1row, 0, x0, y0 + wg, b);
      bulk_commit();
    }
    __syncwarp();
  }
  if (leader) bulk_wait<0>();
}

// x, skip: (B, H, W, CS) bf16; wa: (9, 64, 2 CS) bf16 taps (x's input
// channels, then skip's); wr: (64, 2 CS) bf16; h1, r1: (B, H, W, 64) bf16;
// all 16-byte aligned.
template <int CS>
int launch_head(const void* x, const void* skip, const void* wa, const void* wr, const HeadArgs& args, void* h1,
                void* r1, int B, int H, int W, cudaStream_t s) {
  auto kern = head_kernel<CS>;
  constexpr size_t smem = head_smem<CS>();
  static_assert(smem <= 232448, "more shared memory than a block may use");
  static int nsm = 0;  // per instantiation
  if (nsm == 0) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  }
  if (B <= 0 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const long tiles = (long)B * ((H + TH - 1) / TH) * ((W + TM - 1) / TM);
  if (tiles >= (1L << 30)) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tskip, tw, twr, th1, tr1;
  int rc = make_map(&tx, x, B, H, W, HW, HH, CS);
  if (!rc) rc = make_map(&tskip, skip, B, H, W, HW, HH, CS);
  if (!rc) rc = make_map(&tw, wa, 1, 9, C, 64, 3, 2 * CS);  // the taps as (2 CS, C_out, 9, 1)
  if (!rc) rc = make_map(&twr, wr, 1, 1, C, 64, 1, 2 * CS);  // the 1x1 as (2 CS, C_out, 1, 1)
  if (!rc) rc = make_map(&th1, h1, B, H, W, TM, 1);
  if (!rc) rc = make_map(&tr1, r1, B, H, W, TM, 1);
  if (rc) return rc;
  const unsigned grid = (unsigned)(tiles < nsm ? tiles : nsm);
  kern<<<grid, NT, smem, s>>>(tx, tskip, tw, twr, th1, tr1, args, B, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The Downsample: dtype 1 (bfloat16) only. out is (B, H, W, 64), H and W
// even; wds is (9, C_out, C_in) bf16; bds (64,) float32; ds_out is written
// as (B, H / 2, W / 2, 64). Returns cudaGetLastError() after the launch.
int dgmsr_ds_wgmma(int dtype, const void* out, const void* wds, const void* bds, void* ds_out, int B, int H, int W,
                   void* stream) {
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return launch_ds(out, wds, static_cast<const float*>(bds), ds_out, B, H, W, static_cast<cudaStream_t>(stream));
}

// The head writing the chain's h1 and r1: dtype 1 (bfloat16) and cs 64 or
// 128. x and skip are (B, H, W, cs); wa is (9, 64, 2 cs) bf16 (x's input
// channels first); wr (64, 2 cs) bf16; ba, br (64,) and tv1 (B, 64)
// float32; h1 and r1 are written as (B, H, W, 64). Returns
// cudaGetLastError() after the launch.
int dgmsr_head_wgmma(int dtype, const void* x, const void* skip, const void* wa, const void* ba, const void* wr,
                     const void* br, const void* tv1, void* h1, void* r1, int cs, int B, int H, int W,
                     void* stream) {
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const HeadArgs args{f(ba), f(br), f(tv1)};
  auto s = static_cast<cudaStream_t>(stream);
  switch (cs) {
    case 64: return launch_head<64>(x, skip, wa, wr, args, h1, r1, B, H, W, s);
    case 128: return launch_head<128>(x, skip, wa, wr, args, h1, r1, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
