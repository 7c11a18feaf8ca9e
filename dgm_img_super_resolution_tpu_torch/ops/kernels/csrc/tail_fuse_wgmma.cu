// The UNet tail region in bf16 at C = 64, by hand for Hopper (sm_90a), on
// warpgroup MMA fed by TMA: a ConvT written over the helpers of the conv core
// (conv_wgmma.cuh), then the core's reflect 3x3 with a hook that folds Mish
// and the 1x1 conv into its epilogue.
//
// Replaces, for bfloat16 at C = 64 and out_dim (cout) up to 8,
// dgm_img_super_resolution_tpu/ops/pallas/tail_fuse.py:_tail_fuse_pallas, as
// tail_reference defines it:
//   y   = rnd(convT_k4s2p1(x) + bt)          (C -> C, zero border, 2x up)
//   m   = rnd(mish(rnd(reflect_conv3x3(y) + bf)))
//   out = rnd(m . wo + bo)                    (1x1, C -> cout)
// float32, and cout above 8, stay on tail_fuse.cu's tiled conv
// (conv_tile.cuh): routing by dtype and shape, in ops/kernels/tail_fuse.py.
//
// Bound on the card: at B=8, x 256x256 -> out 512x512 the region is 224
// GFLOP against 80 MB of unavoidable traffic, so the tensor cores bound it
// (0.227 ms at 989 TFLOP/s). This design's own floor is higher: y (B, 2H, 2W,
// 64) goes through device memory between the two launches, 268 MB written
// and read again (0.16 ms at 3.35 TB/s). Keeping y on chip in one launch is
// a later step.
//
// Launch 1, the ConvT (convt_kernel). Output pixel (2j + a, 2l + b) is phase
// (a, b): the sum over taps (u, v) of W[a, b, u, v] (C_out, C_in) times input
// pixel (j - 1 + a + u, l - 1 + b + v), zero outside the image
// (ops/kernels/tail_fuse.py: convt_phase_taps). For one phase, 64
// consecutive output pixels of one column phase read 64 consecutive input
// pixels, so the core's shifted descriptor serves each tap as it stands:
// - Persistent grid of two-warpgroup blocks, one row phase a a block (block
//   index parity), whose 8 taps (2 column phases x 4) stay in shared memory
//   (65,536 B, loaded by TMA 128-byte swizzled as the core's taps).
// - Tile: input rows j, j + 1 (one a warpgroup) x 64 input columns from l0
//   -> output rows 2j + a and 2j + 2 + a, 128 pixels each from 2 l0.
// - Stage: one TMA box of 64 channels x 72 pixels x 3 input rows from
//   (l0 - 1, j - 1 + a): the rows both warpgroups' taps read (the core's
//   box has 4; the fourth would be loaded for nothing). TMA fills what lies
//   outside the image with zeros, the ConvT's border. A ring of 3 stages
//   (27,648 B each), loaded by thread 0 three tiles ahead.
// - Products: column phase b of warpgroup w is one m64n64 product with K = 4
//   taps x 64: tap (u, v) reads halo row w + u from pixel b + v (the
//   descriptor's start moved 128 (b + v) bytes), 16 wgmma m64n64k16.
// - Overlap: the unit of the pipeline is a (tile, column phase): one m64n64
//   accumulator, so two in flight take the core's 64 registers, not the 128
//   of two whole tiles. Phase 1 of tile j runs under phase 0's epilogue,
//   phase 0 of tile j + 1 under phase 1's. Each epilogue writes its 64
//   pixels, bias added and rounded, into the even (b = 0) or odd (b = 1)
//   pixels of a 128-pixel swizzled staging row (16,384 B); after phase 1 one
//   TMA store of 128 pixels x 128 B writes the row, clipped at 2W. Two
//   staging rows a warpgroup, so that a row's store has a whole tile to read
//   it before the row is written again.
// - Straight-line wgmma as in the core: none under a branch (C7518), none in
//   flight across the loop's back edge (C7514).
// Shared memory: 1024 + 65,536 + 3 x 27,648 + 2 x 2 x 16,384 = 215,040 B.
//
// Launch 2: the core's reflect C = 64 conv over y (conv_wgmma.cuh, row 6's
// instance, weights K.conv_taps) with the Tail hook, which stores for itself
// (Epi::STORES): bias, Mish and the 1x1 in registers, 6 bytes a pixel at
// cout = 3 (no TMA box: its inner dimension must be 16 bytes at least). The
// 1x1 is f32 FMAs: a second wgmma in the epilogue would queue behind the
// next tile's products on the tensor cores, which the epilogue overlaps.

#include "conv_wgmma.cuh"

using namespace dgmsr::cw;

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- the ConvT
constexpr int CT_HH = 3;                                // input rows a stage
constexpr uint32_t CT_STAGE_BYTES = CT_HH * ROW_BYTES;  // 27,648
constexpr uint32_t CT_W_BYTES = 8 * TAP_BYTES;          // 65,536: a row phase's 2 column phases x 4 taps
constexpr int CT_OUT_PIX = 2 * TM;                      // 128 output pixels a warpgroup row
constexpr uint32_t CT_OUT_BYTES = CT_OUT_PIX * PIX;     // 16,384
constexpr int CT_BUFS = 2;                              // staging rows a warpgroup
constexpr size_t CT_SMEM_BYTES = 1024 + CT_W_BYTES + STAGES * CT_STAGE_BYTES + TH * CT_BUFS * CT_OUT_BYTES;
static_assert(CT_SMEM_BYTES <= 232448, "more shared memory than a block may use");

// Issue (no wait) the 16 products of column phase PB of one warpgroup's
// row: tap (u, v) = (tap / 2, tap % 2) reads halo row u of the warpgroup's
// rows from pixel PB + v, with the row phase's weights 4 PB + tap; K-step kk
// moves 32 B into each 128-byte row. da: the stage's halo row w; dw: the row
// phase's first tap.
template <int PB>
__device__ __forceinline__ void issue_phase(float (&acc)[32], uint64_t da, uint64_t dw) {
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < 4; ++tap)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_m64n64(acc, da + (((tap >> 1) * ROW_BYTES + (PB + (tap & 1)) * PIX + kk * 32) >> 4),
                 dw + (((4 * PB + tap) * TAP_BYTES + kk * 32) >> 4), tap > 0 || kk > 0);
  wgmma_commit();
}

// Column phase PB of one warpgroup's accumulator, + bias and rounded, into
// its 128-pixel staging row: input pixel i is output pixel m = 2 i + PB, at
// m * 128 B with channel chunk n at n ^ (m % 8), as the TMA store reads it.
template <int PB>
__device__ __forceinline__ void stage_phase(const BiasRegs& r, const float (&acc)[32], unsigned char* out) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 2 * (warp * 16 + g + 8 * h) + PB;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(out + m * PIX + ((n ^ (m & 7)) << 4) + 4 * t) =
          pack(acc[4 * n + 2 * h] + r.b[2 * n], acc[4 * n + 2 * h + 1] + r.b[2 * n + 1]);
  }
}

// y = rnd(convT_k4s2p1(x) + bias) over NHWC x (B, H, W, 64) -> y (B, 2H, 2W,
// 64). tin: x in boxes (64, 72, 3, 1); tw: the (16 taps, C_out, C_in)
// weights as (C_in, C_out, 16, 1) in boxes of one tap; tout: y in boxes
// (64, 128, 1, 1). Block k takes row phase k % 2 and tiles k / 2 + i *
// gridDim.x / 2 of that phase.
__global__ void __launch_bounds__(NT, 1)
    convt_kernel(const __grid_constant__ CUtensorMap tin, const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap tout, const float* __restrict__ bias, int B, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_w, full[STAGES], empty[STAGES];
  const uint32_t base = smem_addr(smem_raw);
  unsigned char* sw = smem_raw + ((1024 - (base & 1023)) & 1023);  // 1024 B aligned: the swizzle atoms
  unsigned char* sx = sw + CT_W_BYTES;                              // stage s at s * CT_STAGE_BYTES
  unsigned char* so = sx + STAGES * CT_STAGE_BYTES;                 // warpgroup w's rows at 2 w * CT_OUT_BYTES

  const int a = blockIdx.x & 1;  // the block's row phase
  const int blk = blockIdx.x >> 1, nblk = gridDim.x >> 1;
  const int tiles_x = (W + TM - 1) / TM, tiles_y = (H + TH - 1) / TH;
  const long per_image = (long)tiles_x * tiles_y;
  const long ntiles = per_image * B;
  const int n = (int)((ntiles - blk + nblk - 1) / nblk);  // >= 1: the launcher keeps nblk <= ntiles
  auto coords = [&](int j, int& b, int& y0, int& x0) {
    const long tile = blk + (long)j * nblk;
    b = (int)(tile / per_image);
    const int rem = (int)(tile - b * per_image);
    y0 = (rem / tiles_x) * TH;
    x0 = (rem % tiles_x) * TM;
  };
  const bool loader = threadIdx.x == 0;
  // Tile j into stage j % STAGES once all threads released tile j - STAGES there.
  auto load = [&](int j) {
    const int s = j % STAGES;
    mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
    mbar_expect(&full[s], CT_STAGE_BYTES);
    int b, y0, x0;
    coords(j, b, y0, x0);
    tma_load(&tin, sx + s * CT_STAGE_BYTES, &full[s], 0, x0 - 1, y0 - 1 + a, b);
  };
  if (loader) {
    mbar_init(&bar_w, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bar_w, CT_W_BYTES);
    for (int tap = 0; tap < 8; ++tap) tma_load(&tw, sw + tap * TAP_BYTES, &bar_w, 0, 0, 8 * a + tap, 0);
    for (int j = 0; j < STAGES && j < n; ++j) load(j);
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const bool leader = (threadIdx.x & 127) == 0;  // issues the warpgroup's stores
  const BiasRegs regs = bias_regs(bias, threadIdx.x & 3);
  const uint64_t dw = desc(sw, 16, 1024);
  const uint64_t dx = desc(sx + wg * ROW_BYTES, 16, 1024);
  constexpr uint64_t stage_step = CT_STAGE_BYTES >> 4;
  auto stage_desc = [&](int j) { return dx + (j % STAGES) * stage_step; };
  auto land = [&](int j) { mbar_wait_warp(&full[j % STAGES], (j / STAGES) & 1); };
  auto row = [&](int j) { return so + (wg * CT_BUFS + (j & 1)) * CT_OUT_BYTES; };
  // Tile j's even output pixels into its staging row, once the store that
  // read that row two tiles before is done (one bulk group a tile).
  auto finish0 = [&](int j, const float(&acc)[32]) {
    if (leader) bulk_wait_read<CT_BUFS - 1>();
    named_sync(BAR_OUT + wg, 128);
    stage_phase<0>(regs, acc, row(j));
  };
  // Release tile j's stage (both phases' products are done), add its odd
  // pixels and store the row: output row 2 (y0 + w) + a from pixel 2 x0,
  // nothing past the image's last row (odd H); then load tile j + STAGES.
  auto finish1 = [&](int j, const float(&acc)[32]) {
    mbar_arrive(&empty[j % STAGES]);
    stage_phase<1>(regs, acc, row(j));
    fence_async_smem();
    named_sync(BAR_OUT + wg, 128);
    if (leader) {
      int b, y0, x0;
      coords(j, b, y0, x0);
      if (y0 + wg < H) tma_store(&tout, row(j), 0, 2 * x0, 2 * (y0 + wg) + a, b);
      bulk_commit();  // empty past the last row, so that every tile commits one group
    }
    if (loader && j + STAGES < n) load(j + STAGES);
    __syncwarp();
  };

  float acc0[32], acc1[32];
  mbar_wait_warp(&bar_w, 0);
  land(0);
  issue_phase<0>(acc0, stage_desc(0), dw);
  wgmma_wait<0>();
  fence_regs(acc0);
  for (int j = 0; j + 1 < n; ++j) {
    issue_phase<1>(acc1, stage_desc(j), dw);
    finish0(j, acc0);
    wgmma_wait<0>();
    fence_regs(acc1);
    land(j + 1);
    issue_phase<0>(acc0, stage_desc(j + 1), dw);
    finish1(j, acc1);
    wgmma_wait<0>();
    fence_regs(acc0);
  }
  issue_phase<1>(acc1, stage_desc(n - 1), dw);
  finish0(n - 1, acc0);
  wgmma_wait<0>();
  fence_regs(acc1);
  finish1(n - 1, acc1);
  if (leader) bulk_wait<0>();
}

// x: (B, H, W, 64) bf16; wt: (16 = 4 phases x 4 taps, C_out, C_in) bf16;
// bias: (64,) float32; y: (B, 2H, 2W, 64) bf16; all 16-byte aligned.
int launch_convt(const void* x, const void* wt, const float* bias, void* y, int B, int H, int W, cudaStream_t s) {
  static int nsm = 0;
  if (nsm == 0) {
    cudaError_t err = cudaFuncSetAttribute(convt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)CT_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  }
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tin, tw, tout;
  int rc = make_map(&tin, x, B, H, W, HW, CT_HH);
  if (!rc) rc = make_map(&tw, wt, 1, 16, C, C, 1);  // the weights as (C_in, C_out, 16 taps, 1)
  if (!rc) rc = make_map(&tout, y, B, 2 * H, 2 * W, CT_OUT_PIX, 1);
  if (rc) return rc;
  const long ntiles = (long)B * ((H + TH - 1) / TH) * ((W + TM - 1) / TM);  // of each row phase
  const long per_phase = nsm / 2 < ntiles ? nsm / 2 : ntiles;
  convt_kernel<<<(unsigned)(2 * per_phase), NT, CT_SMEM_BYTES, s>>>(tin, tw, tout, bias, B, H, W);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- the 3x3's epilogue hook
// m = rnd(mish(rnd(s + bias))) at the thread's 16 channels (8 n + 2 t, + 1)
// of its 2 pixels (rows g and g + 8 of its warp's 16), each channel pair
// rounded by one packed conversion; then out = rnd(m . wo + bo) for CO
// output channels (the first cout of them real): the thread's partial dots
// over its 16 channels, completed over the quad (t = lane % 4, the four
// threads of a pixel) by two xor shuffles, which leave the same sum in all
// four. Lane t stores output channels t and t + 4 of both pixels. wo is
// read from L1 in the epilogue as bf16, 8 bytes for four outputs of a
// channel: ptxas hoists those loads, and as float32 they took it into
// spills. The bias stays in registers, as the core's other hooks keep it
// (read from L1 instead it was slower: tools/torch_port_tail_variants.py).
template <int CO> struct Tail {
  static constexpr int NRES = 0;
  static constexpr bool STORES = true;
  const float* bias;  // (64,) float32
  const bf16* wo;     // (64, CO) bf16, wo[c][o]; zero past cout
  const float* bo;    // (cout,) float32
  bf16* out;          // (B, H, W, cout)
  int cout;
  using Regs = BiasRegs;
  __device__ __forceinline__ Regs setup(int t, int) const { return bias_regs(bias, t); }
  __device__ __forceinline__ void store(const Regs& r, const float (&acc)[32], int b, int y, int x0, int H,
                                        int W) const {
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    float s[2][CO];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 0; o < CO; ++o) s[h][o] = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const uint2* w2 = reinterpret_cast<const uint2*>(wo + (8 * n + 2 * t) * CO);  // channels c, c + 1
      float w[2 * CO];
#pragma unroll
      for (int q = 0; q < CO / 2; ++q) {
        const uint2 u = __ldg(w2 + q);
        const float2 a = unpack(u.x), d = unpack(u.y);
        w[4 * q] = a.x, w[4 * q + 1] = a.y, w[4 * q + 2] = d.x, w[4 * q + 3] = d.y;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = unpack(pack(acc[4 * n + 2 * h] + r.b[2 * n], acc[4 * n + 2 * h + 1] + r.b[2 * n + 1]));
        const float2 m = unpack(pack(mish(v.x), mish(v.y)));
#pragma unroll
        for (int o = 0; o < CO; ++o) s[h][o] = fmaf(m.y, w[CO + o], fmaf(m.x, w[o], s[h][o]));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 0; o < CO; ++o) {
        s[h][o] += __shfl_xor_sync(0xffffffffu, s[h][o], 1);
        s[h][o] += __shfl_xor_sync(0xffffffffu, s[h][o], 2);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int x = x0 + warp * 16 + g + 8 * h;
      if (y >= H || x >= W) continue;
      bf16* p = out + ((size_t)(b * H + y) * W + x) * cout;
#pragma unroll
      for (int o = 0; o < CO; ++o)
        if ((o & 3) == t && o < cout) p[o] = __float2bfloat16_rn(s[h][o] + __ldg(bo + o));
    }
  }
};

// The 3x3 + Mish + 1x1 over y (B, H, W, 64) bf16 (H, W: y's) -> out (B, H,
// W, cout) bf16; wf (9, C_out, C_in) bf16; wo (64, CO) bf16.
int conv_mish_1x1(const void* y, const void* wf, const float* bf, const bf16* wo, const float* bo, void* out,
                  int cout, int B, int H, int W, cudaStream_t s) {
  if (cout < 1 || cout > 8 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  bf16* o = static_cast<bf16*>(out);
  return cout <= 4 ? launch_conv_wgmma<true>(y, wf, out, Tail<4>{bf, wo, bo, o, cout}, B, H, W, s)
                   : launch_conv_wgmma<true>(y, wf, out, Tail<8>{bf, wo, bo, o, cout}, B, H, W, s);
}

}  // namespace

extern "C" {

// The tail's two launches, for dtype 1 (bfloat16) at c = 64; any other dtype
// or width, or cout outside 1-8, returns cudaErrorInvalidValue. Each returns
// cudaGetLastError() after its launch.

// Launch 1: y = rnd(convT(x) + bt). x is (B, H, W, 64) NHWC, y (B, 2H, 2W,
// 64); wt is the ConvT weight as (4 phases, 4 taps, C_out, C_in) bf16; bt
// (64,) float32.
int dgmsr_convt_wgmma(int dtype, const void* x, const void* wt, const void* bt, void* y, int c, int B, int H, int W,
                      void* stream) {
  if (dtype != 1 || c != C) return (int)cudaErrorInvalidValue;
  return launch_convt(x, wt, static_cast<const float*>(bt), y, B, H, W, static_cast<cudaStream_t>(stream));
}

// Launch 2: out = rnd(rnd(mish(rnd(conv3x3(y) + bf))) . wo + bo) over y (B,
// H, W, 64), H, W >= 2, into out (B, H, W, cout). wf is the 3x3 weight as
// (9, C_out, C_in) bf16; wo (64, 4) bf16 for cout <= 4, (64, 8) above,
// wo[c][o], zero past cout; bf and bo float32.
int dgmsr_conv_mish_1x1_wgmma(int dtype, const void* y, const void* wf, const void* bf, const void* wo,
                              const void* bo, void* out, int c, int cout, int B, int H, int W, void* stream) {
  if (dtype != 1 || c != C) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  return conv_mish_1x1(y, wf, f(bf), static_cast<const bf16*>(wo), f(bo), out, cout, B, H, W,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
