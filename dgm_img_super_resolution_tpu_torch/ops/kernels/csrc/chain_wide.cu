// The UNet's ResnetBlock-pair chain at the wide stages (96 to 512 channels,
// in multiples of 32), by hand for Hopper (sm_90a).
//
// Routing by dtype and width (ops/kernels/block_chain.py): bfloat16 at C =
// 128, 192 and 256 runs on the warpgroup-MMA conv core instead
// (block_chain_wgmma.cu over conv_wgmma_wide.cuh); this kernel serves
// float32 at every width from 96 on, and bfloat16 at 96, 160, 224 and
// 288-512.
//
// Replaces the unpacked (9, C, C) mode of
// dgm_img_super_resolution_tpu/ops/pallas/block_chain.py:_block_chain3_pallas
// (block_chain.py:323-330: every C but 64), which the UNet runs for each
// ResnetBlock pair whose width DGMSR_CHAIN_C names. It computes what
// block_chain3_reference defines, as chain3 of block_chain.cu does at C = 64:
//   h1  = rnd(mish(a_pre) + tv1)
//   y1  = rnd(rnd(mish(conv_b(h1) + bb)) + r1)
//   h2  = rnd(mish(conv_c(y1) + bc) + tv2)
//   out = rnd(rnd(mish(conv_d(h2) + bd)) + y1) [then rnd(out + cond)]
// with conv_* the reflect-bordered 3x3 C -> C convs, each output rounded to
// the compute dtype with its bias, and rnd() rounding where the reference
// rounds. Three launches of one conv kernel: conv_b builds h1 in its input
// prologue, and every epilogue is fused into the conv that feeds it.
//
// Bound on the card: at the main path's shapes (B = 8, bf16) the three convs
// are 463.9 GFLOP at (C, H, W) = (128, 256, 256), 260.9 at (192, 128, 128)
// and 116.0 at (256, 64, 64), against 402.7 / 151.0 / 50.3 MB of unavoidable
// traffic (a_pre, r1 and out): the tensor cores bound them, 0.469 / 0.264 /
// 0.117 ms at 989 TFLOP/s.
//
// Design. The resident-weight conv of conv_tile.cuh does not scale: the nine
// taps' C x C bf16 weights are 295 KB at C = 128 and 1.18 MB at 256, against
// the 227 KB of shared memory a block may hold, and 4 warps holding all C
// outputs of an 8x16 tile would need C f32 accumulators a thread. So the
// conv tiles N and streams K:
// - a block computes one 8x16 output tile for NB output channels (NB = 64;
//   32 when C is an odd multiple of 32): 4 warps of 2 tile rows each, as
//   mma.sync m16n8k16 bf16 products with f32 accumulators (NB a thread), or
//   f32 FMAs in the same layout for the float32 instantiation;
// - it walks K in 32-channel slices of the input: for each it stages the
//   10x18-pixel halo tile (reflect border; conv_b's prologue applied as it
//   loads) and the nine taps' NB x 32 weights, then runs the nine taps;
// - the grid is (tiles x C / NB, B), the N slices of one tile next to each
//   other, so that an input tile read C / NB times is read from L2 after the
//   first. conv_b recomputes its prologue as often.
// Shared memory per block: bf16 60.5 KB (NB = 64), 3 blocks per SM; f32
// 108.9 KB, 2 blocks. One stage, no cp.async pipeline: the blocks resident
// on an SM overlap each other's loads and products. Registers (nvcc 12.8,
// -Xptxas -v; chip_smoke.py prints the report): bf16 NB = 64 uses 128 for
// conv_b and 162 for conv_c and conv_d, so registers too allow 3 blocks per
// SM; NB = 32 uses 96; no bf16 instantiation spills. The float32 ones, for
// the checks, use 96-168, and conv_d at NB = 64 spills 20 bytes.

#include "conv_tile.cuh"

using namespace dgmsr;

namespace {

constexpr int KS = 32;  // input channels per streamed K slice

struct WideArgs {
  const void* in;       // (B, H, W, C) input of the conv
  const void* w;        // (C / KS, 9, C_out, KS) weights in T, one slab per K slice
  const float* bias;    // (C,)
  const float* pro_tv;  // (B, C): input prologue in = rnd(mish(in) + pro_tv), or null
  const float* tv;      // (B, C) time vector of EPI_H2
  const void* res;      // (B, H, W, C) residual of EPI_Y1 / EPI_OUT
  const void* cond;     // (B, H, W, C) condition of EPI_OUT, or null
  void* out;            // (B, H, W, C)
  int H, W, C;
};

template <typename T, int NB, bool PRO, int EPI>
__global__ void __launch_bounds__(NT) chain_wide_kernel(const WideArgs a) {
  constexpr int CS = Traits<T, KS>::CS, VEC = Traits<T, KS>::VEC, CH = KS / VEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);  // 9 taps x NB output channels x CS
  T* sx = sw + 9 * NB * CS;                // HALO_H x HALO_W pixels x CS

  const int C = a.C, H = a.H, W = a.W;
  const int nslices = C / NB;
  const int tile = blockIdx.x / nslices, n0 = (blockIdx.x - tile * nslices) * NB;
  const int tiles_x = (W + TW - 1) / TW;
  const int y0 = (tile / tiles_x) * TH, x0 = (tile % tiles_x) * TW;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const T* in = reinterpret_cast<const T*>(a.in);

  float acc[2][NB / 8][4];
  zero_acc<NB>(acc);
#pragma unroll 1
  for (int k = 0; k < C / KS; ++k) {
    __syncthreads();  // every warp is done with the previous slice
    load_tile<T, KS, HALO_H, HALO_W, true, PRO>(sx, in, a.pro_tv, b, y0 - 1, x0 - 1, H, W, C, k * KS);
    const T* wg = reinterpret_cast<const T*>(a.w) + ((size_t)k * 9 * C + n0) * KS;
    for (int idx = threadIdx.x; idx < 9 * NB * CH; idx += NT) {
      const int row = idx / CH, ch = idx - row * CH;  // row = tap * NB + n
      const int tap = row / NB, n = row - tap * NB;
      *reinterpret_cast<uint4*>(sw + row * CS + ch * VEC) =
          __ldg(reinterpret_cast<const uint4*>(wg + ((size_t)tap * C + n) * KS + ch * VEC));
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) tap_mma<T, KS, 1, HALO_W, NB>(sx, sw + tap * NB * CS, tap / 3, tap % 3, acc);
  }

  T* out = reinterpret_cast<T*>(a.out);
  const T* res = reinterpret_cast<const T*>(a.res);
  const T* cond = reinterpret_cast<const T*>(a.cond);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int oy = y0 + 2 * warp + mt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = x0 + g + 8 * half;
      if (oy >= H || ox >= W) continue;
      const size_t pix = ((size_t)b * H + oy) * W + ox;
#pragma unroll
      for (int nt = 0; nt < NB / 8; ++nt) {
        const int c = n0 + nt * 8 + 2 * t4;
        const size_t o = pix * C + c;
        // the conv's output, rounded to T as the reference's conv returns it
        const float v0 = rnd<T>(acc[mt][nt][2 * half] + a.bias[c]);
        const float v1 = rnd<T>(acc[mt][nt][2 * half + 1] + a.bias[c + 1]);
        if constexpr (EPI == EPI_H2) {
          const float* tv = a.tv + (size_t)b * C + c;
          store2<T>(out + o, mish(v0) + tv[0], mish(v1) + tv[1]);
        } else {
          float s0 = rnd<T>(rnd<T>(mish(v0)) + to_f(res[o]));
          float s1 = rnd<T>(rnd<T>(mish(v1)) + to_f(res[o + 1]));
          if (EPI == EPI_OUT && cond != nullptr) {
            s0 += to_f(cond[o]);
            s1 += to_f(cond[o + 1]);
          }
          store2<T>(out + o, s0, s1);
        }
      }
    }
  }
}

// One launch with the dynamic shared memory the instantiation needs (set
// once per instantiation). Returns cudaGetLastError() after the launch.
template <typename T, int NB, bool PRO, int EPI>
int launch_wide(const WideArgs& a, int B, cudaStream_t stream) {
  auto kern = chain_wide_kernel<T, NB, PRO, EPI>;
  const size_t smem = (size_t)(9 * NB + HALO_H * HALO_W) * Traits<T, KS>::CS * sizeof(T);
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const unsigned tiles = (unsigned)(((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW));
  kern<<<dim3(tiles * (unsigned)(a.C / NB), B), NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int NB>
int chain_wide(const void* a_pre, const void* r1, const float* tv1, const float* tv2, const void* wb,
               const float* bb, const void* wc, const float* bc, const void* wd, const float* bd, const void* cond,
               void* y1, void* h2, void* out, int C, int B, int H, int W, cudaStream_t s) {
  WideArgs a = {};
  a.H = H;
  a.W = W;
  a.C = C;
  // conv_b over h1 = rnd(mish(a_pre) + tv1), built in the input prologue
  a.in = a_pre;
  a.w = wb;
  a.bias = bb;
  a.pro_tv = tv1;
  a.res = r1;
  a.out = y1;
  int err = launch_wide<T, NB, true, EPI_Y1>(a, B, s);
  if (err) return err;
  a.in = y1;
  a.w = wc;
  a.bias = bc;
  a.pro_tv = nullptr;
  a.tv = tv2;
  a.res = nullptr;
  a.out = h2;
  if ((err = launch_wide<T, NB, false, EPI_H2>(a, B, s))) return err;
  a.in = h2;
  a.w = wd;
  a.bias = bd;
  a.tv = nullptr;
  a.res = y1;
  a.cond = cond;
  a.out = out;
  return launch_wide<T, NB, false, EPI_OUT>(a, B, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; C: a multiple of 32 from 32 to 512.
// Activations are NHWC and contiguous; conv weights are (C / 32, 9, C_out,
// 32) in the activation dtype; biases and time vectors are float32. y1 and
// h2 are scratch of the activations' shape. Three launches; returns
// cudaGetLastError() after the last (0 on success).
int dgmsr_chain_wide(int dtype, const void* a_pre, const void* r1, const void* tv1, const void* tv2, const void* wb,
                     const void* bb, const void* wc, const void* bc, const void* wd, const void* bd, const void* cond,
                     void* y1, void* h2, void* out, int C, int B, int H, int W, void* stream) {
  if (C < KS || C > 512 || C % KS) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  decltype(&chain_wide<float, 64>) fn = C % 64 == 0 ? (dtype == 1 ? &chain_wide<bf16, 64> : &chain_wide<float, 64>)
                                                    : (dtype == 1 ? &chain_wide<bf16, 32> : &chain_wide<float, 32>);
  return fn(a_pre, r1, f(tv1), f(tv2), wb, f(bb), wc, f(bc), wd, f(bd), cond, y1, h2, out, C, B, H, W, s);
}

}  // extern "C"
