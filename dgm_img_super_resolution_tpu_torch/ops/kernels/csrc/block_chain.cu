// The UNet's ResnetBlock-pair chain regions, by hand for Hopper (sm_90a).
//
// Replaces dgm_img_super_resolution_tpu/ops/pallas/block_chain.py:
//   _block_chain3_stem_pallas (down stage 0: stem conv 3->C, 1x1 residual,
//                              three reflect 3x3 C->C convs, RRDB cond add;
//                              with has_ds, also the stage's Downsample)
//   _block_chain3_pallas      (the same chain from h1 on, for every other pair
//                              of width 64; here also at 32; chain_wide.cu
//                              takes the wider stages)
//   _block_chain3_head_pallas (the last up stage with its head conv over the
//                              [x || skip] join and its 1x1 residual in front)
// as their *_reference compositions define them:
//   h1  = rnd(mish(a_pre) + tv1)
//   y1  = rnd(rnd(mish(conv_b(h1) + bb)) + r1)
//   h2  = rnd(mish(conv_c(y1) + bc) + tv2)
//   out = rnd(rnd(mish(conv_d(h2) + bd)) + y1) [then rnd(out + cond)]
// with rnd() rounding to the compute dtype where the reference does, and
//   ds_out = rnd(reflect_conv3x3_stride2(out, wds) + bds)
//   a_pre  = rnd(rnd(conv_a(x, wa[:, :Cs]) + ba) + rnd(conv_a(skip, wa[:, Cs:])))
//   r1     = rnd(rnd(rnd(x . wr[:, :Cs]) + rnd(skip . wr[:, Cs:])) + br)
// for the Downsample fold and the head.
// Here in float32, and the chain at C = 32 in bf16: in bf16 at C = 64 the stem
// and the chain run on the warpgroup-MMA conv core (block_chain_wgmma.cu),
// and so do the Downsample and the head at C_s = 64, 128 (head_ds_wgmma.cu);
// the Downsample and head convs below serve float32 and the bf16 head at
// other C_s.
//
// Design: a region is a few launches of one tiled conv kernel (conv_tile.cuh:
// mma.sync bf16 tensor-core implicit GEMM or f32 FMAs, weights resident in
// shared memory, persistent tiles, the elementwise chain fused into the input
// prologue and output epilogues). The intermediates a_pre, r1, y1 and h2 go
// through device memory.
//
// The Downsample fold and the head add one or two launches of a second conv,
// conv_stream_kernel, in front of or behind the chain. Its weights cannot stay
// resident: the head's 3x3 over 2 x 128 input channels holds 295 KB of bf16
// weights (590 KB in f32) and the stride-2 conv's input tile is 17x33 pixels,
// against the 227 KB of shared memory a block may hold. So each block takes
// one 8x16 output tile and streams over K: for each 64-channel slice of its
// inputs (x low and high, then skip low and high) it stages the slice's halo
// tile, then the weights one window row (3 taps) at a time, and accumulates
// in f32 registers. The x part is rounded before the skip part is added, as
// the reference rounds its two convs. Bound at the main path's shapes: the
// Downsample fold (B=8, 512x512 -> 256x256, C=64, bf16) adds 38.7 GFLOP and
// the 67 MB of ds_out to the stem region; the head (B=8, 256x256, Cs=128) adds
// 154.6 + 17.2 GFLOP and 268 MB of x and skip to the chain, so both regions
// stay bound by the tensor cores.

#include "conv_tile.cuh"

using namespace dgmsr;

namespace {

constexpr int C = 64;  // channels of the stem, the head, the Downsample and the chain (also 32)

// Stem: a_pre = rnd(reflect_conv3x3(x, wa) + ba) (3 -> C) and
// r1 = rnd(x . wr + br) (1x1, 3 -> C). The K dim is 27 + 3, too thin for the
// tensor cores: 8 threads per pixel, 8 output channels each, f32 FMAs.
constexpr int STEM_PIX = 32;  // pixels per block

template <typename T>
__global__ void __launch_bounds__(STEM_PIX * 8) stem_kernel(const T* __restrict__ x, const float* __restrict__ wa,
                                                          const float* __restrict__ ba, const float* __restrict__ wr,
                                                          const float* __restrict__ br, T* __restrict__ a_pre,
                                                          T* __restrict__ r1, int B, int H, int W) {
  __shared__ float swa[27 * C];
  __shared__ float swr[3 * C];
  __shared__ float sb[2 * C];
  for (int i = threadIdx.x; i < 27 * C; i += blockDim.x) swa[i] = wa[i];
  for (int i = threadIdx.x; i < 3 * C; i += blockDim.x) swr[i] = wr[i];
  for (int i = threadIdx.x; i < C; i += blockDim.x) {
    sb[i] = ba[i];
    sb[C + i] = br[i];
  }
  __syncthreads();

  const long pix = (long)blockIdx.x * STEM_PIX + threadIdx.x / 8;
  if (pix >= (long)B * H * W) return;
  const int c0 = (threadIdx.x % 8) * 8;
  const int b = (int)(pix / ((long)H * W));
  const int rem = (int)(pix - (long)b * H * W);
  const int y = rem / W, xx = rem % W;

  float in[27];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int r = reflect(y - 1 + dy, H);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const T* p = x + ((size_t)(b * H + r) * W + reflect(xx - 1 + dx, W)) * 3;
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) in[(dy * 3 + dx) * 3 + ci] = to_f(p[ci]);
    }
  }
  float acc[8], racc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    acc[e] = 0.f;
    racc[e] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 27; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += in[j] * swa[j * C + c0 + e];
#pragma unroll
  for (int ci = 0; ci < 3; ++ci)
#pragma unroll
    for (int e = 0; e < 8; ++e) racc[e] += in[12 + ci] * swr[ci * C + c0 + e];  // centre tap

  const size_t o = (size_t)pix * C + c0;
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    store2<T>(a_pre + o + e, acc[e] + sb[c0 + e], acc[e + 1] + sb[c0 + e + 1]);
    store2<T>(r1 + o + e, racc[e] + sb[C + c0 + e], racc[e + 1] + sb[C + c0 + e + 1]);
  }
}

// The chain from h1 on at CC channels (64, or 32 for the outer stages of a
// hidden-32 UNet): three launches of the resident-weight tiled conv. Wider
// chains stream their weights instead (chain_wide.cu).
template <typename T, int CC>
int chain3(const void* a_pre, const void* r1, const float* tv1, const float* tv2, const void* wb, const float* bb,
           const void* wc, const float* bc, const void* wd, const float* bd, const void* cond, void* y1, void* h2,
           void* out, int B, int H, int W, cudaStream_t s) {
  ConvArgs a = {};
  a.B = B;
  a.H = H;
  a.W = W;
  // conv_b over h1 = rnd(mish(a_pre) + tv1), built in the input prologue
  a.in = a_pre;
  a.w = wb;
  a.bias = bb;
  a.pro_tv = tv1;
  a.res = r1;
  a.out = y1;
  int err = launch_conv<T, CC, 9, true, true, EPI_Y1>(a, 1, s);
  if (err) return err;
  a.in = y1;
  a.w = wc;
  a.bias = bc;
  a.pro_tv = nullptr;
  a.tv = tv2;
  a.res = nullptr;
  a.out = h2;
  if ((err = launch_conv<T, CC, 9, true, false, EPI_H2>(a, 1, s))) return err;
  a.in = h2;
  a.w = wd;
  a.bias = bd;
  a.tv = nullptr;
  a.res = y1;
  a.cond = cond;
  a.out = out;
  return launch_conv<T, CC, 9, true, false, EPI_OUT>(a, 1, s);
}


struct StreamArgs {
  const void* in0;    // (B, H, W, cs) input
  const void* in1;    // (B, H, W, cs) second input whose channels continue in0's, or null
  const void* w;      // (inputs, cs / C, taps, C_out, C) weights in T, one slab per 64-channel slice
  const float* bias;  // (C,)
  void* out;          // (B, Ho, Wo, C)
  int H, W, Ho, Wo, cs;
};

// A reflect-bordered conv C_in -> 64 at stride S (3x3, or 1x1 when NTAPS ==
// 1) over one or two inputs, one 8x16 output tile per block, weights streamed
// through shared memory (see the note at the top). The result of input 0 is
// p0 = rnd(acc0 + bias) if BIAS_FIRST else rnd(acc0); with input 1 the output
// is rnd(p0 + rnd(acc1)), then + bias and rounded again if not BIAS_FIRST.
template <typename T, int S, int NTAPS, bool BIAS_FIRST>
__global__ void __launch_bounds__(NT) conv_stream_kernel(const StreamArgs a) {
  constexpr int CS = Traits<T, C>::CS, VEC = Traits<T, C>::VEC, CH = C / VEC;
  constexpr int HH = S * (TH - 1) + 3, HWD = S * (TW - 1) + 3;
  constexpr int KT = NTAPS == 9 ? 3 : 1;  // taps per weight stage: one row of the window
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);
  T* sw = sx + HH * HWD * CS;

  const int tiles_x = (a.Wo + TW - 1) / TW;
  const int y0 = (blockIdx.x / tiles_x) * TH, x0 = (blockIdx.x % tiles_x) * TW;
  const int b = blockIdx.y;
  const int nslices = a.cs / C, nsrc = a.in1 ? 2 : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;

  float acc[2][C / 8][4], part[2][C / 8][4];
  zero_acc<C>(acc);
#pragma unroll 1
  for (int src = 0; src < nsrc; ++src) {
    const T* in = reinterpret_cast<const T*>(src ? a.in1 : a.in0);
#pragma unroll 1
    for (int k = 0; k < nslices; ++k) {
      __syncthreads();  // every warp is done with the previous slice
      load_tile<T, C, HH, HWD, true, false>(sx, in, nullptr, b, S * y0 - 1, S * x0 - 1, a.H, a.W, a.cs, k * C);
      const T* wg = reinterpret_cast<const T*>(a.w) + (size_t)(src * nslices + k) * NTAPS * C * C;
#pragma unroll 1
      for (int st = 0; st < NTAPS / KT; ++st) {
        if (st) __syncthreads();  // every warp is done with the previous stage's weights
        for (int idx = threadIdx.x; idx < KT * C * CH; idx += NT) {
          const int row = idx / CH, ch = idx - row * CH;
          *reinterpret_cast<uint4*>(sw + row * CS + ch * VEC) =
              __ldg(reinterpret_cast<const uint4*>(wg + ((size_t)st * KT * C + row) * C + ch * VEC));
        }
        __syncthreads();
#pragma unroll
        for (int t = 0; t < KT; ++t)
          tap_mma<T, C, S, HWD>(sx, sw + t * C * CS, NTAPS == 9 ? st : 1, NTAPS == 9 ? t : 1, acc);
      }
    }
    if (src == 0 && nsrc == 2) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float bias = BIAS_FIRST ? a.bias[nt * 8 + 2 * t4 + (e & 1)] : 0.f;
            part[mt][nt][e] = rnd<T>(acc[mt][nt][e] + bias);
            acc[mt][nt][e] = 0.f;
          }
    }
  }

  T* out = reinterpret_cast<T*>(a.out);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int oy = y0 + 2 * warp + mt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ox = x0 + g + 8 * half;
      if (oy >= a.Ho || ox >= a.Wo) continue;
#pragma unroll
      for (int nt = 0; nt < C / 8; ++nt) {
        const int c = nt * 8 + 2 * t4;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float s = acc[mt][nt][2 * half + j];
          if (nsrc == 1) {
            v[j] = rnd<T>(s + a.bias[c + j]);
          } else {
            v[j] = rnd<T>(part[mt][nt][2 * half + j] + rnd<T>(s));
            if (!BIAS_FIRST) v[j] = rnd<T>(v[j] + a.bias[c + j]);
          }
        }
        store2<T>(out + ((size_t)(b * a.Ho + oy) * a.Wo + ox) * C + c, v[0], v[1]);
      }
    }
  }
}

template <typename T, int S, int NTAPS, bool BIAS_FIRST>
int launch_stream(const StreamArgs& a, int B, cudaStream_t stream) {
  auto kern = conv_stream_kernel<T, S, NTAPS, BIAS_FIRST>;
  constexpr int KT = NTAPS == 9 ? 3 : 1;
  const size_t smem = (size_t)((S * (TH - 1) + 3) * (S * (TW - 1) + 3) + KT * C) * Traits<T, C>::CS * sizeof(T);
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const unsigned tiles = (unsigned)(((a.Ho + TH - 1) / TH) * ((a.Wo + TW - 1) / TW));
  kern<<<dim3(tiles, B), NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int stem_ds(const void* out, const void* wds, const float* bds, void* ds_out, int B, int H, int W, cudaStream_t s) {
  StreamArgs a = {};
  a.in0 = out;
  a.w = wds;
  a.bias = bds;
  a.out = ds_out;
  a.H = H;
  a.W = W;
  a.Ho = (H - 1) / 2 + 1;
  a.Wo = (W - 1) / 2 + 1;
  a.cs = C;
  return launch_stream<T, 2, 9, true>(a, B, s);
}

template <typename T>
int head(const void* x, const void* skip, const void* wa, const float* ba, const void* wr, const float* br,
         void* a_pre, void* r1, int cs, int B, int H, int W, cudaStream_t s) {
  StreamArgs a = {};
  a.in0 = x;
  a.in1 = skip;
  a.w = wa;
  a.bias = ba;
  a.out = a_pre;
  a.H = a.Ho = H;
  a.W = a.Wo = W;
  a.cs = cs;
  int err = launch_stream<T, 1, 9, true>(a, B, s);
  if (err) return err;
  a.w = wr;
  a.bias = br;
  a.out = r1;
  return launch_stream<T, 1, 1, false>(a, B, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; c: 64 or 32 channels (bfloat16: 32 only;
// block_chain_wgmma.cu runs it at 64). Activations are NHWC and contiguous;
// conv weights are (9, C_out, C_in) in the activation dtype; biases and time
// vectors are float32. y1 and h2 are scratch of the activations' shape.
// Returns cudaGetLastError() after the last launch (0 on success).
int dgmsr_block_chain3(int dtype, const void* a_pre, const void* r1, const void* tv1, const void* tv2, const void* wb,
                       const void* bb, const void* wc, const void* bc, const void* wd, const void* bd,
                       const void* cond, void* y1, void* h2, void* out, int c, int B, int H, int W, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if ((c != C && c != 32) || (dtype == 1 && c != 32)) return (int)cudaErrorInvalidValue;
  decltype(&chain3<float, C>) fn = dtype == 1 ? &chain3<bf16, 32> : c == C ? &chain3<float, C> : &chain3<float, 32>;
  return fn(a_pre, r1, f(tv1), f(tv2), wb, f(bb), wc, f(bc), wd, f(bd), cond, y1, h2, out, B, H, W, s);
}

// dtype must be 0 (float32; block_chain_wgmma.cu runs the bfloat16 stem). x is
// (B, H, W, 3); wa is (27, C) float32 ordered (dy, dx, c_in); wr is (3, C)
// float32; a_pre and r1 are written as (B, H, W, C).
int dgmsr_stem_head(int dtype, const void* x, const void* wa, const void* ba, const void* wr, const void* br,
                    void* a_pre, void* r1, int B, int H, int W, void* stream) {
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const long npix = (long)B * H * W;
  const unsigned grid = (unsigned)((npix + STEM_PIX - 1) / STEM_PIX);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  stem_kernel<float><<<grid, STEM_PIX * 8, 0, s>>>(static_cast<const float*>(x), f(wa), f(ba), f(wr), f(br),
                                                   static_cast<float*>(a_pre), static_cast<float*>(r1), B, H, W);
  return (int)cudaGetLastError();
}

// Down stage 0's Downsample over the chain's output: out is (B, H, W, C);
// wds is (1, 1, 9, C_out, C_in) in the activation dtype; ds_out is written
// as (B, (H + 1) / 2, (W + 1) / 2, C).
int dgmsr_stem_ds(int dtype, const void* out, const void* wds, const void* bds, void* ds_out, int B, int H, int W,
                  void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto b = static_cast<const float*>(bds);
  if (dtype == 1) return stem_ds<bf16>(out, wds, b, ds_out, B, H, W, s);
  return stem_ds<float>(out, wds, b, ds_out, B, H, W, s);
}

// The head in front of the chain: x and skip are (B, H, W, cs), cs a
// multiple of 64; wa is (2, cs / 64, 9, C_out, 64) and wr (2, cs / 64, 1,
// C_out, 64) in the activation dtype (x's slices, then skip's); a_pre and r1
// are written as (B, H, W, C). Two launches.
int dgmsr_head(int dtype, const void* x, const void* skip, const void* wa, const void* ba, const void* wr,
               const void* br, void* a_pre, void* r1, int cs, int B, int H, int W, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == 1) return head<bf16>(x, skip, wa, f(ba), wr, f(br), a_pre, r1, cs, B, H, W, s);
  return head<float>(x, skip, wa, f(ba), wr, f(br), a_pre, r1, cs, B, H, W, s);
}

}  // extern "C"
