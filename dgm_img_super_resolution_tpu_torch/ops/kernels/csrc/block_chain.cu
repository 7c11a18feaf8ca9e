// The UNet's ResnetBlock-pair chain regions, by hand for Hopper (sm_90a).
//
// Replaces dgm_img_super_resolution_tpu/ops/pallas/block_chain.py:
//   _block_chain3_stem_pallas (down stage 0: stem conv 3->C, 1x1 residual,
//                              three reflect 3x3 C->C convs, RRDB cond add)
//   _block_chain3_pallas      (the last up stage: the same chain from h1 on)
// as their *_reference compositions define them:
//   h1  = rnd(mish(a_pre) + tv1)
//   y1  = rnd(rnd(mish(conv_b(h1) + bb)) + r1)
//   h2  = rnd(mish(conv_c(y1) + bc) + tv2)
//   out = rnd(rnd(mish(conv_d(h2) + bd)) + y1) [then rnd(out + cond)]
// with rnd() rounding to the compute dtype where the reference does.
//
// Bound on the card: at B=8, 512x512, C=64 in bf16 the stem region is 472
// GFLOP against about 549 MB of unavoidable traffic, so the tensor cores
// bound it (0.48 ms at 989 TFLOP/s); the 256x256 up-stage chain likewise
// (116 GFLOP). Design: a region is a few launches of one tiled conv kernel
// (conv_tile.cuh: mma.sync bf16 tensor-core implicit GEMM, weights resident
// in shared memory, persistent tiles, the elementwise chain fused into the
// input prologue and output epilogues). The intermediates a_pre, r1, y1 and
// h2 go through device memory: 11 activation passes for the stem region
// where a fused one needs 2, and 8 where 3 for the up-stage chain, which a
// later single-launch version removes.

#include "conv_tile.cuh"

using namespace dgmsr;

namespace {

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

template <typename T>
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
  int err = launch_conv<T, 9, true, true, EPI_Y1>(a, 1, s);
  if (err) return err;
  a.in = y1;
  a.w = wc;
  a.bias = bc;
  a.pro_tv = nullptr;
  a.tv = tv2;
  a.res = nullptr;
  a.out = h2;
  if ((err = launch_conv<T, 9, true, false, EPI_H2>(a, 1, s))) return err;
  a.in = h2;
  a.w = wd;
  a.bias = bd;
  a.tv = nullptr;
  a.res = y1;
  a.cond = cond;
  a.out = out;
  return launch_conv<T, 9, true, false, EPI_OUT>(a, 1, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Activations are NHWC and contiguous;
// conv weights are (9, C_out, C_in) in the activation dtype; biases and time
// vectors are float32. y1 and h2 are scratch of the activations' shape.
// Returns cudaGetLastError() after the last launch (0 on success).
int dgmsr_block_chain3(int dtype, const void* a_pre, const void* r1, const void* tv1, const void* tv2, const void* wb,
                       const void* bb, const void* wc, const void* bc, const void* wd, const void* bd,
                       const void* cond, void* y1, void* h2, void* out, int B, int H, int W, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == 1)
    return chain3<bf16>(a_pre, r1, f(tv1), f(tv2), wb, f(bb), wc, f(bc), wd, f(bd), cond, y1, h2, out, B, H, W, s);
  return chain3<float>(a_pre, r1, f(tv1), f(tv2), wb, f(bb), wc, f(bc), wd, f(bd), cond, y1, h2, out, B, H, W, s);
}

// x is (B, H, W, 3); wa is (27, C) float32 ordered (dy, dx, c_in); wr is
// (3, C) float32; a_pre and r1 are written as (B, H, W, C).
int dgmsr_stem_head(int dtype, const void* x, const void* wa, const void* ba, const void* wr, const void* br,
                    void* a_pre, void* r1, int B, int H, int W, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const long npix = (long)B * H * W;
  const unsigned grid = (unsigned)((npix + STEM_PIX - 1) / STEM_PIX);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == 1)
    stem_kernel<bf16><<<grid, STEM_PIX * 8, 0, s>>>(static_cast<const bf16*>(x), f(wa), f(ba), f(wr), f(br),
                                                    static_cast<bf16*>(a_pre), static_cast<bf16*>(r1), B, H, W);
  else
    stem_kernel<float><<<grid, STEM_PIX * 8, 0, s>>>(static_cast<const float*>(x), f(wa), f(ba), f(wr), f(br),
                                                     static_cast<float*>(a_pre), static_cast<float*>(r1), B, H, W);
  return (int)cudaGetLastError();
}

}  // extern "C"
