// The bf16 chain of the UNet's ResnetBlock-pair regions at C = 64, 128, 192
// and 256, by hand for Hopper (sm_90a), on the warpgroup-MMA conv core of
// conv_wgmma.cuh (C = 64, weights resident) and conv_wgmma_wide.cuh (C =
// 128-256, K and the weights streamed in 64-channel slices).
//
// Replaces, for bfloat16 at those widths, the chain part of
// dgm_img_super_resolution_tpu/ops/pallas/block_chain.py:
//   _block_chain3_stem_pallas (down stage 0, C = 64; with has_ds the
//                              Downsample follows, on head_ds_wgmma.cu)
//   _block_chain3_pallas      (the chain from h1 on: packed at C = 64, its
//                              unpacked wide mode, block_chain.py:323-330,
//                              at 128-256)
//   _block_chain3_head_pallas (the chain behind the head, C = 64; the head
//                              launch of head_ds_wgmma.cu writes its h1, r1)
// as their *_reference compositions define it, rounding where they round:
//   h1  = rnd(mish(a_pre) + tv1),  a_pre = rnd(conv_a(x) + ba)
//   y1  = rnd(rnd(mish(rnd(conv_b(h1) + bb))) + r1),  r1 = rnd(x . wr + br)
//   h2  = rnd(mish(rnd(conv_c(y1) + bc)) + tv2)
//   out = rnd(rnd(mish(rnd(conv_d(h2) + bd))) + y1) [then rnd(out + cond)]
// float32, C = 32 and the other wide widths (96, 160, 224, 288-512) stay on
// block_chain.cu / chain_wide.cu: routing by dtype and width, in
// ops/kernels/block_chain.py.
//
// Launches: the stem (stem_h1_kernel: conv_a, the 1x1 residual and h1), the
// head (head_ds_wgmma.cu, writing h1 and r1) or, where a_pre comes from
// outside the chain, the h1 pass (h1_kernel); then
// conv_b, conv_c and conv_d, each one launch of the conv core with its
// epilogue hook (Y1, H2, Out): 4 launches, all of them writing through device
// memory. So the core needs no input prologue: TMA reads h1 as it is.
//
// Bound on the card at the main path's shape (B=8, 512x512, bf16): the three
// convs are 464 GFLOP (0.469 ms at 989 TFLOP/s) against the region's 549 MB
// of unavoidable traffic (0.164 ms), so the tensor cores bound the region;
// the wide chain likewise at configuration C's shapes (0.469 ms at (8, 128,
// 256, 256), 0.264 at (8, 192, 128, 128), 0.117 at (8, 256, 64, 64)).
// This design's own floor is higher: each launch moves its intermediates
// through device memory, one conv its input and output and zero to two
// residuals (0.54-1.07 GB at this shape, longer than its 0.156 ms of
// products at the peak), 2.96 GB over the four launches, 0.88 ms at 3.35
// TB/s. Fusing the launches is a later step; this one moves the three convs
// onto the core as they are.
//
// The stem's K is 27 (+3 for the residual): f32 FMAs, 8 threads a pixel, 8
// output channels each, 2 pixels a thread so that each weight read from
// shared memory serves two. The weights are laid out in shared memory so
// that the 8 threads of a pixel read 128 contiguous bytes (no bank
// conflict); a persistent grid loads them once a block. Each thread writes
// its 8 channels of h1 and of r1 as one 16-byte store. The stem and the h1
// pass are bound by their bytes.

#include "conv_wgmma_wide.cuh"

using namespace dgmsr::cw;

namespace {

typedef __nv_bfloat16 bf16;

// ReflectionPad(1) index of i in [-1, n].
__device__ __forceinline__ int reflect1(int i, int n) { return i < 0 ? -i : i >= n ? 2 * n - 2 - i : i; }

// 8 bf16 values (16 bytes) and their f32 values; 8 float32 values (32
// bytes, 16-byte aligned).
__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]), pack(v[6], v[7]));
}
__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack(w[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// ---------------------------------------------------------------- the stem
constexpr int STEM_NT = 256;                         // threads a block: 8 a pixel
constexpr int STEM_PPT = 2;                          // pixels a thread
constexpr int STEM_STEP = STEM_NT / 8 * STEM_PPT;   // pixels a block and step

// Shared-memory index of weight (row j, channel c) in a (rows, C) matrix laid
// out so that channel group q (channels 8 q .. 8 q + 7) reads its first four
// at j * C + 4 q and its last four at j * C + 32 + 4 q.
__device__ __forceinline__ int stem_slot(int i) {
  const int j = i / C, c = i % C, q = c >> 3, half = (c >> 2) & 1;
  return j * C + half * 32 + q * 4 + (c & 3);
}

// h1 = rnd(mish(rnd(reflect_conv3x3(x, wa) + ba)) + tv1[b]) and
// r1 = rnd(x . wr + br) (1x1, the centre tap) over (B, H, W, 3) x.
// A warp takes 8 consecutive pixels a step: pixel base + lane / 8 + 4 i.
__global__ void __launch_bounds__(STEM_NT) stem_h1_kernel(const bf16* __restrict__ x, const float* __restrict__ wa,
                                                        const float* __restrict__ ba, const float* __restrict__ wr,
                                                        const float* __restrict__ br, const float* __restrict__ tv1,
                                                        bf16* __restrict__ h1, bf16* __restrict__ r1, int B, int H,
                                                        int W) {
  __shared__ __align__(16) float swa[27 * C];
  __shared__ __align__(16) float swr[3 * C];
  for (int i = threadIdx.x; i < 27 * C; i += STEM_NT) swa[stem_slot(i)] = wa[i];
  for (int i = threadIdx.x; i < 3 * C; i += STEM_NT) swr[stem_slot(i)] = wr[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, q = lane & 7, c0 = 8 * q;
  float bias_a[8], bias_r[8];
  load8(ba + c0, bias_a);
  load8(br + c0, bias_r);
  const int hw = H * W, npix = B * hw;  // the launcher keeps B H W below 2^30
  for (int base = (blockIdx.x * (STEM_NT / 32) + (threadIdx.x >> 5)) * 8; base < npix;
       base += gridDim.x * STEM_STEP) {
    float in[STEM_PPT][27];
    int pix[STEM_PPT], img[STEM_PPT];
#pragma unroll
    for (int i = 0; i < STEM_PPT; ++i) {
      pix[i] = base + (lane >> 3) + 4 * i;
      const int p = pix[i] < npix ? pix[i] : npix - 1;
      img[i] = p / hw;
      const int rem = p - img[i] * hw;
      const int y = rem / W, xx = rem - y * W;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const bf16* row = x + (size_t)(img[i] * H + reflect1(y - 1 + dy, H)) * W * 3;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const bf16* px = row + reflect1(xx - 1 + dx, W) * 3;
#pragma unroll
          for (int ci = 0; ci < 3; ++ci) in[i][(dy * 3 + dx) * 3 + ci] = __bfloat162float(px[ci]);
        }
      }
    }
    float acc[STEM_PPT][8], racc[STEM_PPT][8];
#pragma unroll
    for (int i = 0; i < STEM_PPT; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = racc[i][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 27; ++j) {
      float w[8];
      const float4 lo = *reinterpret_cast<const float4*>(swa + j * C + 4 * q);
      const float4 hi = *reinterpret_cast<const float4*>(swa + j * C + 32 + 4 * q);
      w[0] = lo.x, w[1] = lo.y, w[2] = lo.z, w[3] = lo.w, w[4] = hi.x, w[5] = hi.y, w[6] = hi.z, w[7] = hi.w;
#pragma unroll
      for (int i = 0; i < STEM_PPT; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] += in[i][j] * w[e];
    }
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) {
      float w[8];
      const float4 lo = *reinterpret_cast<const float4*>(swr + ci * C + 4 * q);
      const float4 hi = *reinterpret_cast<const float4*>(swr + ci * C + 32 + 4 * q);
      w[0] = lo.x, w[1] = lo.y, w[2] = lo.z, w[3] = lo.w, w[4] = hi.x, w[5] = hi.y, w[6] = hi.z, w[7] = hi.w;
#pragma unroll
      for (int i = 0; i < STEM_PPT; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) racc[i][e] += in[i][12 + ci] * w[e];  // the centre tap
    }
#pragma unroll
    for (int i = 0; i < STEM_PPT; ++i) {
      if (pix[i] >= npix) continue;
      float tv[8], hv[8], rv[8];
      load8(tv1 + img[i] * C + c0, tv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        hv[e] = mish(rnd(acc[i][e] + bias_a[e])) + tv[e];
        rv[e] = racc[i][e] + bias_r[e];
      }
      const size_t o = (size_t)pix[i] * C + c0;
      *reinterpret_cast<uint4*>(h1 + o) = pack8(hv);
      *reinterpret_cast<uint4*>(r1 + o) = pack8(rv);
    }
  }
}

// h1 = rnd(mish(a_pre) + tv1[b]) over (B, H, W, CW), 8 channels (16 bytes) a
// thread and step.
template <int CW>
__global__ void __launch_bounds__(256) h1_kernel(const bf16* __restrict__ a_pre, const float* __restrict__ tv1,
                                                 bf16* __restrict__ h1, int nvec, int hw) {
  constexpr int V = CW / 8;  // vectors a pixel
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += gridDim.x * blockDim.x) {
    float a[8], tv[8];
    unpack8(*reinterpret_cast<const uint4*>(a_pre + 8 * (size_t)i), a);
    const int pixel = i / V;
    load8(tv1 + (pixel / hw) * CW + (i - pixel * V) * 8, tv);
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = mish(a[e]) + tv[e];
    *reinterpret_cast<uint4*>(h1 + 8 * (size_t)i) = pack8(a);
  }
}

// A persistent grid for `work` items of `step` a block: at most as many
// blocks as the card holds at once (counted once into *resident).
template <class Kernel>
int persistent_grid(Kernel kern, int threads, long work, int step, int* resident, unsigned* grid) {
  if (*resident == 0) {
    int dev = 0, nsm = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, 0);
    if (err != cudaSuccess) return (int)err;
    *resident = nsm * (per_sm > 0 ? per_sm : 1);
  }
  const long need = (work + step - 1) / step;
  *grid = (unsigned)(need < *resident ? need : *resident);
  return 0;
}

// ------------------------------------------------- the chain's epilogue hooks
// v = rnd(s + bias), the conv's output in bf16, then:

// y1 = rnd(rnd(mish(v)) + r1); r1 read at the output pixel (residual 0).
struct Y1 {
  static constexpr int NRES = 1;
  const float* bias;
  using Regs = BiasRegs;
  __device__ __forceinline__ Regs setup(int t, int n0) const { return bias_regs(bias + n0, t); }
  __device__ __forceinline__ uint32_t operator()(const Regs& r, int n, int, int, int, float s0, float s1,
                                                 uint32_t res, uint32_t) const {
    const float2 p = unpack(res);
    return pack(rnd(mish(rnd(s0 + r.b[2 * n]))) + p.x, rnd(mish(rnd(s1 + r.b[2 * n + 1]))) + p.y);
  }
};

// h2 = rnd(mish(v) + tv2[b]) at width CW.
template <int CW> struct H2 {
  static constexpr int NRES = 0;
  const float* bias;
  const float* tv;  // (B, CW) float32
  struct Regs {
    BiasRegs bias;
    int ch;  // the thread's first channel, n0 + 2 t
  };
  __device__ __forceinline__ Regs setup(int t, int n0) const { return {bias_regs(bias + n0, t), n0 + 2 * t}; }
  __device__ __forceinline__ uint32_t operator()(const Regs& r, int n, int b, int, int, float s0, float s1,
                                                 uint32_t, uint32_t) const {
    const float2 tv2 = __ldg(reinterpret_cast<const float2*>(tv + b * CW + r.ch + 8 * n));
    return pack(mish(rnd(s0 + r.bias.b[2 * n])) + tv2.x, mish(rnd(s1 + r.bias.b[2 * n + 1])) + tv2.y);
  }
};

// out = rnd(rnd(mish(v)) + y1) (residual 0), then rnd(out + cond) (residual 1).
template <bool COND> struct Out {
  static constexpr int NRES = COND ? 2 : 1;
  const float* bias;
  using Regs = BiasRegs;
  __device__ __forceinline__ Regs setup(int t, int n0) const { return bias_regs(bias + n0, t); }
  __device__ __forceinline__ uint32_t operator()(const Regs& r, int n, int, int, int, float s0, float s1,
                                                 uint32_t res0, uint32_t res1) const {
    const float2 y = unpack(res0);
    float o0 = rnd(mish(rnd(s0 + r.b[2 * n]))) + y.x, o1 = rnd(mish(rnd(s1 + r.b[2 * n + 1]))) + y.y;
    if (COND) {
      const float2 c = unpack(res1);
      o0 = rnd(o0) + c.x;
      o1 = rnd(o1) + c.y;
    }
    return pack(o0, o1);
  }
};

// One reflect conv of the chain at width CW: the core with resident weights
// at C = 64, the wide core (conv_wgmma_wide.cuh) above.
template <int CW, class Epi>
int conv(const void* x, const void* w, void* out, const Epi& epi, int B, int H, int W, cudaStream_t s,
         const void* res0 = nullptr, const void* res1 = nullptr) {
  if constexpr (CW == C) return launch_conv_wgmma<true>(x, w, out, epi, B, H, W, s, res0, res1);
  else return launch_conv_wide<CW, true>(x, w, out, epi, B, H, W, s, res0, res1);
}

// conv_b, conv_c, conv_d on the core. h2 may be h1's memory: conv_b has read
// h1 before conv_c writes h2 (one stream).
template <int CW>
int chain3(const void* h1, const void* r1, const float* tv2, const void* wb, const float* bb, const void* wc,
           const float* bc, const void* wd, const float* bd, const void* cond, void* y1, void* h2, void* out, int B,
           int H, int W, cudaStream_t s) {
  int err = conv<CW>(h1, wb, y1, Y1{bb}, B, H, W, s, r1);
  if (!err) err = conv<CW>(y1, wc, h2, H2<CW>{bc, tv2}, B, H, W, s);
  if (err) return err;
  return cond ? conv<CW>(h2, wd, out, Out<true>{bd}, B, H, W, s, y1, cond)
              : conv<CW>(h2, wd, out, Out<false>{bd}, B, H, W, s, y1);
}

}  // namespace

extern "C" {

// dtype must be 1 (bfloat16): the only instantiation here. x is (B, H, W, 3);
// wa is (27, 64) float32 ordered (dy, dx, c_in), wr (3, 64) float32; ba, br
// (64,) and tv1 (B, 64) float32; h1 and r1 are written as (B, H, W, 64).
// Returns cudaGetLastError() after the launch (0 on success).
int dgmsr_stem_h1(int dtype, const void* x, const void* wa, const void* ba, const void* wr, const void* br,
                  const void* tv1, void* h1, void* r1, int B, int H, int W, void* stream) {
  if (dtype != 1 || B <= 0 || H < 2 || W < 2 || (long)B * H * W >= (1L << 30)) return (int)cudaErrorInvalidValue;
  static int resident = 0;
  unsigned grid = 0;
  const int err = persistent_grid(stem_h1_kernel, STEM_NT, (long)B * H * W, STEM_STEP, &resident, &grid);
  if (err) return err;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  stem_h1_kernel<<<grid, STEM_NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), f(wa), f(ba), f(wr), f(br), f(tv1), static_cast<bf16*>(h1),
      static_cast<bf16*>(r1), B, H, W);
  return (int)cudaGetLastError();
}

// The h1 pass where a_pre comes from outside the chain: dtype 1 (bfloat16)
// and c in {64, 128, 192, 256}; a_pre and h1 are (B, H, W, c) bf16; tv1 is
// (B, c) float32.
int dgmsr_h1(int dtype, const void* a_pre, const void* tv1, void* h1, int c, int B, int H, int W, void* stream) {
  const long nvec = (long)B * H * W * (c / 8);
  if (dtype != 1 || B <= 0 || H <= 0 || W <= 0 || nvec >= (1L << 30)) return (int)cudaErrorInvalidValue;
  auto run = [&](auto kern, int* resident) {
    unsigned grid = 0;
    const int err = persistent_grid(kern, 256, nvec, 256, resident, &grid);
    if (err) return err;
    kern<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(a_pre), static_cast<const float*>(tv1), static_cast<bf16*>(h1), (int)nvec, H * W);
    return (int)cudaGetLastError();
  };
  static int resident[4] = {0, 0, 0, 0};
  switch (c) {
    case 64: return run(h1_kernel<64>, &resident[0]);
    case 128: return run(h1_kernel<128>, &resident[1]);
    case 192: return run(h1_kernel<192>, &resident[2]);
    case 256: return run(h1_kernel<256>, &resident[3]);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The chain from h1 on: dtype 1 (bfloat16) and c in {64, 128, 192, 256}. h1,
// r1, cond and the outputs are (B, H, W, c), 16-byte aligned; cond may be
// null; y1 and h2 are scratch (h2 may be h1). Weights are (9, C_out, C_in)
// bf16; biases and tv2 float32. Three launches; returns cudaGetLastError()
// after the last.
int dgmsr_chain3_wgmma(int dtype, const void* h1, const void* r1, const void* tv2, const void* wb, const void* bb,
                       const void* wc, const void* bc, const void* wd, const void* bd, const void* cond, void* y1,
                       void* h2, void* out, int c, int B, int H, int W, void* stream) {
  if (dtype != 1 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 64: return chain3<64>(h1, r1, f(tv2), wb, f(bb), wc, f(bc), wd, f(bd), cond, y1, h2, out, B, H, W, s);
    case 128: return chain3<128>(h1, r1, f(tv2), wb, f(bb), wc, f(bc), wd, f(bd), cond, y1, h2, out, B, H, W, s);
    case 192: return chain3<192>(h1, r1, f(tv2), wb, f(bb), wc, f(bc), wd, f(bd), cond, y1, h2, out, B, H, W, s);
    case 256: return chain3<256>(h1, r1, f(tv2), wb, f(bb), wc, f(bc), wd, f(bd), cond, y1, h2, out, B, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
