// Tiled direct convolution over NHWC activations with C in {32, 64} channels
// in and out, shared by the UNet regions in block_chain.cu and tail_fuse.cu
// and by the single conv of conv3x3.cu.
//
// One block computes an 8x16-pixel output tile for all C output channels as
// an implicit GEMM: M = 128 pixels, N = C channels, K = taps x C. The input
// tile and its 1-pixel halo are staged in shared memory (the halo built with
// the border rule of the conv: reflect, or zeros), and every tap's CxC
// weight slab stays resident in shared memory for the life of the block,
// which walks over tiles persistently. Accumulation is f32: bf16 inputs go
// through mma.sync m16n8k16 tensor-core products, f32 inputs through plain
// FMAs with the same ownership of outputs, so one epilogue serves both.
//
// Shared-memory rows are padded (C + 8 bf16 / C + 4 f32 per pixel) so that
// the fragment loads of a warp hit 32 distinct banks.
//
// tap_mma (one tap's product, at stride 1 or 2) and load_tile (one halo tile,
// from any 32- or 64-channel slice of a wider tensor) are also the parts of
// the weight-streaming convs in block_chain.cu and chain_wide.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dgmsr {

constexpr int TH = 8;        // output tile rows
constexpr int TW = 16;       // output tile cols (one m16 MMA tile per row)
constexpr int NT = 128;      // threads per block: 4 warps x 2 tile rows
constexpr int HALO_H = TH + 2;
constexpr int HALO_W = TW + 2;

typedef __nv_bfloat16 bf16;

template <typename T, int C> struct Traits;
template <int C> struct Traits<float, C> {
  static constexpr int CS = C + 4;  // padded pixel stride in shared memory
  static constexpr int VEC = 4;     // elements per 16-byte vector
};
template <int C> struct Traits<bf16, C> {
  static constexpr int CS = C + 8;
  static constexpr int VEC = 8;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
// Round an f32 value to T and back: the points where the reference rounds to
// the compute dtype.
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// mish(x) = x * tanh(softplus(x)). With n = e^x, tanh(log(1 + n)) =
// n(n + 2) / (n(n + 2) + 2): one expf and one division, no overflow since
// x > 20 returns x (tanh(softplus(x)) is 1 in f32 there). It agrees with
// x * tanhf(log1pf(expf(x))) to a few f32 ulp.
__device__ __forceinline__ float mish(float x) {
  if (x > 20.f) return x;
  const float n = expf(x);
  const float p = n * (n + 2.f);
  return x * p / (p + 2.f);
}

// ReflectionPad(1) index; rows/cols past the image that only ragged tiles
// read (never stored) are clamped into range.
__device__ __forceinline__ int reflect(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i < 0 ? 0 : i;
}

template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<bf16>(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Epilogues, over v = rnd(acc + bias), the conv's output in T.
enum Epi {
  EPI_Y1 = 0,        // y1  = rnd(rnd(mish(v)) + res)
  EPI_H2 = 1,        // h2  = rnd(mish(v) + tv[b])
  EPI_OUT = 2,       // out = rnd(rnd(mish(v)) + res) [then rnd(. + cond)]
  EPI_CONVT = 3,     // y   = v, stored at the (2j+a, 2l+b) phase pixel
  EPI_TAIL = 4,      // m   = rnd(mish(v)); out = rnd(m . wo + bo)
  EPI_CONV = 5,      // out = v
  EPI_CONV_MISH = 6  // out = rnd(mish(v))
};

struct ConvArgs {
  const void* in;       // (B, H, W, C) input of the conv
  const void* w;        // (taps, C_out, C_in) weights in T (per phase for ConvT)
  const float* bias;    // (C,)
  const float* pro_tv;  // (B, C): input prologue in = rnd(mish(in) + pro_tv), or null
  const float* tv;      // (B, C) time vector of EPI_H2
  const void* res;      // (B, H, W, C) residual of EPI_Y1 / EPI_OUT
  const void* cond;     // (B, H, W, C) condition of EPI_OUT, or null
  void* out;
  const float* wo;      // (cout, C) 1x1 weights of EPI_TAIL (values of T)
  const float* bo;      // (cout,)
  int B, H, W;          // size of the conv's input image
  int cout;             // output channels of EPI_TAIL
};

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Tap t of the window: 3x3 conv (dy, dx) = (t / 3, t % 3); ConvT phase
// (pa, pb) reads the 2x2 taps (pa + t / 2, pb + t % 2) of the same window.
template <int NTAPS> __device__ __forceinline__ int tap_dy(int t, int pa) {
  return NTAPS == 9 ? t / 3 : pa + (t >> 1);
}
template <int NTAPS> __device__ __forceinline__ int tap_dx(int t, int pb) {
  return NTAPS == 9 ? t % 3 : pb + (t & 1);
}

// acc[mt][nt][e]: tile row py = 2 * warp + mt; e < 2 at col px = g, e >= 2 at
// px = g + 8; channel nt * 8 + 2 * (lane & 3) + (e & 1). This is the
// mma.sync m16n8 accumulator layout, kept by the FMA path too.
template <int C> __device__ __forceinline__ void zero_acc(float (&acc)[2][C / 8][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < C / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// acc += the product of one tap: output pixel (py, px) reads the staged
// input pixel (S * py + dy, S * px + dx) of a halo tile HWD pixels wide, and
// wt is that tap's (N, C) weight slab in shared memory: C input channels (K)
// and N output channels, N = C but for the wide chain's N slices.
template <typename T, int C, int S, int HWD, int N = C>
__device__ __forceinline__ void tap_mma(const T* sx, const T* wt, int dy, int dx, float (&acc)[2][N / 8][4]) {
  constexpr int CS = Traits<T, C>::CS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int kc = 0; kc < C / 16; ++kc) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const T* p0 = sx + ((S * (2 * warp + mt) + dy) * HWD + S * g + dx) * CS + kc * 16 + 2 * t4;
        const T* p1 = p0 + 8 * S * CS;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(p0);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(p1);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
      }
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
        const T* bp = wt + (nt * 8 + g) * CS + kc * 16 + 2 * t4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bp);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bp + 8);
        mma_bf16(acc[0][nt], a[0], b0, b1);
        mma_bf16(acc[1][nt], a[1], b0, b1);
      }
    }
  } else {
    const T* w0p = wt + (2 * t4) * CS;
    const T* x0 = sx + ((S * 2 * warp + dy) * HWD + S * g + dx) * CS;
#pragma unroll 4
    for (int k = 0; k < C; ++k) {
      float a[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a[mt][0] = to_f(x0[S * mt * HWD * CS + k]);
        a[mt][1] = to_f(x0[S * mt * HWD * CS + 8 * S * CS + k]);
      }
#pragma unroll
      for (int nt = 0; nt < N / 8; ++nt) {
        const float w0 = to_f(w0p[nt * 8 * CS + k]);
        const float w1 = to_f(w0p[nt * 8 * CS + CS + k]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          acc[mt][nt][0] += a[mt][0] * w0;
          acc[mt][nt][1] += a[mt][0] * w1;
          acc[mt][nt][2] += a[mt][1] * w0;
          acc[mt][nt][3] += a[mt][1] * w1;
        }
      }
    }
  }
}

template <typename T, int C, int NTAPS>
__device__ __forceinline__ void tile_gemm(const T* sx, const T* sw, int pa, int pb, float (&acc)[2][C / 8][4]) {
  constexpr int CS = Traits<T, C>::CS;
  zero_acc<C>(acc);
#pragma unroll 1
  for (int tap = 0; tap < NTAPS; ++tap)
    tap_mma<T, C, 1, HALO_W>(sx, sw + tap * C * CS, tap_dy<NTAPS>(tap, pa), tap_dx<NTAPS>(tap, pb), acc);
}

// Stage the HH x HWD input tile whose top-left pixel is (iy0, ix0), channels
// [coff, coff + C) of a tensor with cstride channels per pixel, 16 bytes per
// thread and step. Pixels outside the image reflect, or read as zeros. PRO
// applies the chain's prologue rnd(mish(in) + pro_tv[b]), pro_tv being
// (B, cstride).
template <typename T, int C, int HH, int HWD, bool REFLECT, bool PRO>
__device__ __forceinline__ void load_tile(T* sx, const T* __restrict__ in, const float* __restrict__ pro_tv,
                                          int b, int iy0, int ix0, int H, int W, int cstride = C, int coff = 0) {
  constexpr int VEC = Traits<T, C>::VEC, CH = C / VEC;
  for (int idx = threadIdx.x; idx < HH * HWD * CH; idx += NT) {
    const int q = idx / CH, ch = idx - q * CH;
    const int ty = q / HWD, tx = q - ty * HWD;
    int r = iy0 + ty, c = ix0 + tx;
    bool inside = true;
    if (REFLECT) {
      r = reflect(r, H);
      c = reflect(c, W);
    } else {
      inside = r >= 0 && r < H && c >= 0 && c < W;
    }
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (inside)
      v = __ldg(reinterpret_cast<const uint4*>(in + ((size_t)(b * H + r) * W + c) * cstride + coff + ch * VEC));
    if (PRO) {
      T* e = reinterpret_cast<T*>(&v);
      const float* tv = pro_tv + (size_t)b * cstride + coff + ch * VEC;
#pragma unroll
      for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(mish(to_f(e[i])) + tv[i]);
    }
    *reinterpret_cast<uint4*>(sx + q * Traits<T, C>::CS + ch * VEC) = v;
  }
}

// Persistent kernel: each block keeps all taps' weights in shared memory and
// walks over output tiles (b, tile row, tile col) with stride gridDim.x.
// blockIdx.y is the ConvT phase (2 * pa + pb) when NTAPS == 4.
template <typename T, int C, int NTAPS, bool REFLECT, bool PRO, int EPI>
__global__ void __launch_bounds__(NT) conv_tile_kernel(const ConvArgs a) {
  constexpr int CS = Traits<T, C>::CS, VEC = Traits<T, C>::VEC, CH = C / VEC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sw = reinterpret_cast<T*>(smem_raw);
  T* sx = sw + NTAPS * C * CS;

  const int phase = NTAPS == 4 ? blockIdx.y : 0;
  const int pa = phase >> 1, pb = phase & 1;
  const T* wg = reinterpret_cast<const T*>(a.w) + (size_t)phase * NTAPS * C * C;
  for (int idx = threadIdx.x; idx < NTAPS * C * CH; idx += NT) {
    const int row = idx / CH, ch = idx - row * CH;
    *reinterpret_cast<uint4*>(sw + row * CS + ch * VEC) =
        __ldg(reinterpret_cast<const uint4*>(wg + (size_t)row * C + ch * VEC));
  }

  const int H = a.H, W = a.W;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const long ntiles = (long)a.B * tiles_y * tiles_x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const T* in = reinterpret_cast<const T*>(a.in);
  T* out = reinterpret_cast<T*>(a.out);

  for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = (int)(tile / ((long)tiles_y * tiles_x));
    const int rem = (int)(tile - (long)b * tiles_y * tiles_x);
    const int y0 = (rem / tiles_x) * TH, x0 = (rem % tiles_x) * TW;

    __syncthreads();  // the previous tile's reads of sx are done
    load_tile<T, C, HALO_H, HALO_W, REFLECT, PRO>(sx, in, a.pro_tv, b, y0 - 1, x0 - 1, H, W);
    __syncthreads();

    float acc[2][C / 8][4];
    tile_gemm<T, C, NTAPS>(sx, sw, pa, pb, acc);

    if constexpr (EPI == EPI_TAIL) {
      __syncthreads();  // every warp is done reading sx: reuse it for m
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int py = 2 * warp + mt;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int px = g + 8 * half;
        const int oy = y0 + py, ox = x0 + px;
        const bool valid = oy < H && ox < W;
#pragma unroll
        for (int nt = 0; nt < C / 8; ++nt) {
          const int c = nt * 8 + 2 * t4;
          // the conv's output, rounded to T as the reference's conv returns it
          const float v0 = rnd<T>(acc[mt][nt][2 * half] + a.bias[c]);
          const float v1 = rnd<T>(acc[mt][nt][2 * half + 1] + a.bias[c + 1]);
          if constexpr (EPI == EPI_TAIL) {
            store2<T>(sx + (py * TW + px) * CS + c, mish(v0), mish(v1));
            continue;
          }
          if (!valid) continue;
          if constexpr (EPI == EPI_CONVT) {
            const size_t o = ((size_t)(b * 2 * H + 2 * oy + pa) * (2 * W) + 2 * ox + pb) * C + c;
            store2<T>(out + o, v0, v1);
            continue;
          }
          const size_t o = ((size_t)(b * H + oy) * W + ox) * C + c;
          if constexpr (EPI == EPI_CONV) {
            store2<T>(out + o, v0, v1);
          } else if constexpr (EPI == EPI_CONV_MISH) {
            store2<T>(out + o, mish(v0), mish(v1));
          } else if constexpr (EPI == EPI_H2) {
            store2<T>(out + o, mish(v0) + a.tv[b * C + c], mish(v1) + a.tv[b * C + c + 1]);
          } else {
            const T* res = reinterpret_cast<const T*>(a.res);
            float s0 = rnd<T>(rnd<T>(mish(v0)) + to_f(res[o]));
            float s1 = rnd<T>(rnd<T>(mish(v1)) + to_f(res[o + 1]));
            if (EPI == EPI_OUT && a.cond != nullptr) {
              const T* cond = reinterpret_cast<const T*>(a.cond);
              s0 += to_f(cond[o]);
              s1 += to_f(cond[o + 1]);
            }
            store2<T>(out + o, s0, s1);
          }
        }
      }
    }

    if constexpr (EPI == EPI_TAIL) {
      __syncthreads();
      // 1x1 conv C -> cout over the rounded Mish values of the tile.
      for (int idx = threadIdx.x; idx < TH * TW * a.cout; idx += NT) {
        const int p = idx / a.cout, o = idx - p * a.cout;
        const int oy = y0 + p / TW, ox = x0 + p % TW;
        if (oy >= H || ox >= W) continue;
        const T* m = sx + p * CS;
        const float* wo = a.wo + o * C;
        float s = a.bo[o];
#pragma unroll 8
        for (int k = 0; k < C; ++k) s += to_f(m[k]) * wo[k];
        out[((size_t)(b * H + oy) * W + ox) * a.cout + o] = from_f<T>(s);
      }
    }
  }
}

// Launch with the dynamic shared memory the instantiation needs, one or more
// resident blocks per SM (as occupancy allows) and gridDim.y = phases.
// Returns cudaGetLastError() after the launch.
template <typename T, int C, int NTAPS, bool REFLECT, bool PRO, int EPI>
int launch_conv(const ConvArgs& a, int phases, cudaStream_t stream) {
  auto kern = conv_tile_kernel<T, C, NTAPS, REFLECT, PRO, EPI>;
  const size_t smem = (size_t)(NTAPS * C + HALO_H * HALO_W) * Traits<T, C>::CS * sizeof(T);
  static int resident = 0;  // blocks per SM times SMs, fixed per instantiation
  if (resident == 0) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, nsm = 0, occ = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, NT, smem)) != cudaSuccess) return (int)err;
    resident = nsm * (occ > 0 ? occ : 1);
  }
  const long ntiles = (long)a.B * ((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW);
  long gx = resident / phases;
  if (gx < 1) gx = 1;
  if (gx > ntiles) gx = ntiles;
  kern<<<dim3((unsigned)gx, phases), NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace dgmsr
