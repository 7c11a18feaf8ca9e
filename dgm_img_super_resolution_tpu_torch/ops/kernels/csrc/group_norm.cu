// GroupNorm + affine + optional SiLU, by hand for Hopper (sm_90a).
//
// Replaces dgm_img_super_resolution_tpu/ops/pallas/groupnorm.py:
// fused_group_norm (_gn_kernel), and computes what it computes, per sample n
// and group g of C / G channels:
//   mean = sum(x) / cnt,  var = sum(x^2) / cnt - mean^2   (sums in f32)
//   y    = (x - mean) * rsqrt(var + eps) * scale[c] + bias[c]
//   out  = silu ? y * sigmoid(y) : y, cast to x's dtype
// over NCHW-shaped tensors held either NCHW-contiguous or channels_last.
//
// Bound on the card: it reads x twice (statistics, then normalisation) and
// writes out once, at a few operations per byte, so the memory bounds it; the
// least traffic is one read and one write (at the SD UNet's (2, 256, 256,
// 256) bf16, 134 MB: 0.040 ms at 3.35 TB/s). PyTorch's own statistics kernel
// runs one block per (sample, group), 64 blocks on 132 SMs at that shape.
// Design: three launches. (1) Statistics: each (sample, group) is split over
// many blocks, each summing a contiguous part of the group (16-byte loads
// where the layout allows) into f32 partial sums, so the card fills whatever
// the batch. (2) Finalize: one thread per (sample, group) adds its partials in
// a fixed order (no atomics: the result does not change from run to run) into
// mean and 1 / sqrt(var + eps). (3) Normalize: an elementwise pass over x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int NTHREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

struct GnArgs {
  const void* x;
  void* out;
  const float* scale;  // (C,)
  const float* bias;   // (C,)
  float* part;         // (N * G, splits, 2) partial sums
  float2* stats;       // (N * G): mean, 1 / sqrt(var + eps)
  int N, C, HW, G, splits;
  float eps;
  int silu;
};

// Units of U elements that are contiguous in memory: U = 16 / sizeof(T) on
// the vector path, 1 on the scalar one. Unit u of group (n, g) starts at:
template <bool CL, int U>
__device__ __forceinline__ size_t group_unit(const GnArgs& a, int n, int g, long u) {
  const int cg = a.C / a.G;
  if (!CL) return ((size_t)n * a.C + (size_t)g * cg) * a.HW + (size_t)u * U;
  const int per_pix = cg / U;
  const long p = u / per_pix;
  return ((size_t)n * a.HW + p) * a.C + (size_t)g * cg + (size_t)(u - p * per_pix) * U;
}

template <typename T, int U>
__device__ __forceinline__ void load_unit(const T* x, size_t off, float (&v)[U]) {
  if constexpr (U == 1) {
    v[0] = to_f(x[off]);
  } else {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x + off));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < U; ++i) v[i] = to_f(e[i]);
  }
}

template <typename T, bool CL, int U>
__global__ void __launch_bounds__(NTHREADS) gn_stats(const GnArgs a) {
  const int ng = blockIdx.y, n = ng / a.G, g = ng - n * a.G;
  const long units = (long)(a.C / a.G) * a.HW / U;
  const long chunk = (units + a.splits - 1) / a.splits;
  const long lo = (long)blockIdx.x * chunk;
  const long hi = lo + chunk < units ? lo + chunk : units;
  const T* x = reinterpret_cast<const T*>(a.x);
  float s = 0.f, ss = 0.f;
  for (long u = lo + threadIdx.x; u < hi; u += NTHREADS) {
    float v[U];
    load_unit<T, U>(x, group_unit<CL, U>(a, n, g, u), v);
#pragma unroll
    for (int i = 0; i < U; ++i) {
      s += v[i];
      ss += v[i] * v[i];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  __shared__ float red[2][NTHREADS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = ss;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ts = 0.f, tss = 0.f;
    for (int w = 0; w < NTHREADS / 32; ++w) {
      ts += red[0][w];
      tss += red[1][w];
    }
    float* p = a.part + ((size_t)ng * a.splits + blockIdx.x) * 2;
    p[0] = ts;
    p[1] = tss;
  }
}

__global__ void gn_finalize(const GnArgs a) {
  const int ng = blockIdx.x * blockDim.x + threadIdx.x;
  if (ng >= a.N * a.G) return;
  float s = 0.f, ss = 0.f;
  for (int k = 0; k < a.splits; ++k) {
    s += a.part[((size_t)ng * a.splits + k) * 2];
    ss += a.part[((size_t)ng * a.splits + k) * 2 + 1];
  }
  const float cnt = (float)(a.C / a.G) * (float)a.HW;
  const float mean = s / cnt;
  const float var = ss / cnt - mean * mean;
  a.stats[ng] = make_float2(mean, rsqrtf(var + a.eps));
}

template <typename T, bool CL, int U>
__global__ void __launch_bounds__(NTHREADS) gn_apply(const GnArgs a) {
  const long units = (long)a.N * a.C * a.HW / U;
  const int cg = a.C / a.G;
  const T* x = reinterpret_cast<const T*>(a.x);
  T* out = reinterpret_cast<T*>(a.out);
  for (long u = (long)blockIdx.x * NTHREADS + threadIdx.x; u < units; u += (long)gridDim.x * NTHREADS) {
    const size_t off = (size_t)u * U;
    // a unit lies in one channel (NCHW, HW % U == 0) or one pixel (channels_last, C % U == 0)
    int n, c0;
    if (CL) {
      n = (int)(off / ((size_t)a.HW * a.C));
      c0 = (int)(off % a.C);
    } else {
      const size_t nc = off / a.HW;
      n = (int)(nc / a.C);
      c0 = (int)(nc % a.C);
    }
    float v[U];
    load_unit<T, U>(x, off, v);
    __align__(16) T o[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const int c = CL ? c0 + i : c0;
      const float2 st = a.stats[n * a.G + c / cg];
      float y = (v[i] - st.x) * st.y * a.scale[c] + a.bias[c];
      if (a.silu) y = y / (1.f + expf(-y));
      o[i] = from_f<T>(y);
    }
    if constexpr (U == 1) {
      out[off] = o[0];
    } else {
      *reinterpret_cast<uint4*>(out + off) = *reinterpret_cast<const uint4*>(o);
    }
  }
}

template <typename T, bool CL, int U>
int run(const GnArgs& a, int apply_blocks, cudaStream_t s) {
  gn_stats<T, CL, U><<<dim3(a.splits, a.N * a.G), NTHREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_finalize<<<(a.N * a.G + 127) / 128, 128, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gn_apply<T, CL, U><<<apply_blocks, NTHREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const GnArgs& a, int channels_last, int vec, int apply_blocks, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (channels_last)
    return vec ? run<T, true, V>(a, apply_blocks, s) : run<T, true, 1>(a, apply_blocks, s);
  return vec ? run<T, false, V>(a, apply_blocks, s) : run<T, false, 1>(a, apply_blocks, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x and out are (N, C, H, W)-shaped, both
// NCHW-contiguous (channels_last = 0) or both channels_last (1); scale and
// bias are (C,) float32; scratch holds N * G * (2 * splits + 2) float32.
// vec = 1 takes 16-byte loads: the wrapper sets it when x is 16-byte aligned
// and HW (NCHW) or C / G (channels_last) is a multiple of 16 / sizeof(dtype).
// apply_blocks: the normalize pass's grid. Returns cudaGetLastError() after
// the last launch (0 on success).
int dgmsr_group_norm(int dtype, const void* x, const void* scale, const void* bias, void* out, void* scratch,
                     int N, int C, int HW, int G, int splits, int channels_last, int vec, int silu,
                     int apply_blocks, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  GnArgs a;
  a.x = x;
  a.out = out;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.part = static_cast<float*>(scratch);
  a.stats = reinterpret_cast<float2*>(a.part + (size_t)N * G * splits * 2);
  a.N = N;
  a.C = C;
  a.HW = HW;
  a.G = G;
  a.splits = splits;
  a.eps = eps;
  a.silu = silu;
  if (dtype == 1) return dispatch<bf16>(a, channels_last, vec, apply_blocks, s);
  return dispatch<float>(a, channels_last, vec, apply_blocks, s);
}

}  // extern "C"
