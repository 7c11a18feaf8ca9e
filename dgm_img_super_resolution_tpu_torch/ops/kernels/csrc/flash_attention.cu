// Non-causal flash attention, by hand for Hopper (sm_90a).
//
// Replaces dgm_img_super_resolution_tpu/ops/pallas/attention.py:
// flash_attention (_flash_kernel), and computes what it computes, row by row:
//   s     = (q . k^T) * D^-1/2                 scores in f32
//   m_new = max(m_prev, max_j s)               m starts at -1e30, not -inf
//   alpha = exp(m_prev - m_new)
//   p     = exp(s - m_new)                     f32
//   l     = alpha * l + sum_j p                from the f32 p
//   acc   = alpha * acc + rnd_v(p) . v         p rounded to v's dtype first
//   o     = acc / l, cast to q's dtype
// over (B, L, H, D) tensors in that layout (the public layout of the JAX
// function), so nothing is transposed around the call.
//
// Bound on the card: at the SD x4 path's shape (B=2 CFG halves, L=1024
// tokens, H=8, D=128, bf16) one call is 4.B.H.L^2.D = 8.6 GFLOP against
// 16.8 MB of q, k, v and o, so the tensor cores bound it (8.7 us at
// 989 TFLOP/s, against 5.0 us for the bytes). The score matrix never goes to
// device memory.
//
// Design (simple and right first): one block of 4 warps per (b.h, 64-query
// tile); each warp owns 16 query rows. The block walks the keys in tiles of
// 64, staging K and V in shared memory with cp.async, two tiles in flight.
// bf16: S = Q K^T and O += P V with mma.sync m16n8k16 (f32 accumulators);
// the S accumulator is re-packed in registers as the A operand of P V, the
// way the online softmax leaves it. f32: the same ownership of rows and
// columns with plain FMAs (no TF32), P going through shared memory. The
// online softmax runs per row in registers, its max reduced over the 4
// threads that share a row; l stays a per-thread partial sum until the end.
// A ragged last tile is masked: queries past L are computed on zeros and not
// stored, keys past L get s = -inf (p = 0) and zero-filled V rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;    // query rows per block (4 warps x 16)
constexpr int BK = 64;    // keys per staged tile
constexpr int NT = 128;   // threads per block
constexpr int NKT = BK / 8;  // 8-key column tiles of S
constexpr float NEG_INF = -1e30f;

template <typename T, int D> struct Tile {
  static constexpr int RS = D + 16 / sizeof(T);  // padded row stride in shared memory
  static constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte copy
  static constexpr int Q = BQ * RS;
  static constexpr int KV = BK * RS;
  static constexpr int PS = BK + 4;               // row stride of the f32 P buffer
  static constexpr int P = sizeof(T) == 4 ? 4 * 16 * PS : 0;
  static constexpr size_t bytes = (size_t)(Q + 4 * KV) * sizeof(T) + (size_t)P * sizeof(float);
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Rows row0 .. row0 + n - 1 of one (b, h) slice into shared memory; rows at
// or past L are zero-filled (their source address is clamped to row 0).
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* base, int row0, int n, int L, size_t stride) {
  using TL = Tile<T, D>;
  constexpr int CPR = D / TL::VEC;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < n * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const bool valid = row0 + r < L;
    const T* src = base + (valid ? (size_t)(row0 + r) * stride : 0) + c * TL::VEC;
    cp_async16(dst + r * TL::RS + c * TL::VEC, src, valid);
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Ownership (the mma.sync m16n8 accumulator layout, kept by the f32 path):
// with g = lane / 4 and t = lane % 4, s[n][e] is query row g + 8 * (e / 2) of
// the warp and key 8 n + 2 t + e % 2 of the tile; acc[n][e] is the same row
// and output column 8 n + 2 t + e % 2.

// S = Q K^T for the warp's 16 rows against the 64 keys of sK.
template <int D>
__device__ __forceinline__ void scores(const bf16* sQ, const bf16* sK, float (&s)[NKT][4]) {
  constexpr int RS = Tile<bf16, D>::RS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* qw = sQ + warp * 16 * RS;
#pragma unroll
  for (int n = 0; n < NKT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    a[0] = ld32(qw + g * RS + kk * 16 + 2 * t);
    a[1] = ld32(qw + (g + 8) * RS + kk * 16 + 2 * t);
    a[2] = ld32(qw + g * RS + kk * 16 + 8 + 2 * t);
    a[3] = ld32(qw + (g + 8) * RS + kk * 16 + 8 + 2 * t);
#pragma unroll
    for (int n = 0; n < NKT; ++n) {
      const bf16* kr = sK + (n * 8 + g) * RS + kk * 16 + 2 * t;
      mma_bf16(s[n], a, ld32(kr), ld32(kr + 8));
    }
  }
}

template <int D>
__device__ __forceinline__ void scores(const float* sQ, const float* sK, float (&s)[NKT][4]) {
  constexpr int RS = Tile<float, D>::RS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* q0 = sQ + (warp * 16 + g) * RS;
  const float* q1 = q0 + 8 * RS;
#pragma unroll
  for (int n = 0; n < NKT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll 1
  for (int d = 0; d < D; d += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(q0 + d);
    const float4 a1 = *reinterpret_cast<const float4*>(q1 + d);
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(sK + (n * 8 + 2 * t + c) * RS + d);
        s[n][c] = fmaf(a0.x, k4.x, fmaf(a0.y, k4.y, fmaf(a0.z, k4.z, fmaf(a0.w, k4.w, s[n][c]))));
        s[n][2 + c] = fmaf(a1.x, k4.x, fmaf(a1.y, k4.y, fmaf(a1.z, k4.z, fmaf(a1.w, k4.w, s[n][2 + c]))));
      }
  }
}

// acc += rnd_v(P) V for the warp's rows, P in the score registers.
template <int D>
__device__ __forceinline__ void pv(const float (&p)[NKT][4], const bf16* sV, float*, float (&acc)[D / 8][4]) {
  constexpr int RS = Tile<bf16, D>::RS;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kc][0], p[2 * kc][1]);
    a[1] = pack_bf16(p[2 * kc][2], p[2 * kc][3]);
    a[2] = pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    a[3] = pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      // B fragment (k = key, n = output column): keys 2t, 2t+1 and 2t+8, 2t+9
      // of this 16-key chunk, column 8 n + g.
      const bf16* vr = sV + (kc * 16 + 2 * t) * RS + n * 8 + g;
      mma_bf16(acc[n], a, pack_raw(vr[0], vr[RS]), pack_raw(vr[8 * RS], vr[9 * RS]));
    }
  }
}

template <int D>
__device__ __forceinline__ void pv(const float (&p)[NKT][4], const float* sV, float* sP, float (&acc)[D / 8][4]) {
  constexpr int RS = Tile<float, D>::RS;
  constexpr int PS = Tile<float, D>::PS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float* pw = sP + warp * 16 * PS;
#pragma unroll
  for (int n = 0; n < NKT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) pw[(g + 8 * (e >> 1)) * PS + n * 8 + 2 * t + (e & 1)] = p[n][e];
  __syncwarp();
#pragma unroll 1
  for (int j = 0; j < BK; ++j) {
    const float p0 = pw[g * PS + j], p1 = pw[(g + 8) * PS + j];
    const float* vr = sV + j * RS + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float2 v2 = *reinterpret_cast<const float2*>(vr + n * 8);
      acc[n][0] = fmaf(p0, v2.x, acc[n][0]);
      acc[n][1] = fmaf(p0, v2.y, acc[n][1]);
      acc[n][2] = fmaf(p1, v2.x, acc[n][2]);
      acc[n][3] = fmaf(p1, v2.y, acc[n][3]);
    }
  }
  __syncwarp();
}

__device__ __forceinline__ void store2(float* p, float a, float b) { *reinterpret_cast<float2*>(p) = make_float2(a, b); }
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                                   const T* __restrict__ v, T* __restrict__ o, int H, int Lq,
                                                   int Lk) {
  using TL = Tile<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + TL::Q;       // two K tiles
  T* sV = sK + 2 * TL::KV;  // two V tiles
  float* sP = reinterpret_cast<float*>(sV + 2 * TL::KV);

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const size_t stride = (size_t)H * D;  // between consecutive tokens of one head
  const T* qb = q + ((size_t)b * Lq * H + h) * D;
  const T* kb = k + ((size_t)b * Lk * H + h) * D;
  const T* vb = v + ((size_t)b * Lk * H + h) * D;
  T* ob = o + ((size_t)b * Lq * H + h) * D;
  // D^-1/2 rounded once to f32, as the JAX kernel's Python-float scale is
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));

  load_rows<T, D>(sQ, qb, q0, BQ, Lq, stride);
  load_rows<T, D>(sK, kb, 0, BK, Lk, stride);
  load_rows<T, D>(sV, vb, 0, BK, Lk, stride);
  cp_commit();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int nk = (Lk + BK - 1) / BK;
  for (int j = 0; j < nk; ++j) {
    const int buf = j & 1;
    if (j + 1 < nk) {  // the next tile goes into the buffer the last iteration finished with
      load_rows<T, D>(sK + (buf ^ 1) * TL::KV, kb, (j + 1) * BK, BK, Lk, stride);
      load_rows<T, D>(sV + (buf ^ 1) * TL::KV, vb, (j + 1) * BK, BK, Lk, stride);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    float s[NKT][4];
    scores<D>(sQ, sK + buf * TL::KV, s);
    const int key0 = j * BK + 2 * t;
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = key0 + n * 8 + (e & 1) < Lk ? s[n][e] * scale : -INFINITY;

#pragma unroll
    for (int r = 0; r < 2; ++r) {  // rows g (e = 0, 1) and g + 8 (e = 2, 3)
      float mc = -INFINITY;
#pragma unroll
      for (int n = 0; n < NKT; ++n) mc = fmaxf(mc, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      const float mn = fmaxf(m[r], mc);
      const float alpha = expf(m[r] - mn);
      float ps = 0.f;
#pragma unroll
      for (int n = 0; n < NKT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = expf(s[n][2 * r + c] - mn);
          s[n][2 * r + c] = p;
          ps += p;
        }
      l[r] = alpha * l[r] + ps;
      m[r] = mn;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
    pv<D>(s, sV + buf * TL::KV, sP, acc);
    __syncthreads();  // every warp is done with buf before it is refilled
  }

  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row < Lq) {
      T* orow = ob + (size_t)row * stride + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) store2(orow + n * 8, acc[n][2 * r] / lt, acc[n][2 * r + 1] / lt);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Lk, cudaStream_t s) {
  constexpr size_t smem = Tile<T, D>::bytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  flash_kernel<T, D><<<grid, NT, smem, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                            static_cast<const T*>(v), static_cast<T*>(o), H, Lq, Lk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q is (B, Lq, H, D), k and v (B, Lk, H, D),
// o (B, Lq, H, D), all contiguous and 16-byte aligned; D is 64 or 128.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// head width with no instantiation.
int dgmsr_flash_attention(int dtype, const void* q, const void* k, const void* v, void* o, int B, int H, int Lq,
                          int Lk, int D, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (Lq <= 0 || Lk <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (D == 64) return launch<bf16, 64>(q, k, v, o, B, H, Lq, Lk, s);
    if (D == 128) return launch<bf16, 128>(q, k, v, o, B, H, Lq, Lk, s);
  } else if (dtype == 0) {
    if (D == 64) return launch<float, 64>(q, k, v, o, B, H, Lq, Lk, s);
    if (D == 128) return launch<float, 128>(q, k, v, o, B, H, Lq, Lk, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
