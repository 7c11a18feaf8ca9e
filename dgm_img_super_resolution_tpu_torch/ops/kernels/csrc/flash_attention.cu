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
// function), so nothing is transposed around the call. Lq and Lk may differ
// and need not divide by a tile: queries past Lq are computed on zero rows
// and not stored, keys past Lk get p = 0 (and zero-filled V rows).
//
// Bound on the card: at the SD x4 path's shape (B=2 CFG halves, L=1024
// tokens, H=8, D=128, bf16) one call is 4.B.H.L^2.D = 8.6 GFLOP against
// 16.8 MB of q, k, v and o, so the tensor cores bound it (8.7 us at
// 989 TFLOP/s, against 5.0 us for the bytes). The score matrix never goes to
// device memory. Each of the Lq / 128 query tiles of a head reads the head's
// K and V from L2 (64 MB in all at that shape), and with 8 key tiles a block
// the first S and the last P V do not overlap anything.
//
// The descriptor, wgmma fence / commit / wait, mbarrier, TMA and tensor-map
// helpers are in hopper.cuh, shared with the conv of conv_wgmma.cuh.
//
// bfloat16 (the SD serve's path), on Hopper's warpgroup MMA and TMA. One
// block of two warpgroups (256 threads) serves one (b.h) and 128 query rows,
// 64 a warpgroup; the grid is (Lq / 128, B.H), 128 blocks at the SD shape,
// one wave on 132 SMs, one block an SM. Q is loaded once; K and V walk in
// tiles of 128 keys through two rings of 2 shared-memory stages. Thread 0
// issues every load as a TMA box of 128 rows x 64 columns of one head (a
// 4-D tensor map over (D, H, L, B); rows past L come in as zeros), which
// lands 128-byte swizzled (16-byte chunk c of row r at c ^ (r % 8)) in
// 1024-byte aligned atoms: the layout the wgmma descriptors name. Each tile
// has a "full" mbarrier (the TMA's bytes) and an "empty" one (all 256
// threads done with it); nothing else synchronises the two warpgroups.
//   S = Q K^T: wgmma m64n128k16, both operands from shared memory, both
//     K-major (D contiguous; SBO 1024 B between 8-row groups), D / 16 steps
//     that move the start address 32 B within a 128-byte row.
//   The online softmax runs on the S accumulator in registers. Per warp it
//     has the mma.sync m16n8 ownership: s[4 n + e] is row g + 8 (e / 2) of
//     the warp's 16, key 8 n + 2 t + e % 2 (g = lane / 4, t = lane % 4), so a
//     row's max and sum reduce over the 4 threads of a quad; ex2.approx, with
//     log2(e) folded into the scale and the scale into the exponent's FMA.
//   O += P V: wgmma m64nDk16 with A from registers: P rounded to bf16 and
//     packed from the S accumulator (its m16n8 layout is the A fragment
//     layout); B = V, MN-major (D contiguous) with the transpose bit, LBO
//     128 keys x 128 B between 64-column blocks, SBO 1024 B between 8-key
//     groups; 8 steps of 16 keys.
//   Per key tile i = j + 1 a warpgroup issues S_i, then P_j V_j, and while
//     the two run, thread 0 loads K_{j+2} and V_{j+1}; the softmax of S_i
//     runs while P_j V_j is still on the tensor cores (wgmma.wait_group 1).
// ptxas (sm_90a, CUDA 12.8): 199 registers at D = 128 and 160 at D = 64,
// no spills; 164,864 B of dynamic shared memory at D = 128 (82,944 at 64)
// and 80 B of barriers. bf16 rounds p against each 128-key tile's running
// max (JAX: each 512-key block's max).
//
// float32 (the card's correctness check): one block of 4 warps per (b.h,
// 64-query tile); each warp owns 16 query rows. The block walks the keys in
// tiles of 64, staging K and V in shared memory with cp.async, two tiles in
// flight; plain FMAs (no TF32) with the m16n8 ownership above, P going
// through shared memory. l stays a per-thread partial sum until the end.
// A ragged last tile is masked: queries past L are computed on zeros and not
// stored, keys past L get s = -inf (p = 0) and zero-filled V rows.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// the float32 kernel
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Ownership (the mma.sync m16n8 accumulator layout):
// with g = lane / 4 and t = lane % 4, s[n][e] is query row g + 8 * (e / 2) of
// the warp and key 8 n + 2 t + e % 2 of the tile; acc[n][e] is the same row
// and output column 8 n + 2 t + e % 2.

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

// ---------------------------------------------------------------- bfloat16
namespace wg {

using namespace dgmsr::hopper;

constexpr int BQ = 128;      // query rows per block: two warpgroups of 64
constexpr int BK = 128;      // keys per tile
constexpr int NT = 2 * 128;  // threads per block

template <int D> struct Smem {
  static constexpr int Q = BQ * D;   // elements of the Q tile
  static constexpr int KV = BK * D;  // elements of one K or V tile
  static constexpr size_t bytes = (size_t)(Q + 4 * KV) * sizeof(bf16) + 1024;  // + the 1024 B alignment
};

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(i) WG_F4(i), WG_F4(i + 4), WG_F4(i + 8), WG_F4(i + 12)
#define WG_F32(i) WG_F16(i), WG_F16(i + 16)

// d (64 x 128, f32) = (scale_d ? d : 0) + A (64 x 16) B (16 x 128); A, B
// K-major in shared memory.
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F32(0), WG_F32(32)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N, f32) += A (64 x 16, bf16 registers) B (16 x N); B MN-major in
// shared memory (the transpose bit). N = 128 and 64.
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_F32(0), WG_F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T for a warpgroup's 64 rows against a tile's 128 keys, issued (no
// fence, no commit): D / 16 steps of 16 columns, column block kk / 4 and
// 32 B into its 128-byte rows. dq, dk: descriptors of the rows' start.
template <int D>
__device__ __forceinline__ void scores_issue(float (&s)[BK / 2], uint64_t dq, uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma_ss(s, dq + (((kk >> 2) * BQ * 128 + (kk & 3) * 32) >> 4), dk + (((kk >> 2) * BK * 128 + (kk & 3) * 32) >> 4),
           kk > 0);
}

// O += P V with P in registers, issued: 8 steps of 16 keys, 16 rows of 128 B
// down the V tile. dv: the tile's descriptor.
template <int D>
__device__ __forceinline__ void pv_issue(const uint32_t (&pa)[BK / 16][4], float (&acc)[D / 2], uint64_t dv) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) mma_rs(acc, pa[kc], dv + ((kc * 16 * 128) >> 4));
}

// The online softmax of one tile on the S accumulator (raw scores): masks
// keys past Lk, updates m and l, leaves P (f32) in s and each row's rescale
// of O in alpha. Both rows at once, max and sum over 4 partials each.
__device__ __forceinline__ void softmax(float (&s)[BK / 2], float (&m)[2], float (&l)[2], float (&alpha)[2], int key0,
                                        int Lk, float scale2) {
  const int t = threadIdx.x & 3;
  if (key0 + BK > Lk) {  // the ragged last tile
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      if (key0 + 2 * t + (i >> 2) * 8 + (i & 1) >= Lk) s[i] = -INFINITY;
  }
  float mx[2][4], mn[2], ps[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) mx[r][u] = fmaxf(s[4 * u + 2 * r], s[4 * u + 2 * r + 1]);
#pragma unroll
  for (int n = 4; n < BK / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r][n & 3] = fmaxf(mx[r][n & 3], fmaxf(s[4 * n + 2 * r], s[4 * n + 2 * r + 1]));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mc = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
    mn[r] = fmaxf(m[r], mc * scale2);  // scaled, in log2 units
    alpha[r] = exp2_approx(m[r] - mn[r]);
    m[r] = mn[r];
#pragma unroll
    for (int u = 0; u < 4; ++u) ps[r][u] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = exp2_approx(fmaf(s[i], scale2, -mn[r]));
    ps[r][(i >> 2) & 3] += s[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + ((ps[r][0] + ps[r][1]) + (ps[r][2] + ps[r][3]));
}

// P rounded to bf16 and packed as wgmma A fragments, 16 keys a step: (row g,
// keys 2t..) (row g + 8, ..), then keys + 8: the S accumulator's layout.
__device__ __forceinline__ void pack_p(const float (&s)[BK / 2], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kc][i] = pack_bf16(s[8 * kc + 2 * i], s[8 * kc + 2 * i + 1]);
}

template <int D> __device__ __forceinline__ void rescale(float (&acc)[D / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, int H, int Lq, int Lk) {
  using S = Smem<D>;  // Q, then 2 K tiles, then 2 V tiles
  extern __shared__ __align__(16) unsigned char smem[];
  // full: a tile landed; empty: both warpgroups are done with it
  __shared__ __align__(8) uint64_t bar_q, full_k[2], empty_k[2], full_v[2], empty_v[2];
  const uint32_t base = smem_addr(smem);
  bf16* sQ = reinterpret_cast<bf16*>(smem + ((1024 - (base & 1023)) & 1023));  // 1024 B aligned: the swizzle atoms
  bf16* sK = sQ + S::Q;
  bf16* sV = sK + 2 * S::KV;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const int nk = (Lk + BK - 1) / BK;
  const bool loader = threadIdx.x == 0;  // the one thread that issues the tile loads
  constexpr uint32_t tile_bytes = BK * D * sizeof(bf16);
  // Tile n of K or V into its stage n % 2, once both warpgroups released
  // tile n - 2 there (a fresh barrier passes parity 1).
  auto load = [&](const CUtensorMap* map, bf16* ring, uint64_t* full, uint64_t* empty, int n) {
    const int st = n & 1;
    mbar_wait(&empty[st], ((n >> 1) & 1) ^ 1);
    mbar_expect(&full[st], tile_bytes);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb)
      tma_load(map, ring + st * S::KV + cb * BK * 64, &full[st], cb * 64, h, n * BK, b);
  };
  if (loader) {
    mbar_init(&bar_q, 1);
    for (int i = 0; i < 2; ++i) {
      mbar_init(&full_k[i], 1);
      mbar_init(&full_v[i], 1);
      mbar_init(&empty_k[i], NT);
      mbar_init(&empty_v[i], NT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(&bar_q, BQ * D * sizeof(bf16));
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) tma_load(&tq, sQ + cb * BQ * 64, &bar_q, cb * 64, h, q0, b);
    load(&tk, sK, full_k, empty_k, 0);
    load(&tv, sV, full_v, empty_v, 0);
    if (nk > 1) load(&tk, sK, full_k, empty_k, 1);
  }
  __syncthreads();

  const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // D^-1/2 (rounded to f32, as the JAX kernel's Python-float scale is) times log2(e), for exp2
  const float scale2 = static_cast<float>(static_cast<double>(static_cast<float>(1.0 / sqrt((double)D))) *
                                          1.4426950408889634);
  const uint64_t dq = desc(sQ + wgi * 64 * 64, 16, 1024);  // K-major: LBO unused, 1024 B between 8-row groups
  const uint64_t dk0 = desc(sK, 16, 1024);
  const uint64_t dv0 = desc(sV, BK * 128, 1024);  // MN-major: 64-column blocks BK x 128 B apart
  constexpr uint64_t tile_step = S::KV * sizeof(bf16) / 16;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
  float acc[D / 2], s[BK / 2];  // acc[4 n + e]: row g + 8 (e / 2), column 8 n + 2 t + e % 2; s likewise, keys
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;

  mbar_wait_warp(&bar_q, 0);
  mbar_wait_warp(&full_k[0], 0);
  wgmma_fence();
  scores_issue<D>(s, dq, dk0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  mbar_arrive(&empty_k[0]);
  softmax(s, m, l, alpha, 0, Lk, scale2);
  pack_p(s, pa);
  // Tile i = j + 1: S_i is issued with P_j V_j behind it; K_{j+2} and V_{j+1}
  // are loaded while they run, and the softmax of S_i runs while P_j V_j is
  // on the tensor cores.
  for (int j = 0; j + 1 < nk; ++j) {
    const int i = j + 1;
    mbar_wait_warp(&full_k[i & 1], (i >> 1) & 1);
    wgmma_fence();
    scores_issue<D>(s, dq, dk0 + (i & 1) * tile_step);
    wgmma_commit();
    rescale<D>(acc, alpha);
    mbar_wait_warp(&full_v[j & 1], (j >> 1) & 1);
    wgmma_fence();
    pv_issue<D>(pa, acc, dv0 + (j & 1) * tile_step);
    wgmma_commit();
    if (loader) {
      if (j + 2 < nk) load(&tk, sK, full_k, empty_k, j + 2);
      load(&tv, sV, full_v, empty_v, j + 1);
    }
    __syncwarp();
    wgmma_wait<1>();  // S_i; P_j V_j may still run
    fence_regs(s);
    mbar_arrive(&empty_k[i & 1]);
    softmax(s, m, l, alpha, i * BK, Lk, scale2);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(&empty_v[j & 1]);
    pack_p(s, pa);
  }
  const int j = nk - 1;
  mbar_wait_warp(&full_v[j & 1], (j >> 1) & 1);
  rescale<D>(acc, alpha);
  wgmma_fence();
  pv_issue<D>(pa, acc, dv0 + (j & 1) * tile_step);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

  const size_t stride = (size_t)H * D;  // between consecutive tokens of one head
  bf16* ob = o + ((size_t)b * Lq * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = q0 + wgi * 64 + warp * 16 + g + 8 * r;
    if (row < Lq) {
      bf16* orow = ob + (size_t)row * stride + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) store2(orow + n * 8, acc[4 * n + 2 * r] / lt, acc[4 * n + 2 * r + 1] / lt);
    }
  }
}

// A (B, L, H, D) bf16 tensor as a 4-D map whose box is rows x 64 columns of
// one head, 128-byte swizzled: one column block of a tile as the descriptors
// read it. Rows past L are filled with zeros.
int make_map(CUtensorMap* map, const void* p, int B, int L, int H, int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2, (cuuint64_t)L * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Lq, int Lk, cudaStream_t s) {
  constexpr size_t smem = Smem<D>::bytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, B, Lq, H, D, BQ);
  if (!rc) rc = make_map(&tk, k, B, Lk, H, D, BK);
  if (!rc) rc = make_map(&tv, v, B, Lk, H, D, BK);
  if (rc) return rc;
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  flash_kernel<D><<<grid, NT, smem, s>>>(tq, tk, tv, static_cast<bf16*>(o), H, Lq, Lk);
  return (int)cudaGetLastError();
}

}  // namespace wg

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
    if (D == 64) return wg::launch<64>(q, k, v, o, B, H, Lq, Lk, s);
    if (D == 128) return wg::launch<128>(q, k, v, o, B, H, Lq, Lk, s);
  } else if (dtype == 0) {
    if (D == 64) return launch<float, 64>(q, k, v, o, B, H, Lq, Lk, s);
    if (D == 128) return launch<float, 128>(q, k, v, o, B, H, Lq, Lk, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
