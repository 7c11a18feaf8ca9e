// GroupNorm + affine + optional SiLU, by hand for Hopper (sm_90a), in one
// launch that reads x once wherever a group fits on chip.
//
// Replaces dgm_img_super_resolution_tpu/ops/pallas/groupnorm.py:62
// fused_group_norm (its kernel _gn_kernel, :29), and computes what it
// computes, per sample n and group g of C / G channels:
//   mean = sum(x) / cnt,  var = sum(x^2) / cnt - mean^2   (sums in f32)
//   y    = (x - mean) * rsqrt(var + eps) * scale[c] + bias[c]
//   out  = silu ? y * sigmoid(y) : y, cast to x's dtype
// over NCHW-shaped tensors held either NCHW-contiguous or channels_last.
//
// Bound on the card: a few operations per byte, so the memory bounds it: x
// read once and out written once. At the SD UNet's (2, 256, 256, 256) bf16
// that is 134.2 MB, 0.0401 ms at 3.35 TB/s; at the SD VAE decoder's (1, 128,
// 1024, 1024) bf16, 536.9 MB, 0.1603 ms. The kernel it replaces made three
// launches (split statistics, finalize, normalize) and read x twice.
//
// Design: persistent thread-block clusters of `cluster` CTAs, as many as run
// at once; cluster q takes the items q, q + clusters, ... in turn. An item is
// one group (NCHW: one contiguous run) or, in channels_last, a block of `gb`
// consecutive groups whose channels make a run of 32 bytes or more a pixel
// (a group alone is 8 or 16 bytes a pixel at SD's widths: half a sector).
// An item is cut into units, contiguous runs of UB bytes (16 where the
// layout and alignment allow), and CTA r of the cluster takes the units
// [r * slice, (r + 1) * slice) of every item it meets (whole pixels in
// channels_last); the last `resident` units of its slice stay in its shared
// memory.
//  1. It sums its slice in f32, per group. With 16-byte units a producer
//     warp fills a ring of `buffers` slices of shared memory, up to `buffers`
//     items ahead, in 8 KB chunks that complete on "full" mbarriers: bulk
//     copies of the contiguous run in NCHW, 2-D TMA boxes of `rows` pixels
//     of the item's channels in channels_last. Meanwhile 16 warps sum the
//     rest of the slice (if any) from device memory, then each chunk as it
//     lands, one unit a thread. Otherwise the 16 warps load the resident
//     units themselves, summing and keeping them.
//  2. The CTAs' (s, ss) pairs go to every CTA of the cluster through
//     distributed shared memory (st.async, completing on an mbarrier of the
//     receiving CTA), and each CTA adds them in rank order 0, 1, ...: no
//     atomics, the same result on every CTA and from run to run, and no
//     cluster-wide barrier inside the loop.
//  3. Each CTA normalises its resident units from shared memory as one FMA
//     an element (x * rstd * scale + (bias - mean * rstd * scale); the SiLU
//     by ex2.approx and rcp.approx), stores them (16-byte stores where the
//     units are) and frees each chunk to the producer ("empty" mbarriers),
//     which fills it with a later item's units while the stores drain; then
//     it re-reads the rest of its slice in reverse order, so that the lines
//     it read last come first, from the 50 MB L2.
// The wrapper (ops/kernels/group_norm.py:plan) picks the item, the cluster
// and the ring from the shape: the resident route holds the whole slice
// (one read, one write: the bound); the streamed route, for slices larger
// than a CTA holds, keeps the most it can and re-reads the rest. A CTA takes
// a whole SM, and clusters larger than 2 leave SMs idle (an H100's 132 SMs
// run 66, 30, 15 and 7 clusters of 2, 4, 8 and 16 at once), so the plan
// weighs the rounds that the items take at each cluster size against the
// slice; it asks dgmsr_group_norm_limits how many clusters of each size run
// at once (16 is non-portable, and 0 where it does not schedule).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

#include "hopper.cuh"

namespace {

using namespace dgmsr::hopper;
typedef __nv_bfloat16 bf16;

constexpr int NTC = 512;         // computing threads a CTA: one 16-byte unit of each 8 KB chunk
constexpr int NT = NTC + 32;     // and a warp that loads
constexpr int CHUNK = 8192;      // bytes a bulk copy, one pair of mbarriers each
constexpr int MAX_CHUNKS = 32;   // 256 KB: more than a CTA's shared memory
constexpr int MAX_CLUSTER = 16;  // CTAs a cluster at most
constexpr int MAX_GB = 8;        // groups an item at most (channels_last)
constexpr int UNROLL = 4;        // units a thread has in flight on the streamed parts
constexpr int RESERVED = 6144;   // shared memory kept for the static arrays (group_norm.py:RESERVED)

template <int UB> struct Raw;
template <> struct Raw<16> { typedef uint4 T; };
template <> struct Raw<8> { typedef uint2 T; };
template <> struct Raw<4> { typedef unsigned int T; };
template <> struct Raw<2> { typedef unsigned short T; };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_ranks() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }
// Sends v into the float2 at p in the shared memory of the cluster's CTA
// `rank`, completing 8 bytes of the transaction on that CTA's mbarrier bar.
__device__ __forceinline__ void st_cluster(const float2* p, float2 v, const uint64_t* bar, uint32_t rank) {
  uint32_t rp, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rp) : "r"(smem_addr(p)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(rb) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n"
               ::"r"(rp), "f"(v.x), "f"(v.y), "r"(rb)
               : "memory");
}
// Waits for the phase of the given parity of bar, whose transactions come
// from other CTAs of the cluster.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
}
// One box of a 2-D tensor map into this CTA's shared memory, completing on bar.
__device__ __forceinline__ void tma_load_2d(const CUtensorMap* map, void* dst, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from device to
// this CTA's shared memory, completing on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// n / d for 0 <= n < 2^31, by a multiply and a shift (d >= 1).
struct FastDiv {
  unsigned m;
  int s, d;
  __host__ FastDiv(int d_ = 1) : m(0), s(0), d(d_) {
    if (d > 1) {
      int l = 0;
      while ((1ll << l) < d) ++l;
      m = (unsigned)(((1ull << (31 + l)) + d - 1) / d);
      s = l - 1;
    }
  }
  __device__ __forceinline__ int operator()(int n) const { return d == 1 ? n : (int)(__umulhi((unsigned)n, m) >> s); }
};

struct GnArgs {
  const void* x;
  void* out;
  const float* scale;  // (C,)
  const float* bias;   // (C,)
  int C, HW, G;
  int gb;        // groups an item: 1 in NCHW; in channels_last a block of consecutive groups
  int cg_shift;  // log2(C / G) where gb > 1
  int items;     // N * G / gb
  int units;     // units of UB bytes in an item
  int slice;     // units a CTA: rank r takes [r * slice, min((r + 1) * slice, units))
  int resident;  // at most this many of them, the last of its slice, stay in shared memory
  int buffers;   // slices of the ring: the producer runs up to this many items ahead
  int rows;      // pixels a box of the channels_last ring
  float eps;
  int silu;
  FastDiv div;  // by the units of a channel's plane (NCHW) or of a pixel (channels_last)
};

// Where the units of one item lie: E elements each, contiguous. In NCHW an
// item is one group, one run, and a unit lies in one channel (HW % E == 0);
// in channels_last an item is gb groups, a pixel holds per_pix units of them,
// and (where gb > 1) the plan starts every slice and resident part on a pixel.
template <typename T, bool CL, int E>
struct Item {
  size_t base;  // element offset of unit 0
  int C, n, c0, per_pix;
  FastDiv div;
  __device__ __forceinline__ Item(const GnArgs& a, int it) : C(a.C), div(a.div) {
    const int per_n = a.G / a.gb;
    n = it / per_n;
    c0 = (it - n * per_n) * a.gb * (a.C / a.G);
    per_pix = a.gb * (a.C / a.G) / E;
    base = CL ? (size_t)n * a.HW * a.C + c0 : ((size_t)n * a.C + c0) * a.HW;
  }
  __device__ __forceinline__ size_t elem(int u) const {
    if (!CL) return base + (size_t)u * E;
    const int p = div(u);
    return base + (size_t)p * C + (size_t)(u - p * per_pix) * E;
  }
  // the element offset of the unit in its pixel's run (channels_last)
  __device__ __forceinline__ int pos(int u) const { return CL ? (u - div(u) * per_pix) * E : 0; }
  // the channel of the unit's first element (the unit's channels follow it in channels_last)
  __device__ __forceinline__ int channel(int u) const { return c0 + (CL ? pos(u) : div(u)); }
};

// Sums of a unit's elements into A accumulators: one (NCHW), or one for
// each element's place in the unit (channels_last, where the places of a
// thread's units belong to fixed groups of the item).
template <typename T, int E, int A, typename R>
__device__ __forceinline__ void accumulate(const R& r, float (&s)[A], float (&ss)[A]) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const float v = to_f(e[i]);
    s[A == 1 ? 0 : i] += v;
    ss[A == 1 ? 0 : i] += v * v;
  }
}

// y * sigmoid(y) = y / (1 + exp(-y)), in every dtype by two MUFU operations
// (ex2.approx and rcp.approx, relative error about 2^-21 for every y; the
// one-instruction form 0.5 y (1 + tanh.approx(0.5 y)) is off by 0.5% at y = -3
// and 1.4% at y = -4, more than a bf16 rounding). For y below about -87,
// exp(-y) is inf and the result -0.
__device__ __forceinline__ float silu(float y) { return __fdividef(y, 1.f + __expf(-y)); }

// A unit normalised: y = x * mul + add, with mul = rstd * scale[c] and add =
// bias[c] - mean * mul for element i's channel c (c0 + i in channels_last, c0
// in NCHW) and its group's (mean, rstd) from st (st[0] in NCHW; the group of
// element offset e0 + i of the item's run in channels_last).
template <typename T, bool CL, int E, typename R>
__device__ __forceinline__ R normalise(const R& r, int c0, int e0, const float2* st, const GnArgs& a) {
  const T* e = reinterpret_cast<const T*>(&r);
  R o;
  T* oe = reinterpret_cast<T*>(&o);
  float mul = 0.f, add = 0.f;
  if (!CL) {
    const float2 m = st[0];
    mul = m.y * __ldg(a.scale + c0);
    add = __ldg(a.bias + c0) - m.x * mul;
  }
#pragma unroll
  for (int i = 0; i < E; ++i) {
    if (CL) {
      const float2 m = st[a.gb > 1 ? (e0 + i) >> a.cg_shift : 0];
      mul = m.y * __ldg(a.scale + c0 + i);
      add = __ldg(a.bias + c0 + i) - m.x * mul;
    }
    float y = fmaf(to_f(e[i]), mul, add);
    if (a.silu) y = silu(y);
    oe[i] = from_f<T>(y);
  }
  return o;
}

// The same with a thread's coefficients for the E places of its units
// (channels_last, where every unit of the thread sits at one place of the
// pixel's run).
template <typename T, int E, typename R>
__device__ __forceinline__ R normalise_fixed(const R& r, const float (&mul)[E], const float (&add)[E], int act) {
  const T* e = reinterpret_cast<const T*>(&r);
  R o;
  T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
  for (int i = 0; i < E; ++i) {
    float y = fmaf(to_f(e[i]), mul[i], add[i]);
    if (act) y = silu(y);
    oe[i] = from_f<T>(y);
  }
  return o;
}

template <typename T, bool CL, int UB>
__global__ void __launch_bounds__(NT, 1) gn_cluster(const GnArgs a, const __grid_constant__ CUtensorMap tmap) {
  typedef typename Raw<UB>::T R;
  constexpr int E = UB / (int)sizeof(T);
  constexpr int A = CL ? E : 1;          // accumulators a thread
  constexpr bool RING = UB == 16;        // the producer fills a ring (bulk copies; boxes in channels_last)
  constexpr int CU = CHUNK / UB;         // a chunk's room, in units: one a computing thread
  constexpr int GBS = CL ? MAX_GB : 1;   // groups an item at most
  extern __shared__ __align__(128) uint8_t smem[];
  R* res = reinterpret_cast<R*>(smem);
  __shared__ __align__(8) uint64_t full[MAX_CHUNKS], empty[MAX_CHUNKS], xbar[2];
  __shared__ __align__(8) float2 parts[2][MAX_CLUSTER][GBS];  // the cluster's (s, ss) of an item, by rank
  __shared__ float red[2][NT / 32][GBS];
  __shared__ float2 stats[GBS];  // each group's mean, 1 / sqrt(var + eps)

  const int t = threadIdx.x;
  const uint32_t rank = cluster_rank(), ranks = cluster_ranks();
  const int first = blockIdx.x / ranks, step = gridDim.x / ranks;
  const long long lo_ll = (long long)rank * a.slice;
  const int lo = lo_ll < a.units ? (int)lo_ll : a.units;
  const int hi = a.units - lo < a.slice ? a.units : lo + a.slice;
  const int nres = hi - lo < a.resident ? hi - lo : a.resident;
  const int mid = hi - nres;                        // [lo, mid) streamed, [mid, hi) resident
  // units a chunk holds: CU in NCHW, `rows` pixels of the item in channels_last
  const int cu = RING ? (CL ? a.rows * (a.gb * (a.C / a.G) / E) : CU) : 1;
  const int cps = RING ? (nres + cu - 1) / cu : 0;  // chunks of a slice in the ring
  const int gb = CL ? a.gb : 1;
  const T* x = reinterpret_cast<const T*>(a.x);
  T* out = reinterpret_cast<T*>(a.out);

  if (t == 0) {
    for (int c = 0; c < cps * a.buffers; ++c) {
      mbar_init(&full[c], 1);
      mbar_init(&empty[c], NTC / 32);
    }
    mbar_init(&xbar[0], 1);
    mbar_init(&xbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  cluster_arrive();
  cluster_wait();  // every CTA's barriers are ready for the others' stores

  if (t < 32) {
    if (RING && t == 0) {  // the producer: each item's resident part, chunk by chunk, into the ring
      for (int i = 0, it = first; it < a.items; ++i, it += step) {
        const int b = i % a.buffers;
        const Item<T, CL, E> item(a, it);
        const uint8_t* src = reinterpret_cast<const uint8_t*>(x + item.elem(mid));
        for (int c = 0; c < cps; ++c) {
          const int k = b * cps + c;
          if (i >= a.buffers) mbar_wait(&empty[k], (uint32_t)(i / a.buffers - 1) & 1);
          if (CL) {  // a whole box, its rows past the slice (or the tensor: zeros) unread
            mbar_expect(&full[k], (uint32_t)cu * UB);
            tma_load_2d(&tmap, smem + (size_t)k * CHUNK, &full[k], item.c0,
                        item.n * a.HW + (mid + c * cu) / item.per_pix);
          } else {
            const int units = nres - c * cu < cu ? nres - c * cu : cu;
            mbar_expect(&full[k], (uint32_t)units * UB);
            bulk_load(smem + (size_t)k * CHUNK, src + (size_t)c * CHUNK, (uint32_t)units * UB, &full[k]);
          }
        }
      }
    }
    __syncwarp();
  } else {
    const int ct = t - 32, warp = t >> 5, lane = t & 31;
    for (int i = 0, it = first; it < a.items; ++i, it += step) {
      const Item<T, CL, E> item(a, it);
      const int b = i % a.buffers;
      const uint32_t phase = (uint32_t)(i / a.buffers) & 1;
      R* ring = res + (size_t)b * cps * CU;  // chunks CHUNK bytes apart
      if (ct == 0) mbar_expect(&xbar[i & 1], ranks * gb * (uint32_t)sizeof(float2));  // this item's parts

      float s[A], ss[A];
#pragma unroll
      for (int k = 0; k < A; ++k) s[k] = ss[k] = 0.f;
      // 1a. the streamed part, summed from device memory
      for (int j0 = lo + ct; j0 < mid; j0 += NTC * UNROLL) {
        R r[UNROLL];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k)
          if (j0 + k * NTC < mid) r[k] = __ldg(reinterpret_cast<const R*>(x + item.elem(j0 + k * NTC)));
#pragma unroll
        for (int k = 0; k < UNROLL; ++k)
          if (j0 + k * NTC < mid) accumulate<T, E, A>(r[k], s, ss);
      }
      // 1b. the resident part: from the ring as each chunk lands, or loaded here and kept
      if (RING) {
        for (int c0 = 0; c0 < cps; c0 += UNROLL) {
          R r[UNROLL];
#pragma unroll
          for (int k = 0; k < UNROLL; ++k)
            if (c0 + k < cps) {
              mbar_wait(&full[b * cps + c0 + k], phase);
              if (ct < cu && (c0 + k) * cu + ct < nres) r[k] = ring[(c0 + k) * CU + ct];
            }
#pragma unroll
          for (int k = 0; k < UNROLL; ++k)
            if (c0 + k < cps && ct < cu && (c0 + k) * cu + ct < nres) accumulate<T, E, A>(r[k], s, ss);
        }
      } else {
        for (int j0 = ct; j0 < nres; j0 += NTC * UNROLL) {
          R r[UNROLL];
#pragma unroll
          for (int k = 0; k < UNROLL; ++k)
            if (j0 + k * NTC < nres) r[k] = __ldg(reinterpret_cast<const R*>(x + item.elem(mid + j0 + k * NTC)));
#pragma unroll
          for (int k = 0; k < UNROLL; ++k)
            if (j0 + k * NTC < nres) {
              res[j0 + k * NTC] = r[k];  // read back by this thread alone
              accumulate<T, E, A>(r[k], s, ss);
            }
        }
      }

      // 2. the CTA's sums of each group in warp order, sent to every CTA; the cluster's in rank order.
      // A thread's units all start at element offset item.pos(lo + ct) of their pixel's run (gb > 1).
      const int e0 = item.pos(lo + ct);
      for (int g = 0; g < gb; ++g) {
        float vs = 0.f, vss = 0.f;
#pragma unroll
        for (int k = 0; k < A; ++k)
          if (!CL || gb == 1 || ((e0 + k) >> a.cg_shift) == g) {
            vs += s[k];
            vss += ss[k];
          }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          vs += __shfl_xor_sync(0xffffffffu, vs, o);
          vss += __shfl_xor_sync(0xffffffffu, vss, o);
        }
        if (lane == 0) {
          red[0][warp][g] = vs;
          red[1][warp][g] = vss;
        }
      }
      named_sync(1, NTC);
      if (ct == 0) {
        for (int g = 0; g < gb; ++g) {
          float ts = 0.f, tss = 0.f;
          for (int w = 1; w < NT / 32; ++w) {
            ts += red[0][w][g];
            tss += red[1][w][g];
          }
          for (uint32_t r = 0; r < ranks; ++r)
            st_cluster(&parts[i & 1][rank][g], make_float2(ts, tss), &xbar[i & 1], r);
        }
        mbar_wait_cluster(&xbar[i & 1], (uint32_t)(i >> 1) & 1);
        const float cnt = (float)(a.C / a.G) * (float)a.HW;
        for (int g = 0; g < gb; ++g) {
          float ts = 0.f, tss = 0.f;
          for (uint32_t r = 0; r < ranks; ++r) {
            ts += parts[i & 1][r][g].x;
            tss += parts[i & 1][r][g].y;
          }
          const float mean = ts / cnt;
          const float var = tss / cnt - mean * mean;
          stats[g] = make_float2(mean, rsqrtf(var + a.eps));
        }
      }
      named_sync(1, NTC);

      // In channels_last, where the pixel's units divide the computing threads, every unit a thread
      // meets sits at the place (ct % per_pix) of its pixel's run: the affine is worked out once an item.
      const bool fixed = CL && NTC % item.per_pix == 0;
      float cm[A], ca[A];
      if (CL && fixed) {
        const int p0 = (ct % item.per_pix) * E;
#pragma unroll
        for (int k = 0; k < A; ++k) {
          const float2 m = stats[gb > 1 ? (p0 + k) >> a.cg_shift : 0];
          cm[k] = m.y * __ldg(a.scale + item.c0 + p0 + k);
          ca[k] = __ldg(a.bias + item.c0 + p0 + k) - m.x * cm[k];
        }
      }
      auto norm = [&](const R& r, int u) -> R {
        if constexpr (CL) {
          if (fixed) return normalise_fixed<T, E>(r, cm, ca, a.silu);
        }
        return normalise<T, CL, E>(r, item.channel(u), item.pos(u), stats, a);
      };

      // 3a. the resident part, from shared memory; each chunk freed for a later item
      if (RING) {
        for (int c0 = 0; c0 < cps; c0 += UNROLL) {
#pragma unroll
          for (int k = 0; k < UNROLL; ++k) {
            const int j = (c0 + k) * cu + ct;
            if (c0 + k < cps && ct < cu && j < nres) {
              const int u = mid + j;
              *reinterpret_cast<R*>(out + item.elem(u)) = norm(ring[(c0 + k) * CU + ct], u);
            }
          }
          __syncwarp();
          if (lane == 0)
            for (int k = 0; k < UNROLL && c0 + k < cps; ++k) mbar_arrive(&empty[b * cps + c0 + k]);
        }
      } else {
        for (int j0 = ct; j0 < nres; j0 += NTC * UNROLL) {
#pragma unroll
          for (int k = 0; k < UNROLL; ++k)
            if (j0 + k * NTC < nres) {
              const int u = mid + j0 + k * NTC;
              *reinterpret_cast<R*>(out + item.elem(u)) = norm(res[j0 + k * NTC], u);
            }
        }
      }
      // 3b. the streamed part again, in blocks of NTC units from the most recently read back to lo
      const int blocks = (mid - lo + NTC - 1) / NTC;
      for (int b0 = 0; b0 < blocks; b0 += UNROLL) {
        R r[UNROLL];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const int u = mid - NTC * (b0 + k + 1) + ct;
          if (b0 + k < blocks && u >= lo) r[k] = __ldg(reinterpret_cast<const R*>(x + item.elem(u)));
        }
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const int u = mid - NTC * (b0 + k + 1) + ct;
          if (b0 + k < blocks && u >= lo) *reinterpret_cast<R*>(out + item.elem(u)) = norm(r[k], u);
        }
      }
    }
  }
  cluster_arrive();
  cluster_wait();  // no CTA leaves while another may still store into its shared memory
}

// A launch of `ctas` CTAs in clusters of `cluster`, attr its one attribute.
cudaLaunchConfig_t config(int ctas, int cluster, int smem, cudaStream_t s, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The kernel's attributes for a launch of this shared memory and cluster
// size on the current device: the most shared memory asked for so far, and
// clusters over 8 allowed once one is asked for; set only when they grow.
template <typename T, bool CL, int UB>
cudaError_t prepare(int cluster, int smem) {
  constexpr int DEVICES = 64;
  static int smem_set[DEVICES], wide_set[DEVICES];
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  auto kern = gn_cluster<T, CL, UB>;
  std::lock_guard<std::mutex> guard(lock);
  if (dev >= DEVICES || smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < DEVICES) smem_set[dev] = smem;
  }
  if (cluster > 8 && (dev >= DEVICES || !wide_set[dev])) {
    if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)) != cudaSuccess)
      return err;
    if (dev < DEVICES) wide_set[dev] = 1;
  }
  return cudaSuccess;
}

// How many clusters of the kernel run at once on the current device, for a
// cluster size and shared memory: asked of the runtime once per (kernel,
// device, cluster, smem) and kept.
template <typename T, bool CL, int UB>
cudaError_t active_clusters(int cluster, int smem, int* count) {
  struct Entry {
    int dev, cluster, smem, count;
  };
  static Entry cache[64];
  static int used = 0;
  static std::mutex lock;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i)
    if (cache[i].dev == dev && cache[i].cluster == cluster && cache[i].smem == smem) {
      *count = cache[i].count;
      return cudaSuccess;
    }
  err = prepare<T, CL, UB>(cluster, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(cluster * 64, cluster, smem, 0, attr);
  err = cudaOccupancyMaxActiveClusters(count, (const void*)gn_cluster<T, CL, UB>, &cfg);
  if (err != cudaSuccess) return err;
  if (used < 64) cache[used++] = Entry{dev, cluster, smem, *count};
  return cudaSuccess;
}

// x (N, H, W, C) channels_last as a 2-D map of N * HW rows of C channels,
// whose box is `rows` pixels of the gb * C / G channels of an item.
template <typename T>
int make_map(CUtensorMap* map, const GnArgs& a, int N) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)a.C, (cuuint64_t)N * a.HW};
  const cuuint64_t strides[1] = {(cuuint64_t)a.C * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(a.gb * (a.C / a.G)), (cuuint32_t)a.rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                            const_cast<void*>(a.x), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, bool CL, int UB>
int launch(GnArgs a, int N, int cluster, int smem, cudaStream_t s) {
  constexpr int E = UB / (int)sizeof(T);
  a.div = FastDiv(CL ? a.gb * (a.C / a.G) / E : a.HW / E);
  alignas(64) CUtensorMap tmap = {};
  if (CL && UB == 16) {
    const int rc = make_map<T>(&tmap, a, N);
    if (rc) return rc;
  }
  int active = 0;
  cudaError_t err = active_clusters<T, CL, UB>(cluster, smem, &active);
  if (err != cudaSuccess) return (int)err;
  if (active < 1) return (int)cudaErrorInvalidConfiguration;  // a cluster of this size does not schedule
  if ((err = prepare<T, CL, UB>(cluster, smem)) != cudaSuccess) return (int)err;
  const int clusters = a.items < active ? a.items : active;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config(clusters * cluster, cluster, smem, s, attr);
  err = cudaLaunchKernelEx(&cfg, gn_cluster<T, CL, UB>, a, tmap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, bool CL>
int by_unit(const GnArgs& a, int N, int ub, int cluster, int smem, cudaStream_t s) {
  switch (ub) {
    case 16: return launch<T, CL, 16>(a, N, cluster, smem, s);
    case 8: return launch<T, CL, 8>(a, N, cluster, smem, s);
    case 4: return launch<T, CL, 4>(a, N, cluster, smem, s);
    case 2:
      if constexpr (sizeof(T) == 2) return launch<T, CL, 2>(a, N, cluster, smem, s);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x and out are (N, C, H, W)-shaped, both
// NCHW-contiguous or both channels_last; scale and bias are (C,) float32.
// params: 16 ints, N, C, HW, G, channels_last (0 or 1), unit_bytes, silu (0
// or 1), cluster, gb, cg_shift, units, slice, resident, buffers, rows, smem.
// An item is one group (NCHW) or `gb` consecutive groups (channels_last;
// C / G = 2^cg_shift where gb > 1), `units` units of unit_bytes (16, 8, 4 or
// 2 in bf16) each, dividing HW * sizeof (NCHW) or gb * C / G * sizeof
// (channels_last) and x's alignment. Clusters of `cluster` CTAs (1-16),
// each CTA taking `slice` units of an item and keeping the last `resident`
// of them in shared memory (whole pixels in channels_last): with 16-byte
// units a ring of `buffers` slices of 8 KB chunks (in channels_last boxes
// of `rows` pixels), in `smem` bytes of dynamic shared memory
// (group_norm.py:plan). One launch; returns its error (0 on success).
int dgmsr_group_norm(int dtype, const void* x, const void* scale, const void* bias, void* out, const void* params,
                     float eps, void* stream) {
  const int* p = static_cast<const int*>(params);
  const int N = p[0], C = p[1], HW = p[2], G = p[3], channels_last = p[4], unit_bytes = p[5], silu = p[6];
  const int cluster = p[7], gb = p[8], buffers = p[13], smem = p[15];
  auto s = static_cast<cudaStream_t>(stream);
  GnArgs a;
  a.x = x;
  a.out = out;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.C = C;
  a.HW = HW;
  a.G = G;
  a.gb = gb;
  a.cg_shift = p[9];
  a.items = N * G / gb;
  a.units = p[10];
  a.slice = p[11];
  a.resident = p[12];
  a.buffers = buffers;
  a.rows = p[14];
  a.eps = eps;
  a.silu = silu;
  if (cluster < 1 || cluster > MAX_CLUSTER || buffers < 1 || gb < 1 || gb > MAX_GB || G % gb ||
      (gb > 1 && !channels_last))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return channels_last ? by_unit<bf16, true>(a, N, unit_bytes, cluster, smem, s)
                         : by_unit<bf16, false>(a, N, unit_bytes, cluster, smem, s);
  return channels_last ? by_unit<float, true>(a, N, unit_bytes, cluster, smem, s)
                       : by_unit<float, false>(a, N, unit_bytes, cluster, smem, s);
}

// The current device's limits for the plan: out[0] its SM count, out[1] the
// shared memory a CTA may opt in to, out[2 + i] how many clusters of 2 << i
// CTAs (2, 4, 8, 16) with the largest slice (out[1] - RESERVED bytes) can
// run at once (0: such a cluster does not schedule; a CTA takes a whole SM
// at any slice). Returns the first error (0 on success).
int dgmsr_group_norm_limits(int dtype, void* out, void* stream) {
  (void)dtype;
  (void)stream;
  int* o = static_cast<int*>(out);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&o[0], cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&o[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < 4; ++i)
    if (active_clusters<bf16, false, 16>(2 << i, o[1] - RESERVED, &o[2 + i]) != cudaSuccess) {
      o[2 + i] = 0;
      cudaGetLastError();  // refused: clusters of this size are not offered, which is no error of the caller's
    }
  return 0;
}

}  // extern "C"
