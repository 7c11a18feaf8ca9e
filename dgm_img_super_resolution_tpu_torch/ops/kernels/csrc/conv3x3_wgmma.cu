// One SAME 3x3 conv C -> C with bias and optional Mish, bf16 at C = 64, by
// hand for Hopper (sm_90a) on warpgroup MMA fed by TMA.
//
// Replaces dgm_img_super_resolution_tpu/ops/pallas/conv3x3.py:
// conv3x3_rowpack for bfloat16 at C = 64 (the Block conv behind
// DGMSR_PALLAS_CONV at the published width), and computes what it computes:
//   v   = rnd(conv3x3(pad(x), w) + b)      pad: ReflectionPad(1) or zeros
//   out = mish ? rnd(mish(v)) : v
// over NHWC tensors, at any B, H, W (H, W >= 2 for the reflect border).
// float32 and C = 32 stay on conv3x3.cu's tiled conv.
//
// Bound on the card: at the main path's shape (B=8, 512x512) one call is
// 2.B.H.W.9.C^2 = 154.6 GFLOP against 537 MB of input and output: 0.160 ms
// for the bytes at 3.35 TB/s, 0.156 ms for the tensor cores, so bytes and
// operations are balanced and both must be kept busy at once. Design: the
// conv core of conv_wgmma.cuh (weights resident and swizzled, a TMA ring of
// halo tiles under the wgmma of the tile before, reflect border patched in
// shared memory, TMA-stored output); this file is its epilogue, bias + Mish.
// Its wgmma m64n64k16 read 4 KB of shared memory per 32 tensor-core clocks,
// the shared memory's whole rate, so shared memory, not the bytes or the
// tensor cores, holds it back (PERF.md section 7).

#include "conv_wgmma.cuh"

using namespace dgmsr::cw;

namespace {

template <bool MISH> struct BiasAct {
  static constexpr int NRES = 0;
  const float* bias;  // (C,) float32
  using Regs = BiasRegs;
  __device__ __forceinline__ Regs setup(int t) const { return bias_regs(bias, t); }
  __device__ __forceinline__ uint32_t operator()(const Regs& r, int n, int, int, int, float s0, float s1, uint32_t,
                                                 uint32_t) const {
    float v0 = rnd(s0 + r.b[2 * n]), v1 = rnd(s1 + r.b[2 * n + 1]);
    if (MISH) {
      v0 = mish(v0);
      v1 = mish(v1);
    }
    return pack(v0, v1);
  }
};

template <bool REFLECT>
int conv(const void* x, const void* w, const float* b, void* out, int act, int B, int H, int W, cudaStream_t s) {
  return act ? launch_conv_wgmma<REFLECT>(x, w, out, BiasAct<true>{b}, B, H, W, s)
             : launch_conv_wgmma<REFLECT>(x, w, out, BiasAct<false>{b}, B, H, W, s);
}

}  // namespace

extern "C" {

// dtype must be 1 (bfloat16) and c 64: the instantiation this kernel has.
// x and out are (B, H, W, 64) NHWC, 16-byte aligned; w is (9, C_out, C_in)
// bf16; b is float32. reflect: 1 for ReflectionPad(1), 0 for zeros; act: 1
// applies Mish. Returns cudaGetLastError() after the launch (0 on success).
int dgmsr_conv3x3_wgmma(int dtype, const void* x, const void* w, const void* b, void* out, int c, int reflect,
                        int act, int B, int H, int W, void* stream) {
  if (dtype != 1 || c != C) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto bias = static_cast<const float*>(b);
  return reflect ? conv<true>(x, w, bias, out, act, B, H, W, s) : conv<false>(x, w, bias, out, act, B, H, W, s);
}

}  // extern "C"
