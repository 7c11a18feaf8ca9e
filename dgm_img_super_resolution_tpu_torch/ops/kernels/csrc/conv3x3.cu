// One SAME 3x3 conv C -> C with bias and optional Mish, by hand for Hopper
// (sm_90a).
//
// Replaces dgm_img_super_resolution_tpu/ops/pallas/conv3x3.py:
// conv3x3_rowpack, the Block conv behind DGMSR_PALLAS_CONV, and computes
// what it computes:
//   v   = rnd(conv3x3(pad(x), w) + b)      pad: ReflectionPad(1) or zeros
//   out = mish ? rnd(mish(v)) : v
// in float32 at C in {32, 64} and bfloat16 at C = 32, NHWC; bfloat16 at
// C = 64, the published width, is conv3x3_wgmma.cu's. The TPU kernel's
// row-pair lane packing and lag pipeline fit the MXU's 128 lanes and the
// sequential grid; neither is copied.
//
// Design: one launch of the tiled conv of conv_tile.cuh (weights resident in
// shared memory, the border built into the halo load, persistent 8x16-pixel
// tiles), which reads each input pixel once from device memory plus its
// tile's halo and writes each output once; float32 on plain FMAs (the card
// checks' precision), bf16 on mma.sync.

#include "conv_tile.cuh"

using namespace dgmsr;

namespace {

template <typename T, int C>
int conv3x3(const void* x, const void* w, const float* b, void* out, int reflect, int act, int B, int H, int W,
            cudaStream_t s) {
  ConvArgs a = {};
  a.in = x;
  a.w = w;
  a.bias = b;
  a.out = out;
  a.B = B;
  a.H = H;
  a.W = W;
  if (reflect)
    return act ? launch_conv<T, C, 9, true, false, EPI_CONV_MISH>(a, 1, s)
               : launch_conv<T, C, 9, true, false, EPI_CONV>(a, 1, s);
  return act ? launch_conv<T, C, 9, false, false, EPI_CONV_MISH>(a, 1, s)
             : launch_conv<T, C, 9, false, false, EPI_CONV>(a, 1, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (c 32 or 64), 1 = bfloat16 (c 32). x and out are
// (B, H, W, C) NHWC; w is (9, C_out, C_in) in the activation dtype; b is
// float32. reflect: 1 for ReflectionPad(1), 0 for zeros; act: 1 applies
// Mish. Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a dtype and width with no instantiation.
int dgmsr_conv3x3(int dtype, const void* x, const void* w, const void* b, void* out, int c, int reflect, int act,
                  int B, int H, int W, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto bias = static_cast<const float*>(b);
  if (dtype == 1 && c == 32) return conv3x3<bf16, 32>(x, w, bias, out, reflect, act, B, H, W, s);
  if (dtype == 0 && c == 32) return conv3x3<float, 32>(x, w, bias, out, reflect, act, B, H, W, s);
  if (dtype == 0 && c == 64) return conv3x3<float, 64>(x, w, bias, out, reflect, act, B, H, W, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
