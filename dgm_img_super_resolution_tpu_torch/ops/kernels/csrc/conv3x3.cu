// One SAME 3x3 conv C -> C with bias and optional Mish, by hand for Hopper
// (sm_90a).
//
// Replaces dgm_img_super_resolution_tpu/ops/pallas/conv3x3.py:
// conv3x3_rowpack, the Block conv behind DGMSR_PALLAS_CONV, and computes
// what it computes:
//   v   = rnd(conv3x3(pad(x), w) + b)      pad: ReflectionPad(1) or zeros
//   out = mish ? rnd(mish(v)) : v
// for C in {32, 64}, float32 or bfloat16, NHWC. The TPU kernel's row-pair
// lane packing and lag pipeline fit the MXU's 128 lanes and the sequential
// grid; neither is copied.
//
// Bound on the card: at the main path's shape (B=8, 512x512, C=64, bf16)
// one call is 2.B.H.W.9.C^2 = 154.6 GFLOP against 537 MB of input and output,
// so the memory bounds it (0.160 ms at 3.35 TB/s, against 0.156 ms for the
// tensor cores). Design: one launch of the tiled conv of conv_tile.cuh
// (weights resident in shared memory, the border built into the halo load,
// persistent 8x16-pixel tiles), which reads each input pixel once from device
// memory plus its tile's halo and writes each output once.

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

template <typename T>
int dispatch(int c, const void* x, const void* w, const float* b, void* out, int reflect, int act, int B, int H,
             int W, cudaStream_t s) {
  if (c == 32) return conv3x3<T, 32>(x, w, b, out, reflect, act, B, H, W, s);
  if (c == 64) return conv3x3<T, 64>(x, w, b, out, reflect, act, B, H, W, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x and out are (B, H, W, C) NHWC; w is
// (9, C_out, C_in) in the activation dtype; b is float32. reflect: 1 for
// ReflectionPad(1), 0 for zeros; act: 1 applies Mish. Returns
// cudaGetLastError() after the launch (0 on success).
int dgmsr_conv3x3(int dtype, const void* x, const void* w, const void* b, void* out, int c, int reflect, int act,
                  int B, int H, int W, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto bias = static_cast<const float*>(b);
  if (dtype == 1) return dispatch<bf16>(c, x, w, bias, out, reflect, act, B, H, W, s);
  return dispatch<float>(c, x, w, bias, out, reflect, act, B, H, W, s);
}

}  // extern "C"
