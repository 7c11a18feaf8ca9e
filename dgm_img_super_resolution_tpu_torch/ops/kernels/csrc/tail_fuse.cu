// The UNet tail region, by hand for Hopper (sm_90a).
//
// Replaces dgm_img_super_resolution_tpu/ops/pallas/tail_fuse.py:
// _tail_fuse_pallas, as tail_reference defines it:
//   y   = rnd(convT_k4s2p1(x) + bt)          (C -> C, zero border, 2x up)
//   m   = rnd(mish(rnd(reflect_conv3x3(y) + bf)))
//   out = rnd(m . wo + bo)                    (1x1, C -> out_dim)
//
// Bound on the card: at B=8, x 256x256 -> out 512x512, C=64 in bf16 the
// region is 224 GFLOP against 80 MB of unavoidable traffic, so the tensor
// cores bound it (0.23 ms at 989 TFLOP/s). Design: two launches of the tiled
// conv kernel in conv_tile.cuh. The ConvT runs as four sub-pixel phases
// (gridDim.y): output pixel (2j+a, 2l+b) is a 2x2 conv of the zero-bordered
// input through the taps kernel[a::2, b::2] of the stored (pre-flipped)
// kernel, so no structural zeros are multiplied. The 3x3 conv then reflects
// its own input y and folds Mish and the 1x1 conv into its epilogue: only
// the 2x-upsampled y goes through device memory (a write and a read of
// B x 2H x 2W x C beyond the fused bound); the Mish output never does.

#include "conv_tile.cuh"

using namespace dgmsr;

namespace {

template <typename T>
int tail(const void* x, const void* wt, const float* bt, const void* wf, const float* bf, const float* wo,
         const float* bo, void* y, void* out, int cout, int B, int H, int W, cudaStream_t s) {
  ConvArgs a = {};
  a.B = B;
  a.H = H;
  a.W = W;
  a.in = x;
  a.w = wt;
  a.bias = bt;
  a.out = y;
  int err = launch_conv<T, 64, 4, false, false, EPI_CONVT>(a, 4, s);
  if (err) return err;
  a.H = 2 * H;
  a.W = 2 * W;
  a.in = y;
  a.w = wf;
  a.bias = bf;
  a.wo = wo;
  a.bo = bo;
  a.cout = cout;
  a.out = out;
  return launch_conv<T, 64, 9, true, false, EPI_TAIL>(a, 1, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. x is (B, H, W, C) NHWC; wt is the ConvT
// weight as (4 phases, 4 taps, C_out, C_in) and wf the 3x3 weight as
// (9, C_out, C_in), both in the activation dtype; wo is (cout, C) float32
// holding values of the activation dtype; biases are float32. y is scratch
// (B, 2H, 2W, C); out is (B, 2H, 2W, cout). Returns cudaGetLastError().
int dgmsr_tail_fuse(int dtype, const void* x, const void* wt, const void* bt, const void* wf, const void* bf,
                    const void* wo, const void* bo, void* y, void* out, int cout, int B, int H, int W,
                    void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == 1) return tail<bf16>(x, wt, f(bt), wf, f(bf), f(wo), f(bo), y, out, cout, B, H, W, s);
  return tail<float>(x, wt, f(bt), wf, f(bf), f(wo), f(bo), y, out, cout, B, H, W, s);
}

}  // extern "C"
