// Native host-side image ops of the PyTorch port (its own copy of the JAX
// package's native/src/imageops.cc, built and loaded by ../__init__.py).
//
// It covers the host leg of the pipeline: the per-sample CPU work the
// reference does in Python/PIL/NumPy (MATLAB-exact bicubic `imresize`,
// reference srdiff/model.py:1163-1312, and the uint8 <-> [-1,1] float
// conversions of its `Measure`/transform glue, model.py:1516-1558), as a
// dependency-free C++ shared library with a thread pool, so host code is
// not bound by the GIL.
//
// Exactness: cubic kernel a=-0.5, antialias pre-scale when shrinking,
// symmetric (mirror) boundary, per-row weight renormalisation: the same
// algorithm as ops/resize.py::_matrix_matlab, all weights in double.
// Parity with the matrix path is held by tests/test_torch_port_native.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

inline double cubic(double x) {
  const double a = -0.5;
  x = std::fabs(x);
  const double x2 = x * x, x3 = x2 * x;
  if (x <= 1.0) return (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0;
  if (x <= 2.0) return a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a;
  return 0.0;
}

// Weight/index table for one axis (MATLAB imresize "contributions").
struct AxisTable {
  int taps;                 // weights per output coordinate
  std::vector<double> w;    // (out_len, taps)
  std::vector<int> idx;     // (out_len, taps), already mirror-mapped
};

AxisTable build_table(int in_len, int out_len) {
  const double scale = static_cast<double>(out_len) / in_len;
  const bool shrink = scale < 1.0;
  const double kw = shrink ? 4.0 / scale : 4.0;
  const int taps = static_cast<int>(std::ceil(kw)) + 2;

  AxisTable t;
  t.taps = taps;
  t.w.resize(static_cast<size_t>(out_len) * taps);
  t.idx.resize(static_cast<size_t>(out_len) * taps);

  for (int o = 0; o < out_len; ++o) {
    const double u = (o + 1) / scale + 0.5 * (1.0 - 1.0 / scale);
    const double left = std::floor(u - kw / 2.0);
    double sum = 0.0;
    for (int k = 0; k < taps; ++k) {
      const double col = left + k - 1.0;       // 0-indexed tap position
      const double d = u - col - 1.0;
      const double wk = shrink ? scale * cubic(scale * d) : cubic(d);
      t.w[static_cast<size_t>(o) * taps + k] = wk;
      sum += wk;
      // symmetric (mirror, no repeated edge) boundary
      long c = static_cast<long>(col);
      long m = ((c % (2L * in_len)) + 2L * in_len) % (2L * in_len);
      t.idx[static_cast<size_t>(o) * taps + k] =
          static_cast<int>(m < in_len ? m : 2L * in_len - 1L - m);
    }
    for (int k = 0; k < taps; ++k)
      t.w[static_cast<size_t>(o) * taps + k] /= sum;
  }
  return t;
}

void parallel_for(int n, int nthreads, const std::function<void(int, int)>& fn) {
  nthreads = std::max(1, std::min(nthreads, n));
  if (nthreads == 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  const int chunk = (n + nthreads - 1) / nthreads;
  for (int i = 0; i < nthreads; ++i) {
    const int lo = i * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back(fn, lo, hi);
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// HWC double image resize: in (h,w,c) -> out (oh,ow,c). Returns 0 on success.
int matlab_resize_f64(const double* in, int h, int w, int c, int oh, int ow,
                      double* out, int nthreads) {
  if (h <= 0 || w <= 0 || c <= 0 || oh <= 0 || ow <= 0) return 1;
  const AxisTable th_ = build_table(h, oh);
  const AxisTable tw_ = build_table(w, ow);

  // pass 1: rows (h -> oh), width/channels unchanged
  std::vector<double> tmp(static_cast<size_t>(oh) * w * c);
  parallel_for(oh, nthreads, [&](int lo, int hi) {
    for (int o = lo; o < hi; ++o) {
      double* dst = &tmp[static_cast<size_t>(o) * w * c];
      std::memset(dst, 0, sizeof(double) * w * c);
      for (int k = 0; k < th_.taps; ++k) {
        const double wk = th_.w[static_cast<size_t>(o) * th_.taps + k];
        const double* src =
            &in[static_cast<size_t>(th_.idx[static_cast<size_t>(o) * th_.taps + k]) * w * c];
        for (int j = 0; j < w * c; ++j) dst[j] += wk * src[j];
      }
    }
  });

  // pass 2: cols (w -> ow)
  parallel_for(oh, nthreads, [&](int lo, int hi) {
    for (int r = lo; r < hi; ++r) {
      const double* src_row = &tmp[static_cast<size_t>(r) * w * c];
      double* dst_row = &out[static_cast<size_t>(r) * ow * c];
      for (int o = 0; o < ow; ++o) {
        double* dst = &dst_row[static_cast<size_t>(o) * c];
        for (int ch = 0; ch < c; ++ch) dst[ch] = 0.0;
        for (int k = 0; k < tw_.taps; ++k) {
          const double wk = tw_.w[static_cast<size_t>(o) * tw_.taps + k];
          const double* src =
              &src_row[static_cast<size_t>(tw_.idx[static_cast<size_t>(o) * tw_.taps + k]) * c];
          for (int ch = 0; ch < c; ++ch) dst[ch] += wk * src[ch];
        }
      }
    }
  });
  return 0;
}

// uint8 HWC in/out (round + clip like reference convertDouble2Byte,
// model.py:1309-1312).
int matlab_resize_u8(const uint8_t* in, int h, int w, int c, int oh, int ow,
                     uint8_t* out, int nthreads) {
  std::vector<double> fin(static_cast<size_t>(h) * w * c);
  for (size_t i = 0; i < fin.size(); ++i) fin[i] = in[i];
  std::vector<double> fout(static_cast<size_t>(oh) * ow * c);
  const int rc = matlab_resize_f64(fin.data(), h, w, c, oh, ow, fout.data(), nthreads);
  if (rc) return rc;
  for (size_t i = 0; i < fout.size(); ++i) {
    double v = std::nearbyint(std::min(255.0, std::max(0.0, fout[i])));
    out[i] = static_cast<uint8_t>(v);
  }
  return 0;
}

// uint8 [0,255] -> float32 [-1,1]
void u8_to_pm1(const uint8_t* in, float* out, long n, int nthreads) {
  parallel_for(static_cast<int>(std::min<long>(n, 1 << 30)), nthreads, [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) out[i] = static_cast<float>(in[i]) / 127.5f - 1.0f;
  });
}

// float32 [-1,1] -> uint8 [0,255] (round-half-away like numpy.around on .5
// boundaries is banker's rounding; use nearbyint to match numpy default)
void pm1_to_u8(const float* in, uint8_t* out, long n, int nthreads) {
  parallel_for(static_cast<int>(std::min<long>(n, 1 << 30)), nthreads, [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      const double v = (static_cast<double>(in[i]) + 1.0) * 127.5;
      out[i] = static_cast<uint8_t>(std::nearbyint(std::min(255.0, std::max(0.0, v))));
    }
  });
}

}  // extern "C"
