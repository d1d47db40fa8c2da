// Copied from ominix_mlx_tpu/native/resample.cc (unchanged below this
// note) for the torch package, which builds and loads its own copy
// (ominix_mlx_tpu_torch/native/__init__.py) and imports nothing of the JAX
// package.
// High-quality audio resampler (windowed-sinc), the native half of the
// audio IO path. Counterpart of the reference's host-side audio runtime
// (mlx-rs-core/src/audio.rs:285 linear `resample`) — upgraded from linear
// interpolation to a Hann-windowed sinc kernel (proper band-limited
// resampling), implemented in C++ for host-side throughput on long files.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <vector>

namespace {
const double kPi = 3.14159265358979323846;

inline double sinc(double x) {
  if (std::fabs(x) < 1e-12) return 1.0;
  const double px = kPi * x;
  return std::sin(px) / px;
}
}  // namespace

extern "C" {

// Resample `n_in` float32 samples from `src_rate` to `dst_rate` into `out`
// (caller allocates ceil(n_in * dst_rate / src_rate) floats).
// `taps` is the half-width of the sinc kernel (e.g. 16 or 32).
// Returns the number of output samples written.
int64_t resample_sinc(const float* in, int64_t n_in, double src_rate,
                      double dst_rate, float* out, int64_t n_out, int taps) {
  if (n_in <= 0 || n_out <= 0) return 0;
  const double ratio = src_rate / dst_rate;       // input samples per output
  // When downsampling, widen + lowpass the kernel by the ratio.
  const double scale = ratio > 1.0 ? 1.0 / ratio : 1.0;
  const double width = taps / scale;              // input-sample half-width

  for (int64_t i = 0; i < n_out; ++i) {
    const double center = i * ratio;
    const int64_t lo = (int64_t)std::ceil(center - width);
    const int64_t hi = (int64_t)std::floor(center + width);
    double acc = 0.0, wsum = 0.0;
    for (int64_t j = lo; j <= hi; ++j) {
      const double d = (center - j) * scale;
      // Hann window over the kernel support
      const double w = 0.5 * (1.0 + std::cos(kPi * d / taps));
      const double k = sinc(d) * w * scale;
      wsum += k;
      const int64_t jj = j < 0 ? 0 : (j >= n_in ? n_in - 1 : j);
      acc += k * in[jj];
    }
    // normalize by the kernel sum: keeps DC gain exactly 1 at every phase
    out[i] = (float)(acc / (wsum > 1e-12 ? wsum : 1.0));
  }
  return n_out;
}

// int16 PCM -> float32 in [-1, 1] (vectorizable tight loop).
void pcm16_to_float(const int16_t* in, int64_t n, float* out) {
  constexpr float kInv = 1.0f / 32768.0f;
  for (int64_t i = 0; i < n; ++i) out[i] = in[i] * kInv;
}

// float32 -> int16 PCM with clamping.
void float_to_pcm16(const float* in, int64_t n, int16_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    float v = in[i];
    v = v > 1.0f ? 1.0f : (v < -1.0f ? -1.0f : v);
    out[i] = (int16_t)std::lrintf(v * 32767.0f);
  }
}

}  // extern "C"
