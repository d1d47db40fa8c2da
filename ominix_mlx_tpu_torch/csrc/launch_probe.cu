// Probes of the kernel launch itself, not a port of any TPU kernel:
// chip_smoke.py's launch_floor line times an empty kernel on an idle card,
// and the same kernel behind a one-CTA kernel, launched after it plainly
// or by programmatic dependent launch (as the rows kernels of K1, K4, K6
// and K8 follow their prologues), to say how much of a small kernel's
// device time is the launch.

#include "qmm_common.cuh"

namespace {

// Does nothing; with wait, first waits for the grid it depends on.
__global__ void probe_empty(int wait) {
  if (wait) griddep_wait();
}

// One CTA that lets its dependents start at once, then does nothing.
__global__ void probe_one(int) { griddep_launch_dependents(); }

}  // namespace

extern "C" {

// mode 0: probe_empty over ctas CTAs of 128 threads; mode 1: probe_one,
// then probe_empty behind it by programmatic dependent launch; mode 2:
// probe_one, then probe_empty launched plainly. Returns the first CUDA
// error.
int ominix_launch_probe(int mode, int ctas, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (mode < 0 || mode > 2 || ctas < 1) return (int)cudaErrorInvalidValue;
  if (mode > 0) {
    const cudaError_t e =
        launch_kernel(probe_one, dim3(1), dim3(128), 0, false, st, 0);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)launch_kernel(probe_empty, dim3(ctas), dim3(128), 0, mode == 1,
                            st, mode == 1 ? 1 : 0);
}

}  // extern "C"
