// An empty kernel: the launch floor of this card, timed by chip_smoke.py
// with the same CUDA-event brackets as the port's kernels (no kernel of the
// port can take less).  Not on any serving path.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// One launch of one warp on `stream`; returns cudaGetLastError() after it.
extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
