// An empty kernel: one block of one thread that does nothing. Timed by
// chip_smoke.py in the same CUDA-graph replay as the port's kernels, it
// puts on record the least device time a launch costs on the card, the
// floor under a kernel whose work is a few microseconds (embedding_bag,
// din_attention). Not a kernel of any path; nothing counts its launches.
#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" int launch_floor(void* stream) {
  launch_floor_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
