// An empty kernel, for the launch floor: the device time of one launch, and
// of a pair of dependent launches, that does no work. chip_smoke.py times it
// beside the kernels, whose times at the paths' live counts are mostly this
// fixed cost.

#include <cuda_runtime.h>

__global__ void noop_kernel() {}

// n empty one-block launches in a row on the stream (each waits for the one
// before it, as the two launches of ba_accumulate do)
extern "C" int noop_launch(int n, void* stream) {
  for (int i = 0; i < n; ++i) noop_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
