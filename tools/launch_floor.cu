// An empty kernel: the launch floor beside which the route kernels are
// read.
//
// Replaces no TPU kernel and runs on no training or serving path, so it
// lives beside the smoke and not in the package: `chip_smoke.py` builds
// it with the package's nvcc flags and times it at the route kernels'
// grid, back to back and as launches captured in a CUDA graph, so that
// the time K2 and K4 (lightgbm_tpu_torch/csrc/route.cu) take beyond
// their byte bound can be split into the cost of a launch of that shape
// and the kernels' own work (PERF.md).
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int lgbm_empty(int grid, int block, void* stream) {
  empty_kernel<<<grid, block, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
