// The gather floor under the route kernels: the memory traffic of a
// route with no decision in it.
//
// Replaces no TPU kernel and runs on no training or serving path, so it
// lives beside the smoke and not in the package: `chip_smoke.py` builds
// it with the package's nvcc flags and times it, in a CUDA graph, on
// the same wave as K2 (lightgbm_tpu_torch/csrc/route.cu).  Each row
// reads its two leaf ids; a row whose leaf splits (`group[leaf]` >= 0)
// reads the one bin K2 reads, bins_t[group, row]; each row writes two
// leaf ids.  So its time is what that access pattern costs on this card
// with as many rows in flight as K2 keeps (ROUTE_ROWS a thread, a
// persistent grid): where K2 sits at this floor, the scattered bin reads
// (through L2, or HBM when the bins outgrow L2) and not the kernel hold
// it (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#define FLOOR_THREADS 512
#define FLOOR_ROWS 4

template <typename BinT>
__global__ void __launch_bounds__(FLOOR_THREADS)
gather_kernel(const BinT* __restrict__ bins_t, long long n_pad,
              const int* __restrict__ leaf2_in, int* __restrict__ leaf2_out,
              const int* __restrict__ group, int magic) {
  const long long step = (long long)gridDim.x * FLOOR_THREADS * FLOOR_ROWS;
  for (long long base =
           (long long)blockIdx.x * FLOOR_THREADS * FLOOR_ROWS + threadIdx.x;
       base < n_pad; base += step) {
    int rl[FLOOR_ROWS], hl[FLOOR_ROWS], c[FLOOR_ROWS];
#pragma unroll
    for (int k = 0; k < FLOOR_ROWS; ++k) {
      const long long row = base + (long long)k * FLOOR_THREADS;
      rl[k] = row < n_pad ? leaf2_in[row] : -1;
      hl[k] = row < n_pad ? leaf2_in[n_pad + row] : -1;
    }
#pragma unroll
    for (int k = 0; k < FLOOR_ROWS; ++k) {
      const long long row = base + (long long)k * FLOOR_THREADS;
      const int g = rl[k] >= 0 ? __ldg(group + rl[k]) : -1;
      c[k] = g >= 0 ? (int)bins_t[(long long)g * n_pad + row] : 0;
    }
#pragma unroll
    for (int k = 0; k < FLOOR_ROWS; ++k) {
      const long long row = base + (long long)k * FLOOR_THREADS;
      if (row >= n_pad) break;
      // `magic` is no bin: the leaves are written unchanged, and the
      // compare keeps the bin load
      leaf2_out[row] = rl[k] + (c[k] == magic);
      leaf2_out[n_pad + row] = hl[k] + (c[k] == magic);
    }
  }
}

// `group` [L]: each leaf's split column, -1 where the leaf does not
// split; `magic` a value no bin takes (-1).
extern "C" int lgbm_gather_floor(const void* bins_t, int bins_int32,
                                 long long n_pad, const void* leaf2_in,
                                 void* leaf2_out, const void* group,
                                 int magic, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = bins_int32 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, gather_kernel<int32_t>, FLOOR_THREADS, 0)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         &per_sm, gather_kernel<uint8_t>, FLOOR_THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  const long long want =
      (n_pad + FLOOR_THREADS * FLOOR_ROWS - 1) / (FLOOR_THREADS * FLOOR_ROWS);
  const int grid = (int)(want < (long long)per_sm * sms
                             ? (want > 0 ? want : 1)
                             : (long long)per_sm * sms);
  cudaStream_t st = (cudaStream_t)stream;
  if (bins_int32)
    gather_kernel<int32_t><<<grid, FLOOR_THREADS, 0, st>>>(
        (const int32_t*)bins_t, n_pad, (const int*)leaf2_in,
        (int*)leaf2_out, (const int*)group, magic);
  else
    gather_kernel<uint8_t><<<grid, FLOOR_THREADS, 0, st>>>(
        (const uint8_t*)bins_t, n_pad, (const int*)leaf2_in,
        (int*)leaf2_out, (const int*)group, magic);
  return (int)cudaGetLastError();
}
