// Leaf-compacted histogram kernel (K3) for waves wider than 32 slots.
//
// Replaces the JAX package's Pallas `_hist_compact_kernel`
// (lightgbm_tpu/ops/compact.py, reached from `hist_active_compact`
// together with the XLA `compact_plan`).  On the TPU the per-row MXU cost
// of the one-hot histogram grows with the number of active slots, so the
// reference stable-sorts rows into 32-slot leaf groups and runs one
// 32-column matmul per group.  On Hopper the per-row cost of an atomic
// histogram does not grow with the slot count, and int32 atomics are
// exact in any order, so this port keeps dataset row order: no sort, no
// regroup gather (which alone would move more bytes than the kernel
// reads).  Rows whose hist leaf is not active, bagged-out rows included,
// add nothing, and -1 slots are exact zeros, as in the reference.
//
// What bounds it on an H100: the roofline bound is bytes (hist leaf 4
// B/row, bins G B/row, values C B/row); in practice the G*C shared-memory
// atomics per active row bound it.  With 64 or 128 slots one column of
// the histogram (slots x B x C int32, 128 KB at 128 slots, 64 bins,
// int8h) fills a block's shared memory, so the grid tiles columns one at
// a time and each tile re-reads the hist leaf vector (4 B/row/column);
// slot groups split the slots when even one column does not fit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_smem.cuh"

extern "C" int lgbm_hist_compact(const void* bins_t, long long n_pad, int G,
                                 const void* vals, int C,
                                 const void* hist_leaf, int L,
                                 const void* inv, const void* src, int A,
                                 int B, int Ft, int As, int grid_x,
                                 long long rows_per_block, int block,
                                 void* out, void* stream) {
  int smem = hist_smem_bytes(L, false, As, Ft, B, C);
  cudaFuncSetAttribute(hist_kernel<false>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(grid_x, (G + Ft - 1) / Ft, (A + As - 1) / As);
  hist_kernel<false><<<grid, block, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bins_t, n_pad, G, (const int8_t*)vals, C,
      (const int*)hist_leaf, nullptr, nullptr, L, nullptr, 0,
      (const int*)inv, (const int*)src, A, B, Ft, As, rows_per_block,
      (int*)out);
  return (int)cudaGetLastError();
}
