// Fused route + histogram kernel (K1).
//
// Replaces the JAX package's Pallas `_hist_route_kernel`
// (lightgbm_tpu/ops/pallas_histogram.py, reached from `hist_route_pallas`):
// apply the previous wave's pending splits to both leaf vectors, then
// histogram the active leaves over the routed hist leaves, from one pass
// over the bins.  The TPU kernel builds a one-hot of every (column, bin)
// and contracts it with leaf-masked value columns on the MXU, because
// the TPU has no atomics; its cost grows with the number of active
// slots.  On Hopper each thread routes one row (route_row.cuh) and adds
// the row's C int8 values to its slot's cells with shared-memory int32
// atomics (hist_smem.cuh), so the per-row cost does not depend on the
// slot count and the sums are exact in any order.
//
// What bounds it on an H100: the roofline bound is bytes (bins G B/row,
// values C B/row, leaf vectors 16 B/row); in practice the G*C atomics per
// in-bag active row (112 at 28 columns, int8h) bound it.  The design
// keeps those atomics in shared memory (one global atomic per nonzero
// cell per block at the end), tiles the columns so a tile of the
// histogram fits a block's shared memory, and re-runs the integer route
// per column tile instead of storing the routed leaves: only the first
// column tile writes leaf2'.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_smem.cuh"

extern "C" int lgbm_hist_route(const void* bins_t, long long n_pad, int G,
                               const void* vals, int C, const void* leaf2_in,
                               void* leaf2_out, const void* tabs, int L,
                               const void* cat_mask, int Bcat,
                               const void* inv, const void* src, int A,
                               int B, int Ft, int As, int grid_x,
                               long long rows_per_block, int block,
                               void* out, void* stream) {
  int smem = hist_smem_bytes(L, true, As, Ft, B, C);
  cudaFuncSetAttribute(hist_kernel<true>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(grid_x, (G + Ft - 1) / Ft, (A + As - 1) / As);
  hist_kernel<true><<<grid, block, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)bins_t, n_pad, G, (const int8_t*)vals, C,
      (const int*)leaf2_in, (int*)leaf2_out, (const int*)tabs, L,
      (const uint8_t*)cat_mask, Bcat, (const int*)inv, (const int*)src, A,
      B, Ft, As, rows_per_block, (int*)out);
  return (int)cudaGetLastError();
}
