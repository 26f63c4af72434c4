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
// keeps those atomics in shared memory, merges the blocks' tiles through
// an int32 slab scratch (hist_smem.cuh), tiles the columns so a tile of
// the histogram fills up to the 227 KB of a block, and re-runs the
// integer route per column tile instead of storing the routed leaves
// (2, 3 and 5 column tiles at 8, 16 and 32 slots on 28 columns, 64
// bins): only the first column tile writes leaf2'.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_smem.cuh"

extern "C" int lgbm_hist_route(const void* bins_t, long long n_pad, int G,
                               const void* vals, int C, const void* leaf2_in,
                               void* leaf2_out, const void* tabs, int L,
                               const void* cat_mask, int Bcat,
                               const void* inv, const void* src, int A,
                               int B, int Ft, int As, int grid_x,
                               long long rows_per_block, void* slab,
                               void* out, void* stream) {
  return launch_hist<true>(bins_t, n_pad, G, vals, C, leaf2_in, leaf2_out,
                           tabs, L, cat_mask, Bcat, inv, src, A, B, Ft, As,
                           grid_x, rows_per_block, slab, out, stream);
}
