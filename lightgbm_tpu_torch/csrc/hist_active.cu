// Wide active-leaf histogram kernel (K5) on quantized values.
//
// Replaces the JAX package's Pallas `_hist_kernel`
// (lightgbm_tpu/ops/pallas_histogram.py, reached from `hist_active_pallas`)
// on the quantized modes, in its seeded form: the streamed out-of-core
// folds call it once per row block with the wave's carried int32
// accumulator, which the TPU kernel loads instead of zero-initialising
// (`input_output_aliases`).  Here the kernel adds into the carry in
// place: the caller passes the carry as `acc` and nothing zeroes it.
// Int32 atomics are exact in any order, so a chain of per-block calls is
// bitwise one call over all rows.
//
// The rows arrive already routed (the hist leaf per row), as in the
// leaf-compacted kernel K3, and the body is the same shared-memory
// atomic histogram (hist_smem.cuh, ROUTE=false); what differs is the
// wave description the caller builds: rows whose hist leaf is -1
// (padding rows of a block, bagged-out rows) accumulate into the first
// -1 slot, and every -1 slot reads it, as the TPU kernel's -1 slots do.
//
// What bounds it on an H100: the roofline bound is bytes (bins G B/row,
// values C B/row, hist leaf 4 B/row, the carry read and written once);
// in practice the G*C shared-memory atomics per active row and the
// merge of the per-block tiles; hist_smem.cuh says what the design does
// about both.  The slab reduction adds into the carry.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_smem.cuh"

extern "C" int lgbm_hist_active(const void* bins_t, long long n_pad, int G,
                                const void* vals, int C,
                                const void* hist_leaf, int L,
                                const void* inv, const void* src, int A,
                                int B, int Ft, int As, int grid_x,
                                long long rows_per_block, void* slab,
                                void* acc, void* stream) {
  return launch_hist<false>(bins_t, n_pad, G, vals, C, hist_leaf, nullptr,
                            nullptr, L, nullptr, 0, inv, src, A, B, Ft, As,
                            grid_x, rows_per_block, slab, acc, stream);
}
