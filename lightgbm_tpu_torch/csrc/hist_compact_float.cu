// Leaf-compacted histogram kernel (K3) on float values, in the float
// K5's fixed order.
//
// Replaces the JAX package's Pallas `_hist_compact_kernel`
// (lightgbm_tpu/ops/compact.py, reached from `hist_active_compact`
// together with the XLA `compact_plan`) on the float modes: for waves of
// more than 32 slots, after the route kernel, the float32 sums of the
// bf16-rounded values per (active slot, column, bin, value row) of the
// rows whose routed hist leaf is active; rows of other leaves, bagged-out
// rows included, add nothing, and -1 slots get nothing (the caller's
// zeros: exact zeros).  The TPU kernel stable-sorts the rows into leaf
// groups (compact_plan) and contracts a bf16 one-hot with the grouped
// value rows on the MXU, accumulating in float32.
//
// The order is the float K5's: per output slot and cell, the carry plus,
// in chunk order, each 2,048-row chunk's partial, itself the cell's rows
// of that chunk summed in row order from +0.0.  So a call is bitwise the
// float K5 on its non-negative slots, and an in-memory float model is
// bitwise the streamed one.  That order deviates from the reference,
// whose float K3 is not chain-exact against its own wide kernel.
//
// The design is in hist_float_walk.cuh: the rows sorted by slot on the
// card, like the reference's compact_plan, then each slot's rows walked
// once (a slot with few rows a chunk) or summed per chunk into partials
// folded in chunk order (a slot with many), so the cost follows the rows
// and a slot's chunks spread over the multiprocessors.  One call covers a
// window of rows; the wrapper (ops/compact.py hist_compact_float_raw)
// chains the windows through the carry.  What bounds it is stated there.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_float_walk.cuh"

extern "C" int lgbm_hist_compact_float(
    const void* bins_t, long long ld, long long nrows, int G,
    const void* vals, int C, const void* hist_leaf, int L, const void* inv,
    const void* src, int A, int B, int chunk, int light_rows,
    int dense_rows, int pcap,
    int heavy_blocks, int kernels, void* ibuf, void* sbins, void* svals,
    void* partial, void* acc, void* stream) {
  return float_walk_window(bins_t, ld, nrows, G, vals, C, hist_leaf, L, inv,
                           src, A, B, chunk, light_rows, dense_rows, pcap,
                           heavy_blocks,
                           kernels, ibuf, sbins, svals, partial, acc, stream);
}
