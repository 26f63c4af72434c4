// Fused route + histogram kernel (K1) on float values, in the float
// K5's fixed order.
//
// Replaces the JAX package's Pallas `_hist_route_kernel`
// (lightgbm_tpu/ops/pallas_histogram.py, reached from `hist_route_pallas`)
// on the float modes (bf16, hilo, hhilo, ghilo): apply the previous
// wave's pending splits to both leaf vectors, then histogram the active
// leaves over the routed hist leaves.  The TPU kernel contracts a bf16
// one-hot of every (column, bin) with the leaf-masked value rows cast to
// bf16, accumulating in float32 on the MXU.  Here the sums are those of
// the float K5 (hist_float.cuh): bf16-rounded values added in float32,
// per 2,048-row chunk in row order from +0.0, the chunk partials folded
// into the carry in chunk order, no float atomics.  So a call is bitwise
// the route kernel (K2) followed by the float K5 on the routed leaves,
// and an in-memory float model is bitwise the streamed one.  Rows whose
// hist leaf is -1 (bagged out; padding rows carry zero values) go to the
// -1 slots, as the TPU kernel's do.
//
// One call covers a window of `nrows` rows of a leaf2 / bins_t / vals
// whose row stride is `ld`; the wrapper (ops/histogram.py
// hist_route_float_raw) chains windows of 1,048,576 rows through the
// carry, which is bitwise one call, so the chunk partials' scratch does
// not grow with the row count.
//
// What bounds it on an H100: bytes (leaf2 read and written, 16 B/row;
// bins G B/row; values 4C B/row; the carry), plus the float K5's
// contract floor: each (chunk, slot) pair with rows writes a partial
// that the fold reads back.  The design is the float K5's, with the
// route (route_row.cuh) done in the partial kernel's first staging
// step: each row is routed once per column group (one for 28 columns)
// and leaf2' is written by the first.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_float.cuh"

extern "C" int lgbm_hist_route_float(const void* bins_t, long long ld,
                                     long long nrows, int G,
                                     const void* vals, int C,
                                     const void* leaf2_in, void* leaf2_out,
                                     const void* tabs, int L,
                                     const void* cat_mask, int Bcat,
                                     const void* inv, const void* src,
                                     int A, int B, int chunk, int chp,
                                     int warps, void* partial, void* counts,
                                     void* acc, void* stream) {
  const FloatRoute route{(int*)leaf2_out, (const int*)tabs,
                         (const uint8_t*)cat_mask, Bcat};
  const int err = launch_float_partial<true>(
      bins_t, ld, nrows, G, vals, C, leaf2_in, L, inv, A, B, chunk, chp,
      warps, partial, counts, route, stream);
  if (err != 0) return err;
  const int K = (int)((nrows + chunk - 1) / chunk);
  return launch_float_fold(partial, counts, K, A, C, B, G, src, acc, stream);
}
