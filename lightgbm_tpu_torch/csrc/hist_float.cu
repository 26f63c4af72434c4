// Wide active-leaf histogram kernel (K5) on float values, in a fixed
// order.
//
// Replaces the JAX package's Pallas `_hist_kernel`
// (lightgbm_tpu/ops/pallas_histogram.py, reached from `hist_active_pallas`)
// on the float modes (bf16, hilo, hhilo, ghilo), in its seeded form.
// The TPU kernel multiplies a bf16 one-hot of the bins by the value rows
// cast to bf16 and accumulates in float32 on the MXU, so the function is:
// float32 sums of the bf16-rounded values per (active slot, column, bin,
// value row), added to a carried accumulator.  Streams of more than
// 16,909,320 rows take it (past that row count int8 cells could overflow
// int32).
//
// The kernels, their fixed order (chunks of 2,048 rows summed in row
// order from +0.0, the chunk partials folded into the carry in chunk
// order), what bounds them and their design are in hist_float.cuh, which
// the fused route + float histogram kernel (K1, hist_route_float.cu)
// shares.  Here the rows' hist leaves arrive routed, and the call covers
// all n_pad rows of its block.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_float.cuh"

extern "C" int lgbm_hist_float_partial(const void* bins_t, long long n_pad,
                                       int G, const void* vals, int C,
                                       const void* hist_leaf, int L,
                                       const void* inv, int A, int B,
                                       int chunk, int chp, int warps,
                                       void* partial, void* counts,
                                       void* stream) {
  return launch_float_partial<false>(bins_t, n_pad, n_pad, G, vals, C,
                                     hist_leaf, L, inv, A, B, chunk, chp,
                                     warps, partial, counts, FloatRoute{},
                                     stream);
}

extern "C" int lgbm_hist_float_fold(const void* partial, const void* counts,
                                    int K, int A, int C, int B, int G,
                                    const void* src, void* acc,
                                    void* stream) {
  return launch_float_fold(partial, counts, K, A, C, B, G, src, acc, stream);
}

extern "C" int lgbm_hist_float(const void* bins_t, long long n_pad, int G,
                               const void* vals, int C,
                               const void* hist_leaf, int L,
                               const void* inv, const void* src, int A,
                               int B, int chunk, int chp, int warps,
                               void* partial, void* counts, void* acc,
                               void* stream) {
  const int err = lgbm_hist_float_partial(bins_t, n_pad, G, vals, C,
                                          hist_leaf, L, inv, A, B, chunk,
                                          chp, warps, partial, counts,
                                          stream);
  if (err != 0) return err;
  const int K = (int)((n_pad + chunk - 1) / chunk);
  return launch_float_fold(partial, counts, K, A, C, B, G, src, acc, stream);
}
