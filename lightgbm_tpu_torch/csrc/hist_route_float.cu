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
// Design: the partials are the float K5's partial kernel with the route
// (route_row.cuh) in its first staging step (each row routed once per
// column group, leaf2' written by the first): one block per chunk stages
// and sorts the chunk once and writes one partial per (chunk, slot) with
// rows, which is what a narrow wave of many rows a slot needs.  The fold
// is this file's: one thread per (output slot, value row, bin, column),
// C times the float K5 fold's threads, the slot's chunks with rows staged
// in shared memory per block and 16 chunks' reads in flight, so the fold
// reads the partials near the card's rate even when few slots are active
// (the float K5 fold, one thread per (slot, bin, column) chaining K adds
// for each value row, is latency-bound there).
//
// What bounds it on an H100: bytes (leaf2 read and written, 16 B/row;
// bins G B/row; values 4C B/row; the carry), plus the float K5's
// contract floor: each (chunk, slot) pair with rows writes a G x B x C
// partial that the fold reads back.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_float.cuh"

#define LGBM_WIDE_FOLD_THREADS 256
#define LGBM_WIDE_FOLD_DEPTH 16
enum { LGBM_K1_PARTIAL = 1, LGBM_K1_FOLD = 2 };

// acc[s, g, b, c] += the chunk partials [K][A][C][B][G] of src[s], in
// chunk order, skipping the chunks where that slot has no rows (they add
// +0.0, which changes no bit once the carry has had +0.0 added).  The
// grid's y is the (output slot, value row), so a block's threads share
// one slot: which chunks it has rows in is staged in shared memory once
// and only the partials' reads go to device memory, 16 chunks in flight.
__global__ void __launch_bounds__(LGBM_WIDE_FOLD_THREADS)
hist_float_wide_fold_kernel(const float* __restrict__ partial,
                            const int* __restrict__ counts, int K, int A,
                            int C, int B, int G, const int* __restrict__ src,
                            float* __restrict__ acc) {
  extern __shared__ int has[];   // [K]: the slot has rows in chunk k
  const int s = blockIdx.y / C;
  const int c = blockIdx.y % C;
  const int ss = src[s];
  if (ss < 0) return;   // the whole block
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    has[k] = counts[(long long)k * A + ss] > 0;
  __syncthreads();
  const int cell = blockIdx.x * blockDim.x + threadIdx.x;   // b * G + g
  if (cell >= B * G) return;
  const int b = cell / G;
  const int g = cell - b * G;
  const long long bg = (long long)B * G;
  const long long kstride = (long long)A * C * bg;
  const float* p = partial + ((long long)ss * C + c) * bg + cell;
  float* out = acc + (((long long)s * G + g) * B + b) * C + c;
  float t = __fadd_rn(*out, 0.f);
  int k = 0;
  for (; k + LGBM_WIDE_FOLD_DEPTH <= K; k += LGBM_WIDE_FOLD_DEPTH) {
    float x[LGBM_WIDE_FOLD_DEPTH];
#pragma unroll
    for (int u = 0; u < LGBM_WIDE_FOLD_DEPTH; ++u)
      x[u] = has[k + u] ? p[(k + u) * kstride] : 0.f;
#pragma unroll
    for (int u = 0; u < LGBM_WIDE_FOLD_DEPTH; ++u) t = __fadd_rn(t, x[u]);
  }
  for (; k < K; ++k)
    if (has[k]) t = __fadd_rn(t, p[k * kstride]);
  *out = t;
}

// `kernels`: a mask of LGBM_K1_PARTIAL and LGBM_K1_FOLD (both for a call;
// one alone, on the scratch an earlier launch left, to time them apart).
extern "C" int lgbm_hist_route_float(const void* bins_t, long long ld,
                                     long long nrows, int G,
                                     const void* vals, int C,
                                     const void* leaf2_in, void* leaf2_out,
                                     const void* tabs, int L,
                                     const void* cat_mask, int Bcat,
                                     const void* inv, const void* src,
                                     int A, int B, int chunk, int chp,
                                     int warps, int kernels, void* partial,
                                     void* counts, void* acc, void* stream) {
  if (kernels & LGBM_K1_PARTIAL) {
    const FloatRoute route{(int*)leaf2_out, (const int*)tabs,
                           (const uint8_t*)cat_mask, Bcat};
    const int err = launch_float_partial<true>(
        bins_t, ld, nrows, G, vals, C, leaf2_in, L, inv, A, B, chunk, chp,
        warps, partial, counts, route, stream);
    if (err != 0) return err;
  }
  if (kernels & LGBM_K1_FOLD) {
    const int K = (int)((nrows + chunk - 1) / chunk);
    const dim3 grid((B * G + LGBM_WIDE_FOLD_THREADS - 1) /
                        LGBM_WIDE_FOLD_THREADS,
                    A * C);
    hist_float_wide_fold_kernel<<<grid, LGBM_WIDE_FOLD_THREADS,
                                  K * sizeof(int), (cudaStream_t)stream>>>(
        (const float*)partial, (const int*)counts, K, A, C, B, G,
        (const int*)src, (float*)acc);
    return (int)cudaGetLastError();
  }
  return 0;
}
