// Shared-memory privatised int32 histogram over the active leaves,
// shared by the fused route+histogram kernel (K1, ROUTE=true) and the
// leaf-compacted histogram kernel (K3, ROUTE=false).
//
// Output: out[A, G, B, C] int32, zero-initialised by the caller, where
// slot s of the wave holds the sums of the quantized values
// (vals[C, n_pad] int8) of the rows whose hist leaf is active[s], per
// stored column and bin.  The caller describes the wave with two small
// tables instead of the active list itself:
//   inv[L + 1]: the shared-memory slot a row accumulates into, indexed by
//               its hist leaf (inv[L] for rows whose hist leaf is -1);
//               -1 = the row adds nothing;
//   src[A]:     the shared-memory slot output slot s is read from
//               (-1: exact zeros).
// A slot whose id is -1 reads the one slot that collected the rows whose
// hist leaf is -1 in K1 (the TPU kernel's semantics: every -1 slot
// collects those rows) and nothing in K3 (exact zeros), and slots that
// repeat a leaf id all read the same accumulation.
//
// Integer atomics are exact and independent of order, so the result is
// bitwise the same in every run and equal to a plain int32 index_add.
// Each block owns a tile of As slots x Ft columns of the histogram in
// shared memory, accumulates its row range there with shared-memory
// atomics, and adds the nonzero cells to the global histogram with one
// global atomic each.  grid = (row chunks, column tiles, slot groups).
#pragma once
#include <stdint.h>

#include "route_row.cuh"

#define LGBM_MAX_VALUE_COLS 5

template <bool ROUTE>
__global__ void hist_kernel(const uint8_t* __restrict__ bins_t,
                            long long n_pad, int G,
                            const int8_t* __restrict__ vals, int C,
                            const int* __restrict__ leaf_in,
                            int* __restrict__ leaf2_out,
                            const int* __restrict__ tabs, int L,
                            const uint8_t* __restrict__ cat_mask, int Bcat,
                            const int* __restrict__ inv,
                            const int* __restrict__ src, int A, int B,
                            int Ft, int As, long long rows_per_block,
                            int* __restrict__ out) {
  extern __shared__ int sh[];
  int* sh_inv = sh;
  int* sh_tab = sh + (L + 1);
  int* sh_hist = sh_tab + (ROUTE ? ROUTE_TAB_ROWS * L : 0);
  const int f0 = blockIdx.y * Ft;
  const int nf = min(Ft, G - f0);
  const int s0 = blockIdx.z * As;
  const int cells = As * Ft * B * C;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh_hist[i] = 0;
  for (int i = threadIdx.x; i <= L; i += blockDim.x) sh_inv[i] = inv[i];
  if (ROUTE) stage_route_tables(sh_tab, tabs, L);
  __syncthreads();

  const bool write_leaf = ROUTE && blockIdx.y == 0 && blockIdx.z == 0;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n_pad, r0 + rows_per_block);
  for (long long row = r0 + threadIdx.x; row < r1; row += blockDim.x) {
    int hl;
    if (ROUTE) {
      int2 r = route_row(sh_tab, L, bins_t, n_pad, row, leaf_in[row],
                         leaf_in[n_pad + row], cat_mask, Bcat);
      if (write_leaf) {
        leaf2_out[row] = r.x;
        leaf2_out[n_pad + row] = r.y;
      }
      hl = r.y;
    } else {
      hl = leaf_in[row];
    }
    const int sl = sh_inv[hl >= 0 ? hl : L] - s0;
    if ((unsigned)sl >= (unsigned)As) continue;
    int v[LGBM_MAX_VALUE_COLS];
#pragma unroll
    for (int c = 0; c < LGBM_MAX_VALUE_COLS; ++c)
      v[c] = c < C ? (int)vals[(long long)c * n_pad + row] : 0;
    for (int fl = 0; fl < nf; ++fl) {
      const int bin = bins_t[(long long)(f0 + fl) * n_pad + row];
      int* cell = sh_hist + ((sl * Ft + fl) * B + bin) * C;
#pragma unroll
      for (int c = 0; c < LGBM_MAX_VALUE_COLS; ++c)
        if (c < C && v[c] != 0) atomicAdd(cell + c, v[c]);
    }
  }
  __syncthreads();

  const int per_slot = nf * B * C;
  for (int i = threadIdx.x; i < A * per_slot; i += blockDim.x) {
    const int s = i / per_slot;
    const int ss = src[s] - s0;
    if ((unsigned)ss >= (unsigned)As) continue;
    const int rem = i - s * per_slot;
    const int fl = rem / (B * C);
    const int bc = rem - fl * (B * C);
    const int val = sh_hist[(ss * Ft + fl) * B * C + bc];
    if (val != 0)
      atomicAdd(out + ((long long)s * G + f0 + fl) * B * C + bc, val);
  }
}

// Dynamic shared memory of one block, in bytes.
static inline int hist_smem_bytes(int L, bool route, int As, int Ft, int B,
                                  int C) {
  return ((L + 1) + (route ? ROUTE_TAB_ROWS * L : 0) + As * Ft * B * C) * 4;
}
