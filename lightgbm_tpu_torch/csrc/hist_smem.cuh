// Shared-memory privatised int32 histogram over the active leaves,
// shared by the fused route+histogram kernel (K1, ROUTE=true), the
// leaf-compacted histogram kernel (K3) and the quantized wide
// active-leaf kernel (K5), both ROUTE=false.
//
// Output: out[A, G, B, C] int32, to which the call adds, where slot s
// of the wave holds the sums of the quantized values (vals[C, n_pad]
// int8) of the rows whose hist leaf is active[s], per stored column and
// bin.  The caller describes the wave with two small tables instead of
// the active list itself:
//   inv[L + 1]: the accumulation slot a row adds into, indexed by its
//               hist leaf (inv[L] for rows whose hist leaf is -1);
//               -1 = the row adds nothing;
//   src[A]:     the accumulation slot output slot s is read from
//               (-1: s gets nothing, the caller's zeros or carry).
// A slot whose id is -1 reads the one slot that collected the rows whose
// hist leaf is -1 in K1 and K5 (the TPU kernel's semantics: every -1
// slot collects those rows) and nothing in K3 (exact zeros), and slots
// that repeat a leaf id all read the same accumulation.
//
// Integer adds are exact and independent of order, so the result is
// bitwise the same in every run and equal to a plain int32 index_add.
//
// What bounds it on an H100: the roofline bound is bytes (bins G B/row,
// values C B/row, hist leaf 4 B/row, the output read and written once);
// in practice the instructions a warp issues per (row, column, value
// row): G*C atomics for every 32 rows, whether or not their slots are
// active, each with its address arithmetic (the time of a skewed wave,
// twice the active rows, equals a uniform one's), and the traffic to
// merge the per-block tiles.  The design:
//   * hist_kernel: grid = (row partitions, column tiles, slot groups),
//     one 1,024-thread block per SM whose tile of As slots x Ft columns
//     fills up to the 227 KB a block may hold (the launch plan,
//     ops/histogram.py:hist_plan, balances the tiles), so a row's hist
//     leaf and values are read, and K1 routes it, once per column tile;
//   * each thread takes 4 consecutive rows: one 16-byte load of hist
//     leaves and one 4-byte load per column and per value row;
//   * the tile is laid out [value row][slot][column][bin], so the lanes
//     of a warp (rows of different slots, one column, one value row)
//     land on bank bin mod 32, not on the 8 banks bin*C + c reached; a
//     row's values and slot offset are unpacked once, so an atomic costs
//     an add, a test and the atomic itself;
//   * the block writes its tile once, non-atomically and coalesced, into
//     its row partition's slab of an int32 scratch [P, A, G, B, C]
//     (every cell, zeros included, so the scratch needs no clearing);
//     hist_reduce_kernel then adds the P slabs of each output slot's
//     accumulation slot into out: no global atomics.
// Measured slower on the H100 (PERF.md): 64-bit cells holding two
// value rows (the 64-bit shared atomic add compiles to a compare-and-
// swap loop); a lane-rotated layout free of bank conflicts, whose
// smaller tiles split the slots into groups, so a warp issued its
// atomics once per group; handing a warp's active rows out one a lane
// (always, or where at most half its rows are active), whose selects,
// shuffles and extra registers cost more than the atomics they saved.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "route_row.cuh"

#define LGBM_MAX_VALUE_COLS 5
#define LGBM_HIST_THREADS 1024
#define LGBM_REDUCE_THREADS 256

template <bool ROUTE>
__global__ void __launch_bounds__(LGBM_HIST_THREADS, 1)
hist_kernel(const uint8_t* __restrict__ bins_t, long long n_pad, int G,
            const int8_t* __restrict__ vals, int C,
            const int* __restrict__ leaf_in, int* __restrict__ leaf2_out,
            const int* __restrict__ tabs, int L,
            const uint8_t* __restrict__ cat_mask, int Bcat,
            const int* __restrict__ inv, int A, int B, int Ft, int As,
            long long rows_per_block, int* __restrict__ slab) {
  extern __shared__ int sh[];
  int* sh_inv = sh;
  int* sh_tab = sh + (L + 1);
  int* sh_hist = sh_tab + (ROUTE ? ROUTE_TAB_ROWS * L : 0);
  const int f0 = blockIdx.y * Ft;
  const int nf = min(Ft, G - f0);
  const int s0 = blockIdx.z * As;
  const int ns = min(As, A - s0);
  const int cs = As * Ft * B;             // cells of one value row
  const int cells = cs * C;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh_hist[i] = 0;
  for (int i = threadIdx.x; i <= L; i += blockDim.x) sh_inv[i] = inv[i];
  if (ROUTE) stage_route_tables(sh_tab, tabs, L);
  __syncthreads();

  const bool write_leaf = ROUTE && blockIdx.y == 0 && blockIdx.z == 0;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(n_pad, r0 + rows_per_block);
  // r0, r1 and n_pad are multiples of 4 (the wrapper checks n_pad)
  for (long long q = r0 + 4LL * threadIdx.x; q < r1;
       q += 4LL * blockDim.x) {
    int hl[4];
    if (ROUTE) {
      const int4 a = *(const int4*)(leaf_in + q);
      const int4 b = *(const int4*)(leaf_in + n_pad + q);
      const int rl4[4] = {a.x, a.y, a.z, a.w};
      const int hl4[4] = {b.x, b.y, b.z, b.w};
      int ro[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int2 r = route_row(sh_tab, L, bins_t, n_pad, q + j, rl4[j],
                                 hl4[j], cat_mask, Bcat);
        ro[j] = r.x;
        hl[j] = r.y;
      }
      if (write_leaf) {
        *(int4*)(leaf2_out + q) = make_int4(ro[0], ro[1], ro[2], ro[3]);
        *(int4*)(leaf2_out + n_pad + q) =
            make_int4(hl[0], hl[1], hl[2], hl[3]);
      }
    } else {
      const int4 a = *(const int4*)(leaf_in + q);
      hl[0] = a.x;
      hl[1] = a.y;
      hl[2] = a.z;
      hl[3] = a.w;
    }
    // cell of (slot, column 0, bin 0) for value row 0 of each row; value
    // row c is c * cs cells further
    int base[4];
    bool any = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = sh_inv[hl[j] >= 0 ? hl[j] : L] - s0;
      base[j] = (unsigned)s < (unsigned)ns ? s * Ft * B : -1;
      any |= base[j] >= 0;
    }
    if (!any) continue;
    // the rows' values, one int8 per byte of a 4-byte load per value row
    int v[4][LGBM_MAX_VALUE_COLS];
#pragma unroll
    for (int c = 0; c < LGBM_MAX_VALUE_COLS; ++c) {
      const uint32_t w =
          c < C ? *(const uint32_t*)(vals + (long long)c * n_pad + q) : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j][c] = (int)(int8_t)(w >> (8 * j));
    }
    for (int fl = 0; fl < nf; ++fl) {
      const uint32_t bw =
          *(const uint32_t*)(bins_t + (long long)(f0 + fl) * n_pad + q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (base[j] < 0) continue;
        int* cell = sh_hist + base[j] + fl * B + ((bw >> (8 * j)) & 0xff);
#pragma unroll
        for (int c = 0; c < LGBM_MAX_VALUE_COLS; ++c)
          if (c < C && v[j][c] != 0) atomicAdd(cell + c * cs, v[j][c]);
      }
    }
  }
  __syncthreads();

  // the tile into this row partition's slab, in the output's layout
  const long long gbc = (long long)G * B * C;
  const int bc_n = B * C;
  const int per_slot = nf * bc_n;
  int* dst = slab + ((long long)blockIdx.x * A + s0) * gbc +
             (long long)f0 * bc_n;
  for (int i = threadIdx.x; i < ns * per_slot; i += blockDim.x) {
    const int sl = i / per_slot;
    const int rem = i - sl * per_slot;
    const int fl = rem / bc_n;
    const int bc = rem - fl * bc_n;
    const int b = bc / C;
    const int c = bc - b * C;
    dst[sl * gbc + rem] = sh_hist[c * cs + (sl * Ft + fl) * B + b];
  }
}

// out[s] += sum over the P slabs of slab[p][src[s]], 4 cells a thread
// (G*B*C is a multiple of 8: B >= 8).
__global__ void hist_reduce_kernel(const int* __restrict__ slab, int P,
                                   int A, long long gbc,
                                   const int* __restrict__ src,
                                   int* __restrict__ out) {
  const long long i = 4LL * ((long long)blockIdx.x * blockDim.x +
                             threadIdx.x);
  if (i >= (long long)A * gbc) return;
  const int s = (int)(i / gbc);
  const int ss = src[s];
  if (ss < 0) return;
  const long long pstride = (long long)A * gbc;
  const int* p = slab + (long long)ss * gbc + (i - (long long)s * gbc);
  int4 a = *(int4*)(out + i);
#pragma unroll 4
  for (int k = 0; k < P; ++k) {
    const int4 t = *(const int4*)(p + k * pstride);
    a.x += t.x;
    a.y += t.y;
    a.z += t.z;
    a.w += t.w;
  }
  *(int4*)(out + i) = a;
}

// Dynamic shared memory of one hist_kernel block, in bytes.
static inline int hist_smem_bytes(int L, bool route, int As, int Ft, int B,
                                  int C) {
  return ((L + 1) + (route ? ROUTE_TAB_ROWS * L : 0) + As * Ft * B * C) * 4;
}

// Launch the histogram kernel, then the slab reduction into out.
template <bool ROUTE>
static int launch_hist(const void* bins_t, long long n_pad, int G,
                       const void* vals, int C, const void* leaf_in,
                       void* leaf2_out, const void* tabs, int L,
                       const void* cat_mask, int Bcat, const void* inv,
                       const void* src, int A, int B, int Ft, int As,
                       int grid_x, long long rows_per_block, void* slab,
                       void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = hist_smem_bytes(L, ROUTE, As, Ft, B, C);
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel<ROUTE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(grid_x, (G + Ft - 1) / Ft, (A + As - 1) / As);
  hist_kernel<ROUTE><<<grid, LGBM_HIST_THREADS, smem, st>>>(
      (const uint8_t*)bins_t, n_pad, G, (const int8_t*)vals, C,
      (const int*)leaf_in, (int*)leaf2_out, (const int*)tabs, L,
      (const uint8_t*)cat_mask, Bcat, (const int*)inv, A, B, Ft, As,
      rows_per_block, (int*)slab);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long gbc = (long long)G * B * C;
  const long long quads = (long long)A * gbc / 4;
  hist_reduce_kernel<<<(unsigned)((quads + LGBM_REDUCE_THREADS - 1) /
                                  LGBM_REDUCE_THREADS),
                       LGBM_REDUCE_THREADS, 0, st>>>(
      (const int*)slab, grid_x, A, gbc, (const int*)src, (int*)out);
  return (int)cudaGetLastError();
}
