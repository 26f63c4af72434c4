// The fixed-order float histogram shared by the float wide active-leaf
// kernel (K5, hist_float.cu, ROUTE=false) and the fused route + float
// histogram kernel (K1, hist_route_float.cu, ROUTE=true).
//
// The function: float32 sums of the bf16-rounded values per (active
// slot, column, bin, value row), added to a carried accumulator
// acc[A, G, B, C].  Float atomics would add in a different order in
// every run.  These kernels fix the order instead, and their plain
// version (ops/histogram.py:hist_float_plain) sums in the same one:
//   * rows are cut into chunks of `chunk` rows (2,048, a divisor of the
//     streamed block granularity of 8,192 rows), counted on the row
//     index of the whole call;
//   * within a chunk every cell sums its rows in row order from +0.0
//     (kernel 1, one partial per chunk and slot);
//   * each output slot adds its accumulation slot's chunk partials into
//     the carry in chunk order (kernel 2), with __fadd_rn: no FMA
//     contraction.
// So the result does not depend on the block size, and a chain of calls
// over consecutive row windows whose bounds are multiples of `chunk` is
// bitwise one call over all rows.  A call covers the rows [0, nrows) of
// a window whose row stride (the leading dimension of bins_t, vals and
// leaf2) is `ld`; pointers arrive offset to the window's first row.
//
// The wave is described by inv[L + 1] (the accumulation slot of a row,
// by hist leaf; inv[L] for hist leaf -1; -1 = the row adds nothing) and
// src[A] (the accumulation slot each output slot reads; -1 = nothing),
// as in hist_smem.cuh.  With ROUTE the partial kernel first applies the
// previous wave's per-leaf tables to leaf2 (route_row.cuh, the code K1
// and K2 share), writes leaf2' once (the first column group) and feeds
// the routed hist leaf into the chunk's sort.
//
// Kernel 1, hist_float_partial_kernel: one block per (chunk, group of 32
// columns), W warps.  The block stages the chunk once:
//   1. the accumulation slot of each row (from its hist leaf);
//   2. a stable counting sort of the rows by slot in shared memory
//      (per-warp counts over contiguous row segments, __match_any_sync
//      ranks within 32 rows), each slot's run starting at a multiple of
//      4 positions;
//   3. the chunk's bins (4-byte loads, one column row per lane later)
//      and its value rows rounded to bf16 once (__float2bfloat16_rn),
//      both scattered into sorted order.
// Work items are (slot with rows, value row c): a warp owns one, with
// lane = column and a private [B][32] float32 tile (bank = lane on
// every access), zeroes it, walks the slot's rows in ascending row
// order 4 at a time — the 4 cells are loaded together and a row whose
// bin repeats an earlier one of the 4 takes that row's new sum, so the
// adds of each cell stay in row order — and writes the tile to the
// chunk partial, coalesced, as [B][G] rows.  Only (chunk, slot) pairs
// with rows are written; counts[K][A] records the rows of each.
// Kernel 2, hist_float_fold_kernel: one thread per (output slot, bin,
// column) adds, for each value row, the chunk partials of its
// accumulation slot into the carry in chunk order.  A chunk in which
// that slot has no rows adds +0.0, exactly what the plain version adds
// there (its partial of such a chunk is all zeros), so skipping the
// read changes no bit, whatever the carry holds.
//
// What bounds it on an H100: the roofline bound is bytes (bins G B/row,
// values 4C B/row, hist leaf 4 B/row, or leaf2 read and written 16
// B/row with ROUTE, the carry read and written once).  The contract
// adds a floor of its own: every (chunk, slot) pair with rows writes a
// G x B x C float32 partial that the fold reads back, 455 MB per call
// on a 1,048,576-row window whose rows spread over 31 slots (28
// columns, 64 bins, 4 value rows), about 0.27 ms at 3.35 TB/s.  The
// design keeps everything else off the device memory path: rows are
// read once per column group, sorted and walked in shared memory, and a
// wave whose rows sit in one slot (every tree's first wave) walks C
// warps per chunk at once and writes one partial per chunk.  On such a
// wave latency sets the time instead: C walking warps per multiprocessor
// and each fold thread's chain of K adds (splitting a slot's columns
// over more warps, or the fold over one thread per value row, measured
// slower on the uniform wave; PERF.md).  The routed variant reads the
// route tables from global memory (L1-cached; 11 x L ints), one lookup
// per row and column group.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "route_row.cuh"

#define LGBM_FLOAT_LANES 32
#define LGBM_FOLD_THREADS 256

// Byte offsets of the partial kernel's shared-memory regions; the host
// computes the same ones for the launch (ops/histogram.py
// float_smem_bytes).
struct FloatSmem {
  int wcnt, off, cnt, list, meta, pos, svals, sbins, total;
};

__host__ __device__ inline FloatSmem float_smem(int W, int A, int B, int C,
                                                int chunk, int chp) {
  FloatSmem m;
  const int ints = ((W * A + 3 * A + 4) + 3) & ~3;   // keep 16-B alignment
  m.wcnt = W * B * LGBM_FLOAT_LANES * 4;             // tiles come first
  m.off = m.wcnt + W * A * 4;
  m.cnt = m.off + A * 4;
  m.list = m.cnt + A * 4;
  m.meta = m.list + A * 4;
  m.pos = m.wcnt + ints * 4;
  m.svals = m.pos + ((chunk * 2 + 15) & ~15);
  m.sbins = m.svals + ((C * chp * 2 + 15) & ~15);
  m.total = m.sbins + LGBM_FLOAT_LANES * chp;
  return m;
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t u) {
  return __uint_as_float(u << 16);
}

// The route inputs of the partial kernel (ROUTE only): leaf2 [2, ld] in
// and out, the per-leaf tables [ROUTE_TAB_ROWS, L] and the categorical
// masks [L, Bcat].
struct FloatRoute {
  int* leaf2_out;
  const int* tabs;
  const uint8_t* cat_mask;
  int Bcat;
};

// `leaf` is the hist leaf vector [nrows] (ROUTE=false) or leaf2 [2, ld]
// (ROUTE=true).
template <bool ROUTE>
__global__ void __launch_bounds__(512)
hist_float_partial_kernel(const uint8_t* __restrict__ bins_t, long long ld,
                          long long nrows, int G,
                          const float* __restrict__ vals, int C,
                          const int* __restrict__ leaf, int L,
                          const int* __restrict__ inv, int A, int B,
                          int chunk, int chp, float* __restrict__ partial,
                          int* __restrict__ counts, FloatRoute route) {
  extern __shared__ float4 sh4[];
  char* sh = (char*)sh4;
  const int W = blockDim.x / LGBM_FLOAT_LANES;
  const FloatSmem m = float_smem(W, A, B, C, chunk, chp);
  float* tiles = (float*)sh;
  int* wcnt = (int*)(sh + m.wcnt);     // [W][A] counts, then bases
  int* off = (int*)(sh + m.off);       // first sorted position per slot
  int* cnt = (int*)(sh + m.cnt);       // rows per slot
  int* list = (int*)(sh + m.list);     // slots with rows, ascending
  int* meta = (int*)(sh + m.meta);     // [0]: number of such slots
  short* pos = (short*)(sh + m.pos);   // slot of a row, then its position
  uint16_t* svals = (uint16_t*)(sh + m.svals);  // [C][chp] bf16 bits
  uint8_t* sbins = (uint8_t*)(sh + m.sbins);    // [32][chp]

  const int k = blockIdx.x;
  const long long r0 = (long long)k * chunk;
  const int len = (int)min((long long)chunk, nrows - r0);   // multiple of 4
  const int g0 = blockIdx.y * LGBM_FLOAT_LANES;
  const int ng = min(LGBM_FLOAT_LANES, G - g0);
  const int tid = threadIdx.x;
  const int NT = blockDim.x;
  const int w = tid / LGBM_FLOAT_LANES;
  const int lane = tid % LGBM_FLOAT_LANES;
  const unsigned full = 0xffffffffu;

  for (int i = tid; i < W * A; i += NT) wcnt[i] = 0;
  for (int i = tid; i < len; i += NT) {
    int hl;
    if (ROUTE) {
      const long long r = r0 + i;
      const int2 o = route_row(route.tabs, L, bins_t, ld, r, leaf[r],
                               leaf[ld + r], route.cat_mask, route.Bcat);
      if (blockIdx.y == 0) {
        route.leaf2_out[r] = o.x;
        route.leaf2_out[ld + r] = o.y;
      }
      hl = o.y;
    } else {
      hl = leaf[r0 + i];
    }
    pos[i] = (short)inv[hl >= 0 ? hl : L];
  }
  __syncthreads();

  // rows [seg0, seg1) belong to warp w; their rounds of 32 run in order
  const int seg = ((len + W - 1) / W + 31) & ~31;
  const int seg0 = min(len, w * seg);
  const int seg1 = min(len, seg0 + seg);
  for (int base = seg0; base < seg1; base += LGBM_FLOAT_LANES) {
    const int i = base + lane;
    const int s = i < seg1 ? pos[i] : -1;
    const unsigned peers = __match_any_sync(full, s);
    if (s >= 0 && lane == __ffs(peers) - 1)
      wcnt[w * A + s] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int s = tid; s < A; s += NT) {
    int t = 0;
    for (int v = 0; v < W; ++v) t += wcnt[v * A + s];
    cnt[s] = t;
  }
  __syncthreads();
  if (w == 0) {   // runs start at multiples of 4; the slots with rows
    int run = 0, nl = 0;
    for (int b = 0; b < A; b += LGBM_FLOAT_LANES) {
      const int s = b + lane;
      const int c = s < A ? cnt[s] : 0;
      const int c4 = (c + 3) & ~3;
      int x = c4;
      for (int d = 1; d < LGBM_FLOAT_LANES; d <<= 1) {
        const int y = __shfl_up_sync(full, x, d);
        if (lane >= d) x += y;
      }
      if (s < A) off[s] = run + x - c4;
      run += __shfl_sync(full, x, LGBM_FLOAT_LANES - 1);
      const unsigned has = __ballot_sync(full, c > 0);
      if (c > 0) list[nl + __popc(has & ((1u << lane) - 1u))] = s;
      nl += __popc(has);
    }
    if (lane == 0) meta[0] = nl;
  }
  __syncthreads();
  for (int s = tid; s < A; s += NT) {
    int run = off[s];
    for (int v = 0; v < W; ++v) {
      const int t = wcnt[v * A + s];
      wcnt[v * A + s] = run;
      run += t;
    }
  }
  __syncthreads();
  for (int base = seg0; base < seg1; base += LGBM_FLOAT_LANES) {
    const int i = base + lane;
    const int s = i < seg1 ? pos[i] : -1;
    const unsigned peers = __match_any_sync(full, s);
    const int p =
        s >= 0 ? wcnt[w * A + s] + __popc(peers & ((1u << lane) - 1u)) : -1;
    __syncwarp();
    if (s >= 0 && lane == __ffs(peers) - 1)
      wcnt[w * A + s] += __popc(peers);
    if (i < seg1) pos[i] = (short)p;
    __syncwarp();
  }
  __syncthreads();

  // the chunk's bins and bf16-rounded values, in sorted order
  const int quads = len / 4;
  for (int idx = tid; idx < ng * quads; idx += NT) {
    const int gl = idx / quads;
    const int q = idx - gl * quads;
    const uint32_t bw =
        *(const uint32_t*)(bins_t + (long long)(g0 + gl) * ld + r0 + 4 * q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = pos[4 * q + j];
      if (p >= 0) sbins[gl * chp + p] = (uint8_t)(bw >> (8 * j));
    }
  }
  for (int idx = tid; idx < C * quads; idx += NT) {
    const int c = idx / quads;
    const int q = idx - c * quads;
    const float4 f = *(const float4*)(vals + (long long)c * ld + r0 + 4 * q);
    const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = pos[4 * q + j];
      if (p >= 0)
        svals[c * chp + p] = __bfloat16_as_ushort(__float2bfloat16_rn(fv[j]));
    }
  }
  if (blockIdx.y == 0)
    for (int s = tid; s < A; s += NT) counts[(long long)k * A + s] = cnt[s];
  __syncthreads();

  // items (slot with rows, value row): one warp each
  const int n_items = meta[0] * C;
  float* mine = tiles + (size_t)w * B * LGBM_FLOAT_LANES;
  const long long gb = (long long)B * G;
  for (int it = w; it < n_items; it += W) {
    const int s = list[it / C];
    const int c = it - (it / C) * C;
    for (int i = lane; i < B * LGBM_FLOAT_LANES / 4; i += LGBM_FLOAT_LANES)
      ((float4*)mine)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncwarp();
    if (lane < ng) {
      const uint8_t* bcol = sbins + lane * chp;
      const uint16_t* vrow = svals + c * chp;
      float* cell = mine + lane;          // bin b at cell[b * 32]
      int j = off[s];
      const int end = j + cnt[s];
      for (; j + 4 <= end; j += 4) {
        const uint32_t bw = *(const uint32_t*)(bcol + j);
        const uint2 vw = *(const uint2*)(vrow + j);
        const int b0 = bw & 0xff, b1 = (bw >> 8) & 0xff;
        const int b2 = (bw >> 16) & 0xff, b3 = bw >> 24;
        const float v0 = bf16_bits_to_float(vw.x & 0xffffu);
        const float v1 = bf16_bits_to_float(vw.x >> 16);
        const float v2 = bf16_bits_to_float(vw.y & 0xffffu);
        const float v3 = bf16_bits_to_float(vw.y >> 16);
        const float x0 = cell[b0 * LGBM_FLOAT_LANES];
        const float x1 = cell[b1 * LGBM_FLOAT_LANES];
        const float x2 = cell[b2 * LGBM_FLOAT_LANES];
        const float x3 = cell[b3 * LGBM_FLOAT_LANES];
        const float s0 = __fadd_rn(x0, v0);
        const float s1 = __fadd_rn(b1 == b0 ? s0 : x1, v1);
        const float s2 =
            __fadd_rn(b2 == b1 ? s1 : b2 == b0 ? s0 : x2, v2);
        const float s3 = __fadd_rn(
            b3 == b2 ? s2 : b3 == b1 ? s1 : b3 == b0 ? s0 : x3, v3);
        cell[b0 * LGBM_FLOAT_LANES] = s0;   // in row order: the last
        cell[b1 * LGBM_FLOAT_LANES] = s1;   // store to a repeated bin
        cell[b2 * LGBM_FLOAT_LANES] = s2;   // holds its newest sum
        cell[b3 * LGBM_FLOAT_LANES] = s3;
      }
      for (; j < end; ++j) {
        const int b = bcol[j];
        cell[b * LGBM_FLOAT_LANES] =
            __fadd_rn(cell[b * LGBM_FLOAT_LANES], bf16_bits_to_float(vrow[j]));
      }
      float* dst = partial + (((long long)k * A + s) * C + c) * gb + g0 + lane;
      for (int b = 0; b < B; ++b) dst[b * G] = cell[b * LGBM_FLOAT_LANES];
    }
    __syncwarp();
  }
}

// acc[s, g, b, c] += the chunk partials of src[s], in chunk order; one
// thread per (s, b, g) with g fastest (coalesced partial reads), its C
// value rows at once, 4 chunks' reads in flight before their adds.
__global__ void hist_float_fold_kernel(const float* __restrict__ partial,
                                       const int* __restrict__ counts,
                                       int K, int A, int C, int B, int G,
                                       const int* __restrict__ src,
                                       float* __restrict__ acc) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long bg = (long long)B * G;
  if (idx >= (long long)A * bg) return;
  const int s = (int)(idx / bg);
  const int r = (int)(idx - (long long)s * bg);
  const int b = r / G;
  const int g = r - b * G;
  const int ss = src[s];
  if (ss < 0) return;
  float* out = acc + (((long long)s * G + g) * B + b) * C;
  float a[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) a[c] = c < C ? out[c] : 0.f;
  const long long kstride = (long long)A * C * bg;
  const float* p = partial + (long long)ss * C * bg + r;
  const int* cn = counts + ss;
  int k = 0;
  for (; k + 4 <= K; k += 4) {
    float t[4][5];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool has = cn[(long long)(k + u) * A] > 0;
#pragma unroll
      for (int c = 0; c < 5; ++c)
        t[u][c] = (c < C && has) ? p[(k + u) * kstride + c * bg] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int c = 0; c < 5; ++c) a[c] = __fadd_rn(a[c], t[u][c]);
  }
  for (; k < K; ++k) {
    const bool has = cn[(long long)k * A] > 0;
#pragma unroll
    for (int c = 0; c < 5; ++c)
      a[c] = __fadd_rn(a[c], (c < C && has) ? p[k * kstride + c * bg] : 0.f);
  }
#pragma unroll
  for (int c = 0; c < 5; ++c)
    if (c < C) out[c] = a[c];
}

template <bool ROUTE>
inline int launch_float_partial(const void* bins_t, long long ld,
                                long long nrows, int G, const void* vals,
                                int C, const void* leaf, int L,
                                const void* inv, int A, int B, int chunk,
                                int chp, int warps, void* partial,
                                void* counts, FloatRoute route,
                                void* stream) {
  const int K = (int)((nrows + chunk - 1) / chunk);
  const int smem = float_smem(warps, A, B, C, chunk, chp).total;
  cudaError_t err = cudaFuncSetAttribute(
      hist_float_partial_kernel<ROUTE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(K, (G + LGBM_FLOAT_LANES - 1) / LGBM_FLOAT_LANES);
  hist_float_partial_kernel<ROUTE>
      <<<grid, warps * LGBM_FLOAT_LANES, smem, (cudaStream_t)stream>>>(
          (const uint8_t*)bins_t, ld, nrows, G, (const float*)vals, C,
          (const int*)leaf, L, (const int*)inv, A, B, chunk, chp,
          (float*)partial, (int*)counts, route);
  return (int)cudaGetLastError();
}

inline int launch_float_fold(const void* partial, const void* counts, int K,
                             int A, int C, int B, int G, const void* src,
                             void* acc, void* stream) {
  const long long total = (long long)A * B * G;
  hist_float_fold_kernel<<<(unsigned)((total + LGBM_FOLD_THREADS - 1) /
                                      LGBM_FOLD_THREADS),
                           LGBM_FOLD_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)partial, (const int*)counts, K, A, C, B, G,
      (const int*)src, (float*)acc);
  return (int)cudaGetLastError();
}
