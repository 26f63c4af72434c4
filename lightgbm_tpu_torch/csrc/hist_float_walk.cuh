// The fixed-order float histogram of the leaf-compacted kernel K3 on
// float values (hist_compact_float.cu).
//
// The function: float32 sums of the bf16-rounded values per (active
// slot, column, bin, value row), added to a carried accumulator
// acc[A, G, B, C], in the float K5's order (hist_float.cuh): rows cut
// into chunks of `chunk` rows (2,048) counted on the row index; within a
// chunk every cell sums its rows in row order from +0.0; each output
// slot adds its accumulation slot's chunk partials into the carry in
// chunk order, with __fadd_rn (no FMA contraction).  A chunk without
// rows of a cell adds +0.0 there; once the carry has had +0.0 added
// (which turns -0.0 into +0.0) such adds change no bit, so each cell
// adds +0.0 once and skips the rest.  So a call is bitwise the float K5
// on the same hist leaves, and an in-memory float model is bitwise the
// streamed one.
//
// One call covers a window of `nrows` rows (a multiple of 4) of bins_t,
// vals and the hist leaves, whose row stride is `ld`; the pointers
// arrive offset to the window's first row, whose index is a multiple of
// `chunk`.  The wrapper (ops/histogram.py float_walk_launches) chains
// windows through the carry, which is bitwise one call over all rows, so
// no scratch grows with the row count.
//
// The wave is described by inv[L + 1] (the accumulation slot of a row,
// by hist leaf; inv[L] for hist leaf -1; -1 = the row adds nothing) and
// src[A] (the accumulation slot each output slot reads; -1 = nothing),
// as in hist_smem.cuh.
//
// Why not the float K5's design (a dense partial per (chunk, slot) with
// rows, folded in chunk order): on a wide wave a slot has a few rows per
// chunk against B bins, so zeroing, writing and folding the partials
// cost A x K x B instead of the rows; on a narrow one the partials are
// G x B x C floats per pair (28.7 KB on the headline's hhilo) written to
// device memory and read back.  Here the rows are sorted by slot and
// each slot takes one of two routes, chosen per window on the card:
//   1. fw_count_kernel: rows per (slot, chunk), one block per chunk,
//      shared-memory int atomics (exact);
//   2. fw_scan_kernel, one block per slot: the slot's rows and chunks
//      with rows, the first sorted position of each (slot, chunk) within
//      the slot and the number of the slot's chunks with rows before it;
//   3. fw_plan_kernel, one block: each slot's first sorted position, and
//      its split: a slot with more than `light_rows` rows keeps its first
//      chunks up to that many rows for the walk (light; none at all
//      from `dense_rows` rows on) and gives the later ones, as chunk
//      partials, to step 5 (heavy pairs), the largest slots first (ties
//      by slot) while their pairs fit the `pcap` partials of the
//      scratch; the others are walked whole;
//   4. fw_fill_kernel, one block per chunk: a stable counting sort of
//      the chunk's rows by slot in shared memory (per-warp counts over
//      contiguous row segments, __match_any_sync ranks within 32 rows),
//      then each active row's bins and its values rounded to bf16
//      (__float2bfloat16_rn) with its chunk in the high 16 bits, staged
//      in shared memory by sorted index from 4-byte loads and written at
//      their sorted positions (consecutive threads on consecutive
//      positions of a slot's run).
//      The sorted arrays are column-major, [G][R] bytes and [C][R]
//      words, and each slot's run starts at a multiple of 16 positions,
//      so a walking lane reads 16 rows of its column in one 16-byte load
//      and the values of 16 rows in four broadcast ones;
//   5. fw_heavy_kernel (on a second stream, beside step 6): one warp
//      per (heavy (slot, chunk) pair, value row, group of 32 columns),
//      lane = column, sums the pair's rows in
//      row order from +0.0 into a private [B][32] tile in shared memory,
//      4 rows at a time (the 4 cells are loaded together and a row whose
//      bin repeats an earlier one of the 4 takes that row's new sum), and
//      writes the tile as the pair's chunk partial [C][B][G];
//   6. fw_light_kernel: one warp per (output slot, value row, group of
//      32 columns), lane = column, walks the slot's light rows once, in
//      sorted order (chunk by chunk, rows in order),
//      32 rows a batch (one 16-byte load of each lane's column per 16
//      rows, the values shared by shuffles), 4 rows at a time as step 5.
//      Each of the lane's cells keeps its total, the partial of the last
//      chunk that reached it and that chunk's index (an int4 in shared
//      memory).  A row of a newer chunk first adds the cell's partial
//      into its total and restarts the partial from +0.0: the same adds
//      in the same order as the chunk partials folded in chunk order,
//      with no per-chunk zeroing and no fold of every cell.  The work
//      follows the rows;
//   7. fw_fold_kernel: one thread per (output slot with heavy pairs,
//      value row, bin, column) adds the slot's chunk partials, which all
//      follow its light chunks, to what the walk left, in chunk order
//      (the pairs of a slot are numbered in chunk order).
//
// What bounds it on an H100: the roofline bound is bytes (bins G B/row,
// values 4C B/row, hist leaf 4 B/row, the carry read and written once).  The sort moves
// each active row's bins and values once more (G + 4C B, written and
// read back by the walking warps).  A light slot's walk is one chain of
// shared-memory updates per lane, so its rows set its time (latency,
// not bytes, bounds it: about 50 cycles a row on the card, PERF.md); a
// heavy
// slot's rows are spread over its chunks, and its partials (G x B x C
// floats per chunk with rows) are written and read back.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FW_LANES 32
#define FW_COUNT_THREADS 256
#define FW_SCAN_THREADS 256
#define FW_PLAN_THREADS 1024
#define FW_FILL_THREADS 256
#define FW_FOLD_THREADS 256
#define FW_HEAVY_WARPS 4
#define FW_BATCH 32    // rows a walking warp loads at once (two in flight)
#define FW_ALIGN 16    // a slot's run of sorted positions starts at a multiple
enum {
  FW_K_COUNT = 1,
  FW_K_SCAN = 2,
  FW_K_PLAN = 4,
  FW_K_FILL = 8,
  FW_K_HEAVY = 16,
  FW_K_LIGHT = 32,
  FW_K_FOLD = 64
};

// The int32 scratch of a window: counts, offs and nzb [A][Kw] (rows of
// each (slot, chunk), rows of the slot before it, chunks of the slot
// with rows before it), then the per-slot table meta [FW_META * A + 2]
// (rows, chunks with rows, first sorted position, first heavy pair or
// -1, rows walked, heavy pairs; then the heavy pairs and slots with
// some), then the heavy pairs hpair[pcap] (slot << 16 | chunk).  The
// host sizes it the same way (ops/histogram.py FloatWalkScratch).
enum {
  FW_TOT = 0,
  FW_NPAIR = 1,
  FW_BASE = 2,
  FW_HBASE = 3,
  FW_LROWS = 4,
  FW_HCOUNT = 5,
  FW_META = 6
};

struct WalkBufs {
  int* counts;
  int* offs;
  int* nzb;
  int* meta;
  int* hpair;
};

__host__ __device__ inline WalkBufs walk_bufs(int* ibuf, int A, int Kw) {
  WalkBufs w;
  w.counts = ibuf;
  w.offs = ibuf + (long long)A * Kw;
  w.nzb = ibuf + 2LL * A * Kw;
  w.meta = ibuf + 3LL * A * Kw;
  w.hpair = w.meta + FW_META * A + 2;
  return w;
}

// Sorted positions of a window of `nrows` rows (the column stride of the
// sorted arrays): every slot's run padded to FW_ALIGN, and a batch's
// worth of slack after the last (ops/histogram.py float_walk_rows).
__host__ __device__ inline long long fw_rows(long long nrows, int A) {
  return (nrows + (long long)FW_ALIGN * A + FW_ALIGN - 1) / FW_ALIGN *
             FW_ALIGN + FW_BATCH;
}

__device__ __forceinline__ float fw_bf16_to_float(uint32_t u) {
  return __uint_as_float(u << 16);
}

__global__ void __launch_bounds__(FW_COUNT_THREADS)
fw_count_kernel(const int* __restrict__ hist_leaf, long long nrows, int L,
                const int* __restrict__ inv, int A, int chunk, int Kw,
                int* __restrict__ counts) {
  extern __shared__ int cnt[];   // [A]
  for (int s = threadIdx.x; s < A; s += blockDim.x) cnt[s] = 0;
  __syncthreads();
  const int k = blockIdx.x;
  const long long r0 = (long long)k * chunk;
  const int len = (int)min((long long)chunk, nrows - r0);
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int hl = hist_leaf[r0 + i];
    const int s = inv[hl >= 0 ? hl : L];
    if (s >= 0) atomicAdd(&cnt[s], 1);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < A; s += blockDim.x)
    counts[(long long)s * Kw + k] = cnt[s];
}

// Slot blockIdx.x: each thread a segment of chunks, a Hillis-Steele scan
// of the segment sums (rows and chunks with rows) in shared memory.
__global__ void __launch_bounds__(FW_SCAN_THREADS)
fw_scan_kernel(const int* __restrict__ counts, int Kw, int A,
               int* __restrict__ offs, int* __restrict__ nzb,
               int* __restrict__ meta) {
  __shared__ int ps[FW_SCAN_THREADS];
  __shared__ int pn[FW_SCAN_THREADS];
  const int s = blockIdx.x;
  const int t = threadIdx.x;
  const int NT = blockDim.x;
  const int seg = (Kw + NT - 1) / NT;
  const int k0 = min(Kw, t * seg);
  const int k1 = min(Kw, k0 + seg);
  const int* cs = counts + (long long)s * Kw;
  int sum = 0, nz = 0;
  for (int k = k0; k < k1; ++k) {
    sum += cs[k];
    nz += cs[k] > 0;
  }
  ps[t] = sum;
  pn[t] = nz;
  __syncthreads();
  for (int d = 1; d < NT; d <<= 1) {
    const int a = t >= d ? ps[t - d] : 0;
    const int b = t >= d ? pn[t - d] : 0;
    __syncthreads();
    ps[t] += a;
    pn[t] += b;
    __syncthreads();
  }
  int run = ps[t] - sum, nr = pn[t] - nz;
  for (int k = k0; k < k1; ++k) {
    const int c = cs[k];
    offs[(long long)s * Kw + k] = run;
    nzb[(long long)s * Kw + k] = nr;
    run += c;
    nr += c > 0;
  }
  if (t == NT - 1) {
    meta[FW_TOT * A + s] = ps[t];
    meta[FW_NPAIR * A + s] = pn[t];
  }
}

// out[i] = the sum of v(u) over u < i for i < n, v(u) = vals[idx ? idx[u]
// : u] rounded up to a multiple of `align`; all threads of the block take
// part (out may be vals).  -> the total.
__device__ __forceinline__ int fw_block_scan(const int* vals, const int* idx,
                                             int* out, int n, int align,
                                             int* part) {
  const int t = threadIdx.x;
  const int NT = blockDim.x;
  int carry = 0;
  for (int b0 = 0; b0 < n; b0 += NT) {
    const int i = b0 + t;
    const int v =
        i < n ? (vals[idx ? idx[i] : i] + align - 1) / align * align : 0;
    part[t] = v;
    __syncthreads();
    for (int d = 1; d < NT; d <<= 1) {
      const int a = t >= d ? part[t - d] : 0;
      __syncthreads();
      part[t] += a;
      __syncthreads();
    }
    if (i < n) out[i] = carry + part[t] - v;
    carry += part[NT - 1];
    __syncthreads();
  }
  return carry;
}

// One block: meta's first sorted positions (each slot's run aligned to
// FW_ALIGN) and each slot's split between its walk and its heavy pairs.
// Shared memory: the slots by rows, largest first (ord [A]), the heavy
// pairs of the slots before each rank (cum [A]) and each slot's first
// heavy chunk (ks [A]).
__global__ void __launch_bounds__(FW_PLAN_THREADS)
fw_plan_kernel(const int* __restrict__ offs, const int* __restrict__ nzb,
               int Kw, int A, int light_rows, int dense_rows, int pcap,
               int* __restrict__ meta, int* __restrict__ hpair) {
  extern __shared__ int psh[];
  __shared__ int part[FW_PLAN_THREADS];
  __shared__ int nheavy;
  int* ord = psh;
  int* cum = psh + A;
  int* ks = psh + 2 * A;
  const int* tot = meta + FW_TOT * A;
  const int* npair = meta + FW_NPAIR * A;
  int* base = meta + FW_BASE * A;
  int* hbase = meta + FW_HBASE * A;
  int* lrows = meta + FW_LROWS * A;
  int* hcount = meta + FW_HCOUNT * A;
  const int t = threadIdx.x;
  const int NT = blockDim.x;
  for (int s = t; s < A; s += NT) {
    const int ts = tot[s];
    int r = 0;
    for (int u = 0; u < A; ++u) {
      const int tu = tot[u];
      r += tu > ts || (tu == ts && u < s);
    }
    ord[r] = s;
    // the slot's first chunks whose rows fit light_rows stay light: the
    // last k with offs(k) <= light_rows, offs(Kw) = tot (none of a dense
    // slot's)
    int k = Kw;
    int c = 0;
    if (ts > light_rows) {
      const int* o = offs + (long long)s * Kw;
      int lo = 0, hi = ts >= dense_rows ? 0 : Kw - 1;   // o[0] = 0
      while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (o[mid] <= light_rows) lo = mid; else hi = mid - 1;
      }
      k = lo;
      c = npair[s] - nzb[(long long)s * Kw + k];
    }
    ks[s] = k;
    hcount[s] = c;
  }
  if (t == 0) nheavy = 0;
  __syncthreads();
  fw_block_scan(tot, nullptr, base, A, FW_ALIGN, part);
  fw_block_scan(hcount, ord, cum, A, 1, part);
  for (int r = t; r < A; r += NT) {
    const int s = ord[r];
    const int c = hcount[s];
    const bool heavy = c > 0 && cum[r] + c <= pcap;
    hbase[s] = heavy ? cum[r] : -1;
    lrows[s] = heavy ? offs[(long long)s * Kw + ks[s]] : tot[s];
    if (heavy) atomicAdd(&nheavy, 1);
  }
  __syncthreads();
  for (int s = t; s < A; s += NT)   // pairs past the cap stay walked
    if (hbase[s] < 0) hcount[s] = 0;
  const int nh = nheavy;   // the heavy slots: ranks [0, nh)
  if (t == 0) {
    meta[FW_META * A] = nh > 0 ? cum[nh - 1] + hcount[ord[nh - 1]] : 0;
    meta[FW_META * A + 1] = nh;
  }
  for (int r = 0; r < nh; ++r) {
    const int s = ord[r];
    const int hb = hbase[s];
    const int k0 = ks[s];
    const int* cs = nzb + (long long)s * Kw;
    const int r0 = cs[k0];
    for (int k = k0 + t; k < Kw; k += NT) {
      const bool rows = k + 1 < Kw ? cs[k + 1] > cs[k]
                                   : npair[s] > cs[k];
      if (rows) hpair[hb + cs[k] - r0] = (s << 16) | k;
    }
  }
}

// One block per chunk: the stable sort of its rows by slot, then their
// bins and bf16 values (chunk in the high half) at their sorted
// positions.  Both sides are coalesced: 32 columns (or a value row) of
// the chunk are staged in shared memory at their sorted indices from
// 4-byte loads, then written in sorted order, consecutive threads on
// consecutive positions of a slot's run.  Shared memory: per-warp counts
// [W][A], each slot's first index in the chunk's sorted order [A], a
// row's slot and then its sorted index [chunk], each sorted index's
// global position [chunk], and the staging area (32 columns of bytes, or
// a value row of words) [32 * chunk] bytes.
__global__ void __launch_bounds__(FW_FILL_THREADS)
fw_fill_kernel(const uint8_t* __restrict__ bins_t, long long ld,
               long long nrows, int G, const float* __restrict__ vals, int C,
               const int* __restrict__ hist_leaf, int L,
               const int* __restrict__ inv, int A, int chunk, int Kw,
               const int* __restrict__ offs, const int* __restrict__ meta,
               long long R, uint8_t* __restrict__ sbins,
               uint32_t* __restrict__ svals) {
  extern __shared__ int fsh[];
  __shared__ int part[FW_FILL_THREADS];
  const int W = blockDim.x / FW_LANES;
  const int NT = blockDim.x;
  const int tid = threadIdx.x;
  const int w = tid / FW_LANES;
  const int lane = tid % FW_LANES;
  const unsigned full = 0xffffffffu;
  int* wcnt = fsh;                        // [W][A]
  int* cst = fsh + W * A;                 // [A]
  int* slot = cst + A;                    // [chunk]
  int* gpos = slot + chunk;               // [chunk]
  uint8_t* sb = (uint8_t*)(gpos + chunk); // [32][chunk]
  uint32_t* sv = (uint32_t*)sb;           // [chunk]
  const int k = blockIdx.x;
  const long long r0 = (long long)k * chunk;
  const int len = (int)min((long long)chunk, nrows - r0);
  for (int i = tid; i < W * A; i += NT) wcnt[i] = 0;
  for (int i = tid; i < len; i += NT) {
    const int hl = hist_leaf[r0 + i];
    slot[i] = inv[hl >= 0 ? hl : L];
  }
  __syncthreads();
  // rows [seg0, seg1) belong to warp w; their rounds of 32 run in order
  const int seg = ((len + W - 1) / W + 31) & ~31;
  const int seg0 = min(len, w * seg);
  const int seg1 = min(len, seg0 + seg);
  for (int b = seg0; b < seg1; b += FW_LANES) {
    const int i = b + lane;
    const int s = i < seg1 ? slot[i] : -1;
    const unsigned peers = __match_any_sync(full, s);
    if (s >= 0 && lane == __ffs(peers) - 1) wcnt[w * A + s] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int s = tid; s < A; s += NT) {
    int t = 0;
    for (int v = 0; v < W; ++v) t += wcnt[v * A + s];
    cst[s] = t;
  }
  __syncthreads();
  const int nact = fw_block_scan(cst, nullptr, cst, A, 1, part);
  for (int s = tid; s < A; s += NT) {
    int run = cst[s];
    for (int v = 0; v < W; ++v) {
      const int t = wcnt[v * A + s];
      wcnt[v * A + s] = run;
      run += t;
    }
  }
  __syncthreads();
  // each row's sorted index (in place of its slot; a row is its lane's)
  // and each sorted index's global position
  const int* base = meta + FW_BASE * A;
  for (int b = seg0; b < seg1; b += FW_LANES) {
    const int i = b + lane;
    const int s = i < seg1 ? slot[i] : -1;
    const unsigned peers = __match_any_sync(full, s);
    int q = -1;
    if (s >= 0) {
      q = wcnt[w * A + s] + __popc(peers & ((1u << lane) - 1u));
      gpos[q] = base[s] + offs[(long long)s * Kw + k] + (q - cst[s]);
    }
    __syncwarp();
    if (s >= 0 && lane == __ffs(peers) - 1) wcnt[w * A + s] += __popc(peers);
    if (i < seg1) slot[i] = q;
    __syncwarp();
  }
  __syncthreads();
  const int quads = len / 4;
  for (int g0 = 0; g0 < G; g0 += FW_LANES) {
    const int ng = min(FW_LANES, G - g0);
    for (int qd = tid; qd < quads; qd += NT) {
      int q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] = slot[4 * qd + j];
      if ((q[0] & q[1] & q[2] & q[3]) < 0) continue;   // no active row
      const uint8_t* src = bins_t + (long long)g0 * ld + r0 + 4 * qd;
      for (int gl = 0; gl < ng; ++gl) {
        const uint32_t wd = *(const uint32_t*)(src + gl * ld);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (q[j] >= 0) sb[gl * chunk + q[j]] = (uint8_t)(wd >> (8 * j));
      }
    }
    __syncthreads();
    for (int gl = 0; gl < ng; ++gl) {
      uint8_t* dst = sbins + (g0 + gl) * R;
      for (int q = tid; q < nact; q += NT) dst[gpos[q]] = sb[gl * chunk + q];
    }
    __syncthreads();
  }
  const uint32_t ktag = (uint32_t)k << 16;
  for (int c = 0; c < C; ++c) {
    for (int qd = tid; qd < quads; qd += NT) {
      const float4 f = *(const float4*)(vals + (long long)c * ld + r0 + 4 * qd);
      const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = slot[4 * qd + j];
        if (q >= 0)
          sv[q] = ktag | __bfloat16_as_ushort(__float2bfloat16_rn(fv[j]));
      }
    }
    __syncthreads();
    for (int q = tid; q < nact; q += NT) svals[c * R + gpos[q]] = sv[q];
    __syncthreads();
  }
}

// A batch of FW_BATCH (32) sorted rows from an aligned position: the 32
// bins of the lane's column (2 x 16 B) and the packed value (bf16 bits,
// chunk << 16) of row `lane`, which the warp's lanes share by shuffles.
// (Loads with one address for the whole warp would be moved to uniform
// registers as soon as they are issued, which waits for them and undoes
// the double buffering.)
struct FwBatch {
  uint4 b[FW_BATCH / 16];
  uint32_t v;
};

__device__ __forceinline__ void fw_load(const uint8_t* bcol,
                                        const uint32_t* vrow, long long j,
                                        FwBatch& x) {
#pragma unroll
  for (int t = 0; t < FW_BATCH / 16; ++t)
    x.b[t] = *(const uint4*)(bcol + j + 16 * t);
  x.v = vrow[j + threadIdx.x % FW_LANES];
}

__device__ __forceinline__ uint32_t fw_word(const uint4* a, int i) {
  const uint4 q = a[i >> 2];
  return (i & 3) == 0 ? q.x : (i & 3) == 1 ? q.y : (i & 3) == 2 ? q.z : q.w;
}

__device__ __forceinline__ int fw_bin(const FwBatch& x, int u) {
  return (fw_word(x.b, u >> 2) >> (8 * (u & 3))) & 0xff;
}

// The batch's 32 packed values in every lane, shuffled up front with no
// branch between them (a shuffle behind a per-row branch cannot be
// hoisted, and each row then waits out its latency).
struct FwVals {
  uint32_t v[FW_BATCH];
};

__device__ __forceinline__ void fw_vals(const FwBatch& x, FwVals& y) {
#pragma unroll
  for (int u = 0; u < FW_BATCH; ++u)
    y.v[u] = __shfl_sync(0xffffffffu, x.v, u);
}

// Rows q..q+3 of a batch into the lane's tile (bin b at cell[b * 32]),
// in row order: the 4 cells are loaded together and a row whose bin
// repeats an earlier one of the 4 takes that row's new sum.
__device__ __forceinline__ void fw_tile4(float* cell, const FwBatch& x,
                                         const FwVals& y, int q) {
  const int b0 = fw_bin(x, q), b1 = fw_bin(x, q + 1);
  const int b2 = fw_bin(x, q + 2), b3 = fw_bin(x, q + 3);
  const float v0 = fw_bf16_to_float(y.v[q] & 0xffffu);
  const float v1 = fw_bf16_to_float(y.v[q + 1] & 0xffffu);
  const float v2 = fw_bf16_to_float(y.v[q + 2] & 0xffffu);
  const float v3 = fw_bf16_to_float(y.v[q + 3] & 0xffffu);
  const float x0 = cell[b0 * FW_LANES];
  const float x1 = cell[b1 * FW_LANES];
  const float x2 = cell[b2 * FW_LANES];
  const float x3 = cell[b3 * FW_LANES];
  const float s0 = __fadd_rn(x0, v0);
  const float s1 = __fadd_rn(b1 == b0 ? s0 : x1, v1);
  const float s2 = __fadd_rn(b2 == b1 ? s1 : b2 == b0 ? s0 : x2, v2);
  const float s3 =
      __fadd_rn(b3 == b2 ? s2 : b3 == b1 ? s1 : b3 == b0 ? s0 : x3, v3);
  cell[b0 * FW_LANES] = s0;   // in row order: the last store to a
  cell[b1 * FW_LANES] = s1;   // repeated bin holds its newest sum
  cell[b2 * FW_LANES] = s2;
  cell[b3 * FW_LANES] = s3;
}

// A heavy pair's rows u0 <= u < m of a batch into the lane's tile.
__device__ __forceinline__ void fw_tile_rows(float* cell, const FwBatch& x,
                                             int u0, int m) {
  FwVals y;
  fw_vals(x, y);
  if (u0 == 0 && m == FW_BATCH) {   // a whole batch: no row conditions
#pragma unroll
    for (int q = 0; q < FW_BATCH; q += 4) fw_tile4(cell, x, y, q);
    return;
  }
#pragma unroll
  for (int q = 0; q < FW_BATCH; q += 4) {
    if (q >= u0 && q + 4 <= m) {
      fw_tile4(cell, x, y, q);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (q + r >= u0 && q + r < m) {
          const int b = fw_bin(x, q + r);
          cell[b * FW_LANES] = __fadd_rn(
              cell[b * FW_LANES], fw_bf16_to_float(y.v[q + r] & 0xffffu));
        }
    }
  }
}

// Warps of FW_HEAVY_WARPS a block walk the heavy pairs' (value row,
// column group) items, grid-stride; each warp a [B][32] tile.
__global__ void __launch_bounds__(FW_HEAVY_WARPS * FW_LANES)
fw_heavy_kernel(const int* __restrict__ counts, const int* __restrict__ offs,
                const int* __restrict__ meta, const int* __restrict__ hpair,
                int Kw, const uint8_t* __restrict__ sbins,
                const uint32_t* __restrict__ svals, long long R, int G, int C,
                int A, int B, float* __restrict__ partial) {
  extern __shared__ float hsh[];
  const int W = blockDim.x / FW_LANES;
  const int w = threadIdx.x / FW_LANES;
  const int lane = threadIdx.x % FW_LANES;
  float* cell = hsh + (long long)w * B * FW_LANES + lane;
  const int ncg = (G + FW_LANES - 1) / FW_LANES;
  const long long items = (long long)meta[FW_META * A] * C * ncg;
  for (long long it = (long long)blockIdx.x * W + w; it < items;
       it += (long long)gridDim.x * W) {
    const int cg = (int)(it % ncg);
    const int c = (int)(it / ncg % C);
    const long long h = it / ((long long)ncg * C);
    const int pr = hpair[h];
    const int s = pr >> 16, k = pr & 0xffff;
    const long long j0 = meta[FW_BASE * A + s] + offs[(long long)s * Kw + k];
    const long long jend = j0 + counts[(long long)s * Kw + k];
    const int g0 = cg * FW_LANES;
    const int ng = min(FW_LANES, G - g0);
    const uint8_t* bcol = sbins + (g0 + min(lane, ng - 1)) * R;
    const uint32_t* vrow = svals + c * R;
    for (int b = 0; b < B; ++b) cell[b * FW_LANES] = 0.f;
    // batches from the aligned position at or before j0
    long long j = j0 / FW_ALIGN * FW_ALIGN;
    int u0 = (int)(j0 - j);
    FwBatch xa, xb;
    fw_load(bcol, vrow, j, xa);
    while (true) {   // two batches a turn: one walked while one loads
      if (j + FW_BATCH < jend) fw_load(bcol, vrow, j + FW_BATCH, xb);
      fw_tile_rows(cell, xa, u0, (int)min((long long)FW_BATCH, jend - j));
      u0 = 0;
      j += FW_BATCH;
      if (j >= jend) break;
      if (j + FW_BATCH < jend) fw_load(bcol, vrow, j + FW_BATCH, xa);
      fw_tile_rows(cell, xb, 0, (int)min((long long)FW_BATCH, jend - j));
      j += FW_BATCH;
      if (j >= jend) break;
    }
    if (lane < ng) {
      float* dst = partial + ((h * C + c) * B) * G + g0 + lane;
      for (int b = 0; b < B; ++b) dst[(long long)b * G] = cell[b * FW_LANES];
    }
  }
}

// A light walk's cell: total, partial of its last chunk, that chunk (the
// floats as their bits).  A row of chunk k adding v.
__device__ __forceinline__ int4 fw_step(int4 x, uint32_t w) {
  const int k = (int)(w >> 16);
  const float v = fw_bf16_to_float(w & 0xffffu);
  const bool fresh = x.z != k;
  const float tot = __int_as_float(x.x);
  const float pend = __int_as_float(x.y);
  const float t2 = fresh ? __fadd_rn(tot, pend) : tot;
  const float p2 = __fadd_rn(fresh ? 0.f : pend, v);
  return make_int4(__float_as_int(t2), __float_as_int(p2), k, 0);
}

// Rows q..q+3 of a batch: the 4 cells are loaded together and a row
// whose bin repeats an earlier one of the 4 takes that row's new state.
__device__ __forceinline__ void fw_walk4(int4* cell, const FwBatch& x,
                                         const FwVals& y, int q) {
  const int b0 = fw_bin(x, q), b1 = fw_bin(x, q + 1);
  const int b2 = fw_bin(x, q + 2), b3 = fw_bin(x, q + 3);
  const int4 x0 = cell[b0 * FW_LANES];
  const int4 x1 = cell[b1 * FW_LANES];
  const int4 x2 = cell[b2 * FW_LANES];
  const int4 x3 = cell[b3 * FW_LANES];
  const int4 y0 = fw_step(x0, y.v[q]);
  const int4 y1 = fw_step(b1 == b0 ? y0 : x1, y.v[q + 1]);
  const int4 y2 = fw_step(b2 == b1 ? y1 : b2 == b0 ? y0 : x2, y.v[q + 2]);
  const int4 y3 = fw_step(b3 == b2 ? y2 : b3 == b1 ? y1 : b3 == b0 ? y0 : x3,
                          y.v[q + 3]);
  cell[b0 * FW_LANES] = y0;
  cell[b1 * FW_LANES] = y1;
  cell[b2 * FW_LANES] = y2;
  cell[b3 * FW_LANES] = y3;
}

__device__ __forceinline__ void fw_walk_rows(int4* cell, const FwBatch& x,
                                             int m) {
  FwVals y;
  fw_vals(x, y);
  if (m == FW_BATCH) {   // a whole batch: no row conditions
#pragma unroll
    for (int q = 0; q < FW_BATCH; q += 4) fw_walk4(cell, x, y, q);
    return;
  }
#pragma unroll
  for (int q = 0; q < FW_BATCH; q += 4) {
    if (q + 4 <= m) {
      fw_walk4(cell, x, y, q);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (q + r < m) {
          const int b = fw_bin(x, q + r);
          cell[b * FW_LANES] = fw_step(cell[b * FW_LANES], y.v[q + r]);
        }
    }
  }
}

// One warp a block: output slot, value row and column group of item
// blockIdx.x; its cells [B][32] int4 in shared memory.
__global__ void __launch_bounds__(FW_LANES)
fw_light_kernel(const int* __restrict__ meta,
                const uint8_t* __restrict__ sbins,
                const uint32_t* __restrict__ svals, long long R, int G,
                int C, int A, int B, const int* __restrict__ src,
                float* __restrict__ acc) {
  extern __shared__ int4 lsh[];
  const int lane = threadIdx.x;
  const int ncg = (G + FW_LANES - 1) / FW_LANES;
  const int cg = blockIdx.x % ncg;
  const int c = blockIdx.x / ncg % C;
  const int s = blockIdx.x / (ncg * C);
  const int ss = src[s];
  if (ss < 0) return;
  const int g0 = cg * FW_LANES;
  const int ng = min(FW_LANES, G - g0);
  float* out = acc + ((long long)s * G + g0 + min(lane, ng - 1)) * B * C + c;
  int4* cell = lsh + lane;   // bin b at cell[b * 32]
  // the carry; a cell's first add (of +0.0 pending, at its first row or
  // in the final flush) turns -0.0 into +0.0, as the float K5's first
  // fold add does
  for (int b = 0; b < B; ++b)
    cell[b * FW_LANES] = make_int4(
        __float_as_int(lane < ng ? out[(long long)b * C] : 0.f), 0, -1, 0);
  long long j = meta[FW_BASE * A + ss];   // a multiple of FW_ALIGN
  const long long jend = j + meta[FW_LROWS * A + ss];
  const uint8_t* bcol = sbins + (g0 + min(lane, ng - 1)) * R;
  const uint32_t* vrow = svals + c * R;
  if (j < jend) {
    FwBatch xa, xb;
    fw_load(bcol, vrow, j, xa);
    while (true) {   // two batches a turn: one walked while one loads
      if (j + FW_BATCH < jend) fw_load(bcol, vrow, j + FW_BATCH, xb);
      fw_walk_rows(cell, xa, (int)min((long long)FW_BATCH, jend - j));
      j += FW_BATCH;
      if (j >= jend) break;
      if (j + FW_BATCH < jend) fw_load(bcol, vrow, j + FW_BATCH, xa);
      fw_walk_rows(cell, xb, (int)min((long long)FW_BATCH, jend - j));
      j += FW_BATCH;
      if (j >= jend) break;
    }
  }
  // each cell's last partial into its total (+0.0 where none is pending)
  if (lane < ng)
    for (int b = 0; b < B; ++b) {
      const int4 x = cell[b * FW_LANES];
      out[(long long)b * C] =
          __fadd_rn(__int_as_float(x.x), __int_as_float(x.y));
    }
}

// One thread per (output slot, value row, bin, column), column fastest.
__global__ void __launch_bounds__(FW_FOLD_THREADS)
fw_fold_kernel(const int* __restrict__ meta,
               const float* __restrict__ partial, int A, int C, int B, int G,
               const int* __restrict__ src, float* __restrict__ acc) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)A * C * B * G) return;
  const int g = (int)(idx % G);
  const int b = (int)(idx / G % B);
  const int c = (int)(idx / ((long long)G * B) % C);
  const int s = (int)(idx / ((long long)G * B * C));
  const int ss = src[s];
  if (ss < 0) return;
  const int hb = meta[FW_HBASE * A + ss];
  if (hb < 0) return;
  const int np = meta[FW_HCOUNT * A + ss];
  float* out = acc + (((long long)s * G + g) * B + b) * C + c;
  const long long stride = (long long)C * B * G;
  const float* p = partial + ((long long)hb * C + c) * B * G +
                   (long long)b * G + g;
  float t = *out;   // as the walk left it (no -0.0)
  int h = 0;
  for (; h + 8 <= np; h += 8) {   // 8 chunks' reads in flight
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = p[(h + u) * stride];
#pragma unroll
    for (int u = 0; u < 8; ++u) t = __fadd_rn(t, x[u]);
  }
  for (; h < np; ++h) t = __fadd_rn(t, p[h * stride]);
  *out = t;
}

// A second stream and two events (made once; the port drives one card
// per process) on which the heavy partials run beside the light walks:
// the caller's stream forks to it and joins it before the fold.  Stream
// capture records the fork and join as two branches of the graph.
struct FwSide {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

inline cudaError_t fw_side(FwSide** out) {
  static FwSide side;
  cudaError_t err = cudaSuccess;
  if (!side.stream) {
    if ((err = cudaStreamCreateWithFlags(&side.stream,
                                         cudaStreamNonBlocking)) ||
        (err = cudaEventCreateWithFlags(&side.fork,
                                        cudaEventDisableTiming)) ||
        (err = cudaEventCreateWithFlags(&side.join,
                                        cudaEventDisableTiming)))
      return err;
  }
  *out = &side;
  return err;
}

// A kernel's dynamic shared memory above 48 KB, set once per size (the
// port drives one card per process).
template <class K>
inline cudaError_t fw_smem(K* kernel, int bytes, int* set) {
  if (bytes <= *set) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *set = bytes;
  return err;
}

// The launches of one window: `kernels` is a mask of FW_K_* (all of them
// for a call; one or a few, reading what earlier launches left in the
// scratch, to time them apart).
inline int float_walk_window(const void* bins_t, long long ld,
                             long long nrows, int G, const void* vals, int C,
                             const void* hist_leaf, int L, const void* inv,
                             const void* src, int A, int B, int chunk,
                             int light_rows, int dense_rows, int pcap,
                             int heavy_blocks,
                             int kernels, void* ibuf, void* sbins,
                             void* svals, void* partial, void* acc,
                             void* stream) {
  static int count_set = 48 << 10, plan_set = 48 << 10, fill_set = 48 << 10;
  static int heavy_set = 48 << 10, light_set = 48 << 10;
  cudaStream_t st = (cudaStream_t)stream;
  const int Kw = (int)((nrows + chunk - 1) / chunk);
  const long long R = fw_rows(nrows, A);
  const WalkBufs wb = walk_bufs((int*)ibuf, A, Kw);
  cudaError_t err = cudaSuccess;
  if (kernels & FW_K_COUNT) {
    const int count_smem = A * 4;
    if ((err = fw_smem(fw_count_kernel, count_smem, &count_set)))
      return (int)err;
    fw_count_kernel<<<Kw, FW_COUNT_THREADS, count_smem, st>>>(
        (const int*)hist_leaf, nrows, L, (const int*)inv, A, chunk, Kw,
        wb.counts);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (kernels & FW_K_SCAN) {
    fw_scan_kernel<<<A, FW_SCAN_THREADS, 0, st>>>(wb.counts, Kw, A, wb.offs,
                                                  wb.nzb, wb.meta);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (kernels & FW_K_PLAN) {
    const int plan_smem = 3 * A * 4;
    if ((err = fw_smem(fw_plan_kernel, plan_smem, &plan_set)))
      return (int)err;
    fw_plan_kernel<<<1, FW_PLAN_THREADS, plan_smem, st>>>(
        wb.offs, wb.nzb, Kw, A, light_rows, dense_rows, pcap, wb.meta,
        wb.hpair);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (kernels & FW_K_FILL) {
    const int fill_smem =
        ((FW_FILL_THREADS / FW_LANES + 1) * A + 2 * chunk) * (int)sizeof(int) +
        FW_LANES * chunk;
    if ((err = fw_smem(fw_fill_kernel, fill_smem, &fill_set)))
      return (int)err;
    fw_fill_kernel<<<Kw, FW_FILL_THREADS, fill_smem, st>>>(
        (const uint8_t*)bins_t, ld, nrows, G, (const float*)vals, C,
        (const int*)hist_leaf, L, (const int*)inv, A, chunk, Kw, wb.offs, wb.meta, R,
        (uint8_t*)sbins, (uint32_t*)svals);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  // the heavy partials beside the light walks when both run
  const bool fork = (kernels & FW_K_HEAVY) && (kernels & FW_K_LIGHT);
  FwSide* side = nullptr;
  if (fork) {
    if ((err = fw_side(&side)) || (err = cudaEventRecord(side->fork, st)) ||
        (err = cudaStreamWaitEvent(side->stream, side->fork, 0)))
      return (int)err;
  }
  if (kernels & FW_K_HEAVY) {
    const int heavy_smem = FW_HEAVY_WARPS * B * FW_LANES * (int)sizeof(float);
    if ((err = fw_smem(fw_heavy_kernel, heavy_smem, &heavy_set)))
      return (int)err;
    fw_heavy_kernel<<<heavy_blocks, FW_HEAVY_WARPS * FW_LANES, heavy_smem,
                      fork ? side->stream : st>>>(
        wb.counts, wb.offs, wb.meta, wb.hpair, Kw, (const uint8_t*)sbins,
        (const uint32_t*)svals, R, G, C, A, B, (float*)partial);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (kernels & FW_K_LIGHT) {
    const int light_smem = B * FW_LANES * (int)sizeof(int4);
    if ((err = fw_smem(fw_light_kernel, light_smem, &light_set)))
      return (int)err;
    const int ncg = (G + FW_LANES - 1) / FW_LANES;
    fw_light_kernel<<<A * C * ncg, FW_LANES, light_smem, st>>>(
        wb.meta, (const uint8_t*)sbins, (const uint32_t*)svals, R, G, C, A,
        B, (const int*)src, (float*)acc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (fork) {
    if ((err = cudaEventRecord(side->join, side->stream)) ||
        (err = cudaStreamWaitEvent(st, side->join, 0)))
      return (int)err;
  }
  if (kernels & FW_K_FOLD) {
    const long long cells = (long long)A * C * B * G;
    fw_fold_kernel<<<(unsigned)((cells + FW_FOLD_THREADS - 1) /
                                FW_FOLD_THREADS),
                     FW_FOLD_THREADS, 0, st>>>(wb.meta,
                                               (const float*)partial, A, C,
                                               B, G, (const int*)src,
                                               (float*)acc);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
