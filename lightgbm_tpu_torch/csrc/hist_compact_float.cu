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
// The order is the float K5's (hist_float.cuh): per output slot and
// cell, the carry plus, in chunk order, each 2,048-row chunk's partial,
// itself the cell's rows of that chunk summed in row order from +0.0
// (__fadd_rn throughout: no FMA contraction).  So a call is bitwise the
// float K5 on its non-negative slots, and an in-memory float model is
// bitwise the streamed one.  That order deviates from the reference,
// whose float K3 is not chain-exact against its own wide kernel.
//
// Design: no per-(chunk, slot) partials in device memory, whose size
// would grow with rows x slots.  Like the reference's compact_plan, the
// rows are first sorted by slot, stably (row order kept), on the card:
//   1. cf_count_kernel: rows of each (chunk, accumulation slot), one
//      block per chunk, shared-memory int atomics (exact);
//   2. cf_scan_kernel: the first sorted position of each (chunk, slot),
//      the exclusive prefix of the counts in slot-major order (one block);
//   3. cf_fill_kernel: one block per chunk sorts its rows by slot in
//      shared memory, stably, as the float K5 sorts a chunk, and writes
//      each active row's bins (row-major, 4 columns a word) and its values
//      rounded to bf16 (__float2bfloat16_rn) at its sorted position;
// then
//   4. cf_walk_kernel: one block per (output slot, value row, group of 32
//      columns), lane = column.  Its W warps take W consecutive chunks at
//      a time: each sums its chunk's rows of the slot (contiguous in the
//      sorted arrays) in row order from +0.0 into a private [B][32] tile
//      in shared memory, 4 rows at a time as the float K5 does; then the
//      block adds the W tiles into the totals [B][32], in chunk order,
//      cells spread over its threads.  A chunk without rows of the slot
//      adds +0.0 in the float K5's fold: after the carry has had +0.0
//      added once (which turns -0.0 into +0.0), such adds change no bit,
//      so they are skipped.
//
// What bounds it on an H100: bytes (hist leaf 4 B/row; bins G B/row and
// values 4C B/row of the active rows; the output); the sort moves each
// active row's bins and values once more (G + 2C B, written and read
// back by each of the C walking blocks).  The walk of a chunk is a chain
// of shared-memory adds per lane; the blocks of the slot with the most
// rows set the time (a wave whose rows sit in one slot keeps C blocks
// busy).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define LGBM_CF_COUNT_THREADS 256
#define LGBM_CF_SCAN_THREADS 1024
#define LGBM_CF_FILL_THREADS 256
#define LGBM_CF_LANES 32
#define LGBM_CF_BATCH 16
#define LGBM_CF_MAX_WARPS 12

__device__ __forceinline__ int cf_row_slot(const int* __restrict__ hist_leaf,
                                           const int* __restrict__ inv,
                                           int L, long long r) {
  const int hl = hist_leaf[r];
  return inv[hl >= 0 ? hl : L];
}

__global__ void cf_count_kernel(const int* __restrict__ hist_leaf,
                                long long n_pad, int L,
                                const int* __restrict__ inv, int A,
                                int chunk, int* __restrict__ counts) {
  extern __shared__ int cnt[];   // [A]
  const int k = blockIdx.x;
  for (int s = threadIdx.x; s < A; s += blockDim.x) cnt[s] = 0;
  __syncthreads();
  const long long r0 = (long long)k * chunk;
  const int len = (int)min((long long)chunk, n_pad - r0);
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int s = cf_row_slot(hist_leaf, inv, L, r0 + i);
    if (s >= 0) atomicAdd(&cnt[s], 1);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < A; s += blockDim.x)
    counts[(long long)s * gridDim.x + k] = cnt[s];
}

// offs[s, k]: the first sorted position of slot s's rows of chunk k, the
// exclusive prefix of counts [A, K] in its own (slot-major) order: slot
// s's rows before slot s + 1's, each slot's in chunk order.  One block:
// each thread sums a segment, a Hillis-Steele scan of the segment sums in
// shared memory, then each thread writes its segment.
__global__ void __launch_bounds__(LGBM_CF_SCAN_THREADS)
cf_scan_kernel(const int* __restrict__ counts, long long N,
               int* __restrict__ offs) {
  __shared__ int part[LGBM_CF_SCAN_THREADS];
  const int t = threadIdx.x;
  const long long seg = (N + blockDim.x - 1) / blockDim.x;
  const long long i0 = min(N, t * seg);
  const long long i1 = min(N, i0 + seg);
  int sum = 0;
  for (long long i = i0; i < i1; ++i) sum += counts[i];
  part[t] = sum;
  __syncthreads();
  for (int d = 1; d < (int)blockDim.x; d <<= 1) {
    const int v = t >= d ? part[t - d] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  int run = part[t] - sum;
  for (long long i = i0; i < i1; ++i) {
    const int c = counts[i];
    offs[i] = run;
    run += c;
  }
}

// One block per chunk: a stable counting sort of the chunk's rows by slot
// in shared memory (per-warp counts over contiguous row segments,
// __match_any_sync ranks within 32 rows, as the float K5 sorts a chunk),
// then every active row's bins (row-major, 4 columns a word) and values
// rounded to bf16 (__float2bfloat16_rn) written at its sorted position.
__global__ void __launch_bounds__(LGBM_CF_FILL_THREADS)
cf_fill_kernel(const uint8_t* __restrict__ bins_t, long long n_pad, int G,
               int Gw, const float* __restrict__ vals, int C,
               const int* __restrict__ hist_leaf, int L,
               const int* __restrict__ inv, int A, int chunk,
               const int* __restrict__ offs, uint32_t* __restrict__ sbins,
               uint16_t* __restrict__ svals) {
  extern __shared__ int fsh[];
  const int W = blockDim.x / LGBM_CF_LANES;
  const int NT = blockDim.x;
  const int tid = threadIdx.x;
  const int w = tid / LGBM_CF_LANES;
  const int lane = tid % LGBM_CF_LANES;
  const unsigned full = 0xffffffffu;
  int* wcnt = fsh;            // [W][A] counts, then each warp's positions
  int* pos = fsh + W * A;     // [chunk] slot of a row, then its position
  const int k = blockIdx.x;
  const long long r0 = (long long)k * chunk;
  const int len = (int)min((long long)chunk, n_pad - r0);
  for (int i = tid; i < W * A; i += NT) wcnt[i] = 0;
  for (int i = tid; i < len; i += NT)
    pos[i] = cf_row_slot(hist_leaf, inv, L, r0 + i);
  __syncthreads();
  // rows [seg0, seg1) belong to warp w; their rounds of 32 run in order
  const int seg = ((len + W - 1) / W + 31) & ~31;
  const int seg0 = min(len, w * seg);
  const int seg1 = min(len, seg0 + seg);
  for (int b = seg0; b < seg1; b += LGBM_CF_LANES) {
    const int i = b + lane;
    const int s = i < seg1 ? pos[i] : -1;
    const unsigned peers = __match_any_sync(full, s);
    if (s >= 0 && lane == __ffs(peers) - 1) wcnt[w * A + s] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int s = tid; s < A; s += NT) {
    int run = offs[(long long)s * gridDim.x + k];
    for (int v = 0; v < W; ++v) {
      const int t = wcnt[v * A + s];
      wcnt[v * A + s] = run;
      run += t;
    }
  }
  __syncthreads();
  for (int b = seg0; b < seg1; b += LGBM_CF_LANES) {
    const int i = b + lane;
    const int s = i < seg1 ? pos[i] : -1;
    const unsigned peers = __match_any_sync(full, s);
    const int p =
        s >= 0 ? wcnt[w * A + s] + __popc(peers & ((1u << lane) - 1u)) : -1;
    __syncwarp();
    if (s >= 0 && lane == __ffs(peers) - 1) wcnt[w * A + s] += __popc(peers);
    if (i < seg1) pos[i] = p;
    __syncwarp();
  }
  __syncthreads();
  for (int i = tid; i < len; i += NT) {
    const int p = pos[i];
    if (p < 0) continue;
    const long long r = r0 + i;
    for (int q = 0; q < Gw; ++q) {
      uint32_t word = 0;
      for (int t = 0; t < 4; ++t) {
        const int g = 4 * q + t;
        if (g < G) word |= (uint32_t)bins_t[(long long)g * n_pad + r] << (8 * t);
      }
      sbins[(long long)p * Gw + q] = word;
    }
    for (int c = 0; c < C; ++c)
      svals[(long long)c * n_pad + p] = __bfloat16_as_ushort(
          __float2bfloat16_rn(vals[(long long)c * n_pad + r]));
  }
}

__device__ __forceinline__ float cf_bf16_to_float(uint32_t u) {
  return __uint_as_float(u << 16);
}

// acc[s, g, b, c] for the 32 columns of group blockIdx.x, value row
// blockIdx.y, output slot blockIdx.z.  Shared memory: the totals [B][32],
// one [B][32] chunk-partial tile per warp, and a flag per warp (its chunk
// has rows of the slot).
__global__ void __launch_bounds__(LGBM_CF_MAX_WARPS * LGBM_CF_LANES)
cf_walk_kernel(const int* __restrict__ counts, const int* __restrict__ offs,
               const uint8_t* __restrict__ sbins, int Gp,
               const uint16_t* __restrict__ svals, long long n_pad, int G,
               int C, int A, int B, int K, const int* __restrict__ src,
               float* __restrict__ acc) {
  extern __shared__ float cf_sh[];
  const int W = blockDim.x / LGBM_CF_LANES;
  const int NT = blockDim.x;
  const int tid = threadIdx.x;
  const int w = tid / LGBM_CF_LANES;
  const int lane = tid % LGBM_CF_LANES;
  const int cg = blockIdx.x, c = blockIdx.y, s = blockIdx.z;
  const int ss = src[s];
  if (ss < 0) return;                        // the whole block
  const int nbl = B * LGBM_CF_LANES;
  float* tot = cf_sh;                        // [B][32]
  float* tiles = cf_sh + nbl;                // [W][B][32]
  int* has = (int*)(tiles + (long long)W * nbl);   // [W]
  float* cell = tiles + (long long)w * nbl + lane; // bin b at cell[b * 32]
  const int g0 = cg * LGBM_CF_LANES;
  const int ng = min(LGBM_CF_LANES, G - g0);
  // the carry plus +0.0, as the float K5's first fold add leaves it
  // (cell i of the totals is bin i / 32 of column i % 32)
  for (int i = tid; i < nbl; i += NT) {
    const int l = i % LGBM_CF_LANES;
    tot[i] = l < ng ? __fadd_rn(acc[(((long long)s * G + g0 + l) * B +
                                     i / LGBM_CF_LANES) * C + c], 0.f)
                    : 0.f;
  }
  const int* cnt_s = counts + (long long)ss * K;
  const int* off_s = offs + (long long)ss * K;
  const uint16_t* vrow = svals + (long long)c * n_pad;
  const uint8_t* bcol = sbins + g0 + min(lane, ng - 1);
  for (int k0 = 0; k0 < K; k0 += W) {
    // warp w sums chunk k0 + w of the slot's rows, in row order from +0.0
    const int k = k0 + w;
    const int n = k < K ? cnt_s[k] : 0;
    const int j1 = k < K ? off_s[k] : 0;
    if (lane == 0) has[w] = n > 0;
    if (n > 0)   // the lane's own column: no other lane reads it here
      for (int b = 0; b < B; ++b) cell[b * LGBM_CF_LANES] = 0.f;
    for (int u0 = 0; u0 < n; u0 += LGBM_CF_BATCH) {
      const int m = min(LGBM_CF_BATCH, n - u0);
      int bb[LGBM_CF_BATCH];
      float vv[LGBM_CF_BATCH];
#pragma unroll
      for (int u = 0; u < LGBM_CF_BATCH; ++u) {
        const long long j = j1 + u0 + (u < m ? u : 0);
        bb[u] = bcol[j * Gp];
        vv[u] = cf_bf16_to_float(vrow[j]);
      }
      // 4 rows at a time: the 4 cells are loaded together and a row whose
      // bin repeats an earlier one of the 4 takes that row's new sum, so
      // the adds of each cell stay in row order
#pragma unroll
      for (int q = 0; q < LGBM_CF_BATCH; q += 4) {
        if (q + 4 <= m) {
          const int b0 = bb[q], b1 = bb[q + 1], b2 = bb[q + 2];
          const int b3 = bb[q + 3];
          const float x0 = cell[b0 * LGBM_CF_LANES];
          const float x1 = cell[b1 * LGBM_CF_LANES];
          const float x2 = cell[b2 * LGBM_CF_LANES];
          const float x3 = cell[b3 * LGBM_CF_LANES];
          const float s0 = __fadd_rn(x0, vv[q]);
          const float s1 = __fadd_rn(b1 == b0 ? s0 : x1, vv[q + 1]);
          const float s2 =
              __fadd_rn(b2 == b1 ? s1 : b2 == b0 ? s0 : x2, vv[q + 2]);
          const float s3 = __fadd_rn(
              b3 == b2 ? s2 : b3 == b1 ? s1 : b3 == b0 ? s0 : x3, vv[q + 3]);
          cell[b0 * LGBM_CF_LANES] = s0;
          cell[b1 * LGBM_CF_LANES] = s1;
          cell[b2 * LGBM_CF_LANES] = s2;
          cell[b3 * LGBM_CF_LANES] = s3;
        } else {
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (q + r < m)
              cell[bb[q + r] * LGBM_CF_LANES] =
                  __fadd_rn(cell[bb[q + r] * LGBM_CF_LANES], vv[q + r]);
        }
      }
    }
    __syncthreads();
    // fold this round's chunk partials into the totals, in chunk order; a
    // chunk without rows of the slot adds +0.0 there: no bit changes
    for (int i = tid; i < nbl; i += NT) {
      float t = tot[i];
      for (int u = 0; u < W; ++u)
        if (has[u]) t = __fadd_rn(t, tiles[(long long)u * nbl + i]);
      tot[i] = t;
    }
    __syncthreads();
  }
  for (int i = tid; i < nbl; i += NT) {
    const int l = i % LGBM_CF_LANES;
    if (l < ng)
      acc[(((long long)s * G + g0 + l) * B + i / LGBM_CF_LANES) * C + c] =
          tot[i];
  }
}

// The sort (steps 1-3 above) of a call.
static int cf_sort(const void* bins_t, long long n_pad, int G,
                   const void* vals, int C, const void* hist_leaf, int L,
                   const void* inv, int A, int chunk, int K, void* counts,
                   void* offs, void* sbins, void* svals, cudaStream_t st) {
  cf_count_kernel<<<K, LGBM_CF_COUNT_THREADS, A * sizeof(int), st>>>(
      (const int*)hist_leaf, n_pad, L, (const int*)inv, A, chunk,
      (int*)counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cf_scan_kernel<<<1, LGBM_CF_SCAN_THREADS, 0, st>>>(
      (const int*)counts, (long long)A * K, (int*)offs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int fill_smem =
      ((LGBM_CF_FILL_THREADS / LGBM_CF_LANES) * A + chunk) * (int)sizeof(int);
  err = cudaFuncSetAttribute(cf_fill_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             fill_smem);
  if (err != cudaSuccess) return (int)err;
  cf_fill_kernel<<<K, LGBM_CF_FILL_THREADS, fill_smem, st>>>(
      (const uint8_t*)bins_t, n_pad, G, (G + 3) / 4, (const float*)vals, C,
      (const int*)hist_leaf, L, (const int*)inv, A, chunk, (const int*)offs,
      (uint32_t*)sbins, (uint16_t*)svals);
  return (int)cudaGetLastError();
}

// phase 0: the whole call; 1: the sort only; 2: the walk only (of the
// sort a phase-1 call left in the scratch), for timing the two apart.
extern "C" int lgbm_hist_compact_float(
    const void* bins_t, long long n_pad, int G, const void* vals, int C,
    const void* hist_leaf, int L, const void* inv, const void* src, int A,
    int B, int chunk, int walk_warps, int phase, void* counts, void* offs,
    void* sbins, void* svals, void* acc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int K = (int)((n_pad + chunk - 1) / chunk);
  if (phase != 2) {
    const int err = cf_sort(bins_t, n_pad, G, vals, C, hist_leaf, L, inv, A,
                            chunk, K, counts, offs, sbins, svals, st);
    if (err != 0 || phase == 1) return err;
  }
  const int walk_smem =
      ((walk_warps + 1) * B * LGBM_CF_LANES + walk_warps) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      cf_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, walk_smem);
  if (err != cudaSuccess) return (int)err;
  cf_walk_kernel<<<dim3((G + LGBM_CF_LANES - 1) / LGBM_CF_LANES, C, A),
                   walk_warps * LGBM_CF_LANES, walk_smem, st>>>(
      (const int*)counts, (const int*)offs, (const uint8_t*)sbins,
      4 * ((G + 3) / 4), (const uint16_t*)svals, n_pad, G, C, A, B, K,
      (const int*)src, (float*)acc);
  return (int)cudaGetLastError();
}
