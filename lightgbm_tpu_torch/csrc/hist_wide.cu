// Exact-f32 histogram of the active leaves over uint8 or int32 bins, for
// wide bins (groups of more than 256 bins) and deep trees (more than
// 1,024 leaves).
//
// Replaces the XLA scatter-add that the JAX package takes past its
// Pallas kernels' domain (`hist_active_scatter`,
// lightgbm_tpu/ops/pallas_histogram.py:588, called from
// lightgbm_tpu/learner/serial.py:427-432): every row in an active leaf
// adds (grad, hess, 1) to the cell (slot, column, bin) of each stored
// column.  It has no Pallas counterpart.
//
// Order.  XLA's CPU scatter adds the updates one after another in row
// order, so each cell is the row-order sum of its rows, from +0.0.  This
// kernel keeps exactly that order, without float atomics: the rows of
// each active slot are first listed in ascending row order (a stable
// counting sort: per-chunk slot counts, their scan, a stable fill), then
// one warp owns one (slot, column) pair and walks its slot's rows 32 at a
// time, loading WIDE_AHEAD batches ahead.  Within a batch the lanes whose
// rows share a bin are found with __match_any_sync; the lowest of them
// adds their values into the shared-memory cell in lane (= row) order.  Distinct bins are distinct
// cells, so the warp's leaders never touch the same cell.  The result is
// bitwise the plain version (ops/histogram.py `hist_wide_plain`, a
// sequential index_add_ on the CPU) and the JAX package's scatter.
//
// What bounds it: the bytes are G bins + 8 B of values per active row
// and column; the walk is serial per (slot, column), so a wave with one
// big slot (the root) runs G warps over every row: memory latency, not
// bandwidth, bounds it there, which the loads ahead cut (the first
// design, one batch at a time, took 27.7 ms for the root wave of 1M rows
// at 1,024 bins on an H100).  A simple kernel that is right first.
#include <cuda_runtime.h>
#include <stdint.h>

// slot of a row: inv[hist_leaf] for a leaf in [0, L), else -1
__device__ __forceinline__ int row_slot(const int* __restrict__ hist_leaf,
                                        const int* __restrict__ inv,
                                        long long row, int L) {
  int hl = hist_leaf[row];
  return (hl >= 0 && hl < L) ? inv[hl] : -1;
}

// counts[chunk * A + s]: rows of chunk `chunk` in slot s (int atomics in
// shared memory: exact in any order)
__global__ void wide_count(const int* __restrict__ hist_leaf, long long n,
                           const int* __restrict__ inv, int L, int A,
                           int chunk, int* __restrict__ counts) {
  extern __shared__ int sh_cnt[];
  for (int s = threadIdx.x; s < A; s += blockDim.x) sh_cnt[s] = 0;
  __syncthreads();
  long long r0 = (long long)blockIdx.x * chunk;
  long long r1 = min(r0 + chunk, n);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    int s = row_slot(hist_leaf, inv, r, L);
    if (s >= 0) atomicAdd(&sh_cnt[s], 1);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < A; s += blockDim.x)
    counts[(long long)blockIdx.x * A + s] = sh_cnt[s];
}

// One block: thread t turns the per-chunk counts of slots t, t + 1024,
// ... into the write offsets of each chunk (in place), after the rows of
// every lower slot; start[s] / start[s + 1] bound slot s's rows.
__global__ void wide_scan(int* __restrict__ counts, int nchunks, int A,
                          int* __restrict__ start) {
  for (int s = threadIdx.x; s < A; s += blockDim.x) {
    int run = 0;
    for (int c = 0; c < nchunks; ++c) {
      int v = counts[(long long)c * A + s];
      counts[(long long)c * A + s] = run;
      run += v;
    }
    start[s] = run;                  // the slot's total, for now
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int i = 0; i < A; ++i) {
      int v = start[i];
      start[i] = acc;
      acc += v;
    }
    start[A] = acc;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < A; s += blockDim.x) {
    int base = start[s];
    for (int c = 0; c < nchunks; ++c) counts[(long long)c * A + s] += base;
  }
}

// Stable fill: one warp per chunk lists each row at its slot's cursor,
// 32 rows at a time in row order.  Launched with exactly 32 threads: the
// lanes are the rows of a batch and the cursors are ordered by the warp
// alone.
__global__ void wide_fill(const int* __restrict__ hist_leaf, long long n,
                          const int* __restrict__ inv, int L, int A,
                          int chunk, const int* __restrict__ offsets,
                          int* __restrict__ order) {
  extern __shared__ int cursor[];
  int lane = threadIdx.x;
  for (int s = lane; s < A; s += 32)
    cursor[s] = offsets[(long long)blockIdx.x * A + s];
  __syncwarp();
  long long r0 = (long long)blockIdx.x * chunk;
  long long r1 = min(r0 + chunk, n);
  unsigned lt = (1u << lane) - 1u;
  for (long long b = r0; b < r1; b += 32) {
    long long r = b + lane;
    int s = r < r1 ? row_slot(hist_leaf, inv, r, L) : -1;
    // lanes without a slot take a key no other lane has
    int key = s >= 0 ? s : -1 - lane;
    unsigned peers = __match_any_sync(0xffffffffu, key);
    int base = s >= 0 ? cursor[s] : 0;
    __syncwarp();
    if (s >= 0) {
      order[base + __popc(peers & lt)] = (int)r;
      if ((peers & lt) == 0) cursor[s] = base + __popc(peers);
    }
    __syncwarp();
  }
}

// rows a lane loads ahead: WIDE_AHEAD batches of 32 rows are fetched with
// independent loads before the first of them is summed, so a warp waits
// on memory once per WIDE_AHEAD batches (the root wave's warps walk
// every row of the tree)
#define WIDE_AHEAD 8

// One warp per (slot, column): the slot's rows in row order, each bin's
// cell summed in that order in shared memory, then written out.
template <typename BinT>
__global__ void wide_hist(const BinT* __restrict__ bins_t, long long n_pad,
                          int G, const float* __restrict__ grad,
                          const float* __restrict__ hess,
                          const int* __restrict__ order,
                          const int* __restrict__ start, int A, int B,
                          float* __restrict__ out) {
  extern __shared__ float sh[];
  const int warps = blockDim.x / 32;
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  long long pair = (long long)blockIdx.x * warps + w;
  if (pair >= (long long)A * G) return;       // whole warps only
  const int s = (int)(pair / G);
  const int g = (int)(pair % G);
  float* cell = sh + (size_t)w * (3 * B + 64);
  float* vg = cell + 3 * B;                   // per-lane staging
  float* vh = vg + 32;
  for (int i = lane; i < 3 * B; i += 32) cell[i] = 0.0f;
  __syncwarp();
  const BinT* col = bins_t + (long long)g * n_pad;
  const int r0 = start[s], r1 = start[s + 1];
  const unsigned lt = (1u << lane) - 1u;
  for (int b0 = r0; b0 < r1; b0 += 32 * WIDE_AHEAD) {
    int row[WIDE_AHEAD], bin[WIDE_AHEAD];
    float gv[WIDE_AHEAD], hv[WIDE_AHEAD];
#pragma unroll
    for (int u = 0; u < WIDE_AHEAD; ++u) {
      int i = b0 + 32 * u + lane;
      row[u] = i < r1 ? order[i] : -1;
    }
#pragma unroll
    for (int u = 0; u < WIDE_AHEAD; ++u) {
      bin[u] = -1 - lane;       // no other lane holds this key
      gv[u] = 0.0f;
      hv[u] = 0.0f;
      if (row[u] >= 0) {
        bin[u] = (int)col[row[u]];
        gv[u] = grad[row[u]];
        hv[u] = hess[row[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < WIDE_AHEAD; ++u) {
      vg[lane] = gv[u];
      vh[lane] = hv[u];
      unsigned peers = __match_any_sync(0xffffffffu, bin[u]);
      __syncwarp();
      if (row[u] >= 0 && (peers & lt) == 0) {
        float* c = cell + 3 * bin[u];
        float ag = c[0], ah = c[1], ac = c[2];
        unsigned m = peers;
        while (m) {
          int q = __ffs(m) - 1;
          m &= m - 1u;
          ag = __fadd_rn(ag, vg[q]);
          ah = __fadd_rn(ah, vh[q]);
          ac = __fadd_rn(ac, 1.0f);
        }
        c[0] = ag;
        c[1] = ah;
        c[2] = ac;
      }
      __syncwarp();
    }
  }
  float* dst = out + pair * (long long)(3 * B);
  for (int i = lane; i < 3 * B; i += 32) dst[i] = cell[i];
}

static int wide_hist_smem(int warps, int B) {
  return warps * (3 * B + 64) * (int)sizeof(float);
}

// The whole wave: count, scan, fill, walk.  `counts` is [nchunks, A]
// int32 scratch, `start` [A + 1], `order` [n] int32; `out` [A, G, B, 3]
// f32 (every cell written).
extern "C" int lgbm_hist_wide(const void* bins_t, int bins_int32,
                              long long n_pad, long long n, int G,
                              const void* grad, const void* hess,
                              const void* hist_leaf, const void* inv, int L,
                              int A, int B, int chunk, void* counts,
                              void* start, void* order, int warps,
                              void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int nchunks = (int)((n + chunk - 1) / chunk);
  int slot_smem = A * (int)sizeof(int);     // per-slot counts / cursors
  if (slot_smem > 48 * 1024) {
    cudaFuncSetAttribute(wide_count,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         slot_smem);
    cudaFuncSetAttribute(wide_fill,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         slot_smem);
  }
  if (nchunks > 0) {
    wide_count<<<nchunks, 256, slot_smem, st>>>(
        (const int*)hist_leaf, n, (const int*)inv, L, A, chunk,
        (int*)counts);
  }
  wide_scan<<<1, 1024, 0, st>>>((int*)counts, nchunks, A, (int*)start);
  if (nchunks > 0) {
    wide_fill<<<nchunks, 32, slot_smem, st>>>(
        (const int*)hist_leaf, n, (const int*)inv, L, A, chunk,
        (const int*)counts, (int*)order);
  }
  long long pairs = (long long)A * G;
  int grid = (int)((pairs + warps - 1) / warps);
  int smem = wide_hist_smem(warps, B);
  if (bins_int32) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(wide_hist<int32_t>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    wide_hist<int32_t><<<grid, 32 * warps, smem, st>>>(
        (const int32_t*)bins_t, n_pad, G, (const float*)grad,
        (const float*)hess, (const int*)order, (const int*)start, A, B,
        (float*)out);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(wide_hist<uint8_t>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    wide_hist<uint8_t><<<grid, 32 * warps, smem, st>>>(
        (const uint8_t*)bins_t, n_pad, G, (const float*)grad,
        (const float*)hess, (const int*)order, (const int*)start, A, B,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
