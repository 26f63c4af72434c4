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
// kernel keeps exactly that order without float atomics.  A float sum in
// row order cannot be split across rows, so the parallelism comes from
// the cells: every (slot, column, bin) cell is an independent chain.
//
// Design:
//  1. A stable LSD radix sort of the active rows by slot, in passes of
//     at most 8 bits (two up to 65,536 slots; count per chunk in shared
//     memory, one block scans the (digit, chunk) counts, one warp per
//     chunk fills in row order, equal digits found by one ballot a bit),
//     then each slot's bounds by a binary search.  The counts live in
//     global memory per digit, not per slot, so any number of slots
//     sorts (num_leaves 131,072 gives 65,536 slots a wave).
//  2. A staging pass gathers, in that slot order, each row's bins as
//     uint16 (int32 past a 65,536-bin stride; one array a column) and its
//     (grad, hess) pair, so that the walk reads contiguous memory and can
//     load a round ahead.
//  3. A plan: a slot of at most WARP_MAX_ROWS rows at a bin stride of at
//     most WARP_MAX_BINS gets G warp items (slot, column); one past a
//     round of WALK_TILE rows at a stride of at most BLOCK_MAX_BINS has
//     its rounds sorted apart (G x rounds tasks) and summed in order
//     (G x GATHER_SPLIT gather items), so that the root wave (one slot,
//     every row) spreads over the card; any other gets G x K block items
//     (slot, column, range of R = B / K <= BLOCK_MAX_BINS bins: no cap
//     on the stride).
//  4. The walk, one launch of persistent blocks that take the tasks,
//     block items from an integer counter, then, warp by warp, warp
//     items from another; then the gather.  An item walks its slot's
//     rows in row order in rounds;
//     the rows whose bin falls in its range are sorted by bin in shared
//     memory, stably (per-warp counts of each bin, a scan in (bin, warp)
//     order, each lane's rank among the lanes of its bin, found by one
//     ballot a bit of the bin: __match_any_sync's throughput is far
//     lower), and one thread per bin adds its bin's values in that
//     order into the cell's running sum.  The count is an integer (a
//     row-order float sum of ones is min(count, 2^24), which it writes).
//  5. Slots without rows (id -1 included) are zeroed by a float4 pass at
//     bandwidth; an item writes all 3R floats of its range once.
//
// What bounds it: the bytes are each active row's bins and two values,
// the hist leaves, and the [A, G, B, 3] histogram written once.  A cell's
// chain is serial (one add after another), so a bin holding most of a
// big slot's rows is bound by the add latency of that chain; otherwise
// the walk is bound by the latency of its rounds (gathers, the shared-
// memory sort and its barriers), which loading a round ahead and many
// items in flight hide.
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define SCAN_THREADS 1024   // the one-block scans
#define COUNT_THREADS 256   // per-chunk digit counts
#define FILL_AHEAD 8        // 32-entry batches a fill warp loads ahead
#define WALK_THREADS 512    // one block of the walk
#define WALK_WARPS (WALK_THREADS / 32)
#define WALK_AHEAD 8        // 32-row batches each warp holds per round
#define WALK_TILE (WALK_THREADS * WALK_AHEAD)
#define BLOCK_MAX_BINS 1024 // bins of one block item
#define SORT_CHUNK 2048     // rows per chunk of the slot sort, at least
#define SORT_MAX_CHUNKS 1024
#define WARP_MAX_BINS 256   // bin strides a warp item covers whole
#define WARP_MAX_ROWS 4096  // rows of a slot that takes warp items
#define WARP_TILE (32 * WALK_AHEAD)

// slot of a row: inv[hist_leaf] for a leaf in [0, L), else -1
__device__ __forceinline__ int row_slot(const int* __restrict__ hist_leaf,
                                        const int* __restrict__ inv,
                                        long long row, int L) {
  int hl = hist_leaf[row];
  return (hl >= 0 && hl < L) ? inv[hl] : -1;
}

// Inclusive sum of `v` over the threads of the block (all threads call;
// `wsum` holds 32 values).
template <typename T>
__device__ __forceinline__ T block_incl_scan(T v, T* wsum) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T t = __shfl_up_sync(FULL_MASK, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) wsum[w] = v;
  __syncthreads();
  if (w == 0) {
    T t = lane < nw ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T u = __shfl_up_sync(FULL_MASK, t, o);
      if (lane >= o) t += u;
    }
    wsum[lane] = t;
  }
  __syncthreads();
  if (w > 0) v += wsum[w - 1];
  __syncthreads();
  return v;
}

// Inclusive sum of `v` over the lanes of a warp.
__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(FULL_MASK, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// The lanes whose `key` equals this lane's, for keys of at most `bits`
// bits (-1: no key; such lanes match no keyed lane), from one ballot a
// bit: what __match_any_sync gives, at the throughput of ballots.
__device__ __forceinline__ unsigned match_key(int key, int bits) {
  const bool has = key >= 0;
  const unsigned any = __ballot_sync(FULL_MASK, has);
  unsigned m = has ? any : ~any;
  for (int b = 0; b < bits; ++b) {
    const bool on = (key >> b) & 1;
    const unsigned v = __ballot_sync(FULL_MASK, on);
    m &= on ? v : ~v;
  }
  return m;
}

// ---- 1. the stable sort of the active rows by slot ----

// Entries of a pass: the first reads rows [0, n) (their slots from the
// hist leaves, written to keys0 for its fill), the second the first's
// output list, *n_in entries long.
__device__ __forceinline__ long long pass_len(long long n,
                                              const int* __restrict__ n_in) {
  return n_in != nullptr ? (long long)*n_in : n;
}

// counts[d * nchunks + chunk]: entries of chunk `chunk` whose digit is
// d (integer atomics in shared memory: exact in any order).
__global__ void ws_count(const int* __restrict__ hist_leaf,
                         const int* __restrict__ inv, int L, long long n,
                         const int* __restrict__ keys_in,
                         const int* __restrict__ n_in, int* __restrict__ keys0,
                         int chunk, int shift, int nb,
                         int* __restrict__ counts) {
  extern __shared__ int sh_cnt[];
  for (int d = threadIdx.x; d < nb; d += blockDim.x) sh_cnt[d] = 0;
  __syncthreads();
  const long long len = pass_len(n, n_in);
  const long long r0 = (long long)blockIdx.x * chunk;
  const long long r1 = min(r0 + chunk, len);
  for (long long i = r0 + threadIdx.x; i < r1; i += blockDim.x) {
    int s;
    if (keys_in != nullptr) {
      s = keys_in[i];
    } else {
      s = row_slot(hist_leaf, inv, i, L);
      keys0[i] = s;
    }
    if (s >= 0) atomicAdd(&sh_cnt[(s >> shift) & (nb - 1)], 1);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < nb; d += blockDim.x)
    counts[(long long)d * gridDim.x + blockIdx.x] = sh_cnt[d];
}

// One block: the counts, in (digit, chunk) order as they lie, become each
// chunk's first write position of each digit (in place); *total gets the
// number of entries with a slot.  Tiles of SCAN_PER counts a thread go
// through shared memory, so that every global access is coalesced.
#define SCAN_PER 8
__global__ void ws_scan(int* __restrict__ counts, int M,
                        int* __restrict__ total) {
  __shared__ int tile[SCAN_THREADS * SCAN_PER];
  __shared__ int wsum[32];
  const int tid = threadIdx.x;
  int carry = 0;
  for (int base = 0; base < M; base += SCAN_THREADS * SCAN_PER) {
#pragma unroll
    for (int k = 0; k < SCAN_PER; ++k) {
      const int e = base + k * SCAN_THREADS + tid;
      tile[k * SCAN_THREADS + tid] = e < M ? counts[e] : 0;
    }
    __syncthreads();
    int v[SCAN_PER], sum = 0;
#pragma unroll
    for (int k = 0; k < SCAN_PER; ++k) {
      v[k] = tile[tid * SCAN_PER + k];
      sum += v[k];
    }
    const int incl = block_incl_scan(sum, wsum);
    int run = carry + incl - sum;
#pragma unroll
    for (int k = 0; k < SCAN_PER; ++k) {
      tile[tid * SCAN_PER + k] = run;
      run += v[k];
    }
    carry += wsum[SCAN_THREADS / 32 - 1];   // the tile's total
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SCAN_PER; ++k) {
      const int e = base + k * SCAN_THREADS + tid;
      if (e < M) counts[e] = tile[k * SCAN_THREADS + tid];
    }
    __syncthreads();
  }
  if (tid == 0) *total = carry;
}

// Stable fill: one warp per chunk writes each entry at its digit's
// cursor, FILL_AHEAD batches of 32 entries loaded ahead, every batch in
// lane (= entry) order (digits of `bits` bits).  Launched with exactly
// 32 threads.
__global__ void ws_fill(const int* __restrict__ keys0, long long n,
                        const int* __restrict__ rows_in,
                        const int* __restrict__ keys_in,
                        const int* __restrict__ n_in, int chunk, int shift,
                        int nb, int bits, const int* __restrict__ offsets,
                        int* __restrict__ rows_out,
                        int* __restrict__ keys_out) {
  extern __shared__ int cursor[];
  const int lane = threadIdx.x;
  for (int d = lane; d < nb; d += 32)
    cursor[d] = offsets[(long long)d * gridDim.x + blockIdx.x];
  __syncwarp();
  const long long len = pass_len(n, n_in);
  const long long r0 = (long long)blockIdx.x * chunk;
  const long long r1 = min(r0 + chunk, len);
  const unsigned lt = (1u << lane) - 1u;
  for (long long b0 = r0; b0 < r1; b0 += 32 * FILL_AHEAD) {
    int key[FILL_AHEAD], row[FILL_AHEAD];
#pragma unroll
    for (int u = 0; u < FILL_AHEAD; ++u) {
      long long i = b0 + 32 * u + lane;
      key[u] = -1;
      row[u] = 0;
      if (i < r1) {
        key[u] = keys_in != nullptr ? keys_in[i] : keys0[i];
        row[u] = rows_in != nullptr ? rows_in[i] : (int)i;
      }
    }
#pragma unroll
    for (int u = 0; u < FILL_AHEAD; ++u) {
      const int s = key[u];
      const int d = s >= 0 ? (s >> shift) & (nb - 1) : -1;
      const unsigned peers = match_key(d, bits);
      const int base = s >= 0 ? cursor[d] : 0;
      __syncwarp();
      if (s >= 0) {
        const int pos = base + __popc(peers & lt);
        rows_out[pos] = row[u];
        keys_out[pos] = s;
        if ((peers & lt) == 0) cursor[d] = base + __popc(peers);
      }
      __syncwarp();
    }
  }
}

// start[s] = the first entry of slot s in the sorted keys (s in [0, A]),
// one warp a slot: a 32-way search, one dependent load per 5 bits.
__global__ void ws_bounds(const int* __restrict__ keys,
                          const int* __restrict__ n_active, int A,
                          int* __restrict__ start) {
  const int s = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (s > A) return;                       // whole warps
  int lo = 0, hi = *n_active;              // the answer lies in [lo, hi]
  while (hi > lo) {
    const int step = (hi - lo + 31) / 32;
    const int q = lo + (lane + 1) * step - 1;
    const unsigned m = __ballot_sync(FULL_MASK, q < hi && keys[q] < s);
    const int c = __popc(m);               // a prefix of the lanes
    hi = min(hi, lo + (c + 1) * step - 1);
    lo += c * step;
  }
  start[s] = lo;
}

// ---- 2. staging in slot order ----

// sgh[i] = (grad, hess) of the i-th sorted row; sbin[g * n + i] its bin
// in column g (SBinT: uint16_t, or int past a 65,536-bin stride), STAGE_COLS columns a thread from STAGE_COLS * blockIdx.y
// (blocks of those columns run together, so int32 columns stay in L2
// while their rows are gathered).
#define STAGE_COLS 4
template <typename BinT, typename SBinT>
__global__ void ws_stage(const BinT* __restrict__ bins_t, long long n_pad,
                         int G, const float* __restrict__ grad,
                         const float* __restrict__ hess,
                         const int* __restrict__ order,
                         const int* __restrict__ n_active, long long n,
                         SBinT* __restrict__ sbin,
                         float2* __restrict__ sgh) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= *n_active) return;
  const int g0 = blockIdx.y * STAGE_COLS;
  const int row = order[i];
  int b[STAGE_COLS];
#pragma unroll
  for (int c = 0; c < STAGE_COLS; ++c)
    b[c] = g0 + c < G ? (int)bins_t[(g0 + c) * n_pad + row] : 0;
#pragma unroll
  for (int c = 0; c < STAGE_COLS; ++c)
    if (g0 + c < G) sbin[(g0 + c) * n + i] = (SBinT)b[c];
  if (g0 == 0) sgh[i] = make_float2(grad[row], hess[row]);
}

// ---- 3. the plan ----

// Item classes of the walk, each with its per-slot prefix in `items`
// [CLASSES][A + 1] and its counter in `next_item`: the rounds of a
// two-round-kind slot (G x its rounds: sorted apart, then summed by
// GATHER_SPLIT gather items a column, each over its part of the bins),
// block items, warp items, gather items.
#define TASK 0
#define BLOCK 1
#define WARP 2
#define GATHER 3
#define CLASSES 4
#define GATHER_SPLIT 4

// Rounds of WALK_TILE rows in `ns` rows.
__device__ __forceinline__ int rounds_of(long long ns) {
  return (int)((ns + WALK_TILE - 1) / WALK_TILE);
}

// One block: each slot's kind and items.  A slot of at most warp_rows
// rows (0 where the stride is past WARP_MAX_BINS) takes G warp items;
// past one round, at a stride of at most BLOCK_MAX_BINS (kbase 1), its
// rounds are sorted as G x rounds tasks and summed by G x GATHER_SPLIT
// gather items; else it takes G x kslot[s] = G x kbase block items
// (kslot 0 for the others).
__global__ void ws_plan(const int* __restrict__ start, int A, int G,
                        int kbase, int warp_rows, int* __restrict__ kslot,
                        long long* __restrict__ items,
                        unsigned long long* __restrict__ next_item) {
  __shared__ long long wsum[32];
  const int per = (A + blockDim.x - 1) / blockDim.x;
  const int s0 = min(A, (int)threadIdx.x * per);
  const int s1 = min(A, s0 + per);
  long long sum[CLASSES] = {0, 0, 0, 0};
  for (int s = s0; s < s1; ++s) {
    const long long ns = start[s + 1] - start[s];
    int k = 0;
    if (ns == 0) {
    } else if (ns <= warp_rows) {
      sum[WARP] += G;
    } else if (kbase == 1 && ns > WALK_TILE) {
      sum[TASK] += (long long)G * rounds_of(ns);
      sum[GATHER] += G * GATHER_SPLIT;
    } else {
      k = kbase;
      sum[BLOCK] += (long long)G * k;
    }
    kslot[s] = k;
  }
  for (int c = 0; c < CLASSES; ++c) {
    const long long incl = block_incl_scan(sum[c], wsum);
    long long run = incl - sum[c];
    long long* first = items + (long long)c * (A + 1);
    for (int s = s0; s < s1; ++s) {
      const long long ns = start[s + 1] - start[s];
      first[s] = run;
      const bool warp = ns > 0 && ns <= warp_rows;
      const bool two = !warp && kslot[s] == 0 && ns > 0;
      run += c == TASK ? (two ? (long long)G * rounds_of(ns) : 0)
           : c == BLOCK ? (long long)G * kslot[s]
           : c == WARP ? (warp ? G : 0)
                       : (two ? G * GATHER_SPLIT : 0);
    }
    if (threadIdx.x == blockDim.x - 1) {
      first[A] = incl;
      next_item[c] = 0ull;
    }
  }
}

// ---- 4. the walk ----

// The last slot s with first[s] <= it (it < first[A]), by one whole
// warp: a 32-way search, one dependent load per 5 bits of A.
__device__ __forceinline__ int find_slot(const long long* __restrict__ first,
                                         int A, long long it, int lane) {
  int lo = 0, hi = A;
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    const unsigned m = __ballot_sync(FULL_MASK, p < hi && first[p] <= it);
    const int nlo = lo + (31 - __clz(m)) * step;
    hi = min(hi, nlo + step);
    lo = nlo;
  }
  return lo;
}

// Shared memory of a walk block: per-warp bin counts, the running cells
// and the round's rows sorted by bin for block items of at most `rmax`
// bins; for warp items of `rw` bins (0: none) the same per warp.
static size_t block_smem(int rmax) {
  return (size_t)WALK_WARPS * rmax * sizeof(int)
       + (size_t)rmax * (2 * sizeof(float) + sizeof(int))
       + (size_t)WALK_TILE * 2 * sizeof(float);
}
__host__ __device__ __forceinline__ size_t warp_smem(int rw) {
  return (size_t)rw * (sizeof(int) + 2 * sizeof(float) + sizeof(int))
       + (size_t)WARP_TILE * 2 * sizeof(float);
}
static size_t walk_smem(int rmax, int rw) {
  const size_t b = block_smem(rmax);
  const size_t w = rw > 0 ? WALK_WARPS * warp_smem(rw) : 0;
  return b > w ? b : w;
}

// Write one item's cells: 3R floats from the running sums.
__device__ __forceinline__ void write_cells(float* __restrict__ dst,
                                            const float* acc_g,
                                            const float* acc_h,
                                            const int* acc_n, int R,
                                            int t, int nt) {
  for (int q = t; q < 3 * R; q += nt) {
    const int j = q / 3, c = q - 3 * j;
    dst[q] = c == 0 ? acc_g[j]
           : c == 1 ? acc_h[j]
                    : (float)min(acc_n[j], 1 << 24);
  }
}

// Sort one round of a block by bin, stably: each thread holds
// WALK_AHEAD rows (lbr: local bin, -1 for none; their values gv / hv),
// warp w the rows [w, w + 1) x WALK_AHEAD x 32 of the round in order.
// After it, cnt[j] (warp 0's row) is bin j's first position in srt_g /
// srt_h and *tile_total the rows sorted.  Every thread calls.
__device__ __forceinline__ void block_sort_round(
    int (&lbr)[WALK_AHEAD], const float (&gv)[WALK_AHEAD],
    const float (&hv)[WALK_AHEAD], int R, int rbits, int* cnt,
    float* srt_g, float* srt_h, int* wsum, int* tile_total) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int j = tid; j < WALK_WARPS * R; j += WALK_THREADS) cnt[j] = 0;
  __syncthreads();                         // counters zeroed
  int* wcnt = cnt + warp * R;
#pragma unroll
  for (int u = 0; u < WALK_AHEAD; ++u) {
    const int lb = lbr[u];
    if (__ballot_sync(FULL_MASK, lb >= 0) == 0u) continue;
    const unsigned peers = match_key(lb, rbits);
    const int c = lb >= 0 ? wcnt[lb] : 0;
    __syncwarp();
    if (lb >= 0) {
      lbr[u] = lb | ((c + __popc(peers & lt)) << 16);
      if ((peers & lt) == 0) wcnt[lb] = c + __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();                         // every warp counted
  // exclusive offsets in (bin, warp) order, in place: a thread sums the
  // warps' counts of its one or two bins
  const int bpt = (R + WALK_THREADS - 1) / WALK_THREADS;
  int sum = 0;
  for (int m = 0; m < bpt; ++m) {
    const int j = tid * bpt + m;
    if (j < R) {
#pragma unroll
      for (int w = 0; w < WALK_WARPS; ++w) sum += cnt[w * R + j];
    }
  }
  const int incl = block_incl_scan(sum, wsum);
  int run = incl - sum;
  for (int m = 0; m < bpt; ++m) {
    const int j = tid * bpt + m;
    if (j < R) {
#pragma unroll
      for (int w = 0; w < WALK_WARPS; ++w) {
        const int v = cnt[w * R + j];
        cnt[w * R + j] = run;
        run += v;
      }
    }
  }
  if (tid == WALK_THREADS - 1) *tile_total = incl;
  __syncthreads();
#pragma unroll
  for (int u = 0; u < WALK_AHEAD; ++u) {
    if (lbr[u] >= 0) {
      const int pos = wcnt[lbr[u] & 0xffff] + (lbr[u] >> 16);
      srt_g[pos] = gv[u];
      srt_h[pos] = hv[u];
    }
  }
  __syncthreads();
}

// The walk's first kernel: persistent blocks take, in turn, the rounds
// of the two-round-kind slots (sorted by bin, written out with each
// bin's first position), block items, then warp by warp warp items.
template <typename SBinT>
__global__ void __launch_bounds__(WALK_THREADS, 2)
wide_walk(const SBinT* __restrict__ sbin, long long n, int G,
          const float2* __restrict__ sgh, const int* __restrict__ start,
          const int* __restrict__ kslot, const long long* __restrict__ items,
          int A, int B, int rmax,
          unsigned long long* __restrict__ next_item,
          float2* __restrict__ srt_out, int* __restrict__ offs,
          float* __restrict__ out) {
  extern __shared__ int smem[];
  __shared__ int wsum[32];
  __shared__ unsigned long long item_sh;
  __shared__ int slot_sh, tile_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  int* cnt = smem;                                    // [WALK_WARPS][R]
  float* acc_g = (float*)(cnt + WALK_WARPS * rmax);   // [R]
  float* acc_h = acc_g + rmax;                        // [R]
  int* acc_n = (int*)(acc_h + rmax);                  // [R]
  float* srt_g = (float*)(acc_n + rmax);              // [WALK_TILE]
  float* srt_h = srt_g + WALK_TILE;                   // [WALK_TILE]

  // the rounds of the two-round-kind slots: every bin (B = rmax), task
  // by task round robin (they are alike); a slot's bounds are kept while
  // its tasks last
  {
    const long long* first = items + TASK * (A + 1);
    const long long total = first[A];
    const int R = B;
    const int rbits = 31 - __clz(R);
    long long lo_t = 0, hi_t = 0;          // the kept slot's tasks
    int r0 = 0, r1 = 0, rounds = 1;
    for (long long t = blockIdx.x; t < total; t += gridDim.x) {
      if (t >= hi_t) {                     // uniform: a new slot
        if (warp == 0) {
          const int s = find_slot(first, A, t, lane);
          if (lane == 0) slot_sh = s;
        }
        __syncthreads();
        const int s = slot_sh;
        lo_t = first[s];
        r0 = start[s];
        r1 = start[s + 1];
        rounds = rounds_of(r1 - r0);
        hi_t = lo_t + (long long)G * rounds;
      }
      const long long local = t - lo_t;
      const int g = (int)(local / rounds);
      const int rbase = r0 + (int)(local % rounds) * WALK_TILE;
      const int rend = min(r1, rbase + WALK_TILE);
      int lbr[WALK_AHEAD];
      float gv[WALK_AHEAD], hv[WALK_AHEAD];
#pragma unroll
      for (int u = 0; u < WALK_AHEAD; ++u) {
        const int i = rbase + (warp * WALK_AHEAD + u) * 32 + lane;
        lbr[u] = -1;
        gv[u] = 0.0f;
        hv[u] = 0.0f;
        if (i < rend) {
          lbr[u] = (int)sbin[g * n + i];
          const float2 v = sgh[i];
          gv[u] = v.x;
          hv[u] = v.y;
        }
      }
      block_sort_round(lbr, gv, hv, R, rbits, cnt, srt_g, srt_h, wsum,
                       &tile_total);
      int* o = offs + t * (R + 1);
      for (int j = tid; j <= R; j += WALK_THREADS)
        o[j] = j < R ? cnt[j] : tile_total;
      float2* dst = srt_out + g * n + rbase;
      for (int p = tid; p < rend - rbase; p += WALK_THREADS)
        dst[p] = make_float2(srt_g[p], srt_h[p]);
      __syncthreads();                     // before the next task
    }
  }

  // block items: (slot, column, bin range), rounds of WALK_TILE rows
  {
    const long long* first = items + BLOCK * (A + 1);
    const long long total = first[A];
    for (;;) {
      if (tid == 0) item_sh = atomicAdd(next_item + BLOCK, 1ull);
      __syncthreads();
      const long long it = (long long)item_sh;
      if (it >= total) break;
      if (warp == 0) {
        const int s = find_slot(first, A, it, lane);
        if (lane == 0) slot_sh = s;
      }
      __syncthreads();
      const int s = slot_sh;
      const int k = kslot[s];
      const long long local = it - first[s];
      const int g = (int)(local / k);
      const int R = B / k;
      const int rbits = 31 - __clz(R);     // R is a power of two
      const int b0 = (int)(local % k) * R;
      for (int j = tid; j < R; j += WALK_THREADS) {
        acc_g[j] = 0.0f;
        acc_h[j] = 0.0f;
        acc_n[j] = 0;
      }
      const SBinT* col = sbin + g * n;
      const int r0 = start[s], r1 = start[s + 1];
      // this round's bins, loaded a round ahead (-1: no row)
      int nb[WALK_AHEAD];
#pragma unroll
      for (int u = 0; u < WALK_AHEAD; ++u) {
        const int i = r0 + (warp * WALK_AHEAD + u) * 32 + lane;
        nb[u] = i < r1 ? (int)col[i] : -1;
      }
      for (int base = r0; base < r1; base += WALK_TILE) {
        int lbr[WALK_AHEAD];          // local bin | rank << 16, -1: out
        float gv[WALK_AHEAD], hv[WALK_AHEAD];
#pragma unroll
        for (int u = 0; u < WALK_AHEAD; ++u) {
          const int b = nb[u] - b0;
          lbr[u] = nb[u] >= 0 && (unsigned)b < (unsigned)R ? b : -1;
          gv[u] = 0.0f;
          hv[u] = 0.0f;
          if (lbr[u] >= 0) {
            const float2 v =
                sgh[base + (warp * WALK_AHEAD + u) * 32 + lane];
            gv[u] = v.x;
            hv[u] = v.y;
          }
        }
        const int next = base + WALK_TILE;
#pragma unroll
        for (int u = 0; u < WALK_AHEAD; ++u) {
          const int i = next + (warp * WALK_AHEAD + u) * 32 + lane;
          nb[u] = i < r1 ? (int)col[i] : -1;
        }
        block_sort_round(lbr, gv, hv, R, rbits, cnt, srt_g, srt_h, wsum,
                         &tile_total);
        // one thread per bin adds its rows in row order
        for (int j = tid; j < R; j += WALK_THREADS) {
          const int p0 = cnt[j];                        // (bin j, warp 0)
          const int p1 = j + 1 < R ? cnt[j + 1] : tile_total;
          float a = acc_g[j], h = acc_h[j];
          for (int p = p0; p < p1; ++p) {
            a = __fadd_rn(a, srt_g[p]);
            h = __fadd_rn(h, srt_h[p]);
          }
          acc_g[j] = a;
          acc_h[j] = h;
          acc_n[j] += p1 - p0;
        }
        __syncthreads();
      }
      write_cells(out + ((long long)s * G + g) * B * 3 + (long long)b0 * 3,
                  acc_g, acc_h, acc_n, R, tid, WALK_THREADS);
      __syncthreads();                     // before the next item's reset
    }
    __syncthreads();                       // item_sh read by every thread
  }

  // warp items: (slot, column) of a small slot, every bin (B <=
  // WARP_MAX_BINS), rounds of WARP_TILE rows; no block barrier from here
  {
    const long long* first = items + WARP * (A + 1);
    const long long total = first[A];
    const int R = B;
    const int rbits = 31 - __clz(R);
    int* wc = (int*)((char*)smem + warp * warp_smem(R));       // [R]
    float* wg = (float*)(wc + R);                              // [R]
    float* wh = wg + R;                                        // [R]
    int* wn = (int*)(wh + R);                                  // [R]
    float* sg = (float*)(wn + R);                              // [WARP_TILE]
    float* sh = sg + WARP_TILE;                                // [WARP_TILE]
    for (;;) {
      long long it = 0;
      if (lane == 0) it = (long long)atomicAdd(next_item + WARP, 1ull);
      it = __shfl_sync(FULL_MASK, it, 0);
      if (it >= total) break;
      const int s = find_slot(first, A, it, lane);
      const int g = (int)(it - first[s]);
      for (int j = lane; j < R; j += 32) {
        wg[j] = 0.0f;
        wh[j] = 0.0f;
        wn[j] = 0;
      }
      const SBinT* col = sbin + g * n;
      const int r0 = start[s], r1 = start[s + 1];
      const int bpl = (R + 31) / 32;     // bins a lane scans
      for (int base = r0; base < r1; base += WARP_TILE) {
        for (int j = lane; j < R; j += 32) wc[j] = 0;
        int lbr[WALK_AHEAD];
        float gv[WALK_AHEAD], hv[WALK_AHEAD];
#pragma unroll
        for (int u = 0; u < WALK_AHEAD; ++u) {
          const int i = base + u * 32 + lane;
          lbr[u] = i < r1 ? (int)col[i] : -1;
          gv[u] = 0.0f;
          hv[u] = 0.0f;
          if (i < r1) {
            const float2 v = sgh[i];
            gv[u] = v.x;
            hv[u] = v.y;
          }
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < WALK_AHEAD; ++u) {
          const int lb = lbr[u];
          if (__ballot_sync(FULL_MASK, lb >= 0) == 0u) continue;
          const unsigned peers = match_key(lb, rbits);
          const int c = lb >= 0 ? wc[lb] : 0;
          __syncwarp();
          if (lb >= 0) {
            lbr[u] = lb | ((c + __popc(peers & lt)) << 16);
            if ((peers & lt) == 0) wc[lb] = c + __popc(peers);
          }
          __syncwarp();
        }
        // exclusive offsets of the bins, in place
        int sum = 0;
        for (int m = 0; m < bpl; ++m) {
          const int j = lane * bpl + m;
          if (j < R) sum += wc[j];
        }
        const int incl = warp_incl_scan(sum, lane);
        const int ttotal = __shfl_sync(FULL_MASK, incl, 31);
        int run = incl - sum;
        for (int m = 0; m < bpl; ++m) {
          const int j = lane * bpl + m;
          if (j < R) {
            const int v = wc[j];
            wc[j] = run;
            run += v;
          }
        }
        __syncwarp();
#pragma unroll
        for (int u = 0; u < WALK_AHEAD; ++u) {
          if (lbr[u] >= 0) {
            const int pos = wc[lbr[u] & 0xffff] + (lbr[u] >> 16);
            sg[pos] = gv[u];
            sh[pos] = hv[u];
          }
        }
        __syncwarp();
        for (int j = lane; j < R; j += 32) {
          const int p0 = wc[j];
          const int p1 = j + 1 < R ? wc[j + 1] : ttotal;
          float a = wg[j], h = wh[j];
          for (int p = p0; p < p1; ++p) {
            a = __fadd_rn(a, sg[p]);
            h = __fadd_rn(h, sh[p]);
          }
          wg[j] = a;
          wh[j] = h;
          wn[j] += p1 - p0;
        }
        __syncwarp();
      }
      write_cells(out + ((long long)s * G + g) * B * 3, wg, wh, wn, R, lane,
                  32);
      __syncwarp();
    }
  }
}

// Asynchronous copies global -> shared of 8 or 4 bytes (cp.async), their
// commit and the wait for all but the newest `N` groups.
__device__ __forceinline__ void copy_async8(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  *(float2*)dst = *(const float2*)src;
#endif
}
__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  *(int*)dst = *(const int*)src;
#endif
}
__device__ __forceinline__ void copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}
template <int N>
__device__ __forceinline__ void copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// The walk's second kernel: one block per (slot, column, part of the
// bins) of a two-round-kind slot sums its rounds in order, each bin's
// sorted values from its first position on (thread t owns the part's
// bins t and t + WALK_THREADS).  The rounds stream through a ring of
// GATHER_RING buffers in shared memory, GATHER_RING - 1 rounds in flight
// while one is summed.
#define GATHER_BINS ((BLOCK_MAX_BINS + WALK_THREADS - 1) / WALK_THREADS)
#define GATHER_RING 4
static size_t gather_smem(int B) {
  return (size_t)GATHER_RING * (WALK_TILE * sizeof(float2)
                                + (B + 1) * sizeof(int));
}
__global__ void __launch_bounds__(WALK_THREADS)
wide_gather(const float2* __restrict__ srt_out, const int* __restrict__ offs,
            long long n, int G, const int* __restrict__ start,
            const long long* __restrict__ items, int A, int B,
            unsigned long long* __restrict__ next_item,
            float* __restrict__ out) {
  extern __shared__ int gsm[];
  float2* vals = (float2*)gsm;                        // [RING][WALK_TILE]
  int* first_pos = (int*)(vals + GATHER_RING * WALK_TILE);  // [RING][B+1]
  __shared__ unsigned long long item_sh;
  __shared__ int slot_sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long* tasks = items + TASK * (A + 1);
  const long long* first = items + GATHER * (A + 1);
  const long long total = first[A];
  const int R = B;
  for (;;) {
    if (tid == 0) item_sh = atomicAdd(next_item + GATHER, 1ull);
    __syncthreads();
    const long long it = (long long)item_sh;
    if (it >= total) break;
    if (warp == 0) {
      const int s = find_slot(first, A, it, lane);
      if (lane == 0) slot_sh = s;
    }
    __syncthreads();
    const int s = slot_sh;
    const int g = (int)((it - first[s]) / GATHER_SPLIT);
    const int part = R / GATHER_SPLIT;   // bins of this item, from j0
    const int j0 = (int)((it - first[s]) % GATHER_SPLIT) * part;
    const int r0 = start[s], r1 = start[s + 1];
    const int rounds = rounds_of(r1 - r0);
    const long long t0 = tasks[s] + (long long)g * rounds;
    // start the copies of round r into its ring buffer (one group a
    // round, empty past the last)
    auto fetch = [&](int r) {
      if (r < rounds) {
        const int rbase = r0 + r * WALK_TILE;
        const int len = min(r1, rbase + WALK_TILE) - rbase;
        const float2* src = srt_out + g * n + rbase;
        float2* v = vals + (r % GATHER_RING) * WALK_TILE;
        for (int p = tid; p < len; p += WALK_THREADS)
          copy_async8(v + p, src + p);
        const int* o = offs + (t0 + r) * (R + 1);
        int* f = first_pos + (r % GATHER_RING) * (R + 1);
        for (int j = tid; j <= R; j += WALK_THREADS) copy_async4(f + j, o + j);
      }
      copy_commit();
    };
    float a[GATHER_BINS], h[GATHER_BINS];
    int c[GATHER_BINS];
#pragma unroll
    for (int m = 0; m < GATHER_BINS; ++m) {
      a[m] = 0.0f;
      h[m] = 0.0f;
      c[m] = 0;
    }
    for (int r = 0; r < GATHER_RING - 1; ++r) fetch(r);
    for (int r = 0; r < rounds; ++r) {
      fetch(r + GATHER_RING - 1);
      copy_wait<GATHER_RING - 1>();        // this thread's round r landed
      __syncthreads();                     // every thread's
      const float2* v = vals + (r % GATHER_RING) * WALK_TILE;
      const int* f = first_pos + (r % GATHER_RING) * (R + 1) + j0;
#pragma unroll
      for (int m = 0; m < GATHER_BINS; ++m) {
        const int j = m * WALK_THREADS + tid;
        if (j < part) {
          const int p0 = f[j], p1 = f[j + 1];
          int p = p0;
          for (; p + 4 <= p1; p += 4) {      // four loads, then their adds
            const float2 x0 = v[p], x1 = v[p + 1], x2 = v[p + 2],
                         x3 = v[p + 3];
            a[m] = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(a[m], x0.x),
                                                 x1.x), x2.x), x3.x);
            h[m] = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(h[m], x0.y),
                                                 x1.y), x2.y), x3.y);
          }
          for (; p < p1; ++p) {
            a[m] = __fadd_rn(a[m], v[p].x);
            h[m] = __fadd_rn(h[m], v[p].y);
          }
          c[m] += p1 - p0;
        }
      }
      __syncthreads();                     // before the buffer is refilled
    }
    copy_wait<0>();
    float* dst = out + ((long long)s * G + g) * B * 3 + (long long)j0 * 3;
#pragma unroll
    for (int m = 0; m < GATHER_BINS; ++m) {
      const int j = m * WALK_THREADS + tid;
      if (j < part) {
        dst[3 * j] = a[m];
        dst[3 * j + 1] = h[m];
        dst[3 * j + 2] = (float)min(c[m], 1 << 24);
      }
    }
  }
}

// ---- 5. the zeros of slots without rows ----

__global__ void wide_zero(const int* __restrict__ start, long long slot_f4,
                          long long total_f4, float4* __restrict__ out) {
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < total_f4; q += (long long)gridDim.x * blockDim.x) {
    const int s = (int)(q / slot_f4);
    if (start[s + 1] == start[s]) out[q] = z;
  }
}

#define TRY(x)                             \
  do {                                     \
    cudaError_t e_ = (x);                  \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

// Persistent grid of `kernel` with `smem` bytes of dynamic shared memory:
// as many blocks as the card holds at once.  Past 48 KB the kernel is
// opted in to the most bytes any call asked (a lower opt-in would refuse
// the earlier, bigger launches).  Both kept per (device, kernel, bytes):
// the queries cost host time every wave.
template <typename K>
static int persistent_grid(K kernel, int threads, size_t smem, int* grid) {
  struct Seen {
    int dev;
    const void* kernel;
    size_t smem;
    int grid;
  };
  static Seen seen[32];
  static int n_seen = 0;
  int dev = 0;
  TRY(cudaGetDevice(&dev));
  size_t opted = 48 * 1024;
  for (int i = 0; i < n_seen; ++i) {
    if (seen[i].dev != dev || seen[i].kernel != (const void*)kernel)
      continue;
    if (seen[i].smem == smem) {
      *grid = seen[i].grid;
      return 0;
    }
    if (seen[i].smem > opted) opted = seen[i].smem;
  }
  if (smem > opted)
    TRY(cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem));
  int sms = 0, per_sm = 0;
  TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    threads, smem));
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = sms * per_sm;
  if (n_seen < 32)
    seen[n_seen++] = Seen{dev, (const void*)kernel, smem, *grid};
  return 0;
}

// Rows per chunk of the slot sort: SORT_CHUNK, or more so that at most
// SORT_MAX_CHUNKS chunks cover the rows.
static long long sort_chunk(long long n) {
  const long long c = (n + SORT_MAX_CHUNKS - 1) / SORT_MAX_CHUNKS;
  return c > SORT_CHUNK ? c : SORT_CHUNK;
}

// The wave's scratch, cut from one buffer in 256-byte pieces (int32
// unless said): keys0, rows_a, keys_a, rows_b, keys_b [n]; counts
// [nchunks * 256]; start [A + 1]; kslot [A]; items [CLASSES (A + 1)]
// int64; scal [10] (scal[0] the active rows, then the four item
// counters); sbin [G n] uint16 (int32 past a 65,536-bin stride); sgh [n]
// float2; and where B <=
// BLOCK_MAX_BINS the sorted rounds srt [G n] float2 and each round's
// first positions offs [G (2 ceil(n / WALK_TILE) + 1) (B + 1)].
struct Scratch {
  int *keys0, *rows_a, *keys_a, *rows_b, *keys_b, *counts, *start, *kslot;
  long long* items;
  int* scal;
  void* sbin;
  float2 *sgh, *srt;
  int* offs;
};
static size_t carve(char* base, long long n, int G, int A, int B,
                    Scratch* sc) {
  const long long rows = n > 0 ? n : 1;
  const long long nchunks = (n + sort_chunk(n) - 1) / sort_chunk(n);
  const bool two = B <= BLOCK_MAX_BINS;
  size_t at = 0;
  auto take = [&](size_t bytes) -> char* {
    char* p = base != nullptr ? base + at : nullptr;
    at += (bytes + 255) / 256 * 256;
    return p;
  };
  sc->keys0 = (int*)take(rows * 4);
  sc->rows_a = (int*)take(rows * 4);
  sc->keys_a = (int*)take(rows * 4);
  sc->rows_b = (int*)take(rows * 4);
  sc->keys_b = (int*)take(rows * 4);
  sc->counts = (int*)take((nchunks > 0 ? nchunks : 1) * 256 * 4);
  sc->start = (int*)take((A + 1) * 4);
  sc->kslot = (int*)take(A * 4);
  sc->items = (long long*)take((size_t)CLASSES * (A + 1) * 8);
  sc->scal = (int*)take(10 * 4);
  sc->sbin = take((size_t)G * rows * (B > 65536 ? 4 : 2));
  sc->sgh = (float2*)take(rows * 8);
  sc->srt = two ? (float2*)take((size_t)G * rows * 8) : nullptr;
  sc->offs = two ? (int*)take((size_t)G *
                              (2 * ((rows + WALK_TILE - 1) / WALK_TILE) + 1) *
                              (B + 1) * 4)
                 : nullptr;
  return at;
}

// Bytes of the scratch of a wave, in units of 256 (at most INT_MAX:
// 512 GiB, past any card).
extern "C" int lgbm_hist_wide_scratch(long long n, int G, int A, int B) {
  Scratch sc;
  const size_t units = carve(nullptr, n, G, A, B, &sc) / 256;
  return units < 0x7fffffff ? (int)units : 0x7fffffff;
}

// The whole wave into `out` [A, G, B, 3] f32 (every cell written), with
// `scratch` of lgbm_hist_wide_scratch x 256 bytes.
extern "C" int lgbm_hist_wide(const void* bins_t, int bins_int32,
                              long long n_pad, long long n, int G,
                              const void* grad, const void* hess,
                              const void* hist_leaf, const void* inv, int L,
                              int A, int B, void* scratch, void* out,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Scratch sc;
  carve((char*)scratch, n, G, A, B, &sc);
  int* n_active = sc.scal;
  unsigned long long* next_item = (unsigned long long*)(sc.scal + 2);
  const int chunk = (int)sort_chunk(n);
  const int nchunks = (int)((n + chunk - 1) / chunk);
  // slot bits -> passes of at most 8 bits (the counts hold 256 digits a
  // chunk), the later passes taking the odd bits
  int bits = 1;
  while ((1LL << bits) < A) ++bits;
  const int passes = (bits + 7) / 8;
  const int* sorted_rows = sc.rows_a;
  const int* sorted_keys = sc.keys_a;
  if (nchunks > 0) {
    int shift = 0;
    for (int p = 0; p < passes; ++p) {
      const int pbits = bits / passes + (p >= passes - bits % passes);
      const int nb = 1 << pbits;
      const bool first = p == 0;
      int* rout = p % 2 == 0 ? sc.rows_a : sc.rows_b;
      int* kout = p % 2 == 0 ? sc.keys_a : sc.keys_b;
      const int* rin = first ? nullptr : sorted_rows;
      const int* kin = first ? nullptr : sorted_keys;
      const int* nin = first ? nullptr : n_active;
      ws_count<<<nchunks, COUNT_THREADS, nb * sizeof(int), st>>>(
          (const int*)hist_leaf, (const int*)inv, L, n, kin, nin, sc.keys0,
          chunk, shift, nb, sc.counts);
      TRY(cudaGetLastError());
      ws_scan<<<1, SCAN_THREADS, 0, st>>>(sc.counts, nb * nchunks,
                                           n_active);
      TRY(cudaGetLastError());
      ws_fill<<<nchunks, 32, nb * sizeof(int), st>>>(
          sc.keys0, n, rin, kin, nin, chunk, shift, nb, pbits, sc.counts,
          rout, kout);
      TRY(cudaGetLastError());
      sorted_rows = rout;
      sorted_keys = kout;
      shift += pbits;
    }
    const dim3 sgrid((unsigned)((n + 255) / 256),
                     (unsigned)((G + STAGE_COLS - 1) / STAGE_COLS));
    if (B > 65536)
      ws_stage<int32_t, int><<<sgrid, 256, 0, st>>>(
          (const int32_t*)bins_t, n_pad, G, (const float*)grad,
          (const float*)hess, sorted_rows, n_active, n, (int*)sc.sbin,
          sc.sgh);
    else if (bins_int32)
      ws_stage<int32_t, uint16_t><<<sgrid, 256, 0, st>>>(
          (const int32_t*)bins_t, n_pad, G, (const float*)grad,
          (const float*)hess, sorted_rows, n_active, n,
          (uint16_t*)sc.sbin, sc.sgh);
    else
      ws_stage<uint8_t, uint16_t><<<sgrid, 256, 0, st>>>(
          (const uint8_t*)bins_t, n_pad, G, (const float*)grad,
          (const float*)hess, sorted_rows, n_active, n,
          (uint16_t*)sc.sbin, sc.sgh);
    TRY(cudaGetLastError());
  } else {
    TRY(cudaMemsetAsync(n_active, 0, sizeof(int), st));
  }
  ws_bounds<<<(A + 1 + 7) / 8, 256, 0, st>>>(sorted_keys, n_active, A,
                                              sc.start);
  TRY(cudaGetLastError());
  const int rmax = B < BLOCK_MAX_BINS ? B : BLOCK_MAX_BINS;
  const int kbase = B / rmax;
  const int rw = B <= WARP_MAX_BINS ? B : 0;
  ws_plan<<<1, SCAN_THREADS, 0, st>>>(sc.start, A, G, kbase,
                                       rw > 0 ? WARP_MAX_ROWS : 0, sc.kslot,
                                       sc.items, next_item);
  TRY(cudaGetLastError());
  const long long slot_f4 = (long long)G * B * 3 / 4;
  wide_zero<<<1024, 256, 0, st>>>(sc.start, slot_f4, slot_f4 * A,
                                   (float4*)out);
  TRY(cudaGetLastError());
  const size_t smem = walk_smem(rmax, rw);
  int grid = 0;
  int code;
  if (B > 65536) {
    code = persistent_grid(wide_walk<int>, WALK_THREADS, smem, &grid);
    if (code) return code;
    wide_walk<int><<<grid, WALK_THREADS, smem, st>>>(
        (const int*)sc.sbin, n, G, sc.sgh, sc.start, sc.kslot, sc.items, A,
        B, rmax, next_item, sc.srt, sc.offs, (float*)out);
  } else {
    code = persistent_grid(wide_walk<uint16_t>, WALK_THREADS, smem, &grid);
    if (code) return code;
    wide_walk<uint16_t><<<grid, WALK_THREADS, smem, st>>>(
        (const uint16_t*)sc.sbin, n, G, sc.sgh, sc.start, sc.kslot,
        sc.items, A, B, rmax, next_item, sc.srt, sc.offs, (float*)out);
  }
  TRY(cudaGetLastError());
  if (kbase == 1) {
    const size_t gsmem = gather_smem(B);
    code = persistent_grid(wide_gather, WALK_THREADS, gsmem, &grid);
    if (code) return code;
    wide_gather<<<grid, WALK_THREADS, gsmem, st>>>(
        sc.srt, sc.offs, n, G, sc.start, sc.items, A, B, next_item,
        (float*)out);
    TRY(cudaGetLastError());
  }
  return 0;
}
