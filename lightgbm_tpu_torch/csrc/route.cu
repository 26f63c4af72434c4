// Route (K2) and route-values (K4) kernels, on uint8 bins and (the
// `_i32` entry points) on the int32 bins of groups with more than 256
// bins.
//
// Replace the JAX package's Pallas `_route_kernel` and
// `_route_values_kernel` (lightgbm_tpu/ops/pallas_route.py, reached from
// `route_rows_pallas` / `route_rows_values_pallas` via `_route_call`).
//
// What bounds them on an H100: bytes.  Each row reads its two leaf ids
// (8 B) and writes two (8 B), plus 4 B of leaf value for K4; a row of a
// split leaf also reads one bin, whose 32-byte sector is the only
// scattered access (the split column varies by leaf).  The per-leaf
// split tables are small but read by every row, and how they reach the
// rows decides the time once a tree is deep:
//   * a row needs its leaf's split only if the leaf splits in this wave,
//     so the kernels test one bit of a selection map (L bits, in shared
//     memory: 16 KB at 131,072 leaves) first, and read the split of a
//     selected leaf as one 32-byte record (route_row.cuh `RecordLeaf`:
//     two int4 loads, not eleven scattered table reads);
//   * staged (up to 4,096 leaves, where the records and K4's leaf values
//     fit shared memory): each block packs the records of the leaves
//     this wave splits, and only those, from the [11, L] table into
//     shared memory, and builds the selection map with one ballot per
//     32 leaves.  The grid is persistent (as many blocks as are resident
//     at once, from the occupancy query), so the tables stage once per
//     resident block, not once per 512 rows: past 1,024 leaves one
//     1,024-thread block an SM with two rows a thread in flight (its
//     leaves, then their records and bins, load before the first
//     decision); up to 1,024 leaves four 512-thread blocks an SM at 32
//     registers, or, where one block an SM holds every row, one
//     uncapped block (a latency chain, not a stream);
//   * global (deeper trees): a pack kernel writes the records of the
//     selected leaves and the selection map to scratch once, and the
//     route kernel stages only the map and reads a selected row's record
//     (one 32-byte sector) through L1, at full occupancy;
//   * each thread's first rows' leaf loads are issued before the
//     staging.
// The shapes were chosen by timing variants on the card (PERF.md).
// The work is integer and per row, so any row order or split of rows
// gives the bits of the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "route_row.cuh"

// A launch shape: threads a block, rows a thread holds in flight, the
// blocks an SM that __launch_bounds__ asks registers for, and the leaves
// a thread stages a round (their loads in flight together).
template <int THREADS_, int ROWS_, int MIN_BLOCKS_, int STAGE_LEAVES_>
struct RouteShape {
  static constexpr int THREADS = THREADS_;
  static constexpr int ROWS = ROWS_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int STAGE_LEAVES = STAGE_LEAVES_;
};
// staged, up to ROUTE_SMALL_LEAVES leaves: small tables, staged by each
// of four blocks an SM, one row a thread at full occupancy (32
// registers: a leaf a round keeps the staging within them)
using SmallShape = RouteShape<512, 1, 4, 1>;
// K4's where one block an SM holds every row (at most 512 rows an SM):
// the route is then one latency chain (launch, staging, leaf, bin,
// stores), which the register cap lengthened for K4 (not for K2) and
// occupancy does not shorten
using LatencyShape = RouteShape<512, 1, 1, 1>;
// staged past that: one large block an SM, so the tables stage once per
// SM, and two rows a thread
using DeepShape = RouteShape<1024, 2, 1, 2>;
// global: full occupancy, one row a thread at a time
using GlobalShape = RouteShape<512, 1, 4, 1>;
#define ROUTE_SMALL_LEAVES 1024
// the staged layout takes trees of at most this many leaves: past it the
// blocks' staging (the sel row and ten fields of every split leaf, per
// block) costs more than the global layout's pack and record reads
#define ROUTE_STAGE_MAX_LEAVES 4096
#define ROUTE_PACK_THREADS 256
// shared memory one block may use on sm_90
#define ROUTE_SMEM_MAX 232448

__host__ __device__ static inline int sel_words(int L) {
  return (L + 31) / 32;
}

// Shared memory of the staged layout: records [2L] int4 (the a halves,
// then the b halves), K4's leaf values [L] f32, the selection map.
static size_t staged_smem_bytes(int L, bool values) {
  return (size_t)L * 32 + (values ? (size_t)L * 4 : 0)
         + (size_t)sel_words(L) * 4;
}

static bool staged(int L, bool values) {
  return L <= ROUTE_STAGE_MAX_LEAVES
         && staged_smem_bytes(L, values) <= ROUTE_SMEM_MAX;
}

static size_t smem_bytes(int L, bool values) {
  return staged(L, values) ? staged_smem_bytes(L, values)
                           : (size_t)sel_words(L) * 4;
}

// scratch of the global layout: records [L] x 32 B, the selection map
static size_t scratch_bytes(int L, bool values) {
  return staged(L, values) ? 0
                           : (size_t)L * 32 + (size_t)sel_words(L) * 4;
}

// The global layout's pack: the records of the leaves this wave splits
// (leaf i at records[2i], records[2i + 1]) and the selection map.  One
// thread per leaf; the grid covers sel_words(L) * 32 leaves.
__global__ void __launch_bounds__(ROUTE_PACK_THREADS)
route_pack_kernel(const int* __restrict__ tabs, int L,
                  int4* __restrict__ records, unsigned* __restrict__ sel) {
  const int i = blockIdx.x * ROUTE_PACK_THREADS + threadIdx.x;
  if (i >= sel_words(L) * 32) return;   // whole warps: a multiple of 32
  const bool s = i < L && tabs[T_SEL * L + i] != 0;
  const unsigned word = __ballot_sync(0xffffffffu, s);
  if ((threadIdx.x & 31) == 0) sel[i >> 5] = word;
  if (s) {
    const RecordLeaf r = pack_route_record(tabs, L, i);
    records[2 * i] = r.a;
    records[2 * i + 1] = r.b;
  }
}

// The staged layout's tables, built by every thread of the block (the
// caller synchronises): the records of the split leaves, the selection
// map, K4's leaf values.  A thread takes P leaves a round, i + p *
// THREADS, with all their loads in flight at once.  W * 32 and the
// block are multiples of 32: whole warps take part in each ballot.
template <bool VALUES, int THREADS, int P>
__device__ __forceinline__ void stage_records(
    const int* __restrict__ tabs, int L,
    const float* __restrict__ leaf_values, int4* sh_rec, float* sh_val,
    unsigned* sh_sel) {
  const int W = sel_words(L);
  for (int i0 = threadIdx.x; i0 < W * 32; i0 += P * THREADS) {
    bool s[P];
    RecordLeaf r[P];
    float v[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = i0 + p * THREADS;
      s[p] = i < L && tabs[T_SEL * L + i] != 0;
      if (VALUES && i < L) v[p] = leaf_values[i];
    }
#pragma unroll
    for (int p = 0; p < P; ++p)
      if (s[p]) r[p] = pack_route_record(tabs, L, i0 + p * THREADS);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int i = i0 + p * THREADS;
      if (i < W * 32) {   // the same for the whole warp
        const unsigned word = __ballot_sync(0xffffffffu, s[p]);
        if ((threadIdx.x & 31) == 0) sh_sel[i >> 5] = word;
      }
      if (s[p]) {
        sh_rec[i] = r[p].a;
        sh_rec[L + i] = r[p].b;
      }
      if (VALUES && i < L) sh_val[i] = v[p];
    }
  }
}

// STAGED: the staged layout; else the global one (`records`, `sel` from
// route_pack_kernel).  With T = Shape::THREADS and R = Shape::ROWS,
// batch b of block x holds rows (b * R + k) * gridDim * T + x * T + tid,
// k < R: a warp's rows are neighbours, and a grid of one block per T
// rows gives each thread one row.
template <bool VALUES, typename BinT, bool STAGED, typename Shape>
__global__ void __launch_bounds__(Shape::THREADS, Shape::MIN_BLOCKS)
route_kernel(const BinT* __restrict__ bins_t, long long n_pad,
             const int* __restrict__ leaf2_in, int* __restrict__ leaf2_out,
             const int* __restrict__ tabs, int L,
             const uint8_t* __restrict__ cat_mask, int Bcat,
             const float* __restrict__ leaf_values,
             float* __restrict__ values_out,
             const int4* __restrict__ records,
             const unsigned* __restrict__ sel) {
  constexpr int R = Shape::ROWS;
  extern __shared__ int4 sh4[];
  int4* sh_rec = sh4;
  float* sh_val = reinterpret_cast<float*>(sh4 + (STAGED ? 2 * L : 0));
  unsigned* sh_sel =
      reinterpret_cast<unsigned*>(sh_val + (STAGED && VALUES ? L : 0));
  const long long span = (long long)gridDim.x * Shape::THREADS;
  long long base = (long long)blockIdx.x * Shape::THREADS + threadIdx.x;

  // the first batch's leaves load while the tables stage
  int rl[R], hl[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const long long row = base + k * span;
    rl[k] = row < n_pad ? leaf2_in[row] : -1;
    hl[k] = row < n_pad ? leaf2_in[n_pad + row] : -1;
  }

  if (STAGED) {
    stage_records<VALUES, Shape::THREADS, Shape::STAGE_LEAVES>(
        tabs, L, leaf_values, sh_rec, sh_val, sh_sel);
  } else {
    for (int i = threadIdx.x; i < sel_words(L); i += Shape::THREADS)
      sh_sel[i] = sel[i];
  }
  __syncthreads();

  while (base < n_pad) {
    RecordLeaf f[R];
    int c[R];
    bool moves[R];
    // every row's record first, then the bins they name
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int leaf = rl[k];
      moves[k] = leaf >= 0 && ((sh_sel[leaf >> 5] >> (leaf & 31)) & 1u);
      if (moves[k]) {
        if (STAGED) {
          f[k].a = sh_rec[leaf];
          f[k].b = sh_rec[L + leaf];
        } else {
          f[k].a = __ldg(records + 2 * leaf);
          f[k].b = __ldg(records + 2 * leaf + 1);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      if (moves[k])
        c[k] = bins_t[(long long)f[k].a.x * n_pad + base + k * span];
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const long long row = base + k * span;
      if (row >= n_pad) break;
      int leaf = rl[k];
      if (moves[k] && !route_left(f[k], c[k], leaf, cat_mask, Bcat))
        leaf = f[k].new_id();
      leaf2_out[row] = leaf;
      leaf2_out[n_pad + row] = hl[k] >= 0 ? leaf : hl[k];
      if (VALUES) {
        float v = 0.0f;
        if (leaf >= 0) v = STAGED ? sh_val[leaf] : __ldg(leaf_values + leaf);
        values_out[row] = v;
      }
    }
    base += R * span;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const long long row = base + k * span;
      rl[k] = row < n_pad ? leaf2_in[row] : -1;
      hl[k] = row < n_pad ? leaf2_in[n_pad + row] : -1;
    }
  }
}

// One layout and launch shape of K2 (VALUES false) or K4 on BinT bins.
template <bool VALUES, typename BinT, bool STAGED, typename Shape>
struct RouteLaunch {
  static int opt_in(size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        route_kernel<VALUES, BinT, STAGED, Shape>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  }
  static int plan(size_t smem, int* out) {
    const int e = opt_in(smem);
    if (e) return e;
    out[2] = Shape::THREADS;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], route_kernel<VALUES, BinT, STAGED, Shape>, Shape::THREADS,
        smem);
  }
  static int launch(const BinT* b, long long n_pad, const int* in, int* out,
                    const int* t, int L, const uint8_t* cm, int Bcat,
                    const float* lv, float* vo, const int4* records,
                    const unsigned* sel, size_t smem, int grid, int block,
                    cudaStream_t stream) {
    if (block != Shape::THREADS) return (int)cudaErrorInvalidValue;
    const int e = opt_in(smem);
    if (e) return e;
    route_kernel<VALUES, BinT, STAGED, Shape><<<grid, block, smem, stream>>>(
        b, n_pad, in, out, t, L, cm, Bcat, lv, vo, records, sel);
    return (int)cudaGetLastError();
  }
};

template <bool VALUES, typename BinT>
static int route_plan(int L, int* out) {
  const size_t smem = smem_bytes(L, VALUES);
  out[1] = (int)scratch_bytes(L, VALUES);
  if (!staged(L, VALUES))
    return RouteLaunch<VALUES, BinT, false, GlobalShape>::plan(smem, out);
  if (L <= ROUTE_SMALL_LEAVES)
    return RouteLaunch<VALUES, BinT, true, SmallShape>::plan(smem, out);
  return RouteLaunch<VALUES, BinT, true, DeepShape>::plan(smem, out);
}

// The current device's SM count, kept per device after the first query.
static int multiprocessor_count(int* sms) {
  static int known[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 64 && known[dev] > 0) {
    *sms = known[dev];
    return 0;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < 64) known[dev] = *sms;
  return (int)e;
}

template <bool VALUES, typename BinT>
static int launch_route(const void* bins_t, long long n_pad,
                        const void* leaf2_in, void* leaf2_out,
                        const void* tabs, int L, const void* cat_mask,
                        int Bcat, const void* leaf_values, void* values_out,
                        void* scratch, int grid, int block, void* stream) {
  if (grid < 1 || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = smem_bytes(L, VALUES);
  const BinT* b = (const BinT*)bins_t;
  const int* in = (const int*)leaf2_in;
  int* out = (int*)leaf2_out;
  const int* t = (const int*)tabs;
  const uint8_t* cm = (const uint8_t*)cat_mask;
  const float* lv = (const float*)leaf_values;
  float* vo = (float*)values_out;
  if (staged(L, VALUES)) {
    if (L <= ROUTE_SMALL_LEAVES) {
      int sms = 0;
      if (VALUES) {
        const int e = multiprocessor_count(&sms);
        if (e) return e;
      }
      if (VALUES && n_pad <= (long long)sms * LatencyShape::THREADS)
        return RouteLaunch<VALUES, BinT, true, LatencyShape>::launch(
            b, n_pad, in, out, t, L, cm, Bcat, lv, vo, nullptr, nullptr,
            smem, grid, block, st);
      return RouteLaunch<VALUES, BinT, true, SmallShape>::launch(
          b, n_pad, in, out, t, L, cm, Bcat, lv, vo, nullptr, nullptr, smem,
          grid, block, st);
    }
    return RouteLaunch<VALUES, BinT, true, DeepShape>::launch(
        b, n_pad, in, out, t, L, cm, Bcat, lv, vo, nullptr, nullptr, smem,
        grid, block, st);
  }
  if (scratch == nullptr || block != GlobalShape::THREADS)
    return (int)cudaErrorInvalidValue;
  int4* records = (int4*)scratch;
  unsigned* sel = (unsigned*)((char*)scratch + (size_t)L * 32);
  const int leaves = sel_words(L) * 32;
  route_pack_kernel<<<(leaves + ROUTE_PACK_THREADS - 1) / ROUTE_PACK_THREADS,
                      ROUTE_PACK_THREADS, 0, st>>>(t, L, records, sel);
  const int e = (int)cudaGetLastError();
  if (e) return e;
  return RouteLaunch<VALUES, BinT, false, GlobalShape>::launch(
      b, n_pad, in, out, t, L, cm, Bcat, lv, vo, records, sel, smem, grid,
      block, st);
}

// The launch plan of K2 (`values` 0) or K4 on uint8 (`i32` 0) or int32
// bins at `L` leaves, on the current device: out[0] = blocks resident on
// one SM, out[1] = bytes of scratch a launch takes (0: the staged
// layout), out[2] = threads a block (the launch's `block`).
extern "C" int lgbm_route_plan(int L, int values, int i32, int* out) {
  if (values)
    return i32 ? route_plan<true, int32_t>(L, out)
               : route_plan<true, uint8_t>(L, out);
  return i32 ? route_plan<false, int32_t>(L, out)
             : route_plan<false, uint8_t>(L, out);
}

extern "C" int lgbm_route_rows(const void* bins_t, long long n_pad,
                               const void* leaf2_in, void* leaf2_out,
                               const void* tabs, int L, const void* cat_mask,
                               int Bcat, void* scratch, int grid, int block,
                               void* stream) {
  return launch_route<false, uint8_t>(bins_t, n_pad, leaf2_in, leaf2_out,
                                      tabs, L, cat_mask, Bcat, nullptr,
                                      nullptr, scratch, grid, block, stream);
}

extern "C" int lgbm_route_rows_values(const void* bins_t, long long n_pad,
                                      const void* leaf2_in, void* leaf2_out,
                                      const void* tabs, int L,
                                      const void* cat_mask, int Bcat,
                                      const void* leaf_values,
                                      void* values_out, void* scratch,
                                      int grid, int block, void* stream) {
  return launch_route<true, uint8_t>(bins_t, n_pad, leaf2_in, leaf2_out,
                                     tabs, L, cat_mask, Bcat, leaf_values,
                                     values_out, scratch, grid, block,
                                     stream);
}

extern "C" int lgbm_route_rows_i32(const void* bins_t, long long n_pad,
                                   const void* leaf2_in, void* leaf2_out,
                                   const void* tabs, int L,
                                   const void* cat_mask, int Bcat,
                                   void* scratch, int grid, int block,
                                   void* stream) {
  return launch_route<false, int32_t>(bins_t, n_pad, leaf2_in, leaf2_out,
                                      tabs, L, cat_mask, Bcat, nullptr,
                                      nullptr, scratch, grid, block, stream);
}

extern "C" int lgbm_route_rows_values_i32(const void* bins_t,
                                          long long n_pad,
                                          const void* leaf2_in,
                                          void* leaf2_out, const void* tabs,
                                          int L, const void* cat_mask,
                                          int Bcat, const void* leaf_values,
                                          void* values_out, void* scratch,
                                          int grid, int block, void* stream) {
  return launch_route<true, int32_t>(bins_t, n_pad, leaf2_in, leaf2_out,
                                     tabs, L, cat_mask, Bcat, leaf_values,
                                     values_out, scratch, grid, block,
                                     stream);
}
