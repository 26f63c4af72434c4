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
// Float atomics would add in a different order in every run.  This
// kernel fixes the order instead, and its plain version
// (ops/histogram.py:hist_float_plain) sums in the same one:
//   * rows are cut into chunks of `chunk` rows (2,048, a divisor of the
//     streamed block granularity of 8,192 rows);
//   * within a chunk every cell sums its rows in row order from +0.0
//     (kernel 1, one partial per chunk);
//   * the partials are added into the carry in chunk order (kernel 2).
// So the result does not depend on the block size, and a chain of
// per-block calls is bitwise one call over all rows.
//
// Kernel 1: one thread block per (chunk, slot group, column group).
// Warp w owns slot s0 + w and lane l owns column g0 + l, so every cell
// has exactly one owner and the owner walks the chunk's rows in order.
// A warp takes the chunk 32 rows at a time, finds the rows of its slot
// with one ballot and visits them in row order; the block's partial
// lives in shared memory as [slots][C][B][32 lanes] float32, so the 32
// lanes of a warp always hit 32 different banks.
// Kernel 2: one thread per output cell folds the chunk partials of its
// accumulation slot into the carry, in chunk order.
//
// What bounds it on an H100: the roofline bound is bytes (bins G B/row,
// values 4C B/row, hist leaf 4 B/row, the carry read and written once);
// this first design pays more: each matched row is one lane's serial
// shared-memory read-modify-write per value row, a block's partial
// (zeros included) goes through device memory once, and a chunk whose
// rows all fall in one slot (the root wave) is walked by a single warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define LGBM_FLOAT_LANES 32

__global__ void hist_float_partial_kernel(
    const uint8_t* __restrict__ bins_t, long long n_pad, int G,
    const float* __restrict__ vals, int C,
    const int* __restrict__ hist_leaf, int L, const int* __restrict__ inv,
    int A, int B, int As, int chunk, float* __restrict__ partial) {
  extern __shared__ float sh[];
  float* part = sh;                                   // [As][C][B][LANES]
  short* slot = (short*)(sh + (size_t)As * C * B * LGBM_FLOAT_LANES);
  const long long k = blockIdx.x;
  const long long r0 = k * chunk;
  const int len = (int)min((long long)chunk, n_pad - r0);
  const int s0 = blockIdx.y * As;
  const int ns = min(As, A - s0);
  const int g0 = blockIdx.z * LGBM_FLOAT_LANES;
  const int ng = min(LGBM_FLOAT_LANES, G - g0);
  const int cells = As * C * B * LGBM_FLOAT_LANES;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) part[i] = 0.0f;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int hl = hist_leaf[r0 + i];
    const int s = inv[hl >= 0 ? hl : L] - s0;
    slot[i] = (short)((unsigned)s < (unsigned)ns ? s : -1);
  }
  __syncthreads();

  const int w = threadIdx.x / LGBM_FLOAT_LANES;
  const int lane = threadIdx.x % LGBM_FLOAT_LANES;
  if (w < ns) {                       // warp-uniform
    const bool own = lane < ng;
    const uint8_t* col =
        bins_t + (long long)(g0 + (own ? lane : 0)) * n_pad + r0;
    const float* v0 = vals + r0;
    float* mine = part + (size_t)w * C * B * LGBM_FLOAT_LANES + lane;
    for (int base = 0; base < len; base += LGBM_FLOAT_LANES) {
      const int i = base + lane;
      const bool hit = i < len && slot[i] == w;
      unsigned m = __ballot_sync(0xffffffffu, hit);
      while (m) {                     // this slot's rows, in row order
        const int j = base + __ffs(m) - 1;
        m &= m - 1;
        if (!own) continue;
        const int bin = col[j];
        for (int c = 0; c < C; ++c) {
          const float v =
              __bfloat162float(__float2bfloat16_rn(v0[c * n_pad + j]));
          float* cell = mine + ((size_t)c * B + bin) * LGBM_FLOAT_LANES;
          *cell = __fadd_rn(*cell, v);
        }
      }
    }
  }
  __syncthreads();

  // the block's tile of partial[k][slot][column][bin][c], every cell
  // written (zeros included), so the buffer needs no clearing
  const long long gbc = (long long)G * B * C;
  const int tile = ns * ng * B * C;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int c = i % C;
    int t = i / C;
    const int b = t % B;
    t /= B;
    const int gl = t % ng;
    const int sl = t / ng;
    partial[(k * A + s0 + sl) * gbc + ((long long)(g0 + gl) * B + b) * C +
            c] = part[(((size_t)sl * C + c) * B + b) * LGBM_FLOAT_LANES + gl];
  }
}

__global__ void hist_float_fold_kernel(const float* __restrict__ partial,
                                       int K, int A, long long gbc,
                                       const int* __restrict__ src,
                                       float* __restrict__ acc) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)A * gbc) return;
  const int s = (int)(idx / gbc);
  const int ss = src[s];
  if (ss < 0) return;
  const long long stride = (long long)A * gbc;
  const float* p = partial + (long long)ss * gbc + (idx - (long long)s * gbc);
  float a = acc[idx];
  for (int k = 0; k < K; ++k) a = __fadd_rn(a, p[k * stride]);
  acc[idx] = a;
}

// Dynamic shared memory of one block of kernel 1, in bytes.
static inline int hist_float_smem_bytes(int As, int B, int C, int chunk) {
  return As * C * B * LGBM_FLOAT_LANES * 4 + chunk * 2;
}

extern "C" int lgbm_hist_float(const void* bins_t, long long n_pad, int G,
                               const void* vals, int C,
                               const void* hist_leaf, int L,
                               const void* inv, const void* src, int A,
                               int B, int As, int chunk, void* partial,
                               void* acc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int K = (int)((n_pad + chunk - 1) / chunk);
  const int smem = hist_float_smem_bytes(As, B, C, chunk);
  cudaFuncSetAttribute(hist_float_partial_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid(K, (A + As - 1) / As,
            (G + LGBM_FLOAT_LANES - 1) / LGBM_FLOAT_LANES);
  hist_float_partial_kernel<<<grid, As * LGBM_FLOAT_LANES, smem, st>>>(
      (const uint8_t*)bins_t, n_pad, G, (const float*)vals, C,
      (const int*)hist_leaf, L, (const int*)inv, A, B, As, chunk,
      (float*)partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long gbc = (long long)G * B * C;
  const long long total = (long long)A * gbc;
  const int threads = 256;
  hist_float_fold_kernel<<<(unsigned)((total + threads - 1) / threads),
                           threads, 0, st>>>(
      (const float*)partial, K, A, gbc, (const int*)src, (float*)acc);
  return (int)cudaGetLastError();
}
