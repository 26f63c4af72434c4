// Route (K2) and route-values (K4) kernels, on uint8 bins and (the
// `_i32` entry points) on the int32 bins of groups with more than 256
// bins.
//
// Replace the JAX package's Pallas `_route_kernel` and
// `_route_values_kernel` (lightgbm_tpu/ops/pallas_route.py, reached from
// `route_rows_pallas` / `route_rows_values_pallas` via `_route_call`).
//
// What bounds them on an H100: bytes.  Each row reads its two leaf ids
// (8 B) and one bin byte and writes two leaf ids (8 B), plus 4 B of leaf
// value for K4: about 17-21 B per row, a few microseconds per million
// rows at 3.35 TB/s.  The design keeps the traffic at that minimum: one
// thread per row, neighbouring threads on neighbouring rows so every
// leaf-vector access is coalesced, the per-leaf tables (and leaf values)
// staged once per block in shared memory, and a grid-stride loop so a
// modest grid amortises the staging.  The only scattered access is the
// split column's byte, bins_t[group, row], whose group varies by leaf.
#include <cuda_runtime.h>
#include <stdint.h>

#include "route_row.cuh"

// STAGED: the per-leaf tables are copied into shared memory, which holds
// them up to about 4,900 leaves; a deeper tree's are read from global
// memory (through L2) instead
template <bool VALUES, typename BinT, bool STAGED>
__global__ void route_kernel(const BinT* __restrict__ bins_t,
                             long long n_pad,
                             const int* __restrict__ leaf2_in,
                             int* __restrict__ leaf2_out,
                             const int* __restrict__ tabs, int L,
                             const uint8_t* __restrict__ cat_mask, int Bcat,
                             const float* __restrict__ leaf_values,
                             float* __restrict__ values_out) {
  extern __shared__ int sh[];
  const int* tab = tabs;
  const float* val = leaf_values;
  if (STAGED) {
    int* sh_tab = sh;
    float* sh_val = reinterpret_cast<float*>(sh + ROUTE_TAB_ROWS * L);
    stage_route_tables(sh_tab, tabs, L);
    if (VALUES) {
      for (int i = threadIdx.x; i < L; i += blockDim.x)
        sh_val[i] = leaf_values[i];
    }
    __syncthreads();
    tab = sh_tab;
    val = sh_val;
  }
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       row < n_pad; row += stride) {
    int rl = leaf2_in[row];
    int hl = leaf2_in[n_pad + row];
    int2 r = route_row(tab, L, bins_t, n_pad, row, rl, hl, cat_mask, Bcat);
    leaf2_out[row] = r.x;
    leaf2_out[n_pad + row] = r.y;
    if (VALUES) values_out[row] = r.x >= 0 ? val[r.x] : 0.0f;
  }
}

// shared memory one block may use on sm_90
#define ROUTE_SMEM_MAX 232448

static int route_smem_bytes(int L, bool values) {
  return (ROUTE_TAB_ROWS * L + (values ? L : 0)) * 4;
}

template <bool VALUES, typename BinT>
static int launch_route(const void* bins_t, long long n_pad,
                        const void* leaf2_in, void* leaf2_out,
                        const void* tabs, int L, const void* cat_mask,
                        int Bcat, const void* leaf_values, void* values_out,
                        int grid, int block, void* stream) {
  int smem = route_smem_bytes(L, VALUES);
  if (smem > ROUTE_SMEM_MAX) {
    route_kernel<VALUES, BinT, false><<<grid, block, 0,
                                        (cudaStream_t)stream>>>(
        (const BinT*)bins_t, n_pad, (const int*)leaf2_in, (int*)leaf2_out,
        (const int*)tabs, L, (const uint8_t*)cat_mask, Bcat,
        (const float*)leaf_values, (float*)values_out);
    return (int)cudaGetLastError();
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        route_kernel<VALUES, BinT, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  route_kernel<VALUES, BinT, true><<<grid, block, smem,
                                     (cudaStream_t)stream>>>(
      (const BinT*)bins_t, n_pad, (const int*)leaf2_in, (int*)leaf2_out,
      (const int*)tabs, L, (const uint8_t*)cat_mask, Bcat,
      (const float*)leaf_values, (float*)values_out);
  return (int)cudaGetLastError();
}

extern "C" int lgbm_route_rows(const void* bins_t, long long n_pad,
                               const void* leaf2_in, void* leaf2_out,
                               const void* tabs, int L, const void* cat_mask,
                               int Bcat, int grid, int block,
                               void* stream) {
  return launch_route<false, uint8_t>(bins_t, n_pad, leaf2_in, leaf2_out,
                                      tabs, L, cat_mask, Bcat, nullptr,
                                      nullptr, grid, block, stream);
}

extern "C" int lgbm_route_rows_values(const void* bins_t, long long n_pad,
                                      const void* leaf2_in, void* leaf2_out,
                                      const void* tabs, int L,
                                      const void* cat_mask, int Bcat,
                                      const void* leaf_values,
                                      void* values_out, int grid, int block,
                                      void* stream) {
  return launch_route<true, uint8_t>(bins_t, n_pad, leaf2_in, leaf2_out,
                                     tabs, L, cat_mask, Bcat, leaf_values,
                                     values_out, grid, block, stream);
}

extern "C" int lgbm_route_rows_i32(const void* bins_t, long long n_pad,
                                   const void* leaf2_in, void* leaf2_out,
                                   const void* tabs, int L,
                                   const void* cat_mask, int Bcat, int grid,
                                   int block, void* stream) {
  return launch_route<false, int32_t>(bins_t, n_pad, leaf2_in, leaf2_out,
                                      tabs, L, cat_mask, Bcat, nullptr,
                                      nullptr, grid, block, stream);
}

extern "C" int lgbm_route_rows_values_i32(const void* bins_t,
                                          long long n_pad,
                                          const void* leaf2_in,
                                          void* leaf2_out, const void* tabs,
                                          int L, const void* cat_mask,
                                          int Bcat, const void* leaf_values,
                                          void* values_out, int grid,
                                          int block, void* stream) {
  return launch_route<true, int32_t>(bins_t, n_pad, leaf2_in, leaf2_out,
                                     tabs, L, cat_mask, Bcat, leaf_values,
                                     values_out, grid, block, stream);
}
