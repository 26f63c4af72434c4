// Fused numerical split scan (K6).
//
// Replaces the JAX package's Pallas `_split_kernel`
// (lightgbm_tpu/ops/pallas_split.py, reached from
// `find_best_splits_pallas`): for every changed leaf of a wave, the
// prefix sums over each feature's bins, both missing-direction variants,
// the constraints, the gains and the joint (feature, bin, direction)
// argmax, packed as one row (gain, feature, bin, default_left, lg, lh,
// lc, 0) per leaf.
//
// What bounds it on an H100: bytes, in principle.  The wave reads its
// [L2, F, B, 3] float32 grid once (5.5 MB at 64 leaves x 28 features x
// 256 bins), under 2 us at 3.35 TB/s, and does a few tens of float
// operations per cell.  At that size the launch costs more than the
// work; the design therefore aims at one launch per wave with no host
// read, and keeps the arithmetic in the reference's order so the result
// is bitwise its plain version's:
//   * one block per leaf, 256 threads, one thread per (feature, bin)
//     cell; a block takes 256 / B features per pass and loops over the
//     features, carrying its best candidate between passes;
//   * prefix and suffix sums are Hillis-Steele steps in shared memory,
//     x + (lane >= k ? x[lane - k] : 0), the order of the reference's
//     masked rolls;
//   * every add, multiply and divide is an explicitly rounded intrinsic,
//     so nvcc contracts nothing into a fused multiply-add;
//   * the argmax is a shared-memory tree over (gain desc, lane asc).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMissingZero = 1;   // io/binning.py MISSING_ZERO
constexpr int kMissingNan = 2;    // io/binning.py MISSING_NAN
constexpr float kMinScore = -1e30f;
constexpr int kPacked = 8;
constexpr int kMaxThreads = 256;

struct Cand {
  float gain;
  int lane;
  float lg, lh, lc, var;
};

__device__ __forceinline__ bool better(const Cand& a, const Cand& b) {
  return a.gain > b.gain || (a.gain == b.gain && a.lane < b.lane);
}

// sign(s) * max(|s| - l1, 0) squared over (h + l2), rounded op by op
__device__ __forceinline__ float gain_of(float s, float h, float l1,
                                         float l2) {
  float sg = s > 0.0f ? 1.0f : (s < 0.0f ? -1.0f : 0.0f);
  float t = __fmul_rn(sg, fmaxf(__fsub_rn(fabsf(s), l1), 0.0f));
  return __fdiv_rn(__fmul_rn(t, t), __fadd_rn(h, l2));
}

// inclusive Hillis-Steele scan of buf[c][t] within segments of B lanes;
// forward (prefix) or backward (suffix)
template <bool SUFFIX>
__device__ void seg_scan(float (*buf)[kMaxThreads], int t, int lm, int B) {
  for (int k = 1; k < B; k <<= 1) {
    float a[3];
    bool take = SUFFIX ? (lm < B - k) : (lm >= k);
    for (int c = 0; c < 3; ++c)
      a[c] = take ? buf[c][SUFFIX ? t + k : t - k] : 0.0f;
    __syncthreads();
    for (int c = 0; c < 3; ++c) buf[c][t] = __fadd_rn(buf[c][t], a[c]);
    __syncthreads();
  }
}

__global__ void split_scan_kernel(
    const float* __restrict__ grid, int F, int B,
    const float* __restrict__ lsg, const float* __restrict__ lsh,
    const float* __restrict__ lcnt, const int* __restrict__ num_bins,
    const int* __restrict__ missing_types,
    const int* __restrict__ default_bins,
    const uint8_t* __restrict__ fmask, float l1, float l2, float min_d,
    float min_he, int any_missing, float* __restrict__ out) {
  __shared__ float scan[3][kMaxThreads];
  __shared__ float msum[3][kMaxThreads];
  __shared__ Cand red[kMaxThreads];
  const int leaf = blockIdx.x;
  const int t = threadIdx.x;
  const int nthreads = blockDim.x;
  const int per_pass = nthreads / B;
  const int lm = t & (B - 1);
  const float tg = lsg[leaf], th = lsh[leaf], tc = lcnt[leaf];
  Cand best = {-INFINITY, 0x7fffffff, 0.0f, 0.0f, 0.0f, 0.0f};

  for (int f0 = 0; f0 < F; f0 += per_pass) {
    const int f = f0 + t / B;
    const bool live = f < F;
    bool vmask = false, miss = false, ok_base = false, hasmiss = false;
    bool fm = false;
    float v[3] = {0.0f, 0.0f, 0.0f};
    if (live) {
      const int nb = num_bins[f];
      const int mt = missing_types[f];
      const bool has_nan = mt == kMissingNan;
      const bool is_zero = mt == kMissingZero;
      const int missb = has_nan ? nb - 1 : (is_zero ? default_bins[f] : -1);
      const bool valid = lm < nb;
      miss = (lm == missb) && valid;
      vmask = valid && !miss;
      const int max_t = has_nan ? nb - 2 : nb - 1;
      ok_base = (lm < max_t) && !(miss && is_zero);
      hasmiss = missb >= 0;
      fm = fmask[f] != 0;
      const float* cell = grid + (((long long)leaf * F + f) * B + lm) * 3;
      v[0] = cell[0];
      v[1] = cell[1];
      v[2] = cell[2];
    }
    // masks multiply (as the reference) so signed zeros follow it
    for (int c = 0; c < 3; ++c) {
      scan[c][t] = __fmul_rn(v[c], vmask ? 1.0f : 0.0f);
      msum[c][t] = __fmul_rn(v[c], miss ? 1.0f : 0.0f);
    }
    __syncthreads();
    seg_scan<false>(scan, t, lm, B);
    float mb[3] = {0.0f, 0.0f, 0.0f};
    if (any_missing) {
      seg_scan<true>(msum, t, lm, B);
      // the segment total moves to lane 0 and is broadcast by a prefix
      // scan (the reference's order)
      float at0[3];
      for (int c = 0; c < 3; ++c) at0[c] = lm == 0 ? msum[c][t] : 0.0f;
      __syncthreads();
      for (int c = 0; c < 3; ++c) msum[c][t] = at0[c];
      __syncthreads();
      seg_scan<false>(msum, t, lm, B);
      for (int c = 0; c < 3; ++c) mb[c] = msum[c][t];
    }

    Cand cand;
    cand.lane = f * B + lm;
    {
      const float lg = scan[0][t], lh = scan[1][t], lc = scan[2][t];
      const float rg = __fsub_rn(tg, lg), rh = __fsub_rn(th, lh);
      const float rc = __fsub_rn(tc, lc);
      const bool ok = lc >= min_d && rc >= min_d && lh >= min_he &&
                      rh >= min_he && ok_base && fm;
      const float g0 = ok ? __fadd_rn(gain_of(lg, lh, l1, l2),
                                      gain_of(rg, rh, l1, l2))
                          : kMinScore;
      cand.gain = g0;
      cand.lg = lg;
      cand.lh = lh;
      cand.lc = lc;
      cand.var = 0.0f;
      if (any_missing) {
        const float lg1 = __fadd_rn(lg, mb[0]);
        const float lh1 = __fadd_rn(lh, mb[1]);
        const float lc1 = __fadd_rn(lc, mb[2]);
        const float rg1 = __fsub_rn(tg, lg1), rh1 = __fsub_rn(th, lh1);
        const float rc1 = __fsub_rn(tc, lc1);
        const bool ok1 = lc1 >= min_d && rc1 >= min_d && lh1 >= min_he &&
                         rh1 >= min_he && ok_base && fm && hasmiss;
        const float g1 = ok1 ? __fadd_rn(gain_of(lg1, lh1, l1, l2),
                                         gain_of(rg1, rh1, l1, l2))
                             : kMinScore;
        if (g1 > g0) {                 // ties -> variant 0
          cand.gain = g1;
          cand.lg = lg1;
          cand.lh = lh1;
          cand.lc = lc1;
          cand.var = 1.0f;
        }
      }
      if (!live) cand.gain = -INFINITY;
    }
    red[t] = cand;
    __syncthreads();
    for (int s = nthreads >> 1; s > 0; s >>= 1) {
      if (t < s && better(red[t + s], red[t])) red[t] = red[t + s];
      __syncthreads();
    }
    if (t == 0 && better(red[0], best)) best = red[0];
    __syncthreads();
  }

  if (t == 0) {
    float* o = out + (long long)leaf * kPacked;
    o[0] = best.gain;
    o[1] = (float)(best.lane / B);
    o[2] = (float)(best.lane % B);
    // the reference picks the winner's values by a one-hot sum: + 0.0
    o[3] = __fadd_rn(best.var, 0.0f);
    o[4] = __fadd_rn(best.lg, 0.0f);
    o[5] = __fadd_rn(best.lh, 0.0f);
    o[6] = __fadd_rn(best.lc, 0.0f);
    o[7] = 0.0f;
  }
}

}  // namespace

extern "C" int lgbm_split_scan(const void* grid, int L2, int F, int B,
                               const void* lsg, const void* lsh,
                               const void* lcnt, const void* num_bins,
                               const void* missing_types,
                               const void* default_bins, const void* fmask,
                               float l1, float l2, float min_d, float min_he,
                               int any_missing, void* out, int threads,
                               void* stream) {
  if (B < 1 || (B & (B - 1)) || B > threads || threads > kMaxThreads ||
      (threads & (threads - 1)))
    return (int)cudaErrorInvalidValue;
  if (L2 <= 0) return (int)cudaGetLastError();
  split_scan_kernel<<<L2, threads, 0, (cudaStream_t)stream>>>(
      (const float*)grid, F, B, (const float*)lsg, (const float*)lsh,
      (const float*)lcnt, (const int*)num_bins, (const int*)missing_types,
      (const int*)default_bins, (const uint8_t*)fmask, l1, l2, min_d, min_he,
      any_missing, (float*)out);
  return (int)cudaGetLastError();
}
