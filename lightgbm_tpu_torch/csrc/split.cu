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
// operations per cell.  In practice it is latency: each feature is a
// chain of dependent scan steps.  The design keeps many such chains in
// flight and puts no block barrier inside one:
//   * one warp per (leaf, feature) segment; a lane holds V = B / 32
//     consecutive bins x 3 channels in registers (read as 16-byte
//     vectors where they are aligned), or, for B < 32, one bin, the
//     warp then holding 32 / B features;
//   * one block per leaf with up to 32 warps that stride over the
//     features (28 warps at F = 28: every feature of a leaf at once);
//   * prefix sums are the reference's Hillis-Steele steps
//     x + (lane >= k ? x[lane - k] : 0), each new value computed from
//     the old ones: for k < V the in-lane part from registers and the
//     part that crosses from the lane below by one shuffle, for k >= V a
//     shuffle by k / V lanes;
//   * of the missing cell's suffix scan only the adds that reach its
//     lane-0 total t run (a pairwise tree, the same adds), and its
//     broadcast is the value that scan gives every bin, t + 0.0;
//   * every add, multiply and divide is an explicitly rounded intrinsic,
//     so nvcc contracts nothing into a fused multiply-add;
//   * the argmax over (gain desc, joint lane asc) runs per lane in bin
//     order, then over the warp by shuffles, then once over the block's
//     warps in shared memory: one barrier per leaf.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMissingZero = 1;   // io/binning.py MISSING_ZERO
constexpr int kMissingNan = 2;    // io/binning.py MISSING_NAN
constexpr float kMinScore = -1e30f;
constexpr int kPacked = 8;
constexpr int kMaxBins = 256;
constexpr int kMaxWarps = 32;
constexpr unsigned kFull = 0xffffffffu;

struct Cand {
  float gain;
  int lane;                        // joint index feature * B + bin
  float lg, lh, lc, var;
};

__device__ __forceinline__ bool better(float ga, int la, float gb, int lb) {
  return ga > gb || (ga == gb && la < lb);
}

// sign(s) * max(|s| - l1, 0) squared over (h + l2), rounded op by op
__device__ __forceinline__ float gain_of(float s, float h, float l1,
                                         float l2) {
  float sg = s > 0.0f ? 1.0f : (s < 0.0f ? -1.0f : 0.0f);
  float t = __fmul_rn(sg, fmaxf(__fsub_rn(fabsf(s), l1), 0.0f));
  return __fdiv_rn(__fmul_rn(t, t), __fadd_rn(h, l2));
}

// Inclusive Hillis-Steele prefix scan of a segment of B = S * V bins held
// V to a lane (sl: the lane within its segment of S lanes).
template <int V>
__device__ __forceinline__ void scan_prefix(float (&x)[3][V], int sl,
                                            int B) {
#pragma unroll
  for (int k = 1; k < V; k <<= 1) {
    // bins j < k of a lane take bin V + j - k of the lane below
    float cross[3][V];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int j = 0; j < k; ++j) {
        const float t = __shfl_up_sync(kFull, x[c][V + j - k], 1);
        cross[c][j] = sl >= 1 ? t : 0.0f;
      }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int j = V - 1; j >= k; --j)
        x[c][j] = __fadd_rn(x[c][j], x[c][j - k]);
#pragma unroll
      for (int j = 0; j < k; ++j) x[c][j] = __fadd_rn(x[c][j], cross[c][j]);
    }
  }
  for (int k = V; k < B; k <<= 1) {
    const int d = k / V;
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = __shfl_up_sync(kFull, x[c][j], d);
        x[c][j] = __fadd_rn(x[c][j], sl >= d ? t : 0.0f);
      }
  }
}

// The missing cell's total, as the reference's inclusive suffix scan
// x + (lane < B - k ? x[lane + k] : 0) leaves it in lane 0 of the
// segment.  Only lane 0's result is read, and it depends at step k only
// on the bins that are multiples of 2k, so just those are updated:
// x[i] += x[i + k] for i a multiple of 2k (never masked), the same adds
// on the same operands in the same order.  -> lane 0 of the segment
// holds the total in x[c][0].
template <int V>
__device__ __forceinline__ void suffix_total(float (&x)[3][V], int sl,
                                             int B) {
#pragma unroll
  for (int k = 1; k < V; k <<= 1)
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int j = 0; j + k < V; j += 2 * k)
        x[c][j] = __fadd_rn(x[c][j], x[c][j + k]);
  for (int k = V; k < B; k <<= 1) {
    const int d = k / V;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float t = __shfl_down_sync(kFull, x[c][0], d);
      if ((sl & (2 * d - 1)) == 0) x[c][0] = __fadd_rn(x[c][0], t);
    }
  }
}

// V bins x 3 channels of one lane: 3 V contiguous floats
template <int V>
__device__ __forceinline__ void load_cells(const float* p, bool vec,
                                           float (&v)[3][V]) {
  float buf[3 * V];
  if ((3 * V) % 4 == 0 && vec) {
#pragma unroll
    for (int i = 0; i < 3 * V / 4; ++i) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p) + i);
      buf[4 * i] = q.x;
      buf[4 * i + 1] = q.y;
      buf[4 * i + 2] = q.z;
      buf[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 3 * V; ++i) buf[i] = __ldg(p + i);
  }
#pragma unroll
  for (int j = 0; j < V; ++j)
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c][j] = buf[3 * j + c];
}

template <int V>
__global__ void __launch_bounds__(kMaxWarps * 32) split_scan_kernel(
    const float* __restrict__ grid, int F, int B, bool vec,
    const float* __restrict__ lsg, const float* __restrict__ lsh,
    const float* __restrict__ lcnt, const int* __restrict__ num_bins,
    const int* __restrict__ missing_types,
    const int* __restrict__ default_bins,
    const uint8_t* __restrict__ fmask, float l1, float l2, float min_d,
    float min_he, int any_missing, float* __restrict__ out) {
  __shared__ Cand red[kMaxWarps];
  const int leaf = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int ln = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int S = B / V;                 // lanes per feature segment
  const int fpw = 32 / S;              // features per warp
  const int sl = ln & (S - 1);
  const int seg = ln / S;
  const float tg = lsg[leaf], th = lsh[leaf], tc = lcnt[leaf];
  Cand best = {-INFINITY, 0x7fffffff, 0.0f, 0.0f, 0.0f, 0.0f};

  // every lane of a warp walks the same groups: the shuffles converge
  for (int f0 = warp * fpw; f0 < F; f0 += nwarps * fpw) {
    const int f = f0 + seg;
    const bool live = f < F;
    int nb = 0, mt = 0, missb = -1;
    bool fm = false;
    float v[3][V];
    if (live) {
      nb = num_bins[f];
      mt = missing_types[f];
      missb = mt == kMissingNan ? nb - 1
                                : (mt == kMissingZero ? default_bins[f] : -1);
      fm = fmask[f] != 0;
      load_cells<V>(grid + (((long long)leaf * F + f) * B + sl * V) * 3,
                    vec, v);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
#pragma unroll
        for (int c = 0; c < 3; ++c) v[c][j] = 0.0f;
    }
    const int max_t = mt == kMissingNan ? nb - 2 : nb - 1;
    // masks multiply (as the reference) so signed zeros follow it
    float s[3][V], m[3][V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int b = sl * V + j;
      const bool valid = b < nb;
      const bool miss = b == missb && valid;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        s[c][j] = __fmul_rn(v[c][j], valid && !miss ? 1.0f : 0.0f);
        m[c][j] = __fmul_rn(v[c][j], miss ? 1.0f : 0.0f);
      }
    }
    // The reference moves the missing total t to lane 0 and broadcasts it
    // by a prefix scan of (t, +0, ..., +0): every bin, lane 0 too (its
    // masked steps add +0.0), sums t with +0.0s, which is t + 0.0 whatever
    // the tree (adding +0.0 again changes nothing); with one bin there is
    // no step and t stays.
    float mb[3] = {0.0f, 0.0f, 0.0f};
    if (any_missing) {
      suffix_total<V>(m, sl, B);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float t = __shfl_sync(kFull, m[c][0], ln & ~(S - 1));
        mb[c] = B > 1 ? __fadd_rn(t, 0.0f) : t;
      }
    }
    scan_prefix<V>(s, sl, B);

#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int b = sl * V + j;
      const bool miss = b == missb && b < nb;
      const bool ok_base = b < max_t && !(miss && mt == kMissingZero) && fm;
      const float lg = s[0][j], lh = s[1][j], lc = s[2][j];
      const float rg = __fsub_rn(tg, lg), rh = __fsub_rn(th, lh);
      const float rc = __fsub_rn(tc, lc);
      const bool ok = lc >= min_d && rc >= min_d && lh >= min_he &&
                      rh >= min_he && ok_base;
      float gain = kMinScore;
      if (ok)
        gain = __fadd_rn(gain_of(lg, lh, l1, l2), gain_of(rg, rh, l1, l2));
      float cg = lg, ch = lh, cc = lc, var = 0.0f;
      if (any_missing) {
        const float lg1 = __fadd_rn(lg, mb[0]);
        const float lh1 = __fadd_rn(lh, mb[1]);
        const float lc1 = __fadd_rn(lc, mb[2]);
        const float rg1 = __fsub_rn(tg, lg1), rh1 = __fsub_rn(th, lh1);
        const float rc1 = __fsub_rn(tc, lc1);
        const bool ok1 = lc1 >= min_d && rc1 >= min_d && lh1 >= min_he &&
                         rh1 >= min_he && ok_base && missb >= 0;
        float g1 = kMinScore;
        if (ok1)
          g1 = __fadd_rn(gain_of(lg1, lh1, l1, l2),
                         gain_of(rg1, rh1, l1, l2));
        if (g1 > gain) {               // ties -> variant 0
          gain = g1;
          cg = lg1;
          ch = lh1;
          cc = lc1;
          var = 1.0f;
        }
      }
      if (!live) gain = -INFINITY;
      const int lane = f * B + b;
      // bins in ascending order: a tie keeps the lower joint lane
      if (better(gain, lane, best.gain, best.lane)) {
        best.gain = gain;
        best.lane = lane;
        best.lg = cg;
        best.lh = ch;
        best.lc = cc;
        best.var = var;
      }
    }
  }

  // the warp's winner; (gain, lane) is a strict order, so the butterfly
  // leaves every lane the same maximum and one lane owns it
  float bg = best.gain;
  int bl = best.lane;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const float og = __shfl_xor_sync(kFull, bg, d);
    const int ol = __shfl_xor_sync(kFull, bl, d);
    if (better(og, ol, bg, bl)) {
      bg = og;
      bl = ol;
    }
  }
  if (best.lane == bl) red[warp] = best;
  __syncthreads();
  if (warp != 0) return;
  Cand w = ln < nwarps ? red[ln]
                       : Cand{-INFINITY, 0x7fffffff, 0.0f, 0.0f, 0.0f, 0.0f};
  bg = w.gain;
  bl = w.lane;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const float og = __shfl_xor_sync(kFull, bg, d);
    const int ol = __shfl_xor_sync(kFull, bl, d);
    if (better(og, ol, bg, bl)) {
      bg = og;
      bl = ol;
    }
  }
  if (ln < nwarps && w.lane == bl) {
    float* o = out + (long long)leaf * kPacked;
    o[0] = w.gain;
    o[1] = (float)(w.lane / B);
    o[2] = (float)(w.lane % B);
    // the reference picks the winner's values by a one-hot sum: + 0.0
    o[3] = __fadd_rn(w.var, 0.0f);
    o[4] = __fadd_rn(w.lg, 0.0f);
    o[5] = __fadd_rn(w.lh, 0.0f);
    o[6] = __fadd_rn(w.lc, 0.0f);
    o[7] = 0.0f;
  }
}

template <int V>
void launch(const float* grid, int L2, int F, int B, int warps,
            const float* lsg, const float* lsh, const float* lcnt,
            const int* num_bins, const int* missing_types,
            const int* default_bins, const uint8_t* fmask, float l1,
            float l2, float min_d, float min_he, int any_missing,
            float* out, cudaStream_t stream) {
  const bool vec = ((uintptr_t)grid & 15) == 0;
  split_scan_kernel<V><<<L2, warps * 32, 0, stream>>>(
      grid, F, B, vec, lsg, lsh, lcnt, num_bins, missing_types,
      default_bins, fmask, l1, l2, min_d, min_he, any_missing, out);
}

}  // namespace

// threads: the most threads a block may have (a multiple of 32, at most
// 1024); a leaf takes as many warps as it has feature groups, up to that.
extern "C" int lgbm_split_scan(const void* grid, int L2, int F, int B,
                               const void* lsg, const void* lsh,
                               const void* lcnt, const void* num_bins,
                               const void* missing_types,
                               const void* default_bins, const void* fmask,
                               float l1, float l2, float min_d, float min_he,
                               int any_missing, void* out, int threads,
                               void* stream) {
  if (B < 1 || (B & (B - 1)) || B > kMaxBins || threads < 32 ||
      threads > kMaxWarps * 32 || (threads & 31))
    return (int)cudaErrorInvalidValue;
  if (L2 <= 0) return (int)cudaGetLastError();
  const int fpw = B >= 32 ? 1 : 32 / B;
  const int groups = (F + fpw - 1) / fpw;
  int warps = groups < threads / 32 ? groups : threads / 32;
  if (warps < 1) warps = 1;
  const float* g = (const float*)grid;
  const float* s = (const float*)lsg;
  const float* h = (const float*)lsh;
  const float* c = (const float*)lcnt;
  const int* nb = (const int*)num_bins;
  const int* mt = (const int*)missing_types;
  const int* db = (const int*)default_bins;
  const uint8_t* fm = (const uint8_t*)fmask;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (B) {
    case 256:
      launch<8>(g, L2, F, B, warps, s, h, c, nb, mt, db, fm, l1, l2, min_d,
                min_he, any_missing, o, st);
      break;
    case 128:
      launch<4>(g, L2, F, B, warps, s, h, c, nb, mt, db, fm, l1, l2, min_d,
                min_he, any_missing, o, st);
      break;
    case 64:
      launch<2>(g, L2, F, B, warps, s, h, c, nb, mt, db, fm, l1, l2, min_d,
                min_he, any_missing, o, st);
      break;
    default:                           // B <= 32: one bin a lane
      launch<1>(g, L2, F, B, warps, s, h, c, nb, mt, db, fm, l1, l2, min_d,
                min_he, any_missing, o, st);
  }
  return (int)cudaGetLastError();
}
