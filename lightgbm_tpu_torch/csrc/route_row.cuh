// Per-row split application shared by the route (K2), route-values (K4)
// and fused route+histogram (K1) kernels.
//
// Replaces the per-row decision of the JAX package's Pallas route body
// (lightgbm_tpu/ops/pallas_route.py `_route_body`).  The TPU version
// selects each row's split data with a one-hot matmul against per-leaf
// tables and reads the split column with a masked sublane reduction,
// because the TPU has no cheap per-row gather.  On Hopper a thread owns
// one row: it reads the row's leaf, looks the leaf's split up, and reads
// one bin of the transposed bins.  The decision (`route_left`) is one
// function, templated on how a leaf's fields are read: from the eleven
// [L] rows of the table (`TableLeaf`, K1, staged in shared memory) or
// from a 32-byte record packed from them (`RecordLeaf`, K2/K4).  All
// work is integer, so the result is bitwise that of the reference's
// `route_rows_xla`.
#pragma once
#include <stdint.h>

// rows of the [ROUTE_TAB_ROWS, L] int32 per-leaf table (ops/route.py
// `leaf_tables` builds it in this order)
enum {
  T_GROUP = 0,   // group column of the leaf's split feature
  T_THR = 1,     // threshold bin (numerical: bin <= thr goes left)
  T_DL = 2,      // default_left for missing values
  T_ISCAT = 3,   // categorical split
  T_SEL = 4,     // leaf is split in this wave
  T_NEWID = 5,   // id of the right child
  T_OFF = 6,     // EFB offset of the feature in its group (-1: identity)
  T_NB = 7,      // number of bins of the feature
  T_DB = 8,      // default (zero) bin of the feature
  T_MT = 9,      // missing type
  T_NANB = 10,   // NaN bin of the feature (-1: none)
  ROUTE_TAB_ROWS = 11
};

#define LGBM_MISSING_ZERO 1
#define LGBM_MISSING_NAN 2

// Copy the per-leaf tables into shared memory (all threads of the block
// take part; the caller synchronises).
__device__ __forceinline__ void stage_route_tables(int* sh_tabs,
                                                   const int* tabs, int L) {
  for (int i = threadIdx.x; i < ROUTE_TAB_ROWS * L; i += blockDim.x)
    sh_tabs[i] = tabs[i];
}

// EFB inverse mapping: stored column value -> feature bin (identity when
// off < 0); the io/dataset.py BundleInfo encoding.
__device__ __forceinline__ int unbundle_bin(int col, int off, int nb,
                                           int db) {
  if (off < 0) return col;
  int rank = col - off;
  bool in_range = rank >= 0 && rank < nb - 1;
  return in_range ? rank + (rank >= db ? 1 : 0) : db;
}

// A leaf's split read from the [ROUTE_TAB_ROWS, L] table, one row per
// field (K1 reads the table staged in shared memory).
struct TableLeaf {
  const int* tab;
  int L;
  int leaf;
  __device__ __forceinline__ int field(int r) const {
    return tab[r * L + leaf];
  }
  __device__ __forceinline__ int group() const { return field(T_GROUP); }
  __device__ __forceinline__ int threshold() const { return field(T_THR); }
  __device__ __forceinline__ int new_id() const { return field(T_NEWID); }
  __device__ __forceinline__ bool categorical() const {
    return field(T_ISCAT) != 0;
  }
  __device__ __forceinline__ bool default_left() const {
    return field(T_DL) != 0;
  }
  __device__ __forceinline__ int offset() const { return field(T_OFF); }
  __device__ __forceinline__ int num_bins() const { return field(T_NB); }
  __device__ __forceinline__ int default_bin() const { return field(T_DB); }
  __device__ __forceinline__ int missing_type() const { return field(T_MT); }
  __device__ __forceinline__ int nan_bin() const { return field(T_NANB); }
};

// A leaf's split as one 32-byte record of full-width fields, two int4:
//   a = {group, threshold, right child's id, flags}
//   b = {EFB offset, number of bins, default bin, NaN bin}
// flags: REC_CAT, REC_DEFAULT_LEFT, and from bit REC_MT_SHIFT the missing
// type as the decision reads it (LGBM_MISSING_NAN, LGBM_MISSING_ZERO, or
// 0 for any other value).
#define REC_CAT 1
#define REC_DEFAULT_LEFT 2
#define REC_MT_SHIFT 2

struct RecordLeaf {
  int4 a;
  int4 b;
  __device__ __forceinline__ int group() const { return a.x; }
  __device__ __forceinline__ int threshold() const { return a.y; }
  __device__ __forceinline__ int new_id() const { return a.z; }
  __device__ __forceinline__ bool categorical() const {
    return (a.w & REC_CAT) != 0;
  }
  __device__ __forceinline__ bool default_left() const {
    return (a.w & REC_DEFAULT_LEFT) != 0;
  }
  __device__ __forceinline__ int offset() const { return b.x; }
  __device__ __forceinline__ int num_bins() const { return b.y; }
  __device__ __forceinline__ int default_bin() const { return b.z; }
  __device__ __forceinline__ int missing_type() const {
    return a.w >> REC_MT_SHIFT;
  }
  __device__ __forceinline__ int nan_bin() const { return b.w; }
};

// Pack leaf `leaf`'s split from the table into a record.
__device__ __forceinline__ RecordLeaf pack_route_record(const int* tabs,
                                                        int L, int leaf) {
  const TableLeaf t{tabs, L, leaf};
  const int mt = t.missing_type();
  const int kind = mt == LGBM_MISSING_NAN || mt == LGBM_MISSING_ZERO ? mt : 0;
  const int flags = (t.categorical() ? REC_CAT : 0)
                    | (t.default_left() ? REC_DEFAULT_LEFT : 0)
                    | kind << REC_MT_SHIFT;
  RecordLeaf r;
  r.a = make_int4(t.group(), t.threshold(), t.new_id(), flags);
  r.b = make_int4(t.offset(), t.num_bins(), t.default_bin(), t.nan_bin());
  return r;
}

// The decision: whether a row of split leaf `leaf` whose split column
// holds `c` goes left.  `cat_mask` is [L, Bcat] uint8 (bins going
// left), read only for categorical splits.
template <typename Leaf>
__device__ __forceinline__ bool route_left(const Leaf& f, int c, int leaf,
                                           const uint8_t* cat_mask,
                                           int Bcat) {
  const int db = f.default_bin();
  const int b = unbundle_bin(c, f.offset(), f.num_bins(), db);
  const int mt = f.missing_type();
  const bool is_missing = (mt == LGBM_MISSING_NAN && b == f.nan_bin())
                          || (mt == LGBM_MISSING_ZERO && b == db);
  bool go_left;
  if (f.categorical()) {
    go_left = b < Bcat && cat_mask[(long long)leaf * Bcat + b] != 0;
  } else if (is_missing) {
    go_left = f.default_left();
  } else {
    go_left = b <= f.threshold();
  }
  return go_left;
}

// Route one row: -> (row_leaf', hist_leaf').  `tab` is the staged table,
// `rl`/`hl` the row's current leaves (-1: padding / bagged out).
// `bins_t` holds uint8 bins, or int32 ones where a group has more than
// 256 bins.
template <typename BinT>
__device__ __forceinline__ int2 route_row(const int* tab, int L,
                                          const BinT* bins_t,
                                          long long n_pad, long long row,
                                          int rl, int hl,
                                          const uint8_t* cat_mask,
                                          int Bcat) {
  int rl2 = rl;
  if (rl >= 0 && tab[T_SEL * L + rl]) {
    const TableLeaf f{tab, L, rl};
    const int c = bins_t[(long long)f.group() * n_pad + row];
    if (!route_left(f, c, rl, cat_mask, Bcat)) rl2 = f.new_id();
  }
  return make_int2(rl2, hl >= 0 ? rl2 : hl);
}
