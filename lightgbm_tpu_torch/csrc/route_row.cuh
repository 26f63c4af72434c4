// Per-row split application shared by the route (K2), route-values (K4)
// and fused route+histogram (K1) kernels.
//
// Replaces the per-row decision of the JAX package's Pallas route body
// (lightgbm_tpu/ops/pallas_route.py `_route_body`).  The TPU version
// selects each row's split data with a one-hot matmul against per-leaf
// tables and reads the split column with a masked sublane reduction,
// because the TPU has no cheap per-row gather.  On Hopper a thread owns
// one row: it reads the row's leaf, looks the leaf up in the tables
// (staged in shared memory), and reads one byte of the transposed bins.
// All work is integer, so the result is bitwise that of the reference's
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

// Route one row: -> (row_leaf', hist_leaf').  `tab` is the staged table,
// `rl`/`hl` the row's current leaves (-1: padding / bagged out).
// `cat_mask` is [L, Bcat] uint8 (bins going left), read only for
// categorical splits.  `bins_t` holds uint8 bins, or int32 ones where a
// group has more than 256 bins.
template <typename BinT>
__device__ __forceinline__ int2 route_row(const int* tab, int L,
                                          const BinT* bins_t,
                                          long long n_pad, long long row,
                                          int rl, int hl,
                                          const uint8_t* cat_mask,
                                          int Bcat) {
  int rl2 = rl;
  if (rl >= 0 && tab[T_SEL * L + rl]) {
    int g = tab[T_GROUP * L + rl];
    int c = bins_t[(long long)g * n_pad + row];
    int db = tab[T_DB * L + rl];
    int b = unbundle_bin(c, tab[T_OFF * L + rl], tab[T_NB * L + rl], db);
    int mt = tab[T_MT * L + rl];
    bool is_missing = (mt == LGBM_MISSING_NAN && b == tab[T_NANB * L + rl])
                      || (mt == LGBM_MISSING_ZERO && b == db);
    bool go_left;
    if (tab[T_ISCAT * L + rl]) {
      go_left = b < Bcat && cat_mask[(long long)rl * Bcat + b] != 0;
    } else if (is_missing) {
      go_left = tab[T_DL * L + rl] != 0;
    } else {
      go_left = b <= tab[T_THR * L + rl];
    }
    if (!go_left) rl2 = tab[T_NEWID * L + rl];
  }
  return make_int2(rl2, hl >= 0 ? rl2 : hl);
}
