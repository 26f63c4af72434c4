/* R object access WITHOUT R headers.
 *
 * The reference R-package takes exactly this approach (for license
 * reasons it cannot include R's headers): a small helper mirroring R's
 * in-memory SEXP layout (`R-package`, `include/LightGBM/
 * R_object_helper.h`).  We keep the same contract for the same reason —
 * and it makes the shim fully compile- AND run-testable in an image
 * with no R toolchain: the tests allocate mock objects with this exact
 * layout (which IS R's vector ABI) and drive the wrappers end to end.
 *
 * Layout facts (R's public ABI for vector SEXPs, stable across R 3.x):
 *   [ 32-bit type/info word + padding | attrib ptr | gc next | gc prev |
 *     int length | int truelength | <8-byte-aligned payload...> ]
 */
#ifndef LTPU_R_OBJECT_H_
#define LTPU_R_OBJECT_H_

#include <cstdint>
#include <cstddef>

struct ltpu_rheader {
  unsigned int type : 5;       /* SEXPTYPE; 0 == NILSXP (R NULL) */
  unsigned int flags : 27;
  /* 4 bytes padding to pointer alignment */
  void* attrib;
  void* gc_next;
  void* gc_prev;
  int length;
  int truelength;
};

/* payload starts at the next 8-byte boundary after the header, exactly
 * like R's SEXPREC_ALIGN (the double forces the alignment) */
typedef union {
  struct ltpu_rheader hdr;
  double align_;
} ltpu_ralign;

typedef void* LGBM_SE;        /* opaque R object, matching the R glue */

static inline void* ltpu_r_data(LGBM_SE x) {
  return (void*)(((ltpu_ralign*)x) + 1);
}

static inline char* ltpu_r_char(LGBM_SE x) {
  return (char*)ltpu_r_data(x);
}
static inline int* ltpu_r_int(LGBM_SE x) {
  return (int*)ltpu_r_data(x);
}
static inline double* ltpu_r_real(LGBM_SE x) {
  return (double*)ltpu_r_data(x);
}
static inline int ltpu_r_as_int(LGBM_SE x) {
  return *ltpu_r_int(x);
}
static inline int ltpu_r_is_null(LGBM_SE x) {
  return ((ltpu_ralign*)x)->hdr.type == 0;
}

/* handles ride as an int64 payload (64-bit R), NULL-safe */
static inline void ltpu_r_set_ptr(LGBM_SE x, void* p) {
  *(int64_t*)ltpu_r_data(x) = (int64_t)p;
}
static inline void* ltpu_r_get_ptr(LGBM_SE x) {
  if (ltpu_r_is_null(x)) return nullptr;
  return (void*)*(int64_t*)ltpu_r_data(x);
}

#endif  /* LTPU_R_OBJECT_H_ */
