// Native text-data parser of lightgbm_tpu_torch (a copy of the JAX
// package's native/parser.cpp).
//
// Counterpart of the reference's C++ ingest machinery (src/io/parser.cpp
// CSV/TSV/LibSVM parsers, include/LightGBM/utils/text_reader.h buffered
// line reader): the hot parse loop stays native while Python
// orchestrates.  Exposed as a tiny C ABI consumed through ctypes (no
// pybind11 dependency).
//
// Locale-independent float parsing via strtod on the "C" locale contract
// (mirroring Common::Atof, include/LightGBM/utils/common.h).
//
// Build (native/__init__.py does it at first use):
//   g++ -O3 -shared -fPIC [-fopenmp] -o ltpu_parser.so parser.cpp
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Read a whole file into memory; returns nullptr on failure.
char* read_file(const char* path, size_t* out_len) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long len = std::ftell(f);
  if (len < 0) { std::fclose(f); return nullptr; }
  std::fseek(f, 0, SEEK_SET);
  char* buf = static_cast<char*>(std::malloc(static_cast<size_t>(len) + 1));
  if (!buf) { std::fclose(f); return nullptr; }
  size_t got = std::fread(buf, 1, static_cast<size_t>(len), f);
  std::fclose(f);
  buf[got] = '\0';
  *out_len = got;
  return buf;
}

// Consume a blank (empty or whitespace-only) line at p; returns whether
// one was consumed.  Blank lines are not rows (text_reader semantics).
inline bool skip_blank_line(const char*& p, const char* end) {
  const char* q = p;
  while (q < end && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
  if (q >= end) { p = q; return true; }
  if (*q == '\n') { p = q + 1; return true; }
  return false;
}

inline const char* skip_lines(const char* p, const char* end, long n) {
  while (n > 0 && p < end) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!nl) return end;
    p = nl + 1;
    --n;
  }
  return p;
}

// Parse one field ending at `delim`/newline; empty or unparseable -> NaN.
// The field is bounded FIRST: strtod skips leading whitespace (including
// '\t' and '\n'), so an unbounded call would swallow the next field of a
// tab-separated line when this one is empty.
inline double parse_field(const char*& p, const char* end, char delim,
                          bool* line_done) {
  const char* q = p;
  while (q < end && *q != delim && *q != '\n' && *q != '\r') ++q;
  double v;
  if (q == p) {
    v = std::nan("");                       // empty field
  } else {
    char* next = nullptr;
    v = std::strtod(p, &next);
    const char* t = next;
    while (t < q && (*t == ' ' || *t == '\t')) ++t;   // trailing whitespace ok
    // junk, crossed bound, or trailing garbage ("1.5abc") -> NaN, matching
    // the np.genfromtxt fallback
    if (next == p || next > q || t != q) v = std::nan("");
  }
  if (q < end && *q == delim) {
    p = q + 1;
    *line_done = false;
  } else {
    while (q < end && *q == '\r') ++q;
    p = (q < end && *q == '\n') ? q + 1 : q;
    *line_done = true;
  }
  return v;
}

}  // namespace

extern "C" {

// Parse a delimiter-separated numeric file -> row-major [rows, cols]
// doubles (missing/na fields = NaN, genfromtxt semantics).  Returns the
// row count (<0 on error); *out_data is malloc'd, caller frees via
// ltpu_free.  cols = field count of the first data line.
long ltpu_parse_delimited(const char* path, char delim, long skip,
                          double** out_data, long* out_cols) {
  size_t len = 0;
  char* buf = read_file(path, &len);
  if (!buf) return -1;
  const char* end = buf + len;
  const char* p = skip_lines(buf, end, skip);

  // count columns from the first non-empty data line
  long cols = 0;
  {
    const char* q = p;
    while (q < end && (*q == '\n' || *q == '\r')) ++q;
    if (q >= end) { std::free(buf); *out_cols = 0; return 0; }
    const char* scan = q;
    bool done = false;
    while (!done && scan < end) {
      parse_field(scan, end, delim, &done);
      ++cols;
    }
  }

  std::vector<double> data;
  data.reserve(1 << 20);
  long rows = 0;
  while (p < end) {
    if (*p == '\n' || *p == '\r') { ++p; continue; }
    if (skip_blank_line(p, end)) continue;
    bool done = false;
    long c = 0;
    while (c < cols && !(done && c > 0)) {
      data.push_back(parse_field(p, end, delim, &done));
      ++c;
    }
    // inconsistent column count: fail loudly like np.genfromtxt
    // (the Python wrapper falls back, which raises the descriptive error)
    if (c < cols || !done) { std::free(buf); return -3; }
    ++rows;
  }
  std::free(buf);

  double* out = static_cast<double*>(std::malloc(data.size() * sizeof(double)));
  if (!out && !data.empty()) return -2;
  std::memcpy(out, data.data(), data.size() * sizeof(double));
  *out_data = out;
  *out_cols = cols;
  return rows;
}

// Parse LibSVM "label idx:val ..." -> dense row-major [rows, max_idx+1]
// doubles + labels.  Returns row count (<0 on error).
long ltpu_parse_libsvm(const char* path, long skip, double** out_x,
                       long* out_cols, double** out_labels) {
  size_t len = 0;
  char* buf = read_file(path, &len);
  if (!buf) return -1;
  const char* end = buf + len;
  const char* start = skip_lines(buf, end, skip);

  // pass 1: rows + max feature index
  long rows = 0, max_idx = -1;
  for (const char* p = start; p < end;) {
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    ++rows;
    while (p < end && *p != '\n') {
      if (*p == ':') {
        const char* q = p - 1;
        while (q > start && q[-1] >= '0' && q[-1] <= '9') --q;
        long idx = std::strtol(q, nullptr, 10);
        if (idx > max_idx) max_idx = idx;
      }
      ++p;
    }
  }
  long cols = max_idx + 1;
  double* X = static_cast<double*>(
      std::calloc(static_cast<size_t>(rows) * (cols > 0 ? cols : 1),
                  sizeof(double)));
  double* y = static_cast<double*>(std::malloc(
      static_cast<size_t>(rows) * sizeof(double)));
  if ((!X && rows * cols > 0) || !y) { std::free(buf); return -2; }

  // pass 2: fill
  long r = 0;
  for (const char* p = start; p < end && r < rows;) {
    while (p < end && (*p == '\n' || *p == '\r')) ++p;
    if (p >= end) break;
    char* next = nullptr;
    y[r] = std::strtod(p, &next);
    p = next;
    while (p < end && *p != '\n') {
      while (p < end && *p == ' ') ++p;
      if (p >= end || *p == '\n' || *p == '\r') break;
      char* q = nullptr;
      long idx = std::strtol(p, &q, 10);
      if (q && q < end && *q == ':') {
        double v = std::strtod(q + 1, &next);
        if (idx >= 0 && idx < cols) X[r * cols + idx] = v;
        p = next;
      } else {
        while (p < end && *p != ' ' && *p != '\n' && *p != '\r') ++p;
      }
    }
    ++r;
  }
  std::free(buf);
  *out_x = X;
  *out_labels = y;
  *out_cols = cols;
  return rows;
}

// Chunked delimited parse for two-round / low-memory loading (the
// reference's pattern: utils/pipeline_reader.h bounded double-buffered
// reads + dataset_loader.cpp:698-742 two-round flow).  Reads at most
// `max_bytes` from `offset`, parses the COMPLETE rows in the buffer and
// reports where the next chunk starts.  `skip` header lines are consumed
// only when offset == 0.  `expect_cols` < 0 derives the column count
// from the first data line (returned via *out_cols either way).
// Returns rows parsed (0 at EOF), or <0: -1 open/seek failure,
// -3 inconsistent columns, -4 a single row exceeds max_bytes.
long ltpu_parse_delimited_chunk(const char* path, char delim,
                                long long offset, long skip,
                                long max_bytes, long expect_cols,
                                double** out_data, long* out_cols,
                                long long* out_next) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (std::fseek(f, static_cast<long>(offset), SEEK_SET) != 0) {
    std::fclose(f);
    return -1;
  }
  char* buf = static_cast<char*>(std::malloc(static_cast<size_t>(max_bytes) + 1));
  if (!buf) { std::fclose(f); return -2; }
  size_t got = std::fread(buf, 1, static_cast<size_t>(max_bytes), f);
  bool at_eof = (std::feof(f) != 0);
  std::fclose(f);
  buf[got] = '\0';

  const char* end = buf + got;
  // only parse up to the last complete line unless the file ends here
  if (!at_eof) {
    const char* last_nl = end;
    while (last_nl > buf && last_nl[-1] != '\n') --last_nl;
    if (last_nl == buf) { std::free(buf); return got ? -4 : 0; }
    end = last_nl;
  }

  const char* p = buf;
  if (offset == 0) p = skip_lines(p, end, skip);

  long cols = expect_cols;
  if (cols < 0) {
    const char* q = p;
    while (q < end && (*q == '\n' || *q == '\r')) ++q;
    if (q >= end) { std::free(buf); *out_cols = 0; *out_next = offset + (end - buf); return 0; }
    const char* scan = q;
    bool done = false;
    cols = 0;
    while (!done && scan < end) {
      parse_field(scan, end, delim, &done);
      ++cols;
    }
  }

  std::vector<double> data;
  data.reserve(1 << 16);
  long rows = 0;
  while (p < end) {
    if (*p == '\n' || *p == '\r') { ++p; continue; }
    if (skip_blank_line(p, end)) continue;
    bool done = false;
    long c = 0;
    while (c < cols && !(done && c > 0)) {
      data.push_back(parse_field(p, end, delim, &done));
      ++c;
    }
    if (c < cols || !done) { std::free(buf); return -3; }
    ++rows;
  }
  *out_next = offset + (p - buf);
  std::free(buf);

  *out_cols = cols;
  if (rows == 0) return 0;     // nothing to hand out (caller won't free)
  double* out = static_cast<double*>(std::malloc(
      data.size() * sizeof(double)));
  if (!out) return -2;
  std::memcpy(out, data.data(), data.size() * sizeof(double));
  *out_data = out;
  return rows;
}

// Bounded-memory LibSVM scan: data row count + max feature index
// (the two-round flow's round 0 — the whole file is never resident).
// Row semantics match ltpu_parse_libsvm's pass 1: any line that is not
// purely \n/\r counts.  Returns rows (<0 on error), *out_max_idx = -1
// when no "idx:" token exists.
long ltpu_scan_libsvm(const char* path, long skip, long* out_max_idx) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  size_t cap = 4u << 20;
  char* buf = static_cast<char*>(std::malloc(cap + 1));
  if (!buf) { std::fclose(f); return -2; }
  long rows = 0, max_idx = -1, to_skip = skip;
  size_t have = 0;
  bool eof = false;
  while (!eof || have) {
    if (!eof) {
      size_t got = std::fread(buf + have, 1, cap - have, f);
      have += got;
      eof = (std::feof(f) != 0);
    }
    const char* end = buf + have;
    const char* lim = end;
    if (!eof) {
      while (lim > buf && lim[-1] != '\n') --lim;
      if (lim == buf) {                  // one line longer than cap: grow
        cap *= 2;
        char* nb2 = static_cast<char*>(std::realloc(buf, cap + 1));
        if (!nb2) { std::free(buf); std::fclose(f); return -2; }
        buf = nb2;
        continue;
      }
    }
    const char* p = buf;
    while (p < lim) {
      const char* nl = static_cast<const char*>(
          std::memchr(p, '\n', lim - p));
      const char* le = nl ? nl : lim;
      if (to_skip > 0) {
        --to_skip;
      } else {
        bool content = false;
        for (const char* q = p; q < le; ++q)
          if (*q != '\r') { content = true; break; }
        if (content) {
          ++rows;
          for (const char* c = p; c < le; ++c) {
            if (*c == ':') {
              const char* d = c;
              while (d > p && d[-1] >= '0' && d[-1] <= '9') --d;
              if (d < c) {
                long idx = std::strtol(d, nullptr, 10);
                if (idx > max_idx) max_idx = idx;
              }
            }
          }
        }
      }
      if (!nl) break;
      p = nl + 1;
    }
    size_t rem = static_cast<size_t>(end - lim);
    std::memmove(buf, lim, rem);
    have = rem;
    if (eof) break;
  }
  std::free(buf);
  std::fclose(f);
  *out_max_idx = max_idx;
  return rows;
}

// Chunked LibSVM parse (two-round round 1/2): COMBINED dense
// [rows, 1 + cols] doubles with the label in column 0, so the caller's
// delimited-chunk machinery (label_idx = 0) applies unchanged.  Framing
// mirrors ltpu_parse_delimited_chunk: reads at most `max_bytes` from
// `offset`, parses the complete rows, reports where the next chunk
// starts; `skip` header lines consumed only at offset 0.
long ltpu_parse_libsvm_chunk(const char* path, long long offset, long skip,
                             long max_bytes, long cols, double** out_data,
                             long long* out_next) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (std::fseek(f, static_cast<long>(offset), SEEK_SET) != 0) {
    std::fclose(f);
    return -1;
  }
  char* buf = static_cast<char*>(
      std::malloc(static_cast<size_t>(max_bytes) + 1));
  if (!buf) { std::fclose(f); return -2; }
  size_t got = std::fread(buf, 1, static_cast<size_t>(max_bytes), f);
  bool at_eof = (std::feof(f) != 0);
  std::fclose(f);
  buf[got] = '\0';

  const char* end = buf + got;
  if (!at_eof) {
    const char* last_nl = end;
    while (last_nl > buf && last_nl[-1] != '\n') --last_nl;
    if (last_nl == buf) { std::free(buf); return got ? -4 : 0; }
    end = last_nl;
  }
  const char* p = buf;
  if (offset == 0) p = skip_lines(p, end, skip);

  const long width = cols + 1;
  std::vector<double> data;
  data.reserve(1 << 16);
  long rows = 0;
  while (p < end) {
    if (*p == '\n' || *p == '\r') { ++p; continue; }
    size_t base = data.size();
    data.resize(base + static_cast<size_t>(width), 0.0);
    // skip leading blanks WITHIN the line only: a whitespace-only line
    // is a (label 0, no features) row — strtod would skip across the
    // newline and swallow the next line's label, desyncing the row
    // count from the scan's
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
    if (p >= end || *p == '\n' || *p == '\r') { ++rows; continue; }
    char* next = nullptr;
    data[base] = std::strtod(p, &next);     // complete lines: strtod
    p = next;                               // stops at '\n' at worst
    while (p < end && *p != '\n') {
      while (p < end && *p == ' ') ++p;
      if (p >= end || *p == '\n' || *p == '\r') break;
      char* q = nullptr;
      long idx = std::strtol(p, &q, 10);
      if (q && q < end && *q == ':') {
        double v = std::strtod(q + 1, &next);
        if (idx >= 0 && idx < cols) data[base + 1 + idx] = v;
        p = next;
      } else {
        while (p < end && *p != ' ' && *p != '\n' && *p != '\r') ++p;
      }
    }
    ++rows;
  }
  *out_next = offset + (p - buf);
  std::free(buf);
  if (rows == 0) return 0;
  double* out = static_cast<double*>(
      std::malloc(data.size() * sizeof(double)));
  if (!out) return -2;
  std::memcpy(out, data.data(), data.size() * sizeof(double));
  *out_data = out;
  return rows;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Exact TreeSHAP over flat tree arrays (the native hot loop behind
// boosting/contrib.py — the reference runs the same polynomial-time
// algorithm in C++, src/io/tree.cpp TreeSHAP).  The Python layer dedups
// rows into distinct per-node decision PATTERNS; this runs the
// recursion once per pattern.
// ---------------------------------------------------------------------------
namespace {

struct ShapPath {
  int feature_index;
  double zero_fraction;
  double one_fraction;
  double pweight;
};

struct ShapTree {
  long m, L, F;
  const unsigned char* D;       // current pattern row [m]
  const int* split_feature;     // [m]
  const int* left_child;        // [m] (<0 == ~leaf)
  const int* right_child;       // [m]
  const double* leaf_value;     // [L]
  const double* internal_count; // [m]
  const double* leaf_count;     // [L]
};

void shap_extend(std::vector<ShapPath>& path, int unique_depth,
                 double zero_fraction, double one_fraction,
                 int feature_index) {
  path.push_back({feature_index, zero_fraction, one_fraction,
                  unique_depth == 0 ? 1.0 : 0.0});
  for (int i = unique_depth - 1; i >= 0; --i) {
    path[i + 1].pweight += one_fraction * path[i].pweight * (i + 1)
                           / (unique_depth + 1);
    path[i].pweight = zero_fraction * path[i].pweight
                      * (unique_depth - i) / double(unique_depth + 1);
  }
}

void shap_unwind(std::vector<ShapPath>& path, int unique_depth,
                 int path_index) {
  double one_fraction = path[path_index].one_fraction;
  double zero_fraction = path[path_index].zero_fraction;
  double next_one_portion = path[unique_depth].pweight;
  for (int i = unique_depth - 1; i >= 0; --i) {
    if (one_fraction != 0.0) {
      double tmp = path[i].pweight;
      path[i].pweight = next_one_portion * (unique_depth + 1)
                        / ((i + 1) * one_fraction);
      next_one_portion = tmp - path[i].pweight * zero_fraction
                         * (unique_depth - i) / double(unique_depth + 1);
    } else {
      path[i].pweight = path[i].pweight * (unique_depth + 1)
                        / (zero_fraction * (unique_depth - i));
    }
  }
  for (int i = path_index; i < unique_depth; ++i) {
    path[i].feature_index = path[i + 1].feature_index;
    path[i].zero_fraction = path[i + 1].zero_fraction;
    path[i].one_fraction = path[i + 1].one_fraction;
  }
  path.pop_back();
}

double shap_unwound_sum(const std::vector<ShapPath>& path, int unique_depth,
                        int path_index) {
  double one_fraction = path[path_index].one_fraction;
  double zero_fraction = path[path_index].zero_fraction;
  double next_one_portion = path[unique_depth].pweight;
  double total = 0.0;
  for (int i = unique_depth - 1; i >= 0; --i) {
    if (one_fraction != 0.0) {
      double tmp = next_one_portion * (unique_depth + 1)
                   / ((i + 1) * one_fraction);
      total += tmp;
      next_one_portion = path[i].pweight - tmp * zero_fraction
                         * ((unique_depth - i) / double(unique_depth + 1));
    } else {
      total += path[i].pweight / zero_fraction
               / ((unique_depth - i) / double(unique_depth + 1));
    }
  }
  return total;
}

double shap_node_count(const ShapTree& t, int node) {
  if (node < 0) return t.leaf_count[~node];
  return t.internal_count[node];
}

void shap_recurse(const ShapTree& t, double* phi, int node,
                  int unique_depth, const std::vector<ShapPath>& parent,
                  double parent_zero_fraction, double parent_one_fraction,
                  int parent_feature_index) {
  std::vector<ShapPath> path(parent);
  shap_extend(path, unique_depth, parent_zero_fraction,
              parent_one_fraction, parent_feature_index);

  if (node < 0) {                      // leaf
    double lv = t.leaf_value[~node];
    for (int i = 1; i <= unique_depth; ++i) {
      double w = shap_unwound_sum(path, unique_depth, i);
      const ShapPath& el = path[i];
      phi[el.feature_index] += w * (el.one_fraction - el.zero_fraction)
                               * lv;
    }
    return;
  }

  int hot = t.D[node] ? t.left_child[node] : t.right_child[node];
  int cold = t.D[node] ? t.right_child[node] : t.left_child[node];
  double w = t.internal_count[node];
  double hot_count = shap_node_count(t, hot);
  double cold_count = shap_node_count(t, cold);

  double incoming_zero_fraction = 1.0;
  double incoming_one_fraction = 1.0;
  int feature = t.split_feature[node];
  int path_index = -1;
  for (int i = 1; i <= unique_depth; ++i) {
    if (path[i].feature_index == feature) { path_index = i; break; }
  }
  if (path_index >= 0) {
    incoming_zero_fraction = path[path_index].zero_fraction;
    incoming_one_fraction = path[path_index].one_fraction;
    shap_unwind(path, unique_depth, path_index);
    unique_depth -= 1;
  }

  shap_recurse(t, phi, hot, unique_depth + 1, path,
               hot_count / w * incoming_zero_fraction,
               incoming_one_fraction, feature);
  shap_recurse(t, phi, cold, unique_depth + 1, path,
               cold_count / w * incoming_zero_fraction, 0.0, feature);
}

}  // namespace

extern "C" {

// phi_out [P, F+1] must be pre-zeroed; returns 0 on success.
long ltpu_treeshap(long P, long m, long L, long F,
                   const unsigned char* D, const int* split_feature,
                   const int* left_child, const int* right_child,
                   const double* leaf_value, const double* internal_count,
                   const double* leaf_count, double* phi_out) {
  // patterns are independent (disjoint phi rows): parallelize like the
  // reference's OpenMP row loop (tree.cpp PredictContrib callers)
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
  for (long p = 0; p < P; ++p) {
    ShapTree t{m, L, F, D + p * m, split_feature, left_child, right_child,
               leaf_value, internal_count, leaf_count};
    std::vector<ShapPath> empty;
    shap_recurse(t, phi_out + p * (F + 1), 0, 0, empty, 1.0, 1.0, -1);
  }
  return 0;
}

void ltpu_free(double* p) { std::free(p); }

}  // extern "C"
