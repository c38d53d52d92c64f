// Native text-data parser of lightgbm_tpu_torch: the ingestion hot path
// on the host (no device code).
//
// The reference's DatasetLoader/Parser stack (src/io/dataset_loader.cpp,
// src/io/parser.cpp, external fast_double_parser) is C++ because parsing
// large CSV/TSV files is CPU-bound; a Python float() loop is ~100x
// slower. This is the port's copy of lightgbm_tpu/native/loader.cpp: an
// OpenMP-parallel two-pass parser exposed through a C ABI (ctypes on the
// Python side, no pybind11 dependency).
//
//   pass 1: one serial scan for the line starts, rows and columns
//   pass 2: strtod per field, one row per line, parallel over rows
//
// Missing values ("", na, NA, nan, NaN, null, NULL, ?) parse to NaN.
// Built by lightgbm_tpu_torch/native/__init__.py:
//   g++ -O3 -fopenmp -shared -fPIC loader.cpp

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <locale.h>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

bool is_missing_token(const char* s, const char* end) {
  size_t n = static_cast<size_t>(end - s);
  if (n == 0) return true;
  if (n == 1 && *s == '?') return true;
  if (n == 2 && (memcmp(s, "na", 2) == 0 || memcmp(s, "NA", 2) == 0))
    return true;
  if (n == 3 && (memcmp(s, "nan", 3) == 0 || memcmp(s, "NaN", 3) == 0))
    return true;
  if (n == 4 && (memcmp(s, "null", 4) == 0 || memcmp(s, "NULL", 4) == 0))
    return true;
  return false;
}

// Locale-independent strtod: the host process may have set a non-C
// LC_NUMERIC (the reference vendors fast_double_parser for the same
// reason — '1.5' must never parse as 1.0 under de_DE).
locale_t c_locale() {
  static locale_t loc = newlocale(LC_ALL_MASK, "C", nullptr);
  return loc;
}

// Whitespace-only lines are blank (the Python loader's `ln.strip()`
// semantics): peek from a line start — true if nothing but spaces/tabs/
// CR before the newline.
bool line_is_blank(const char* buf, int64_t len, int64_t i) {
  while (i < len && buf[i] != '\n') {
    char ch = buf[i];
    if (ch != ' ' && ch != '\t' && ch != '\r') return false;
    ++i;
  }
  return true;
}

}  // namespace

extern "C" {

// ONE serial pass: count non-blank lines, the max field count, and the
// line-start offsets (into `offsets`, capacity `cap` — the caller sizes
// it from the newline count, so one pass suffices). Returns 0.
int lgbtpu_scan(const char* buf, int64_t len, char sep, int64_t* n_rows,
                int64_t* n_cols, int64_t* offsets, int64_t cap) {
  int64_t rows = 0, cols = 0;
  int64_t i = 0;
  while (i < len) {
    if (line_is_blank(buf, len, i)) {
      while (i < len && buf[i] != '\n') ++i;
      ++i;
      continue;
    }
    if (offsets != nullptr && rows < cap) offsets[rows] = i;
    int64_t c = 1;
    while (i < len && buf[i] != '\n') {
      if (buf[i] == sep) ++c;
      ++i;
    }
    ++i;
    ++rows;
    if (c > cols) cols = c;
  }
  *n_rows = rows;
  *n_cols = cols;
  return 0;
}

// Parse `buf` into out[n_rows * n_cols] (row-major f64, NaN-padded).
// line_starts must hold n_rows offsets (from lgbtpu_line_starts).
int lgbtpu_parse(const char* buf, int64_t len, char sep,
                 const int64_t* line_starts, int64_t n_rows,
                 int64_t n_cols, double* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t r = 0; r < n_rows; ++r) {
    const char* p = buf + line_starts[r];
    const char* line_end = p;
    while (line_end < buf + len && *line_end != '\n') ++line_end;
    double* row = out + r * n_cols;
    for (int64_t c = 0; c < n_cols; ++c) row[c] = NAN;
    int64_t c = 0;
    while (p <= line_end && c < n_cols) {
      const char* field_end = p;
      while (field_end < line_end && *field_end != sep) ++field_end;
      const char* a = p;
      const char* b = field_end;
      while (a < b && isspace(static_cast<unsigned char>(*a))) ++a;
      while (b > a && (isspace(static_cast<unsigned char>(b[-1]))
                       || b[-1] == '\r')) --b;
      if (!is_missing_token(a, b)) {
        // strtod directly on the buffer: it stops at the separator /
        // newline on its own (the caller's bytes are NUL-terminated),
        // so fields of any length parse without a copy. Non-numeric
        // tokens stay NaN — prefix-permissive like the reference's
        // Common::Atof parser.
        char* endp = nullptr;
        double v = strtod_l(a, &endp, c_locale());
        if (endp != a) row[c] = v;
      }
      ++c;
      if (field_end >= line_end) break;
      p = field_end + 1;
    }
  }
  return 0;
}

// Offsets of every non-blank line start. Returns the count written.
int64_t lgbtpu_line_starts(const char* buf, int64_t len,
                           int64_t* out, int64_t cap) {
  int64_t n = 0;
  int64_t i = 0;
  while (i < len) {
    if (!line_is_blank(buf, len, i)) {
      if (n < cap) out[n] = i;
      ++n;
    }
    while (i < len && buf[i] != '\n') ++i;
    ++i;
  }
  return n;
}

// Batch value->bin over sorted upper bounds (the ingestion-side analog
// of BinMapper::ValueToBin's binary search, bin.h:613): one feature's
// column at a time, OpenMP over rows.
void lgbtpu_value_to_bin(const double* vals, int64_t n,
                         const double* uppers, int32_t n_bins,
                         int32_t nan_bin, int32_t zero_bin,
                         int32_t use_zero_bin, uint8_t* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; ++i) {
    double v = vals[i];
    if (std::isnan(v)) {
      out[i] = static_cast<uint8_t>(nan_bin);
      continue;
    }
    if (use_zero_bin && v > -1e-35 && v < 1e-35) {
      out[i] = static_cast<uint8_t>(zero_bin);
      continue;
    }
    int32_t lo = 0, hi = n_bins - 1;
    while (lo < hi) {
      int32_t mid = (lo + hi) / 2;
      if (uppers[mid] < v) lo = mid + 1; else hi = mid;
    }
    out[i] = static_cast<uint8_t>(lo);
  }
}

}  // extern "C"
