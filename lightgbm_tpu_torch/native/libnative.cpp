// The port's host data path: text parsing, value-to-bin mapping and the
// tree-by-tree host walk, behind a plain C interface for ctypes.
//
// The counterpart of the JAX package's native library (ref: upstream
// LightGBM src/io/parser.cpp CSVParser/TSVParser/LibSVMParser with
// Parser::CreateParser's auto-detection; src/io/dataset_loader.cpp
// LoadFromFile; utils/pipeline_reader.h PipelineReader; bin.h
// BinMapper::ValueToBin; src/application/predictor.hpp Predictor).  Every
// entry has a plain numpy version in native/__init__.py that states what
// it computes; the two agree bit for bit.
//
// Built on first use by native/__init__.py with the system g++
// (`-O3 -shared -fPIC -std=c++17`, `-fopenmp` when the toolchain has it).
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <strings.h>
#include <string>
#include <vector>
#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// bumped with any change of an exported signature; the loader checks it
int32_t lgbt_abi_version() { return 1; }

// ---------------------------------------------------------------- parsing
// The delimiter of a dense file: ',' unless tabs or spaces are more
// frequent on its first non-empty line.
static char detect_delim(const std::string &line) {
  size_t commas = 0, tabs = 0, spaces = 0;
  for (char c : line) {
    if (c == ',') commas++;
    else if (c == '\t') tabs++;
    else if (c == ' ') spaces++;
  }
  if (commas >= tabs && commas >= spaces) return ',';
  if (tabs >= spaces) return '\t';
  return ' ';
}

// One field starting at s (the field ends at `end`; strtod reads the rest
// of the line): leading spaces and quotes skipped, empty / "na..." / "?"
// as NaN, else strtod.  False when strtod converts nothing.
static bool parse_field(const char *s, const char *end, double *out) {
  while (s < end && (*s == ' ' || *s == '"')) s++;
  if (s >= end) { *out = NAN; return true; }
  if (strncasecmp(s, "na", 2) == 0 || *s == '?') { *out = NAN; return true; }
  char *stop = nullptr;
  double v = strtod(s, &stop);
  if (stop == s) return false;
  *out = v;
  return true;
}

// One whole line (of any length) without its trailing '\r' / '\n'; false
// at the end of the file.
static bool read_line(FILE *f, std::string &line) {
  char buf[1 << 16];
  if (!fgets(buf, sizeof(buf), f)) return false;
  line.assign(buf);
  while (!line.empty() && line.back() != '\n' &&
         fgets(buf, sizeof(buf), f)) line += buf;
  while (!line.empty() && (line.back() == '\n' || line.back() == '\r'))
    line.pop_back();
  return true;
}

// The fields of one line; false on a field that does not parse.
static bool split_fields(const std::string &line, char delim,
                         std::vector<double> &vals) {
  vals.clear();
  const char *p = line.c_str();
  const char *end = p + line.size();
  while (p <= end) {
    const char *q = p;
    while (q < end && *q != delim) q++;
    double v;
    if (!parse_field(p, q, &v)) return false;
    vals.push_back(v);
    if (q >= end) break;
    p = q + 1;
  }
  return true;
}

// A dense CSV / TSV / space-separated file.  Two calls: with out == nullptr
// it counts rows and columns; then out holds rows * cols doubles, row
// major.  A first line that does not parse is a header (skipped, flagged
// in *had_header); empty lines are skipped.  Returns 0, or -1 (no file),
// -2 (a line mid-file does not parse), -3 (a line's width differs), -4
// (more rows than the probe counted).
int64_t lgbt_parse_dense(const char *path, double *out, int64_t *n_rows,
                         int64_t *n_cols, int32_t *had_header) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  std::string line;
  line.reserve(1 << 16);
  char delim = 0;
  int64_t rows = 0, cols = 0;
  const bool probing = (out == nullptr);
  const int64_t cap = probing ? 0 : (*n_rows) * (*n_cols);
  int64_t written = 0;
  *had_header = 0;
  bool first = true;
  std::vector<double> vals;
  while (read_line(f, line)) {
    if (line.empty()) continue;
    if (!delim) delim = detect_delim(line);
    if (!split_fields(line, delim, vals)) {
      if (first) { *had_header = 1; first = false; continue; }
      fclose(f);
      return -2;
    }
    first = false;
    if (cols == 0) cols = (int64_t)vals.size();
    if ((int64_t)vals.size() != cols) { fclose(f); return -3; }
    if (!probing) {
      if (written + cols > cap) { fclose(f); return -4; }
      memcpy(out + written, vals.data(), cols * sizeof(double));
    }
    written += cols;
    rows++;
  }
  fclose(f);
  *n_rows = rows;
  *n_cols = cols;
  return 0;
}

// A LibSVM file, "label idx:val idx:val ... [# comment]", dense into out
// [rows, cols + 1] with the label in column 0 and absent entries 0.  The
// probe call (out == nullptr) counts rows, sets *n_cols and *zero_based
// (an index 0 anywhere: the indices are 0-based); the fill call reads
// both.  Returns 0, or -1 (no file), -2 (a label does not parse), -3 (an
// index, or its ':'), -4 (a value).
int64_t lgbt_parse_libsvm(const char *path, double *out, int64_t *n_rows,
                          int64_t *n_cols, int32_t *zero_based) {
  FILE *f = fopen(path, "rb");
  if (!f) return -1;
  char buf[1 << 16];
  std::string line;
  int64_t rows = 0, max_idx = -1;
  const bool probing = (out == nullptr);
  const int64_t cols = probing ? 0 : *n_cols;
  const int64_t shift = (!probing && *zero_based) ? 1 : 0;
  bool saw_zero = false;
  while (fgets(buf, sizeof(buf), f)) {
    line.assign(buf);
    while (!line.empty() && line.back() != '\n' &&
           fgets(buf, sizeof(buf), f)) line += buf;
    if (line.find_first_not_of(" \t\r\n") == std::string::npos) continue;
    const char *p = line.c_str();
    char *stop = nullptr;
    const double label = strtod(p, &stop);
    if (stop == p) { fclose(f); return -2; }
    double *row = probing ? nullptr : out + rows * (cols + 1);
    if (!probing) {
      memset(row, 0, (cols + 1) * sizeof(double));
      row[0] = label;
    }
    p = stop;
    while (*p) {
      while (*p == ' ' || *p == '\t') p++;
      if (*p == '\0' || *p == '\n' || *p == '\r' || *p == '#') break;
      const long idx = strtol(p, &stop, 10);
      if (stop == p || *stop != ':') { fclose(f); return -3; }
      p = stop + 1;
      const double v = strtod(p, &stop);
      if (stop == p) { fclose(f); return -4; }
      p = stop;
      if (idx == 0) saw_zero = true;
      if (idx > max_idx) max_idx = idx;
      if (!probing) {
        const int64_t col = idx + shift;
        if (col >= 1 && col <= cols) row[col] = v;
      }
    }
    rows++;
  }
  fclose(f);
  *n_rows = rows;
  if (probing) {
    *zero_based = saw_zero ? 1 : 0;
    if (max_idx < 0) *n_cols = 0;
    else *n_cols = saw_zero ? (max_idx + 1) : max_idx;
  }
  return 0;
}

// ----------------------------------------------------------- chunked read
// A dense file read in row chunks (two_round ingest): open once, then
// pull up to max_rows rows a call into the caller's buffer.
struct LgbtStream {
  FILE *f;
  char delim;
  int64_t cols;
  std::vector<double> vals;
};

// Opens `path`, reads its delimiter and width from the first data line
// (a first line that does not parse is a header: skipped and flagged),
// and rewinds to that line.  nullptr when the file cannot be read or has
// no data line.
void *lgbt_stream_open(const char *path, int64_t *n_cols,
                       int32_t *had_header) {
  FILE *f = fopen(path, "rb");
  if (!f) return nullptr;
  LgbtStream *s = new LgbtStream();
  s->f = f;
  s->delim = 0;
  s->cols = 0;
  *had_header = 0;
  std::string line;
  long data_start = 0;
  while (read_line(f, line)) {
    if (line.empty()) { data_start = ftell(f); continue; }
    if (!s->delim) s->delim = detect_delim(line);
    if (!split_fields(line, s->delim, s->vals)) {
      if (!*had_header) {
        *had_header = 1;
        data_start = ftell(f);
        continue;
      }
      fclose(f); delete s; return nullptr;
    }
    s->cols = (int64_t)s->vals.size();
    break;
  }
  if (s->cols == 0) { fclose(f); delete s; return nullptr; }
  fseek(f, data_start, SEEK_SET);
  *n_cols = s->cols;
  return s;
}

// The next rows into out [max_rows, cols]: their count (0 at the end), or
// -2 (a line does not parse), -3 (a line's width differs).
int64_t lgbt_stream_next(void *handle, double *out, int64_t max_rows) {
  LgbtStream *s = (LgbtStream *)handle;
  std::string line;
  int64_t rows = 0;
  while (rows < max_rows && read_line(s->f, line)) {
    if (line.empty()) continue;
    if (!split_fields(line, s->delim, s->vals)) return -2;
    if ((int64_t)s->vals.size() != s->cols) return -3;
    memcpy(out + rows * s->cols, s->vals.data(), s->cols * sizeof(double));
    rows++;
  }
  return rows;
}

void lgbt_stream_close(void *handle) {
  LgbtStream *s = (LgbtStream *)handle;
  if (s) {
    fclose(s->f);
    delete s;
  }
}

// ------------------------------------------------------------ bin mapping
// Each value's bin: the first of the inclusive upper bounds that it does
// not exceed (bounds ascending, the last +inf), by binary search.  NaN
// goes to nan_bin when missing_type is 2 (NaN), else is searched as 0.0.
// Long columns spread over OpenMP threads; each value's bin depends on
// that value alone.
void lgbt_values_to_bins(const double *vals, int64_t n, const double *bounds,
                         int32_t n_bounds, int32_t missing_type,
                         int32_t nan_bin, uint16_t *out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n > 65536)
#endif
  for (int64_t i = 0; i < n; ++i) {
    double v = vals[i];
    if (std::isnan(v)) {
      if (missing_type == 2) { out[i] = (uint16_t)nan_bin; continue; }
      v = 0.0;
    }
    int32_t lo = 0, hi = n_bounds - 1;
    while (lo < hi) {
      const int32_t mid = (lo + hi) >> 1;
      if (v <= bounds[mid]) hi = mid; else lo = mid + 1;
    }
    out[i] = (uint16_t)lo;
  }
}

// ---------------------------------------------------------- the host walk
// Raw scores of X [n_rows, n_feat] f64: each row walks every tree (the
// trees' nodes and leaves concatenated, with offsets) and adds its leaf
// value into class t % k_classes, trees in boosting order.  The decisions
// are tree.h's NumericalDecision and CategoricalDecision (decision_type
// bit 0: categorical, bit 1: default left, bits 2-3: missing type).  Rows
// are spread over OpenMP threads (`num_threads` <= 0: the default); a
// row's sum never depends on the thread count.
static const double kZeroThreshold = 1e-35;

void lgbt_predict_rows(
    const int32_t *feat, const double *thr, const int32_t *dtype,
    const int32_t *left, const int32_t *right, const int32_t *thr_bin,
    const double *leaf_value, const int64_t *node_off,
    const int64_t *leaf_off, const int64_t *cb_off,
    const int64_t *cat_bounds, const int64_t *bits_off,
    const uint32_t *cat_bits, int64_t n_trees, int64_t k_classes,
    int32_t num_threads, const double *X, int64_t n_rows, int64_t n_feat,
    double *out) {
  // few rows stay out of the parallel region: no fork of the thread
  // team for a short request, and a forked child that predicts a few
  // rows never touches libgomp
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (n_rows > 64) \
    num_threads(num_threads > 0 ? num_threads : omp_get_max_threads())
#else
  (void)num_threads;
#endif
  for (int64_t r = 0; r < n_rows; ++r) {
    const double *x = X + r * n_feat;
    double *acc = out + r * k_classes;
    for (int64_t k = 0; k < k_classes; ++k) acc[k] = 0.0;
    for (int64_t t = 0; t < n_trees; ++t) {
      const int64_t nb = node_off[t];
      if (node_off[t + 1] == nb) {  // a single leaf
        acc[t % k_classes] += leaf_value[leaf_off[t]];
        continue;
      }
      int32_t nd = 0;
      while (nd >= 0) {
        const int64_t g = nb + nd;
        const double fv = x[feat[g]];
        const int32_t dt = dtype[g];
        bool go_left;
        if (dt & 1) {
          // the category's bit, range-checked in double before the
          // truncation: NaN, v <= -1 and v >= the bitset's span (also an
          // empty span) go right; (-1, 0) truncates to category 0
          const int64_t lo = cat_bounds[cb_off[t] + thr_bin[g]];
          const int64_t hi = cat_bounds[cb_off[t] + thr_bin[g] + 1];
          const double span = (double)((hi - lo) * 32);
          if (std::isnan(fv) || fv <= -1.0 || fv >= span || span <= 0.0) {
            go_left = false;
          } else {
            const int64_t v = (int64_t)fv;
            go_left =
                ((cat_bits[bits_off[t] + lo + v / 32] >> (v % 32)) & 1u);
          }
        } else {
          const int32_t missing_type = (dt >> 2) & 3;
          const bool default_left = (dt & 2) != 0;
          const bool isnan_v = std::isnan(fv);
          const double v = (isnan_v && missing_type != 2) ? 0.0 : fv;
          const bool is_missing =
              (missing_type == 1 && std::fabs(v) <= kZeroThreshold) ||
              (missing_type == 2 && isnan_v);
          go_left = is_missing ? default_left : (v <= thr[g]);
        }
        nd = go_left ? left[g] : right[g];
      }
      acc[t % k_classes] += leaf_value[leaf_off[t] + (~nd)];
    }
  }
}

}  // extern "C"
