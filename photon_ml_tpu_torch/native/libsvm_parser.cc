// Native LibSVM text parser: the port's own copy of the JAX package's
// photon_ml_tpu/native/libsvm_parser.cc, built by native/build.py into the
// port's native library.
//
// It reads the whole file into one heap buffer (simple and NUL-terminable;
// see parse_body) and tokenizes with raw pointer scans (strtod/strtol); the
// Python reader (photon_ml_tpu_torch/data/libsvm.py read_libsvm) copies the
// results straight into numpy buffers and applies the same post-processing
// (label mapping, intercept append) as its Python route.
//
// Semantics mirrored exactly from data/libsvm.py parse_libsvm_line:
//   * '#' starts a comment running to end of line (tags are not needed for
//     the CSR ingest path; the Avro converter keeps the Python tokenizer);
//   * blank / comment-only lines are skipped;
//   * indices are 1-based unless zero_based, normalized to 0-based here;
//   * labels/values accept any strtod-parsable float ("+1", "1e-3", ...).
//
// C API (handle-based, single parse pass):
//   phsvm_parse(path, zero_based) -> handle (NULL on error)
//   phsvm_rows/nnz/max_index(handle) -> sizes for buffer allocation
//   phsvm_copy(handle, labels f64, indptr i64, indices i32, values f64)
//   phsvm_free(handle)
//
// Values are parsed and returned as double so a dtype=float64 Python reader
// loses nothing vs the pure-Python path; float32 readers downcast on copy.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct ParseResult {
  std::vector<double> labels;
  std::vector<int64_t> indptr;  // rows + 1
  std::vector<int32_t> indices;
  std::vector<double> values;  // double so dtype=float64 readers lose nothing
  int64_t max_index = -1;
};

// strtod accepts C99 hex floats ("0x10") that Python's float() rejects;
// declining them keeps "valid input" identical across both engines.
bool is_hex_float(const char* p, const char* end) {
  if (p < end && (*p == '+' || *p == '-')) ++p;
  return p + 1 < end && p[0] == '0' && (p[1] == 'x' || p[1] == 'X');
}

// strtod/strtol stop at the first invalid char, which is exactly the
// tokenizer the Python reference implements with str.split(':'). The buffer
// is NUL-terminated by the caller (whole-file read, not mmap), so the scans
// can never run past `end`.
bool parse_body(const char* p, const char* end, int zero_based,
                ParseResult* out) {
  const int base_adjust = zero_based ? 0 : 1;
  out->indptr.push_back(0);
  while (p < end) {
    // One line per iteration.
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (line_end == nullptr) line_end = end;
    const char* hash = static_cast<const char*>(
        memchr(p, '#', static_cast<size_t>(line_end - p)));
    const char* body_end = hash != nullptr ? hash : line_end;

    while (p < body_end && isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= body_end) {  // blank or comment-only line
      p = line_end + 1;
      continue;
    }

    char* next = nullptr;
    if (is_hex_float(p, body_end)) return false;
    const double label = strtod(p, &next);
    if (next == p) return false;  // malformed label
    p = next;

    while (p < body_end) {
      while (p < body_end && isspace(static_cast<unsigned char>(*p))) ++p;
      if (p >= body_end) break;
      const long idx = strtol(p, &next, 10);
      if (next == p || *next != ':') return false;
      p = next + 1;  // past ':'
      // The value must be attached to the colon (Python's split-on-space
      // tokenizer makes "1:" or "1: 2" a hard error); without this check
      // strtod would skip whitespace — including the newline — and consume
      // the NEXT line's label as this value.
      if (p >= body_end || isspace(static_cast<unsigned char>(*p))) return false;
      if (is_hex_float(p, body_end)) return false;
      const double value = strtod(p, &next);
      if (next == p) return false;
      p = next;
      const int64_t norm = static_cast<int64_t>(idx) - base_adjust;
      if (norm > INT32_MAX || norm < INT32_MIN) return false;  // let Python
      // raise its loud OverflowError instead of wrapping silently
      out->indices.push_back(static_cast<int32_t>(norm));
      out->values.push_back(value);
      if (norm > out->max_index) out->max_index = norm;
    }

    out->labels.push_back(label);
    out->indptr.push_back(static_cast<int64_t>(out->indices.size()));
    p = line_end + 1;
  }
  return true;
}

}  // namespace

extern "C" {

void* phsvm_parse(const char* path, int zero_based) {
  // Whole-file read into a NUL-terminated buffer (not mmap): a file ending
  // mid-token would otherwise let strtod scan past the mapping boundary.
  FILE* f = fopen(path, "rb");
  if (f == nullptr) return nullptr;
  if (fseek(f, 0, SEEK_END) != 0) {
    fclose(f);
    return nullptr;
  }
  const long size = ftell(f);
  if (size < 0 || fseek(f, 0, SEEK_SET) != 0) {
    fclose(f);
    return nullptr;
  }
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  if (size > 0 &&
      fread(buf.data(), 1, static_cast<size_t>(size), f) !=
          static_cast<size_t>(size)) {
    fclose(f);
    return nullptr;
  }
  fclose(f);
  buf[static_cast<size_t>(size)] = '\0';

  auto* result = new ParseResult();
  bool ok = true;
  if (size > 0) {
    ok = parse_body(buf.data(), buf.data() + size, zero_based, result);
  } else {
    result->indptr.push_back(0);
  }
  if (!ok) {
    delete result;
    return nullptr;
  }
  return result;
}

int64_t phsvm_rows(void* handle) {
  return static_cast<int64_t>(static_cast<ParseResult*>(handle)->labels.size());
}

int64_t phsvm_nnz(void* handle) {
  return static_cast<int64_t>(static_cast<ParseResult*>(handle)->values.size());
}

int64_t phsvm_max_index(void* handle) {
  return static_cast<ParseResult*>(handle)->max_index;
}

void phsvm_copy(void* handle, double* labels, int64_t* indptr,
                int32_t* indices, double* values) {
  const auto* r = static_cast<ParseResult*>(handle);
  memcpy(labels, r->labels.data(), r->labels.size() * sizeof(double));
  memcpy(indptr, r->indptr.data(), r->indptr.size() * sizeof(int64_t));
  memcpy(indices, r->indices.data(), r->indices.size() * sizeof(int32_t));
  memcpy(values, r->values.data(), r->values.size() * sizeof(double));
}

void phsvm_free(void* handle) { delete static_cast<ParseResult*>(handle); }

}  // extern "C"
