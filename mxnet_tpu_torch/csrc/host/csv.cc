// Native CSV parser.
//
// Reference: `src/io/iter_csv.cc` (CSVIter — the registered C++ iterator
// parsing numeric CSV rows into dense batches; the reference never touches
// python for the hot parse).  Design mirrors libsvm.cc: the
// whole file parses once into a flat float32 row-major buffer that the
// python side copies out in one memcpy and feeds to NDArrayIter-style
// batching — no per-token python work.
//
// Dialect: comma / tab / space separated floats, one row per line; blank
// lines and '#' comments skipped; ragged rows are an error (the reference
// CHECKs row width against data_shape the same way).

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <vector>

namespace {

thread_local std::string g_csv_error;

struct CSV {
  std::vector<float> values;  // row-major
  int64_t rows = 0;
  int64_t cols = -1;
};

}  // namespace

extern "C" {

const char *csv_last_error() { return g_csv_error.c_str(); }

void *csv_open(const char *path) {
  std::ifstream in(path);
  if (!in) {
    g_csv_error = std::string("open failed: ") + std::strerror(errno);
    return nullptr;
  }
  auto *p = new CSV();
  std::string line;
  size_t line_no = 0;
  while (std::getline(in, line)) {
    ++line_no;
    const char *s = line.c_str();
    while (*s == ' ' || *s == '\t') ++s;
    if (*s == '\0' || *s == '#') continue;
    int64_t row_cols = 0;
    while (*s != '\0') {
      char *end = nullptr;
      float v = std::strtof(s, &end);
      if (end == s) {
        g_csv_error = "bad value at line " + std::to_string(line_no);
        delete p;
        return nullptr;
      }
      p->values.push_back(v);
      ++row_cols;
      s = end;
      while (*s == ',' || *s == ' ' || *s == '\t' || *s == '\r') ++s;
    }
    if (p->cols < 0) {
      p->cols = row_cols;
    } else if (row_cols != p->cols) {
      g_csv_error = "ragged row at line " + std::to_string(line_no) +
                    ": got " + std::to_string(row_cols) + " values, "
                    "expected " + std::to_string(p->cols);
      delete p;
      return nullptr;
    }
    ++p->rows;
  }
  if (p->cols < 0) p->cols = 0;
  return p;
}

void csv_close(void *h) { delete static_cast<CSV *>(h); }

int64_t csv_rows(void *h) { return static_cast<CSV *>(h)->rows; }

int64_t csv_cols(void *h) { return static_cast<CSV *>(h)->cols; }

void csv_copy(void *h, float *dst) {
  auto *p = static_cast<CSV *>(h);
  std::memcpy(dst, p->values.data(), p->values.size() * sizeof(float));
}

}  // extern "C"
