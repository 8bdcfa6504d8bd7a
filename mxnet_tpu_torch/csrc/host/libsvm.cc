// Native LibSVM parser.
//
// Reference: `src/io/iter_libsvm.cc` (LibSVMIter parsing "label idx:val ..."
// rows into CSR batches).  Design: the file is read once into
// flat CSR arrays (labels / indptr / indices / values) that the python side
// copies out in four bulk memcpys — no per-token python work, so a
// multi-GB CTR dataset parses at native speed and lands directly in the
// CSRNDArray container.

#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;

struct LibSVM {
  std::vector<float> labels;
  std::vector<int64_t> indptr;   // size rows+1
  std::vector<int32_t> indices;
  std::vector<float> values;
  int32_t max_index = -1;
};

}  // namespace

extern "C" {

const char *lsvm_last_error() { return g_last_error.c_str(); }

void *lsvm_open(const char *path) {
  std::ifstream in(path);
  if (!in) {
    g_last_error = std::string("open failed: ") + std::strerror(errno);
    return nullptr;
  }
  auto *p = new LibSVM();
  p->indptr.push_back(0);
  std::string line;
  size_t line_no = 0;
  while (std::getline(in, line)) {
    ++line_no;
    const char *s = line.c_str();
    char *end = nullptr;
    // skip blank / comment lines
    while (*s == ' ' || *s == '\t') ++s;
    if (*s == '\0' || *s == '#') continue;
    float label = std::strtof(s, &end);
    if (end == s) {
      g_last_error = "bad label at line " + std::to_string(line_no);
      delete p;
      return nullptr;
    }
    s = end;
    while (*s != '\0') {
      while (*s == ' ' || *s == '\t') ++s;
      if (*s == '\0' || *s == '#') break;
      long idx = std::strtol(s, &end, 10);
      if (end == s || *end != ':') {
        g_last_error = "bad feature at line " + std::to_string(line_no);
        delete p;
        return nullptr;
      }
      if (idx < 0 || idx > INT32_MAX) {
        g_last_error = "feature index out of range at line " +
                       std::to_string(line_no);
        delete p;
        return nullptr;
      }
      s = end + 1;
      float val = std::strtof(s, &end);
      if (end == s) {
        g_last_error = "bad value at line " + std::to_string(line_no);
        delete p;
        return nullptr;
      }
      s = end;
      p->indices.push_back(static_cast<int32_t>(idx));
      p->values.push_back(val);
      if (idx > p->max_index) p->max_index = static_cast<int32_t>(idx);
    }
    p->labels.push_back(label);
    p->indptr.push_back(static_cast<int64_t>(p->indices.size()));
  }
  return p;
}

void lsvm_close(void *h) { delete static_cast<LibSVM *>(h); }

int64_t lsvm_num_rows(void *h) {
  return static_cast<LibSVM *>(h)->labels.size();
}

int64_t lsvm_nnz(void *h) {
  return static_cast<LibSVM *>(h)->values.size();
}

int32_t lsvm_max_index(void *h) {
  return static_cast<LibSVM *>(h)->max_index;
}

// Bulk copy-out into caller-allocated buffers.
void lsvm_copy(void *h, float *labels, int64_t *indptr, int32_t *indices,
               float *values) {
  auto *p = static_cast<LibSVM *>(h);
  std::memcpy(labels, p->labels.data(), p->labels.size() * sizeof(float));
  std::memcpy(indptr, p->indptr.data(), p->indptr.size() * sizeof(int64_t));
  std::memcpy(indices, p->indices.data(),
              p->indices.size() * sizeof(int32_t));
  std::memcpy(values, p->values.data(), p->values.size() * sizeof(float));
}

}  // extern "C"
