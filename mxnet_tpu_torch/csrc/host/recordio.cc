// Native RecordIO reader/writer.
//
// Reference: dmlc-core recordio (consumed via `src/io/` in the reference
// framework; python mirror `python/mxnet/recordio.py`).  Format-compatible:
// records framed as [kMagic:u32][(cflag<<29|len):u32][payload][pad to 4B],
// kMagic = 0xced7230a.
//
// Design: the reader memory-maps the file, so reads are O(1)
// zero-copy pointer returns (the python layer wraps them in bytes as
// needed) and sequential throughput is bounded by page-cache bandwidth,
// not python struct parsing.  The sequential cursor is a byte offset, and
// the per-record offset index is built lazily on first indexed access —
// opening a 100GB .rec for .idx-driven training touches no payload pages.
// A truncated trailing record (producer killed mid-write) ends the stream
// instead of poisoning the whole file.  This is the native core under
// MXIndexedRecordIO and the ImageRecord dataset pipeline.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0xced7230a;
constexpr uint64_t kLenMask = (1u << 29) - 1;

thread_local std::string g_last_error;

void set_error(const std::string &msg) { g_last_error = msg; }

struct Reader {
  int fd = -1;
  const uint8_t *base = nullptr;
  uint64_t size = 0;
  uint64_t cursor = 0;            // byte offset of the next sequential record
  bool scanned = false;
  std::vector<uint64_t> offsets;  // lazy index: offset of each record header
};

struct Writer {
  FILE *fp = nullptr;
};

// Header at `off` if a complete record starts there: 0 on success, -1 on a
// clean end (EOF / truncated tail), -2 on corrupt magic.
int parse_header(const Reader *r, uint64_t off, uint64_t *len) {
  if (off > r->size || r->size - off < 8) return -1;
  uint32_t magic, lrec;
  std::memcpy(&magic, r->base + off, 4);
  std::memcpy(&lrec, r->base + off + 4, 4);
  if (magic != kMagic) {
    set_error("corrupt record magic at offset " + std::to_string(off));
    return -2;
  }
  *len = lrec & kLenMask;
  if (*len > r->size - off - 8) return -1;  // truncated tail: tolerate
  return 0;
}

uint64_t record_end(uint64_t off, uint64_t len) {
  return off + 8 + len + (4 - len % 4) % 4;
}

// Build the record-offset index (first indexed access only).  Stops at a
// truncated tail; a corrupt header mid-file also ends the index (preceding
// complete records stay readable, matching the tolerant-tail policy).
void ensure_scanned(Reader *r) {
  if (r->scanned) return;
  uint64_t pos = 0, len;
  while (parse_header(r, pos, &len) == 0) {
    r->offsets.push_back(pos);
    pos = record_end(pos, len);
  }
  r->scanned = true;
}

}  // namespace

extern "C" {

const char *rio_last_error() { return g_last_error.c_str(); }

void *rio_open_reader(const char *path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) {
    set_error(std::string("open failed: ") + std::strerror(errno));
    return nullptr;
  }
  struct stat st;
  if (fstat(fd, &st) != 0) {
    set_error(std::string("fstat failed: ") + std::strerror(errno));
    ::close(fd);
    return nullptr;
  }
  auto *r = new Reader();
  r->fd = fd;
  r->size = static_cast<uint64_t>(st.st_size);
  if (r->size > 0) {
    void *m = mmap(nullptr, r->size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (m == MAP_FAILED) {
      set_error(std::string("mmap failed: ") + std::strerror(errno));
      ::close(fd);
      delete r;
      return nullptr;
    }
    r->base = static_cast<const uint8_t *>(m);
  }
  // cheap sanity check: the first record's magic (catches non-recordio
  // files without scanning the whole mmap)
  if (r->size >= 8) {
    uint32_t magic;
    std::memcpy(&magic, r->base, 4);
    if (magic != kMagic) {
      set_error("corrupt record magic at offset 0");
      munmap(const_cast<uint8_t *>(r->base), r->size);
      ::close(fd);
      delete r;
      return nullptr;
    }
  }
  return r;
}

void rio_close_reader(void *h) {
  auto *r = static_cast<Reader *>(h);
  if (!r) return;
  if (r->base) munmap(const_cast<uint8_t *>(r->base), r->size);
  if (r->fd >= 0) ::close(r->fd);
  delete r;
}

int64_t rio_num_records(void *h) {
  auto *r = static_cast<Reader *>(h);
  ensure_scanned(r);
  return r->offsets.size();
}

// Read record i; returns 0 on success, data points into the mmap (valid
// until rio_close_reader).
int rio_read_record(void *h, int64_t i, const uint8_t **data, uint64_t *len) {
  auto *r = static_cast<Reader *>(h);
  ensure_scanned(r);
  if (i < 0 || static_cast<uint64_t>(i) >= r->offsets.size()) {
    set_error("record index out of range");
    return -1;
  }
  uint64_t pos = r->offsets[i];
  uint32_t lrec;
  std::memcpy(&lrec, r->base + pos + 4, 4);
  *len = lrec & kLenMask;
  *data = r->base + pos + 8;
  return 0;
}

// Read record at byte offset `off` (for .idx-file compatibility).
// Bounds checks avoid uint64 overflow: a hostile .idx offset near 2^64
// must fail cleanly, not wrap past the check into an OOB mmap read.
int rio_read_at(void *h, uint64_t off, const uint8_t **data, uint64_t *len) {
  auto *r = static_cast<Reader *>(h);
  switch (parse_header(r, off, len)) {
    case -1:
      set_error("offset out of range or truncated record");
      return -1;
    case -2:
      return -1;
    default:
      *data = r->base + off + 8;
      return 0;
  }
}

// Position the sequential cursor at byte offset `off` (the values stored
// in .idx files; python fp.seek semantics — validity is checked on read).
int rio_seek(void *h, uint64_t off) {
  auto *r = static_cast<Reader *>(h);
  if (off > r->size) {
    set_error("seek offset past end of file");
    return -1;
  }
  r->cursor = off;
  return 0;
}

// Byte offset of the next sequential record — the reader-side tell() used
// when building .idx files.
uint64_t rio_reader_tell(void *h) {
  return static_cast<Reader *>(h)->cursor;
}

// Sequential read at the cursor; 0 on success, -1 at EOF (incl. a
// truncated trailing record), -2 on corrupt magic.
int rio_next_record(void *h, const uint8_t **data, uint64_t *len) {
  auto *r = static_cast<Reader *>(h);
  int rc = parse_header(r, r->cursor, len);
  if (rc != 0) return rc;
  *data = r->base + r->cursor + 8;
  r->cursor = record_end(r->cursor, *len);
  return 0;
}

void rio_reset(void *h) { static_cast<Reader *>(h)->cursor = 0; }

uint64_t rio_record_offset(void *h, int64_t i) {
  auto *r = static_cast<Reader *>(h);
  ensure_scanned(r);
  if (i < 0 || static_cast<uint64_t>(i) >= r->offsets.size()) return ~0ull;
  return r->offsets[i];
}

void *rio_open_writer(const char *path, int append) {
  FILE *fp = std::fopen(path, append ? "ab" : "wb");
  if (!fp) {
    set_error(std::string("fopen failed: ") + std::strerror(errno));
    return nullptr;
  }
  auto *w = new Writer();
  w->fp = fp;
  return w;
}

int64_t rio_writer_tell(void *h) {
  auto *w = static_cast<Writer *>(h);
  return ftell(w->fp);
}

int rio_write_record(void *h, const uint8_t *data, uint64_t len) {
  auto *w = static_cast<Writer *>(h);
  if (len & ~kLenMask) {
    set_error("record length " + std::to_string(len) +
              " exceeds the 29-bit frame limit");
    return -1;
  }
  uint32_t header[2] = {kMagic, static_cast<uint32_t>(len)};
  if (std::fwrite(header, 4, 2, w->fp) != 2) {
    set_error("short write (header)");
    return -1;
  }
  if (len && std::fwrite(data, 1, len, w->fp) != len) {
    set_error("short write (payload)");
    return -1;
  }
  uint64_t pad = (4 - len % 4) % 4;
  static const uint8_t zeros[4] = {0, 0, 0, 0};
  if (pad && std::fwrite(zeros, 1, pad, w->fp) != pad) {
    set_error("short write (pad)");
    return -1;
  }
  return 0;
}

void rio_close_writer(void *h) {
  auto *w = static_cast<Writer *>(h);
  if (!w) return;
  if (w->fp) std::fclose(w->fp);
  delete w;
}

}  // extern "C"
