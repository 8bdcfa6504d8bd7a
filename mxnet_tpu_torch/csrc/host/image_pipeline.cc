// Native threaded image pipeline: RecordIO -> JPEG decode -> augment ->
// batched NHWC uint8.
//
// Reference: `src/io/iter_image_recordio_2.cc` (ImageRecordIOParser2),
// `src/io/image_aug_default.cc` (DefaultImageAugmenter) and
// `src/io/image_recordio.h` — the reference feeds its GPUs from C++
// decode threads because a Python/PIL loop cannot keep up with the chip.
// Same logic here: worker threads decode with libjpeg(-turbo) entirely
// outside the GIL into a ring of pre-allocated batch slots; Python pops
// completed batches in order and ships them to the card.  DCT-domain
// scaled decode (scale_denom in {1,2,4,8}) trims decode cost when the
// stored image is much larger than the crop, exactly like the reference's
// cv::IMREAD_REDUCED paths.
//
// Record payload layout is the im2rec IRHeader
// (`python/mxnet/recordio.py`): [flag:u32][label:f32][id:u64][id2:u64]
// (+flag extra f32 labels) followed by the encoded image.
//
// Built by g++ with -ljpeg into a library of its own
// (`mxnet_tpu_torch/_native.py`), apart from the other host sources, so a
// machine without libjpeg keeps RecordIO, CSV and LibSVM.  There is no
// fallback: where libjpeg is missing, building this library raises.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <jpeglib.h>

namespace {

constexpr uint32_t kMagic = 0xced7230a;
constexpr uint64_t kLenMask = (1u << 29) - 1;
constexpr int kIRHeaderBytes = 24;  // <IfQQ

thread_local std::string g_err;

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr *e = reinterpret_cast<JpegErr *>(cinfo->err);
  longjmp(e->jb, 1);
}

// -- bilinear resize, uint8 HWC ---------------------------------------------
void resize_bilinear(const uint8_t *src, int sh, int sw, uint8_t *dst,
                     int dh, int dw, int c) {
  const float ry = dh > 1 ? float(sh - 1) / (dh - 1) : 0.f;
  const float rx = dw > 1 ? float(sw - 1) / (dw - 1) : 0.f;
  for (int y = 0; y < dh; ++y) {
    float fy = y * ry;
    int y0 = int(fy);
    int y1 = y0 + 1 < sh ? y0 + 1 : y0;
    float wy = fy - y0;
    const uint8_t *r0 = src + size_t(y0) * sw * c;
    const uint8_t *r1 = src + size_t(y1) * sw * c;
    uint8_t *out = dst + size_t(y) * dw * c;
    for (int x = 0; x < dw; ++x) {
      float fx = x * rx;
      int x0 = int(fx);
      int x1 = x0 + 1 < sw ? x0 + 1 : x0;
      float wx = fx - x0;
      for (int k = 0; k < c; ++k) {
        float top = r0[x0 * c + k] * (1 - wx) + r0[x1 * c + k] * wx;
        float bot = r1[x0 * c + k] * (1 - wx) + r1[x1 * c + k] * wx;
        out[x * c + k] = uint8_t(top * (1 - wy) + bot * wy + 0.5f);
      }
    }
  }
}

struct Slot {
  std::vector<uint8_t> data;    // batch * H * W * C
  std::vector<float> labels;    // batch
  uint64_t batch_no = 0;        // which batch may currently be written
  std::atomic<int> completed{0};
  std::mutex m;
  std::condition_variable cv_writable;
  std::condition_variable cv_ready;
};

struct Pipeline {
  // record file
  int fd = -1;
  const uint8_t *base = nullptr;
  uint64_t fsize = 0;
  std::vector<std::pair<uint64_t, uint32_t>> recs;  // payload off, len

  // config
  int batch = 0, H = 0, W = 0, C = 3;
  int resize_short = 0;       // 0 = off
  bool rand_crop = false, rand_mirror = false, shuffle = false;
  uint64_t seed = 0;
  int depth = 3;
  // per-host sharding: this reader owns the strided slice
  // perm[part_index::num_parts] of each epoch's GLOBAL permutation, so
  // every part's order is a pure function of (seed, epoch, part) and the
  // union over parts is an exact partition of the record file
  int num_parts = 1, part_index = 0;
  uint64_t part_n = 0;        // records owned by this part

  // epoch order cache (shared_ptr snapshots: a worker holds its epoch's
  // permutation by refcount, so regeneration for a later epoch can never
  // race a reader still finishing an old one)
  std::mutex order_m;
  uint64_t order_epoch[2] = {~0ull, ~0ull};
  std::shared_ptr<const std::vector<uint32_t>> order[2];

  std::vector<std::unique_ptr<Slot>> slots;
  std::vector<std::thread> workers;
  std::atomic<uint64_t> next_index{0};
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> decode_errors{0};

  uint64_t consumer_batch = 0;

  ~Pipeline() {
    stop.store(true);
    for (auto &s : slots) {
      std::lock_guard<std::mutex> lk(s->m);
      s->cv_writable.notify_all();
    }
    for (auto &t : workers) t.join();
    if (base) munmap(const_cast<uint8_t *>(base), fsize);
    if (fd >= 0) close(fd);
  }

  std::shared_ptr<const std::vector<uint32_t>> epoch_order(uint64_t epoch) {
    std::lock_guard<std::mutex> lk(order_m);
    int slot = epoch & 1;
    if (order_epoch[slot] != epoch) {
      auto o = std::make_shared<std::vector<uint32_t>>(recs.size());
      for (uint32_t i = 0; i < o->size(); ++i) (*o)[i] = i;
      if (shuffle) {
        std::mt19937_64 rng(seed ^ (epoch * 0x9e3779b97f4a7c15ull));
        for (size_t i = o->size() - 1; i > 0; --i) {
          std::swap((*o)[i], (*o)[rng() % (i + 1)]);
        }
      }
      order[slot] = std::move(o);
      order_epoch[slot] = epoch;
    }
    return order[slot];
  }

  bool decode_one(const uint8_t *payload, uint32_t len, uint8_t *out,
                  float *label, std::mt19937_64 &rng) {
    if (len < kIRHeaderBytes) return false;
    uint32_t flag;
    std::memcpy(&flag, payload, 4);
    std::memcpy(label, payload + 4, 4);
    uint64_t skip = kIRHeaderBytes + uint64_t(flag) * 4;
    if (len <= skip) return false;
    const uint8_t *jpg = payload + skip;
    uint64_t jlen = len - skip;

    // declared BEFORE setjmp: after a longjmp the function resumes at the
    // setjmp site and returns normally, so these destructors still run
    // (declaring them later would leak the decode buffers on corrupt
    // scan data)
    std::vector<uint8_t> buf;
    std::vector<uint8_t> rbuf;

    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t *>(jpg), jlen);
    if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
    cinfo.out_color_space = JCS_RGB;
    // DCT-domain downscale: largest denom keeping both dims >= what the
    // later resize/crop needs (reference IMREAD_REDUCED_COLOR_*)
    int need_h = resize_short > 0 ? resize_short : H;
    int need_w = resize_short > 0 ? resize_short : W;
    int denom = 1;
    for (int d = 2; d <= 8; d *= 2) {
      if (int(cinfo.image_height) / d >= need_h &&
          int(cinfo.image_width) / d >= need_w) {
        denom = d;
      }
    }
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
    cinfo.dct_method = JDCT_ISLOW;
    // IFAST saves ~10% decode time but visibly degrades high-frequency
    // content; ISLOW + SIMD (libjpeg-turbo) is the reference default too
    
    jpeg_start_decompress(&cinfo);
    int dw = cinfo.output_width, dh = cinfo.output_height;
    int dc = cinfo.output_components;  // 3 (RGB forced)
    buf.resize(size_t(dw) * dh * dc);
    while (cinfo.output_scanline < cinfo.output_height) {
      uint8_t *row = buf.data() + size_t(cinfo.output_scanline) * dw * dc;
      jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);

    // optional shorter-side resize
    const uint8_t *img = buf.data();
    int ih = dh, iw = dw;
    if (resize_short > 0 && std::min(dh, dw) != resize_short) {
      if (dh < dw) {
        ih = resize_short;
        iw = int(int64_t(dw) * resize_short / dh);
      } else {
        iw = resize_short;
        ih = int(int64_t(dh) * resize_short / dw);
      }
      rbuf.resize(size_t(ih) * iw * dc);
      resize_bilinear(buf.data(), dh, dw, rbuf.data(), ih, iw, dc);
      img = rbuf.data();
    }
    if (ih < H || iw < W) {  // undersized source: upscale to crop size
      rbuf.resize(size_t(H) * W * dc);
      std::vector<uint8_t> tmp(rbuf);
      resize_bilinear(img, ih, iw, tmp.data(), H, W, dc);
      rbuf.swap(tmp);
      img = rbuf.data();
      ih = H;
      iw = W;
    }

    // crop (random in train, center otherwise) + optional mirror
    int y0 = (ih - H) / 2, x0 = (iw - W) / 2;
    if (rand_crop) {
      y0 = ih == H ? 0 : int(rng() % uint64_t(ih - H + 1));
      x0 = iw == W ? 0 : int(rng() % uint64_t(iw - W + 1));
    }
    bool mirror = rand_mirror && (rng() & 1);
    for (int y = 0; y < H; ++y) {
      const uint8_t *src = img + (size_t(y0 + y) * iw + x0) * dc;
      uint8_t *dst = out + size_t(y) * W * C;
      if (!mirror) {
        std::memcpy(dst, src, size_t(W) * C);
      } else {
        for (int x = 0; x < W; ++x) {
          std::memcpy(dst + size_t(x) * C, src + size_t(W - 1 - x) * C, C);
        }
      }
    }
    return true;
  }

  void worker(int wid) {
    std::mt19937_64 rng(seed ^ (0xabcdef12345678ull + wid));
    while (!stop.load(std::memory_order_relaxed)) {
      uint64_t i = next_index.fetch_add(1);
      uint64_t batch_no = i / batch;
      Slot &s = *slots[batch_no % depth];
      {
        std::unique_lock<std::mutex> lk(s.m);
        s.cv_writable.wait(lk, [&] {
          return stop.load(std::memory_order_relaxed) ||
                 s.batch_no == batch_no;
        });
      }
      if (stop.load(std::memory_order_relaxed)) break;
      // i counts PART-LOCAL samples; map to the part's strided view of
      // the epoch's global permutation
      uint64_t epoch = i / part_n;
      uint64_t j = uint64_t(part_index) + (i % part_n) * uint64_t(num_parts);
      uint32_t rec = (*epoch_order(epoch))[j];
      uint8_t *out = s.data.data() + size_t(i % batch) * H * W * C;
      float label = -1.f;
      bool ok = decode_one(base + recs[rec].first, recs[rec].second, out,
                           &label, rng);
      if (!ok) {
        std::memset(out, 0, size_t(H) * W * C);
        decode_errors.fetch_add(1);
      }
      s.labels[i % batch] = label;
      if (s.completed.fetch_add(1) + 1 == batch) {
        std::lock_guard<std::mutex> lk(s.m);
        s.cv_ready.notify_all();
      }
    }
  }

  int ready_batches() const {
    // gauge only (racy reads are fine): completed slots the consumer has
    // not yet popped — 0 while compute waits means the decode pool, not
    // the chip, bounds the run
    int n = 0;
    for (const auto &s : slots) {
      if (s->completed.load(std::memory_order_relaxed) == batch) ++n;
    }
    return n;
  }

  int next(uint8_t *out_data, float *out_labels) {
    Slot &s = *slots[consumer_batch % depth];
    {
      std::unique_lock<std::mutex> lk(s.m);
      s.cv_ready.wait(lk, [&] {
        return s.batch_no == consumer_batch &&
               s.completed.load() == batch;
      });
    }
    std::memcpy(out_data, s.data.data(), s.data.size());
    std::memcpy(out_labels, s.labels.data(), s.labels.size() * 4);
    {
      std::lock_guard<std::mutex> lk(s.m);
      s.completed.store(0);
      s.batch_no += depth;
      s.cv_writable.notify_all();
    }
    ++consumer_batch;
    return batch;
  }
};

bool scan_records(Pipeline *p) {
  uint64_t off = 0;
  while (off + 8 <= p->fsize) {
    uint32_t magic, lrec;
    std::memcpy(&magic, p->base + off, 4);
    std::memcpy(&lrec, p->base + off + 4, 4);
    if (magic != kMagic) break;
    uint64_t len = lrec & kLenMask;
    if (off + 8 + len > p->fsize) break;  // truncated tail
    uint32_t cflag = lrec >> 29;
    if (cflag == 0) {  // plain (non-split) record
      p->recs.emplace_back(off + 8, uint32_t(len));
    }
    off += 8 + ((len + 3) & ~3ull);
  }
  return !p->recs.empty();
}

}  // namespace

extern "C" {

const char *imgpipe_last_error() { return g_err.c_str(); }

void *imgpipe_create(const char *path, int batch, int h, int w,
                     int resize_short, int nthreads, int depth,
                     int rand_crop, int rand_mirror, int shuffle,
                     uint64_t seed, int num_parts, int part_index) {
  auto p = std::make_unique<Pipeline>();
  p->fd = open(path, O_RDONLY);
  if (p->fd < 0) {
    g_err = std::string("open failed: ") + path;
    return nullptr;
  }
  struct stat st;
  if (fstat(p->fd, &st) != 0 || st.st_size == 0) {
    g_err = "empty or unreadable record file";
    return nullptr;
  }
  p->fsize = uint64_t(st.st_size);
  void *m = mmap(nullptr, p->fsize, PROT_READ, MAP_PRIVATE, p->fd, 0);
  if (m == MAP_FAILED) {
    g_err = "mmap failed";
    return nullptr;
  }
  p->base = static_cast<const uint8_t *>(m);
  madvise(m, p->fsize, MADV_WILLNEED);
  if (!scan_records(p.get())) {
    g_err = "no records found (bad magic?)";
    return nullptr;
  }
  p->batch = batch;
  p->H = h;
  p->W = w;
  p->resize_short = resize_short;
  p->rand_crop = rand_crop != 0;
  p->rand_mirror = rand_mirror != 0;
  p->shuffle = shuffle != 0;
  p->seed = seed;
  if (num_parts < 1 || part_index < 0 || part_index >= num_parts) {
    g_err = "invalid shard: need 0 <= part_index < num_parts";
    return nullptr;
  }
  p->num_parts = num_parts;
  p->part_index = part_index;
  {
    uint64_t n = p->recs.size();
    uint64_t pi = uint64_t(part_index), np = uint64_t(num_parts);
    p->part_n = n > pi ? (n - pi + np - 1) / np : 0;
  }
  if (p->part_n == 0) {
    g_err = "shard owns no records (num_parts exceeds record count?)";
    return nullptr;
  }
  p->depth = depth < 2 ? 2 : depth;
  if (nthreads < 1) nthreads = 1;
  for (int i = 0; i < p->depth; ++i) {
    auto s = std::make_unique<Slot>();
    s->data.resize(size_t(batch) * h * w * p->C);
    s->labels.resize(batch);
    s->batch_no = i;
    p->slots.push_back(std::move(s));
  }
  for (int i = 0; i < nthreads; ++i) {
    p->workers.emplace_back(&Pipeline::worker, p.get(), i);
  }
  return p.release();
}

int64_t imgpipe_num_records(void *h) {
  return int64_t(static_cast<Pipeline *>(h)->recs.size());
}

int64_t imgpipe_part_records(void *h) {
  return int64_t(static_cast<Pipeline *>(h)->part_n);
}

// Completed batches waiting in the ring (occupancy gauge for telemetry).
int imgpipe_ready_batches(void *h) {
  return static_cast<Pipeline *>(h)->ready_batches();
}

int64_t imgpipe_decode_errors(void *h) {
  return int64_t(static_cast<Pipeline *>(h)->decode_errors.load());
}

// Blocks until the next batch is complete; fills caller buffers
// (batch*H*W*3 uint8, batch float32).  Returns batch size.
int imgpipe_next(void *h, uint8_t *out_data, float *out_labels) {
  return static_cast<Pipeline *>(h)->next(out_data, out_labels);
}

void imgpipe_destroy(void *h) { delete static_cast<Pipeline *>(h); }

}  // extern "C"
