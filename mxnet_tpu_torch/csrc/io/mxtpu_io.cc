// mxtpu_io: native IO runtime of mxnet_tpu_torch (built with g++ by
// mxnet_tpu_torch/_native.py at first use).
//
// The equivalent of the reference's C++ data pipeline
// (ref: src/io/iter_image_recordio_2.cc:880, src/io/iter_prefetcher.h,
// dmlc-core recordio). The reference builds a chain of
// recordio-chunk-reader -> threaded JPEG decode/augment -> batcher ->
// prefetcher; this file implements the same stages with a reorder-buffer
// worker pool feeding pre-allocated host batch buffers, exposed through a
// flat C ABI consumed via ctypes (no pybind11 in the image).
//
// Framing is binary-compatible with dmlc recordio:
//   [magic u32 = 0xced7230a][lrec u32: cflag<<29 | len][payload][pad to 4B]
// Image records carry an IRHeader {flag u32, label f32, id u64, id2 u64}
// followed by `flag` extra f32 labels, then JPEG bytes.

#include <atomic>
#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <csetjmp>
#include <jpeglib.h>

namespace {

constexpr uint32_t kMagic = 0xced7230a;

#pragma pack(push, 1)
struct IRHeader {
  uint32_t flag;
  float label;
  uint64_t id;
  uint64_t id2;
};
#pragma pack(pop)
static_assert(sizeof(IRHeader) == 24, "IRHeader layout");

// ---------------------------------------------------------------------------
// RecordIO writer / reader
// ---------------------------------------------------------------------------

struct RecordIOWriter {
  FILE* fp = nullptr;
  uint64_t nrecords = 0;
};

struct RecordIOReader {
  FILE* fp = nullptr;
  std::vector<char> buf;
};

bool write_record(FILE* fp, const char* data, uint32_t len) {
  uint32_t head[2] = {kMagic, len & ((1u << 29) - 1)};
  if (fwrite(head, 4, 2, fp) != 2) return false;
  if (len && fwrite(data, 1, len, fp) != len) return false;
  uint32_t pad = (4 - len % 4) % 4;
  static const char zeros[4] = {0, 0, 0, 0};
  if (pad && fwrite(zeros, 1, pad, fp) != pad) return false;
  return true;
}

// Reads one framed record into out. Returns 0 on success, -1 on clean
// EOF, -2 on corruption (bad magic / truncated payload) — callers must
// not conflate truncation with end-of-data.
int read_record(FILE* fp, std::vector<char>* out) {
  uint32_t head[2];
  size_t got = fread(head, 4, 2, fp);
  if (got == 0 && feof(fp)) return -1;
  if (got != 2) return -2;
  if (head[0] != kMagic) return -2;
  uint32_t len = head[1] & ((1u << 29) - 1);
  out->resize(len);
  if (len && fread(out->data(), 1, len, fp) != len) return -2;
  uint32_t pad = (4 - len % 4) % 4;
  if (pad) fseek(fp, pad, SEEK_CUR);
  return 0;
}

// ---------------------------------------------------------------------------
// JPEG decode (libjpeg) + bilinear resize
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

// Decodes JPEG to RGB u8 HWC. Returns false on failure.
// target_short > 0 enables decode-time scaling: libjpeg's M/8 IDCT
// scaling decodes directly at reduced resolution, so a 360x480 source
// headed for resize_short=256 never pays for full-res IDCT — the same
// trick behind the reference's ~3000 img/s OpenCV path (cv::IMREAD +
// JPEG scale_denom; ref: src/io/image_recordio pipeline,
// docs note_data_loading.md:181).
bool decode_jpeg(const uint8_t* src, size_t len,
                 std::vector<uint8_t>* out, int* h, int* w,
                 int target_short = 0) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, src, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  if (target_short > 0) {
    int shorter = std::min<int>(cinfo.image_height, cinfo.image_width);
    if (shorter > target_short) {
      // largest M/8 (M in 1..8) whose result still covers target_short
      int m = 8;
      while (m > 1 && (shorter * (m - 1)) / 8 >= target_short) --m;
      cinfo.scale_num = m;
      cinfo.scale_denom = 8;
      // approximations are fine here: a bilinear resize follows, which
      // washes out IFAST/plain-upsampling error. The unscaled path
      // keeps ISLOW + fancy upsampling for exact-decode parity
      // (tests/test_io_native.py decode_correct).
      cinfo.dct_method = JDCT_IFAST;
      cinfo.do_fancy_upsampling = FALSE;
    }
  }
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(size_t(*w) * (*h) * 3);
  // hand libjpeg a whole batch of row pointers per call — per-scanline
  // calls pay the library's dispatch overhead height times
  std::vector<uint8_t*> rows(*h);
  for (int y = 0; y < *h; ++y)
    rows[y] = out->data() + size_t(y) * (*w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    jpeg_read_scanlines(&cinfo, rows.data() + cinfo.output_scanline,
                        cinfo.output_height - cinfo.output_scanline);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// Bilinear RGB u8 HWC resize, fixed-point 8.8. For mild rescales
// (sh < 2*dh — the resize-short-side-then-crop regime) the horizontal
// lerp of each source row is computed ONCE into a u16 buffer and the
// vertical pass lerps between those rows: the naive per-output-pixel
// form recomputes each source row's horizontal lerp for every output
// row that touches it (~2*dh row-lerps vs sh here). Both paths produce
// bit-identical output — the separable pass stores the exact integer
// `top`/`bot` intermediates of the naive form.
void resize_bilinear(const uint8_t* src, int sh, int sw,
                     uint8_t* dst, int dh, int dw) {
  const float ry = dh > 1 ? float(sh - 1) / (dh - 1) : 0.f;
  const float rx = dw > 1 ? float(sw - 1) / (dw - 1) : 0.f;
  std::vector<int> x0s(dw), x1s(dw), wxs(dw);
  for (int x = 0; x < dw; ++x) {
    float fx = rx * x;
    int x0 = int(fx);
    x0s[x] = x0;
    x1s[x] = std::min(x0 + 1, sw - 1);
    wxs[x] = int((fx - x0) * 256.f + 0.5f);
  }
  if (sh < 2 * dh) {
    // separable: horizontal pass over all source rows, then vertical
    std::vector<uint16_t> hbuf(size_t(sh) * dw * 3);
    for (int y = 0; y < sh; ++y) {
      const uint8_t* row = src + size_t(y) * sw * 3;
      uint16_t* hrow = hbuf.data() + size_t(y) * dw * 3;
      for (int x = 0; x < dw; ++x) {
        const int o0 = x0s[x] * 3, o1 = x1s[x] * 3, wx = wxs[x];
        for (int c = 0; c < 3; ++c)
          hrow[x * 3 + c] =
              uint16_t((row[o0 + c] << 8) + (row[o1 + c] - row[o0 + c]) * wx);
      }
    }
    for (int y = 0; y < dh; ++y) {
      float fy = ry * y;
      int y0 = int(fy);
      int y1 = std::min(y0 + 1, sh - 1);
      int wy = int((fy - y0) * 256.f + 0.5f);
      const uint16_t* r0 = hbuf.data() + size_t(y0) * dw * 3;
      const uint16_t* r1 = hbuf.data() + size_t(y1) * dw * 3;
      uint8_t* drow = dst + size_t(y) * dw * 3;
      for (int k = 0; k < dw * 3; ++k) {
        int top = r0[k], bot = r1[k];
        drow[k] = uint8_t(((top << 8) + (bot - top) * wy + (1 << 15)) >> 16);
      }
    }
    return;
  }
  // strong downscale: most source rows are never sampled — lerp per
  // output pixel so skipped rows cost nothing
  for (int y = 0; y < dh; ++y) {
    float fy = ry * y;
    int y0 = int(fy);
    int y1 = std::min(y0 + 1, sh - 1);
    int wy = int((fy - y0) * 256.f + 0.5f);
    const uint8_t* r0 = src + size_t(y0) * sw * 3;
    const uint8_t* r1 = src + size_t(y1) * sw * 3;
    uint8_t* drow = dst + size_t(y) * dw * 3;
    for (int x = 0; x < dw; ++x) {
      const int o0 = x0s[x] * 3, o1 = x1s[x] * 3, wx = wxs[x];
      for (int c = 0; c < 3; ++c) {
        int top = (r0[o0 + c] << 8) + (r0[o1 + c] - r0[o0 + c]) * wx;
        int bot = (r1[o0 + c] << 8) + (r1[o1 + c] - r1[o0 + c]) * wx;
        drow[x * 3 + c] =
            uint8_t(((top << 8) + (bot - top) * wy + (1 << 15)) >> 16);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// ImageRecordPipeline: offsets scan -> worker pool decode -> reorder queue
// ---------------------------------------------------------------------------

struct PipelineConfig {
  int batch_size;
  int height, width;       // output HW (channels fixed at 3)
  int label_width;
  int num_threads;
  int prefetch_depth;      // max in-flight decoded batches
  int resize_short;        // resize shorter side to this before crop (<=0 off)
  int shuffle;
  int rand_crop;
  int rand_mirror;
  uint64_t seed;
  float mean[3];
  float std[3];
  int output_u8;           // 1: emit decoded u8 NHWC, normalization deferred
                           // to the consumer (device-side); 0: f32 NCHW
                           // normalized on the host (legacy path)
  uint64_t cache_bytes;    // decode-cache budget (0 = off): decoded +
                           // short-side-resized images are kept across
                           // epochs up to this many bytes, so steady-state
                           // epochs skip JPEG decode entirely. Crop,
                           // mirror and normalization stay per-epoch.
};

// One decode-cache entry: the post-resize_short, pre-crop image (the
// last deterministic point of the augmentation chain) plus its labels.
struct CachedImage {
  std::vector<uint8_t> img;   // HWC u8
  int h = 0, w = 0;
  std::vector<float> label;
};

struct Batch {
  std::vector<float> data;    // f32 mode: batch*3*H*W, CHW per image
  std::vector<uint8_t> u8;    // u8 mode: batch*H*W*3, HWC per image
  std::vector<float> label;   // batch*label_width
  int count = 0;
};

struct Pipeline {
  PipelineConfig cfg;
  std::string path;
  std::vector<std::pair<uint64_t, uint32_t>> offsets;  // (pos, payload len)
  std::vector<uint32_t> order;
  uint64_t epoch = 0;

  std::vector<std::thread> workers;
  std::atomic<int> next_batch_to_claim{0};
  int num_batches = 0;

  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::map<int, Batch> ready;   // reorder buffer keyed by batch index
  int next_batch_out = 0;
  bool stopping = false;
  std::string error;            // first worker error, reported at next()

  Batch current;                // last batch handed to the caller (next())
  // leased batches: handed to the caller zero-copy, owned here until
  // mxt_pipeline_return — the caller wraps the buffer without copying
  std::map<uint64_t, Batch> leased;
  uint64_t next_lease_id = 1;

  // decode cache (immutable entries, shared_ptr so readers never hold
  // the lock while using one)
  std::mutex cache_mu;
  std::unordered_map<uint32_t, std::shared_ptr<const CachedImage>> cache;
  uint64_t cache_used = 0;
  std::atomic<uint64_t> cache_hits{0}, cache_misses{0};
};

std::shared_ptr<const CachedImage> cache_get(Pipeline* p, uint32_t rec) {
  if (p->cfg.cache_bytes == 0) return nullptr;
  std::lock_guard<std::mutex> lk(p->cache_mu);
  auto it = p->cache.find(rec);
  if (it == p->cache.end()) return nullptr;
  return it->second;
}

void cache_put(Pipeline* p, uint32_t rec,
               std::shared_ptr<const CachedImage> entry) {
  if (p->cfg.cache_bytes == 0) return;
  uint64_t sz = entry->img.size() + entry->label.size() * 4 + 64;
  std::lock_guard<std::mutex> lk(p->cache_mu);
  if (p->cache_used + sz > p->cfg.cache_bytes) return;  // budget full
  if (p->cache.emplace(rec, std::move(entry)).second) p->cache_used += sz;
}

// Scans the .rec file once, recording payload offsets (the analog of the
// reference's .idx file, built on the fly so one works without an index).
// A file that does not terminate at a clean record boundary is rejected
// (create fails, Python falls back to its raising reader) rather than
// silently truncated.
bool scan_offsets(Pipeline* p) {
  FILE* fp = fopen(p->path.c_str(), "rb");
  if (!fp) return false;
  fseek(fp, 0, SEEK_END);
  const uint64_t fsize = ftell(fp);
  fseek(fp, 0, SEEK_SET);
  uint32_t head[2];
  bool clean_end = false;
  for (;;) {
    uint64_t pos = ftell(fp);
    size_t got = fread(head, 4, 2, fp);
    if (got == 0 && feof(fp)) {
      clean_end = true;
      break;
    }
    if (got != 2 || head[0] != kMagic) break;
    uint32_t len = head[1] & ((1u << 29) - 1);
    uint32_t skip = len + (4 - len % 4) % 4;
    if (pos + 8 + skip > fsize) break;  // payload truncated (fseek past
                                        // EOF would not detect this)
    if (fseek(fp, skip, SEEK_CUR) != 0) break;
    p->offsets.emplace_back(pos + 8, len);
  }
  fclose(fp);
  return clean_end && !p->offsets.empty();
}

void set_error(Pipeline* p, const std::string& msg) {
  std::lock_guard<std::mutex> lk(p->mu);
  if (p->error.empty()) p->error = msg;
  p->cv_ready.notify_all();
}

// Crop/mirror/emit one decoded (and short-side-resized) image into slot
// i of the batch — the per-epoch tail of the augmentation chain, shared
// by the decode path and the decode-cache hit path.
bool finish_record(Pipeline* p, const CachedImage& ci, Batch* b,
                   int i, std::mt19937* rng) {
  const PipelineConfig& c = p->cfg;
  const std::vector<uint8_t>& img = ci.img;
  const int h = ci.h, w = ci.w;

  float* lbl = b->label.data() + size_t(i) * c.label_width;
  memcpy(lbl, ci.label.data(), size_t(c.label_width) * 4);

  // crop to target (random or center), resizing up if the source is smaller
  int th = c.height, tw = c.width;

  if (c.output_u8) {
    // u8 transport: crop/mirror straight into the batch's HWC slot —
    // no per-image temp, no normalize (deferred to the device)
    uint8_t* out = b->u8.data() + size_t(i) * th * tw * 3;
    if (h >= th && w >= tw) {
      int y0, x0;
      if (c.rand_crop) {
        y0 = int((*rng)() % (h - th + 1));
        x0 = int((*rng)() % (w - tw + 1));
      } else {
        y0 = (h - th) / 2;
        x0 = (w - tw) / 2;
      }
      for (int y = 0; y < th; ++y)
        memcpy(out + size_t(y) * tw * 3,
               img.data() + (size_t(y0 + y) * w + x0) * 3, size_t(tw) * 3);
    } else {
      resize_bilinear(img.data(), h, w, out, th, tw);
    }
    if (c.rand_mirror && ((*rng)() & 1)) {
      for (int y = 0; y < th; ++y) {
        uint8_t* row = out + size_t(y) * tw * 3;
        for (int x = 0; x < tw / 2; ++x) {
          uint8_t* a = row + x * 3;
          uint8_t* z = row + (tw - 1 - x) * 3;
          std::swap(a[0], z[0]);
          std::swap(a[1], z[1]);
          std::swap(a[2], z[2]);
        }
      }
    }
    b->count = std::max(b->count, i + 1);
    return true;
  }

  std::vector<uint8_t> crop(size_t(th) * tw * 3);
  if (h >= th && w >= tw) {
    int y0, x0;
    if (c.rand_crop) {
      y0 = int((*rng)() % (h - th + 1));
      x0 = int((*rng)() % (w - tw + 1));
    } else {
      y0 = (h - th) / 2;
      x0 = (w - tw) / 2;
    }
    for (int y = 0; y < th; ++y)
      memcpy(crop.data() + size_t(y) * tw * 3,
             img.data() + (size_t(y0 + y) * w + x0) * 3, size_t(tw) * 3);
  } else {
    resize_bilinear(img.data(), h, w, crop.data(), th, tw);
  }

  bool mirror = c.rand_mirror && ((*rng)() & 1);

  // HWC u8 -> CHW f32 normalized
  float* out = b->data.data() + size_t(i) * 3 * th * tw;
  for (int ch = 0; ch < 3; ++ch) {
    float m = c.mean[ch], s = c.std[ch];
    float inv = s != 0.f ? 1.f / s : 1.f;
    float* plane = out + size_t(ch) * th * tw;
    for (int y = 0; y < th; ++y) {
      for (int x = 0; x < tw; ++x) {
        int sx = mirror ? (tw - 1 - x) : x;
        plane[size_t(y) * tw + x] =
            (float(crop[(size_t(y) * tw + sx) * 3 + ch]) - m) * inv;
      }
    }
  }
  b->count = std::max(b->count, i + 1);
  return true;
}

// Decodes one record into slot i of the batch, populating the decode
// cache (budget permitting) so later epochs skip straight to
// finish_record.
bool process_record(Pipeline* p, uint32_t rec_idx,
                    const std::vector<char>& rec, Batch* b,
                    int i, std::mt19937* rng) {
  const PipelineConfig& c = p->cfg;
  if (rec.size() < sizeof(IRHeader)) return false;
  IRHeader hdr;
  memcpy(&hdr, rec.data(), sizeof(hdr));
  const uint8_t* payload =
      reinterpret_cast<const uint8_t*>(rec.data()) + sizeof(hdr);
  size_t payload_len = rec.size() - sizeof(hdr);

  auto entry = std::make_shared<CachedImage>();
  entry->label.assign(size_t(c.label_width), 0.f);
  if (hdr.flag > 0) {
    size_t nl = std::min<size_t>(hdr.flag, c.label_width);
    if (payload_len < hdr.flag * 4) return false;
    memcpy(entry->label.data(), payload, nl * 4);
    payload += hdr.flag * 4;
    payload_len -= hdr.flag * 4;
  } else {
    entry->label[0] = hdr.label;
  }

  std::vector<uint8_t> img;
  int h = 0, w = 0;
  // decode-time scaling only when a resize step follows: the scaled
  // decode feeds the same resize_bilinear, so output semantics are
  // unchanged; without resize_short, crops must come from the full-res
  // image, so decode full size
  if (!decode_jpeg(payload, payload_len, &img, &h, &w, c.resize_short))
    return false;

  if (c.resize_short > 0) {
    int shorter = std::min(h, w);
    if (shorter != c.resize_short) {
      int nh = int(int64_t(h) * c.resize_short / shorter);
      int nw = int(int64_t(w) * c.resize_short / shorter);
      std::vector<uint8_t> resized(size_t(nh) * nw * 3);
      resize_bilinear(img.data(), h, w, resized.data(), nh, nw);
      img.swap(resized);
      h = nh; w = nw;
    }
  }

  entry->img = std::move(img);
  entry->h = h;
  entry->w = w;
  bool ok = finish_record(p, *entry, b, i, rng);
  cache_put(p, rec_idx, std::move(entry));
  return ok;
}

void worker_loop(Pipeline* p, int worker_id) {
  FILE* fp = fopen(p->path.c_str(), "rb");
  if (!fp) {
    set_error(p, "worker failed to open " + p->path);
    return;
  }
  const PipelineConfig& c = p->cfg;
  std::mt19937 rng(uint32_t(c.seed + p->epoch * 1315423911u + worker_id));
  std::vector<char> rec;

  for (;;) {
    int bidx = p->next_batch_to_claim.fetch_add(1);
    if (bidx >= p->num_batches) break;
    {
      // bounded prefetch: don't run ahead of the consumer by > depth
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv_space.wait(lk, [&] {
        return p->stopping || bidx < p->next_batch_out + c.prefetch_depth;
      });
      if (p->stopping) break;
    }
    Batch b;
    if (c.output_u8)
      b.u8.assign(size_t(c.batch_size) * c.height * c.width * 3, 0);
    else
      b.data.resize(size_t(c.batch_size) * 3 * c.height * c.width);
    b.label.assign(size_t(c.batch_size) * c.label_width, 0.f);
    int start = bidx * c.batch_size;
    int end = std::min<int>(start + c.batch_size, int(p->order.size()));
    int slot = 0;
    for (int k = start; k < end; ++k) {
      uint32_t rec_idx = p->order[k];
      if (auto cached = cache_get(p, rec_idx)) {
        p->cache_hits.fetch_add(1, std::memory_order_relaxed);
        if (finish_record(p, *cached, &b, slot, &rng)) ++slot;
        continue;
      }
      p->cache_misses.fetch_add(1, std::memory_order_relaxed);
      auto [pos, len] = p->offsets[rec_idx];
      rec.resize(len);
      if (fseek(fp, long(pos), SEEK_SET) != 0 ||
          fread(rec.data(), 1, len, fp) != len) {
        set_error(p, "short read in " + p->path);
        fclose(fp);
        return;
      }
      if (process_record(p, rec_idx, rec, &b, slot, &rng)) {
        ++slot;   // undecodable records are skipped, batch shrinks
      }
    }
    b.count = slot;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->ready.emplace(bidx, std::move(b));
      p->cv_ready.notify_all();
    }
  }
  fclose(fp);
}

void stop_workers(Pipeline* p) {
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stopping = true;
  }
  p->cv_space.notify_all();
  p->cv_ready.notify_all();
  for (auto& t : p->workers) t.join();
  p->workers.clear();
  p->stopping = false;
}

// Moves the next in-order non-empty batch into *out.
// Returns 1 on success, 0 at epoch end, -1 on error.
int take_next(Pipeline* p, Batch* out) {
  std::unique_lock<std::mutex> lk(p->mu);
  // a batch whose records all failed decode is skipped, not surfaced as
  // count==0 (which means epoch end to the caller)
  for (;;) {
    if (p->next_batch_out >= p->num_batches) return 0;
    p->cv_ready.wait(lk, [&] {
      return !p->error.empty() || p->ready.count(p->next_batch_out) > 0;
    });
    if (!p->error.empty()) return -1;
    auto it = p->ready.find(p->next_batch_out);
    *out = std::move(it->second);
    p->ready.erase(it);
    ++p->next_batch_out;
    p->cv_space.notify_all();
    if (out->count > 0) return 1;
  }
}

void start_epoch(Pipeline* p) {
  stop_workers(p);
  p->ready.clear();
  p->leased.clear();  // a reset invalidates outstanding leases
  p->next_batch_out = 0;
  p->next_batch_to_claim = 0;
  p->num_batches =
      int((p->order.size() + p->cfg.batch_size - 1) / p->cfg.batch_size);
  if (p->cfg.shuffle) {
    std::mt19937_64 rng(p->cfg.seed + p->epoch);
    std::shuffle(p->order.begin(), p->order.end(), rng);
  }
  int n = std::max(1, p->cfg.num_threads);
  for (int i = 0; i < n; ++i)
    p->workers.emplace_back(worker_loop, p, i);
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* mxt_recordio_writer_create(const char* path) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return nullptr;
  auto* w = new RecordIOWriter();
  w->fp = fp;
  return w;
}

int mxt_recordio_writer_write(void* handle, const char* buf, uint32_t len,
                              uint64_t* out_pos) {
  auto* w = static_cast<RecordIOWriter*>(handle);
  if (out_pos) *out_pos = ftell(w->fp);
  if (!write_record(w->fp, buf, len)) return -1;
  ++w->nrecords;
  return 0;
}

void mxt_recordio_writer_free(void* handle) {
  auto* w = static_cast<RecordIOWriter*>(handle);
  if (w->fp) fclose(w->fp);
  delete w;
}

void* mxt_recordio_reader_create(const char* path) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return nullptr;
  auto* r = new RecordIOReader();
  r->fp = fp;
  return r;
}

// Returns payload length (>=0) with *out pointing at an internal buffer
// valid until the next call, -1 at clean EOF, -2 on a corrupt record.
int64_t mxt_recordio_reader_read(void* handle, const char** out) {
  auto* r = static_cast<RecordIOReader*>(handle);
  int rc = read_record(r->fp, &r->buf);
  if (rc != 0) return rc;
  *out = r->buf.data();
  return int64_t(r->buf.size());
}

uint64_t mxt_recordio_reader_tell(void* handle) {
  return ftell(static_cast<RecordIOReader*>(handle)->fp);
}

int mxt_recordio_reader_seek(void* handle, uint64_t pos) {
  return fseek(static_cast<RecordIOReader*>(handle)->fp, long(pos), SEEK_SET);
}

void mxt_recordio_reader_free(void* handle) {
  auto* r = static_cast<RecordIOReader*>(handle);
  if (r->fp) fclose(r->fp);
  delete r;
}

// --- image pipeline --------------------------------------------------------

void* mxt_pipeline_create(const char* rec_path, int batch_size, int height,
                          int width, int label_width, int num_threads,
                          int prefetch_depth, int resize_short, int shuffle,
                          int rand_crop, int rand_mirror, uint64_t seed,
                          const float* mean, const float* stdv,
                          int output_u8, uint64_t cache_bytes) {
  auto* p = new Pipeline();
  p->path = rec_path;
  p->cfg = PipelineConfig{batch_size, height, width, label_width,
                          num_threads, std::max(1, prefetch_depth),
                          resize_short, shuffle, rand_crop, rand_mirror,
                          seed, {mean[0], mean[1], mean[2]},
                          {stdv[0], stdv[1], stdv[2]}, output_u8,
                          cache_bytes};
  if (!scan_offsets(p)) {
    delete p;
    return nullptr;
  }
  // probe: the first record must JPEG-decode, otherwise this dataset is
  // not ours to serve (e.g. PNG payloads) — fail so the caller can fall
  // back to a decoder that handles it, instead of yielding empty epochs
  {
    FILE* fp = fopen(p->path.c_str(), "rb");
    std::vector<char> rec(p->offsets[0].second);
    bool ok = fp != nullptr &&
              fseek(fp, long(p->offsets[0].first), SEEK_SET) == 0 &&
              fread(rec.data(), 1, rec.size(), fp) == rec.size();
    if (fp) fclose(fp);
    if (ok && rec.size() > sizeof(IRHeader)) {
      IRHeader hdr;
      memcpy(&hdr, rec.data(), sizeof(hdr));
      size_t off = sizeof(hdr) + size_t(hdr.flag) * 4;
      std::vector<uint8_t> img;
      int h = 0, w = 0;
      ok = off < rec.size() &&
           decode_jpeg(reinterpret_cast<const uint8_t*>(rec.data()) + off,
                       rec.size() - off, &img, &h, &w);
    }
    if (!ok) {
      delete p;
      return nullptr;
    }
  }
  p->order.resize(p->offsets.size());
  for (uint32_t i = 0; i < p->order.size(); ++i) p->order[i] = i;
  start_epoch(p);
  return p;
}

int64_t mxt_pipeline_num_records(void* handle) {
  return int64_t(static_cast<Pipeline*>(handle)->offsets.size());
}

// Blocks for the next decoded batch. Returns count (0 = epoch end, -1 =
// error; message via mxt_pipeline_error). Pointers valid until the next
// next()/reset()/free(). f32 mode only — u8 batches go through the
// lease API below.
int mxt_pipeline_next(void* handle, const float** data, const float** label) {
  auto* p = static_cast<Pipeline*>(handle);
  if (p->cfg.output_u8) {
    set_error(p, "mxt_pipeline_next: pipeline is in u8 mode, use "
                 "mxt_pipeline_next_lease");
    return -1;
  }
  int rc = take_next(p, &p->current);
  if (rc <= 0) return rc;
  *data = p->current.data.data();
  *label = p->current.label.data();
  return p->current.count;
}

// Zero-copy variant: the batch buffer stays owned by the pipeline until
// mxt_pipeline_return(lease_id) — the caller may wrap it (numpy
// as_array) without a defensive copy and hold it across further
// next_lease calls. *data points at u8 NHWC (u8 mode) or f32 NCHW (f32
// mode). Returns count (0 = epoch end, -1 = error).
int mxt_pipeline_next_lease(void* handle, const void** data,
                            const float** label, uint64_t* lease_id) {
  auto* p = static_cast<Pipeline*>(handle);
  Batch b;
  int rc = take_next(p, &b);
  if (rc <= 0) return rc;
  std::lock_guard<std::mutex> lk(p->mu);
  uint64_t lid = p->next_lease_id++;
  Batch& slot = p->leased[lid];
  slot = std::move(b);
  *data = p->cfg.output_u8
              ? static_cast<const void*>(slot.u8.data())
              : static_cast<const void*>(slot.data.data());
  *label = slot.label.data();
  *lease_id = lid;
  return slot.count;
}

// Releases a leased batch buffer. Returns 0, or -1 for an unknown id
// (double return / id from before a reset).
int mxt_pipeline_return(void* handle, uint64_t lease_id) {
  auto* p = static_cast<Pipeline*>(handle);
  std::lock_guard<std::mutex> lk(p->mu);
  return p->leased.erase(lease_id) ? 0 : -1;
}

// Number of batches currently leased out (telemetry / leak checks).
int mxt_pipeline_leased(void* handle) {
  auto* p = static_cast<Pipeline*>(handle);
  std::lock_guard<std::mutex> lk(p->mu);
  return int(p->leased.size());
}

// Decode-cache counters (telemetry): lifetime hits/misses and bytes
// currently held.
void mxt_pipeline_cache_stats(void* handle, uint64_t* hits,
                              uint64_t* misses, uint64_t* bytes) {
  auto* p = static_cast<Pipeline*>(handle);
  if (hits) *hits = p->cache_hits.load(std::memory_order_relaxed);
  if (misses) *misses = p->cache_misses.load(std::memory_order_relaxed);
  if (bytes) {
    std::lock_guard<std::mutex> lk(p->cache_mu);
    *bytes = p->cache_used;
  }
}

const char* mxt_pipeline_error(void* handle) {
  return static_cast<Pipeline*>(handle)->error.c_str();
}

// Rewinds to a fresh epoch (reshuffling if configured).
void mxt_pipeline_reset(void* handle) {
  auto* p = static_cast<Pipeline*>(handle);
  ++p->epoch;
  start_epoch(p);
}

void mxt_pipeline_free(void* handle) {
  auto* p = static_cast<Pipeline*>(handle);
  stop_workers(p);
  delete p;
}

}  // extern "C"
