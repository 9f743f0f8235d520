// Native decode->augment->batch pipeline stage (reference:
// src/io/iter_image_recordio_2.cc ImageRecordIOParser2 — chunked InputSplit
// reading + OMP-parallel decode/augment into ordered InstVector batches,
// registered :559 — layered under iter_batchloader.h / iter_prefetcher.h).
//
// Shape here: N worker threads pull (seq, record) from the sharded RecReader
// ring (src/recordio.cc, already thread-safe), JPEG-decode (decode.cc),
// augment (augment.cc: resize-shortest-edge -> center/random crop ->
// horizontal flip), and deposit into an ordered reassembly map; one
// assembler thread drains the map in sequence order into uint8-HWC batch
// buffers and parks complete batches in a bounded output ring the python
// consumer (or any C caller) pops. Zero Python-thread involvement between
// record bytes and the assembled wire batch — the python side's only work
// per batch is one memcpy into a numpy array.
//
// Ordering/quarantine contract mirrors io_image.py's batcher: batches keep
// record order; corrupt records are skipped but still claim their sequence
// number so reassembly never stalls; past the max_bad budget the pipeline
// fails fast and the error surfaces from mxt_pipe_next after any batches
// assembled before the overflow.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include "include/pipe_api.h"

extern "C" {
void* mxt_alloc(size_t nbytes);
void mxt_free(void* p, size_t nbytes);
void* mxt_rec_reader_open(const char* path, int part_index, int num_parts,
                          int queue_size);
int mxt_rec_reader_next(void* h, char** data, size_t* len);
void mxt_rec_free(char* data, size_t len);
void mxt_rec_reader_close(void* h);
}

namespace mxt_aug {
void resize_bilinear(const uint8_t* src, int sh, int sw, int c, uint8_t* dst,
                     int dh, int dw);
void scale_down(int sw, int sh, int* w, int* h);
void resize_short_dims(int w, int h, int size, int* nw, int* nh);
}  // namespace mxt_aug

namespace mxt_pipe {

using Clock = std::chrono::steady_clock;

inline double seconds_since(Clock::time_point t0) {
  return std::chrono::duration<double>(Clock::now() - t0).count();
}

// splitmix64: deterministic per-worker seed mix of (seed, epoch, wid) — the
// native analog of io_image.py's per-worker seeded stream contract. The
// native and python streams are both deterministic per (seed, epoch, worker)
// but are NOT the same sequence (python draws from CPython's global MT).
inline uint64_t mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

struct Item {
  uint8_t* img = nullptr;  // out_h*out_w*3, null = quarantined record
  size_t img_bytes = 0;
  std::vector<float> label;
};

struct Batch {
  uint8_t* data = nullptr;
  size_t data_bytes = 0;
  float* label = nullptr;  // batch_size * label_width, mxt_alloc'd
  size_t label_bytes = 0;
  int pad = 0;
};

class Pipe {
 public:
  explicit Pipe(const MXTPipeConfig& cfg) : cfg_(cfg) {
    img_bytes_ = static_cast<size_t>(cfg_.out_h) * cfg_.out_w * cfg_.out_c;
    batch_bytes_ = img_bytes_ * cfg_.batch_size;
    label_bytes_ = static_cast<size_t>(cfg_.batch_size) * cfg_.label_width *
                   sizeof(float);
    pending_cap_ = cfg_.batch_size * 4;
    if (pending_cap_ < 64) pending_cap_ = 64;
    if (pending_cap_ < cfg_.num_threads * 16)
      pending_cap_ = cfg_.num_threads * 16;
    prefetch_ = cfg_.prefetch < 1 ? 1 : cfg_.prefetch;
    reader_ = mxt_rec_reader_open(cfg_.path, cfg_.part_index, cfg_.num_parts,
                                  cfg_.num_threads * 8);
    if (!reader_) {
      fail("cannot open " + std::string(cfg_.path));
      eos_ = true;
      return;
    }
    active_workers_ = cfg_.num_threads;
    for (int i = 0; i < cfg_.num_threads; ++i)
      workers_.emplace_back([this, i] { WorkerLoop(i); });
    assembler_ = std::thread([this] { AssemblerLoop(); });
  }

  ~Pipe() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_data_.notify_all();
    cv_space_.notify_all();
    cv_out_.notify_all();
    for (auto& t : workers_)
      if (t.joinable()) t.join();
    if (assembler_.joinable()) assembler_.join();
    if (reader_) mxt_rec_reader_close(reader_);
    std::lock_guard<std::mutex> lk(mu_);
    for (auto& kv : pending_) FreeItem(&kv.second);
    for (auto& b : out_q_) FreeBatch(&b);
    FreeBatch(&fill_);
  }

  // 1 batch, 0 end-of-shard, -1 error; caller owns (*data, *label) until
  // Release
  int Pop(uint8_t** data, float** label, int* pad) {
    Batch b;
    {
      std::unique_lock<std::mutex> lk(mu_);
      cv_out_.wait(lk, [&] { return !out_q_.empty() || eos_ || failed_; });
      if (out_q_.empty()) return failed_ ? -1 : 0;
      b = out_q_.front();
      out_q_.pop_front();
    }
    cv_out_.notify_all();
    *data = b.data;
    *label = b.label;
    *pad = b.pad;
    batches_.fetch_add(1, std::memory_order_relaxed);
    return 1;
  }

  void Release(uint8_t* data, float* label) {
    if (data) mxt_free(data, batch_bytes_);
    if (label) mxt_free(label, label_bytes_);
  }

  // copying variant (C callers without a release discipline)
  int Next(uint8_t* data, float* label, int* pad) {
    uint8_t* d = nullptr;
    float* l = nullptr;
    int rc = Pop(&d, &l, pad);
    if (rc != 1) return rc;
    std::memcpy(data, d, batch_bytes_);
    std::memcpy(label, l, label_bytes_);
    Release(d, l);
    return 1;
  }

  const char* Error() {
    std::lock_guard<std::mutex> lk(mu_);
    return error_.c_str();
  }

  void Stats(double* out, int n) {
    double vals[6] = {
        static_cast<double>(bad_.load(std::memory_order_relaxed)),
        decode_ns_.load(std::memory_order_relaxed) * 1e-9,
        augment_ns_.load(std::memory_order_relaxed) * 1e-9,
        assemble_ns_.load(std::memory_order_relaxed) * 1e-9,
        static_cast<double>(decoded_.load(std::memory_order_relaxed)),
        static_cast<double>(batches_.load(std::memory_order_relaxed)),
    };
    for (int i = 0; i < n && i < 6; ++i) out[i] = vals[i];
  }

 private:
  void fail(const std::string& msg) {
    // caller must NOT hold mu_
    {
      std::lock_guard<std::mutex> lk(mu_);
      if (!failed_) error_ = msg;
      failed_ = true;
    }
    cv_data_.notify_all();
    cv_space_.notify_all();
    cv_out_.notify_all();
  }

  void FreeItem(Item* it) {
    if (it->img) mxt_free(it->img, it->img_bytes);
    it->img = nullptr;
  }

  void FreeBatch(Batch* b) {
    if (b->data) mxt_free(b->data, b->data_bytes);
    if (b->label) mxt_free(b->label, b->label_bytes);
    b->data = nullptr;
    b->label = nullptr;
  }

  // false on allocation failure (fail() already called)
  bool AllocBatch(Batch* b) {
    b->data = static_cast<uint8_t*>(mxt_alloc(batch_bytes_));
    b->data_bytes = batch_bytes_;
    b->label = static_cast<float*>(mxt_alloc(label_bytes_));
    b->label_bytes = label_bytes_;
    if (b->data && b->label) {
      std::memset(b->label, 0, label_bytes_);
      return true;
    }
    FreeBatch(b);
    fail("native decode: batch buffer allocation failed");
    return false;
  }

  // Parse the recordio payload: IRHeader (u32 flag, f32 label, u64 id, u64
  // id2 — recordio.py's "<IfQQ"), flag>0 => flag float32 labels follow,
  // then the image bytes. False = malformed.
  bool ParseRecord(const char* rec, size_t len, std::vector<float>* label,
                   const uint8_t** img, size_t* img_len) {
    if (len < 24) return false;
    uint32_t flag;
    float lab0;
    std::memcpy(&flag, rec, 4);
    std::memcpy(&lab0, rec + 4, 4);
    size_t off = 24;
    label->assign(static_cast<size_t>(cfg_.label_width), 0.0f);
    if (flag > 0) {
      if (off + static_cast<size_t>(flag) * 4 > len) return false;
      size_t n = flag < static_cast<uint32_t>(cfg_.label_width)
                     ? flag
                     : static_cast<uint32_t>(cfg_.label_width);
      std::memcpy(label->data(), rec + off, n * 4);
      off += static_cast<size_t>(flag) * 4;
    } else if (cfg_.label_width > 0) {
      (*label)[0] = lab0;
    }
    *img = reinterpret_cast<const uint8_t*>(rec) + off;
    *img_len = len - off;
    return true;
  }

  // decode + augment one record into a ready out_h*out_w*3 image.
  // -1 = corrupt (quarantine), 0 = ok.
  int Process(const uint8_t* jpg, size_t jpg_len, std::mt19937_64* rng,
              uint8_t** out) {
    auto t0 = Clock::now();
    if (cfg_.resize == 0) {
      // packed-dataset fast path: a source already at (out_h, out_w) makes
      // every crop the identity — decode scanlines straight into the output
      // image, no intermediate buffer or copy
      uint8_t* direct = static_cast<uint8_t*>(mxt_alloc(img_bytes_));
      if (!direct) return -1;
      int rc = mxt_decode_jpeg_direct(jpg, jpg_len, direct, cfg_.out_h,
                                      cfg_.out_w);
      if (rc == 1) {
        decode_ns_.fetch_add(
            static_cast<int64_t>(seconds_since(t0) * 1e9),
            std::memory_order_relaxed);
        t0 = Clock::now();
        MaybeMirror(direct, rng);
        augment_ns_.fetch_add(
            static_cast<int64_t>(seconds_since(t0) * 1e9),
            std::memory_order_relaxed);
        *out = direct;
        return 0;
      }
      mxt_free(direct, img_bytes_);
      if (rc < 0) return -1;
    }
    uint8_t* raw = nullptr;
    int h = 0, w = 0;
    if (mxt_decode_jpeg(jpg, jpg_len, &raw, &h, &w) != 0) return -1;
    size_t raw_bytes = static_cast<size_t>(h) * w * 3;
    decode_ns_.fetch_add(
        static_cast<int64_t>(seconds_since(t0) * 1e9),
        std::memory_order_relaxed);

    t0 = Clock::now();
    // resize shortest edge (image.py ResizeAug)
    if (cfg_.resize > 0 && !(h == cfg_.resize && w == cfg_.resize)) {
      int nw, nh;
      mxt_aug::resize_short_dims(w, h, cfg_.resize, &nw, &nh);
      if (nw != w || nh != h) {
        size_t nbytes = static_cast<size_t>(nh) * nw * 3;
        uint8_t* resized = static_cast<uint8_t*>(mxt_alloc(nbytes));
        if (!resized) {
          mxt_free(raw, raw_bytes);
          return -1;
        }
        mxt_aug::resize_bilinear(raw, h, w, 3, resized, nh, nw);
        mxt_free(raw, raw_bytes);
        raw = resized;
        raw_bytes = nbytes;
        h = nh;
        w = nw;
      }
    }
    // crop to (out_w, out_h) via scale_down (image.py CenterCropAug /
    // RandomCropAug: crop a scaled-down rect, then resize it to target)
    int cw = cfg_.out_w, ch = cfg_.out_h;
    mxt_aug::scale_down(w, h, &cw, &ch);
    int x0, y0;
    if (cfg_.crop == 1) {
      x0 = w > cw ? static_cast<int>((*rng)() % (w - cw + 1)) : 0;
      y0 = h > ch ? static_cast<int>((*rng)() % (h - ch + 1)) : 0;
    } else {
      x0 = (w - cw) / 2;
      y0 = (h - ch) / 2;
    }
    uint8_t* out_img = static_cast<uint8_t*>(mxt_alloc(img_bytes_));
    if (!out_img) {
      mxt_free(raw, raw_bytes);
      return -1;
    }
    if (cw == cfg_.out_w && ch == cfg_.out_h) {
      for (int y = 0; y < ch; ++y)
        std::memcpy(out_img + static_cast<size_t>(y) * cw * 3,
                    raw + (static_cast<size_t>(y0 + y) * w + x0) * 3,
                    static_cast<size_t>(cw) * 3);
    } else {
      // crop rect != target: contiguous crop, then Pillow-parity resize
      std::vector<uint8_t> cropped(static_cast<size_t>(ch) * cw * 3);
      for (int y = 0; y < ch; ++y)
        std::memcpy(cropped.data() + static_cast<size_t>(y) * cw * 3,
                    raw + (static_cast<size_t>(y0 + y) * w + x0) * 3,
                    static_cast<size_t>(cw) * 3);
      mxt_aug::resize_bilinear(cropped.data(), ch, cw, 3, out_img,
                               cfg_.out_h, cfg_.out_w);
    }
    mxt_free(raw, raw_bytes);
    MaybeMirror(out_img, rng);
    augment_ns_.fetch_add(
        static_cast<int64_t>(seconds_since(t0) * 1e9),
        std::memory_order_relaxed);
    *out = out_img;
    return 0;
  }

  // horizontal flip with probability mirror_prob (image.py HorizontalFlipAug)
  void MaybeMirror(uint8_t* img, std::mt19937_64* rng) {
    if (cfg_.mirror_prob <= 0.0) return;
    double u = (*rng)() * (1.0 / 18446744073709551616.0);  // [0, 1)
    if (u >= cfg_.mirror_prob) return;
    for (int y = 0; y < cfg_.out_h; ++y) {
      uint8_t* row = img + static_cast<size_t>(y) * cfg_.out_w * 3;
      for (int xl = 0, xr = cfg_.out_w - 1; xl < xr; ++xl, --xr) {
        for (int b = 0; b < 3; ++b)
          std::swap(row[xl * 3 + b], row[xr * 3 + b]);
      }
    }
  }

  void WorkerLoop(int wid) {
    std::mt19937_64 rng(
        mix64(static_cast<uint64_t>(cfg_.seed) * 0x100000001b3ull ^
              mix64(static_cast<uint64_t>(cfg_.epoch) << 20 ^
                    static_cast<uint64_t>(wid))));
    for (;;) {
      char* rec = nullptr;
      size_t rec_len = 0;
      int64_t seq;
      {
        // one lock assigns the sequence number atomically with the pop, so
        // reassembly order == record order regardless of scheduling
        std::lock_guard<std::mutex> lk(reader_mu_);
        if (stopped()) break;
        if (!mxt_rec_reader_next(reader_, &rec, &rec_len)) break;
        seq = reader_seq_++;
      }
      Item item;
      const uint8_t* jpg = nullptr;
      size_t jpg_len = 0;
      bool ok = ParseRecord(rec, rec_len, &item.label, &jpg, &jpg_len);
      if (ok) {
        ok = Process(jpg, jpg_len, &rng, &item.img) == 0;
        if (ok) {
          item.img_bytes = img_bytes_;
          decoded_.fetch_add(1, std::memory_order_relaxed);
        }
      }
      mxt_rec_free(rec, rec_len);
      if (!ok) {
        int64_t nbad = bad_.fetch_add(1, std::memory_order_relaxed) + 1;
        if (cfg_.max_bad >= 0 && nbad > cfg_.max_bad) {
          fail("native decode: " + std::to_string(nbad) +
               " corrupt records exceed MXNET_IO_MAX_BAD_RECORDS=" +
               std::to_string(cfg_.max_bad));
          break;
        }
        // quarantined records still claim their seq (img stays null)
      }
      std::unique_lock<std::mutex> lk(mu_);
      cv_space_.wait(lk, [&] {
        // the holder of next_emit_ must always get through, or reassembly
        // deadlocks against a full pending map
        return stop_ || failed_ ||
               pending_.size() < static_cast<size_t>(pending_cap_) ||
               seq == next_emit_;
      });
      if (stop_ || failed_) {
        lk.unlock();
        FreeItem(&item);
        break;
      }
      pending_.emplace(seq, std::move(item));
      lk.unlock();
      cv_data_.notify_all();
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      --active_workers_;
    }
    cv_data_.notify_all();
  }

  void AssemblerLoop() {
    if (!AllocBatch(&fill_)) return;
    int i = 0;  // slot in the current batch
    for (;;) {
      Item item;
      bool have = false;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_data_.wait(lk, [&] {
          return stop_ || failed_ || pending_.count(next_emit_) ||
                 (active_workers_ == 0 && pending_.empty());
        });
        if (stop_ || failed_) return;
        auto it = pending_.find(next_emit_);
        if (it != pending_.end()) {
          item = std::move(it->second);
          pending_.erase(it);
          ++next_emit_;
          have = true;
        } else if (active_workers_ == 0 && pending_.empty()) {
          break;  // end of shard
        }
      }
      cv_space_.notify_all();
      if (!have || !item.img) continue;  // quarantined record: skip
      auto t0 = Clock::now();
      std::memcpy(fill_.data + static_cast<size_t>(i) * img_bytes_, item.img,
                  img_bytes_);
      std::copy(item.label.begin(), item.label.end(),
                fill_.label + static_cast<size_t>(i) * cfg_.label_width);
      FreeItem(&item);
      ++i;
      assemble_ns_.fetch_add(
          static_cast<int64_t>(seconds_since(t0) * 1e9),
          std::memory_order_relaxed);
      if (i == cfg_.batch_size) {
        if (!EmitBatch(0)) return;
        i = 0;
      }
    }
    if (i > 0) {
      // pad the final batch by wrapping the filled slots (io_image.py's
      // batcher / the reference's round_batch pad semantics)
      for (int j = i; j < cfg_.batch_size; ++j) {
        std::memcpy(fill_.data + static_cast<size_t>(j) * img_bytes_,
                    fill_.data + static_cast<size_t>(j - i) * img_bytes_,
                    img_bytes_);
        std::copy(fill_.label + static_cast<size_t>(j - i) * cfg_.label_width,
                  fill_.label +
                      static_cast<size_t>(j - i + 1) * cfg_.label_width,
                  fill_.label + static_cast<size_t>(j) * cfg_.label_width);
      }
      if (!EmitBatch(cfg_.batch_size - i)) return;
    }
    {
      std::lock_guard<std::mutex> lk(mu_);
      eos_ = true;
    }
    cv_out_.notify_all();
  }

  // park the filled batch in the bounded output ring; false = stopped
  bool EmitBatch(int pad) {
    Batch next;
    if (!AllocBatch(&next)) return false;
    fill_.pad = pad;
    std::unique_lock<std::mutex> lk(mu_);
    cv_out_.wait(lk, [&] {
      return stop_ || failed_ ||
             out_q_.size() < static_cast<size_t>(prefetch_);
    });
    if (stop_ || failed_) {
      lk.unlock();
      FreeBatch(&next);
      return false;
    }
    out_q_.push_back(fill_);
    fill_ = next;
    lk.unlock();
    cv_out_.notify_all();
    return true;
  }

  bool stopped() {
    std::lock_guard<std::mutex> lk(mu_);
    return stop_ || failed_;
  }

  MXTPipeConfig cfg_;
  size_t img_bytes_ = 0, batch_bytes_ = 0, label_bytes_ = 0;
  int pending_cap_ = 0, prefetch_ = 1;
  void* reader_ = nullptr;

  std::mutex reader_mu_;
  int64_t reader_seq_ = 0;

  std::mutex mu_;
  std::condition_variable cv_data_, cv_space_, cv_out_;
  std::map<int64_t, Item> pending_;
  int64_t next_emit_ = 0;
  int active_workers_ = 0;
  std::deque<Batch> out_q_;
  Batch fill_;
  bool stop_ = false, failed_ = false, eos_ = false;
  std::string error_;

  std::atomic<int64_t> bad_{0}, decoded_{0}, batches_{0};
  std::atomic<int64_t> decode_ns_{0}, augment_ns_{0}, assemble_ns_{0};

  std::vector<std::thread> workers_;
  std::thread assembler_;
};

}  // namespace mxt_pipe

extern "C" {

void* mxt_pipe_create(const MXTPipeConfig* cfg) {
  if (!cfg || !cfg->path || cfg->batch_size < 1 || cfg->num_threads < 1 ||
      cfg->out_c != 3 || cfg->label_width < 1)
    return nullptr;
  if (!mxt_pipe_decode_available()) return nullptr;
  return new mxt_pipe::Pipe(*cfg);
}

int mxt_pipe_next(void* h, uint8_t* data, float* label, int* pad) {
  return static_cast<mxt_pipe::Pipe*>(h)->Next(data, label, pad);
}

int mxt_pipe_pop(void* h, uint8_t** data, float** label, int* pad) {
  return static_cast<mxt_pipe::Pipe*>(h)->Pop(data, label, pad);
}

void mxt_pipe_release(void* h, uint8_t* data, float* label) {
  static_cast<mxt_pipe::Pipe*>(h)->Release(data, label);
}

const char* mxt_pipe_error(void* h) {
  return static_cast<mxt_pipe::Pipe*>(h)->Error();
}

void mxt_pipe_stats(void* h, double* out, int n) {
  static_cast<mxt_pipe::Pipe*>(h)->Stats(out, n);
}

void mxt_pipe_close(void* h) { delete static_cast<mxt_pipe::Pipe*>(h); }

}  // extern "C"
