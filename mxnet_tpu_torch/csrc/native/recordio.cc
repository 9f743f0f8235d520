// Native RecordIO reader/writer + threaded sharded reader — rebuild of the
// reference's data-ingest bottom layer (reference: dmlc-core recordio framing
// consumed by src/io/iter_image_recordio_2.cc:28-80 — InputSplit chunk
// reading with part_index/num_parts sharding, feeding a background parser;
// python mirror python/mxnet/recordio.py).
//
// Wire format (identical to the reference so .rec files interchange):
//   [uint32 magic 0xced7230a][uint32 lrec][payload][pad to 4B]
//   lrec>>29 = continuation flag (0 whole, 1 first, 2 last, 3 middle),
//   lrec&((1<<29)-1) = payload length.
//
// The threaded reader owns a byte-range shard of the file: it starts at the
// first magic-aligned record at/after its range start (the reference's
// InputSplit alignment trick) and stops once a record *starts* at/after the
// range end. Records are produced into a bounded ring consumed from Python
// (or any C caller) one record at a time.

#include <cstdint>

#include "include/recordio_wire.h"
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
void* mxt_alloc(size_t nbytes);
void mxt_free(void* p, size_t nbytes);
}

namespace mxt {

using mxt_wire::kMagic;

struct Record {
  char* data;
  size_t len;
};

class RecReader {
 public:
  RecReader(const char* path, int part_index, int num_parts, int queue_size)
      : queue_cap_(queue_size < 1 ? 1 : queue_size) {
    f_ = fopen(path, "rb");
    if (!f_) {
      failed_ = true;
      done_ = true;
      return;
    }
    fseek(f_, 0, SEEK_END);
    int64_t size = ftell(f_);
    if (num_parts < 1) num_parts = 1;
    begin_ = size * part_index / num_parts;
    end_ = size * (part_index + 1) / num_parts;
    thread_ = std::thread([this] { ProducerLoop(); });
  }

  ~RecReader() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_space_.notify_all();
    if (thread_.joinable()) thread_.join();
    std::unique_lock<std::mutex> lk(mu_);
    for (auto& r : queue_) mxt_free(r.data, r.len);
    queue_.clear();
    if (f_) fclose(f_);
  }

  // Pop next record. Returns 1 and fills (*data,*len) — caller must
  // mxt_rec_free() it — or 0 at end-of-shard / error.
  int Next(char** data, size_t* len) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_data_.wait(lk, [&] { return !queue_.empty() || done_; });
    if (queue_.empty()) return 0;
    Record r = queue_.front();
    queue_.pop_front();
    lk.unlock();
    cv_space_.notify_one();
    *data = r.data;
    *len = r.len;
    return 1;
  }

  bool failed() const { return failed_; }

 private:
  // Scan forward from `begin_` to the first well-formed record header whose
  // continuation flag is 0 or 1 (a record START, not a middle chunk).
  bool SeekFirstRecord() {
    int64_t pos = (begin_ + 3) & ~int64_t(3);
    // bound is pos < end_, not pos+8 <= end_: a record may START in the last
    // <8 bytes of the shard range (the header itself extends past end_ into
    // the next shard's bytes, which is fine — ownership is by start offset).
    for (; pos < end_; pos += 4) {
      if (fseek(f_, pos, SEEK_SET) != 0) return false;
      uint32_t hdr[2];
      if (fread(hdr, 4, 2, f_) != 2) return false;
      uint32_t cflag = hdr[1] >> 29;
      if (hdr[0] == kMagic && (cflag == 0 || cflag == 1)) {
        fseek(f_, pos, SEEK_SET);
        return true;
      }
    }
    return false;
  }

  // Read one full (possibly multi-chunk) record into a pooled buffer.
  bool ReadRecord(std::string* out) {
    out->clear();
    for (;;) {
      uint32_t hdr[2];
      if (fread(hdr, 4, 2, f_) != 2) return false;
      if (hdr[0] != kMagic) return false;
      uint32_t cflag = hdr[1] >> 29;
      uint32_t len = hdr[1] & ((1u << 29) - 1);
      size_t off = out->size();
      out->resize(off + len);
      if (len && fread(&(*out)[off], 1, len, f_) != len) return false;
      size_t pad = mxt_wire::pad_of(len);
      if (pad) fseek(f_, pad, SEEK_CUR);
      if (cflag == 0 || cflag == 2) return true;
    }
  }

  void ProducerLoop() {
    if (!SeekFirstRecord()) {
      std::unique_lock<std::mutex> lk(mu_);
      done_ = true;
      cv_data_.notify_all();
      return;
    }
    std::string buf;
    for (;;) {
      int64_t start = ftell(f_);
      if (start >= end_) break;  // record starting past shard end: next part's
      if (!ReadRecord(&buf)) break;
      char* mem = static_cast<char*>(mxt_alloc(buf.size()));
      if (!mem) break;  // allocation failure ends the shard, not the process
      memcpy(mem, buf.data(), buf.size());
      std::unique_lock<std::mutex> lk(mu_);
      cv_space_.wait(lk, [&] { return queue_.size() < queue_cap_ || stop_; });
      if (stop_) {
        mxt_free(mem, buf.size());
        break;
      }
      queue_.push_back({mem, buf.size()});
      cv_data_.notify_one();
    }
    std::unique_lock<std::mutex> lk(mu_);
    done_ = true;
    cv_data_.notify_all();
  }

  FILE* f_ = nullptr;
  int64_t begin_ = 0, end_ = 0;
  size_t queue_cap_;
  std::thread thread_;
  std::mutex mu_;
  std::condition_variable cv_data_, cv_space_;
  std::deque<Record> queue_;
  bool done_ = false, stop_ = false, failed_ = false;
};

}  // namespace mxt

extern "C" {

void* mxt_rec_reader_open(const char* path, int part_index, int num_parts,
                          int queue_size) {
  auto* r = new mxt::RecReader(path, part_index, num_parts, queue_size);
  if (r->failed()) {
    delete r;
    return nullptr;
  }
  return r;
}

int mxt_rec_reader_next(void* h, char** data, size_t* len) {
  return static_cast<mxt::RecReader*>(h)->Next(data, len);
}

void mxt_rec_free(char* data, size_t len) { mxt_free(data, len); }

void mxt_rec_reader_close(void* h) { delete static_cast<mxt::RecReader*>(h); }

}  // extern "C"
