// RecordIO C API — pure C++ (no embedded Python), the reference's
// MXRecordIO* family (include/mxnet/c_api.h: MXRecordIOWriterCreate :~960,
// MXRecordIOReaderCreate, WriteRecord/ReadRecord/Tell/Seek/Free).
//
// Framing is the reference's recordio wire format (dmlc-core recordio,
// python mirror mxnet_tpu/recordio.py, native sharded reader
// src/recordio.cc): [u32 magic 0xced7230a][u32 lrec][payload][pad to 4B],
// lrec>>29 = continuation flag, lrec&((1<<29)-1) = chunk length. The writer
// splits over-long records into first/middle/last chunks exactly like the
// reference so files byte-interchange with recordio.py and the reference
// itself; the reader reassembles them.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>

// public declarations — including them compile-checks every signature
#include "include/c_train_api.h"
#include "include/recordio_wire.h"

#define MXNET_DLL extern "C" __attribute__((visibility("default")))

void mxtpu_set_last_error(const std::string& msg);   // c_predict_api.cc
void mxtpu_set_train_error(const std::string& msg);  // c_api_train.cc

namespace {

using mxt_wire::kMagic;
using mxt_wire::kMaxChunk;

struct RecIO {
  FILE* f;
  bool writer;
  std::string buf;  // reader: last record, stable until next read
};

int fail(const char* msg) {
  // both error channels: the header documents MXTrainGetLastError, and the
  // predict shim's MXGetLastError is the reference's canonical accessor
  mxtpu_set_last_error(msg);
  mxtpu_set_train_error(msg);
  return -1;
}

}  // namespace

MXNET_DLL int MXRecordIOWriterCreate(const char* uri, RecordIOHandle* out) {
  FILE* f = std::fopen(uri, "wb");
  if (!f) return fail("cannot open for write");
  *out = new RecIO{f, true, {}};
  return 0;
}

MXNET_DLL int MXRecordIOReaderCreate(const char* uri, RecordIOHandle* out) {
  FILE* f = std::fopen(uri, "rb");
  if (!f) return fail("cannot open for read");
  *out = new RecIO{f, false, {}};
  return 0;
}

MXNET_DLL int MXRecordIOWriterFree(RecordIOHandle h) {
  auto* r = static_cast<RecIO*>(h);
  if (!r) return 0;
  // fclose performs the final flush — a full disk (ENOSPC) surfaces HERE,
  // not in the buffered writes, so its result must be checked
  int rc = r->f ? std::fclose(r->f) : 0;
  delete r;
  return rc == 0 ? 0 : fail("close/flush failed (disk full?)");
}

MXNET_DLL int MXRecordIOReaderFree(RecordIOHandle h) {
  return MXRecordIOWriterFree(h);
}

MXNET_DLL int MXRecordIOWriterWriteRecord(RecordIOHandle h, const char* buf,
                                          size_t size) {
  auto* r = static_cast<RecIO*>(h);
  if (!r->writer) return fail("handle is a reader");
  size_t off = 0;
  bool first = true;
  do {
    size_t chunk = size - off < kMaxChunk ? size - off : kMaxChunk;
    bool last = off + chunk == size;
    // cflag: 0 whole, 1 first, 2 last, 3 middle (reference recordio)
    uint32_t cflag = first ? (last ? 0u : 1u) : (last ? 2u : 3u);
    uint32_t hdr[2] = {kMagic, mxt_wire::lrec_of(
                                   cflag, static_cast<uint32_t>(chunk))};
    if (std::fwrite(hdr, 4, 2, r->f) != 2) return fail("short write");
    if (chunk && std::fwrite(buf + off, 1, chunk, r->f) != chunk)
      return fail("short write");
    static const char zeros[4] = {0, 0, 0, 0};
    size_t pad = mxt_wire::pad_of(chunk);
    if (pad && std::fwrite(zeros, 1, pad, r->f) != pad)
      return fail("short write");
    off += chunk;
    first = false;
  } while (off < size);
  return 0;
}

MXNET_DLL int MXRecordIOWriterTell(RecordIOHandle h, size_t* pos) {
  auto* r = static_cast<RecIO*>(h);
  long p = std::ftell(r->f);
  if (p < 0) return fail("tell failed");
  *pos = static_cast<size_t>(p);
  return 0;
}

/* Returns 0 with *out_buf=NULL at end-of-file (the reference's convention:
 * read past the end yields an empty record). The returned pointer stays
 * valid until the next read on the same handle. */
MXNET_DLL int MXRecordIOReaderReadRecord(RecordIOHandle h,
                                         const char** out_buf,
                                         size_t* out_size) {
  auto* r = static_cast<RecIO*>(h);
  if (r->writer) return fail("handle is a writer");
  r->buf.clear();
  bool mid_record = false;
  for (;;) {
    uint32_t hdr[2];
    // byte-granular read so a 1-7-byte trailing fragment is distinguishable
    // from a cleanly absent header
    size_t got = std::fread(hdr, 1, 8, r->f);
    if (got != 8) {
      // clean EOF only at a record boundary with a fully-absent header;
      // a partial header or EOF between chunks is data loss, not EOF
      if (got == 0 && !mid_record && std::feof(r->f)) {
        *out_buf = nullptr;
        *out_size = 0;
        return 0;
      }
      return fail(mid_record ? "file truncated mid-record"
                             : "file truncated mid-header");
    }
    if (hdr[0] != kMagic) return fail("bad record magic");
    uint32_t cflag = mxt_wire::cflag_of(hdr[1]);
    uint32_t len = mxt_wire::len_of(hdr[1]);
    size_t off = r->buf.size();
    r->buf.resize(off + len);
    if (len && std::fread(&r->buf[off], 1, len, r->f) != len)
      return fail("truncated record");
    size_t pad = mxt_wire::pad_of(len);
    if (pad) std::fseek(r->f, static_cast<long>(pad), SEEK_CUR);
    if (cflag == 0 || cflag == 2) break;  // whole or last chunk
    mid_record = true;
  }
  *out_buf = r->buf.data();
  *out_size = r->buf.size();
  return 0;
}

MXNET_DLL int MXRecordIOReaderSeek(RecordIOHandle h, size_t pos) {
  auto* r = static_cast<RecIO*>(h);
  if (std::fseek(r->f, static_cast<long>(pos), SEEK_SET) != 0)
    return fail("seek failed");
  return 0;
}
