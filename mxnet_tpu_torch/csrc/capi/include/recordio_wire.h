// RecordIO wire-format constants shared by the native sharded reader
// (src/recordio.cc) and the RecordIO C API (src/c_api_recordio.cc); the
// Python mirror is mxnet_tpu_torch/recordio.py. Framing (reference dmlc-core
// recordio): [u32 magic][u32 lrec][payload][pad to 4B], lrec>>29 =
// continuation flag (0 whole, 1 first, 2 last, 3 middle), low 29 bits =
// chunk length.
#ifndef MXTPU_RECORDIO_WIRE_H_
#define MXTPU_RECORDIO_WIRE_H_

#include <cstdint>
#include <cstddef>

namespace mxt_wire {

constexpr uint32_t kMagic = 0xced7230a;
constexpr uint32_t kMaxChunk = (1u << 29) - 1;

inline uint32_t cflag_of(uint32_t lrec) { return lrec >> 29; }
inline uint32_t len_of(uint32_t lrec) { return lrec & kMaxChunk; }
inline uint32_t lrec_of(uint32_t cflag, uint32_t len) {
  return (cflag << 29) | len;
}
inline size_t pad_of(size_t len) { return (4 - len % 4) % 4; }

}  // namespace mxt_wire

#endif  // MXTPU_RECORDIO_WIRE_H_
