// NDArray save/load wire format shared by the C API (src/c_api_ndarray.cc)
// and the Python-free predict runtime (src/c_predict_pjrt.cc); the Python
// mirror is mxnet_tpu_torch/ndarray.py save/load. Format (reference
// src/ndarray/ndarray.cc:618-717): per array [u32 0xF993FAC8 magic,
// u32 ndim, ndim*u32 dims, i32 dev_type, i32 dev_id, i32 dtype flag, raw
// data]; ndim==0 is the "none" record and stops right after the shape.
// Legacy pre-V1 blobs omit the magic (first word is ndim). A dict file is
// [u64 0x112, u64 reserved, u64 count, records..., u64 n_names, names...].
#ifndef MXTPU_NDARRAY_WIRE_H_
#define MXTPU_NDARRAY_WIRE_H_

#include <cstddef>
#include <cstdint>
#include <string>
#include <vector>

namespace mxt_ndwire {

constexpr uint32_t kNDArrayMagic = 0xF993FAC8u;
constexpr uint64_t kListMagic = 0x112;

// mshadow dtype flags 0..6 (reference) + TPU-build extensions 7..8
// (bfloat16/bool; flags the reference loader rejects, ndarray.py:630)
constexpr int kDTypeSizeTable[] = {4 /*f32*/, 8 /*f64*/, 2 /*f16*/,
                                   1 /*u8*/,  4 /*i32*/, 1 /*i8*/,
                                   8 /*i64*/, 2 /*bf16*/, 1 /*bool*/};
constexpr int kNumWireDTypes =
    static_cast<int>(sizeof(kDTypeSizeTable) / sizeof(int));

struct NdRecord {
  bool none = false;
  int dtype = 0;
  int dev_type = 1;
  int dev_id = 0;
  std::vector<uint32_t> shape;
  std::vector<uint8_t> data;
};

// Reads one record through `rd` (callable: bool(void* dst, size_t n),
// false on short read). `max_dtype` lets the strict-reference caller
// reject the TPU-extension flags. Guards mirror ndarray.py _read_ndarray:
// ndim <= 64, each dim <= 2^31, total bytes <= 2^40 — a corrupt header
// must fail cleanly, never drive a huge allocation or desynchronize.
template <typename ReadFn>
bool read_ndarray_record(ReadFn&& rd, NdRecord* out, std::string* err,
                         int max_dtype = kNumWireDTypes) {
  uint32_t magic = 0, ndim = 0;
  if (!rd(&magic, 4)) { *err = "truncated NDArray blob"; return false; }
  if (magic == kNDArrayMagic) {
    if (!rd(&ndim, 4)) { *err = "truncated NDArray blob"; return false; }
  } else {
    ndim = magic;  // legacy pre-V1 layout: first word is ndim
  }
  if (ndim > 64) { *err = "implausible ndim"; return false; }
  out->shape.resize(ndim);
  for (uint32_t i = 0; i < ndim; ++i) {
    uint32_t s = 0;
    if (!rd(&s, 4)) { *err = "truncated shape"; return false; }
    if (s > (1u << 31)) { *err = "implausible shape"; return false; }
    out->shape[i] = s;
  }
  if (ndim == 0) {  // "none" record: nothing follows the shape
    out->none = true;
    return true;
  }
  int32_t devctx[2] = {1, 0};
  int32_t flag = 0;
  if (!rd(devctx, 8) || !rd(&flag, 4)) {
    *err = "truncated header";
    return false;
  }
  if (flag < 0 || flag >= max_dtype) {
    *err = "unknown dtype flag";
    return false;
  }
  out->dev_type = devctx[0];
  out->dev_id = devctx[1];
  out->dtype = flag;
  size_t n = 1;
  for (uint32_t s : out->shape) {
    if (s != 0 && n > SIZE_MAX / s) { *err = "implausible size"; return false; }
    n *= s;
  }
  size_t bytes = n * kDTypeSizeTable[flag];
  if (bytes > (size_t(1) << 40)) { *err = "implausible size"; return false; }
  out->data.resize(bytes);
  if (!rd(out->data.data(), bytes)) {
    *err = "truncated data";
    return false;
  }
  return true;
}

}  // namespace mxt_ndwire

#endif  // MXTPU_NDARRAY_WIRE_H_
