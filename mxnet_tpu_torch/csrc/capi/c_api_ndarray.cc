// C NDArray API — host-array subset of the reference's c_api.h
// (include/mxnet/c_api.h: MXNDArrayCreate :244, CreateEx, CreateNone :236,
// Free, SyncCopyFromCPU/ToCPU :320-339, WaitToRead/All, GetShape :430,
// GetData :441, GetDType :450, GetContext :459, Save :301, Load :282).
//
// Pure C++ — no embedded Python: these arrays are host-side containers whose
// job is FFI data interchange and .params/.nd file IO in the reference's
// exact binary format (u64 0x112 list magic + u32 0xF993FAC8 per-array magic,
// src/ndarray/ndarray.cc:618-717 — byte-identical to mxnet_tpu/ndarray.py's
// writer, so files round-trip between C, Python, and the reference). Device
// placement is the Python/XLA layer's concern; dev_type is recorded for
// API fidelity but all storage is host memory (the predict API's Python
// bridge is the compute path for C clients).
//
// Build: part of libmxtpu_predict.so (`make c_predict`); a pure-C client
// exercises the surface in tests/test_c_predict.py.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

#include "include/c_array.h"
#include "include/ndarray_wire.h"

#define MXNET_DLL extern "C" __attribute__((visibility("default")))

typedef void* NDArrayHandle;
typedef unsigned int mx_uint;

// route errors into the predict shim's MXGetLastError (the one accessor
// c_api.h documents); defined in c_predict_api.cc, same .so
void mxtpu_set_last_error(const std::string& msg);

namespace {

constexpr uint64_t kListMagic = 0x112;
constexpr uint32_t kNDArrayMagic = 0xF993FAC8;

// type flag -> element size (reference mshadow type flags 0..6)
const int kDTypeSize[] = {4 /*f32*/, 8 /*f64*/, 2 /*f16*/, 1 /*u8*/,
                          4 /*i32*/, 1 /*i8*/, 8 /*i64*/};
constexpr int kNumDTypes = 7;

// per-process storage for Load's returned name/handle tables (the reference
// keeps equivalent ret_ vectors in its thread-local API registry)
struct LoadResult {
  std::vector<NDArrayHandle> handles;
  std::vector<std::string> names;
  std::vector<const char*> name_ptrs;
};
thread_local LoadResult g_load_result;

// overflow-checked element count: 0 on wrap (callers reject), mirroring
// the Python reader's exact-int product guard (ndarray.py:665-673)
size_t nelem_checked(const std::vector<mx_uint>& shape, bool* ok) {
  size_t n = 1;
  *ok = true;
  for (mx_uint s : shape) {
    if (s != 0 && n > SIZE_MAX / s) { *ok = false; return 0; }
    n *= s;
  }
  return n;
}

size_t nelem(const std::vector<mx_uint>& shape) {
  bool ok;
  return nelem_checked(shape, &ok);
}

int fail(const std::string& msg) {
  mxtpu_set_last_error(msg);
  return -1;
}

bool write_one(FILE* f, const CArray& a) {
  uint32_t ndim = a.none ? 0 : static_cast<uint32_t>(a.shape.size());
  if (fwrite(&kNDArrayMagic, 4, 1, f) != 1) return false;
  if (fwrite(&ndim, 4, 1, f) != 1) return false;
  if (ndim == 0) return true;  // none: readers stop at the shape (ndarray.py:663)
  for (mx_uint s : a.shape) {
    uint32_t v = s;
    if (fwrite(&v, 4, 1, f) != 1) return false;
  }
  int32_t ctx[2] = {1, 0};  // saved as cpu, like the reference
  if (fwrite(ctx, 4, 2, f) != 2) return false;
  int32_t flag = a.dtype;
  if (fwrite(&flag, 4, 1, f) != 1) return false;
  return fwrite(a.data.data(), 1, a.data.size(), f) == a.data.size();
}

bool read_exact(FILE* f, void* dst, size_t n) {
  return fread(dst, 1, n, f) == n;
}

CArray* read_one(FILE* f, std::string* err) {
  // shared wire-format reader (include/ndarray_wire.h); this API speaks the
  // strict reference format, so TPU-extension dtype flags are rejected
  mxt_ndwire::NdRecord rec;
  auto rd = [f](void* dst, size_t n) { return read_exact(f, dst, n); };
  if (!mxt_ndwire::read_ndarray_record(rd, &rec, err, kNumDTypes))
    return nullptr;
  auto arr = new CArray();
  arr->none = rec.none;
  arr->dtype = rec.dtype;
  arr->shape.assign(rec.shape.begin(), rec.shape.end());
  arr->data = std::move(rec.data);
  return arr;
}

}  // namespace

MXNET_DLL int MXNDArrayCreateNone(NDArrayHandle* out) {
  auto a = new CArray();
  a->none = true;
  *out = a;
  return 0;
}

MXNET_DLL int MXNDArrayCreateEx(const mx_uint* shape, mx_uint ndim,
                                int dev_type, int dev_id, int delay_alloc,
                                int dtype, NDArrayHandle* out) {
  if (dtype < 0 || dtype >= kNumDTypes) return fail("unknown dtype flag");
  auto a = new CArray();
  a->shape.assign(shape, shape + ndim);
  a->dtype = dtype;
  a->dev_type = dev_type;
  a->dev_id = dev_id;
  if (!delay_alloc) a->data.assign(nelem(a->shape) * kDTypeSize[dtype], 0);
  *out = a;
  return 0;
}

MXNET_DLL int MXNDArrayCreate(const mx_uint* shape, mx_uint ndim, int dev_type,
                              int dev_id, int delay_alloc, NDArrayHandle* out) {
  return MXNDArrayCreateEx(shape, ndim, dev_type, dev_id, delay_alloc, 0, out);
}

// optional observer for handle teardown: the autograd session in
// c_api_train.cc installs itself here so freed handles are purged from its
// id->array maps (a recycled heap address must not resurrect a stale tape
// entry). Null when that family is unused or not linked in.
void (*mxtpu_ndarray_free_hook)(void*) = nullptr;

MXNET_DLL int MXNDArrayFree(NDArrayHandle handle) {
  if (mxtpu_ndarray_free_hook) mxtpu_ndarray_free_hook(handle);
  delete static_cast<CArray*>(handle);
  return 0;
}

MXNET_DLL int MXNDArraySyncCopyFromCPU(NDArrayHandle handle, const void* data,
                                       size_t size) {
  auto a = static_cast<CArray*>(handle);
  size_t bytes = size * kDTypeSize[a->dtype];
  if (size != nelem(a->shape)) return fail("size mismatch in SyncCopyFromCPU");
  a->data.resize(bytes);
  std::memcpy(a->data.data(), data, bytes);
  a->none = false;
  return 0;
}

MXNET_DLL int MXNDArraySyncCopyToCPU(NDArrayHandle handle, void* data,
                                     size_t size) {
  auto a = static_cast<CArray*>(handle);
  size_t bytes = size * kDTypeSize[a->dtype];
  if (size != nelem(a->shape) || bytes > a->data.size())
    return fail("size mismatch in SyncCopyToCPU");
  std::memcpy(data, a->data.data(), bytes);
  return 0;
}

// host arrays are always materialized: waits are immediate (the async story
// lives in the Python/XLA layer)
MXNET_DLL int MXNDArrayWaitToRead(NDArrayHandle) { return 0; }
MXNET_DLL int MXNDArrayWaitToWrite(NDArrayHandle) { return 0; }
MXNET_DLL int MXNDArrayWaitAll() { return 0; }

MXNET_DLL int MXNDArrayGetShape(NDArrayHandle handle, mx_uint* out_dim,
                                const mx_uint** out_pdata) {
  auto a = static_cast<CArray*>(handle);
  *out_dim = static_cast<mx_uint>(a->shape.size());
  *out_pdata = a->shape.data();
  return 0;
}

MXNET_DLL int MXNDArrayGetData(NDArrayHandle handle, void** out_pdata) {
  auto a = static_cast<CArray*>(handle);
  *out_pdata = a->data.data();
  return 0;
}

MXNET_DLL int MXNDArrayGetDType(NDArrayHandle handle, int* out_dtype) {
  *out_dtype = static_cast<CArray*>(handle)->dtype;
  return 0;
}

MXNET_DLL int MXNDArrayGetContext(NDArrayHandle handle, int* out_dev_type,
                                  int* out_dev_id) {
  auto a = static_cast<CArray*>(handle);
  *out_dev_type = a->dev_type;
  *out_dev_id = a->dev_id;
  return 0;
}

MXNET_DLL int MXNDArraySave(const char* fname, mx_uint num_args,
                            NDArrayHandle* args, const char** keys) {
  FILE* f = std::fopen(fname, "wb");
  if (!f) return fail(std::string("cannot open ") + fname);
  // refuse to write a header whose data bytes cannot follow (delay_alloc
  // arrays never filled): a short blob would desync every later record
  for (mx_uint i = 0; i < num_args; ++i) {
    auto* a = static_cast<CArray*>(args[i]);
    if (!a->none && a->data.size() != nelem(a->shape) * kDTypeSize[a->dtype]) {
      std::fclose(f);
      return fail("array has no materialized data (delay_alloc unfilled)");
    }
  }
  bool ok = true;
  uint64_t header[3] = {kListMagic, 0, num_args};
  ok = fwrite(header, 8, 3, f) == 3;
  for (mx_uint i = 0; ok && i < num_args; ++i)
    ok = write_one(f, *static_cast<CArray*>(args[i]));
  uint64_t n_names = keys ? num_args : 0;
  ok = ok && fwrite(&n_names, 8, 1, f) == 1;
  for (mx_uint i = 0; ok && keys && i < num_args; ++i) {
    uint64_t len = std::strlen(keys[i]);
    ok = fwrite(&len, 8, 1, f) == 1 &&
         fwrite(keys[i], 1, len, f) == len;
  }
  std::fclose(f);
  return ok ? 0 : fail("short write");
}

MXNET_DLL int MXNDArrayLoad(const char* fname, mx_uint* out_size,
                            NDArrayHandle** out_arr, mx_uint* out_name_size,
                            const char*** out_names) {
  FILE* f = std::fopen(fname, "rb");
  if (!f) return fail(std::string("cannot open ") + fname);
  uint64_t magic = 0, reserved = 0, count = 0;
  if (!read_exact(f, &magic, 8) || magic != kListMagic ||
      !read_exact(f, &reserved, 8) || !read_exact(f, &count, 8)) {
    std::fclose(f);
    return fail("invalid NDArray list file");
  }
  LoadResult res;
  std::string err;
  for (uint64_t i = 0; i < count; ++i) {
    CArray* a = read_one(f, &err);
    if (!a) {
      for (auto h : res.handles) delete static_cast<CArray*>(h);
      std::fclose(f);
      return fail(err);
    }
    res.handles.push_back(a);
  }
  uint64_t n_names = 0;
  if (read_exact(f, &n_names, 8) && n_names == count) {
    for (uint64_t i = 0; i < n_names; ++i) {
      uint64_t len;
      if (!read_exact(f, &len, 8) || len > (1u << 20)) {
        n_names = 0;
        res.names.clear();  // all-or-nothing: partial tables mis-associate
        break;
      }
      std::string name(len, '\0');
      if (!read_exact(f, name.data(), len)) {
        n_names = 0;
        res.names.clear();
        break;
      }
      res.names.push_back(std::move(name));
    }
  } else {
    n_names = 0;
  }
  std::fclose(f);
  for (auto& n : res.names) res.name_ptrs.push_back(n.c_str());
  g_load_result = std::move(res);
  *out_size = static_cast<mx_uint>(g_load_result.handles.size());
  *out_arr = g_load_result.handles.data();
  *out_name_size = static_cast<mx_uint>(g_load_result.names.size());
  *out_names = g_load_result.name_ptrs.data();
  return 0;
}

// ---- views + raw-bytes serialization (reference c_api.h: MXNDArraySlice
// :395, MXNDArrayAt :407, MXNDArrayReshape :418, MXNDArraySaveRawBytes
// :291, MXNDArrayLoadFromRawBytes :271). Host arrays: views are copies
// (the reference's chunk-sharing is a device-memory concern; the C-client
// contract — shapes and values — is identical). -----------------------------

MXNET_DLL int MXNDArraySlice(NDArrayHandle handle, mx_uint slice_begin,
                             mx_uint slice_end, NDArrayHandle* out) {
  auto* a = static_cast<CArray*>(handle);
  if (a->shape.empty()) return fail("cannot slice a scalar");
  if (slice_begin > slice_end || slice_end > a->shape[0])
    return fail("invalid slice range");
  if (a->data.size() != nelem(a->shape) * kDTypeSize[a->dtype])
    return fail("cannot slice an unmaterialized (delay_alloc) array");
  size_t row = kDTypeSize[a->dtype];
  for (size_t i = 1; i < a->shape.size(); ++i) row *= a->shape[i];
  auto* r = new CArray();
  r->dtype = a->dtype;
  r->dev_type = a->dev_type;
  r->dev_id = a->dev_id;
  r->shape = a->shape;
  r->shape[0] = slice_end - slice_begin;
  r->data.assign(a->data.begin() + slice_begin * row,
                 a->data.begin() + slice_end * row);
  *out = r;
  return 0;
}

MXNET_DLL int MXNDArrayAt(NDArrayHandle handle, mx_uint idx,
                          NDArrayHandle* out) {
  auto* a = static_cast<CArray*>(handle);
  if (a->shape.empty() || idx >= a->shape[0]) return fail("index out of range");
  NDArrayHandle sliced = nullptr;
  int rc = MXNDArraySlice(handle, idx, idx + 1, &sliced);
  if (rc != 0) return rc;
  auto* r = static_cast<CArray*>(sliced);
  r->shape.erase(r->shape.begin());  // drop the leading dim
  *out = r;
  return 0;
}

MXNET_DLL int MXNDArrayReshape(NDArrayHandle handle, int ndim, int* dims,
                               NDArrayHandle* out) {
  auto* a = static_cast<CArray*>(handle);
  std::vector<mx_uint> shape;
  long known = 1;
  int infer = -1;
  for (int i = 0; i < ndim; ++i) {
    if (dims[i] == -1) {
      if (infer >= 0) return fail("at most one -1 dim in reshape");
      infer = i;
      shape.push_back(0);
    } else {
      shape.push_back(static_cast<mx_uint>(dims[i]));
      known *= dims[i];
    }
  }
  long total = static_cast<long>(nelem(a->shape));
  if (infer >= 0) {
    if (known == 0 || total % known != 0)
      return fail("cannot infer -1 dim in reshape");
    shape[infer] = static_cast<mx_uint>(total / known);
    known *= shape[infer];
  }
  if (known != total) return fail("reshape changes element count");
  auto* r = new CArray();
  r->dtype = a->dtype;
  r->dev_type = a->dev_type;
  r->dev_id = a->dev_id;
  r->shape = shape;
  r->data = a->data;
  *out = r;
  return 0;
}

MXNET_DLL int MXNDArraySaveRawBytes(NDArrayHandle handle, size_t* out_size,
                                    const char** out_buf) {
  auto* a = static_cast<CArray*>(handle);
  thread_local std::vector<char> buf;
  buf.clear();
  auto put = [&](const void* p, size_t n) {
    const char* c = static_cast<const char*>(p);
    buf.insert(buf.end(), c, c + n);
  };
  uint32_t ndim = a->none ? 0 : static_cast<uint32_t>(a->shape.size());
  put(&kNDArrayMagic, 4);
  put(&ndim, 4);
  if (ndim) {
    for (mx_uint s : a->shape) {
      uint32_t v = s;
      put(&v, 4);
    }
    int32_t ctx[2] = {1, 0};
    put(ctx, 8);
    int32_t flag = a->dtype;
    put(&flag, 4);
    put(a->data.data(), a->data.size());
  }
  *out_size = buf.size();
  *out_buf = buf.data();
  return 0;
}

MXNET_DLL int MXNDArrayLoadFromRawBytes(const void* buf, size_t size,
                                        NDArrayHandle* out) {
  const char* p = static_cast<const char*>(buf);
  const char* end = p + size;
  auto rd = [&p, end](void* dst, size_t n) {
    if (static_cast<size_t>(end - p) < n) return false;
    std::memcpy(dst, p, n);
    p += n;
    return true;
  };
  mxt_ndwire::NdRecord rec;
  std::string err;
  if (!mxt_ndwire::read_ndarray_record(rd, &rec, &err, kNumDTypes))
    return fail("LoadFromRawBytes: " + err);
  auto* r = new CArray();
  r->none = rec.none;
  r->dtype = rec.dtype;
  r->shape.assign(rec.shape.begin(), rec.shape.end());
  r->data = std::move(rec.data);
  *out = r;
  return 0;
}
