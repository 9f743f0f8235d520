// Header-only C++ predict API (reference: cpp-package/include/mxnet-cpp — the
// generated C++ classes over the C API; this covers the deployment slice the
// predict clients use).
//
//   mxtpu::Predictor pred(json_str, param_blob, {{"data", {1, 3, 224, 224}}});
//   pred.SetInput("data", img.data(), img.size());
//   pred.Forward();
//   std::vector<float> out = pred.GetOutput(0);
#ifndef MXTPU_MXNET_PREDICT_HPP_
#define MXTPU_MXNET_PREDICT_HPP_

#include <map>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

#include "c_predict_api.h"

namespace mxtpu {

inline void Check(int ret) {
  if (ret != 0) throw std::runtime_error(MXGetLastError());
}

class Predictor {
 public:
  Predictor(const std::string& symbol_json, const std::string& param_blob,
            const std::map<std::string, std::vector<mx_uint>>& input_shapes,
            int dev_type = 1, int dev_id = 0) {
    std::vector<const char*> keys;
    std::vector<mx_uint> indptr{0};
    std::vector<mx_uint> data;
    for (const auto& kv : input_shapes) {
      keys.push_back(kv.first.c_str());
      for (mx_uint d : kv.second) data.push_back(d);
      indptr.push_back(static_cast<mx_uint>(data.size()));
    }
    Check(MXPredCreate(symbol_json.c_str(), param_blob.data(),
                       static_cast<int>(param_blob.size()), dev_type, dev_id,
                       static_cast<mx_uint>(keys.size()), keys.data(),
                       indptr.data(), data.data(), &handle_));
  }
  Predictor(const Predictor&) = delete;
  Predictor& operator=(const Predictor&) = delete;
  Predictor(Predictor&& o) noexcept : handle_(o.handle_) { o.handle_ = nullptr; }
  ~Predictor() {
    if (handle_) MXPredFree(handle_);
  }

  void SetInput(const std::string& key, const float* data, size_t size) {
    Check(MXPredSetInput(handle_, key.c_str(), data,
                         static_cast<mx_uint>(size)));
  }
  void Forward() { Check(MXPredForward(handle_)); }

  std::vector<mx_uint> GetOutputShape(mx_uint index) const {
    mx_uint* shape = nullptr;
    mx_uint ndim = 0;
    Check(MXPredGetOutputShape(handle_, index, &shape, &ndim));
    return std::vector<mx_uint>(shape, shape + ndim);
  }

  std::vector<float> GetOutput(mx_uint index) const {
    auto shape = GetOutputShape(index);
    mx_uint n = 1;
    for (mx_uint d : shape) n *= d;
    std::vector<float> out(n);
    Check(MXPredGetOutput(handle_, index, out.data(), n));
    return out;
  }

 private:
  PredictorHandle handle_ = nullptr;
};

// Parameter-blob reader (reference: MXNDList*).
class NDList {
 public:
  explicit NDList(const std::string& blob) {
    Check(MXNDListCreate(blob.data(), static_cast<int>(blob.size()), &handle_,
                         &size_));
  }
  NDList(const NDList&) = delete;
  NDList& operator=(const NDList&) = delete;
  NDList(NDList&& o) noexcept : handle_(o.handle_), size_(o.size_) {
    o.handle_ = nullptr;
    o.size_ = 0;
  }
  ~NDList() {
    if (handle_) MXNDListFree(handle_);
  }
  mx_uint size() const { return size_; }
  struct Entry {
    std::string key;
    const float* data;
    std::vector<mx_uint> shape;
  };
  Entry at(mx_uint i) const {
    const char* key;
    const float* data;
    const mx_uint* shape;
    mx_uint ndim;
    Check(MXNDListGet(handle_, i, &key, &data, &shape, &ndim));
    return Entry{key, data, std::vector<mx_uint>(shape, shape + ndim)};
  }

 private:
  NDListHandle handle_ = nullptr;
  mx_uint size_ = 0;
};

}  // namespace mxtpu

#endif  // MXTPU_MXNET_PREDICT_HPP_
