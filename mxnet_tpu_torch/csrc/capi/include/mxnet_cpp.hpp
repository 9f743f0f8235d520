// mxnet_cpp.hpp — header-only C++ training API over the C train API slice.
//
// The port's analog of the reference's cpp-package
// (the reference's cpp-package/include/mxnet-cpp/: symbol.h, operator.h,
// executor.h, optimizer.h, kvstore.h — a header-only RAII layer over
// include/mxnet/c_api.h). Same user workflow: build a Symbol from operators
// in C++, SimpleBind it, feed data, Forward/Backward, optimizer-update, save
// a checkpoint that Python (and the reference) can load. The compute path
// underneath is the port's executor (Context "gpu"/"tpu" is the card).
//
// Usage (see examples/cpp/lenet.cpp for a complete LeNet-style trainer):
//
//   namespace mx = mxnet::cpp;
//   auto data  = mx::Symbol::Variable("data");
//   auto fc1   = mx::Operator("FullyConnected").SetParam("num_hidden", 64)
//                    .SetInput("data", data).CreateSymbol("fc1");
//   auto act   = mx::Operator("Activation").SetParam("act_type", "relu")
//                    .SetInput("data", fc1).CreateSymbol();
//   ...
//   auto exec = net.SimpleBind(mx::Context::cpu(),
//                              {{"data", {32, 784}}, {"label", {32}}});
//   exec.InitXavier(7);
//   exec.SetArg("data", batch); exec.Forward(true); exec.Backward();
//   exec.MomentumUpdate(0.05f, 1e-4f, 0.9f);
//   exec.SaveParams("model-0001.params");   // loads in Python Module
#ifndef MXTPU_MXNET_CPP_HPP_
#define MXTPU_MXNET_CPP_HPP_

#include <map>
#include <memory>
#include <sstream>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

#include "c_train_api.h"

namespace mxnet {
namespace cpp {

inline void Check(int rc, const char* what) {
  if (rc != 0) {
    throw std::runtime_error(std::string(what) + ": " +
                             MXTrainGetLastError());
  }
}

class Context {
 public:
  Context(std::string dev_type, int dev_id)
      : dev_type_(std::move(dev_type)), dev_id_(dev_id) {}
  static Context cpu(int id = 0) { return Context("cpu", id); }
  static Context tpu(int id = 0) { return Context("tpu", id); }
  static Context gpu(int id = 0) { return Context("gpu", id); }
  const std::string& dev_type() const { return dev_type_; }
  int dev_id() const { return dev_id_; }

 private:
  std::string dev_type_;
  int dev_id_;
};

class Executor;

class Symbol {
 public:
  Symbol() = default;
  explicit Symbol(SymbolHandle h)
      : h_(h, [](SymbolHandle p) {
          if (p) MXSymbolFree(p);
        }) {}

  static Symbol Variable(const std::string& name) {
    SymbolHandle h = nullptr;
    Check(MXSymbolCreateVariable(name.c_str(), &h), "Variable");
    return Symbol(h);
  }
  static Symbol FromJSON(const std::string& json) {
    SymbolHandle h = nullptr;
    Check(MXSymbolCreateFromJSON(json.c_str(), &h), "FromJSON");
    return Symbol(h);
  }
  std::string ToJSON() const {
    const char* out = nullptr;
    Check(MXSymbolSaveToJSON(get(), &out), "ToJSON");
    return out;
  }
  std::vector<std::string> ListArguments() const {
    return List(&MXSymbolListArguments);
  }
  std::vector<std::string> ListOutputs() const {
    return List(&MXSymbolListOutputs);
  }
  std::vector<std::string> ListAuxiliaryStates() const {
    return List(&MXSymbolListAuxiliaryStates);
  }

  // Defined after Executor.
  inline Executor SimpleBind(
      const Context& ctx,
      const std::map<std::string, std::vector<mx_uint>>& input_shapes,
      const std::string& grad_req = "write") const;

  SymbolHandle get() const { return h_.get(); }
  explicit operator bool() const { return static_cast<bool>(h_); }

 private:
  std::vector<std::string> List(
      int (*fn)(SymbolHandle, mx_uint*, const char***)) const {
    mx_uint n = 0;
    const char** arr = nullptr;
    Check(fn(get(), &n, &arr), "SymbolList");
    return std::vector<std::string>(arr, arr + n);
  }
  std::shared_ptr<void> h_;
};

// Builder over MXSymbolCreateFromOperator (reference: cpp-package
// operator.h Operator::SetParam/SetInput/CreateSymbol).
class Operator {
 public:
  explicit Operator(std::string op_name) : op_(std::move(op_name)) {}

  template <typename T>
  Operator& SetParam(const std::string& key, const T& value) {
    std::ostringstream ss;
    ss << std::boolalpha << value;
    keys_.push_back(key);
    vals_.push_back(ss.str());
    return *this;
  }
  Operator& SetInput(const std::string& input_name, const Symbol& sym) {
    input_keys_.push_back(input_name);
    inputs_.push_back(sym);
    return *this;
  }
  Operator& AddInput(const Symbol& sym) { return SetInput("", sym); }

  Symbol CreateSymbol(const std::string& name = "") {
    std::vector<const char*> k, v, ik;
    for (auto& s : keys_) k.push_back(s.c_str());
    for (auto& s : vals_) v.push_back(s.c_str());
    for (auto& s : input_keys_) ik.push_back(s.c_str());
    std::vector<SymbolHandle> ih;
    for (auto& s : inputs_) ih.push_back(s.get());
    SymbolHandle out = nullptr;
    Check(MXSymbolCreateFromOperator(
              op_.c_str(), name.c_str(), static_cast<mx_uint>(k.size()),
              k.data(), v.data(), static_cast<mx_uint>(ih.size()), ik.data(),
              ih.data(), &out),
          op_.c_str());
    return Symbol(out);
  }

 private:
  std::string op_;
  std::vector<std::string> keys_, vals_, input_keys_;
  std::vector<Symbol> inputs_;
};

class Executor {
 public:
  explicit Executor(ExecutorHandle h)
      : h_(h, [](ExecutorHandle p) {
          if (p) MXExecutorFree(p);
        }) {}

  void Forward(bool is_train) {
    Check(MXExecutorForward(get(), is_train ? 1 : 0), "Forward");
  }
  void Backward() { Check(MXExecutorBackward(get(), 0, nullptr), "Backward"); }
  void InitXavier(int seed) {
    Check(MXExecutorInitXavier(get(), seed), "InitXavier");
  }
  void SetArg(const std::string& name, const std::vector<float>& data) {
    Check(MXExecutorSetArg(get(), name.c_str(), data.data(),
                           static_cast<mx_uint>(data.size())),
          "SetArg");
  }
  std::vector<float> GetArg(const std::string& name) const {
    return Fetch([&](const float** p, mx_uint* n) {
      return MXExecutorGetArg(get(), name.c_str(), p, n);
    });
  }
  std::vector<float> GetGrad(const std::string& name) const {
    return Fetch([&](const float** p, mx_uint* n) {
      return MXExecutorGetGrad(get(), name.c_str(), p, n);
    });
  }
  std::vector<float> GetAux(const std::string& name) const {
    return Fetch([&](const float** p, mx_uint* n) {
      return MXExecutorGetAux(get(), name.c_str(), p, n);
    });
  }
  std::vector<float> GetOutput(mx_uint index) const {
    return Fetch([&](const float** p, mx_uint* n) {
      return MXExecutorGetOutput(get(), index, p, n);
    });
  }
  std::vector<mx_uint> OutputShape(mx_uint index) const {
    const mx_uint* shape = nullptr;
    mx_uint ndim = 0;
    Check(MXExecutorOutputShape(get(), index, &shape, &ndim), "OutputShape");
    return std::vector<mx_uint>(shape, shape + ndim);
  }
  mx_uint NumOutputs() const {
    mx_uint n = 0;
    Check(MXExecutorNumOutputs(get(), &n), "NumOutputs");
    return n;
  }
  // rescale_grad: loss gradients are batch-summed — pass 1/batch_size for
  // batch-mean training (the reference optimizer's rescale_grad knob)
  void SGDUpdate(float lr, float wd = 0.f, float rescale_grad = 1.f) {
    Check(MXExecutorSGDUpdate(get(), lr, wd, rescale_grad), "SGDUpdate");
  }
  void MomentumUpdate(float lr, float wd = 0.f, float momentum = 0.9f,
                      float rescale_grad = 1.f) {
    Check(MXExecutorMomentumUpdate(get(), lr, wd, momentum, rescale_grad),
          "MomentumUpdate");
  }
  void SaveParams(const std::string& path) const {
    Check(MXExecutorSaveParams(get(), path.c_str()), "SaveParams");
  }
  mx_uint LoadParams(const std::string& path) {
    mx_uint n = 0;
    Check(MXExecutorLoadParams(get(), path.c_str(), &n), "LoadParams");
    return n;
  }

  ExecutorHandle get() const { return h_.get(); }

 private:
  template <typename Fn>
  std::vector<float> Fetch(Fn fn) const {
    const float* p = nullptr;
    mx_uint n = 0;
    Check(fn(&p, &n), "Fetch");
    return std::vector<float>(p, p + n);
  }
  std::shared_ptr<void> h_;
};

inline Executor Symbol::SimpleBind(
    const Context& ctx,
    const std::map<std::string, std::vector<mx_uint>>& input_shapes,
    const std::string& grad_req) const {
  std::vector<const char*> keys;
  std::vector<mx_uint> shape_data, shape_idx{0};
  for (auto& kv : input_shapes) {
    keys.push_back(kv.first.c_str());
    shape_data.insert(shape_data.end(), kv.second.begin(), kv.second.end());
    shape_idx.push_back(static_cast<mx_uint>(shape_data.size()));
  }
  ExecutorHandle h = nullptr;
  Check(MXExecutorSimpleBindLite(get(), ctx.dev_type().c_str(), ctx.dev_id(),
                                 static_cast<mx_uint>(keys.size()),
                                 keys.data(), shape_data.data(),
                                 shape_idx.data(), grad_req.c_str(), &h),
        "SimpleBind");
  return Executor(h);
}

// Optimizer facade matching the reference cpp-package's
// Optimizer("sgd")->SetParam(...)->Update() workflow (optimizer.h), built on
// the executor's device-resident update rules.
class Optimizer {
 public:
  explicit Optimizer(const std::string& type) : type_(type) {
    if (type != "sgd" && type != "ccsgd") {
      throw std::runtime_error("cpp Optimizer supports sgd (got " + type +
                               "); use the Python surface for others");
    }
  }
  Optimizer& SetParam(const std::string& key, float value) {
    if (key == "lr" || key == "learning_rate") lr_ = value;
    else if (key == "wd") wd_ = value;
    else if (key == "momentum") momentum_ = value;
    else if (key == "rescale_grad") rescale_ = value;
    else throw std::runtime_error("unknown optimizer param " + key);
    return *this;
  }
  void Update(Executor& exec) {
    if (momentum_ != 0.f)
      exec.MomentumUpdate(lr_, wd_, momentum_, rescale_);
    else
      exec.SGDUpdate(lr_, wd_, rescale_);
  }

 private:
  std::string type_;
  float lr_ = 0.01f, wd_ = 0.f, momentum_ = 0.f, rescale_ = 1.f;
};

// Data iterator over the framework's IO pipeline (reference: cpp-package
// io.h MXDataIter — param-driven creation, Next/GetData/GetLabel loop).
class DataIter {
 public:
  DataIter(const std::string& name,
           const std::map<std::string, std::string>& params) {
    std::vector<const char*> k, v;
    for (auto& kv : params) {
      k.push_back(kv.first.c_str());
      v.push_back(kv.second.c_str());
    }
    DataIterHandle h = nullptr;
    Check(MXDataIterCreate(name.c_str(), static_cast<mx_uint>(k.size()),
                           k.data(), v.data(), &h),
          name.c_str());
    h_ = std::shared_ptr<void>(h, [](DataIterHandle p) {
      if (p) MXDataIterFree(p);
    });
  }
  bool Next() {
    int has = 0;
    Check(MXDataIterNext(h_.get(), &has), "DataIterNext");
    return has != 0;
  }
  void BeforeFirst() {
    Check(MXDataIterBeforeFirst(h_.get()), "BeforeFirst");
  }
  std::vector<float> GetData() {
    const float* p = nullptr;
    mx_uint n = 0;
    Check(MXDataIterGetData(h_.get(), &p, &n), "GetData");
    return std::vector<float>(p, p + n);
  }
  std::vector<float> GetLabel() {
    const float* p = nullptr;
    mx_uint n = 0;
    Check(MXDataIterGetLabel(h_.get(), &p, &n), "GetLabel");
    return std::vector<float>(p, p + n);
  }
  std::vector<mx_uint> GetDataShape() {
    const mx_uint* shape = nullptr;
    mx_uint ndim = 0;
    Check(MXDataIterGetDataShape(h_.get(), &shape, &ndim), "GetDataShape");
    return std::vector<mx_uint>(shape, shape + ndim);
  }
  int GetPadNum() {
    int pad = 0;
    Check(MXDataIterGetPadNum(h_.get(), &pad), "GetPadNum");
    return pad;
  }

 private:
  std::shared_ptr<void> h_;
};

class KVStore {
 public:
  explicit KVStore(const std::string& type = "local") {
    KVStoreHandle h = nullptr;
    Check(MXKVStoreCreate(type.c_str(), &h), "KVStoreCreate");
    h_ = std::shared_ptr<void>(h, [](KVStoreHandle p) {
      if (p) MXKVStoreFree(p);
    });
  }
  int GetRank() const {
    int r = 0;
    Check(MXKVStoreGetRank(h_.get(), &r), "GetRank");
    return r;
  }
  int GetGroupSize() const {
    int n = 0;
    Check(MXKVStoreGetGroupSize(h_.get(), &n), "GetGroupSize");
    return n;
  }
  void Init(int key, const std::vector<float>& data,
            const std::vector<mx_uint>& shape) {
    Check(MXKVStoreInit(h_.get(), key, data.data(), shape.data(),
                        static_cast<mx_uint>(shape.size())),
          "KVInit");
  }
  void Push(int key, const std::vector<float>& data,
            const std::vector<mx_uint>& shape) {
    Check(MXKVStorePush(h_.get(), key, data.data(), shape.data(),
                        static_cast<mx_uint>(shape.size())),
          "KVPush");
  }
  std::vector<float> Pull(int key) {
    const float* p = nullptr;
    mx_uint n = 0;
    Check(MXKVStorePull(h_.get(), key, &p, &n), "KVPull");
    return std::vector<float>(p, p + n);
  }

 private:
  std::shared_ptr<void> h_;
};

}  // namespace cpp
}  // namespace mxnet

#endif  // MXTPU_MXNET_CPP_HPP_
