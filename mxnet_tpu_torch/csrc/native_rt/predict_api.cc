// The C predict API of the Python-free runtime (reference:
// include/mxnet/c_predict_api.h; the JAX package's
// mxnet_tpu/src/c_predict_pjrt.cc:1203-1440 for its behaviour): a
// predictor from a .mxa predict artifact, its graph run by the
// interpreter on the device the caller asked for (dev_type 1 the CPU, 2
// cuda:dev_id, any other the default device: the card, or the CPU under
// MXNET_DEFAULT_CONTEXT=cpu). Shapes are the artifact's; label inputs are
// fed zeros unless set; MXPredCreatePartialOut picks internal outputs
// (<node>_output, <node>_output<k>, or a variable's name).
#include <cstring>
#include <memory>
#include <set>

#include "runtime.h"

#define MXT_DLL extern "C" __attribute__((visibility("default")))

typedef unsigned int mx_uint;
typedef float mx_float;
typedef void* PredictorHandle;
typedef void* NDListHandle;

namespace mxt_rt {
namespace {

struct IoSpec {
  std::string name;
  std::vector<int64_t> shape;
  std::vector<uint32_t> shape_u32;
  at::ScalarType dtype = at::kFloat;
  bool kept = true;
  int64_t n_elem = 1;
};

struct Predictor {
  Graph graph;
  at::Device device = at::kCPU;
  std::vector<IoSpec> inputs;
  std::vector<at::Tensor> input_vals;         // on the device
  std::map<std::string, at::Tensor> params;   // variables: params and auxs
  std::vector<std::pair<int, int>> outs;      // entries returned
  std::vector<std::vector<uint32_t>> out_shapes;
  std::vector<at::Tensor> out_vals;
  bool has_run = false;
};

bool parse_iospec(const JVal& j, IoSpec* s) {
  const JVal* n = j.get("name");
  const JVal* shp = j.get("shape");
  const JVal* dt = j.get("dtype");
  if (!n || !shp || !dt || n->kind != JVal::STR) return false;
  s->name = n->str;
  if (!json_shape(*shp, &s->shape, &s->shape_u32, &s->n_elem)) return false;
  const JVal* kept = j.get("kept");
  s->kept = !kept || kept->kind != JVal::BOOL || kept->b;
  bool ok = false;
  s->dtype = dtype_by_name(dt->str, &ok);
  return ok;
}

// the host record as a tensor on `dev`
at::Tensor upload(const HostArray& a, const at::Device& dev) {
  bool ok = false;
  at::ScalarType t = dtype_by_flag(a.dtype, &ok);
  if (!ok) throw RtError("param '" + a.name + "' has an unsupported dtype");
  at::Tensor host = at::empty(a.shape, at::TensorOptions().dtype(t));
  if (host.nbytes() != a.data.size())
    throw RtError("param '" + a.name + "': record size mismatch");
  memcpy(host.data_ptr(), a.data.data(), a.data.size());
  return host.to(dev);
}

// the (node, output) an output key names
bool find_output(const Graph& g, const std::string& key,
                 std::pair<int, int>* out) {
  for (size_t i = 0; i < g.nodes.size(); ++i) {
    const Node& n = g.nodes[i];
    if (n.op == "null") {
      if (n.name == key) { *out = {static_cast<int>(i), 0}; return true; }
      continue;
    }
    const std::string base = n.name + "_output";
    if (key == base) { *out = {static_cast<int>(i), 0}; return true; }
    if (key.size() > base.size() && key.compare(0, base.size(), base) == 0) {
      std::string rest = key.substr(base.size());
      if (rest.find_first_not_of("0123456789") == std::string::npos) {
        *out = {static_cast<int>(i), std::stoi(rest)};
        return true;
      }
    }
  }
  return false;
}

void forward(Predictor* p) {
  at::NoGradGuard no_grad;
  std::vector<std::map<std::string, at::Tensor>> vars{p->params};
  for (size_t i = 0; i < p->inputs.size(); ++i)
    vars[0][p->inputs[i].name] =
        p->inputs[i].kept ? p->input_vals[i] : at::Tensor();
  std::vector<OpCtx> ctx(1);
  ctx[0].is_train = false;
  ctx[0].device = p->device;
  auto vals = run_graph(p->graph, &vars, ctx, p->outs);
  p->out_vals.clear();
  for (const auto& e : p->outs) {
    const auto& v = vals[e.first][0];
    if (static_cast<size_t>(e.second) >= v.size())
      throw RtError("output '" + p->graph.nodes[e.first].name + "' " +
                    std::to_string(e.second) + " does not exist");
    p->out_vals.push_back(v[e.second]);
  }
}

int create(const char* bytes, size_t size, int dev_type, int dev_id,
           mx_uint num_input_nodes, const char** input_keys,
           const mx_uint* input_shape_indptr, const mx_uint* input_shape_data,
           mx_uint num_output_nodes, const char** output_keys,
           PredictorHandle* out) {
  Artifact art;
  std::string err;
  if (!read_artifact(bytes, size, &art, &err)) return fail(err);
  const JVal* kind = art.manifest.get("kind");
  if (kind && kind->kind == JVal::STR && kind->str == "train")
    return fail(".mxa: a train artifact; use MXTrainNativeCreateFromFile");
  auto pred = std::make_unique<Predictor>();
  if (!parse_graph(art.program, &pred->graph, &err)) return fail(err);
  const JVal* jin = art.manifest.get("inputs");
  const JVal* jpar = art.manifest.get("params");
  const JVal* jout = art.manifest.get("outputs");
  if (!jin || !jpar || !jout || jin->kind != JVal::ARR ||
      jpar->kind != JVal::ARR || jout->kind != JVal::ARR)
    return fail(".mxa: manifest missing inputs/params/outputs");
  for (const auto& j : jin->arr) {
    IoSpec s;
    if (!parse_iospec(j, &s)) return fail(".mxa: bad input spec");
    pred->inputs.push_back(std::move(s));
  }
  std::vector<IoSpec> out_specs;
  for (const auto& j : jout->arr) {
    IoSpec s;
    if (!parse_iospec(j, &s)) return fail(".mxa: bad output spec");
    out_specs.push_back(std::move(s));
  }
  if (out_specs.size() != pred->graph.heads.size())
    return fail(".mxa: the manifest's outputs do not match the program's heads");
  // caller shapes must be the artifact's: its shapes are fixed at export
  for (mx_uint i = 0; i < num_input_nodes; ++i) {
    const char* key = input_keys[i];
    const IoSpec* spec = nullptr;
    for (const auto& s : pred->inputs)
      if (s.name == key) { spec = &s; break; }
    if (!spec) return fail(std::string("input '") + key + "' not in artifact");
    std::vector<uint32_t> want(input_shape_data + input_shape_indptr[i],
                               input_shape_data + input_shape_indptr[i + 1]);
    if (want != spec->shape_u32)
      return fail(std::string("input '") + key +
                  "' shape differs from the exported artifact (its shapes "
                  "are fixed; re-export for new shapes)");
  }
  if (!resolve_device(dev_type, dev_id, &pred->device, &err)) return fail(err);
  for (const auto& j : jpar->arr) {
    auto it = art.by_name.find(j.str);
    if (it == art.by_name.end())
      return fail(".mxa: manifest param '" + j.str + "' missing from params blob");
    if (it->second->none)
      return fail(".mxa: param '" + j.str + "' is a none record");
    size_t colon = j.str.find(':');
    pred->params[j.str.substr(colon + 1)] = upload(*it->second, pred->device);
  }
  // a parameter the program does not read (the export left it out, as
  // jax.export drops it) is bound as an undefined tensor
  std::set<std::string> input_names;
  for (const auto& s : pred->inputs) input_names.insert(s.name);
  for (const auto& n : pred->graph.nodes)
    if (n.op == "null" && !pred->params.count(n.name) &&
        !input_names.count(n.name))
      pred->params[n.name] = at::Tensor();
  // inputs start at zero (labels stay zero unless the client sets them)
  for (const auto& s : pred->inputs)
    pred->input_vals.push_back(at::zeros(
        s.shape, at::TensorOptions().dtype(s.dtype).device(pred->device)));
  if (num_output_nodes == 0) {
    pred->outs = pred->graph.heads;
    for (const auto& s : out_specs) pred->out_shapes.push_back(s.shape_u32);
  } else {
    for (mx_uint i = 0; i < num_output_nodes; ++i) {
      std::pair<int, int> e;
      if (!find_output(pred->graph, output_keys[i], &e))
        return fail(std::string("output '") + output_keys[i] +
                    "' names no node output of the program");
      pred->outs.push_back(e);
    }
    // internal outputs' shapes come from a forward over the zero inputs
    forward(pred.get());
    for (const auto& t : pred->out_vals) {
      std::vector<uint32_t> s(t.sizes().begin(), t.sizes().end());
      pred->out_shapes.push_back(s);
    }
    pred->out_vals.clear();
  }
  *out = pred.release();
  return 0;
}

#define API_BEGIN() try {
#define API_END()                                   \
  }                                                 \
  catch (const c10::Error& e) {                     \
    return fail(e.what_without_backtrace());        \
  }                                                 \
  catch (const std::exception& e) {                 \
    return fail(e.what());                          \
  }                                                 \
  return 0;

}  // namespace
}  // namespace mxt_rt

using namespace mxt_rt;

MXT_DLL const char* MXGetLastError() { return last_error(); }

MXT_DLL int MXPredCreatePartialOut(
    const char* symbol_json_str, const void* param_bytes, int param_size,
    int dev_type, int dev_id, mx_uint num_input_nodes, const char** input_keys,
    const mx_uint* input_shape_indptr, const mx_uint* input_shape_data,
    mx_uint num_output_nodes, const char** output_keys, PredictorHandle* out) {
  API_BEGIN();
  if (param_bytes && param_size > 8 && memcmp(param_bytes, "MXTPUAR1", 8) == 0)
    return create(static_cast<const char*>(param_bytes), param_size, dev_type,
                  dev_id, num_input_nodes, input_keys, input_shape_indptr,
                  input_shape_data, num_output_nodes, output_keys, out);
  if (symbol_json_str && strstr(symbol_json_str, ".mxa"))
    return fail("pass the artifact bytes as param_bytes, or use "
                "MXPredCreateFromFile");
  return fail("libmxtpu_predict_native consumes .mxa artifacts "
              "(mxnet_tpu_torch.export_predict_artifact); for symbol JSON and "
              "params use libmxtpu_predict.so");
  API_END();
}

MXT_DLL int MXPredCreate(const char* symbol_json_str, const void* param_bytes,
                         int param_size, int dev_type, int dev_id,
                         mx_uint num_input_nodes, const char** input_keys,
                         const mx_uint* input_shape_indptr,
                         const mx_uint* input_shape_data, PredictorHandle* out) {
  return MXPredCreatePartialOut(symbol_json_str, param_bytes, param_size,
                                dev_type, dev_id, num_input_nodes, input_keys,
                                input_shape_indptr, input_shape_data, 0,
                                nullptr, out);
}

MXT_DLL int MXPredCreateFromFile(const char* artifact_path, int dev_type,
                                 int dev_id, PredictorHandle* out) {
  API_BEGIN();
  std::vector<char> bytes;
  std::string err;
  if (!read_file(artifact_path, &bytes, &err)) return fail(err);
  return create(bytes.data(), bytes.size(), dev_type, dev_id, 0, nullptr,
                nullptr, nullptr, 0, nullptr, out);
  API_END();
}

MXT_DLL int MXPredSetInput(PredictorHandle handle, const char* key,
                           const mx_float* data, mx_uint size) {
  API_BEGIN();
  auto* p = static_cast<Predictor*>(handle);
  if (!p) return fail("null predictor");
  for (size_t i = 0; i < p->inputs.size(); ++i) {
    const IoSpec& s = p->inputs[i];
    if (s.name != key) continue;
    if (s.dtype != at::kFloat)
      return fail("MXPredSetInput is float32; input '" + s.name +
                  "' is not float32 in the artifact");
    if (size != static_cast<mx_uint>(s.n_elem))
      return fail("MXPredSetInput: size mismatch for '" + s.name + "'");
    at::Tensor host = at::from_blob(const_cast<mx_float*>(data), s.shape,
                                    at::TensorOptions().dtype(at::kFloat));
    p->input_vals[i].copy_(host);
    return 0;
  }
  return fail(std::string("unknown input '") + key + "'");
  API_END();
}

MXT_DLL int MXPredForward(PredictorHandle handle) {
  API_BEGIN();
  auto* p = static_cast<Predictor*>(handle);
  if (!p) return fail("null predictor");
  p->has_run = false;  // a failed forward leaves no stale outputs readable
  forward(p);
  p->has_run = true;
  API_END();
}

MXT_DLL int MXPredPartialForward(PredictorHandle handle, int step,
                                 int* step_left) {
  // the graph runs as one step
  if (step_left) *step_left = 0;
  if (step > 0) return 0;
  return MXPredForward(handle);
}

MXT_DLL int MXPredGetOutputShape(PredictorHandle handle, mx_uint index,
                                 mx_uint** shape_data, mx_uint* shape_ndim) {
  auto* p = static_cast<Predictor*>(handle);
  if (!p) return fail("null predictor");
  if (index >= p->out_shapes.size()) return fail("output index out of range");
  *shape_data = p->out_shapes[index].data();
  *shape_ndim = static_cast<mx_uint>(p->out_shapes[index].size());
  return 0;
}

MXT_DLL int MXPredGetOutput(PredictorHandle handle, mx_uint index,
                            mx_float* data, mx_uint size) {
  API_BEGIN();
  auto* p = static_cast<Predictor*>(handle);
  if (!p) return fail("null predictor");
  if (!p->has_run) return fail("call MXPredForward first");
  if (index >= p->out_vals.size()) return fail("output index out of range");
  const at::Tensor& t = p->out_vals[index];
  if (size != static_cast<mx_uint>(t.numel()))
    return fail("MXPredGetOutput: size mismatch");
  // one copy from the device into the caller's buffer (C23)
  at::from_blob(data, t.sizes(), at::TensorOptions().dtype(at::kFloat))
      .copy_(t);
  API_END();
}

MXT_DLL int MXPredFree(PredictorHandle handle) {
  API_BEGIN();
  delete static_cast<Predictor*>(handle);
  API_END();
}

// ---- MXNDList*: a .params blob parsed in C++ (reference c_predict_api.cc) --
namespace {
struct NDList {
  std::vector<HostArray> arrays;
  std::vector<std::vector<float>> as_float;
};
}  // namespace

MXT_DLL int MXNDListCreate(const char* nd_file_bytes, int nd_file_size,
                           NDListHandle* out, mx_uint* out_length) {
  auto lst = std::make_unique<NDList>();
  std::string err;
  if (!parse_params(nd_file_bytes, nd_file_size, &lst->arrays, &err))
    return fail(err);
  lst->as_float.resize(lst->arrays.size());
  for (size_t i = 0; i < lst->arrays.size(); ++i) {
    const HostArray& a = lst->arrays[i];
    if (a.none) continue;
    if (a.dtype != kF32)
      return fail("MXNDListCreate: non-float32 array in list (flag " +
                  std::to_string(a.dtype) + ")");
    const float* f = reinterpret_cast<const float*>(a.data.data());
    lst->as_float[i].assign(f, f + a.data.size() / sizeof(float));
  }
  *out_length = static_cast<mx_uint>(lst->arrays.size());
  *out = lst.release();
  return 0;
}

MXT_DLL int MXNDListGet(NDListHandle handle, mx_uint index,
                        const char** out_key, const mx_float** out_data,
                        const mx_uint** out_shape, mx_uint* out_ndim) {
  auto* lst = static_cast<NDList*>(handle);
  if (!lst || index >= lst->arrays.size()) return fail("bad NDList index");
  *out_key = lst->arrays[index].name.c_str();
  *out_data = lst->as_float[index].data();
  *out_shape = lst->arrays[index].shape_u32.data();
  *out_ndim = static_cast<mx_uint>(lst->arrays[index].shape_u32.size());
  return 0;
}

MXT_DLL int MXNDListFree(NDListHandle handle) {
  delete static_cast<NDList*>(handle);
  return 0;
}
