// Training-side C API slice (reference: include/mxnet/c_api.h — the Symbol /
// Executor function families: MXSymbolCreateFromJSON, MXExecutorForward,
// MXExecutorBackward, ...). The predict subset lives in c_predict_api.cc;
// this file adds enough surface for a pure C/C++ client to run a full
// training loop: symbol-from-JSON -> simple_bind -> set args -> forward ->
// backward -> read grads/outputs -> in-framework SGD update.
//
// Same embedding design as the predict shim: CPython is initialized lazily,
// every entry point holds the GIL, and the heavy lifting happens in
// mxnet_tpu_torch.capi_train (whose executor is the port's, on the card's
// kernels — the compute path is identical to the Python surface's).
// Compiled client tests: tests/test_torch_capi.py.
#include <Python.h>

#include <atomic>
#include <cstring>
#include <string>
#include <unordered_set>
#include <vector>

// the public header declares every exported signature — including it makes
// the compiler verify each MXNET_DLL definition against its declaration
#include "include/c_array.h"
#include "include/c_train_api.h"

#define MXNET_DLL extern "C" __attribute__((visibility("default")))

// GIL/env scaffolding shared with the predict shim (defined there when both
// files link into one library).
extern thread_local std::string g_last_error_train;
thread_local std::string g_last_error_train;

void mxtpu_promote_libpython();  // c_predict_api.cc (libpython RTLD_GLOBAL)

// c_api_ndarray.cc invokes this (when set) for every MXNDArrayFree; the
// autograd session installs its purge callback into it
extern void (*mxtpu_ndarray_free_hook)(void*);

// pure-C++ API files (c_api_recordio.cc) report through the train-error
// channel this header documents, without touching Python
void mxtpu_set_train_error(const std::string& msg) {
  g_last_error_train = msg;
}

namespace {

struct GilT {
  GilT() {
    if (!Py_IsInitialized()) {
      mxtpu_promote_libpython();
      Py_InitializeEx(0);
#if PY_VERSION_HEX < 0x03090000
      PyEval_InitThreads();
#endif
      PyEval_SaveThread();
    }
    st = PyGILState_Ensure();
  }
  ~GilT() { PyGILState_Release(st); }
  PyGILState_STATE st;
};

void set_err() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  g_last_error_train = "python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* msg = PyUnicode_AsUTF8(s);
      if (msg) g_last_error_train = msg;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

PyObject* train_module() {
  static PyObject* mod = nullptr;  // borrowed forever once imported
  if (!mod) {
    mod = PyImport_ImportModule("mxnet_tpu_torch.capi_train");
    if (!mod) set_err();
  }
  return mod;
}

struct CSym {
  PyObject* obj;
};
struct CExec {
  PyObject* obj = nullptr;
  // stable storage for string lists returned to C
  std::vector<std::string> names;
  std::vector<const char*> name_ptrs;
  std::vector<mx_uint> shape;
  std::vector<char> blob;
  // per-node monitor (MXExecutorSetMonitorCallback): replayed after each
  // monitored forward; mon_arrays hold the handles until the next forward
  ExecutorMonitorCallback mon_cb = nullptr;
  void* mon_ctx = nullptr;
  std::vector<void*> mon_arrays;
};

int fail() { return -1; }

// marshal a python list-of-str result into thread-local C string tables
int list_strings(PyObject* res, mx_uint* out_size, const char*** out_array) {
  if (!res) {
    set_err();
    return fail();
  }
  thread_local std::vector<std::string> names;
  thread_local std::vector<const char*> ptrs;
  names.clear();
  ptrs.clear();
  if (!PyList_Check(res)) {
    Py_DECREF(res);
    mxtpu_set_train_error("list_strings: helper did not return a list");
    return fail();
  }
  for (Py_ssize_t i = 0; i < PyList_Size(res); ++i) {
    const char* s = PyUnicode_AsUTF8(PyList_GetItem(res, i));
    if (!s) {
      Py_DECREF(res);
      set_err();
      return fail();
    }
    names.emplace_back(s);
  }
  Py_DECREF(res);
  for (auto& n : names) ptrs.push_back(n.c_str());
  *out_size = static_cast<mx_uint>(names.size());
  *out_array = ptrs.data();
  return 0;
}

// unpack a python bytes result into `blob` and expose it as a float32 view
int bytes_to_floats(PyObject* res, std::vector<char>* blob, const float** out,
                    mx_uint* out_size) {
  if (!res) {
    set_err();
    return fail();
  }
  char* buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(res, &buf, &len) != 0) {
    Py_DECREF(res);
    set_err();
    return fail();
  }
  blob->assign(buf, buf + len);
  Py_DECREF(res);
  *out = reinterpret_cast<const float*>(blob->data());
  *out_size = static_cast<mx_uint>(len / sizeof(float));
  return 0;
}

}  // namespace

MXNET_DLL const char* MXTrainGetLastError() {
  return g_last_error_train.c_str();
}

MXNET_DLL int MXSymbolCreateFromJSON(const char* json, SymbolHandle* out) {
  GilT gil;
  PyObject* mod = train_module();
  if (!mod) return fail();
  PyObject* res = PyObject_CallMethod(mod, "_c_symbol_from_json", "s", json);
  if (!res) {
    set_err();
    return fail();
  }
  *out = new CSym{res};
  return 0;
}

MXNET_DLL int MXSymbolSaveToJSON(SymbolHandle sym, const char** out_json) {
  GilT gil;
  auto* s = static_cast<CSym*>(sym);
  PyObject* res =
      PyObject_CallMethod(train_module(), "_c_symbol_to_json", "O", s->obj);
  if (!res) {
    set_err();
    return fail();
  }
  thread_local std::string json;
  json = PyUnicode_AsUTF8(res);
  Py_DECREF(res);
  *out_json = json.c_str();
  return 0;
}

MXNET_DLL int MXSymbolFree(SymbolHandle sym) {
  if (!sym) return 0;
  GilT gil;
  auto* s = static_cast<CSym*>(sym);
  Py_XDECREF(s->obj);
  delete s;
  return 0;
}

// simple_bind: shapes as CSR (keys + flat dims + row offsets), the
// reference's shape-argument convention (c_api.h MXExecutorSimpleBind).
MXNET_DLL int MXExecutorSimpleBindLite(SymbolHandle sym, const char* dev_type,
                                       int dev_id, mx_uint num_args,
                                       const char** keys,
                                       const mx_uint* arg_shape_data,
                                       const mx_uint* arg_shape_idx,
                                       const char* grad_req,
                                       ExecutorHandle* out) {
  GilT gil;
  auto* s = static_cast<CSym*>(sym);
  PyObject* key_list = PyList_New(num_args);
  PyObject* shape_list = PyList_New(num_args);
  for (mx_uint i = 0; i < num_args; ++i) {
    PyList_SetItem(key_list, i, PyUnicode_FromString(keys[i]));
    mx_uint lo = arg_shape_idx[i], hi = arg_shape_idx[i + 1];
    PyObject* dims = PyList_New(hi - lo);
    for (mx_uint j = lo; j < hi; ++j)
      PyList_SetItem(dims, j - lo, PyLong_FromUnsignedLong(arg_shape_data[j]));
    PyList_SetItem(shape_list, i, dims);
  }
  PyObject* res =
      PyObject_CallMethod(train_module(), "_c_simple_bind", "OsiOOs", s->obj,
                          dev_type, dev_id, key_list, shape_list, grad_req);
  Py_DECREF(key_list);
  Py_DECREF(shape_list);
  if (!res) {
    set_err();
    return fail();
  }
  auto* ce = new CExec();
  ce->obj = res;
  *out = ce;
  return 0;
}

MXNET_DLL int MXExecutorFree(ExecutorHandle h) {
  if (!h) return 0;
  GilT gil;
  auto* e = static_cast<CExec*>(h);
  for (void* a : e->mon_arrays) delete static_cast<CArray*>(a);
  Py_XDECREF(e->obj);
  delete e;
  return 0;
}

MXNET_DLL int MXSymbolListArguments(SymbolHandle sym, mx_uint* out_size,
                                    const char*** out_array) {
  GilT gil;
  auto* s = static_cast<CSym*>(sym);
  return list_strings(
      PyObject_CallMethod(train_module(), "_c_symbol_arguments", "O", s->obj),
      out_size, out_array);
}

MXNET_DLL int MXExecutorSetAux(ExecutorHandle h, const char* name,
                               const float* data, mx_uint size) {
  GilT gil;
  auto* e = static_cast<CExec*>(h);
  PyObject* blob = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(data), size * sizeof(float));
  PyObject* res = PyObject_CallMethod(train_module(), "_c_set_aux", "OsO",
                                      e->obj, name, blob);
  Py_DECREF(blob);
  if (!res) {
    set_err();
    return fail();
  }
  Py_DECREF(res);
  return 0;
}

MXNET_DLL int MXExecutorSetArg(ExecutorHandle h, const char* name,
                               const float* data, mx_uint size) {
  GilT gil;
  auto* e = static_cast<CExec*>(h);
  PyObject* blob = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(data), size * sizeof(float));
  PyObject* res = PyObject_CallMethod(train_module(), "_c_set_arg", "OsO",
                                      e->obj, name, blob);
  Py_DECREF(blob);
  if (!res) {
    set_err();
    return fail();
  }
  Py_DECREF(res);
  return 0;
}

namespace {

int get_array(CExec* e, const char* which, PyObject* key, const float** out,
              mx_uint* out_size) {
  PyObject* res = PyObject_CallMethod(train_module(), "_c_get_array", "OsO",
                                      e->obj, which, key);
  Py_DECREF(key);
  return bytes_to_floats(res, &e->blob, out, out_size);
}

}  // namespace

MXNET_DLL int MXExecutorGetArg(ExecutorHandle h, const char* name,
                               const float** out, mx_uint* out_size) {
  GilT gil;
  return get_array(static_cast<CExec*>(h), "arg", PyUnicode_FromString(name),
                   out, out_size);
}

MXNET_DLL int MXExecutorGetGrad(ExecutorHandle h, const char* name,
                                const float** out, mx_uint* out_size) {
  GilT gil;
  return get_array(static_cast<CExec*>(h), "grad", PyUnicode_FromString(name),
                   out, out_size);
}

MXNET_DLL int MXExecutorGetOutput(ExecutorHandle h, mx_uint index,
                                  const float** out, mx_uint* out_size) {
  GilT gil;
  return get_array(static_cast<CExec*>(h), "output", PyLong_FromLong(index),
                   out, out_size);
}

MXNET_DLL int MXExecutorOutputShape(ExecutorHandle h, mx_uint index,
                                    const mx_uint** out_shape,
                                    mx_uint* out_dim) {
  GilT gil;
  auto* e = static_cast<CExec*>(h);
  PyObject* res = PyObject_CallMethod(train_module(), "_c_get_shape", "OsI",
                                      e->obj, "output", index);
  if (!res) {
    set_err();
    return fail();
  }
  e->shape.clear();
  for (Py_ssize_t i = 0; i < PyList_Size(res); ++i)
    e->shape.push_back(
        static_cast<mx_uint>(PyLong_AsLong(PyList_GetItem(res, i))));
  Py_DECREF(res);
  *out_shape = e->shape.data();
  *out_dim = static_cast<mx_uint>(e->shape.size());
  return 0;
}

MXNET_DLL int MXExecutorForward(ExecutorHandle h, int is_train) {
  GilT gil;
  auto* e = static_cast<CExec*>(h);
  if (e->mon_cb) {
    // monitored pass (reference ExecuteMonCallback): collect per-node
    // outputs python-side, then replay into the client's callback
    PyObject* res = PyObject_CallMethod(
        train_module(), "_c_forward_monitored", "Oi", e->obj, is_train);
    if (!res) {
      set_err();
      return fail();
    }
    for (void* a : e->mon_arrays) delete static_cast<CArray*>(a);
    e->mon_arrays.clear();
    if (!PyList_Check(res)) {
      Py_DECREF(res);
      mxtpu_set_train_error("_c_forward_monitored: expected a list");
      return fail();
    }
    struct Entry {
      std::string name;
      CArray* arr;
    };
    std::vector<Entry> entries;
    for (Py_ssize_t i = 0; i < PyList_Size(res); ++i) {
      PyObject* tup = PyList_GetItem(res, i);
      const char* nm = nullptr;
      PyObject* blob = nullptr;
      PyObject* shp = nullptr;
      if (!PyArg_ParseTuple(tup, "sSO", &nm, &blob, &shp)) {
        Py_DECREF(res);
        set_err();
        return fail();
      }
      auto* arr = new CArray();
      arr->dtype = 0;
      for (Py_ssize_t j = 0; j < PyList_Size(shp); ++j)
        arr->shape.push_back(static_cast<mx_uint>(
            PyLong_AsUnsignedLong(PyList_GetItem(shp, j))));
      char* buf = nullptr;
      Py_ssize_t len = 0;
      PyBytes_AsStringAndSize(blob, &buf, &len);
      arr->data.assign(buf, buf + len);
      e->mon_arrays.push_back(arr);
      entries.push_back({nm, arr});
    }
    Py_DECREF(res);
    for (const auto& en : entries) e->mon_cb(en.name.c_str(), en.arr, e->mon_ctx);
    return 0;
  }
  PyObject* res = PyObject_CallMethod(train_module(), "_c_forward", "Oi",
                                      e->obj, is_train);
  if (!res) {
    set_err();
    return fail();
  }
  Py_DECREF(res);
  return 0;
}

MXNET_DLL int MXExecutorSetMonitorCallback(ExecutorHandle h,
                                           ExecutorMonitorCallback callback,
                                           void* callback_handle) {
  auto* e = static_cast<CExec*>(h);
  if (!e) {
    mxtpu_set_train_error("null executor handle");
    return fail();
  }
  e->mon_cb = callback;
  e->mon_ctx = callback_handle;
  return 0;
}

MXNET_DLL int MXExecutorBackward(ExecutorHandle h, mx_uint, void**) {
  GilT gil;
  auto* e = static_cast<CExec*>(h);
  PyObject* res =
      PyObject_CallMethod(train_module(), "_c_backward", "O", e->obj);
  if (!res) {
    set_err();
    return fail();
  }
  Py_DECREF(res);
  return 0;
}

MXNET_DLL int MXExecutorSGDUpdate(ExecutorHandle h, float lr, float wd,
                                  float rescale_grad) {
  GilT gil;
  auto* e = static_cast<CExec*>(h);
  PyObject* res = PyObject_CallMethod(train_module(), "_c_sgd_update", "Offf",
                                      e->obj, static_cast<double>(lr),
                                      static_cast<double>(wd),
                                      static_cast<double>(rescale_grad));
  if (!res) {
    set_err();
    return fail();
  }
  Py_DECREF(res);
  return 0;
}

// ---- symbol construction (cpp-package surface) ---------------------------
// The reference separates MXSymbolCreateAtomicSymbol + MXSymbolCompose;
// cpp-package's Operator::CreateSymbol always runs both back-to-back, so
// this slice exposes the fused form. Params are strings (the op's Parameter
// schema parses them — same as the reference's C convention).

MXNET_DLL int MXSymbolCreateVariable(const char* name, SymbolHandle* out) {
  GilT gil;
  PyObject* mod = train_module();
  if (!mod) return fail();
  PyObject* res = PyObject_CallMethod(mod, "_c_variable", "s", name);
  if (!res) {
    set_err();
    return fail();
  }
  *out = new CSym{res};
  return 0;
}

MXNET_DLL int MXSymbolCreateFromOperator(
    const char* op_name, const char* name, mx_uint num_param,
    const char** param_keys, const char** param_vals, mx_uint num_inputs,
    const char** input_keys /* "" = positional */, SymbolHandle* inputs,
    SymbolHandle* out) {
  GilT gil;
  PyObject* mod = train_module();
  if (!mod) return fail();
  PyObject* pkeys = PyList_New(num_param);
  PyObject* pvals = PyList_New(num_param);
  for (mx_uint i = 0; i < num_param; ++i) {
    PyList_SetItem(pkeys, i, PyUnicode_FromString(param_keys[i]));
    PyList_SetItem(pvals, i, PyUnicode_FromString(param_vals[i]));
  }
  PyObject* ikeys = PyList_New(num_inputs);
  PyObject* isyms = PyList_New(num_inputs);
  for (mx_uint i = 0; i < num_inputs; ++i) {
    PyList_SetItem(ikeys, i, PyUnicode_FromString(
        input_keys ? input_keys[i] : ""));
    PyObject* o = static_cast<CSym*>(inputs[i])->obj;
    Py_INCREF(o);
    PyList_SetItem(isyms, i, o);
  }
  PyObject* res = PyObject_CallMethod(mod, "_c_create_symbol", "ssOOOO",
                                      op_name, name ? name : "", pkeys, pvals,
                                      ikeys, isyms);
  Py_DECREF(pkeys);
  Py_DECREF(pvals);
  Py_DECREF(ikeys);
  Py_DECREF(isyms);
  if (!res) {
    set_err();
    return fail();
  }
  *out = new CSym{res};
  return 0;
}

MXNET_DLL int MXSymbolListOutputs(SymbolHandle sym, mx_uint* out_size,
                                  const char*** out_array) {
  GilT gil;
  auto* s = static_cast<CSym*>(sym);
  return list_strings(
      PyObject_CallMethod(train_module(), "_c_symbol_outputs", "O", s->obj),
      out_size, out_array);
}

MXNET_DLL int MXSymbolListAuxiliaryStates(SymbolHandle sym, mx_uint* out_size,
                                          const char*** out_array) {
  GilT gil;
  auto* s = static_cast<CSym*>(sym);
  return list_strings(
      PyObject_CallMethod(train_module(), "_c_symbol_aux_states", "O",
                          s->obj),
      out_size, out_array);
}

MXNET_DLL int MXExecutorNumOutputs(ExecutorHandle h, mx_uint* out) {
  GilT gil;
  auto* e = static_cast<CExec*>(h);
  PyObject* res =
      PyObject_CallMethod(train_module(), "_c_num_outputs", "O", e->obj);
  if (!res) {
    set_err();
    return fail();
  }
  *out = static_cast<mx_uint>(PyLong_AsLong(res));
  Py_DECREF(res);
  return 0;
}

MXNET_DLL int MXExecutorGetAux(ExecutorHandle h, const char* name,
                               const float** out, mx_uint* out_size) {
  GilT gil;
  return get_array(static_cast<CExec*>(h), "aux", PyUnicode_FromString(name),
                   out, out_size);
}

MXNET_DLL int MXExecutorMomentumUpdate(ExecutorHandle h, float lr, float wd,
                                       float momentum, float rescale_grad) {
  GilT gil;
  auto* e = static_cast<CExec*>(h);
  PyObject* res = PyObject_CallMethod(
      train_module(), "_c_momentum_update", "Offff", e->obj,
      static_cast<double>(lr), static_cast<double>(wd),
      static_cast<double>(momentum), static_cast<double>(rescale_grad));
  if (!res) {
    set_err();
    return fail();
  }
  Py_DECREF(res);
  return 0;
}

MXNET_DLL int MXExecutorSaveParams(ExecutorHandle h, const char* path) {
  GilT gil;
  auto* e = static_cast<CExec*>(h);
  PyObject* res = PyObject_CallMethod(train_module(), "_c_save_params", "Os",
                                      e->obj, path);
  if (!res) {
    set_err();
    return fail();
  }
  Py_DECREF(res);
  return 0;
}

MXNET_DLL int MXExecutorLoadParams(ExecutorHandle h, const char* path,
                                   mx_uint* out_num_loaded) {
  GilT gil;
  auto* e = static_cast<CExec*>(h);
  PyObject* res = PyObject_CallMethod(train_module(), "_c_load_params", "Os",
                                      e->obj, path);
  if (!res) {
    set_err();
    return fail();
  }
  if (out_num_loaded)
    *out_num_loaded = static_cast<mx_uint>(PyLong_AsLong(res));
  Py_DECREF(res);
  return 0;
}

// ---- Profiler (reference: c_api.h MXSetProfilerConfig/State/MXDumpProfile)

MXNET_DLL int MXSetProfilerConfig(const char* mode, const char* filename) {
  GilT gil;
  PyObject* res = PyObject_CallMethod(
      train_module(), "_c_profiler_set_config", "ss", mode, filename);
  if (!res) {
    set_err();
    return fail();
  }
  Py_DECREF(res);
  return 0;
}

MXNET_DLL int MXSetProfilerState(int state) {
  GilT gil;
  PyObject* res = PyObject_CallMethod(train_module(), "_c_profiler_set_state",
                                      "i", state);
  if (!res) {
    set_err();
    return fail();
  }
  Py_DECREF(res);
  return 0;
}

MXNET_DLL int MXDumpProfile() {
  GilT gil;
  PyObject* res =
      PyObject_CallMethod(train_module(), "_c_dump_profile", NULL);
  if (!res) {
    set_err();
    return fail();
  }
  Py_DECREF(res);
  return 0;
}

// ---- Rtc (reference: c_api.h MXRtcCreate/MXRtcPush/MXRtcFree) ------------

struct CRtc {
  PyObject* obj;
  std::vector<std::vector<char>> out_blobs;
};

MXNET_DLL int MXRtcCreate(const char* name, mx_uint num_input,
                          mx_uint num_output, const char** input_names,
                          const char** output_names, const char* kernel,
                          RtcHandle* out) {
  GilT gil;
  PyObject* mod = train_module();
  if (!mod) return fail();
  PyObject* ins = PyList_New(num_input);
  PyObject* outs = PyList_New(num_output);
  for (mx_uint i = 0; i < num_input; ++i)
    PyList_SetItem(ins, i, PyUnicode_FromString(input_names[i]));
  for (mx_uint i = 0; i < num_output; ++i)
    PyList_SetItem(outs, i, PyUnicode_FromString(output_names[i]));
  PyObject* res = PyObject_CallMethod(mod, "_c_rtc_create", "sOOs", name,
                                      ins, outs, kernel);
  Py_DECREF(ins);
  Py_DECREF(outs);
  if (!res) {
    set_err();
    return fail();
  }
  *out = new CRtc{res, {}};
  return 0;
}

MXNET_DLL int MXRtcFree(RtcHandle h) {
  if (!h) return 0;
  GilT gil;
  auto* r = static_cast<CRtc*>(h);
  Py_XDECREF(r->obj);
  delete r;
  return 0;
}

// inputs/outputs as float32 buffers with CSR-packed shapes (the
// simple_bind convention); output buffers are returned through out_blobs
// and stay valid until the next push on the same handle
MXNET_DLL int MXRtcPush(RtcHandle h, mx_uint num_input,
                        const float** input_data,
                        const mx_uint* input_shape_data,
                        const mx_uint* input_shape_idx, mx_uint num_output,
                        const mx_uint* output_shape_data,
                        const mx_uint* output_shape_idx,
                        const float** out_data, mx_uint* out_sizes) {
  GilT gil;
  auto* r = static_cast<CRtc*>(h);
  PyObject* blobs = PyList_New(num_input);
  PyObject* ishapes = PyList_New(num_input);
  for (mx_uint i = 0; i < num_input; ++i) {
    mx_uint lo = input_shape_idx[i], hi = input_shape_idx[i + 1];
    size_t n = 1;
    PyObject* dims = PyList_New(hi - lo);
    for (mx_uint j = lo; j < hi; ++j) {
      n *= input_shape_data[j];
      PyList_SetItem(dims, j - lo,
                     PyLong_FromUnsignedLong(input_shape_data[j]));
    }
    PyList_SetItem(ishapes, i, dims);
    PyList_SetItem(blobs, i,
                   PyBytes_FromStringAndSize(
                       reinterpret_cast<const char*>(input_data[i]),
                       n * sizeof(float)));
  }
  PyObject* oshapes = PyList_New(num_output);
  for (mx_uint i = 0; i < num_output; ++i) {
    mx_uint lo = output_shape_idx[i], hi = output_shape_idx[i + 1];
    PyObject* dims = PyList_New(hi - lo);
    for (mx_uint j = lo; j < hi; ++j)
      PyList_SetItem(dims, j - lo,
                     PyLong_FromUnsignedLong(output_shape_data[j]));
    PyList_SetItem(oshapes, i, dims);
  }
  PyObject* res = PyObject_CallMethod(train_module(), "_c_rtc_push", "OOOO",
                                      r->obj, blobs, ishapes, oshapes);
  Py_DECREF(blobs);
  Py_DECREF(ishapes);
  Py_DECREF(oshapes);
  if (!res) {
    set_err();
    return fail();
  }
  r->out_blobs.clear();
  if (!PyList_Check(res) ||
      PyList_Size(res) != static_cast<Py_ssize_t>(num_output)) {
    Py_DECREF(res);
    mxtpu_set_train_error(
        "MXRtcPush: kernel returned wrong number of output blobs");
    return fail();
  }
  for (Py_ssize_t i = 0; i < PyList_Size(res); ++i) {
    char* buf = nullptr;
    Py_ssize_t len = 0;
    if (PyBytes_AsStringAndSize(PyList_GetItem(res, i), &buf, &len) != 0) {
      Py_DECREF(res);
      set_err();
      return fail();
    }
    size_t expect = sizeof(float);
    for (mx_uint j = output_shape_idx[i]; j < output_shape_idx[i + 1]; ++j)
      expect *= output_shape_data[j];
    if (static_cast<size_t>(len) != expect) {
      Py_DECREF(res);
      mxtpu_set_train_error(
          "MXRtcPush: output blob byte length does not match its declared "
          "shape");
      return fail();
    }
    r->out_blobs.emplace_back(buf, buf + len);
  }
  Py_DECREF(res);
  for (mx_uint i = 0; i < num_output; ++i) {
    out_data[i] = reinterpret_cast<const float*>(r->out_blobs[i].data());
    out_sizes[i] =
        static_cast<mx_uint>(r->out_blobs[i].size() / sizeof(float));
  }
  return 0;
}

// ---- DataIter (reference: c_api.h MXListDataIters/MXDataIterCreateIter/
// MXDataIterNext/GetData/GetLabel/GetPadNum) -------------------------------

struct CIter {
  PyObject* obj;
  std::vector<char> blob;
  std::vector<mx_uint> shape;
};

MXNET_DLL int MXListDataIters(mx_uint* out_size, const char*** out_array) {
  GilT gil;
  return list_strings(
      PyObject_CallMethod(train_module(), "_c_iter_list", NULL), out_size,
      out_array);
}

MXNET_DLL int MXDataIterCreate(const char* name, mx_uint num_param,
                               const char** keys, const char** vals,
                               DataIterHandle* out) {
  GilT gil;
  PyObject* mod = train_module();
  if (!mod) return fail();
  PyObject* pkeys = PyList_New(num_param);
  PyObject* pvals = PyList_New(num_param);
  for (mx_uint i = 0; i < num_param; ++i) {
    PyList_SetItem(pkeys, i, PyUnicode_FromString(keys[i]));
    PyList_SetItem(pvals, i, PyUnicode_FromString(vals[i]));
  }
  PyObject* res = PyObject_CallMethod(mod, "_c_iter_create", "sOO", name,
                                      pkeys, pvals);
  Py_DECREF(pkeys);
  Py_DECREF(pvals);
  if (!res) {
    set_err();
    return fail();
  }
  *out = new CIter{res, {}, {}};
  return 0;
}

MXNET_DLL int MXDataIterFree(DataIterHandle h) {
  if (!h) return 0;
  GilT gil;
  auto* it = static_cast<CIter*>(h);
  Py_XDECREF(it->obj);
  delete it;
  return 0;
}

MXNET_DLL int MXDataIterNext(DataIterHandle h, int* out) {
  GilT gil;
  auto* it = static_cast<CIter*>(h);
  PyObject* res =
      PyObject_CallMethod(train_module(), "_c_iter_next", "O", it->obj);
  if (!res) {
    set_err();
    return fail();
  }
  *out = static_cast<int>(PyLong_AsLong(res));
  Py_DECREF(res);
  return 0;
}

MXNET_DLL int MXDataIterBeforeFirst(DataIterHandle h) {
  GilT gil;
  auto* it = static_cast<CIter*>(h);
  PyObject* res =
      PyObject_CallMethod(train_module(), "_c_iter_reset", "O", it->obj);
  if (!res) {
    set_err();
    return fail();
  }
  Py_DECREF(res);
  return 0;
}

namespace {

int iter_fetch(CIter* it, const char* which, const float** out,
               mx_uint* out_size) {
  PyObject* res = PyObject_CallMethod(train_module(), "_c_iter_get", "Os",
                                      it->obj, which);
  return bytes_to_floats(res, &it->blob, out, out_size);
}

int iter_shape(CIter* it, const char* which, const mx_uint** out_shape,
               mx_uint* out_dim) {
  PyObject* res = PyObject_CallMethod(train_module(), "_c_iter_shape", "Os",
                                      it->obj, which);
  if (!res) {
    set_err();
    return fail();
  }
  it->shape.clear();
  for (Py_ssize_t i = 0; i < PyList_Size(res); ++i)
    it->shape.push_back(
        static_cast<mx_uint>(PyLong_AsLong(PyList_GetItem(res, i))));
  Py_DECREF(res);
  *out_shape = it->shape.data();
  *out_dim = static_cast<mx_uint>(it->shape.size());
  return 0;
}

}  // namespace

MXNET_DLL int MXDataIterGetData(DataIterHandle h, const float** out,
                                mx_uint* out_size) {
  GilT gil;
  return iter_fetch(static_cast<CIter*>(h), "data", out, out_size);
}

MXNET_DLL int MXDataIterGetLabel(DataIterHandle h, const float** out,
                                 mx_uint* out_size) {
  GilT gil;
  return iter_fetch(static_cast<CIter*>(h), "label", out, out_size);
}

MXNET_DLL int MXDataIterGetDataShape(DataIterHandle h,
                                     const mx_uint** out_shape,
                                     mx_uint* out_dim) {
  GilT gil;
  return iter_shape(static_cast<CIter*>(h), "data", out_shape, out_dim);
}

MXNET_DLL int MXDataIterGetPadNum(DataIterHandle h, int* out) {
  GilT gil;
  auto* it = static_cast<CIter*>(h);
  PyObject* res =
      PyObject_CallMethod(train_module(), "_c_iter_pad", "O", it->obj);
  if (!res) {
    set_err();
    return fail();
  }
  *out = static_cast<int>(PyLong_AsLong(res));
  Py_DECREF(res);
  return 0;
}

// ---- KVStore (reference: c_api.h MXKVStoreCreate/Init/Push/Pull family) --

struct CKV {
  PyObject* obj;
  std::vector<char> blob;
};

MXNET_DLL int MXKVStoreCreate(const char* type, KVStoreHandle* out) {
  GilT gil;
  PyObject* mod = train_module();
  if (!mod) return fail();
  PyObject* res = PyObject_CallMethod(mod, "_c_kv_create", "s", type);
  if (!res) {
    set_err();
    return fail();
  }
  *out = new CKV{res, {}};
  return 0;
}

MXNET_DLL int MXKVStoreFree(KVStoreHandle h) {
  if (!h) return 0;
  GilT gil;
  auto* kv = static_cast<CKV*>(h);
  Py_XDECREF(kv->obj);
  delete kv;
  return 0;
}

MXNET_DLL int MXKVStoreGetRank(KVStoreHandle h, int* out) {
  GilT gil;
  auto* kv = static_cast<CKV*>(h);
  PyObject* res =
      PyObject_CallMethod(train_module(), "_c_kv_rank", "O", kv->obj);
  if (!res) {
    set_err();
    return fail();
  }
  *out = static_cast<int>(PyLong_AsLong(res));
  Py_DECREF(res);
  return 0;
}

MXNET_DLL int MXKVStoreGetGroupSize(KVStoreHandle h, int* out) {
  GilT gil;
  auto* kv = static_cast<CKV*>(h);
  PyObject* res =
      PyObject_CallMethod(train_module(), "_c_kv_num_workers", "O", kv->obj);
  if (!res) {
    set_err();
    return fail();
  }
  *out = static_cast<int>(PyLong_AsLong(res));
  Py_DECREF(res);
  return 0;
}

namespace {

int kv_send(CKV* kv, const char* method, int key, const float* data,
            const mx_uint* shape, mx_uint ndim) {
  size_t n = 1;
  PyObject* dims = PyList_New(ndim);
  for (mx_uint i = 0; i < ndim; ++i) {
    n *= shape[i];
    PyList_SetItem(dims, i, PyLong_FromUnsignedLong(shape[i]));
  }
  PyObject* blob = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(data), n * sizeof(float));
  PyObject* res = PyObject_CallMethod(train_module(), method, "OiOO", kv->obj,
                                      key, blob, dims);
  Py_DECREF(blob);
  Py_DECREF(dims);
  if (!res) {
    set_err();
    return fail();
  }
  Py_DECREF(res);
  return 0;
}

}  // namespace

MXNET_DLL int MXKVStoreInit(KVStoreHandle h, int key, const float* data,
                            const mx_uint* shape, mx_uint ndim) {
  GilT gil;
  return kv_send(static_cast<CKV*>(h), "_c_kv_init", key, data, shape, ndim);
}

MXNET_DLL int MXKVStorePush(KVStoreHandle h, int key, const float* data,
                            const mx_uint* shape, mx_uint ndim) {
  GilT gil;
  return kv_send(static_cast<CKV*>(h), "_c_kv_push", key, data, shape, ndim);
}

MXNET_DLL int MXKVStorePull(KVStoreHandle h, int key, const float** out,
                            mx_uint* out_size) {
  GilT gil;
  auto* kv = static_cast<CKV*>(h);
  return bytes_to_floats(
      PyObject_CallMethod(train_module(), "_c_kv_pull", "Oi", kv->obj, key),
      &kv->blob, out, out_size);
}

MXNET_DLL int MXExecutorInitXavier(ExecutorHandle h, int seed) {
  GilT gil;
  auto* e = static_cast<CExec*>(h);
  PyObject* res = PyObject_CallMethod(train_module(), "_c_init_xavier", "Oi",
                                      e->obj, seed);
  if (!res) {
    set_err();
    return fail();
  }
  Py_DECREF(res);
  return 0;
}

// ---- Imperative invoke + introspection (reference: c_api.h
// MXImperativeInvoke :518, MXListAllOpNames :594,
// MXSymbolListAtomicSymbolCreators :604, MXSymbolInferShape :854) ----------

namespace {

// creator handles are stable pointers into a process-wide op-name table
// (the reference's AtomicSymbolCreator is likewise an opaque registry entry)
std::vector<std::string>& op_name_table() {
  static std::vector<std::string>* t = nullptr;
  if (!t) {
    t = new std::vector<std::string>();
    PyObject* res =
        PyObject_CallMethod(train_module(), "_c_list_all_ops", NULL);
    if (res && PyList_Check(res)) {
      for (Py_ssize_t i = 0; i < PyList_Size(res); ++i) {
        const char* s = PyUnicode_AsUTF8(PyList_GetItem(res, i));
        if (s) t->push_back(s);
      }
    }
    Py_XDECREF(res);
    if (!res) PyErr_Clear();
  }
  return *t;
}

}  // namespace

MXNET_DLL int MXListAllOpNames(mx_uint* out_size, const char*** out_array) {
  GilT gil;
  auto& tbl = op_name_table();
  thread_local std::vector<const char*> ptrs;
  ptrs.clear();
  for (const auto& s : tbl) ptrs.push_back(s.c_str());
  *out_size = static_cast<mx_uint>(ptrs.size());
  *out_array = ptrs.data();
  return 0;
}

MXNET_DLL int MXSymbolListAtomicSymbolCreators(mx_uint* out_size,
                                               AtomicSymbolCreator** out_array) {
  GilT gil;
  auto& tbl = op_name_table();
  thread_local std::vector<AtomicSymbolCreator> creators;
  creators.clear();
  for (auto& s : tbl)
    creators.push_back(const_cast<std::string*>(&s));
  *out_size = static_cast<mx_uint>(creators.size());
  *out_array = creators.data();
  return 0;
}

MXNET_DLL int MXSymbolGetAtomicSymbolName(AtomicSymbolCreator creator,
                                          const char** name) {
  if (!creator) {
    mxtpu_set_train_error("null creator");
    return fail();
  }
  *name = static_cast<std::string*>(creator)->c_str();
  return 0;
}

namespace {

// C-side mirror of the autograd session's handle ids (python: capi_train's
// _AUTOGRAD_* maps). All access is under the GIL (every entry point takes
// GilT), which serializes it.
std::unordered_set<void*>& autograd_adopted() {
  static std::unordered_set<void*> s;
  return s;
}
std::unordered_set<void*>& autograd_marked() {
  static std::unordered_set<void*> s;
  return s;
}
std::atomic<bool> g_autograd_used{false};

// purge a freed handle from the session (installed as the NDArrayFree hook
// below): a recycled heap address must not resurrect a stale tape array
void autograd_on_free(void* handle) {
  if (!g_autograd_used.load(std::memory_order_acquire)) return;
  GilT gil;
  autograd_adopted().erase(handle);
  autograd_marked().erase(handle);
  PyObject* res = PyObject_CallMethod(train_module(), "_c_autograd_forget",
                                      "O&", PyLong_FromVoidPtr, handle);
  if (!res)
    PyErr_Clear();  // teardown path: never surface errors from Free
  else
    Py_DECREF(res);
}

struct InstallFreeHook {
  InstallFreeHook() { mxtpu_ndarray_free_hook = autograd_on_free; }
} g_install_free_hook;

}  // namespace

MXNET_DLL int MXImperativeInvoke(AtomicSymbolCreator creator, int num_inputs,
                                 NDArrayHandle* inputs, int* num_outputs,
                                 NDArrayHandle** outputs, int num_params,
                                 const char** param_keys,
                                 const char** param_vals) {
  GilT gil;
  if (!creator) {
    mxtpu_set_train_error("null creator");
    return fail();
  }
  const std::string& op_name = *static_cast<std::string*>(creator);
  PyObject* blobs = PyList_New(num_inputs);
  PyObject* shapes = PyList_New(num_inputs);
  PyObject* dtypes = PyList_New(num_inputs);
  for (int i = 0; i < num_inputs; ++i) {
    auto* a = static_cast<CArray*>(inputs[i]);
    // adopted (non-marked) handles are fed as their live python tape
    // arrays — the bytes would be discarded, so skip the copy entirely.
    // Marked variables DO marshal: their current bytes re-sync the value.
    bool skip_bytes = autograd_adopted().count(inputs[i]) &&
                      !autograd_marked().count(inputs[i]);
    PyList_SetItem(blobs, i,
                   skip_bytes
                       ? PyBytes_FromStringAndSize(nullptr, 0)
                       : PyBytes_FromStringAndSize(
                             reinterpret_cast<const char*>(a->data.data()),
                             a->data.size()));
    PyObject* dims = PyList_New(a->shape.size());
    for (size_t j = 0; j < a->shape.size(); ++j)
      PyList_SetItem(dims, j, PyLong_FromUnsignedLong(a->shape[j]));
    PyList_SetItem(shapes, i, dims);
    PyList_SetItem(dtypes, i, PyLong_FromLong(a->dtype));
  }
  PyObject* pkeys = PyList_New(num_params);
  PyObject* pvals = PyList_New(num_params);
  for (int i = 0; i < num_params; ++i) {
    PyList_SetItem(pkeys, i, PyUnicode_FromString(param_keys[i]));
    PyList_SetItem(pvals, i, PyUnicode_FromString(param_vals[i]));
  }
  // handle ids let the autograd session substitute live tape arrays for
  // marked/recorded inputs (see capi_train._c_imperative_invoke)
  PyObject* in_ids = PyList_New(num_inputs);
  for (int i = 0; i < num_inputs; ++i)
    PyList_SetItem(in_ids, i, PyLong_FromVoidPtr(inputs[i]));
  PyObject* res = PyObject_CallMethod(
      train_module(), "_c_imperative_invoke", "sOOOOOO", op_name.c_str(),
      blobs, shapes, dtypes, pkeys, pvals, in_ids);
  Py_DECREF(blobs);
  Py_DECREF(shapes);
  Py_DECREF(dtypes);
  Py_DECREF(pkeys);
  Py_DECREF(pvals);
  Py_DECREF(in_ids);
  if (!res) {
    set_err();
    return fail();
  }
  PyObject *oblobs = nullptr, *oshapes = nullptr, *odtypes = nullptr;
  if (!PyArg_ParseTuple(res, "OOO", &oblobs, &oshapes, &odtypes)) {
    Py_DECREF(res);
    set_err();
    return fail();
  }
  Py_ssize_t n_out = PyList_Size(oblobs);
  bool caller_provided = (*num_outputs > 0 && *outputs != nullptr);
  if (caller_provided && *num_outputs != static_cast<int>(n_out)) {
    Py_DECREF(res);
    mxtpu_set_train_error("MXImperativeInvoke: wrong number of provided "
                          "output handles");
    return fail();
  }
  thread_local std::vector<NDArrayHandle> out_handles;
  if (!caller_provided) out_handles.clear();
  auto drop_allocated = [&]() {
    if (caller_provided) return;
    for (NDArrayHandle h2 : out_handles) delete static_cast<CArray*>(h2);
    out_handles.clear();
  };
  for (Py_ssize_t i = 0; i < n_out; ++i) {
    char* buf = nullptr;
    Py_ssize_t len = 0;
    if (PyBytes_AsStringAndSize(PyList_GetItem(oblobs, i), &buf, &len) != 0) {
      Py_DECREF(res);
      drop_allocated();
      set_err();
      return fail();
    }
    CArray* arr = caller_provided
                      ? static_cast<CArray*>((*outputs)[i])
                      : new CArray();
    arr->shape.clear();
    PyObject* shp = PyList_GetItem(oshapes, i);
    for (Py_ssize_t j = 0; j < PyList_Size(shp); ++j)
      arr->shape.push_back(static_cast<mx_uint>(
          PyLong_AsUnsignedLong(PyList_GetItem(shp, j))));
    arr->dtype =
        static_cast<int>(PyLong_AsLong(PyList_GetItem(odtypes, i)));
    arr->data.assign(buf, buf + len);
    arr->none = false;
    if (!caller_provided) out_handles.push_back(arr);
  }
  Py_DECREF(res);
  if (!caller_provided) {
    *num_outputs = static_cast<int>(n_out);
    *outputs = out_handles.data();
  }
  // bind the (now known) output handle ids to the recorded python outputs;
  // a no-op unless this invoke was recorded by the autograd session
  PyObject* oids = PyList_New(n_out);
  for (Py_ssize_t i = 0; i < n_out; ++i)
    PyList_SetItem(
        oids, i,
        PyLong_FromVoidPtr(caller_provided ? (*outputs)[i]
                                           : out_handles[i]));
  PyObject* ares =
      PyObject_CallMethod(train_module(), "_c_autograd_adopt", "O", oids);
  Py_DECREF(oids);
  if (!ares) {
    set_err();
    return fail();
  }
  // helper returns how many it adopted (0 when not recording): mirror the
  // now-live ids so later invokes skip marshaling their bytes
  if (PyLong_AsLong(ares) == n_out && n_out > 0)
    for (Py_ssize_t i = 0; i < n_out; ++i)
      autograd_adopted().insert(caller_provided ? (*outputs)[i]
                                                : out_handles[i]);
  Py_DECREF(ares);
  return 0;
}

// ---- imperative autograd (reference: c_api.h:549-601 MXAutogradSetIsTraining
// / MarkVariables / ComputeGradient over src/ndarray/autograd.cc; here torch
// autograd under mxnet_tpu_torch.contrib.autograd) -------------------------

MXNET_DLL int MXAutogradSetIsTraining(int is_training, int* prev) {
  GilT gil;
  if (is_training) g_autograd_used.store(true, std::memory_order_release);
  PyObject* res = PyObject_CallMethod(
      train_module(), "_c_autograd_set_is_training", "i", is_training);
  if (!res) {
    set_err();
    return fail();
  }
  if (prev) *prev = static_cast<int>(PyLong_AsLong(res));
  Py_DECREF(res);
  return 0;
}

MXNET_DLL int MXAutogradMarkVariables(mx_uint num_var,
                                      NDArrayHandle* var_handles,
                                      mx_uint* reqs_array,
                                      NDArrayHandle* grad_handles) {
  GilT gil;
  g_autograd_used.store(true, std::memory_order_release);
  for (mx_uint i = 0; i < num_var; ++i)
    autograd_marked().insert(var_handles[i]);
  PyObject* ids = PyList_New(num_var);
  PyObject* blobs = PyList_New(num_var);
  PyObject* shapes = PyList_New(num_var);
  PyObject* dtypes = PyList_New(num_var);
  PyObject* reqs = PyList_New(num_var);
  PyObject* gids = PyList_New(num_var);
  PyObject* gblobs = PyList_New(num_var);
  for (mx_uint i = 0; i < num_var; ++i) {
    auto* v = static_cast<CArray*>(var_handles[i]);
    auto* g = static_cast<CArray*>(grad_handles[i]);
    PyList_SetItem(ids, i, PyLong_FromVoidPtr(var_handles[i]));
    PyList_SetItem(blobs, i,
                   PyBytes_FromStringAndSize(
                       reinterpret_cast<const char*>(v->data.data()),
                       v->data.size()));
    PyObject* dims = PyList_New(v->shape.size());
    for (size_t j = 0; j < v->shape.size(); ++j)
      PyList_SetItem(dims, j, PyLong_FromUnsignedLong(v->shape[j]));
    PyList_SetItem(shapes, i, dims);
    PyList_SetItem(dtypes, i, PyLong_FromLong(v->dtype));
    PyList_SetItem(reqs, i, PyLong_FromUnsignedLong(reqs_array[i]));
    PyList_SetItem(gids, i, PyLong_FromVoidPtr(grad_handles[i]));
    PyList_SetItem(gblobs, i,
                   PyBytes_FromStringAndSize(
                       reinterpret_cast<const char*>(g->data.data()),
                       g->data.size()));
  }
  PyObject* res = PyObject_CallMethod(
      train_module(), "_c_autograd_mark_variables", "OOOOOOO", ids, blobs,
      shapes, dtypes, reqs, gids, gblobs);
  Py_DECREF(ids);
  Py_DECREF(blobs);
  Py_DECREF(shapes);
  Py_DECREF(dtypes);
  Py_DECREF(reqs);
  Py_DECREF(gids);
  Py_DECREF(gblobs);
  if (!res) {
    set_err();
    return fail();
  }
  Py_DECREF(res);
  return 0;
}

MXNET_DLL int MXAutogradComputeGradient(mx_uint num_output,
                                        NDArrayHandle* output_handles) {
  GilT gil;
  // the python session drops adopted intermediates after backward (marked
  // variables stay live) — mirror that here
  autograd_adopted().clear();
  PyObject* heads = PyList_New(num_output);
  for (mx_uint i = 0; i < num_output; ++i)
    PyList_SetItem(heads, i, PyLong_FromVoidPtr(output_handles[i]));
  PyObject* res = PyObject_CallMethod(
      train_module(), "_c_autograd_compute_gradient", "O", heads);
  Py_DECREF(heads);
  if (!res) {
    set_err();
    return fail();
  }
  // [(grad handle id, bytes, shape, dtype), ...] -> write into the grad
  // handles the caller registered via MXAutogradMarkVariables
  if (!PyList_Check(res)) {
    Py_DECREF(res);
    mxtpu_set_train_error("autograd: helper did not return a list");
    return fail();
  }
  for (Py_ssize_t i = 0; i < PyList_Size(res); ++i) {
    PyObject* row = PyList_GetItem(res, i);
    PyObject *gid = nullptr, *blob = nullptr, *shp = nullptr, *dt = nullptr;
    if (!PyArg_ParseTuple(row, "OOOO", &gid, &blob, &shp, &dt)) {
      Py_DECREF(res);
      set_err();
      return fail();
    }
    auto* g = static_cast<CArray*>(PyLong_AsVoidPtr(gid));
    char* buf = nullptr;
    Py_ssize_t len = 0;
    if (!g || PyBytes_AsStringAndSize(blob, &buf, &len) != 0) {
      Py_DECREF(res);
      set_err();
      return fail();
    }
    g->shape.clear();
    for (Py_ssize_t j = 0; j < PyList_Size(shp); ++j)
      g->shape.push_back(static_cast<mx_uint>(
          PyLong_AsUnsignedLong(PyList_GetItem(shp, j))));
    g->dtype = static_cast<int>(PyLong_AsLong(dt));
    g->data.assign(buf, buf + len);
    g->none = false;
  }
  Py_DECREF(res);
  return 0;
}

namespace {

// thread-local result tables for the three InferShape shape lists
struct ShapeTable {
  std::vector<std::vector<mx_uint>> shapes;
  std::vector<mx_uint> ndims;
  std::vector<const mx_uint*> ptrs;
  void load(PyObject* list) {
    shapes.clear();
    ndims.clear();
    ptrs.clear();
    for (Py_ssize_t i = 0; i < PyList_Size(list); ++i) {
      PyObject* s = PyList_GetItem(list, i);
      std::vector<mx_uint> dims;
      for (Py_ssize_t j = 0; j < PyList_Size(s); ++j)
        dims.push_back(static_cast<mx_uint>(
            PyLong_AsUnsignedLong(PyList_GetItem(s, j))));
      shapes.push_back(std::move(dims));
    }
    for (auto& s : shapes) {
      ndims.push_back(static_cast<mx_uint>(s.size()));
      ptrs.push_back(s.data());
    }
  }
};

int infer_shape_impl(SymbolHandle sym, mx_uint num_args, const char** keys,
                     const mx_uint* arg_ind_ptr,
                     const mx_uint* arg_shape_data, mx_uint* in_shape_size,
                     const mx_uint** in_shape_ndim,
                     const mx_uint*** in_shape_data, mx_uint* out_shape_size,
                     const mx_uint** out_shape_ndim,
                     const mx_uint*** out_shape_data, mx_uint* aux_shape_size,
                     const mx_uint** aux_shape_ndim,
                     const mx_uint*** aux_shape_data, int* complete,
                     int partial) {
  GilT gil;
  auto* s = static_cast<CSym*>(sym);
  PyObject* key_list = PyList_New(num_args);
  PyObject* shape_list = PyList_New(num_args);
  for (mx_uint i = 0; i < num_args; ++i) {
    PyList_SetItem(key_list, i,
                   PyUnicode_FromString(keys ? keys[i] : ""));
    mx_uint lo = arg_ind_ptr[i], hi = arg_ind_ptr[i + 1];
    PyObject* dims = PyList_New(hi - lo);
    for (mx_uint j = lo; j < hi; ++j)
      PyList_SetItem(dims, j - lo, PyLong_FromUnsignedLong(arg_shape_data[j]));
    PyList_SetItem(shape_list, i, dims);
  }
  if (!keys) {
    // positional form: helper maps onto list_arguments order
    Py_DECREF(key_list);
    key_list = PyList_New(0);
  }
  PyObject* res =
      PyObject_CallMethod(train_module(), "_c_infer_shape", "OOOi", s->obj,
                          key_list, shape_list, partial);
  Py_DECREF(key_list);
  Py_DECREF(shape_list);
  if (!res) {
    set_err();
    return fail();
  }
  PyObject *in_l = nullptr, *out_l = nullptr, *aux_l = nullptr;
  int comp = 0;
  if (!PyArg_ParseTuple(res, "OOOi", &in_l, &out_l, &aux_l, &comp)) {
    Py_DECREF(res);
    set_err();
    return fail();
  }
  thread_local ShapeTable t_in, t_out, t_aux;
  t_in.load(in_l);
  t_out.load(out_l);
  t_aux.load(aux_l);
  Py_DECREF(res);
  *in_shape_size = static_cast<mx_uint>(t_in.shapes.size());
  *in_shape_ndim = t_in.ndims.data();
  *in_shape_data = t_in.ptrs.data();
  *out_shape_size = static_cast<mx_uint>(t_out.shapes.size());
  *out_shape_ndim = t_out.ndims.data();
  *out_shape_data = t_out.ptrs.data();
  *aux_shape_size = static_cast<mx_uint>(t_aux.shapes.size());
  *aux_shape_ndim = t_aux.ndims.data();
  *aux_shape_data = t_aux.ptrs.data();
  *complete = comp;
  return 0;
}

}  // namespace

MXNET_DLL int MXSymbolInferShape(
    SymbolHandle sym, mx_uint num_args, const char** keys,
    const mx_uint* arg_ind_ptr, const mx_uint* arg_shape_data,
    mx_uint* in_shape_size, const mx_uint** in_shape_ndim,
    const mx_uint*** in_shape_data, mx_uint* out_shape_size,
    const mx_uint** out_shape_ndim, const mx_uint*** out_shape_data,
    mx_uint* aux_shape_size, const mx_uint** aux_shape_ndim,
    const mx_uint*** aux_shape_data, int* complete) {
  return infer_shape_impl(sym, num_args, keys, arg_ind_ptr, arg_shape_data,
                          in_shape_size, in_shape_ndim, in_shape_data,
                          out_shape_size, out_shape_ndim, out_shape_data,
                          aux_shape_size, aux_shape_ndim, aux_shape_data,
                          complete, 0);
}

MXNET_DLL int MXSymbolInferShapePartial(
    SymbolHandle sym, mx_uint num_args, const char** keys,
    const mx_uint* arg_ind_ptr, const mx_uint* arg_shape_data,
    mx_uint* in_shape_size, const mx_uint** in_shape_ndim,
    const mx_uint*** in_shape_data, mx_uint* out_shape_size,
    const mx_uint** out_shape_ndim, const mx_uint*** out_shape_data,
    mx_uint* aux_shape_size, const mx_uint** aux_shape_ndim,
    const mx_uint*** aux_shape_data, int* complete) {
  return infer_shape_impl(sym, num_args, keys, arg_ind_ptr, arg_shape_data,
                          in_shape_size, in_shape_ndim, in_shape_data,
                          out_shape_size, out_shape_ndim, out_shape_data,
                          aux_shape_size, aux_shape_ndim, aux_shape_data,
                          complete, 1);
}

MXNET_DLL int MXRandomSeed(int seed) {
  GilT gil;
  PyObject* res =
      PyObject_CallMethod(train_module(), "_c_random_seed", "i", seed);
  if (!res) {
    set_err();
    return fail();
  }
  Py_DECREF(res);
  return 0;
}

MXNET_DLL int MXNotifyShutdown(void) {
  // engine drain point in the reference; every call here copies its
  // results to the host, which waits for the card, so nothing is pending
  return 0;
}

// ---- Symbol long tail (reference c_api.h: CreateFromFile :722, SaveToFile
// :745, Copy :760, Print :768, GetName :776, CreateGroup :713, GetInternals
// :795, GetOutput :811, GetAttr :784, SetAttr :800, ListAttr :816,
// GetAtomicSymbolInfo :644, InferType :888) --------------------------------

namespace {

int sym_from_call(PyObject* res, SymbolHandle* out) {
  if (!res) {
    set_err();
    return fail();
  }
  *out = new CSym{res};
  return 0;
}

int str_from_call(PyObject* res, const char** out) {
  if (!res) {
    set_err();
    return fail();
  }
  thread_local std::string ret;
  const char* s = PyUnicode_AsUTF8(res);
  if (!s) {
    Py_DECREF(res);
    set_err();
    return fail();
  }
  ret = s;
  Py_DECREF(res);
  *out = ret.c_str();
  return 0;
}

}  // namespace

MXNET_DLL int MXSymbolCreateFromFile(const char* fname, SymbolHandle* out) {
  GilT gil;
  return sym_from_call(
      PyObject_CallMethod(train_module(), "_c_symbol_from_file", "s", fname),
      out);
}

MXNET_DLL int MXSymbolSaveToFile(SymbolHandle sym, const char* fname) {
  GilT gil;
  auto* s = static_cast<CSym*>(sym);
  PyObject* res = PyObject_CallMethod(train_module(), "_c_symbol_save_file",
                                      "Os", s->obj, fname);
  if (!res) {
    set_err();
    return fail();
  }
  Py_DECREF(res);
  return 0;
}

MXNET_DLL int MXSymbolCopy(SymbolHandle sym, SymbolHandle* out) {
  GilT gil;
  auto* s = static_cast<CSym*>(sym);
  return sym_from_call(
      PyObject_CallMethod(train_module(), "_c_symbol_copy", "O", s->obj), out);
}

MXNET_DLL int MXSymbolPrint(SymbolHandle sym, const char** out_str) {
  GilT gil;
  auto* s = static_cast<CSym*>(sym);
  return str_from_call(
      PyObject_CallMethod(train_module(), "_c_symbol_print", "O", s->obj),
      out_str);
}

MXNET_DLL int MXSymbolGetName(SymbolHandle sym, const char** out,
                              int* success) {
  GilT gil;
  auto* s = static_cast<CSym*>(sym);
  int rc = str_from_call(
      PyObject_CallMethod(train_module(), "_c_symbol_name", "O", s->obj), out);
  if (rc == 0 && success) *success = (**out != '\0');
  return rc;
}

MXNET_DLL int MXSymbolCreateGroup(mx_uint num_symbols, SymbolHandle* symbols,
                                  SymbolHandle* out) {
  GilT gil;
  PyObject* lst = PyList_New(num_symbols);
  for (mx_uint i = 0; i < num_symbols; ++i) {
    PyObject* o = static_cast<CSym*>(symbols[i])->obj;
    Py_INCREF(o);
    PyList_SetItem(lst, i, o);
  }
  PyObject* res =
      PyObject_CallMethod(train_module(), "_c_symbol_group", "O", lst);
  Py_DECREF(lst);
  return sym_from_call(res, out);
}

MXNET_DLL int MXSymbolGetInternals(SymbolHandle sym, SymbolHandle* out) {
  GilT gil;
  auto* s = static_cast<CSym*>(sym);
  return sym_from_call(
      PyObject_CallMethod(train_module(), "_c_symbol_internals", "O", s->obj),
      out);
}

MXNET_DLL int MXSymbolGetOutput(SymbolHandle sym, mx_uint index,
                                SymbolHandle* out) {
  GilT gil;
  auto* s = static_cast<CSym*>(sym);
  return sym_from_call(
      PyObject_CallMethod(train_module(), "_c_symbol_get_output", "OI",
                          s->obj, index),
      out);
}

MXNET_DLL int MXSymbolGetAttr(SymbolHandle sym, const char* key,
                              const char** out, int* success) {
  GilT gil;
  auto* s = static_cast<CSym*>(sym);
  PyObject* res = PyObject_CallMethod(train_module(), "_c_symbol_attr", "Os",
                                      s->obj, key);
  if (!res) {
    set_err();
    return fail();
  }
  const char* val = nullptr;
  int found = 0;
  if (!PyArg_ParseTuple(res, "si", &val, &found)) {
    Py_DECREF(res);
    set_err();
    return fail();
  }
  thread_local std::string ret;
  ret = val;
  Py_DECREF(res);
  *out = ret.c_str();
  *success = found;
  return 0;
}

MXNET_DLL int MXSymbolSetAttr(SymbolHandle sym, const char* key,
                              const char* value) {
  GilT gil;
  auto* s = static_cast<CSym*>(sym);
  PyObject* res = PyObject_CallMethod(train_module(), "_c_symbol_set_attr",
                                      "Oss", s->obj, key, value);
  if (!res) {
    set_err();
    return fail();
  }
  Py_DECREF(res);
  return 0;
}

namespace {

int list_attr_impl(SymbolHandle sym, int recursive, mx_uint* out_size,
                   const char*** out) {
  GilT gil;
  auto* s = static_cast<CSym*>(sym);
  PyObject* res = PyObject_CallMethod(
      train_module(), "_c_symbol_list_attr", "Oi", s->obj, recursive);
  if (!res) {
    set_err();
    return fail();
  }
  PyObject *keys = nullptr, *vals = nullptr;
  if (!PyArg_ParseTuple(res, "OO", &keys, &vals)) {
    Py_DECREF(res);
    set_err();
    return fail();
  }
  // reference layout: flat [key0, val0, key1, val1, ...]
  thread_local std::vector<std::string> kv;
  thread_local std::vector<const char*> ptrs;
  kv.clear();
  ptrs.clear();
  for (Py_ssize_t i = 0; i < PyList_Size(keys); ++i) {
    const char* k = PyUnicode_AsUTF8(PyList_GetItem(keys, i));
    const char* v = PyUnicode_AsUTF8(PyList_GetItem(vals, i));
    if (!k || !v) {
      Py_DECREF(res);
      set_err();
      return fail();
    }
    kv.emplace_back(k);
    kv.emplace_back(v);
  }
  Py_DECREF(res);
  for (auto& x : kv) ptrs.push_back(x.c_str());
  *out_size = static_cast<mx_uint>(kv.size() / 2);
  *out = ptrs.data();
  return 0;
}

}  // namespace

MXNET_DLL int MXSymbolListAttr(SymbolHandle sym, mx_uint* out_size,
                               const char*** out) {
  return list_attr_impl(sym, 1, out_size, out);
}

MXNET_DLL int MXSymbolListAttrShallow(SymbolHandle sym, mx_uint* out_size,
                                      const char*** out) {
  return list_attr_impl(sym, 0, out_size, out);
}

MXNET_DLL int MXSymbolGetAtomicSymbolInfo(
    AtomicSymbolCreator creator, const char** name, const char** description,
    mx_uint* num_args, const char*** arg_names, const char*** arg_type_infos,
    const char*** arg_descriptions, const char** key_var_num_args) {
  GilT gil;
  if (!creator) {
    mxtpu_set_train_error("null creator");
    return fail();
  }
  const std::string& op = *static_cast<std::string*>(creator);
  PyObject* res = PyObject_CallMethod(
      train_module(), "_c_atomic_symbol_info", "s", op.c_str());
  if (!res) {
    set_err();
    return fail();
  }
  PyObject *doc = nullptr, *keys = nullptr, *types = nullptr, *descs = nullptr;
  if (!PyArg_ParseTuple(res, "OOOO", &doc, &keys, &types, &descs)) {
    Py_DECREF(res);
    set_err();
    return fail();
  }
  thread_local std::string t_name, t_doc, t_kvna;
  thread_local std::vector<std::string> t_strs;
  thread_local std::vector<const char*> t_keys, t_types, t_descs;
  t_name = op;
  t_doc = PyUnicode_AsUTF8(doc) ? PyUnicode_AsUTF8(doc) : "";
  t_kvna = "";
  t_strs.clear();
  t_keys.clear();
  t_types.clear();
  t_descs.clear();
  Py_ssize_t n = PyList_Size(keys);
  // reserve so c_str() pointers stay stable while filling
  t_strs.reserve(3 * n);
  for (Py_ssize_t i = 0; i < n; ++i) {
    t_strs.emplace_back(PyUnicode_AsUTF8(PyList_GetItem(keys, i)));
    t_keys.push_back(t_strs.back().c_str());
    t_strs.emplace_back(PyUnicode_AsUTF8(PyList_GetItem(types, i)));
    t_types.push_back(t_strs.back().c_str());
    t_strs.emplace_back(PyUnicode_AsUTF8(PyList_GetItem(descs, i)));
    t_descs.push_back(t_strs.back().c_str());
  }
  Py_DECREF(res);
  *name = t_name.c_str();
  *description = t_doc.c_str();
  *num_args = static_cast<mx_uint>(n);
  *arg_names = t_keys.data();
  *arg_type_infos = t_types.data();
  *arg_descriptions = t_descs.data();
  if (key_var_num_args) *key_var_num_args = t_kvna.c_str();
  return 0;
}

MXNET_DLL int MXSymbolInferType(SymbolHandle sym, mx_uint num_args,
                                const char** keys, const int* arg_type_data,
                                mx_uint* in_type_size, const int** in_type_data,
                                mx_uint* out_type_size,
                                const int** out_type_data,
                                mx_uint* aux_type_size,
                                const int** aux_type_data, int* complete) {
  GilT gil;
  auto* s = static_cast<CSym*>(sym);
  PyObject* key_list = PyList_New(num_args);
  PyObject* type_list = PyList_New(num_args);
  for (mx_uint i = 0; i < num_args; ++i) {
    PyList_SetItem(key_list, i, PyUnicode_FromString(keys[i]));
    PyList_SetItem(type_list, i, PyLong_FromLong(arg_type_data[i]));
  }
  PyObject* res = PyObject_CallMethod(train_module(), "_c_infer_type", "OOO",
                                      s->obj, key_list, type_list);
  Py_DECREF(key_list);
  Py_DECREF(type_list);
  if (!res) {
    set_err();
    return fail();
  }
  PyObject *in_l = nullptr, *out_l = nullptr, *aux_l = nullptr;
  int comp = 0;
  if (!PyArg_ParseTuple(res, "OOOi", &in_l, &out_l, &aux_l, &comp)) {
    Py_DECREF(res);
    set_err();
    return fail();
  }
  thread_local std::vector<int> t_in, t_out, t_aux;
  auto load = [](PyObject* l, std::vector<int>* v) {
    v->clear();
    for (Py_ssize_t i = 0; i < PyList_Size(l); ++i)
      v->push_back(static_cast<int>(PyLong_AsLong(PyList_GetItem(l, i))));
  };
  load(in_l, &t_in);
  load(out_l, &t_out);
  load(aux_l, &t_aux);
  Py_DECREF(res);
  *in_type_size = static_cast<mx_uint>(t_in.size());
  *in_type_data = t_in.data();
  *out_type_size = static_cast<mx_uint>(t_out.size());
  *out_type_data = t_out.data();
  *aux_type_size = static_cast<mx_uint>(t_aux.size());
  *aux_type_data = t_aux.data();
  *complete = comp;
  return 0;
}

MXNET_DLL int MXExecutorPrint(ExecutorHandle h, const char** out_str) {
  GilT gil;
  auto* e = static_cast<CExec*>(h);
  PyObject* sym = PyObject_GetAttrString(e->obj, "executor");
  PyObject* res = nullptr;
  if (sym) {
    PyObject* dbg = PyObject_CallMethod(sym, "debug_str", NULL);
    Py_DECREF(sym);
    res = dbg;
  }
  return str_from_call(res, out_str);
}

// ---- KVStore long tail (reference c_api.h: GetType :1239, role predicates
// :1288-1304, Barrier :1312) -----------------------------------------------

MXNET_DLL int MXKVStoreGetType(KVStoreHandle h, const char** out) {
  GilT gil;
  auto* kv = static_cast<CKV*>(h);
  return str_from_call(
      PyObject_CallMethod(train_module(), "_c_kv_type", "O", kv->obj), out);
}

MXNET_DLL int MXKVStoreIsWorkerNode(int* ret) {
  const char* role = getenv("DMLC_ROLE");
  *ret = (!role || strcmp(role, "worker") == 0) ? 1 : 0;
  return 0;
}

MXNET_DLL int MXKVStoreIsServerNode(int* ret) {
  const char* role = getenv("DMLC_ROLE");
  *ret = (role && strcmp(role, "server") == 0) ? 1 : 0;
  return 0;
}

MXNET_DLL int MXKVStoreIsSchedulerNode(int* ret) {
  const char* role = getenv("DMLC_ROLE");
  *ret = (role && strcmp(role, "scheduler") == 0) ? 1 : 0;
  return 0;
}

MXNET_DLL int MXKVStoreBarrier(KVStoreHandle h) {
  GilT gil;
  auto* kv = static_cast<CKV*>(h);
  PyObject* res =
      PyObject_CallMethod(train_module(), "_c_kv_barrier", "O", kv->obj);
  if (!res) {
    set_err();
    return fail();
  }
  Py_DECREF(res);
  return 0;
}

// ---- final long-tail wrappers (reference c_api.h: GetChildren :803,
// ExecutorOutputs :1010, DataIterCreateIter :1120, InitPSEnv :1227,
// SendCommmandToServers :1341, GetNumDeadNode :1354) -----------------------

MXNET_DLL int MXSymbolGetChildren(SymbolHandle sym, SymbolHandle* out) {
  GilT gil;
  auto* s = static_cast<CSym*>(sym);
  return sym_from_call(
      PyObject_CallMethod(train_module(), "_c_symbol_children", "O", s->obj),
      out);
}

// exact reference name for the iterator factory (this library's
// MXDataIterCreate is the same function with the same signature)
MXNET_DLL int MXDataIterCreateIter(const char* handle, mx_uint num_param,
                                   const char** keys, const char** vals,
                                   DataIterHandle* out) {
  return MXDataIterCreate(handle, num_param, keys, vals, out);
}

MXNET_DLL int MXExecutorOutputs(ExecutorHandle h, mx_uint* out_size,
                                NDArrayHandle** out) {
  GilT gil;
  auto* e = static_cast<CExec*>(h);
  PyObject* res =
      PyObject_CallMethod(train_module(), "_c_exec_outputs", "O", e->obj);
  if (!res) {
    set_err();
    return fail();
  }
  if (!PyList_Check(res)) {
    Py_DECREF(res);
    mxtpu_set_train_error("_c_exec_outputs: expected a list");
    return fail();
  }
  thread_local std::vector<NDArrayHandle> handles;
  // handles returned here are caller-freed (MXNDArrayFree), matching
  // MXImperativeInvoke's allocation contract
  handles.clear();
  for (Py_ssize_t i = 0; i < PyList_Size(res); ++i) {
    PyObject* tup = PyList_GetItem(res, i);
    PyObject* blob = nullptr;
    PyObject* shp = nullptr;
    if (!PyArg_ParseTuple(tup, "SO", &blob, &shp)) {
      Py_DECREF(res);
      set_err();
      return fail();
    }
    auto* arr = new CArray();
    arr->dtype = 0;
    for (Py_ssize_t j = 0; j < PyList_Size(shp); ++j)
      arr->shape.push_back(static_cast<mx_uint>(
          PyLong_AsUnsignedLong(PyList_GetItem(shp, j))));
    char* buf = nullptr;
    Py_ssize_t len = 0;
    PyBytes_AsStringAndSize(blob, &buf, &len);
    arr->data.assign(buf, buf + len);
    handles.push_back(arr);
  }
  Py_DECREF(res);
  *out_size = static_cast<mx_uint>(handles.size());
  *out = handles.data();
  return 0;
}

MXNET_DLL int MXInitPSEnv(mx_uint num_vars, const char** keys,
                          const char** vals) {
  for (mx_uint i = 0; i < num_vars; ++i) setenv(keys[i], vals[i], 1);
  return 0;
}

MXNET_DLL int MXKVStoreSendCommmandToServers(KVStoreHandle h, int cmd_head,
                                             const char* cmd_body) {
  GilT gil;
  auto* kv = static_cast<CKV*>(h);
  PyObject* res = PyObject_CallMethod(train_module(), "_c_kv_send_command",
                                      "Ois", kv->obj, cmd_head, cmd_body);
  if (!res) {
    set_err();
    return fail();
  }
  Py_DECREF(res);
  return 0;
}

MXNET_DLL int MXKVStoreGetNumDeadNode(KVStoreHandle h, int node_id,
                                      int* number, int timeout_sec) {
  GilT gil;
  (void)timeout_sec;
  auto* kv = static_cast<CKV*>(h);
  PyObject* res = PyObject_CallMethod(train_module(), "_c_kv_num_dead_node",
                                      "Oi", kv->obj, node_id);
  if (!res) {
    set_err();
    return fail();
  }
  *number = static_cast<int>(PyLong_AsLong(res));
  Py_DECREF(res);
  return 0;
}
