// C predict API — the standalone deployment surface for C/C++ clients
// (reference: include/mxnet/c_predict_api.h + src/c_api/c_predict_api.cc:
// MXPredCreate/SetInput/Forward/GetOutputShape/GetOutput/Free, MXNDList*).
//
// The reference links the full libmxnet; here the predictor embeds CPython and
// delegates to mxnet_tpu_torch.predict (whose forward is the port's executor
// on the current context: the card, whose attention runs the flash kernel),
// so any C/C++/FFI caller gets the identical function signatures while the
// compute path stays the port's. Built by mxnet_tpu_torch/_capi.py (links
// libpython).
//
// Threading: every entry point takes the GIL via PyGILState_Ensure, so the
// library is safe to call from any thread after MXPredInit/first use.
#include <Python.h>
#include <dlfcn.h>

#include <cstdint>
#include <cstdio>
#include <string>
#include <vector>

#define MXNET_DLL extern "C" __attribute__((visibility("default")))

typedef void* PredictorHandle;
typedef void* NDListHandle;
typedef unsigned int mx_uint;
typedef float mx_float;

// Promote libpython's symbols to global visibility before initializing the
// embedded interpreter. When this library is dlopen'd RTLD_LOCAL by an FFI
// host (perl XSLoader, ruby, node), python extension modules (numpy, torch)
// loaded later by the embedded interpreter cannot resolve Py* symbols
// otherwise. No-op when the host already links libpython (python itself,
// directly-linked C clients).
void mxtpu_promote_libpython() {
  static const char* patterns[] = {
      "libpython%d.%d.so",      // -dev symlink
      "libpython%d.%d.so.1.0",  // runtime soname (no -dev installed)
      "libpython%d.%dm.so",     // pre-3.8 'm' ABI
  };
  char name[64];
  for (const char* pat : patterns) {
    std::snprintf(name, sizeof(name), pat, PY_MAJOR_VERSION,
                  PY_MINOR_VERSION);
    if (dlopen(name, RTLD_NOW | RTLD_GLOBAL)) return;
  }
  // best-effort: hosts that already link libpython don't need any of these
}

namespace {

thread_local std::string g_last_error;

struct PyEnv {
  PyEnv() {
    if (!Py_IsInitialized()) {
      mxtpu_promote_libpython();
      Py_InitializeEx(0);
      owns = true;
#if PY_VERSION_HEX < 0x03090000
      PyEval_InitThreads();
#endif
      // release the GIL acquired by Py_Initialize so workers can Ensure it
      state = PyEval_SaveThread();
    }
  }
  bool owns = false;
  PyThreadState* state = nullptr;
};

PyEnv& env() {
  static PyEnv e;
  return e;
}

struct Gil {
  Gil() {
    env();
    st = PyGILState_Ensure();
  }
  ~Gil() { PyGILState_Release(st); }
  PyGILState_STATE st;
};

void set_py_error() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  g_last_error = "python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* msg = PyUnicode_AsUTF8(s);
      if (msg) g_last_error = msg;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

PyObject* predict_module() {
  static PyObject* mod = nullptr;  // borrowed forever once imported
  if (!mod) {
    mod = PyImport_ImportModule("mxnet_tpu_torch.predict");
    if (!mod) set_py_error();
  }
  return mod;
}

struct Pred {
  PyObject* obj;  // mxnet_tpu_torch.predict.Predictor
  // per-handle shape storage: MXPredGetOutputShape returns a pointer that
  // must stay valid until the next call on the SAME handle (the reference
  // stores out_shapes_ per predictor, c_predict_api.cc)
  std::vector<mx_uint> shape;
};

struct NDList {
  std::vector<std::string> names;
  std::vector<std::string> blobs;        // raw fp32 bytes
  std::vector<std::vector<mx_uint>> shapes;
  std::vector<mx_uint> shape_buf;        // scratch for MXNDListGet returns
};

}  // namespace

MXNET_DLL const char* MXGetLastError() { return g_last_error.c_str(); }

// shared error channel for the other translation units in this .so
// (c_api_ndarray.cc routes its failures here so c_api.h's single accessor
// reports them)
void mxtpu_set_last_error(const std::string& msg) { g_last_error = msg; }

static int CreateImpl(const char* symbol_json_str, const void* param_bytes,
                      int param_size, mx_uint num_input_nodes,
                      const char** input_keys,
                      const mx_uint* input_shape_indptr,
                      const mx_uint* input_shape_data,
                      mx_uint num_output_nodes, const char** output_keys,
                      PredictorHandle* out) {
  Gil gil;
  PyObject* mod = predict_module();
  if (!mod) return -1;
  PyObject* names = PyList_New(num_input_nodes);
  PyObject* shapes = PyList_New(num_input_nodes);
  for (mx_uint i = 0; i < num_input_nodes; ++i) {
    PyList_SetItem(names, i, PyUnicode_FromString(input_keys[i]));
    mx_uint lo = input_shape_indptr[i], hi = input_shape_indptr[i + 1];
    PyObject* shp = PyList_New(hi - lo);
    for (mx_uint j = lo; j < hi; ++j)
      PyList_SetItem(shp, j - lo, PyLong_FromUnsignedLong(input_shape_data[j]));
    PyList_SetItem(shapes, i, shp);
  }
  PyObject* outputs;
  if (num_output_nodes) {
    outputs = PyList_New(num_output_nodes);
    for (mx_uint i = 0; i < num_output_nodes; ++i)
      PyList_SetItem(outputs, i, PyUnicode_FromString(output_keys[i]));
  } else {
    outputs = Py_None;
    Py_INCREF(outputs);
  }
  PyObject* blob = PyBytes_FromStringAndSize(
      static_cast<const char*>(param_bytes), param_size);
  PyObject* res = PyObject_CallMethod(mod, "_c_create", "sOOOO",
                                      symbol_json_str, blob, names, shapes,
                                      outputs);
  Py_DECREF(blob);
  Py_DECREF(names);
  Py_DECREF(shapes);
  Py_DECREF(outputs);
  if (!res) {
    set_py_error();
    return -1;
  }
  *out = new Pred{res, {}};
  return 0;
}

MXNET_DLL int MXPredCreate(const char* symbol_json_str, const void* param_bytes,
                           int param_size, int dev_type, int dev_id,
                           mx_uint num_input_nodes, const char** input_keys,
                           const mx_uint* input_shape_indptr,
                           const mx_uint* input_shape_data,
                           PredictorHandle* out) {
  (void)dev_type;
  (void)dev_id;  // device selection: the port's current context decides
  return CreateImpl(symbol_json_str, param_bytes, param_size, num_input_nodes,
                    input_keys, input_shape_indptr, input_shape_data, 0,
                    nullptr, out);
}

MXNET_DLL int MXPredCreatePartialOut(const char* symbol_json_str,
                                     const void* param_bytes, int param_size,
                                     int dev_type, int dev_id,
                                     mx_uint num_input_nodes,
                                     const char** input_keys,
                                     const mx_uint* input_shape_indptr,
                                     const mx_uint* input_shape_data,
                                     mx_uint num_output_nodes,
                                     const char** output_keys,
                                     PredictorHandle* out) {
  (void)dev_type;
  (void)dev_id;
  // requested internal outputs become the predictor's output group
  // (reference: MXPredCreatePartialOut; Predictor(output_names=...))
  return CreateImpl(symbol_json_str, param_bytes, param_size, num_input_nodes,
                    input_keys, input_shape_indptr, input_shape_data,
                    num_output_nodes, output_keys, out);
}

MXNET_DLL int MXPredSetInput(PredictorHandle handle, const char* key,
                             const mx_float* data, mx_uint size) {
  Gil gil;
  Pred* p = static_cast<Pred*>(handle);
  PyObject* mod = predict_module();
  // flat fp32 buffer, read in place by python (its address and length),
  // which copies it into the bound input of the input's shape
  PyObject* res = PyObject_CallMethod(
      mod, "_c_set_input_ptr", "OsKI", p->obj, key,
      static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(data)),
      size);
  if (!res) {
    set_py_error();
    return -1;
  }
  Py_DECREF(res);
  return 0;
}

MXNET_DLL int MXPredForward(PredictorHandle handle) {
  Gil gil;
  Pred* p = static_cast<Pred*>(handle);
  PyObject* res = PyObject_CallMethod(predict_module(), "_c_forward", "O", p->obj);
  if (!res) {
    set_py_error();
    return -1;
  }
  Py_DECREF(res);
  return 0;
}

MXNET_DLL int MXPredPartialForward(PredictorHandle handle, int step,
                                   int* step_left) {
  // the executor runs the whole graph per forward; one step completes all
  if (step_left) *step_left = 0;
  if (step > 0) return 0;
  return MXPredForward(handle);
}

MXNET_DLL int MXPredGetOutputShape(PredictorHandle handle, mx_uint index,
                                   mx_uint** shape_data, mx_uint* shape_ndim) {
  Gil gil;
  Pred* p = static_cast<Pred*>(handle);
  PyObject* res = PyObject_CallMethod(predict_module(), "_c_output_shape",
                                      "OI", p->obj, index);
  if (!res) {
    set_py_error();
    return -1;
  }
  p->shape.clear();
  for (Py_ssize_t i = 0; i < PyList_Size(res); ++i)
    p->shape.push_back(
        static_cast<mx_uint>(PyLong_AsUnsignedLong(PyList_GetItem(res, i))));
  Py_DECREF(res);
  *shape_data = p->shape.data();
  *shape_ndim = static_cast<mx_uint>(p->shape.size());
  return 0;
}

MXNET_DLL int MXPredGetOutput(PredictorHandle handle, mx_uint index,
                              mx_float* data, mx_uint size) {
  Gil gil;
  Pred* p = static_cast<Pred*>(handle);
  // python copies the output (float32) straight into the caller's buffer
  PyObject* res = PyObject_CallMethod(
      predict_module(), "_c_get_output_into", "OIKI", p->obj, index,
      static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(data)),
      size);
  if (!res) {
    set_py_error();
    return -1;
  }
  Py_DECREF(res);
  return 0;
}

MXNET_DLL int MXPredFree(PredictorHandle handle) {
  Gil gil;
  Pred* p = static_cast<Pred*>(handle);
  Py_XDECREF(p->obj);
  delete p;
  return 0;
}

MXNET_DLL int MXNDListCreate(const char* nd_file_bytes, int nd_file_size,
                             NDListHandle* out, mx_uint* out_length) {
  Gil gil;
  PyObject* blob = PyBytes_FromStringAndSize(nd_file_bytes, nd_file_size);
  PyObject* res =
      PyObject_CallMethod(predict_module(), "_c_ndlist", "O", blob);
  Py_DECREF(blob);
  if (!res) {
    set_py_error();
    return -1;
  }
  PyObject *names, *blobs, *shapes;
  if (!PyArg_ParseTuple(res, "OOO", &names, &blobs, &shapes)) {
    set_py_error();
    Py_DECREF(res);
    return -1;
  }
  NDList* list = new NDList();
  for (Py_ssize_t i = 0; i < PyList_Size(names); ++i) {
    const char* key = PyUnicode_AsUTF8(PyList_GetItem(names, i));
    list->names.push_back(key ? key : "");
    char* b;
    Py_ssize_t n;
    PyBytes_AsStringAndSize(PyList_GetItem(blobs, i), &b, &n);
    list->blobs.emplace_back(b, n);
    PyObject* shp = PyList_GetItem(shapes, i);
    std::vector<mx_uint> sv;
    for (Py_ssize_t j = 0; j < PyList_Size(shp); ++j)
      sv.push_back(
          static_cast<mx_uint>(PyLong_AsUnsignedLong(PyList_GetItem(shp, j))));
    list->shapes.push_back(std::move(sv));
  }
  Py_DECREF(res);
  *out = list;
  *out_length = static_cast<mx_uint>(list->names.size());
  return 0;
}

MXNET_DLL int MXNDListGet(NDListHandle handle, mx_uint index, const char** out_key,
                          const mx_float** out_data, const mx_uint** out_shape,
                          mx_uint* out_ndim) {
  NDList* list = static_cast<NDList*>(handle);
  if (index >= list->names.size()) {
    g_last_error = "NDList index out of range";
    return -1;
  }
  *out_key = list->names[index].c_str();
  *out_data = reinterpret_cast<const mx_float*>(list->blobs[index].data());
  *out_shape = list->shapes[index].data();
  *out_ndim = static_cast<mx_uint>(list->shapes[index].size());
  return 0;
}

MXNET_DLL int MXNDListFree(NDListHandle handle) {
  delete static_cast<NDList*>(handle);
  return 0;
}
