/* C predict API declarations (reference: include/mxnet/c_predict_api.h).
 * Implemented by the port's libmxtpu_predict.so (mxnet_tpu_torch/csrc/capi/
 * c_predict_api.cc, built by mxnet_tpu_torch/_capi.py), which embeds the
 * Python runtime and runs forward through mxnet_tpu_torch.predict on the
 * port's current context. dev_type/dev_id are accepted and ignored: the
 * context decides (the card; the CPU under MXNET_DEFAULT_CONTEXT=cpu). */
#ifndef MXTPU_C_PREDICT_API_H_
#define MXTPU_C_PREDICT_API_H_

#ifdef __cplusplus
extern "C" {
#endif

typedef float mx_float;
typedef unsigned int mx_uint;
typedef void* PredictorHandle;
typedef void* NDListHandle;

const char* MXGetLastError();

int MXPredCreate(const char* symbol_json_str, const void* param_bytes,
                 int param_size, int dev_type, int dev_id,
                 mx_uint num_input_nodes, const char** input_keys,
                 const mx_uint* input_shape_indptr,
                 const mx_uint* input_shape_data, PredictorHandle* out);

int MXPredCreatePartialOut(const char* symbol_json_str, const void* param_bytes,
                           int param_size, int dev_type, int dev_id,
                           mx_uint num_input_nodes, const char** input_keys,
                           const mx_uint* input_shape_indptr,
                           const mx_uint* input_shape_data,
                           mx_uint num_output_nodes, const char** output_keys,
                           PredictorHandle* out);

int MXPredSetInput(PredictorHandle handle, const char* key,
                   const mx_float* data, mx_uint size);
int MXPredForward(PredictorHandle handle);
int MXPredPartialForward(PredictorHandle handle, int step, int* step_left);
int MXPredGetOutputShape(PredictorHandle handle, mx_uint index,
                         mx_uint** shape_data, mx_uint* shape_ndim);
int MXPredGetOutput(PredictorHandle handle, mx_uint index, mx_float* data,
                    mx_uint size);
int MXPredFree(PredictorHandle handle);

int MXNDListCreate(const char* nd_file_bytes, int nd_file_size,
                   NDListHandle* out, mx_uint* out_length);
int MXNDListGet(NDListHandle handle, mx_uint index, const char** out_key,
                const mx_float** out_data, const mx_uint** out_shape,
                mx_uint* out_ndim);
int MXNDListFree(NDListHandle handle);

#ifdef __cplusplus
}
#endif

#endif  // MXTPU_C_PREDICT_API_H_
