/* Training-side C API slice (src/c_api_train.cc) — the Symbol/Executor
 * function families from the reference's include/mxnet/c_api.h, enough for a
 * pure C/C++ client to run a complete training loop against the port's
 * executor. Exported by the port's libmxtpu_predict.so (built by
 * mxnet_tpu_torch/_capi.py).
 *
 * All float buffers are float32, row-major, caller-owned. Pointers returned
 * through out-params stay valid until the next call on the same handle
 * (thread-local for the Symbol string lists). On error every function
 * returns -1; MXTrainGetLastError() describes the failure.
 */
#ifndef MXTPU_C_TRAIN_API_H_
#define MXTPU_C_TRAIN_API_H_

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void* SymbolHandle;
typedef void* ExecutorHandle;
typedef void* KVStoreHandle;
typedef unsigned int mx_uint;

const char* MXTrainGetLastError(void);

/* ---- Symbol ---- */
int MXSymbolCreateFromJSON(const char* json, SymbolHandle* out);
int MXSymbolSaveToJSON(SymbolHandle sym, const char** out_json);
int MXSymbolListArguments(SymbolHandle sym, mx_uint* out_size,
                          const char*** out_array);
int MXSymbolListOutputs(SymbolHandle sym, mx_uint* out_size,
                        const char*** out_array);
int MXSymbolListAuxiliaryStates(SymbolHandle sym, mx_uint* out_size,
                                const char*** out_array);
int MXSymbolFree(SymbolHandle sym);

/* Symbol construction from C (the cpp-package surface). The reference
 * splits atomic-symbol creation and composition (MXSymbolCreateAtomicSymbol
 * + MXSymbolCompose); cpp-package's Operator::CreateSymbol always runs both
 * back-to-back, so this slice exposes the fused form. Every operator
 * parameter is passed as a string and parsed by the op's schema. input_keys
 * entries may be "" (positional input) or the operator's input name; name
 * may be NULL/"" for an auto-generated node name. */
int MXSymbolCreateVariable(const char* name, SymbolHandle* out);
int MXSymbolCreateFromOperator(const char* op_name, const char* name,
                               mx_uint num_param, const char** param_keys,
                               const char** param_vals, mx_uint num_inputs,
                               const char** input_keys, SymbolHandle* inputs,
                               SymbolHandle* out);

/* ---- Executor ----
 * Shapes are CSR-packed like the reference's simple_bind: keys[i] names an
 * input whose dims are arg_shape_data[arg_shape_idx[i] .. arg_shape_idx[i+1]).
 * grad_req: "write" | "add" | "null". dev_type: "cpu" | "tpu" | "gpu". */
int MXExecutorSimpleBindLite(SymbolHandle sym, const char* dev_type,
                             int dev_id, mx_uint num_args, const char** keys,
                             const mx_uint* arg_shape_data,
                             const mx_uint* arg_shape_idx,
                             const char* grad_req, ExecutorHandle* out);
int MXExecutorInitXavier(ExecutorHandle exec, int seed);
int MXExecutorSetArg(ExecutorHandle exec, const char* name, const float* data,
                     mx_uint size);
int MXExecutorSetAux(ExecutorHandle exec, const char* name, const float* data,
                     mx_uint size);
int MXExecutorGetArg(ExecutorHandle exec, const char* name, const float** out,
                     mx_uint* out_size);
int MXExecutorGetGrad(ExecutorHandle exec, const char* name,
                      const float** out, mx_uint* out_size);
int MXExecutorGetOutput(ExecutorHandle exec, mx_uint index, const float** out,
                        mx_uint* out_size);
int MXExecutorOutputShape(ExecutorHandle exec, mx_uint index,
                          const mx_uint** out_shape, mx_uint* out_dim);
int MXExecutorForward(ExecutorHandle exec, int is_train);
/* head_grads unsupported in the slice: pass (0, NULL); loss outputs seed 1 */
int MXExecutorBackward(ExecutorHandle exec, mx_uint num_head_grads,
                       void** head_grads);
/* w -= lr * (rescale_grad*grad + wd*w) for every argument with a gradient.
 * Loss-output gradients are batch-SUMMED (reference semantics); pass
 * rescale_grad = 1/batch_size for batch-mean training, 1.0 for raw sums. */
int MXExecutorSGDUpdate(ExecutorHandle exec, float lr, float wd,
                        float rescale_grad);
/* v = momentum*v - lr*(rescale_grad*grad + wd*w); w += v */
int MXExecutorMomentumUpdate(ExecutorHandle exec, float lr, float wd,
                             float momentum, float rescale_grad);
int MXExecutorNumOutputs(ExecutorHandle exec, mx_uint* out);
int MXExecutorGetAux(ExecutorHandle exec, const char* name, const float** out,
                     mx_uint* out_size);
/* Reference checkpoint format (`arg:`/`aux:`-prefixed NDArray dict) — files
 * interchange with Python Module/FeedForward and the reference itself. */
int MXExecutorSaveParams(ExecutorHandle exec, const char* path);
int MXExecutorLoadParams(ExecutorHandle exec, const char* path,
                         mx_uint* out_num_loaded);
int MXExecutorFree(ExecutorHandle exec);

/* ---- Imperative + introspection (reference: c_api.h MXImperativeInvoke
 * :518, MXListAllOpNames :594, MXSymbolListAtomicSymbolCreators :604,
 * MXSymbolInferShape :854). NDArrayHandle is the host-array handle from
 * c_predict_api.h's NDList family (same CArray type across the .so). ---- */
typedef void* NDArrayHandle;
typedef void* AtomicSymbolCreator;

/* ---- NDArray host-array family (implemented in pure C++ by
 * c_api_ndarray.cc; reference: c_api.h MXNDArrayCreate :139 and friends).
 * Data is dtype-sized host bytes; sizes are in ELEMENTS. ---- */
int MXNDArrayCreateNone(NDArrayHandle* out);
int MXNDArrayCreate(const mx_uint* shape, mx_uint ndim, int dev_type,
                    int dev_id, int delay_alloc, NDArrayHandle* out);
int MXNDArrayCreateEx(const mx_uint* shape, mx_uint ndim, int dev_type,
                      int dev_id, int delay_alloc, int dtype,
                      NDArrayHandle* out);
int MXNDArrayFree(NDArrayHandle handle);
int MXNDArraySyncCopyFromCPU(NDArrayHandle handle, const void* data,
                             size_t size);
int MXNDArraySyncCopyToCPU(NDArrayHandle handle, void* data, size_t size);
int MXNDArrayWaitToRead(NDArrayHandle handle);
int MXNDArrayWaitToWrite(NDArrayHandle handle);
int MXNDArrayWaitAll(void);
int MXNDArrayGetShape(NDArrayHandle handle, mx_uint* out_dim,
                      const mx_uint** out_pdata);
int MXNDArrayGetData(NDArrayHandle handle, void** out_pdata);
int MXNDArrayGetDType(NDArrayHandle handle, int* out_dtype);
int MXNDArrayGetContext(NDArrayHandle handle, int* out_dev_type,
                        int* out_dev_id);
int MXNDArraySave(const char* fname, mx_uint num_args, NDArrayHandle* args,
                  const char** keys);
int MXNDArrayLoad(const char* fname, mx_uint* out_size,
                  NDArrayHandle** out_arr, mx_uint* out_name_size,
                  const char*** out_names);
int MXNDArraySlice(NDArrayHandle handle, mx_uint begin, mx_uint end,
                   NDArrayHandle* out);
int MXNDArrayAt(NDArrayHandle handle, mx_uint idx, NDArrayHandle* out);
int MXNDArrayReshape(NDArrayHandle handle, int ndim, int* dims,
                     NDArrayHandle* out);

int MXListAllOpNames(mx_uint* out_size, const char*** out_array);
int MXSymbolListAtomicSymbolCreators(mx_uint* out_size,
                                     AtomicSymbolCreator** out_array);
int MXSymbolGetAtomicSymbolName(AtomicSymbolCreator creator,
                                const char** name);
/* Run one op on host arrays. Inputs are NDArrayHandles (MXNDArrayCreateEx +
 * SyncCopyFromCPU). On entry *num_outputs==0 and *outputs==NULL: the
 * library allocates output handles (caller frees each via MXNDArrayFree;
 * the handle array itself is thread-local). With caller-provided outputs,
 * results are copied into them (shapes must match). */
int MXImperativeInvoke(AtomicSymbolCreator creator, int num_inputs,
                       NDArrayHandle* inputs, int* num_outputs,
                       NDArrayHandle** outputs, int num_params,
                       const char** param_keys, const char** param_vals);
/* ---- Imperative autograd (reference: c_api.h MXAutogradSetIsTraining
 * :549, MXAutogradMarkVariables :558, MXAutogradComputeGradient :570 over
 * src/ndarray/autograd.cc; here over mxnet_tpu_torch.contrib.autograd, which
 * records with torch autograd as the ops run). Flow: set training
 * on, mark variable handles with grad handles (reqs use the OpReqType
 * enum: 0 null / 1 write / 3 add), run ops through MXImperativeInvoke,
 * then ComputeGradient on the loss handle writes into the grad handles.
 * A marked variable's CURRENT bytes are read at each invoke, so updating
 * it via MXNDArraySyncCopyFromCPU between steps is seen. ---- */
int MXAutogradSetIsTraining(int is_training, int* prev);
int MXAutogradMarkVariables(mx_uint num_var, NDArrayHandle* var_handles,
                            mx_uint* reqs_array, NDArrayHandle* grad_handles);
int MXAutogradComputeGradient(mx_uint num_output,
                              NDArrayHandle* output_handles);
/* Shape inference (reference signature, CSR shape args like simple_bind;
 * keys==NULL means positional). Unknown shapes come back with ndim 0;
 * *complete is 1 when every shape is fully known. Returned tables are
 * thread-local, valid until the next InferShape call on any symbol. */
int MXSymbolInferShape(SymbolHandle sym, mx_uint num_args, const char** keys,
                       const mx_uint* arg_ind_ptr,
                       const mx_uint* arg_shape_data, mx_uint* in_shape_size,
                       const mx_uint** in_shape_ndim,
                       const mx_uint*** in_shape_data, mx_uint* out_shape_size,
                       const mx_uint** out_shape_ndim,
                       const mx_uint*** out_shape_data, mx_uint* aux_shape_size,
                       const mx_uint** aux_shape_ndim,
                       const mx_uint*** aux_shape_data, int* complete);
int MXSymbolInferShapePartial(
    SymbolHandle sym, mx_uint num_args, const char** keys,
    const mx_uint* arg_ind_ptr, const mx_uint* arg_shape_data,
    mx_uint* in_shape_size, const mx_uint** in_shape_ndim,
    const mx_uint*** in_shape_data, mx_uint* out_shape_size,
    const mx_uint** out_shape_ndim, const mx_uint*** out_shape_data,
    mx_uint* aux_shape_size, const mx_uint** aux_shape_ndim,
    const mx_uint*** aux_shape_data, int* complete);
/* Per-node monitor (reference: MXExecutorSetMonitorCallback c_api.h:1087 ->
 * GraphExecutor::ExecuteMonCallback). While installed, every
 * MXExecutorForward runs the eager monitored pass and invokes `callback`
 * once per node output with a float32 host NDArrayHandle (owned by the
 * executor, valid until the next forward). NULL callback uninstalls. */
typedef void (*ExecutorMonitorCallback)(const char* name, NDArrayHandle arr,
                                        void* callback_handle);
int MXExecutorSetMonitorCallback(ExecutorHandle exec,
                                 ExecutorMonitorCallback callback,
                                 void* callback_handle);
int MXRandomSeed(int seed);
int MXNotifyShutdown(void);

/* Symbol long tail (reference c_api.h :644-:920) */
int MXSymbolCreateFromFile(const char* fname, SymbolHandle* out);
int MXSymbolSaveToFile(SymbolHandle sym, const char* fname);
int MXSymbolCopy(SymbolHandle sym, SymbolHandle* out);
int MXSymbolPrint(SymbolHandle sym, const char** out_str);
int MXSymbolGetName(SymbolHandle sym, const char** out, int* success);
int MXSymbolCreateGroup(mx_uint num_symbols, SymbolHandle* symbols,
                        SymbolHandle* out);
int MXSymbolGetInternals(SymbolHandle sym, SymbolHandle* out);
int MXSymbolGetOutput(SymbolHandle sym, mx_uint index, SymbolHandle* out);
int MXSymbolGetAttr(SymbolHandle sym, const char* key, const char** out,
                    int* success);
int MXSymbolSetAttr(SymbolHandle sym, const char* key, const char* value);
/* flat [key0, val0, key1, val1, ...] like the reference */
int MXSymbolListAttr(SymbolHandle sym, mx_uint* out_size, const char*** out);
int MXSymbolListAttrShallow(SymbolHandle sym, mx_uint* out_size,
                            const char*** out);
int MXSymbolGetAtomicSymbolInfo(AtomicSymbolCreator creator, const char** name,
                                const char** description, mx_uint* num_args,
                                const char*** arg_names,
                                const char*** arg_type_infos,
                                const char*** arg_descriptions,
                                const char** key_var_num_args);
int MXSymbolInferType(SymbolHandle sym, mx_uint num_args, const char** keys,
                      const int* arg_type_data, mx_uint* in_type_size,
                      const int** in_type_data, mx_uint* out_type_size,
                      const int** out_type_data, mx_uint* aux_type_size,
                      const int** aux_type_data, int* complete);
int MXExecutorPrint(ExecutorHandle exec, const char** out_str);
int MXKVStoreGetType(KVStoreHandle kv, const char** out);
int MXKVStoreIsWorkerNode(int* ret);
int MXKVStoreIsServerNode(int* ret);
int MXKVStoreIsSchedulerNode(int* ret);
int MXKVStoreBarrier(KVStoreHandle kv);

/* ---- DataIter (reference: c_api.h MXListDataIters / MXDataIterCreateIter /
 * Next / BeforeFirst / GetData / GetLabel / GetDataShape / GetPadNum) ----
 * Params are strings, parsed by the iterator's schema (shapes like
 * "(1,28,28)", numbers, booleans, paths). Data crosses as float32; pull
 * pointers stay valid until the next fetch on the same handle. */
typedef void* DataIterHandle;
int MXListDataIters(mx_uint* out_size, const char*** out_array);
int MXDataIterCreate(const char* name, mx_uint num_param, const char** keys,
                     const char** vals, DataIterHandle* out);
int MXDataIterFree(DataIterHandle iter);
int MXDataIterNext(DataIterHandle iter, int* out);
int MXDataIterBeforeFirst(DataIterHandle iter);
int MXDataIterGetData(DataIterHandle iter, const float** out,
                      mx_uint* out_size);
int MXDataIterGetLabel(DataIterHandle iter, const float** out,
                       mx_uint* out_size);
int MXDataIterGetDataShape(DataIterHandle iter, const mx_uint** out_shape,
                           mx_uint* out_dim);
int MXDataIterGetPadNum(DataIterHandle iter, int* out);

/* ---- KVStore (reference: c_api.h MXKVStoreCreate/Init/Push/Pull) ----
 * Values cross the boundary as float32 buffers; aggregation runs on the
 * framework's KVStore (same compute path as the Python surface). Pull
 * pointers stay valid until the next pull on the same handle. */
int MXKVStoreCreate(const char* type, KVStoreHandle* out);
int MXKVStoreFree(KVStoreHandle kv);
int MXKVStoreGetRank(KVStoreHandle kv, int* out);
int MXKVStoreGetGroupSize(KVStoreHandle kv, int* out);
int MXKVStoreInit(KVStoreHandle kv, int key, const float* data,
                  const mx_uint* shape, mx_uint ndim);
int MXKVStorePush(KVStoreHandle kv, int key, const float* data,
                  const mx_uint* shape, mx_uint ndim);
int MXKVStorePull(KVStoreHandle kv, int key, const float** out,
                  mx_uint* out_size);

/* ---- Profiler (reference: c_api.h MXSetProfilerConfig/State/DumpProfile)
 * mode: "symbolic" | "all"; state: 0 stop, 1 run. Dump writes the
 * chrome-trace JSON configured by MXSetProfilerConfig. */
int MXSetProfilerConfig(const char* mode, const char* filename);
int MXSetProfilerState(int state);
int MXDumpProfile(void);

/* ---- Rtc (reference: c_api.h MXRtcCreate/Push/Free) ----
 * Runtime-compiled kernels: the kernel body is the framework's rtc dialect
 * (Python text over torch; reference used CUDA source). Buffers are
 * float32; shapes CSR-packed like simple_bind. Output pointers stay valid
 * until the next push on the same handle. */
typedef void* RtcHandle;
int MXRtcCreate(const char* name, mx_uint num_input, mx_uint num_output,
                const char** input_names, const char** output_names,
                const char* kernel, RtcHandle* out);
int MXRtcPush(RtcHandle h, mx_uint num_input, const float** input_data,
              const mx_uint* input_shape_data, const mx_uint* input_shape_idx,
              mx_uint num_output, const mx_uint* output_shape_data,
              const mx_uint* output_shape_idx, const float** out_data,
              mx_uint* out_sizes);
int MXRtcFree(RtcHandle h);

/* ---- RecordIO (reference: c_api.h MXRecordIOWriterCreate/WriteRecord/
 * Tell, MXRecordIOReaderCreate/ReadRecord/Seek) ----
 * Pure C++ (c_api_recordio.cc) — the reference wire format, byte-
 * interchanging with recordio.py, the native sharded reader, and the
 * reference itself. ReadRecord returns 0 with *out_buf=NULL at EOF; the
 * pointer stays valid until the next read on the same handle. */
typedef void* RecordIOHandle;
int MXRecordIOWriterCreate(const char* uri, RecordIOHandle* out);
int MXRecordIOWriterFree(RecordIOHandle h);
int MXRecordIOWriterWriteRecord(RecordIOHandle h, const char* buf,
                                size_t size);
int MXRecordIOWriterTell(RecordIOHandle h, size_t* pos);
int MXRecordIOReaderCreate(const char* uri, RecordIOHandle* out);
int MXRecordIOReaderFree(RecordIOHandle h);
int MXRecordIOReaderReadRecord(RecordIOHandle h, const char** out_buf,
                               size_t* out_size);
int MXRecordIOReaderSeek(RecordIOHandle h, size_t pos);

#ifdef __cplusplus
}
#endif
#endif /* MXTPU_C_TRAIN_API_H_ */
