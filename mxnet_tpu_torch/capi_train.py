"""Python side of the port's training C API (counterpart of
``mxnet_tpu/capi_train.py``; its C shim is ``csrc/capi/c_api_train.cc``).

The reference exposes ~120 C functions over its C++ engine
(include/mxnet/c_api.h); the predict subset ships in the same
``libmxtpu_predict.so`` (:mod:`._capi`). This module backs the rest —
Symbol from JSON or operators, simple_bind, forward/backward,
argument/gradient/output access, SGD and momentum updates, imperative
invoke and autograd, rtc, the profiler, data iterators and the kvstore —
so a pure C/C++ client runs a whole training loop on the port's executor:
``dev_type`` ``"cpu"`` is the CPU, ``"gpu"``/``"tpu"`` the card, as
:class:`~.context.Context` maps them.

Every ``_c_*`` function takes/returns only C-friendly types (str, bytes,
int, float, opaque PyObject handles) — the C shim marshals nothing else.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = []


def _c_symbol_from_json(json_str):
    from .symbol import load_json

    return load_json(json_str)


def _c_symbol_to_json(sym):
    return sym.tojson()


def _c_symbol_arguments(sym):
    return list(sym.list_arguments())


def _c_symbol_outputs(sym):
    return list(sym.list_outputs())


def _c_symbol_aux_states(sym):
    return list(sym.list_auxiliary_states())


def _c_variable(name):
    from . import symbol

    return symbol.Variable(name)


def _c_create_symbol(op_name, name, param_keys, param_vals,
                     input_keys, input_syms):
    """Atomic-symbol creation + composition in one call (the reference splits
    this into MXSymbolCreateAtomicSymbol + MXSymbolCompose; the cpp-package's
    Operator::CreateSymbol always performs both back-to-back, so the C slice
    exposes the fused form). All params arrive as strings — the op's
    Parameter schema parses them, exactly as the JSON loader does."""
    from . import symbol
    from .base import MXNetError
    from .ops.registry import list_ops

    if op_name not in list_ops():
        raise MXNetError("no operator named %r" % (op_name,))
    fn = getattr(symbol, op_name)
    kwargs = dict(zip(param_keys, param_vals))
    if name:
        kwargs["name"] = name
    args = []
    for k, s in zip(input_keys, input_syms):
        if k:
            kwargs[k] = s
        else:
            args.append(s)
    return fn(*args, **kwargs)


class _CExecutor:
    """Bound training executor + the host-side mirrors the C client reads."""

    def __init__(self, sym, dev_type, dev_id, shapes, grad_req):
        from . import context

        ctx = context.Context(dev_type, dev_id)
        self.executor = sym.simple_bind(ctx, grad_req=grad_req, **shapes)
        # the names the C client binds shapes for ARE its data/label inputs:
        # updates must never touch them
        self.input_names = frozenset(shapes)
        self.outputs = []

    def arg(self, name):
        arr = self.executor.arg_dict.get(name)
        if arr is None:
            raise KeyError("no argument named %r" % (name,))
        return arr


def _c_simple_bind(sym, dev_type, dev_id, shape_keys, shape_data, grad_req):
    """shape_keys: list of names; shape_data: flat list-of-lists of ints."""
    shapes = {k: tuple(int(d) for d in s)
              for k, s in zip(shape_keys, shape_data)}
    return _CExecutor(sym, dev_type, int(dev_id), shapes, grad_req)


def _c_set_arg(cexec, name, data_bytes):
    arr = cexec.arg(name)
    flat = np.frombuffer(data_bytes, dtype=np.float32)
    if flat.size != int(np.prod(arr.shape)):
        raise ValueError(
            "size mismatch for %s: got %d floats, need %d"
            % (name, flat.size, int(np.prod(arr.shape))))
    arr[:] = flat.reshape(arr.shape).astype(arr.dtype)


def _c_set_aux(cexec, name, data_bytes):
    """(reference: aux states are set through MXExecutor's aux dict —
    base_module.set_params writes both arg and aux)."""
    arr = cexec.executor.aux_dict.get(name)
    if arr is None:
        raise ValueError("no auxiliary state named %s" % name)
    flat = np.frombuffer(data_bytes, dtype=np.float32)
    if flat.size != int(np.prod(arr.shape)):
        raise ValueError(
            "size mismatch for aux %s: got %d floats, need %d"
            % (name, flat.size, int(np.prod(arr.shape))))
    arr[:] = flat.reshape(arr.shape).astype(arr.dtype)


def _c_get_array(cexec, which, name_or_index):
    """bytes of (arg|grad|output|aux) as float32."""
    if which == "arg":
        arr = cexec.arg(name_or_index)
    elif which == "grad":
        arr = cexec.executor.grad_dict.get(name_or_index)
        if arr is None:
            raise KeyError("no gradient for %r" % (name_or_index,))
    elif which == "aux":
        arr = cexec.executor.aux_dict[name_or_index]
    else:
        arr = cexec.outputs[int(name_or_index)]
    return np.ascontiguousarray(
        arr.asnumpy().astype(np.float32)).tobytes()


def _c_get_shape(cexec, which, name_or_index):
    if which == "output":
        return list(cexec.outputs[int(name_or_index)].shape)
    if which == "grad":
        return list(cexec.executor.grad_dict[name_or_index].shape)
    return list(cexec.arg(name_or_index).shape)


def _c_num_outputs(cexec):
    return len(cexec.executor._symbol.list_outputs())


def _c_forward(cexec, is_train):
    cexec.outputs = cexec.executor.forward(is_train=bool(is_train))


def _c_backward(cexec):
    cexec.executor.backward()


def _c_momentum_update(cexec, lr, wd, momentum, rescale=1.0):
    """SGD with momentum over every parameter with a gradient (velocity
    state lives on the executor, device-resident): v = mom*v -
    lr*(rescale*grad + wd*w); w += v — the reference's sgd_mom_update rule
    (src/operator/optimizer_op-inl.h SGDMomUpdate). ``rescale`` is the
    reference optimizer's rescale_grad — loss-output gradients are
    batch-summed, so pass 1/batch_size for batch-mean training."""
    ex = cexec.executor
    if not hasattr(cexec, "mom"):
        cexec.mom = {}
    with torch.no_grad():
        for name, grad in ex.grad_dict.items():
            if grad is None or name in cexec.input_names:
                continue
            w = ex.arg_dict[name]
            v = cexec.mom.get(name)
            if v is None:
                v = cexec.mom[name] = torch.zeros_like(w.data)
            v.copy_(momentum * v - lr * (rescale * grad.data + wd * w.data))
            w[:] = w.data + v


def _c_save_params(cexec, path):
    """Write the executor's parameters (+aux) in the reference checkpoint
    format — `arg:`/`aux:` prefixed NDArray dict (model.py save_checkpoint),
    so C-trained weights load directly into Python Module/FeedForward and
    the reference itself."""
    from . import ndarray as nd

    ex = cexec.executor
    save_dict = {
        "arg:%s" % k: v for k, v in ex.arg_dict.items()
        if k not in cexec.input_names
    }
    save_dict.update({"aux:%s" % k: v for k, v in ex.aux_dict.items()})
    nd.save(path, save_dict)


def _c_load_params(cexec, path):
    from . import ndarray as nd

    ex = cexec.executor
    loaded = nd.load(path)
    n = 0
    for k, v in loaded.items():
        tag, _, name = k.partition(":")
        if tag == "arg" and name in ex.arg_dict \
                and name not in cexec.input_names:
            ex.arg_dict[name][:] = v
            n += 1
        elif tag == "aux" and name in ex.aux_dict:
            ex.aux_dict[name][:] = v
            n += 1
    return n


def _c_sgd_update(cexec, lr, wd, rescale=1.0):
    """w -= lr * (rescale*grad + wd*w) over every PARAMETER with a gradient
    — the minimal in-framework update so a C client need not round-trip
    params. The client's bound inputs (data/labels) also carry gradients
    under grad_req='write' but must never be updated. ``rescale`` is the
    reference optimizer's rescale_grad (pass 1/batch_size for batch-mean
    training; loss gradients are batch-summed). (Full optimizers remain the
    Python/Module surface's job.)"""
    ex = cexec.executor
    with torch.no_grad():
        for name, grad in ex.grad_dict.items():
            if grad is None or name in cexec.input_names:
                continue
            w = ex.arg_dict[name]
            w[:] = w.data - lr * (rescale * grad.data + wd * w.data)


# ---- Profiler (reference: c_api.h MXSetProfilerConfig/MXSetProfilerState/
# MXDumpProfile) -------------------------------------------------------------

def _c_profiler_set_config(mode, filename):
    from . import profiler

    profiler.profiler_set_config(mode=mode, filename=filename)


def _c_profiler_set_state(state):
    from . import profiler

    # the reference's C form takes 0/1; accept both that and the strings
    if state in (0, 1):
        state = "run" if state else "stop"
    profiler.profiler_set_state(state)


def _c_dump_profile():
    from . import profiler

    profiler.dump_profile()


# ---- Rtc (reference: c_api.h MXRtcCreate/MXRtcPush/MXRtcFree) --------------

def _c_rtc_create(name, input_names, output_names, kernel):
    from .rtc import Rtc

    # the C boundary carries names only; arrays bind at push time
    return Rtc(name, [(n, None) for n in input_names],
               [(n, None) for n in output_names], kernel)


def _c_rtc_push(rtc, input_blobs, input_shapes, output_shapes):
    """inputs as float32 bytes + shapes; returns list of output bytes."""
    from . import ndarray as nd

    ins = []
    for blob, shape in zip(input_blobs, input_shapes):
        flat = np.frombuffer(blob, dtype=np.float32)
        ins.append(nd.array(flat.reshape([int(d) for d in shape])))
    outs = [nd.zeros(tuple(int(d) for d in s)) for s in output_shapes]
    rtc.push(ins, outs)
    return [np.ascontiguousarray(o.asnumpy().astype(np.float32)).tobytes()
            for o in outs]


# ---- DataIter (reference: c_api.h MXListDataIters/MXDataIterCreateIter/
# Next/GetData/GetLabel/GetPadNum family) ------------------------------------

_C_ITER_NAMES = ("MNISTIter", "CSVIter", "ImageRecordIter",
                 "ImageDetRecordIter")


def _c_iter_list():
    return list(_C_ITER_NAMES)


def _parse_iter_param(v):
    """C clients pass every param as a string (the reference's convention);
    parse shapes/numbers/bools, fall back to the raw string. A value naming
    an existing path stays a string even if it LOOKS like a literal (a CSV
    file named '123' must not become the int 123)."""
    import ast
    import os

    s = v.strip()
    if os.path.exists(s):
        return s
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


class _CDataIter:
    def __init__(self, name, params):
        from . import io, io_image

        if name not in _C_ITER_NAMES:
            raise KeyError(
                "no data iterator named %r (have: %s)"
                % (name, ", ".join(_C_ITER_NAMES)))
        cls = getattr(io, name, None) or getattr(io_image, name)
        self.it = cls(**{k: _parse_iter_param(v) for k, v in params.items()})
        self.batch = None

    def next(self):
        try:
            self.batch = self.it.next()
            return True
        except StopIteration:
            self.batch = None
            return False

    def _current(self, which):
        if self.batch is None:
            raise RuntimeError("no current batch (call Next first)")
        arrs = self.batch.data if which == "data" else self.batch.label
        return arrs[0]

    def _array(self, which):
        return np.ascontiguousarray(
            self._current(which).asnumpy().astype(np.float32))


def _c_iter_create(name, param_keys, param_vals):
    return _CDataIter(name, dict(zip(param_keys, param_vals)))


def _c_iter_next(cit):
    return 1 if cit.next() else 0


def _c_iter_reset(cit):
    cit.it.reset()
    cit.batch = None


def _c_iter_get(cit, which):
    return cit._array(which).tobytes()


def _c_iter_shape(cit, which):
    # shape only — no batch materialization/host copy
    return [int(d) for d in cit._current(which).shape]


def _c_iter_pad(cit):
    if cit.batch is None:
        raise RuntimeError("no current batch (call Next first)")
    return int(cit.batch.pad or 0)


# ---- KVStore (reference: c_api.h MXKVStoreCreate/Init/Push/Pull family) ----

class _CKVStore:
    """KVStore handle + the host mirrors the C client reads. Values cross
    the boundary as float32 blobs; device placement/aggregation is the
    Python KVStore's job (same compute path as the Python surface)."""

    def __init__(self, kv_type):
        from .kvstore import create

        self.kv = create(kv_type)
        self.shapes = {}


def _c_kv_create(kv_type):
    return _CKVStore(kv_type)


def _c_kv_type(ckv):
    return ckv.kv.type


def _c_kv_rank(ckv):
    return int(ckv.kv.rank)


def _c_kv_num_workers(ckv):
    return int(ckv.kv.num_workers)


def _kv_array(ckv, key, data_bytes, shape):
    from . import ndarray as nd

    flat = np.frombuffer(data_bytes, dtype=np.float32)
    shape = tuple(int(d) for d in shape)
    if flat.size != int(np.prod(shape)):
        raise ValueError("key %s: got %d floats for shape %s"
                         % (key, flat.size, shape))
    ckv.shapes[int(key)] = shape
    return nd.array(flat.reshape(shape))


def _c_kv_init(ckv, key, data_bytes, shape):
    ckv.kv.init(int(key), _kv_array(ckv, key, data_bytes, shape))


def _c_kv_push(ckv, key, data_bytes, shape):
    ckv.kv.push(int(key), _kv_array(ckv, key, data_bytes, shape))


def _c_kv_pull(ckv, key):
    from . import ndarray as nd

    shape = ckv.shapes.get(int(key))
    if shape is None:
        raise KeyError("key %s was never initialized through this handle"
                       % (key,))
    out = nd.zeros(shape)
    ckv.kv.pull(int(key), out=out)
    return np.ascontiguousarray(
        out.asnumpy().astype(np.float32)).tobytes()


def _c_init_xavier(cexec, seed):
    """Xavier-initialize every weight, zero biases — convenience so the C
    client does not need an RNG."""
    from . import initializer as init_mod
    from . import random as rnd

    rnd.seed(int(seed))
    init = init_mod.Xavier()
    for name, arr in cexec.executor.arg_dict.items():
        if name.endswith(("_weight", "_bias", "_gamma", "_beta")):
            init(name, arr)


# ---- round 4: C API long tail (reference c_api.h:518 MXImperativeInvoke,
# :854 MXSymbolInferShape, :1087 MXExecutorSetMonitorCallback + op listing
# for MXSymbolListAtomicSymbolCreators) -------------------------------------

def _c_list_all_ops():
    """Registered op names (reference: MXListAllOpNames / the creator list
    behind MXSymbolListAtomicSymbolCreators)."""
    from .ops.registry import list_ops

    return sorted(list_ops())


def _c_imperative_invoke(op_name, blobs, shapes, dtypes, param_keys,
                         param_vals, in_ids=None):
    """Run one op imperatively on host blobs (reference: MXImperativeInvoke,
    c_api_ndarray.cc:324). Returns (out_blobs, out_shapes, out_dtypes).

    ``in_ids`` carries the C handle ids: inputs known to the autograd
    session (marked variables, adopted outputs) are fed as their LIVE
    python arrays so the tape stays connected — marked variables get their
    value re-synced from the C bytes first (the C side may have written the
    handle since mark time). When recording, outputs are stashed for
    _c_autograd_adopt."""
    from . import ndarray as nd
    from .contrib import autograd
    from .ndarray import _DTYPE_MX_TO_NP, _DTYPE_NP_TO_MX

    global _AUTOGRAD_PENDING
    # a failed previous invoke (error after the python call) must not leave
    # its outputs around for THIS invoke's adoption
    _AUTOGRAD_PENDING = []
    if in_ids is None:
        in_ids = [0] * len(blobs)
    arrs = []
    for b, s, t, hid in zip(blobs, shapes, dtypes, in_ids):
        live = _AUTOGRAD_ARRAYS.get(int(hid))
        if live is not None:
            if int(hid) in _AUTOGRAD_MARKED:
                dt = np.dtype(_DTYPE_MX_TO_NP[int(t)])
                cur = np.frombuffer(bytes(b), dtype=dt).reshape(
                    [int(x) for x in s])
                _resync_marked(live, cur)
            arrs.append(live)
            continue
        if len(b) == 0 and any(int(x) for x in s):
            # the C side skipped the bytes expecting a live tape array we
            # no longer hold — fail loudly rather than compute on garbage
            from .base import MXNetError
            raise MXNetError("stale autograd handle fed to %s" % op_name)
        arrs.append(_from_blob(b, s, t))
    attrs = {k: v for k, v in zip(param_keys, param_vals)}
    res = nd.imperative_invoke(op_name, arrs, attrs)
    if not isinstance(res, (list, tuple)):
        res = [res]
    if autograd.is_recording():
        _AUTOGRAD_PENDING = list(res)
    out_blobs, out_shapes, out_dtypes = [], [], []
    for r in res:
        a = r.asnumpy()
        out_blobs.append(np.ascontiguousarray(a).tobytes())
        out_shapes.append([int(x) for x in a.shape])
        out_dtypes.append(int(_DTYPE_NP_TO_MX[np.dtype(a.dtype)]))
    return out_blobs, out_shapes, out_dtypes


def _c_infer_shape(sym, keys, shape_data, partial):
    """(reference: MXSymbolInferShape / MXSymbolInferShapePartial,
    c_api.h:854). ``keys`` empty -> positional over list_arguments order.
    Returns (arg_shapes, out_shapes, aux_shapes, complete); unknown shapes
    come back as []."""
    arg_names = list(sym.list_arguments())
    if not keys:
        keys = arg_names[:len(shape_data)]
    kwargs = {k: tuple(int(x) for x in s)
              for k, s in zip(keys, shape_data) if len(s)}
    if partial:
        arg_shapes, out_shapes, aux_shapes = sym.infer_shape_partial(**kwargs)
    else:
        arg_shapes, out_shapes, aux_shapes = sym.infer_shape(**kwargs)

    def clean(lst):
        return [[int(x) for x in s] if s is not None else []
                for s in (lst or [])]

    def known(lst):
        return lst is not None and all(
            s is not None and 0 not in tuple(s) for s in lst)

    complete = int(known(arg_shapes) and known(out_shapes)
                   and (aux_shapes is None or known(aux_shapes)))
    return clean(arg_shapes), clean(out_shapes), clean(aux_shapes), complete


def _c_forward_monitored(cexec, is_train):
    """Forward with the per-node monitor active (reference:
    MXExecutorSetMonitorCallback -> GraphExecutor::ExecuteMonCallback,
    graph_executor.cc:761-781). Returns [(name, f32_bytes, shape), ...] in
    execution order; the C shim replays them into the client's callback."""
    ex = cexec.executor
    collected = []

    def cb(name, arr):
        a = np.ascontiguousarray(arr.asnumpy().astype(np.float32))
        collected.append((name, a.tobytes(), [int(x) for x in a.shape]))

    prev_cb = ex.monitor_callback
    prev_active = ex._monitor_active
    ex.set_monitor_callback(cb)
    try:
        cexec.outputs = ex.forward(is_train=bool(is_train))
    finally:
        ex.monitor_callback = prev_cb
        ex._monitor_active = prev_active
    return collected


def _c_random_seed(seed):
    from . import random as rnd

    rnd.seed(int(seed))


def _c_symbol_from_file(path):
    from .symbol import load

    return load(path)


def _c_symbol_save_file(sym, path):
    sym.save(path)


def _c_symbol_copy(sym):
    from .symbol import load_json

    return load_json(sym.tojson())


def _c_symbol_name(sym):
    return sym.name or ""


def _c_symbol_print(sym):
    return sym.debug_str()


def _c_symbol_group(syms):
    from .symbol import Group

    return Group(list(syms))


def _c_symbol_internals(sym):
    return sym.get_internals()


def _c_symbol_get_output(sym, index):
    return sym[int(index)]


def _c_symbol_attr(sym, key):
    v = sym.attr(key)
    return ("", 0) if v is None else (str(v), 1)


def _c_symbol_set_attr(sym, key, value):
    sym._set_attr(**{key: value})


def _c_symbol_list_attr(sym, recursive):
    d = sym.list_attr(recursive=bool(recursive)) if recursive in (0, 1) \
        else sym.list_attr()
    keys, vals = [], []
    for k, v in sorted(d.items()):
        keys.append(str(k))
        vals.append(str(v))
    return keys, vals


def _c_infer_type(sym, keys, dtypes):
    """(reference: MXSymbolInferType c_api.h:888) — int mshadow flags."""
    from .ndarray import _DTYPE_MX_TO_NP, _DTYPE_NP_TO_MX

    kwargs = {k: np.dtype(_DTYPE_MX_TO_NP[int(t)])
              for k, t in zip(keys, dtypes)}
    arg_types, out_types, aux_types = sym.infer_type(**kwargs)

    def flags(lst):
        return [int(_DTYPE_NP_TO_MX[np.dtype(t)]) if t is not None else -1
                for t in (lst or [])]

    complete = int(all(t is not None for t in (arg_types or [])))
    return flags(arg_types), flags(out_types), flags(aux_types), complete


def _c_atomic_symbol_info(op_name):
    """(reference: MXSymbolGetAtomicSymbolInfo c_api.h:644) — name, doc,
    arg names/types/descriptions from the op registry's Param schema."""
    from .ops.registry import get_op

    op = get_op(op_name)
    doc = getattr(op, "doc", "") or ""
    keys, types, descs = [], [], []
    params = getattr(op, "params", None) or {}
    for k, spec in sorted(params.items()):
        keys.append(str(k))
        kind = getattr(spec, "kind", "value")
        if getattr(spec, "required", False):
            types.append("%s, required" % kind)
        else:
            types.append("%s, optional, default=%r"
                         % (kind, getattr(spec, "default", None)))
        descs.append("")
    return str(doc), keys, types, descs


def _c_kv_barrier(ckv):
    ckv.kv.barrier()




def _c_symbol_children(sym):
    from .base import MXNetError

    c = sym.get_children()
    if c is None:
        raise MXNetError("symbol has no children (a Variable)")
    return c


def _c_kv_send_command(ckv, head, body):
    ckv.kv._send_command_to_servers(int(head), body)


def _c_kv_num_dead_node(ckv, node_id):
    return int(ckv.kv.get_num_dead_node(int(node_id)))


def _c_exec_outputs(cexec):
    """All output blobs at once (reference: MXExecutorOutputs c_api.h:1010)
    -> [(f32_bytes, shape), ...]."""
    outs = cexec.executor.outputs
    ret = []
    for o in outs:
        a = np.ascontiguousarray(o.asnumpy().astype(np.float32))
        ret.append((a.tobytes(), [int(x) for x in a.shape]))
    return ret


# ---- imperative autograd session (reference: MXAutogradSetIsTraining /
# MXAutogradMarkVariables / MXAutogradComputeGradient, c_api.h:549-601 over
# src/ndarray/autograd.cc). The C boundary marshals host blobs, so the
# session keeps the LIVE python NDArray for every C handle the tape must
# see: marked variables (value re-synced from the C bytes at each invoke)
# and recorded op outputs (adopted under their C handle ids right after
# MXImperativeInvoke creates the handles).

_AUTOGRAD_ARRAYS = {}   # C handle id -> live python NDArray on the tape
_AUTOGRAD_MARKED = {}   # C var handle id -> (var, grad, grad handle id, req)
_AUTOGRAD_PENDING = []  # outputs of the last recorded invoke, pre-adoption


def _resync_marked(var, value):
    """Give a marked variable the bytes its C handle holds now (the client
    may have written it since it was marked). A variable whose value is
    unchanged keeps its tensor, so the ops already recorded on it stay
    connected to the leaf the gradient is taken for."""
    t = var.data
    if tuple(value.shape) != tuple(t.shape) or np.array_equal(
            var.asnumpy(), value):
        return
    fresh = torch.as_tensor(value.copy()).to(t.device, t.dtype)
    var._set_data(fresh.requires_grad_(t.requires_grad))


def _from_blob(blob, shape, dtype):
    from . import ndarray as nd
    from .ndarray import _DTYPE_MX_TO_NP

    dt = np.dtype(_DTYPE_MX_TO_NP[int(dtype)])
    a = np.frombuffer(bytearray(blob), dtype=dt).reshape(
        [int(x) for x in shape])
    return nd.array(a, dtype=dt)


def _c_autograd_set_is_training(flag):
    from .contrib import autograd

    return 1 if autograd.set_is_training(bool(flag)) else 0


def _c_autograd_mark_variables(var_ids, blobs, shapes, dtypes, reqs,
                               grad_ids, grad_blobs):
    """reqs use the reference OpReqType enum: 0 null / 1 write /
    2 write-inplace (treated as write) / 3 add."""
    from .contrib import autograd

    req_name = {0: "null", 1: "write", 2: "write", 3: "add"}
    variables, gradients, grad_reqs = [], [], []
    for vid, b, s, t, r, gid, gb in zip(var_ids, blobs, shapes, dtypes,
                                        reqs, grad_ids, grad_blobs):
        var = _from_blob(b, s, t)
        grad = _from_blob(gb, s, t)  # grads share the variable's shape/dtype
        req = req_name[int(r)]
        _AUTOGRAD_ARRAYS[int(vid)] = var
        _AUTOGRAD_MARKED[int(vid)] = (var, grad, int(gid), req)
        variables.append(var)
        gradients.append(grad)
        grad_reqs.append(req)
    autograd.mark_variables(variables, gradients, grad_reqs)


def _c_autograd_adopt(out_ids):
    """Bind the C handle ids MXImperativeInvoke just created to the python
    outputs of the recorded invoke (same order). Returns how many were
    adopted (0 when the invoke was not recorded)."""
    global _AUTOGRAD_PENDING
    n = 0
    for hid, arr in zip(out_ids, _AUTOGRAD_PENDING):
        _AUTOGRAD_ARRAYS[int(hid)] = arr
        n += 1
    _AUTOGRAD_PENDING = []
    return n


def _c_autograd_compute_gradient(head_ids):
    """Replay the tape, then return the marked gradients as
    [(grad C handle id, f-contiguous bytes, shape, mx dtype), ...] for the
    C side to write back into the caller's grad handles."""
    from .base import MXNetError
    from .contrib import autograd
    from .ndarray import _DTYPE_NP_TO_MX

    heads = []
    for hid in head_ids:
        arr = _AUTOGRAD_ARRAYS.get(int(hid))
        if arr is None:
            raise MXNetError(
                "MXAutogradComputeGradient: output handle was not produced "
                "by a recorded MXImperativeInvoke (is training on?)")
        heads.append(arr)
    autograd.compute_gradient(heads)
    ret = []
    for vid, (var, grad, gid, req) in _AUTOGRAD_MARKED.items():
        if req == "null":  # OpReqType null: never write the caller's handle
            continue
        g = grad.asnumpy()
        ret.append((gid, np.ascontiguousarray(g).tobytes(),
                    [int(x) for x in g.shape],
                    int(_DTYPE_NP_TO_MX[np.dtype(g.dtype)])))
    # drop adopted intermediates (their tape is consumed); keep marked vars
    # live so another recorded forward can run against them
    _AUTOGRAD_ARRAYS.clear()
    _AUTOGRAD_ARRAYS.update(
        {vid: e[0] for vid, e in _AUTOGRAD_MARKED.items()})
    return ret


def _c_autograd_forget(hid):
    """MXNDArrayFree purge: a freed handle's id must not resurrect a stale
    array when the allocator recycles the address. Dropping a marked
    variable's var OR grad handle unmarks it."""
    from .contrib import autograd

    hid = int(hid)
    _AUTOGRAD_ARRAYS.pop(hid, None)
    entry = _AUTOGRAD_MARKED.pop(hid, None)
    if entry is not None:
        autograd._MARKED.pop(id(entry[0]), None)
        return
    for vid, (var, _grad, gid, _req) in list(_AUTOGRAD_MARKED.items()):
        if gid == hid:
            del _AUTOGRAD_MARKED[vid]
            autograd._MARKED.pop(id(var), None)
