"""Standalone inference API of the port (counterpart of
``mxnet_tpu/predict.py``).

Reference: include/mxnet/c_predict_api.h + src/c_api/c_predict_api.cc:
create a predictor from a Symbol JSON string and a parameter blob (the
NDArray-dict save format), set named inputs, forward, read outputs — the
deployment surface of the reference's C and C++ predict clients, which
the port's ``csrc/capi/c_predict_api.cc`` serves through the ``_c_*``
helpers below.

The predictor is one executor bound with ``grad_req="null"`` on a
context: by default :func:`~.context.current_context`, the card (its
attention runs the flash kernel), or the CPU inside ``with mx.cpu():`` or
under ``MXNET_DEFAULT_CONTEXT=cpu``; without CUDA and outside those it
raises, as every entry point of the port does. ``reshape`` rebinds for
new input shapes.
"""
from __future__ import annotations

import ctypes
import io as _io

import numpy as np
import torch

from . import context as _context
from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError

__all__ = ["Predictor", "load_ndarray_file"]


def load_ndarray_file(blob):
    """Parse a parameter blob (bytes of the NDArray-dict save format) into a
    dict (reference: MXNDListCreate, c_predict_api.cc)."""
    return nd.load(_io.BytesIO(blob) if isinstance(blob, (bytes, bytearray))
                   else blob)


class Predictor:
    """(reference: MXPredCreate/MXPredCreatePartialOut c_predict_api.cc)

    ::

        pred = Predictor(open("model-symbol.json").read(),
                         open("model-0001.params","rb").read(),
                         input_shapes={"data": (1, 3, 224, 224)})
        pred.set_input("data", img)
        pred.forward()
        out = pred.get_output(0)
    """

    def __init__(self, symbol_json, param_blob, ctx=None, input_shapes=None,
                 output_names=None):
        if isinstance(symbol_json, bytes):
            symbol_json = symbol_json.decode()
        self.symbol = sym_mod.load_json(symbol_json)
        if output_names:  # partial-out predictor (MXPredCreatePartialOut)
            outs = self.symbol.get_internals()
            if isinstance(output_names, str):
                self.symbol = outs[output_names]
            else:
                self.symbol = sym_mod.Group([outs[n] for n in output_names])
        self.ctx = ctx if ctx is not None else _context.current_context()
        params = param_blob if isinstance(param_blob, dict) \
            else load_ndarray_file(param_blob)
        self._arg_params = {k[4:]: v for k, v in params.items()
                            if k.startswith("arg:")}
        self._aux_params = {k[4:]: v for k, v in params.items()
                            if k.startswith("aux:")}
        # also accept un-prefixed dicts (Module.save_checkpoint params load)
        for k, v in params.items():
            if ":" not in k:
                self._arg_params[k] = v
        if not input_shapes:
            raise MXNetError("input_shapes required (name -> shape)")
        self._input_shapes = dict(input_shapes)
        self._bind()

    def _bind(self):
        arg_names = self.symbol.list_arguments()
        self._input_names = [n for n in arg_names
                             if n not in self._arg_params
                             or n in self._input_shapes]
        missing = [n for n in self._input_names if n not in self._input_shapes]
        if missing:
            # label inputs (e.g. softmax_label) are inferable from the data
            # shapes — the reference predict API also only takes data shapes
            inferred, _, _ = self.symbol.infer_shape_partial(
                **self._input_shapes)
            for n, shp in zip(arg_names, inferred):
                if n in missing and shp is not None and 0 not in tuple(shp):
                    self._input_shapes[n] = tuple(shp)
            missing = [n for n in self._input_names
                       if n not in self._input_shapes]
        if missing:
            raise MXNetError("missing input shapes for %s" % missing)
        self._exe = self.symbol.simple_bind(
            ctx=self.ctx, grad_req="null", **self._input_shapes)
        for n, v in self._arg_params.items():
            if n in self._exe.arg_dict:
                self._exe.arg_dict[n][:] = v
        for n, v in self._aux_params.items():
            if n in self._exe.aux_dict:
                self._exe.aux_dict[n][:] = v
        self._outputs = None

    def set_input(self, name, data):
        """(reference: MXPredSetInput) — copied into the bound input, in its
        dtype, on the predictor's device."""
        if name not in self._exe.arg_dict:
            raise MXNetError("unknown input %s" % name)
        self._exe.arg_dict[name][:] = np.asarray(data, np.float32)

    def forward(self, **inputs):
        """(reference: MXPredForward); optionally pass inputs as kwargs."""
        for k, v in inputs.items():
            self.set_input(k, v)
        self._outputs = self._exe.forward(is_train=False)
        return self

    def get_output(self, index):
        """(reference: MXPredGetOutput) -> numpy array"""
        if self._outputs is None:
            raise MXNetError("call forward() first")
        return self._outputs[index].asnumpy()

    @property
    def num_outputs(self):
        return len(self.symbol.list_outputs())

    def reshape(self, input_shapes):
        """(reference: MXPredReshape) — rebind for new shapes, keeping the
        parameters."""
        self._input_shapes.update(input_shapes)
        self._bind()
        return self


# ---- C-shim helpers (consumed by csrc/capi/c_predict_api.cc via the
# embedded interpreter; byte-oriented so the C side never touches numpy) ----
def _c_create(symbol_json, param_bytes, input_names, input_shapes,
              output_names=None):
    shapes = {n: tuple(s) for n, s in zip(input_names, input_shapes)}
    return Predictor(symbol_json, bytes(param_bytes), input_shapes=shapes,
                     output_names=list(output_names) if output_names else None)


def _c_forward(pred):
    pred.forward()


def _c_output_shape(pred, index):
    # shape only — no device fetch, and valid right after create (reference:
    # MXPredGetOutputShape works before the first forward so clients can size
    # their output buffers)
    if pred._outputs is not None:
        return list(pred._outputs[index].shape)
    _, out_shapes, _ = pred.symbol.infer_shape(**pred._input_shapes)
    return list(out_shapes[index])


def _c_get_output(pred, index):
    out = np.ascontiguousarray(pred.get_output(index), dtype=np.float32)
    return out.tobytes()


def _c_ndlist(blob):
    d = load_ndarray_file(bytes(blob))
    names = list(d.keys())
    return names, [np.ascontiguousarray(d[n].asnumpy(), np.float32).tobytes()
                   for n in names], [list(d[n].shape) for n in names]


def _host_floats(address, size):
    """The caller's ``size`` float32 values at ``address``, as a numpy
    array over that memory (no copy)."""
    return np.ctypeslib.as_array((ctypes.c_float * size).from_address(address))


def _c_set_input_ptr(pred, name, address, size):
    """MXPredSetInput: the caller's flat float32 buffer, copied into the
    bound input (of its shape, on the predictor's device)."""
    if name not in pred._exe.arg_dict:
        raise MXNetError("unknown input %s" % name)
    shape = pred._exe.arg_dict[name].shape
    if size != int(np.prod(shape)):
        raise MXNetError("input %s: got %d floats for shape %s"
                         % (name, size, shape))
    pred.set_input(name, _host_floats(address, size).reshape(shape))


def _c_get_output_into(pred, index, address, size):
    """MXPredGetOutput: output ``index`` copied as float32 straight into the
    caller's buffer of ``size`` floats."""
    if pred._outputs is None:
        raise MXNetError("call forward() first")
    out = pred._outputs[index].data
    if out.numel() != size:
        raise MXNetError("output size mismatch")
    torch.from_numpy(_host_floats(address, size)).copy_(out.detach().reshape(-1))


def _c_set_input_flat(pred, name, data_bytes):
    if name not in pred._exe.arg_dict:
        raise MXNetError("unknown input %s" % name)
    shape = pred._exe.arg_dict[name].shape
    arr = np.frombuffer(bytearray(data_bytes), dtype=np.float32).reshape(shape)
    pred.set_input(name, arr)
