"""DataParallelExecutorGroup of the port (counterpart of
``mxnet_tpu/module/executor_group.py``; reference:
python/mxnet/module/executor_group.py).

One context only in this slice: the group binds one executor, copies
each batch into its bound data and label arrays (host to device), and
exposes its parameter, gradient and output arrays to the module. A list
of several contexts raises; data parallelism over several cards waits
for ``ROADMAP.md`` A6.

``shared_group`` (a bucket of a ``BucketingModule``): the executor binds
the lender's parameter, gradient and auxiliary NDArrays themselves, not
copies, so an update through either group is seen by both. ``reshape``
rebinds at new batch shapes over the same arrays.
"""
from __future__ import annotations

import logging

import numpy as np

from .. import ndarray as nd
from ..base import MXNetError
from ..io import DataDesc

__all__ = ["DataParallelExecutorGroup"]


def _descs(shapes):
    return [x if isinstance(x, DataDesc) else DataDesc(*x) for x in shapes]


def _check_shared(name, arr, shape):
    if tuple(arr.shape) != tuple(shape):
        raise MXNetError("%s: shape %s here, %s in the executor it shares "
                         "arrays with" % (name, tuple(shape), tuple(arr.shape)))


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad, shared_group=None,
                 logger=logging, fixed_param_names=None, grad_req="write",
                 state_names=None, compute_dtype=None):
        if len(contexts) != 1:
            raise MXNetError("the port binds one context per module; %d "
                             "contexts need data parallelism (ROADMAP.md A6)"
                             % len(contexts))
        self.shared_group = shared_group
        self.compute_dtype = compute_dtype
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = contexts
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.logger = logger
        self.fixed_param_names = fixed_param_names or []
        self.state_names = state_names or []

        if not for_training:
            grad_req = "null"
        data_names = [x.name if isinstance(x, DataDesc) else x[0] for x in data_shapes]
        if isinstance(grad_req, str):
            self.grad_req = {}
            for k in self.arg_names:
                if k in self.param_names:
                    self.grad_req[k] = "null" if k in self.fixed_param_names else grad_req
                elif k in data_names:
                    self.grad_req[k] = grad_req if inputs_need_grad else "null"
                else:
                    self.grad_req[k] = "null"
        elif isinstance(grad_req, (list, tuple)):
            self.grad_req = dict(zip(self.arg_names, grad_req))
        elif isinstance(grad_req, dict):
            self.grad_req = {k: "null" for k in self.arg_names}
            self.grad_req.update(grad_req)
        else:
            raise ValueError("invalid grad_req")
        self.bind_exec(data_shapes, label_shapes)

    def bind_exec(self, data_shapes, label_shapes, shared_exec=None):
        """Bind the executor at these batch shapes, over the parameter,
        gradient and auxiliary arrays of ``shared_exec`` (else the shared
        group's executor) where it has them."""
        self.data_shapes = _descs(data_shapes)
        self.label_shapes = _descs(label_shapes) if label_shapes is not None else None
        descs = self.data_shapes + (self.label_shapes or [])
        sizes = {d.shape[DataDesc.get_batch_axis(getattr(d, "layout", "NCHW"))]
                 for d in descs if DataDesc.get_batch_axis(getattr(d, "layout", "NCHW")) >= 0}
        if len(sizes) != 1:
            raise MXNetError("all data and labels must share one batch size, "
                             "got %s" % sorted(sizes))
        self.batch_size = sizes.pop()
        ctx = self.contexts[0]
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(
            **{d.name: d.shape for d in descs})
        if arg_shapes is None:
            raise MXNetError("shape inference failed")
        if shared_exec is None and self.shared_group is not None:
            shared_exec = self.shared_group.execs[0]
        shared_args = shared_exec.arg_dict if shared_exec is not None else {}
        shared_grads = shared_exec.grad_dict if shared_exec is not None else {}
        shared_auxs = shared_exec.aux_dict if shared_exec is not None else {}
        args, grads = [], []
        for name, shape in zip(self.arg_names, arg_shapes):
            if name in self.param_names and name in shared_args:
                _check_shared(name, shared_args[name], shape)
                args.append(shared_args[name])
                grads.append(shared_grads.get(name))
                continue
            args.append(nd.zeros(shape, ctx=ctx, dtype=np.float32))
            grads.append(nd.zeros(shape, ctx=ctx, dtype=np.float32)
                         if self.grad_req.get(name, "null") != "null" else None)
        auxs = []
        for name, shape in zip(self.aux_names, aux_shapes):
            if name in shared_auxs:
                _check_shared(name, shared_auxs[name], shape)
                auxs.append(shared_auxs[name])
            else:
                auxs.append(nd.zeros(shape, ctx=ctx))
        exe = self.symbol.bind(ctx, args, args_grad=grads,
                               grad_req=self.grad_req, aux_states=auxs,
                               compute_dtype=self.compute_dtype,
                               cast_exempt=[d.name for d in
                                            self.label_shapes or []])
        self.execs = [exe]
        arg = exe.arg_dict
        self.data_arrays = [arg[d.name] for d in self.data_shapes]
        self.label_arrays = ([arg[d.name] for d in self.label_shapes]
                             if self.label_shapes is not None else None)
        self.param_arrays = [[exe.arg_arrays[i]] for i, name in enumerate(self.arg_names)
                             if name in self.param_names]
        self.grad_arrays = ([[exe.grad_arrays[i]] for i, name in enumerate(self.arg_names)
                             if name in self.param_names]
                            if self.for_training else None)
        self.input_grad_arrays = ([[exe.grad_dict[d.name]] for d in self.data_shapes]
                                  if self.inputs_need_grad else None)
        self.aux_arrays = [[a] for a in exe.aux_arrays]

    def reshape(self, data_shapes, label_shapes):
        """Rebind at new batch shapes over the same parameter, gradient and
        auxiliary arrays."""
        data_shapes = _descs(data_shapes)
        label_shapes = _descs(label_shapes) if label_shapes is not None else None
        if data_shapes == self.data_shapes and label_shapes == self.label_shapes:
            return
        self.bind_exec(data_shapes, label_shapes, shared_exec=self.execs[0])

    def set_params(self, arg_params, aux_params):
        self.execs[0].copy_params_from(arg_params, aux_params)

    def get_params(self, arg_params, aux_params):
        """Copy the bound parameters into the given dicts of NDArrays."""
        for name, block in zip(self.param_names, self.param_arrays):
            arg_params[name][:] = block[0]
        for name, block in zip(self.aux_names, self.aux_arrays):
            aux_params[name][:] = block[0]

    def forward(self, data_batch, is_train=None):
        """Copy the batch into the bound arrays and run the forward."""
        for src, dst in zip(data_batch.data, self.data_arrays):
            dst[:] = src
        if is_train is None:
            is_train = self.for_training
        if self.label_arrays is not None and data_batch.label:
            for src, dst in zip(data_batch.label, self.label_arrays):
                dst[:] = src
        self.execs[0].forward(is_train=is_train)

    def get_output_shapes(self):
        descs = self.data_shapes + (self.label_shapes or [])
        _, out_shapes, _ = self.symbol.infer_shape(**{d.name: d.shape for d in descs})
        return list(zip(self.symbol.list_outputs(), out_shapes))

    def get_outputs(self, merge_multi_context=True):
        outputs = self.execs[0].outputs
        return outputs if merge_multi_context else [[o] for o in outputs]

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        if merge_multi_context:
            return [g[0] for g in self.input_grad_arrays]
        return self.input_grad_arrays

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True first")
        self.execs[0].backward(out_grads=out_grads)

    def update_metric(self, eval_metric, labels):
        """Feed the outputs of the last forward (not a new one)."""
        eval_metric.update(labels, self.execs[0].outputs)
