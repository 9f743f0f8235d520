"""DataParallelExecutorGroup of the port (counterpart of
``mxnet_tpu/module/executor_group.py``; reference:
python/mxnet/module/executor_group.py).

One context only in this slice: the group binds one executor, copies
each batch into its bound data and label arrays (host to device), and
exposes its parameter, gradient and output arrays to the module. A list
of several contexts raises; data parallelism over several cards waits
for ``ROADMAP.md`` A6.
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


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad, shared_group=None,
                 logger=logging, fixed_param_names=None, grad_req="write",
                 state_names=None, compute_dtype=None):
        if len(contexts) != 1:
            raise MXNetError("the port binds one context per module; %d "
                             "contexts need data parallelism (ROADMAP.md A6)"
                             % len(contexts))
        if shared_group is not None:
            raise MXNetError("shared executor groups (bucketing) are not "
                             "ported yet (ROADMAP.md A1)")
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

    def bind_exec(self, data_shapes, label_shapes):
        """Bind the executor at these batch shapes."""
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
        args, grads = [], []
        for name, shape in zip(self.arg_names, arg_shapes):
            args.append(nd.zeros(shape, ctx=ctx, dtype=np.float32))
            grads.append(nd.zeros(shape, ctx=ctx, dtype=np.float32)
                         if self.grad_req.get(name, "null") != "null" else None)
        auxs = [nd.zeros(s, ctx=ctx) for s in aux_shapes]
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
