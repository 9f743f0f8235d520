"""DataParallelExecutorGroup of the port (counterpart of
``mxnet_tpu/module/executor_group.py``; reference:
python/mxnet/module/executor_group.py — decide_slices :227-242,
bind_exec :244-319, scatter-forward :369, backward :501, metric :530).

The group binds one executor per context, each on its slice of the
batch (:func:`_split_input_slice` by the workload list), copies each
slice into its executor's data and label arrays, and merges the outputs
and input gradients along the batch axis. Gradients are reduced above
the group (the kvstore's ``Comm`` in ``Module.update``), as in the
reference. Two contexts may name one device (``cpu(0)`` and ``cpu(1)``,
or two ``tpu(0)`` on one card): each still binds its own executor and
arrays.

``shared_group`` (a bucket of a ``BucketingModule``): each executor binds
the lender's executor's parameter, gradient and auxiliary NDArrays
themselves, not copies, so an update through either group is seen by
both. ``reshape`` rebinds at new batch shapes over the same arrays.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .. import ndarray as nd
from ..base import MXNetError
from ..io import DataDesc

__all__ = ["DataParallelExecutorGroup", "_split_input_slice"]


def _split_input_slice(batch_size, work_load_list):
    """Slice a batch by workload (reference: executor_manager.py:14)."""
    total_work_load = sum(work_load_list)
    batch_num_list = [round(w * batch_size / total_work_load)
                      for w in work_load_list]
    batch_num_sum = sum(batch_num_list)
    if batch_num_sum < batch_size:
        batch_num_list[-1] += batch_size - batch_num_sum
    slices = []
    end = 0
    for batch_num in batch_num_list:
        begin = int(min(end, batch_size))
        end = int(min(begin + batch_num, batch_size))
        if begin >= end:
            raise ValueError("Too many slices. Some splits are empty.")
        slices.append(slice(begin, end))
    return slices


def _descs(shapes):
    return [x if isinstance(x, DataDesc) else DataDesc(*x) for x in shapes]


def _batch_axis(d):
    return DataDesc.get_batch_axis(getattr(d, "layout", "NCHW"))


def _check_shared(name, arr, shape):
    if tuple(arr.shape) != tuple(shape):
        raise MXNetError("%s: shape %s here, %s in the executor it shares "
                         "arrays with" % (name, tuple(shape), tuple(arr.shape)))


def _take(src, sl, axis):
    """Slice ``sl`` of a batch array along ``axis`` (a view for NDArrays
    and numpy arrays)."""
    if axis < 0:
        return src
    if not isinstance(src, (nd.NDArray, np.ndarray, torch.Tensor)):
        src = np.asarray(src)
    if sl.start == 0 and sl.stop == src.shape[axis]:
        return src
    idx = (slice(None),) * axis + (sl,)
    return src[idx]


def _merge(tensors, axis):
    """Per-executor outputs joined along the batch axis on the first
    executor's device."""
    if len(tensors) == 1 or axis < 0 or tensors[0].ndim == 0:
        return tensors[0]
    dev = tensors[0].context
    return nd.NDArray(torch.cat([t.data.to(dev) for t in tensors], dim=axis))


# thread-confined: an executor group is driven by its Module's thread; the feed thread's `slot.stage(...)` is _PinnedSlot.stage, which the
# analyzer's method-name match also ties to FusedFitPath.stage
class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad, shared_group=None,
                 logger=logging, fixed_param_names=None, grad_req="write",
                 state_names=None, compute_dtype=None):
        self.shared_group = shared_group
        self.compute_dtype = compute_dtype
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.symbol = symbol
        self.contexts = list(contexts)
        self.workload = list(workload) if workload else [1] * len(self.contexts)
        if len(self.workload) != len(self.contexts):
            raise MXNetError("one workload per context")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.logger = logger
        self.fixed_param_names = fixed_param_names or []
        self.state_names = state_names or []
        self._monitors = []

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

    def decide_slices(self, descs):
        """The batch size shared by ``descs`` (those with a batch axis) and
        the per-context slices of it."""
        sizes = {d.shape[_batch_axis(d)] for d in descs if _batch_axis(d) >= 0}
        if len(sizes) != 1:
            raise MXNetError("all data and labels must share one batch size, "
                             "got %s" % sorted(sizes))
        self.batch_size = sizes.pop()
        self.slices = _split_input_slice(self.batch_size, self.workload)

    def _sliced(self, descs, i):
        out = []
        for d in descs:
            shape = list(d.shape)
            axis = _batch_axis(d)
            if axis >= 0:
                shape[axis] = self.slices[i].stop - self.slices[i].start
            out.append(DataDesc(d.name, tuple(shape)))
        return out

    def bind_exec(self, data_shapes, label_shapes, shared_execs=None):
        """Bind one executor per context at these batch shapes, over the
        parameter, gradient and auxiliary arrays of ``shared_execs`` (else
        the shared group's executors) where they have them."""
        self.data_shapes = _descs(data_shapes)
        self.label_shapes = _descs(label_shapes) if label_shapes is not None else None
        descs = self.data_shapes + (self.label_shapes or [])
        self.decide_slices(descs)
        if shared_execs is None and self.shared_group is not None:
            shared_execs = self.shared_group.execs
        old_execs = getattr(self, "execs", [])
        self.execs = [self._bind_ith_exec(i, descs, None if shared_execs is None
                                          else shared_execs[i])
                      for i in range(len(self.contexts))]
        self.data_layouts = [_batch_axis(d) for d in self.data_shapes]
        self.label_layouts = [_batch_axis(d) for d in self.label_shapes or []]
        self.output_layouts = [0] * len(self.symbol.list_outputs())
        execs = self.execs
        self.data_arrays = [[e.arg_dict[d.name] for e in execs]
                            for d in self.data_shapes]
        self.label_arrays = ([[e.arg_dict[d.name] for e in execs]
                              for d in self.label_shapes]
                             if self.label_shapes is not None else None)
        self.param_arrays = [[e.arg_arrays[i] for e in execs]
                             for i, name in enumerate(self.arg_names)
                             if name in self.param_names]
        self.grad_arrays = ([[e.grad_arrays[i] for e in execs]
                             for i, name in enumerate(self.arg_names)
                             if name in self.param_names]
                            if self.for_training else None)
        self.input_grad_arrays = ([[e.grad_dict[d.name] for e in execs]
                                   for d in self.data_shapes]
                                  if self.inputs_need_grad else None)
        self.aux_arrays = [[e.aux_arrays[i] for e in execs]
                           for i in range(len(self.aux_names))]
        for mon in self._monitors:
            # a rebind (reshape) moves the monitor onto the new executors
            mon.exes = [e for e in mon.exes if e not in old_execs]
            for exe in execs:
                mon.install(exe)

    def _bind_ith_exec(self, i, descs, shared_exec):
        ctx = self.contexts[i]
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(
            **{d.name: d.shape for d in self._sliced(descs, i)})
        if arg_shapes is None:
            raise MXNetError("shape inference failed")
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
        return self.symbol.bind(ctx, args, args_grad=grads,
                                grad_req=self.grad_req, aux_states=auxs,
                                compute_dtype=self.compute_dtype,
                                cast_exempt=[d.name for d in
                                             self.label_shapes or []])

    def reshape(self, data_shapes, label_shapes):
        """Rebind at new batch shapes over the same parameter, gradient and
        auxiliary arrays."""
        data_shapes = _descs(data_shapes)
        label_shapes = _descs(label_shapes) if label_shapes is not None else None
        if data_shapes == self.data_shapes and label_shapes == self.label_shapes:
            return
        self.bind_exec(data_shapes, label_shapes, shared_execs=self.execs)

    def set_params(self, arg_params, aux_params):
        for exe in self.execs:
            exe.copy_params_from(arg_params, aux_params)

    def get_params(self, arg_params, aux_params):
        """Copy the bound parameters into the given dicts of NDArrays: with
        several contexts their mean (the reference's 'weight averaged over
        devices')."""
        for names, blocks, dst in ((self.param_names, self.param_arrays, arg_params),
                                   (self.aux_names, self.aux_arrays, aux_params)):
            for name, block in zip(names, blocks):
                if len(block) == 1:
                    dst[name][:] = block[0]
                    continue
                dev = block[0].data.device
                total = block[0].data.clone()
                for w in block[1:]:
                    total += w.data.to(dev)
                dst[name][:] = nd.NDArray(total / len(block))

    def _load(self, sources, targets, layouts):
        for src, dsts, axis in zip(sources, targets, layouts):
            for sl, dst in zip(self.slices, dsts):
                dst[:] = _take(src, sl, axis)

    def forward(self, data_batch, is_train=None):
        """Copy each context's slice of the batch into its arrays and run
        the forwards."""
        self._load(data_batch.data, self.data_arrays, self.data_layouts)
        if is_train is None:
            is_train = self.for_training
        if self.label_arrays is not None and data_batch.label:
            self._load(data_batch.label, self.label_arrays, self.label_layouts)
        for exe in self.execs:
            exe.forward(is_train=is_train)

    def get_output_shapes(self):
        descs = self.data_shapes + (self.label_shapes or [])
        _, out_shapes, _ = self.symbol.infer_shape(**{d.name: d.shape for d in descs})
        return list(zip(self.symbol.list_outputs(), out_shapes))

    def get_outputs(self, merge_multi_context=True):
        per_exec = [e.outputs for e in self.execs]
        outputs = [[outs[i] for outs in per_exec]
                   for i in range(len(per_exec[0]))]
        if merge_multi_context:
            return [_merge(o, axis) for o, axis in zip(outputs, self.output_layouts)]
        return outputs

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        if merge_multi_context:
            return [_merge(g, axis) for g, axis in
                    zip(self.input_grad_arrays, self.data_layouts)]
        return self.input_grad_arrays

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True first")
        if out_grads is None or len(self.execs) == 1:
            for exe in self.execs:
                exe.backward(out_grads=out_grads)
            return
        if isinstance(out_grads, nd.NDArray):
            out_grads = [out_grads]
        for exe, sl, ctx in zip(self.execs, self.slices, self.contexts):
            exe.backward(out_grads=[
                nd.NDArray(_take(g, sl, axis).data.to(torch.device(ctx)))
                if isinstance(g, nd.NDArray) else _take(g, sl, axis)
                for g, axis in zip(out_grads, self.output_layouts)])

    def update_metric(self, eval_metric, labels):
        """Feed each executor's outputs of the last forward (not a new one)
        with its slice of the labels."""
        if len(self.execs) == 1:
            eval_metric.update(labels, self.execs[0].outputs)
            return
        for exe, sl in zip(self.execs, self.slices):
            eval_metric.update([_take(lab, sl, axis) for lab, axis in
                                zip(labels, self.label_layouts)], exe.outputs)

    def install_monitor(self, mon):
        """Install ``mon`` on every executor of the group (and on those a
        later reshape binds)."""
        self._monitors.append(mon)
        for exe in self.execs:
            mon.install(exe)
