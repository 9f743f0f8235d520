"""Pre-Module data-parallel training helper (counterpart of
``mxnet_tpu/executor_manager.py``; reference:
python/mxnet/executor_manager.py — ``_split_input_slice`` :14 and
``DataParallelExecutorManager`` :303, the machinery ``FeedForward`` used
before the Module API existed).

The manager is an adapter over the :class:`~.module.executor_group.
DataParallelExecutorGroup` the Module layer uses, so the pre-Module
workflow (bind per context, scatter batches, ``forward``/``backward``,
read ``param_arrays``/``grad_arrays``, apply an updater) drives the same
executors. ``FeedForward`` with a context list goes through ``Module``,
as in the JAX package.
"""
from __future__ import annotations

import logging

from .base import MXNetError
from .module.executor_group import DataParallelExecutorGroup, _split_input_slice

__all__ = ["DataParallelExecutorManager", "_split_input_slice"]


class DataParallelExecutorManager:
    """Data-parallel training on explicit contexts (reference:
    executor_manager.py:303, same surface). ``sym_gen`` bucketing is the
    ``BucketingModule``'s job and is refused."""

    def __init__(self, symbol, ctx, train_data, arg_names=None,
                 param_names=None, aux_names=None, work_load_list=None,
                 logger=None, sym_gen=None):
        if sym_gen is not None:
            raise MXNetError(
                "sym_gen bucketing lives in BucketingModule now; "
                "DataParallelExecutorManager handles a single symbol")
        self.logger = logger or logging
        num_device = len(ctx)
        self.logger.info("Start training with %s", str(ctx))
        if work_load_list is None:
            work_load_list = [1] * num_device
        if len(work_load_list) != num_device:
            raise MXNetError("Invalid settings for work load.")

        self.symbol = symbol
        self._batch = None
        self.ctx = ctx
        self.arg_names = arg_names or symbol.list_arguments()
        self.aux_names = aux_names or symbol.list_auxiliary_states()
        input_names = [d.name for d in train_data.provide_data] + [
            l.name for l in (train_data.provide_label or [])]
        self.param_names = param_names or [
            n for n in self.arg_names if n not in input_names]
        self.slices = _split_input_slice(train_data.batch_size, work_load_list)
        self.execgrp = DataParallelExecutorGroup(
            symbol, ctx, work_load_list,
            data_shapes=train_data.provide_data,
            label_shapes=train_data.provide_label,
            param_names=self.param_names,
            for_training=True, inputs_need_grad=False,
            logger=self.logger)

    def install_monitor(self, monitor):
        """Install a monitor on every executor."""
        self.execgrp.install_monitor(monitor)

    def set_params(self, arg_params, aux_params):
        """Load parameter and aux dicts into every executor."""
        self.execgrp.set_params(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        """The parameters (averaged over the contexts) into the given
        dicts."""
        self.execgrp.get_params(arg_params, aux_params)

    @property
    def param_arrays(self):
        """Per parameter, the list of per-context weight arrays."""
        return self.execgrp.param_arrays

    @property
    def grad_arrays(self):
        """Per parameter, the list of per-context gradient arrays."""
        return self.execgrp.grad_arrays

    @property
    def aux_arrays(self):
        """Per auxiliary state, the list of per-context arrays."""
        return self.execgrp.aux_arrays

    def load_data_batch(self, data_batch):
        """Stage a batch; its slices go to the contexts on ``forward``
        (a uint8-wire batch is decoded here, once)."""
        from . import io as io_mod

        self._batch = io_mod.apply_wire(
            data_batch, ctx=io_mod.wire_decode_ctx(self.ctx))

    def forward(self, is_train=False):
        if self._batch is None:
            raise MXNetError("call load_data_batch(batch) before forward()")
        self.execgrp.forward(self._batch, is_train=is_train)

    def backward(self):
        self.execgrp.backward()

    def update_metric(self, metric, labels):
        self.execgrp.update_metric(metric, labels)
