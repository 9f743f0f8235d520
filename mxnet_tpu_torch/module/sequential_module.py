"""SequentialModule of the port (counterpart of
``mxnet_tpu/module/sequential_module.py``; reference:
python/mxnet/module/sequential_module.py): a chain of modules acting as
one. ``add(module, take_labels=..., auto_wiring=...)``; forward threads
each stage's outputs into the next stage's data, backward threads the
input gradients the other way. Interior stages bind with
``inputs_need_grad``, so they train on the classic path; a first stage
without a loss output does too (``Module._fused_veto``).
"""
from __future__ import annotations

import logging
from collections import Counter
from dataclasses import dataclass

from ..io import DataBatch
from .base_module import BaseModule

__all__ = ["SequentialModule"]


@dataclass
class _Stage:
    module: BaseModule
    take_labels: bool = False  # feed fit's labels to this stage (loss layers)
    auto_wiring: bool = False  # rename incoming data to this stage's data_names


class SequentialModule(BaseModule):
    # kwarg names accepted by add(); kept as class attrs for API parity
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._stages: list[_Stage] = []
        self._data_shapes = None
        self._label_shapes = None

    def add(self, module, **kwargs):
        """Append a stage. Returns self so adds chain."""
        unknown = set(kwargs) - {self.META_TAKE_LABELS, self.META_AUTO_WIRING}
        if unknown:
            raise ValueError("Unknown meta %s, a typo?" % sorted(unknown))
        self._stages.append(
            _Stage(
                module,
                take_labels=bool(kwargs.get(self.META_TAKE_LABELS, False)),
                auto_wiring=bool(kwargs.get(self.META_AUTO_WIRING, False)),
            )
        )
        # a structural change invalidates everything downstream
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    # ---- shape/name views: first stage fronts, last stage exits ----------
    @property
    def data_names(self):
        return self._stages[0].module.data_names if self._stages else []

    @property
    def output_names(self):
        return self._stages[-1].module.output_names if self._stages else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._stages[0].module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._stages[-1].module.output_shapes

    # ---- params ----------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        args, auxs = {}, {}
        for stage in self._stages:
            a, x = stage.module.get_params()
            args.update(a)
            auxs.update(x)
        return args, auxs

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        for stage in self._stages:
            stage.module.init_params(
                initializer=initializer, arg_params=arg_params,
                aux_params=aux_params, allow_missing=allow_missing,
                force_init=force_init,
            )
        self._assert_unique_param_names()
        self.params_initialized = True

    def _assert_unique_param_names(self):
        for kind in range(2):  # 0: args, 1: auxs
            counts = Counter()
            for stage in self._stages:
                counts.update(stage.module.get_params()[kind].keys())
            dups = [n for n, c in counts.items() if c > 1]
            if dups:
                raise ValueError(
                    "parameter names repeat across stages: %s — prefix each "
                    "stage's symbols to disambiguate" % sorted(dups)
                )

    # ---- bind: thread shapes through the chain ---------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if inputs_need_grad:
            assert for_training
        assert shared_module is None, "Shared module is not supported"
        assert self._stages, "Attempting to bind an empty SequentialModule"
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

        shapes = list(data_shapes)
        labels_used = False
        for i, stage in enumerate(self._stages):
            if stage.auto_wiring:
                names = stage.module.data_names
                assert len(names) == len(shapes)
                shapes = [
                    (name, s.shape if hasattr(s, "shape") else s[1])
                    for name, s in zip(names, shapes)
                ]
            labels_used |= stage.take_labels
            stage.module.bind(
                data_shapes=shapes,
                label_shapes=label_shapes if stage.take_labels else None,
                for_training=for_training,
                # interior stages always need input grads to continue the chain
                inputs_need_grad=inputs_need_grad or (for_training and i > 0),
                force_rebind=force_rebind, shared_module=None, grad_req=grad_req,
            )
            shapes = stage.module.output_shapes
        self._data_shapes = list(data_shapes)
        self._label_shapes = label_shapes if labels_used else None

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for stage in self._stages:
            stage.module.init_optimizer(
                kvstore=kvstore, optimizer=optimizer,
                optimizer_params=optimizer_params, force_init=force_init,
            )
        self.optimizer_initialized = True

    # ---- compute: outputs flow down, grads flow back up ------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        batch = data_batch
        for i, stage in enumerate(self._stages):
            stage.module.forward(batch, is_train=is_train)
            if i + 1 == len(self._stages):
                return
            outputs = stage.module.get_outputs()
            names = [
                s[0] if isinstance(s, tuple) else s.name
                for s in stage.module.output_shapes
            ]
            batch = DataBatch(
                data=outputs,
                label=data_batch.label,
                pad=getattr(data_batch, "pad", None),
                index=getattr(data_batch, "index", None),
                provide_data=[(n, o.shape) for n, o in zip(names, outputs)],
                provide_label=getattr(data_batch, "provide_label", None),
            )

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i in range(len(self._stages) - 1, -1, -1):
            self._stages[i].module.backward(out_grads=out_grads)
            if i:
                out_grads = self._stages[i].module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized and self.optimizer_initialized
        for stage in self._stages:
            stage.module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._stages[-1].module.get_outputs(
            merge_multi_context=merge_multi_context
        )

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and self.inputs_need_grad
        return self._stages[0].module.get_input_grads(
            merge_multi_context=merge_multi_context
        )

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        for stage in self._stages:
            if stage.take_labels:
                stage.module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        for stage in self._stages:
            stage.module.install_monitor(mon)
