"""The fused training step on one device (counterpart of
``mxnet_tpu/parallel/spmd.py``).

The JAX package jits forward, backward and the optimizer update into one
program per step. The port runs the same step — cast to
``compute_dtype``, the graph's forward, the loss outputs seeded with ones
and the others with zeros, the backward, the rule of each parameter —
and on a CUDA device captures it once per trainer (one trainer per bound
input shape) as a ``torch.cuda.CUDAGraph``, then replays it: one launch
of the whole step from the host instead of one per kernel.

Capture follows the rules CUDA graphs impose:

* the first step runs eagerly on a side stream (the warm-up: it loads the
  kernels' libraries, opts their shared memory in and lets cuBLAS and
  cuDNN make their handles), and it is a real training step;
* every tensor the graph reads or writes is static: the parameters, the
  auxiliary states and the optimizer slots are updated in place, the
  batch is copied into input buffers (:meth:`SPMDTrainer.input_buffers`;
  for a uint8 wire batch, :meth:`SPMDTrainer.set_wire`, the data buffers
  hold the uint8 NHWC batch and the step's first ops are the wire's
  cast, normalize and transpose, captured with the rest)
  and the step's learning rate (the lr scheduler's at this step, with
  Adam's bias correction at this step's ``t``) is a device scalar
  written before each replay (:attr:`SPMDTrainer.step_lr` is its host
  value);
* nothing in the step waits for the host, and the outputs are the
  graph's own tensors, read after the replay;
* a graph with an op that draws random numbers (``Dropout``, the
  ``RNN`` op's dropout, ...) registers the device's :mod:`..random`
  generator with the graph before capturing
  (``CUDAGraph.register_generator_state``): each replay then draws fresh
  numbers from the generator's current state, the numbers an eager step
  from that state would draw, and advances it. A torch without that call
  raises (:class:`MXNetError`); nothing falls back to another generator.

The capture is thread-local (``capture_error_mode="thread_local"``): the
input pipeline's threads (an nvJPEG decode, a pinned upload) may call
the CUDA runtime while the step is captured on this thread.

Nothing falls back: a failed capture or replay raises. A kernel's launch
count (``ops._build.Kernel.launches``) goes up by its launches in the
captured step on every replay, and the capture itself counts none.
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import MXNetError, torch_dtype
from ..executor import build_graph_fn, cast_compute, index_like_inputs
from ..ops.registry import get_op
from ..symbol import _topo_order
from . import fused_opt

__all__ = ["SPMDTrainer"]


class SPMDTrainer:
    """Forward, backward and update of ``symbol`` at fixed input shapes on
    one ``device``, with float32 master parameters."""

    def __init__(self, symbol, device, data_shapes, optimizer,
                 label_shapes=None, compute_dtype=None):
        self.device = torch.device(device)
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self._graph_fn = build_graph_fn(symbol)
        self.data_names = [n for n, _ in data_shapes]
        self.label_names = [n for n, _ in (label_shapes or [])]
        inputs = set(self.data_names + self.label_names)
        self.param_names = [n for n in self.arg_names if n not in inputs]
        shapes = dict(data_shapes)
        shapes.update(dict(label_shapes or []))
        self.input_shapes = {n: tuple(s) for n, s in shapes.items()}
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        if arg_shapes is None:
            raise MXNetError("fused step: shape inference failed")
        self.arg_shapes = dict(zip(self.arg_names, arg_shapes))
        self.aux_shapes = dict(zip(self.aux_names, aux_shapes))
        self.optimizer = optimizer
        # raises ValueError for an optimizer without a fused rule
        self.rule = fused_opt.make_rule(optimizer)
        self.lr_mult, self.wd_mult = fused_opt.mults_for(optimizer,
                                                         self.param_names)
        self.compute_dtype = (None if compute_dtype is None
                              else torch_dtype(compute_dtype))
        self._cast_exempt = (frozenset(self.label_names)
                             | index_like_inputs(symbol))
        self._loss_flags = [not node.is_variable and get_op(node.op).is_loss
                            for node, _ in symbol._entries]
        self._stochastic = any(
            not node.is_variable and get_op(node.op).stochastic(node.attrs)
            for node in _topo_order(symbol._entries))
        # the step's learning rate: written before each step, read by the
        # graph
        self._lr = torch.zeros((), dtype=torch.float32, device=self.device)
        #: the value last written into it
        self.step_lr = None
        self._inputs = None
        #: the io.WireSpec of the data inputs (None: float32 inputs)
        self.wire = None
        self._graph = None
        self._graph_outs = None
        self._per_replay = {}
        self.warm = False
        #: CUDA graphs captured by this trainer (at most one) and replays
        self.captures = 0
        self.replays = 0

    # ---- state ---------------------------------------------------------
    def init_opt_state(self):
        """Fresh optimizer slots: name -> tuple of float32 tensors."""
        return {n: self.rule.init_state(self.arg_shapes[n], self.device)
                for n in self.param_names}

    @property
    def started(self):
        """Whether the input buffers exist (their format is then fixed)."""
        return self._inputs is not None

    def set_wire(self, wire):
        """Take the data inputs in ``wire``'s format (an io.WireSpec:
        uint8 NHWC, decoded as the step's first ops), or float32 for
        None. Only before the input buffers exist."""
        if self.started and wire != self.wire:
            raise MXNetError("fused step: the input format is fixed once "
                             "its buffers exist")
        self.wire = wire

    def input_buffers(self):
        """The static input tensors the step reads (name -> tensor), made
        once; a batch is copied into them before each step."""
        if self._inputs is None:
            self._inputs = {}
            for n, s in self.input_shapes.items():
                if self.wire is not None and n in self.data_names:
                    self._inputs[n] = torch.zeros(self.wire.wire_shape(s),
                                                  dtype=torch.uint8,
                                                  device=self.device)
                else:
                    self._inputs[n] = torch.zeros(s, dtype=torch.float32,
                                                  device=self.device)
        return self._inputs

    def _decoded(self, inputs):
        """The step's inputs with the wire's data decoded."""
        if self.wire is None:
            return inputs
        return {n: self.wire.decode_tensor(t) if n in self.data_names else t
                for n, t in inputs.items()}

    # ---- the step --------------------------------------------------------
    def _run(self, params, auxs, states, inputs, train=True):
        """The step's work, eagerly: returns the forward's outputs (of the
        parameters before the update). With ``train`` the auxiliary
        states, parameters and slots are updated in place."""
        names = self.arg_names
        inputs = self._decoded(inputs)
        if not train:
            with torch.no_grad():
                args = [params[n] if n in params else inputs[n] for n in names]
                outs, _ = self._graph_fn(
                    cast_compute(names, args, self.compute_dtype,
                                 self._cast_exempt),
                    [auxs[n] for n in self.aux_names], False)
            return outs
        leaves = {n: params[n].detach().requires_grad_(True)
                  for n in self.param_names}
        args = [leaves[n] if n in leaves else inputs[n] for n in names]
        with torch.enable_grad():
            outs, new_aux = self._graph_fn(
                cast_compute(names, args, self.compute_dtype,
                             self._cast_exempt),
                [auxs[n] for n in self.aux_names], True)
        pairs = [(o, torch.full_like(o, 1.0 if loss else 0.0))
                 for o, loss in zip(outs, self._loss_flags) if o.requires_grad]
        order = list(leaves)
        grads = [None] * len(order)
        if pairs:
            grads = torch.autograd.grad([o for o, _ in pairs],
                                        [leaves[n] for n in order],
                                        [g for _, g in pairs],
                                        allow_unused=True)
        base_wd = self.optimizer.wd
        with torch.no_grad():
            for n, new in zip(self.aux_names, new_aux):
                auxs[n].copy_(new)
            for n, g in zip(order, grads):
                w = params[n]
                g = torch.zeros_like(w) if g is None else g.to(w.dtype)
                self.rule.apply_(w, g, states[n], self._lr * self.lr_mult[n],
                                 base_wd * self.wd_mult[n])
        return [o.detach() for o in outs]

    def step(self, params, auxs, states):
        """One training step over the batch in :meth:`input_buffers`:
        returns its outputs. On a CUDA device the first call runs eagerly
        on a side stream, the second captures the step as a CUDA graph,
        and that call and every later one replay it."""
        lr, t = fused_opt.host_step_values(self.optimizer, self.param_names)
        self.step_lr = self.rule.step_lr(lr, t)
        self._lr.fill_(self.step_lr)
        inputs = self.input_buffers()
        if self.device.type != "cuda":
            return self._run(params, auxs, states, inputs)
        if self._graph is None:
            if not self.warm:
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    outs = self._run(params, auxs, states, inputs)
                torch.cuda.current_stream(self.device).wait_stream(side)
                self.warm = True
                return outs
            self._capture(params, auxs, states, inputs)
        self._graph.replay()
        self.replays += 1
        from ..ops import _build

        for name, n in self._per_replay.items():
            _build.KERNELS[name].launches += n
        return self._graph_outs

    def _capture(self, params, auxs, states, inputs):
        """Record one step into a CUDA graph (nothing runs); the launches
        its kernel wrappers count while recording become the count each
        replay adds, and are taken back from the counters."""
        from ..ops import _build

        graph = torch.cuda.CUDAGraph()
        if self._stochastic:
            if not hasattr(graph, "register_generator_state"):
                raise MXNetError(
                    "fused step: the graph draws random numbers and torch "
                    "%s cannot register a generator with a CUDA graph; "
                    "train it with MXNET_MODULE_NO_FUSED=1" % torch.__version__)
            graph.register_generator_state(_random.generator(self.device))
        before = {n: k.launches for n, k in _build.KERNELS.items()}
        torch.cuda.synchronize(self.device)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            outs = self._run(params, auxs, states, inputs)
        for n, k in _build.KERNELS.items():
            if k.launches != before[n]:
                self._per_replay[n] = k.launches - before[n]
                k.launches = before[n]
        self._graph = graph
        self._graph_outs = outs
        self.captures += 1

    def forward(self, params, auxs, inputs):
        """An inference forward (no graph, no update): the outputs."""
        return self._run(params, auxs, None, inputs, train=False)
