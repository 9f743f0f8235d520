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

The step runs (and captures) the graph-pass pipeline's output
(:func:`..graphpass.optimize`), bound by name to the original symbol's
argument and aux-state order.

Each program is a ``compileobs`` program (``fused.step``,
``fused.grad_step``, ``fused.apply_grads``; the graph key is the
optimized graph's digest, the signature the batch inputs then the
parameters):
on the card the capture is its compile and the warm-up and replays its
runs; on the CPU the first run is its compile.

``MXNET_BACKWARD_DO_MIRROR=1`` (read when the trainer is made) runs the
forward under ``executor.mirrored``: backward recomputes it inside the
captured step, so the step's graph holds each forward kernel twice (the
JAX package's ``jax.checkpoint`` over the step's forward). A mirrored
step of a graph that draws random numbers cannot be captured and raises.

**Over a mesh** (A6d). Given a :class:`~.mesh.Mesh` of several
positions, the trainer is the JAX package's data-parallel step: the batch
is cut into contiguous blocks along ``batch_axis`` (as ``P("dp")`` cuts
it; a batch the axis does not divide raises), each position runs forward
and backward on its block through :class:`~.dp.DPGraph` (every op that
reads rows of other positions exchanges what the global batch needs, or
the trainer refuses the graph and names the op), the gradients are
summed over ``batch_axis`` with :func:`~.collectives.psum` (explicit
copies, also between two positions of one card), and every position
applies the same rule to its own replica of the parameters and slots:
the step computes what the one-position step computes on the global
batch. ``param_rules`` (regex -> ``PartitionSpec``, first match wins, as
the JAX package's) store a matched weight and its optimizer slots
sharded: each position holds its block, the step all-gathers the weight
before the forward and keeps its block of the summed gradient. That
shards storage, not compute: each position multiplies by the whole
weight (``ROADMAP.md`` C38). The state is then per position: every value
of ``params``, ``auxs`` and ``states`` is a list with one entry per
position (:meth:`SPMDTrainer.place` makes one from whole tensors,
:meth:`SPMDTrainer.gather` joins it back). On one card the whole step for
every position is one captured CUDA graph; over distinct cards it would
be one graph spanning them (unverified: no machine here has two cards).
A bare device is a one-position mesh, with plain tensors for values.

The distributed step (``module.fused_path``'s ``_step_dist``) splits the
step in two, each its own graph under the same rules:
:meth:`SPMDTrainer.grad_step` (forward and backward, the float32
gradients written into the static :meth:`SPMDTrainer.grad_buffers`) and
:meth:`SPMDTrainer.apply_grads` (the rule of each parameter, reading
those buffers). The parameter-server exchange runs on the host between
them and writes what it pulls into the captured tensors with ``copy_``:
a rebind would leave every replay reading the first step's tensors.
"""
from __future__ import annotations

import gc
import re
import time

import numpy as np
import torch

from .. import compileobs as _compileobs
from .. import graphpass as _graphpass
from .. import random as _random
from ..base import MXNetError, env_flag, torch_dtype
from ..executor import (build_graph_fn, cast_compute, graph_is_stochastic,
                        index_like_inputs, mirrored)
from ..ops.registry import get_op
from . import collectives as C
from . import fused_opt
from .mesh import Mesh, as_torch_device

__all__ = ["SPMDTrainer"]

_SITE = "mxnet_tpu_torch/parallel/spmd.py:SPMDTrainer"


class _Graph:
    """One captured program of a trainer: the CUDA graph, its output
    tensors and the kernel launches each replay adds."""

    __slots__ = ("graph", "outs", "per_replay", "transfers", "warm",
                 "program")

    def __init__(self, program):
        self.graph = None
        self.outs = None
        self.per_replay = {}
        self.transfers = (0, 0)   # cross-position copies (count, bytes)
        self.warm = False
        self.program = program


# thread-confined: a trainer is driven by the thread that steps it; the feed thread's `slot.stage(...)` is _PinnedSlot.stage, which the
# analyzer's method-name match also ties to FusedFitPath.stage
class SPMDTrainer:
    """Forward, backward and update of ``symbol`` at fixed input shapes
    over ``mesh`` (or one device), with float32 master parameters.

    ``optimizer`` is a name (made with ``optimizer_params``, the symbol's
    ``__lr_mult__``/``__wd_mult__`` attributes resolved by parameter
    name) or an ``Optimizer``. ``dtype`` is the masters' (float32 only)
    and ``donate`` must stay True: the step always updates its state in
    place. ``input_dtype`` other than ``dtype`` sets the compute dtype
    when ``compute_dtype`` is not given, as in the JAX package."""

    def __init__(self, symbol, mesh, data_shapes, optimizer="sgd",
                 optimizer_params=None, label_shapes=None, dtype=np.float32,
                 param_rules=None, batch_axis="dp", donate=True,
                 compute_dtype=None, input_dtype=None):
        from .. import optimizer as opt_mod

        if np.dtype(dtype) != np.float32:
            raise MXNetError("fused step: the master parameters are float32, "
                             "not %s" % np.dtype(dtype))
        if not donate:
            raise MXNetError("fused step: donate=False is not supported (the "
                             "step updates its state in place)")
        if not isinstance(mesh, Mesh):
            mesh = Mesh(np.array([as_torch_device(mesh)], dtype=object),
                        [batch_axis])
        self.mesh = mesh
        self.batch_axis = batch_axis
        #: positions along the batch axis (1: the batch is not cut)
        self.dp = mesh.shape.get(batch_axis, 1)
        self.device = mesh.device_list[0]
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        # the graph-pass pipeline's output is what runs and is captured;
        # the public arg/aux order (checkpoints, shapes, the shared
        # state) stays the original symbol's, bound by name
        self._opt_symbol = _graphpass.optimize(symbol)
        self._graph_fn = build_graph_fn(
            self._opt_symbol, arg_names=self.arg_names,
            aux_names=self.aux_names, order_like=symbol)
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
        if isinstance(optimizer, str):
            optimizer = opt_mod.create(
                optimizer, sym=symbol,
                param_idx2name={n: n for n in self.param_names},
                **dict(optimizer_params or {}))
        elif not isinstance(optimizer, opt_mod.Optimizer):
            raise TypeError("optimizer must be a name or an Optimizer instance")
        elif optimizer_params:
            raise ValueError("optimizer_params cannot be combined with a ready "
                             "Optimizer instance; configure the instance "
                             "directly")
        self.optimizer = optimizer
        # raises ValueError for an optimizer without a fused rule
        self.rule = fused_opt.make_rule(optimizer)
        self.lr_mult, self.wd_mult = fused_opt.mults_for(optimizer,
                                                         self.param_names)
        if compute_dtype is None and input_dtype is not None \
                and torch_dtype(input_dtype) != torch.float32:
            compute_dtype = input_dtype
        self.compute_dtype = (None if compute_dtype is None
                              else torch_dtype(compute_dtype))
        self._cast_exempt = (frozenset(self.label_names)
                             | index_like_inputs(symbol))
        self._loss_flags = [not node.is_variable and get_op(node.op).is_loss
                            for node, _ in symbol._entries]
        self._stochastic = graph_is_stochastic(symbol)
        self._mirror = env_flag("MXNET_BACKWARD_DO_MIRROR")
        self._digest = _compileobs.symbol_digest(self._opt_symbol)
        self._sig = None
        self._param_rules = [(re.compile(k), v)
                             for k, v in (param_rules or {}).items()]
        #: parameter -> (dim, mesh axis) it is stored split along, or None
        self.shard_dims = {n: self._shard_dim(n) for n in self.param_names}
        #: the data-parallel graph (None on a one-position mesh)
        self._dp_graph = None
        if mesh.size > 1:
            if batch_axis not in mesh.shape:
                raise MXNetError("fused step: mesh %s has no batch axis %r"
                                 % (mesh, batch_axis))
            from .dp import DPGraph

            self._dp_graph = DPGraph(
                self._opt_symbol, mesh, batch_axis, self.input_shapes,
                set(self.input_shapes), self.arg_names, self.aux_names,
                order_like=symbol)
            self._out_axes = self._dp_graph.output_axes()
        # the step's learning rate: written before each step, read by the
        # graph (one scalar per device of the mesh)
        self._lrs = {d: torch.zeros((), dtype=torch.float32, device=d)
                     for d in dict.fromkeys(mesh.device_list)}
        self._lr = self._lrs[self.device]
        #: the value last written into it
        self.step_lr = None
        self._inputs = None
        self._grad_bufs = None
        #: the io.WireSpec of the data inputs (None: float32 inputs)
        self.wire = None
        # "step", or "grad" and "apply" (the distributed step's two)
        self._graphs = {}
        #: CUDA graphs captured by this trainer (one per program) and
        #: replays of them
        self.captures = 0
        self.replays = 0

    # ---- state ---------------------------------------------------------
    def _shard_dim(self, name):
        """``(dim, axis)`` of the first ``param_rules`` spec that matches
        ``name`` and splits a dimension, or None (replicated)."""
        for prog, spec in self._param_rules:
            if not prog.match(name):
                continue
            spec = tuple(spec) if isinstance(spec, (tuple, list)) else ()
            split = [(d, a) for d, a in enumerate(spec) if a is not None]
            if not split:
                return None
            if len(split) > 1:
                raise MXNetError("param_rules: %s splits %d dimensions; one "
                                 "is supported" % (name, len(split)))
            d, a = split[0]
            if a not in self.mesh.shape:
                raise MXNetError("param_rules: %s names axis %r, not in %s"
                                 % (name, a, self.mesh))
            size = self.arg_shapes[name][d]
            if size % self.mesh.shape[a]:
                raise MXNetError("param_rules: dim %d of %s (%d) does not "
                                 "split over %s=%d" % (d, name, size, a,
                                                       self.mesh.shape[a]))
            return None if self.mesh.shape[a] == 1 else (d, a)
        return None

    def shard_shape(self, name):
        """The shape each position stores of parameter ``name``."""
        shape = list(self.arg_shapes[name])
        sd = self.shard_dims.get(name)
        if sd is not None:
            shape[sd[0]] //= self.mesh.shape[sd[1]]
        return tuple(shape)

    def _block(self, name, full, pos):
        """Position ``pos``'s block of parameter ``name``'s whole value."""
        sd = self.shard_dims.get(name)
        if sd is None:
            return full
        d, a = sd
        size = full.shape[d] // self.mesh.shape[a]
        return full.narrow(d, self.mesh.axis_index(pos, a) * size, size)

    def place(self, values):
        """``{name: whole tensor}`` (parameters or auxiliary states, on any
        device) as this trainer's state: on a one-position mesh the
        float32 tensors on its device, else a list per name with each
        position's own copy (its block, for a parameter ``param_rules``
        split)."""
        out = {}
        for n, v in values.items():
            v = torch.as_tensor(v).detach().to(torch.float32)
            if self.mesh.size == 1:
                out[n] = v.to(self.device, copy=True)
            else:
                out[n] = [C.transfer(self._block(n, v, p).contiguous(), dev)
                          for p, dev in enumerate(self.mesh.device_list)]
        return out

    def gather(self, name, value):
        """The whole tensor of a parameter, auxiliary state or slot in this
        trainer's state (joined from the positions' blocks when
        ``param_rules`` split it), on position 0's device."""
        if not isinstance(value, (list, tuple)):
            return value
        sd = self.shard_dims.get(name)
        if sd is None:
            return value[0]
        d, a = sd
        parts = [value[p] for p in self.mesh.groups(a)[0]]
        return torch.cat([C.to_position(t, self.device) for t in parts],
                         dim=d)

    def init_opt_state(self):
        """Fresh optimizer slots: name -> tuple of float32 tensors (a list
        of one tuple per position over a mesh, each of the position's
        block's shape)."""
        if self.mesh.size == 1:
            return {n: self.rule.init_state(self.arg_shapes[n], self.device)
                    for n in self.param_names}
        return {n: [self.rule.init_state(self.shard_shape(n), dev)
                    for dev in self.mesh.device_list]
                for n in self.param_names}

    @property
    def _per_replay(self):
        """Kernel launches per replay, over the captured programs."""
        out = {}
        for g in self._graphs.values():
            for n, k in g.per_replay.items():
                out[n] = out.get(n, 0) + k
        return out

    def grad_buffers(self, pos=0):
        """The static float32 gradient tensors of :meth:`grad_step` (name
        -> tensor) of position ``pos`` (each holds the gradient summed
        over the batch axis, of the position's block), made once;
        :meth:`apply_grads` reads them."""
        if self._grad_bufs is None:
            self._grad_bufs = [
                {n: torch.zeros(self.shard_shape(n), dtype=torch.float32,
                                device=dev) for n in self.param_names}
                for dev in self.mesh.device_list]
        return self._grad_bufs[pos]

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
    def _forward_backward(self, params, auxs, inputs):
        """Forward and backward of the batch: returns the outputs and
        ``[(name, gradient or None)]`` in ``param_names`` order; the
        auxiliary states are updated in place."""
        if self._dp_graph is not None:
            return self._forward_backward_dp(params, auxs, inputs)
        names = self.arg_names
        leaves = {n: params[n].detach().requires_grad_(True)
                  for n in self.param_names}
        aux_list = [auxs[n] for n in self.aux_names]

        def run(*xs):
            by_name = dict(zip(leaves, xs))
            args = [by_name[n] if n in by_name else inputs[n] for n in names]
            outs, new_aux = self._graph_fn(
                cast_compute(names, args, self.compute_dtype,
                             self._cast_exempt), aux_list, True, self.device)
            return tuple(outs) + tuple(new_aux)

        with torch.enable_grad():
            if self._mirror and leaves:
                res = mirrored(run, list(leaves.values()), self.device,
                               self._stochastic)
            else:
                res = run(*leaves.values())
        n_out = len(self._loss_flags)
        outs, new_aux = list(res[:n_out]), list(res[n_out:])
        pairs = [(o, torch.full_like(o, 1.0 if loss else 0.0))
                 for o, loss in zip(outs, self._loss_flags) if o.requires_grad]
        order = list(leaves)
        grads = [None] * len(order)
        if pairs:
            grads = torch.autograd.grad([o for o, _ in pairs],
                                        [leaves[n] for n in order],
                                        [g for _, g in pairs],
                                        allow_unused=True)
        with torch.no_grad():
            for n, new in zip(self.aux_names, new_aux):
                auxs[n].copy_(new)
        return [o.detach() for o in outs], list(zip(order, grads))

    def _apply_rule(self, params, states, grads):
        """Each parameter's rule over ``[(name, gradient or None)]``, in
        place, at the learning rate in ``self._lr``."""
        if self._dp_graph is not None:
            return self._apply_rule_dp(params, states, grads)
        base_wd = self.optimizer.wd
        with torch.no_grad():
            for n, g in grads:
                w = params[n]
                g = torch.zeros_like(w) if g is None else g.to(w.dtype)
                self.rule.apply_(w, g, states[n], self._lr * self.lr_mult[n],
                                 base_wd * self.wd_mult[n])

    # ---- the step over a mesh --------------------------------------------
    def _positions(self, values):
        """Check a state dict of a several-position mesh: a list per name."""
        for n, v in values.items():
            if not isinstance(v, (list, tuple)) or len(v) != self.mesh.size:
                raise MXNetError(
                    "fused step over %s: %s must be a list with one value per "
                    "position (SPMDTrainer.place makes one)" % (self.mesh, n))
        return values

    def _leaves_dp(self, params):
        """Per position, ``{name: leaf}`` of the whole parameters the
        forward reads: the position's replica, or the weight all-gathered
        from the blocks ``param_rules`` split (detached: its gradient is
        taken whole and the block kept after the exchange)."""
        P = self.mesh.size
        leaves = [{} for _ in range(P)]
        for n in self.param_names:
            vals = [v.detach() for v in params[n]]
            sd = self.shard_dims[n]
            if sd is not None:
                vals = C.all_gather(vals, self.mesh, sd[1], dim=sd[0])
            for p in range(P):
                leaves[p][n] = vals[p].requires_grad_(True)
        return leaves

    def _join(self, outs_pp):
        """The step's outputs over the global batch, on position 0's
        device: each joined along its batch axis from position 0's group,
        or position 0's where it holds no batch."""
        group = (self.mesh.groups(self.batch_axis)[0] if self.dp > 1
                 else [0])
        out = []
        for k, a in enumerate(self._out_axes):
            if a is None:
                out.append(outs_pp[0][k])
            else:
                out.append(torch.cat([C.to_position(outs_pp[q][k], self.device)
                                      for q in group], dim=a))
        return out

    def _blocks(self, inputs):
        """Per position, its block of every batch input (contiguous, along
        axis 0, as ``P(batch_axis)`` cuts it)."""
        spec = C.P(self.batch_axis)
        cut = {n: C.shard(t, self.mesh, spec) for n, t in inputs.items()}
        return [{n: v[p] for n, v in cut.items()}
                for p in range(self.mesh.size)]

    def _run_dp_graph(self, leaves, auxs, blocks, is_train):
        """The data-parallel graph over per-position leaves and blocks."""
        names = self.arg_names
        args_pp = []
        for p, blk in enumerate(blocks):
            args = [leaves[p][n] if n in leaves[p] else blk[n] for n in names]
            args_pp.append(cast_compute(names, args, self.compute_dtype,
                                        self._cast_exempt))
        aux_pp = [[auxs[n][p] for n in self.aux_names]
                  for p in range(self.mesh.size)]
        return self._dp_graph(args_pp, aux_pp, is_train)

    def _forward_backward_dp(self, params, auxs, inputs):
        """:meth:`_forward_backward` over the mesh: returns the joined
        outputs and, per position, ``[(name, gradient)]`` summed over the
        batch axis (the position's block of it under ``param_rules``)."""
        self._positions(params)
        self._positions(auxs)
        mesh, P = self.mesh, self.mesh.size
        leaves = self._leaves_dp(params)
        flat = [leaves[p][n] for p in range(P) for n in self.param_names]
        blocks = self._blocks(inputs)
        n_par, n_out = len(self.param_names), len(self._loss_flags)

        def run(*xs):
            by_pos = [dict(zip(self.param_names, xs[p * n_par:(p + 1) * n_par]))
                      for p in range(P)]
            outs_pp, aux_pp = self._run_dp_graph(by_pos, auxs, blocks, True)
            return tuple(o for row in outs_pp for o in row) + \
                tuple(a for row in aux_pp for a in row)

        with torch.enable_grad():
            if self._mirror and flat:
                res = mirrored(run, flat, self.device, self._stochastic)
            else:
                res = run(*flat)
        outs_pp = [list(res[p * n_out:(p + 1) * n_out]) for p in range(P)]
        n_aux = len(self.aux_names)
        aux_res = res[P * n_out:]
        pairs = [(o, torch.full_like(o, 1.0 if loss else 0.0))
                 for row in outs_pp
                 for o, loss in zip(row, self._loss_flags) if o.requires_grad]
        grads = [None] * len(flat)
        if pairs:
            grads = torch.autograd.grad([o for o, _ in pairs], flat,
                                        [g for _, g in pairs],
                                        allow_unused=True)
        with torch.no_grad():
            for p in range(P):
                for i, n in enumerate(self.aux_names):
                    auxs[n][p].copy_(aux_res[p * n_aux + i])
            by_pos = [[] for _ in range(P)]
            for i, n in enumerate(self.param_names):
                gs = [grads[p * n_par + i] for p in range(P)]
                gs = [torch.zeros_like(leaves[p][n]) if g is None else g
                      for p, g in enumerate(gs)]
                if self.dp > 1:
                    gs = C.psum(gs, mesh, self.batch_axis)
                for p in range(P):
                    by_pos[p].append((n, self._block(n, gs[p], p)))
        return [o.detach() for o in self._join(outs_pp)], by_pos

    def _apply_rule_dp(self, params, states, grads_pp):
        """Each position's rule over its replica (or block) and slots."""
        base_wd = self.optimizer.wd
        with torch.no_grad():
            for p, grads in enumerate(grads_pp):
                lr = self._lrs[self.mesh.device_list[p]]
                for n, g in grads:
                    w = params[n][p]
                    self.rule.apply_(w, g.to(w.dtype), states[n][p],
                                     lr * self.lr_mult[n],
                                     base_wd * self.wd_mult[n])

    def _forward_dp(self, params, auxs, inputs):
        """An inference forward over the mesh: the joined outputs."""
        self._positions(params)
        leaves = self._leaves_dp(params)
        with torch.no_grad():
            outs_pp, _ = self._run_dp_graph(leaves, auxs,
                                            self._blocks(inputs), False)
        return self._join(outs_pp)

    def _run(self, params, auxs, states, inputs, train=True):
        """The step's work, eagerly: returns the forward's outputs (of the
        parameters before the update). With ``train`` the auxiliary
        states, parameters and slots are updated in place."""
        inputs = self._decoded(inputs)
        if not train:
            if self._dp_graph is not None:
                return self._forward_dp(params, auxs, inputs)
            names = self.arg_names
            with torch.no_grad():
                args = [params[n] if n in params else inputs[n] for n in names]
                outs, _ = self._graph_fn(
                    cast_compute(names, args, self.compute_dtype,
                                 self._cast_exempt),
                    [auxs[n] for n in self.aux_names], False)
            return outs
        outs, grads = self._forward_backward(params, auxs, inputs)
        self._apply_rule(params, states, grads)
        return outs

    def _set_lr(self):
        """Write this step's learning rate (the scheduler's, with the
        rule's correction at this step's count) for the graph to read."""
        lr, t = fused_opt.host_step_values(self.optimizer, self.param_names)
        self.step_lr = self.rule.step_lr(lr, t)
        for t_lr in self._lrs.values():
            t_lr.fill_(self.step_lr)

    def step(self, params, auxs, states):
        """One training step over the batch in :meth:`input_buffers`:
        returns its outputs. On a CUDA device the first call runs eagerly
        on a side stream, the second captures the step as a CUDA graph,
        and that call and every later one replay it."""
        self._set_lr()
        inputs = self.input_buffers()
        return self._launch(
            "step", lambda: self._run(params, auxs, states, inputs))

    def grad_step(self, params, auxs):
        """Forward and backward of the batch in :meth:`input_buffers`, the
        gradients written into :meth:`grad_buffers` (float32) and the
        auxiliary states updated: returns the outputs. Its own graph, as
        :meth:`step`'s."""
        inputs = self.input_buffers()
        self.grad_buffers()
        bufs = self._grad_bufs

        def run():
            outs, grads = self._forward_backward(params, auxs,
                                                 self._decoded(inputs))
            per_pos = grads if self._dp_graph is not None else [grads]
            with torch.no_grad():
                for buf, pairs in zip(bufs, per_pos):
                    for n, g in pairs:
                        if g is None:
                            buf[n].zero_()
                        else:
                            buf[n].copy_(g)
            return outs

        return self._launch("grad", run)

    def apply_grads(self, params, states):
        """The optimizer update of every parameter with the gradients in
        :meth:`grad_buffers` (written there by the caller, e.g. summed
        over the workers), the learning rate advanced as by :meth:`step`.
        Its own graph, as :meth:`step`'s."""
        self._set_lr()
        self.grad_buffers()
        pairs = [[(n, buf[n]) for n in self.param_names]
                 for buf in self._grad_bufs]
        self._launch("apply", lambda: self._apply_rule(
            params, states, pairs if self._dp_graph is not None else pairs[0]))

    _PROGRAMS = {"step": "fused.step", "grad": "fused.grad_step",
                 "apply": "fused.apply_grads"}

    def _signature(self):
        """The programs' input signature: the batch inputs, then the
        parameters (fixed per trainer)."""
        if self._sig is None:
            inputs = self.input_buffers()
            self._sig = _compileobs.signature(
                (n, inputs[n]) for n in self.data_names + self.label_names) \
                + tuple((n, "", tuple(self.arg_shapes[n]), "float32")
                        for n in self.param_names)
        return self._sig

    def _slot(self, slot):
        g = self._graphs.get(slot)
        if g is None:
            g = self._graphs[slot] = _Graph(self._PROGRAMS[slot])
        return g

    def _launch(self, slot, fn):
        """``fn()`` (the work of program ``slot``): eagerly off the card
        (the first run charged as its compile); on a CUDA device eagerly on
        a side stream the first time, captured the second, replayed from
        then on."""
        g = self._slot(slot)
        t0 = time.perf_counter()
        wall0 = time.time()
        if self.device.type != "cuda":
            outs = fn()
            if g.warm:
                _compileobs.note_run(g.program, time.perf_counter() - t0)
            else:
                g.warm = True
                _compileobs.note_compile(
                    g.program, time.perf_counter() - t0, self._signature(),
                    graph_key=self._digest, site=_SITE, digest=self._digest,
                    wall0=wall0)
            return outs
        if g.graph is None:
            if not g.warm:
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    outs = fn()
                torch.cuda.current_stream(self.device).wait_stream(side)
                g.warm = True
                _compileobs.note_run(g.program, time.perf_counter() - t0)
                return outs
            self._capture_slot(g, fn, draws=slot != "apply")
            t0 = time.perf_counter()
        g.graph.replay()
        self.replays += 1
        from ..ops import _build

        for name, n in g.per_replay.items():
            _build.KERNELS[name].launches += n
        if g.transfers[0]:
            C.count_transfers(*g.transfers)
        _compileobs.note_run(g.program, time.perf_counter() - t0)
        return g.outs

    def _capture(self, params, auxs, states, inputs):
        """Record one training step into a CUDA graph (nothing runs)."""
        self._capture_slot(self._slot("step"),
                           lambda: self._run(params, auxs, states, inputs))

    def _capture_slot(self, g, fn, draws=True):
        """Record ``fn`` into ``g``'s CUDA graph (nothing runs); the
        launches its kernel wrappers count while recording become the
        count each replay adds, and are taken back from the counters."""
        from ..ops import _build

        graph = torch.cuda.CUDAGraph()
        if draws and self._stochastic:
            if not hasattr(graph, "register_generator_state"):
                raise MXNetError(
                    "fused step: the graph draws random numbers and torch "
                    "%s cannot register a generator with a CUDA graph; "
                    "train it with MXNET_MODULE_NO_FUSED=1" % torch.__version__)
            graph.register_generator_state(_random.generator(self.device))
        before = {n: k.launches for n, k in _build.KERNELS.items()}
        # fwlint: disable=host-sync — a capture begins on an idle card, once per graph
        torch.cuda.synchronize(self.device)
        # no garbage collection inside the capture: a collected object's
        # finalizer (a pinned host buffer, a decode pipeline joining its
        # threads) may call the CUDA runtime on this thread, which ends
        # the capture; what is garbage now is collected before it begins
        gc.collect()
        gc_was = gc.isenabled()
        gc.disable()
        try:
            with _compileobs.record_compile(
                    g.program, self._signature(), graph_key=self._digest,
                    site=_SITE, digest=self._digest), \
                    C.tally_transfers() as tally, \
                    torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outs = fn()
        finally:
            if gc_was:
                gc.enable()
        g.transfers = tuple(tally)
        for n, k in _build.KERNELS.items():
            if k.launches != before[n]:
                g.per_replay[n] = k.launches - before[n]
                k.launches = before[n]
        g.graph = graph
        g.outs = outs
        self.captures += 1

    def forward(self, params, auxs, inputs):
        """An inference forward (no graph, no update): the outputs."""
        return self._run(params, auxs, None, inputs, train=False)
