"""Executor — binds a Symbol to arrays and runs it (counterpart of
``mxnet_tpu/executor.py``; reference: python/mxnet/executor.py).

The JAX package traces the graph into one jitted function and takes the
gradient with ``jax.vjp``. The port interprets the graph node by node in
topological order with torch tensors (eager, like the reference's
engine) and takes the gradient with ``torch.autograd``:

* ``forward(is_train=True)`` runs the graph once with the arguments that
  need a gradient as autograd leaves and keeps the graph; ``outputs``
  then reads the values of that same run, so a training step computes
  one forward, never two;
* ``backward()`` seeds loss outputs with ones and other heads with zeros
  (or takes ``out_grads``), and writes (``grad_req='write'``) or adds
  (``'add'``) each gradient into its grad array; ``'null'`` arguments get
  none.

``compute_dtype`` is the JAX package's mixed precision: float32
arguments are cast to it where the graph uses them (the leaves that take
gradients stay the float32 masters, so gradients come back float32),
except labels and index-like inputs (``cast_exempt`` and
:data:`_INDEX_ARG_POSITIONS`); auxiliary states keep their float32.

Not in this slice (they raise :class:`MXNetError`): ``group2ctx`` model
parallelism and monitor callbacks — ``ROADMAP.md`` A6/A7. The JAX
package's graph passes and compile cache have no counterpart yet (A7).
"""
from __future__ import annotations

import torch

from . import random as _random
from .base import MXNetError, torch_dtype
from .ops.registry import OpContext, get_op
from .symbol import _topo_order

__all__ = ["Executor"]

# ops whose listed inputs carry integer ids: bf16 holds integers exactly
# only up to 256, so these inputs are exempt from the compute_dtype cast
_INDEX_ARG_POSITIONS = {
    "Embedding": (0,),
    "take": (1,),
    "batch_take": (1,),
    "one_hot": (0,),
    "gather_nd": (1,),
    "scatter_nd": (1,),
    "pick": (1,),
    "choose_element_0index": (1,),
    "fill_element_0index": (1,),
}


def index_like_inputs(symbol):
    """Names of Variable inputs that feed an index argument of any op."""
    exempt = set()
    for node in _topo_order(symbol._entries):
        if node.is_variable:
            continue
        for pos in _INDEX_ARG_POSITIONS.get(node.op, ()):
            if pos < len(node.inputs):
                inp, _ = node.inputs[pos]
                if inp.is_variable:
                    exempt.add(inp.name)
    return exempt


def cast_compute(names, tensors, compute_dtype, exempt):
    """``tensors`` with every float32 one whose name is not in ``exempt``
    cast to ``compute_dtype`` (None: unchanged)."""
    if compute_dtype is None:
        return list(tensors)
    return [t.to(compute_dtype) if (n not in exempt
                                    and t.dtype == torch.float32) else t
            for n, t in zip(names, tensors)]


def build_graph_fn(symbol):
    """Build ``fn(arg_list, aux_list, is_train, device=None) -> (outputs,
    new_auxs)`` over torch tensors, with arguments and aux states in the
    symbol's ``list_arguments``/``list_auxiliary_states`` order. The graph
    runs on the device its arguments lie on (``device`` for a graph with
    none, where its creation and sampling ops make their outputs); a
    stochastic op draws from that device's :mod:`.random` generator, in
    the graph's topological order."""
    order = _topo_order(symbol._entries)
    _, aux_vars = symbol._arg_aux_split()
    arg_names = symbol.list_arguments()
    aux_names = symbol.list_auxiliary_states()
    arg_slot = {n: i for i, n in enumerate(arg_names)}
    aux_slot = {n: i for i, n in enumerate(aux_names)}
    slots = {}
    for node in order:
        if node.is_variable:
            slots[id(node)] = ((True, aux_slot[node.name]) if id(node) in aux_vars
                               else (False, arg_slot[node.name]))

    stochastic = any(not node.is_variable
                     and get_op(node.op).stochastic(node.attrs)
                     for node in order)

    def graph_fn(arg_list, aux_list, is_train, device=None):
        vals = {}
        new_aux = list(aux_list)
        device = arg_list[0].device if arg_list else device
        octx = OpContext(is_train=is_train, device=device,
                         rng=(_random.generator(device)
                              if stochastic and device is not None else None))
        for node in order:
            if node.is_variable:
                is_aux, slot = slots[id(node)]
                vals[id(node)] = [aux_list[slot] if is_aux else arg_list[slot]]
                continue
            op = get_op(node.op)
            n_args = len(op.arg_names(node.attrs))
            ins = [vals[id(n)][k] for n, k in node.inputs]
            outs, updated_aux = op.forward(octx, node.attrs, ins[:n_args], ins[n_args:])
            vals[id(node)] = list(outs)
            # aux write-backs (aux inputs are always variables)
            for (inp, _), new in zip(node.inputs[n_args:], updated_aux):
                new_aux[slots[id(inp)][1]] = new
        return [vals[id(n)][k] for n, k in symbol._entries], new_aux

    return graph_fn


class Executor:
    """A bound computation graph over NDArrays on one device."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, group2ctx=None, shared_exec=None,
                 compute_dtype=None, cast_exempt=()):
        if group2ctx:
            raise MXNetError("group2ctx (model-parallel placement) is not "
                             "ported yet (ROADMAP.md A6)")
        del shared_exec   # no memory pool to share
        self._compute_dtype = (None if compute_dtype is None
                               else torch_dtype(compute_dtype))
        self._cast_exempt = frozenset(cast_exempt) | index_like_inputs(symbol)
        self._symbol = symbol
        self._ctx = ctx
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        self._graph_fn = build_graph_fn(symbol)

        if isinstance(args, dict):
            try:
                self.arg_arrays = [args[n] for n in self._arg_names]
            except KeyError as e:
                raise MXNetError("key %s missing in args" % e) from e
        else:
            self.arg_arrays = list(args)
        if len(self.arg_arrays) != len(self._arg_names):
            raise MXNetError("Expect %d args, got %d"
                             % (len(self._arg_names), len(self.arg_arrays)))
        if isinstance(aux_states, dict):
            self.aux_arrays = [aux_states[n] for n in self._aux_names]
        else:
            self.aux_arrays = list(aux_states) if aux_states else []
        if len(self.aux_arrays) != len(self._aux_names):
            raise MXNetError("Expect %d aux states, got %d"
                             % (len(self._aux_names), len(self.aux_arrays)))
        if isinstance(grad_req, str):
            self._grad_req = {n: grad_req for n in self._arg_names}
        elif isinstance(grad_req, (list, tuple)):
            self._grad_req = dict(zip(self._arg_names, grad_req))
        elif isinstance(grad_req, dict):
            self._grad_req = {n: grad_req.get(n, "null") for n in self._arg_names}
        else:
            raise MXNetError("invalid grad_req")
        if args_grad is None:
            self.grad_arrays = [None] * len(self._arg_names)
        elif isinstance(args_grad, dict):
            self.grad_arrays = [args_grad.get(n) for n in self._arg_names]
        else:
            self.grad_arrays = list(args_grad)
            self.grad_arrays += [None] * (len(self._arg_names) - len(self.grad_arrays))
        for i, n in enumerate(self._arg_names):
            if self.grad_arrays[i] is None:
                self._grad_req[n] = "null"
            elif self._grad_req[n] not in ("null", "write", "add"):
                raise MXNetError("grad_req %r for %s: expected write, add or "
                                 "null" % (self._grad_req[n], n))
        self._diff_idx = [i for i, n in enumerate(self._arg_names)
                          if self._grad_req[n] != "null"]
        self._is_loss_output = [
            not node.is_variable and get_op(node.op).is_loss
            for node, _ in symbol._entries]
        self._outputs = None
        self._pending = None   # (leaves, outputs with their autograd graph)

    # ---- forward ------------------------------------------------------
    def forward(self, is_train=False, **kwargs):
        """Run the graph. kwargs overwrite input arrays first
        (``data=...``). With ``is_train`` the autograd graph is kept for
        :meth:`backward`."""
        for k, v in kwargs.items():
            if k not in self._arg_names:
                raise MXNetError("Unknown input %s" % k)
            self.arg_arrays[self._arg_names.index(k)][:] = v
        args = [a.data for a in self.arg_arrays]
        auxs = [a.data for a in self.aux_arrays]
        if is_train:
            leaves = []
            for i in self._diff_idx:
                args[i] = args[i].detach().requires_grad_(True)
                leaves.append(args[i])
            with torch.enable_grad():
                outs, new_aux = self._graph_fn(self._cast(args), auxs, True,
                                               self._ctx)
            self._pending = (leaves, outs)
            self._outputs = [o.detach() for o in outs]
        else:
            with torch.no_grad():
                outs, new_aux = self._graph_fn(self._cast(args), auxs, False,
                                               self._ctx)
            self._pending = None
            self._outputs = outs
        if is_train:
            for arr, new in zip(self.aux_arrays, new_aux):
                arr._set_data(new.detach().to(arr.data.dtype))
        return self.outputs

    def _cast(self, args):
        return cast_compute(self._arg_names, args, self._compute_dtype,
                            self._cast_exempt)

    @property
    def outputs(self):
        """Output NDArrays of the last forward."""
        from .ndarray import NDArray

        if self._outputs is None:
            raise MXNetError("call forward() first")
        return [NDArray(o) for o in self._outputs]

    # ---- backward -----------------------------------------------------
    def backward(self, out_grads=None):
        """Backward pass. Without ``out_grads``, loss outputs are seeded
        with ones and other outputs with zeros: only ops with declared
        gradients (SoftmaxOutput) then drive the parameters."""
        from .ndarray import NDArray

        if self._pending is None:
            # after an inference forward, re-run it as a training forward
            self.forward(is_train=True)
        leaves, outs = self._pending
        self._pending = None
        if out_grads is None:
            ogs = [torch.full_like(o, 1.0 if loss else 0.0)
                   for o, loss in zip(outs, self._is_loss_output)]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            ogs = [(g.data if isinstance(g, NDArray) else torch.as_tensor(g))
                   .to(o.device, o.dtype) for g, o in zip(out_grads, outs)]
        pairs = [(o, g) for o, g in zip(outs, ogs) if o.requires_grad]
        grads = [None] * len(leaves)
        if pairs and leaves:
            grads = torch.autograd.grad([o for o, _ in pairs],
                                        leaves, [g for _, g in pairs],
                                        allow_unused=True)
        for i, leaf, g in zip(self._diff_idx, leaves, grads):
            if g is None:
                g = torch.zeros_like(leaf)
            dst = self.grad_arrays[i]
            if self._grad_req[self._arg_names[i]] == "write":
                dst._set_data(g.to(dst.data.dtype))
            else:
                dst._set_data(dst.data + g.to(dst.data.dtype))

    # ---- dicts ---------------------------------------------------------
    @property
    def arg_dict(self):
        return dict(zip(self._arg_names, self.arg_arrays))

    @property
    def grad_dict(self):
        return dict(zip(self._arg_names, self.grad_arrays))

    @property
    def aux_dict(self):
        return dict(zip(self._aux_names, self.aux_arrays))

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def copy_params_from(self, arg_params, aux_params=None, allow_extra_params=False):
        """Copy parameters (NDArrays, tensors or numpy arrays) into the
        bound arrays."""
        for name, array in arg_params.items():
            if name in self.arg_dict:
                self.arg_dict[name][:] = array
            elif not allow_extra_params:
                raise ValueError("Find name %s that is not in the arguments" % name)
        for name, array in (aux_params or {}).items():
            if name in self.aux_dict:
                self.aux_dict[name][:] = array
            elif not allow_extra_params:
                raise ValueError("Find name %s that is not in the auxiliary states" % name)

    def set_monitor_callback(self, callback, is_active=None):
        raise MXNetError("monitor callbacks are not ported yet (ROADMAP.md A7)")
