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

``group2ctx`` places the graph (:mod:`.placed`) when its group contexts
and ``ctx`` name at least two distinct torch devices, as the JAX
executor does with jax devices: each group's arrays live on its device
and the graph runs as per-context segments joined by explicit copies
(``_placed``). Otherwise ``_placed`` is None and the graph runs as one
segment: every ``cpu(i)`` is the one CPU device, and on one card every
``tpu(i)`` the card (``ROADMAP.md`` C15). A card and the host do place.

``set_monitor_callback`` installs a per-node monitor (``monitor.py``):
while it is active, forward runs the graph with a callback on every
node's visible outputs (``<node>_output``), the reference's
``ExecuteMonCallback``. ``MXNET_BACKWARD_DO_MIRROR=1`` recomputes the
whole forward in backward instead of keeping its activations
(:func:`mirrored`: ``torch.utils.checkpoint``, non-reentrant, the port's
generator put back for the recompute). :meth:`Executor.memory_analysis`
measures one fwd+bwd on the card (``ROADMAP.md`` C16). Every forward and
fwd+bwd is a ``compileobs`` program (``executor.fwd_eval``,
``executor.fwd_bwd``: the first call at a new signature is its compile),
runs inside ``compileobs.oom_guard`` and records a profiler span
(``executor_forward[name]``, ``executor_fwd_bwd[name]``).

The graph that runs is the graph-pass pipeline's output
(:func:`.graphpass.optimize`: canonicalize, fold constants, CSE, fusion
groups; ``MXNET_GRAPH_PASSES`` turns it off), bound by name to the
original symbol's argument and aux-state order; a placed executor runs
the original, as the JAX package's multi-device one does, and so does a
monitored forward (the monitor sees every node the user built). The
compile registry's digest is the optimized graph's, so the same network
built in another operand order is the same program.
"""
from __future__ import annotations

import time

import torch

from . import compileobs as _compileobs
from . import graphpass as _graphpass
from . import profiler as _profiler
from . import random as _random
from .base import MXNetError, env_flag, torch_dtype
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


def _order_like(order, reference):
    """A topological order of the nodes of ``order`` that runs each node
    as early as the ``reference`` graph ran the node of its name (Kahn's
    algorithm, ready nodes by their rank in the reference's order). A
    graph-pass output runs its stochastic nodes in the original graph's
    order that way, so they draw the same numbers from the generator."""
    import heapq

    rank = {}
    for i, node in enumerate(_topo_order(reference._entries)):
        rank.setdefault(node.name, i)
    pos = {id(n): i for i, n in enumerate(order)}
    byid = {id(n): n for n in order}
    waiting = {}
    users = {}
    for n in order:
        deps = {id(i) for i, _ in n.inputs}
        waiting[id(n)] = len(deps)
        for d in deps:
            users.setdefault(d, []).append(id(n))
    far = len(rank)
    ready = [(rank.get(n.name, far), pos[id(n)], id(n)) for n in order
             if not waiting[id(n)]]
    heapq.heapify(ready)
    out = []
    while ready:
        _, _, nid = heapq.heappop(ready)
        out.append(byid[nid])
        for u in users.get(nid, ()):
            waiting[u] -= 1
            if not waiting[u]:
                heapq.heappush(ready, (rank.get(byid[u].name, far), pos[u], u))
    return out


def graph_plan(symbol, arg_names=None, aux_names=None, order_like=None):
    """``(order, slots, stochastic)`` of :func:`build_graph_fn`: the nodes
    in the order they run, each variable's ``id -> (is_aux, slot)``, and
    whether an op draws random numbers."""
    order = _topo_order(symbol._entries)
    _, aux_vars = symbol._arg_aux_split()
    if arg_names is None:
        arg_names = symbol.list_arguments()
    if aux_names is None:
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
    if stochastic and order_like is not None and order_like is not symbol:
        order = _order_like(order, order_like)
    return order, slots, stochastic


def build_graph_fn(symbol, node_callback=None, arg_names=None,
                   aux_names=None, order_like=None):
    """Build ``fn(arg_list, aux_list, is_train, device=None) -> (outputs,
    new_auxs)`` over torch tensors, with arguments and aux states in the
    symbol's ``list_arguments``/``list_auxiliary_states`` order, or, when
    given, in the order of ``arg_names``/``aux_names``: variables then
    bind to those slots by name (how a graph-pass output runs against
    arrays bound in the original symbol's order). The graph runs on the
    device its arguments lie on (``device`` for a graph with none, where
    its creation and sampling ops make their outputs); a stochastic op
    draws from that device's :mod:`.random` generator, in the graph's
    topological order, or in the order the ``order_like`` symbol runs its
    nodes of the same names. ``node_callback(name, tensor)``, when given,
    sees every op node's visible outputs as they are computed
    (``<node>_output``, or ``<node>_output<k>`` for several: the
    reference's monitor names)."""
    order, slots, stochastic = graph_plan(symbol, arg_names, aux_names,
                                          order_like)

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
            if node_callback is not None:
                n_vis = op.num_visible_outputs(node.attrs)
                for k in range(n_vis):
                    node_callback(node.name + ("_output" if n_vis == 1
                                               else "_output%d" % k), outs[k])
            # aux write-backs (aux inputs are always variables)
            for (inp, _), new in zip(node.inputs[n_args:], updated_aux):
                new_aux[slots[id(inp)][1]] = new
        return [vals[id(n)][k] for n, k in symbol._entries], new_aux

    return graph_fn


def graph_is_stochastic(symbol):
    """Whether any op of ``symbol`` draws random numbers."""
    return any(not node.is_variable and get_op(node.op).stochastic(node.attrs)
               for node in _topo_order(symbol._entries))


def mirrored(fn, inputs, device, stochastic):
    """``fn(*inputs)`` under ``torch.utils.checkpoint`` (non-reentrant):
    autograd keeps only ``inputs``, and backward runs ``fn`` again to
    rebuild what it needs (``MXNET_BACKWARD_DO_MIRROR``; the reference's
    graph_executor.cc:213-226, the JAX package's ``jax.checkpoint`` over
    the whole forward). Checkpoint restores only torch's default
    generators; a ``stochastic`` graph draws from the port's generator of
    ``device``, which is put back to its forward state for the recompute
    and restored after it, so backward sees the forward's masks."""
    from torch.utils.checkpoint import checkpoint

    gen = (_random.generator(device)
           if stochastic and device is not None else None)
    if gen is not None and torch.device(device).type == "cuda" and \
            torch.cuda.is_current_stream_capturing():
        raise MXNetError(
            "MXNET_BACKWARD_DO_MIRROR over a graph that draws random numbers "
            "cannot run inside a CUDA-graph capture (a generator's state "
            "cannot be read there); train it with MXNET_MODULE_NO_FUSED=1")
    saved = []

    def run(*xs):
        if gen is None:
            return fn(*xs)
        if not saved:               # the forward
            saved.append(gen.get_state())
            return fn(*xs)
        after = gen.get_state()     # the recompute, in backward
        gen.set_state(saved[0])
        try:
            return fn(*xs)
        finally:
            gen.set_state(after)

    return checkpoint(run, *inputs, use_reentrant=False,
                      preserve_rng_state=False)


class _MemoryAnalysis:
    """What :meth:`Executor.memory_analysis` returns, with the field names
    of XLA's ``CompiledMemoryStats``."""

    __slots__ = ("argument_size_in_bytes", "output_size_in_bytes",
                 "temp_size_in_bytes", "peak_memory_in_bytes",
                 "alias_size_in_bytes", "generated_code_size_in_bytes")

    def __init__(self, argument, output, temp, peak):
        self.argument_size_in_bytes = int(argument)
        self.output_size_in_bytes = int(output)
        self.temp_size_in_bytes = int(temp)
        self.peak_memory_in_bytes = int(peak)
        self.alias_size_in_bytes = 0
        self.generated_code_size_in_bytes = 0

    def __repr__(self):
        return ("MemoryAnalysis(argument=%d, output=%d, temp=%d, peak=%d)"
                % (self.argument_size_in_bytes, self.output_size_in_bytes,
                   self.temp_size_in_bytes, self.peak_memory_in_bytes))


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class Executor:
    """A bound computation graph over NDArrays on one device."""

    def __init__(self, symbol, ctx, args, args_grad=None, grad_req="write",
                 aux_states=None, group2ctx=None, shared_exec=None,
                 compute_dtype=None, cast_exempt=()):
        del shared_exec   # no memory pool to share
        self._compute_dtype = (None if compute_dtype is None
                               else torch_dtype(compute_dtype))
        self._cast_exempt = frozenset(cast_exempt) | index_like_inputs(symbol)
        self._symbol = symbol
        self._ctx = ctx
        self._group2ctx = group2ctx
        self._arg_names = symbol.list_arguments()
        self._aux_names = symbol.list_auxiliary_states()
        base = ctx[0] if isinstance(ctx, (list, tuple)) else ctx
        multi_dev = bool(group2ctx) and len(
            {torch.device(c) for c in group2ctx.values()}
            | {torch.device(base)}) > 1
        # the graph-pass pipeline's output runs, bound by name to the
        # original symbol's slots; a placed graph keeps the original (the
        # segment cutter reads its node structure)
        self._opt_symbol = symbol if multi_dev else _graphpass.optimize(symbol)
        self._graph_fn = build_graph_fn(
            self._opt_symbol, arg_names=self._arg_names,
            aux_names=self._aux_names, order_like=symbol)
        self._stochastic = graph_is_stochastic(symbol)
        self.monitor_callback = None
        self._monitor_active = None
        self._graph_fn_monitored = None
        digest = _compileobs.symbol_digest(self._opt_symbol)
        site = "mxnet_tpu_torch/executor.py:Executor"
        self._prog_eval = _compileobs.Program("executor.fwd_eval", site,
                                              digest, digest)
        self._prog_fwd_bwd = _compileobs.Program("executor.fwd_bwd", site,
                                                 digest, digest)
        self._fwd_s = 0.0   # the training forward's seconds, for fwd_bwd

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
        self._placed = None
        if multi_dev:
            from .placed import PlacedGraph

            self._placed = PlacedGraph(symbol, group2ctx, base,
                                       self._arg_names, self._aux_names,
                                       self._cast_one)
            self._place_arrays()

    def _cast_one(self, name, t):
        return cast_compute([name], [t], self._compute_dtype,
                            self._cast_exempt)[0]

    def _place_arrays(self):
        """Each bound array on its group's device: the user-visible face of
        model parallelism (``arg_dict[name].context``)."""
        placed = self._placed
        for names, arrays, where in (
                (self._arg_names, (self.arg_arrays, self.grad_arrays),
                 placed.arg_ctx),
                (self._aux_names, (self.aux_arrays,), placed.aux_ctx)):
            for i, name in enumerate(names):
                for group in arrays:
                    arr = group[i]
                    if arr is not None and name in where:
                        arr._set_data(arr.data.to(torch.device(where[name])))

    # ---- forward ------------------------------------------------------
    def _profile_name(self, kind):
        return "executor_%s[%s]" % (kind, getattr(self._symbol, "name", None)
                                    or "graph")

    def _signature(self, args, auxs):
        return _compileobs.signature(zip(self._arg_names + self._aux_names,
                                         list(args) + list(auxs)))

    def _train_forward(self, args, auxs, graph_fn=None):
        """The training forward with autograd on: ``(leaves, outputs, new
        auxs)``, the leaves the arguments that take a gradient. Under
        ``MXNET_BACKWARD_DO_MIRROR`` (not with a node callback) autograd
        keeps only the leaves and backward recomputes the forward."""
        args = list(args)
        leaves = []
        for i in self._diff_idx:
            args[i] = args[i].detach().requires_grad_(True)
            leaves.append(args[i])
        fn = graph_fn or self._graph_fn
        with torch.enable_grad():
            if graph_fn is None and leaves and env_flag("MXNET_BACKWARD_DO_MIRROR"):
                n_out = len(self._symbol._entries)

                def run(*xs):
                    full = list(args)
                    for i, x in zip(self._diff_idx, xs):
                        full[i] = x
                    outs, new_aux = fn(self._cast(full), auxs, True, self._ctx)
                    return tuple(outs) + tuple(new_aux)

                res = mirrored(run, leaves, self._ctx, self._stochastic)
                outs, new_aux = list(res[:n_out]), list(res[n_out:])
            else:
                outs, new_aux = fn(self._cast(args), auxs, True, self._ctx)
        return leaves, outs, new_aux

    def forward(self, is_train=False, **kwargs):
        """Run the graph. kwargs overwrite input arrays first
        (``data=...``). With ``is_train`` the autograd graph is kept for
        :meth:`backward`. With an active monitor the run feeds its
        callback every node's outputs."""
        for k, v in kwargs.items():
            if k not in self._arg_names:
                raise MXNetError("Unknown input %s" % k)
            self.arg_arrays[self._arg_names.index(k)][:] = v
        args = [a.data for a in self.arg_arrays]
        auxs = [a.data for a in self.aux_arrays]
        monitored = self.monitor_callback is not None and (
            self._monitor_active is None or self._monitor_active())
        if monitored and self._placed is not None:
            raise MXNetError(
                "Monitor is not supported on a multi-device group2ctx "
                "executor: remove the monitor or bind without group2ctx.")
        graph_fn = self._monitored_fn() if monitored else None
        kind = ("forward_monitored" if monitored else
                "fwd_bwd" if is_train else "forward")
        t0 = time.perf_counter()
        wall0 = time.time()
        with _profiler.record_span(self._profile_name(kind), "executor"), \
                _compileobs.oom_guard("executor.fwd_bwd" if is_train
                                      else "executor.fwd",
                                      inject=not is_train):
            if self._placed is not None:
                outs, new_aux = self._placed.forward(args, auxs, is_train)
                self._pending = (None, outs) if is_train else None
                self._outputs = outs
            elif is_train:
                leaves, outs, new_aux = self._train_forward(args, auxs,
                                                            graph_fn)
                self._pending = (leaves, outs)
                self._outputs = [o.detach() for o in outs]
            else:
                with torch.no_grad():
                    outs, new_aux = (graph_fn or self._graph_fn)(
                        self._cast(args), auxs, False, self._ctx)
                self._pending = None
                self._outputs = outs
        dt = time.perf_counter() - t0
        if is_train:
            self._fwd_s = dt
            for arr, new in zip(self.aux_arrays, new_aux):
                arr._set_data(new.detach().to(arr.data.dtype))
        else:
            self._prog_eval.charge(self._signature(args, auxs), dt, wall0)
        return self.outputs

    def _monitored_fn(self):
        if self._graph_fn_monitored is None:
            from .ndarray import NDArray

            def emit(name, value):
                cb = self.monitor_callback
                if cb is not None:
                    cb(name, NDArray(value.detach()))

            # the original graph, as the JAX executor's monitored forward
            # runs it: the monitor sees every node the user built
            self._graph_fn_monitored = build_graph_fn(self._symbol,
                                                      node_callback=emit)
        return self._graph_fn_monitored

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
        sig = self._signature([a.data for a in self.arg_arrays],
                              [a.data for a in self.aux_arrays])
        t0 = time.perf_counter()
        wall0 = time.time() - self._fwd_s
        with _profiler.record_span(self._profile_name("fwd_bwd"), "executor"), \
                _compileobs.oom_guard("executor.fwd_bwd"):
            self._backward(leaves, outs, out_grads)
        self._prog_fwd_bwd.charge(sig, self._fwd_s + time.perf_counter() - t0,
                                  wall0)

    def _backward(self, leaves, outs, out_grads):
        from .ndarray import NDArray

        if out_grads is None:
            ogs = [torch.full_like(o, 1.0 if loss else 0.0)
                   for o, loss in zip(outs, self._is_loss_output)]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            ogs = [(g.data if isinstance(g, NDArray) else torch.as_tensor(g))
                   .to(o.device, o.dtype) for g, o in zip(out_grads, outs)]
        if self._placed is not None:
            every = self._placed.backward(ogs)
            grads = [every[i] for i in self._diff_idx]
            leaves = [self.arg_arrays[i].data for i in self._diff_idx]
        else:
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
            g = g.to(dst.data.device, dst.data.dtype)
            if self._grad_req[self._arg_names[i]] == "write":
                dst._set_data(g)
            else:
                dst._set_data(dst.data + g)

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

    def debug_str(self):
        return self._symbol.debug_str()

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

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new executor of this one's symbol at the data shapes in
        ``kwargs`` (reference: ``executor.py:360``; the JAX package's
        ``executor.py:648-680``): every argument, gradient and auxiliary
        array whose shape the new shapes leave unchanged is the same
        NDArray (an update through one executor is seen by the other), and
        every other is new zeros on this executor's context. ``grad_req``,
        ``group2ctx``, ``compute_dtype`` and ``cast_exempt`` carry over;
        ``partial_shaping`` and ``allow_up_sizing`` are the reference's
        names (there is no memory pool to grow)."""
        from . import ndarray as nd

        del partial_shaping, allow_up_sizing
        try:
            arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        except MXNetError as e:
            raise MXNetError("Insufficient argument shapes provided. (%s)"
                             % e) from e
        if arg_shapes is None:
            raise MXNetError("Insufficient argument shapes provided.")
        ctx = self._ctx[0] if isinstance(self._ctx, (list, tuple)) else self._ctx

        def same_or_zeros(cur, shape):
            if tuple(shape) == tuple(cur.shape):
                return cur
            return nd.zeros(shape, ctx=ctx, dtype=cur.dtype)

        new_args, new_grads = [], []
        for arr, grad, shape in zip(self.arg_arrays, self.grad_arrays,
                                    arg_shapes):
            new_args.append(same_or_zeros(arr, shape))
            new_grads.append(None if grad is None else
                             same_or_zeros(grad, shape))
        new_aux = [same_or_zeros(arr, shape)
                   for arr, shape in zip(self.aux_arrays, aux_shapes)]
        return Executor(
            self._symbol, self._ctx, new_args, new_grads,
            [self._grad_req[n] for n in self._arg_names], new_aux,
            group2ctx=self._group2ctx, compute_dtype=self._compute_dtype,
            cast_exempt=self._cast_exempt)

    def set_monitor_callback(self, callback, is_active=None):
        """Install a per-node monitor (reference:
        MXExecutorSetMonitorCallback → GraphExecutor::ExecuteMonCallback,
        graph_executor.cc:761-781): while installed and ``is_active()``
        (always when None), forward feeds ``callback(name, NDArray)`` every
        node's visible outputs."""
        self.monitor_callback = callback
        self._monitor_active = is_active

    def memory_analysis(self):
        """Memory of one fwd+bwd of this executor, with the field names of
        XLA's ``CompiledMemoryStats`` (``argument_size_in_bytes``,
        ``output_size_in_bytes``, ``temp_size_in_bytes``,
        ``peak_memory_in_bytes``).

        torch has no compile-time memory plan (``ROADMAP.md`` C16): on a
        card the port measures — one fwd+bwd on scratch copies of the
        arguments and auxiliary states with the allocator's peak reset, the
        generator put back after it, so the executor's arrays, gradients,
        random stream and the next step are untouched; the peak is the
        allocator's peak above what was allocated before, and temp the
        peak less arguments and outputs. On the CPU the argument and
        output sizes are the arrays' bytes and the peak 0 (nothing
        measures it there)."""
        if self._placed is not None:
            raise MXNetError(
                "memory_analysis is per-program; a multi-device group2ctx "
                "executor runs one program per device segment. Bind without "
                "group2ctx to analyze the single-device program.")
        args = [a.data for a in self.arg_arrays]
        auxs = [a.data for a in self.aux_arrays]
        arg_bytes = _nbytes(args + auxs)
        device = args[0].device if args else torch.device(self._ctx)
        if device.type != "cuda":
            shapes = {n: tuple(a.shape) for n, a in
                      zip(self._arg_names, self.arg_arrays)}
            _, out_shapes, _ = self._symbol.infer_shape(**shapes)
            itemsize = (torch.empty((), dtype=self._compute_dtype).element_size()
                        if self._compute_dtype is not None else 4)
            out_bytes = sum(int(torch.Size(s).numel()) * itemsize
                            for s in out_shapes)
            out_bytes += _nbytes([args[i] for i in self._diff_idx] + auxs)
            return _MemoryAnalysis(arg_bytes, out_bytes, 0, 0)
        gen = _random.generator(device)
        state = gen.get_state()
        # fwlint: disable=host-sync — the measurement's bracket (memory_analysis, off the step path)
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        try:
            scratch = [a.clone() for a in args]
            scratch_aux = [a.clone() for a in auxs]
            leaves, outs, new_aux = self._train_forward(scratch, scratch_aux)
            pairs = [(o, torch.full_like(o, 1.0 if loss else 0.0))
                     for o, loss in zip(outs, self._is_loss_output)
                     if o.requires_grad]
            grads = []
            if pairs and leaves:
                grads = torch.autograd.grad([o for o, _ in pairs], leaves,
                                            [g for _, g in pairs],
                                            allow_unused=True)
            out_bytes = _nbytes(list(outs) + list(grads) + list(new_aux))
            # fwlint: disable=host-sync — the measurement's bracket (memory_analysis, off the step path)
            torch.cuda.synchronize(device)
            peak = torch.cuda.max_memory_allocated(device) - base
            del scratch, scratch_aux, leaves, outs, new_aux, pairs, grads
        finally:
            gen.set_state(state)
        return _MemoryAnalysis(arg_bytes, out_bytes,
                               max(peak - arg_bytes - out_bytes, 0), peak)
