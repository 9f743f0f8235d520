"""Symbol — the declarative graph API of the port (counterpart of
``mxnet_tpu/symbol.py``; reference: python/mxnet/symbol.py).

A lightweight Python DAG of ``(node, output index)`` entries, composed
with the same rules, named by the same :class:`~.name.NameManager`, and
serialized to the same nnvm-format JSON as the JAX package, byte for
byte. Shape and type inference run each op's rule in topological order.
The only consumer is :class:`~.executor.Executor`, which interprets the
graph with torch tensors.

Each registered op is a module-level constructor (``sym.FullyConnected``,
``sym.Reshape``, ...); ``_contrib_*`` ops are also reachable as
``sym.contrib.<name>``. ``Symbol.save`` and :func:`load` write and read
the JSON file (the write crash-safe, as in the JAX package). ``zeros``,
``ones`` and ``arange`` build ``_zeros``/``_ones``/``_arange`` nodes;
``pow``, ``maximum``, ``minimum`` and ``hypot`` take a Symbol or a number
on either side, and ``**`` builds ``_power``/``_power_scalar``, as in the
JAX package. ``Symbol.eval`` is left for a later slice.
"""
from __future__ import annotations

import ast
import builtins
import json
import sys
import types

import numpy as np

from . import context as _context
from .attribute import AttrScope
from .base import MXNetError, attr_str
from .name import NameManager
from .ops.registry import get_op, list_ops

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json", "zeros",
           "ones", "arange", "pow", "maximum", "minimum", "hypot"]


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "_extra_attrs")

    def __init__(self, op, name, attrs, inputs, extra_attrs=None):
        self.op = op  # op name string, or None for a variable
        self.name = name
        self.attrs = attrs or {}  # canonicalized op params
        self.inputs = inputs or []  # list of (_Node, int output index)
        self._extra_attrs = extra_attrs or {}  # user attrs (ctx_group, lr_mult, ...)

    @property
    def is_variable(self):
        return self.op is None

    def list_attr(self):
        d = {k: attr_str(v) for k, v in self.attrs.items()}
        d.update({k: attr_str(v) for k, v in self._extra_attrs.items()})
        return d


def _topo_order(root_entries):
    """Post-order DFS over the DAG; returns list of unique nodes."""
    seen = {}
    order = []
    stack = [(n, False) for n, _ in reversed(root_entries)]
    while stack:
        node, done = stack.pop()
        if done:
            order.append(node)
            continue
        if id(node) in seen:
            continue
        seen[id(node)] = node
        stack.append((node, True))
        for inp, _ in reversed(node.inputs):
            if id(inp) not in seen:
                stack.append((inp, False))
    return order


class Symbol:
    """A multi-output handle onto graph nodes: a list of
    (node, output_index) entries (nnvm's NodeEntry)."""

    __slots__ = ("_entries",)

    def __init__(self, entries):
        self._entries = list(entries)

    # ---- composition ----------------------------------------------------
    def __call__(self, *args, **kwargs):
        """Compose: replace this symbol's free variables with other symbols."""
        s = self.__copy__()
        s._compose(*args, **kwargs)
        return s

    def __copy__(self):
        # copy the reachable subgraph so composition doesn't mutate shared nodes
        mapping = {}
        for node in _topo_order(self._entries):
            mapping[id(node)] = _Node(
                node.op, node.name, dict(node.attrs),
                [(mapping[id(i)], k) for i, k in node.inputs],
                dict(node._extra_attrs))
        return Symbol([(mapping[id(n)], k) for n, k in self._entries])

    def _compose(self, *args, **kwargs):
        if args and kwargs:
            raise MXNetError("compose only accept input Symbols either as "
                             "positional or keyword arguments")
        if args:
            kwargs = dict(zip(self.list_arguments(), args))
        order = _topo_order(self._entries)
        var_map = {}
        for node in order:
            if node.is_variable and node.name in kwargs:
                var_map[id(node)] = kwargs[node.name]._entries[0]
        for node in order:
            node.inputs = [var_map.get(id(i), (i, k)) for i, k in node.inputs]

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError("Cannot find output %s" % index)
            index = names.index(index)
        return Symbol([self._entries[index]])

    def __len__(self):
        return len(self._entries)

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    # ---- arithmetic builds graph nodes ----------------------------------
    def __add__(self, o):
        if isinstance(o, Symbol):
            return _create("elemwise_add", [self, o], {})
        return _create("_plus_scalar", [self], {"scalar": float(o)})

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Symbol):
            return _create("elemwise_sub", [self, o], {})
        return _create("_minus_scalar", [self], {"scalar": float(o)})

    def __rsub__(self, o):
        return _create("_rminus_scalar", [self], {"scalar": float(o)})

    def __mul__(self, o):
        if isinstance(o, Symbol):
            return _create("elemwise_mul", [self, o], {})
        return _create("_mul_scalar", [self], {"scalar": float(o)})

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Symbol):
            return _create("elemwise_div", [self, o], {})
        return _create("_div_scalar", [self], {"scalar": float(o)})

    def __rtruediv__(self, o):
        return _create("_rdiv_scalar", [self], {"scalar": float(o)})

    def __pow__(self, o):
        if isinstance(o, Symbol):
            return _create("_power", [self, o], {})
        return _create("_power_scalar", [self], {"scalar": float(o)})

    def __neg__(self):
        return _create("negative", [self], {})

    # ---- introspection --------------------------------------------------
    @property
    def name(self):
        if len(self._entries) == 1:
            return self._entries[0][0].name
        return None

    def attr(self, key):
        node = self._entries[0][0]
        v = node._extra_attrs.get(key)
        if v is None and key in node.attrs:
            v = attr_str(node.attrs[key])
        return v

    def list_attr(self, recursive=False):
        if recursive:
            ret = {}
            for node in _topo_order(self._entries):
                for k, v in node.list_attr().items():
                    ret["%s_%s" % (node.name, k)] = v
            return ret
        return self._entries[0][0].list_attr()

    def attr_dict(self):
        ret = {}
        for node in _topo_order(self._entries):
            d = node.list_attr()
            if d:
                ret[node.name] = d
        return ret

    def _set_attr(self, **kwargs):
        self._entries[0][0]._extra_attrs.update(kwargs)

    def _arg_aux_split(self):
        """Classify variable nodes into args vs aux states: a variable is
        auxiliary if it feeds an aux slot of an op."""
        aux_vars = set()
        arg_vars = set()
        for node in _topo_order(self._entries):
            if node.is_variable:
                continue
            n_args = len(get_op(node.op).arg_names(node.attrs))
            for i, (inp, _) in enumerate(node.inputs):
                if inp.is_variable:
                    (aux_vars if i >= n_args else arg_vars).add(id(inp))
        return arg_vars, aux_vars

    def list_arguments(self):
        _, aux_vars = self._arg_aux_split()
        return [node.name for node in _topo_order(self._entries)
                if node.is_variable and id(node) not in aux_vars]

    def list_auxiliary_states(self):
        _, aux_vars = self._arg_aux_split()
        return [node.name for node in _topo_order(self._entries)
                if node.is_variable and id(node) in aux_vars]

    def list_outputs(self):
        names = []
        for node, idx in self._entries:
            if node.is_variable:
                names.append(node.name)
            else:
                op = get_op(node.op)
                onames = op.output_names(node.attrs)
                if op.num_outputs(node.attrs) == 1:
                    names.append(node.name + "_" + onames[0])
                else:
                    names.append(node.name + "_" + onames[idx])
        return names

    def list_inputs(self):
        return self.list_arguments() + self.list_auxiliary_states()

    def get_children(self):
        """The inputs of the head node as one symbol; None for a variable."""
        node = self._entries[0][0]
        if not node.inputs:
            return None
        return Symbol([(n, i) for n, i in node.inputs])

    def grad(self, wrt):
        raise MXNetError("Symbol.grad is deprecated; use bind with args_grad")

    def debug_str(self):
        """One line per variable, one block per op with its inputs."""
        lines = []
        for node in _topo_order(self._entries):
            if node.is_variable:
                lines.append("Variable:%s" % node.name)
            else:
                lines.append("Op:%s, Name=%s\nInputs:\n\t%s" % (
                    node.op, node.name,
                    "\n\t".join(n.name for n, _ in node.inputs)))
        return "\n".join(lines)

    def get_internals(self):
        """Every internal output, one entry per node output, in
        topological order."""
        entries = []
        for node in _topo_order(self._entries):
            if node.is_variable:
                entries.append((node, 0))
            else:
                op = get_op(node.op)
                entries += [(node, i) for i in range(op.num_visible_outputs(node.attrs))]
        return Symbol(entries)

    # ---- inference ------------------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes); all three None when the
        given shapes do not determine every one."""
        return _infer(self, self._provided_shapes(args, kwargs), "shape")

    def infer_shape_partial(self, *args, **kwargs):
        """As :meth:`infer_shape`, but a shape the given ones do not
        determine is None in its list (a node whose inference fails leaves
        its outputs None)."""
        return _infer(self, self._provided_shapes(args, kwargs), "shape",
                      partial=True)

    def _provided_shapes(self, args, kwargs):
        provided = {}
        for name, shape in zip(self.list_arguments(), args):
            if shape is not None:
                provided[name] = tuple(shape)
        provided.update({k: tuple(v) for k, v in kwargs.items() if v is not None})
        return provided

    def infer_type(self, *args, **kwargs):
        provided = {}
        for name, dt in zip(self.list_arguments(), args):
            if dt is not None:
                provided[name] = np.dtype(dt)
        provided.update({k: np.dtype(v) for k, v in kwargs.items() if v is not None})
        return _infer(self, provided, "type")

    # ---- serialization --------------------------------------------------
    def tojson(self):
        order = _topo_order(self._entries)
        node_ids = {id(n): i for i, n in enumerate(order)}
        nodes = []
        arg_nodes = []
        for i, node in enumerate(order):
            if node.is_variable:
                arg_nodes.append(i)
                entry = {"op": "null", "name": node.name, "inputs": []}
            else:
                entry = {
                    "op": node.op,
                    "name": node.name,
                    "inputs": [[node_ids[id(n)], k, 0] for n, k in node.inputs],
                }
            attrs = node.list_attr()
            if attrs:
                entry["attrs"] = attrs
            nodes.append(entry)
        heads = [[node_ids[id(n)], k, 0] for n, k in self._entries]
        return json.dumps(
            {
                "nodes": nodes,
                "arg_nodes": arg_nodes,
                "node_row_ptr": list(range(len(order) + 1)),
                "heads": heads,
                "attrs": {"mxnet_version": ["int", 1000]},
            },
            indent=2,
        )

    def save(self, fname):
        """Write :meth:`tojson` to ``fname`` crash-safely (temp file,
        fsync, rename; no checksum footer: the file stays plain JSON)."""
        from .utils.atomic_file import atomic_write

        with atomic_write(fname, checksum=False) as f:
            f.write(self.tojson())

    # ---- binding --------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, shared_arg_names=None, shared_exec=None,
                    shared_buffer=None, compute_dtype=None, cast_exempt=(),
                    **kwargs):
        """Shape-inferred allocation + bind. kwargs are input shapes;
        ``ctx`` defaults to the card (:func:`~.context.default_device`)."""
        from . import ndarray as nd

        ctx = _context.resolve(ctx)
        arg_shapes, _, aux_shapes = self.infer_shape(**kwargs)
        if arg_shapes is None:
            raise MXNetError("cannot infer shapes from %s" % kwargs)
        type_dict = type_dict or {}
        arg_names = self.list_arguments()
        arg_types, _, aux_types = self.infer_type(
            **{k: v for k, v in type_dict.items() if k in arg_names})
        args = [nd.zeros(s, ctx=ctx, dtype=t) for s, t in zip(arg_shapes, arg_types)]
        aux_states = [nd.zeros(s, ctx=ctx, dtype=t) for s, t in zip(aux_shapes, aux_types)]
        if grad_req == "null":
            args_grad = None
        else:
            args_grad = [nd.zeros(s, ctx=ctx, dtype=t) for s, t in zip(arg_shapes, arg_types)]
        return self.bind(ctx, args, args_grad=args_grad, grad_req=grad_req,
                         aux_states=aux_states, group2ctx=group2ctx,
                         shared_exec=shared_exec, compute_dtype=compute_dtype,
                         cast_exempt=cast_exempt)

    def bind(self, ctx, args, args_grad=None, grad_req="write", aux_states=None,
             group2ctx=None, shared_exec=None, compute_dtype=None, cast_exempt=()):
        """Bind the symbol to arrays; returns an :class:`~.executor.Executor`."""
        from .executor import Executor

        return Executor(self, ctx, args, args_grad, grad_req, aux_states,
                        group2ctx=group2ctx, shared_exec=shared_exec,
                        compute_dtype=compute_dtype, cast_exempt=cast_exempt)

    def eval(self, ctx=None, **kwargs):
        """Bind to the NDArrays ``kwargs`` (by argument name) on ``ctx``
        (default: the card), run one inference forward and return the
        outputs."""
        ex = self.bind(_context.resolve(ctx), kwargs)
        ex.forward()
        return ex.outputs

    def __repr__(self):
        name = self.name
        return "<Symbol %s>" % (name if name else "Grouped")


def _infer(sym, provided, kind, partial=False, known=None):
    """Run shape or type inference over the graph in topo order; with
    ``partial`` a node whose inference fails leaves its outputs None.
    ``known``, when given, is filled with every node's ``id -> [value of
    each output]``."""
    order = _topo_order(sym._entries)
    known = {} if known is None else known
    for node in order:
        if node.is_variable:
            val = provided.get(node.name)
            if val is None:
                # attrs declared on the Variable itself (Variable(shape=...))
                if kind == "shape" and node._extra_attrs.get("__shape__"):
                    val = tuple(ast.literal_eval(node._extra_attrs["__shape__"]))
                elif kind != "shape" and node._extra_attrs.get("__dtype__"):
                    val = np.dtype(node._extra_attrs["__dtype__"])
            known[id(node)] = [val]
    for node in order:
        if node.is_variable:
            continue
        op = get_op(node.op)
        in_vals = [None if known.get(id(inp)) is None else known[id(inp)][k]
                   for inp, k in node.inputs]
        n_args = len(op.arg_names(node.attrs))
        arg_vals, aux_vals = in_vals[:n_args], in_vals[n_args:]
        try:
            if kind == "shape":
                new_args, outs, new_aux = op.infer_shape(node.attrs, arg_vals, aux_vals)
            else:
                new_args, outs, _ = op.infer_type(node.attrs, arg_vals)
                # aux types default to the first arg's dtype
                new_aux = [v if v is not None else new_args[0] for v in aux_vals] \
                    if op.aux_names(node.attrs) else []
        except Exception as e:  # noqa: BLE001
            if partial:
                known[id(node)] = [None] * op.num_outputs(node.attrs)
                continue
            raise MXNetError(
                "%s inference failed at node %s(%s): %s" % (kind, node.op, node.name, e)
            ) from e
        # write back filled input values onto variables
        for (inp, k), v in zip(node.inputs, list(new_args) + list(new_aux)):
            if inp.is_variable and v is not None:
                prev = known[id(inp)][0]
                if kind == "shape" and prev is not None and tuple(prev) != tuple(v):
                    raise MXNetError("shape mismatch for %s: %s vs %s" % (inp.name, prev, v))
                known[id(inp)] = [v]
        known[id(node)] = list(outs)
    _, aux_vars = sym._arg_aux_split()
    args, auxs = [], []
    for node in order:
        if node.is_variable:
            (auxs if id(node) in aux_vars else args).append(known[id(node)][0])
    outs = [None if known.get(id(node)) is None else known[id(node)][k]
            for node, k in sym._entries]
    if kind == "shape" and not partial and any(
            v is None for v in args + outs + auxs):
        return None, None, None
    return args, outs, auxs


# ---- symbol creation ----------------------------------------------------
def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, **kwargs):
    """Create a variable symbol."""
    if not isinstance(name, str):
        raise TypeError("Expect a string for variable name")
    extra = AttrScope.current().get(attr or {})
    if shape is not None:
        extra["__shape__"] = str(tuple(shape))
    if lr_mult is not None:
        extra["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        extra["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        extra["__dtype__"] = str(np.dtype(dtype))
    if init is not None:
        # the initializer spec, dispatched by Module.init_params
        extra["__init__"] = init.dumps() if hasattr(init, "dumps") else str(init)
    extra.update({k: str(v) for k, v in kwargs.items()})
    return Symbol([(_Node(None, name, {}, [], extra), 0)])


var = Variable


def Group(symbols):
    """Group symbols into one multi-output symbol."""
    entries = []
    for s in symbols:
        entries.extend(s._entries)
    return Symbol(entries)


def load(fname):
    """Read a Symbol from a JSON file written by :meth:`Symbol.save` (or by
    the JAX package, or the reference)."""
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str):
    """Rebuild a Symbol from nnvm-format JSON."""
    data = json.loads(json_str)
    built = []
    for meta in data["nodes"]:
        attrs = meta.get("attrs", meta.get("param", {})) or {}
        # pre-NNVM files carry user attrs in a separate "attr" dict
        user_attrs = dict(meta.get("attr", {}) or {})
        if meta["op"] == "null":
            merged = dict(attrs)
            merged.update(user_attrs)
            node = _Node(None, meta["name"], {}, [], merged)
        else:
            cattrs, extra = get_op(meta["op"]).canonicalize_attrs(attrs)
            extra.update(user_attrs)
            inputs = [(built[i], k) for i, k, *_ in meta["inputs"]]
            node = _Node(meta["op"], meta["name"], cattrs, inputs, extra)
        built.append(node)
    heads = data.get("heads", [[len(built) - 1, 0, 0]])
    return Symbol([(built[i], k) for i, k, *_ in heads])


# ---- generated op constructors ------------------------------------------
def _create(op_name, sym_args, attrs, name=None, extra_attrs=None):
    op = get_op(op_name)
    cattrs, extra = op.canonicalize_attrs(attrs)
    extra.update(extra_attrs or {})
    extra = AttrScope.current().get(extra)
    name = NameManager.current().get(name, op_name.lower().lstrip("_"))
    inputs = []
    for i, aname in enumerate(op.arg_names(cattrs) + op.aux_names(cattrs)):
        if i < len(sym_args) and sym_args[i] is not None:
            s = sym_args[i]
            if not isinstance(s, Symbol):
                raise TypeError("op %s input %d must be Symbol, got %s" % (op_name, i, type(s)))
            inputs.append(s._entries[0])
        else:
            inputs.append((_Node(None, "%s_%s" % (name, aname), {}, []), 0))
    node = _Node(op_name, name, cattrs, inputs, extra)
    n_vis = op.num_visible_outputs(cattrs)
    return Symbol([(node, i) for i in range(builtins.max(1, n_vis))])


def _make_symbol_function(op_name):
    op = get_op(op_name)

    def fn(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        sym_args = list(args)
        attrs = {}
        sym_kwargs = {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                sym_kwargs[k] = v
            else:
                attrs[k] = v
        if op.key_var_num_args and op.key_var_num_args not in attrs:
            attrs[op.key_var_num_args] = builtins.max(len(sym_args) + len(sym_kwargs), 1)
        cattrs, _ = op.canonicalize_attrs(attrs)
        names = op.arg_names(cattrs) + op.aux_names(cattrs)
        ordered = sym_args + [None] * (len(names) - len(sym_args))
        for k, v in sym_kwargs.items():
            if k not in names:
                raise MXNetError("op %s: unknown input '%s' (expects %s)" % (op_name, k, names))
            ordered[names.index(k)] = v
        return _create(op_name, ordered, attrs, name=name, extra_attrs=attr)

    fn.__name__ = op_name
    fn.__doc__ = "Symbolic form of operator ``%s``." % op_name
    return fn


def _register_ops():
    """Import the op modules (they register at import) and make one
    constructor per op, plus the ``contrib`` namespace."""
    from .ops import (attention, contrib_ops, elemwise,  # noqa: F401
                      indexing, init_ops, loss, matrix, nn, optimizer_ops,
                      ordering, reduce, rnn_ops, sample, spatial)
    from . import operator  # noqa: F401 - registers Custom

    mod = sys.modules[__name__]
    contrib = types.SimpleNamespace()
    for op_name in list_ops():
        fn = _make_symbol_function(op_name)
        setattr(mod, op_name, fn)
        if op_name.startswith("_contrib_"):
            setattr(contrib, op_name[len("_contrib_"):], fn)
    mod.contrib = contrib
    from . import op_doc

    op_doc.attach_docs(mod, list_ops(), "symbolic")


_register_ops()


def zeros(shape, dtype=None, **kwargs):
    """A ``_zeros`` node (a 0 in ``shape`` is the unknown batch: 1,
    broadcast downstream)."""
    return _zeros(shape=shape, dtype=dtype, **kwargs)  # noqa: F821


def ones(shape, dtype=None, **kwargs):
    return _ones(shape=shape, dtype=dtype, **kwargs)  # noqa: F821


def arange(start, stop=None, step=1.0, repeat=1, name=None, dtype=None):
    return _arange(start=start, stop=stop, step=step, repeat=repeat,  # noqa: F821
                   name=name, dtype=dtype)


def _module_binary(lhs, rhs, op, scalar_op, rscalar_op=None):
    """A Symbol or a number on either side (a commutative op takes its
    scalar op for a number on the left)."""
    if isinstance(lhs, Symbol):
        if isinstance(rhs, Symbol):
            return _create(op, [lhs, rhs], {})
        return _create(scalar_op, [lhs], {"scalar": float(rhs)})
    if isinstance(rhs, Symbol):
        return _create(rscalar_op or scalar_op, [rhs], {"scalar": float(lhs)})
    raise TypeError("at least one operand must be a Symbol")


def pow(lhs, rhs):  # noqa: A001 - the reference's name
    return _module_binary(lhs, rhs, "_power", "_power_scalar", "_rpower_scalar")


def maximum(lhs, rhs):
    return _module_binary(lhs, rhs, "_maximum", "_maximum_scalar")


def minimum(lhs, rhs):
    return _module_binary(lhs, rhs, "_minimum", "_minimum_scalar")


def hypot(lhs, rhs):
    return _module_binary(lhs, rhs, "_hypot", "_hypot_scalar")
