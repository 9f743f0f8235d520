"""Operator registry of the port (counterpart of ``mxnet_tpu/ops/registry.py``).

Every op is a function of torch tensors,
``forward(opctx, attrs, args, auxs) -> (outputs, new_auxs)``. Gradients
come from ``torch.autograd`` over the same forward; an op whose gradient
is not the mathematical one (SoftmaxOutput) or that runs a hand-written
kernel (flash attention) wraps itself in a ``torch.autograd.Function``.

Attr parsing, defaults and the order in which they are filled in are
those of the JAX package, so a symbol's JSON is the same byte for byte
in both packages. Shape inference defaults to running the forward on
``meta`` tensors (PyTorch's abstract evaluation, the counterpart of
``jax.eval_shape``), with per-op overrides where unknown parameter shapes
are filled in from data shapes. The JAX package's ``fp32_precision`` has
no counterpart: the port turns TF32 off at import.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..base import MXNetError, parse_bool, parse_shape

__all__ = ["OpContext", "Operator", "register", "register_simple", "get_op",
           "has_op", "list_ops", "Param"]

_OP_REGISTRY = {}


class OpContext:
    """Per-invocation execution context handed to op forwards: the training
    flag, a ``torch.Generator`` for stochastic ops (None otherwise) and the
    device the graph runs on (where ops without inputs, ``_zeros`` and its
    kin, create their outputs; None is the CPU)."""

    __slots__ = ("is_train", "rng", "device")

    def __init__(self, is_train=False, rng=None, device=None):
        self.is_train = is_train
        self.rng = rng
        self.device = device


def _parse_dtype(v):
    if v is None or (isinstance(v, str) and v in ("None", "")):
        return None
    if str(v) == "bfloat16":
        return "bfloat16"      # numpy has no bfloat16; the name round-trips
    return np.dtype(v)


class Param:
    """Attr schema entry: a parser (from the JSON string form or a python
    value), a default, and a required flag."""

    __slots__ = ("parse", "default", "required", "kind")

    _REQUIRED = object()

    def __init__(self, parse, default=_REQUIRED, kind=None):
        self.parse = parse
        self.default = default
        self.required = default is Param._REQUIRED
        self.kind = kind or getattr(parse, "__name__", "value").replace("parse_", "")

    @staticmethod
    def shape(default=_REQUIRED):
        return Param(parse_shape, default, kind="shape")

    @staticmethod
    def int(default=_REQUIRED):
        return Param(lambda v: int(float(v)), default, kind="int")

    @staticmethod
    def float(default=_REQUIRED):
        return Param(float, default, kind="float")

    @staticmethod
    def bool(default=_REQUIRED):
        return Param(parse_bool, default, kind="boolean")

    @staticmethod
    def str(default=_REQUIRED):
        return Param(lambda v: str(v), default, kind="string")

    @staticmethod
    def dtype(default=_REQUIRED):
        return Param(_parse_dtype, default, kind="dtype")


class Operator:
    """A registered operator definition."""

    def __init__(self, name, forward, arg_names=("data",), aux_names=(),
                 num_outputs=1, output_names=None, params=None,
                 infer_shape=None, infer_type=None, stochastic=False,
                 key_var_num_args=None, num_visible_outputs=None, alias=(),
                 mutate_inputs=(), keep_extras=False):
        self.name = name
        self.forward = forward
        self._arg_names = arg_names
        self._aux_names = aux_names
        self._num_outputs = num_outputs
        self._output_names = output_names
        self.params = params or {}
        self._infer_shape = infer_shape
        self._infer_type = infer_type
        self._stochastic = stochastic
        self.key_var_num_args = key_var_num_args
        self._num_visible_outputs = num_visible_outputs
        self.alias = alias
        #: the reference's FMutateInputs: the argument positions that an
        #: imperative call overwrites in place with the op's outputs after
        #: the visible ones, in order (an optimizer update's states)
        self.mutate_inputs = tuple(mutate_inputs)
        #: loss heads: the executor seeds their head gradient with ones
        self.is_loss = False
        #: an op with open-ended attrs (``Custom`` hands them to the user's
        #: prop): unknown attrs stay in its params, not on the node
        self.keep_extras = keep_extras

    # ---- introspection ---------------------------------------------------
    def stochastic(self, attrs):
        """Whether a node with these attrs draws random numbers."""
        st = self._stochastic
        return bool(st(attrs)) if callable(st) else bool(st)

    def arg_names(self, attrs):
        a = self._arg_names
        return list(a(attrs)) if callable(a) else list(a)

    def aux_names(self, attrs):
        a = self._aux_names
        return list(a(attrs)) if callable(a) else list(a)

    def num_outputs(self, attrs):
        n = self._num_outputs
        return n(attrs) if callable(n) else n

    def num_visible_outputs(self, attrs):
        n = self._num_visible_outputs
        if n is None:
            return self.num_outputs(attrs)
        return n(attrs) if callable(n) else n

    def output_names(self, attrs):
        o = self._output_names
        if o is None:
            n = self.num_outputs(attrs)
            return ["output"] if n == 1 else ["output%d" % i for i in range(n)]
        return list(o(attrs)) if callable(o) else list(o)

    # ---- attrs -----------------------------------------------------------
    def canonicalize_attrs(self, raw):
        """Parse raw attrs (strings from JSON or python values) against the
        schema. Unknown keys (graph attrs such as ``__key__``/``ctx_group``)
        come back separately; they live on the node, not in the params."""
        out = {}
        extra = {}
        for k, v in (raw or {}).items():
            if k in self.params:
                try:
                    out[k] = self.params[k].parse(v)
                except Exception as e:  # noqa: BLE001
                    raise MXNetError(
                        "op %s: cannot parse attr %s=%r: %s" % (self.name, k, v, e)
                    ) from e
            else:
                extra[k] = v
        for k, p in self.params.items():
            if k not in out:
                if p.required:
                    raise MXNetError("op %s: required attr '%s' missing" % (self.name, k))
                out[k] = p.default
        if self.keep_extras:
            # graph attrs (__key__, ctx_group) still go on the node
            node_attrs = {k: v for k, v in extra.items()
                          if k.startswith("__") or k == "ctx_group"}
            out.update({k: v for k, v in extra.items() if k not in node_attrs})
            return out, node_attrs
        return out, extra

    # ---- inference -------------------------------------------------------
    def infer_shape(self, attrs, in_shapes, aux_shapes=None):
        """Return (in_shapes, out_shapes, aux_shapes); fills unknown (None)
        entries where the op's own rule can. Default: all inputs known, the
        forward run on ``meta`` tensors."""
        if self._infer_shape is not None:
            return self._infer_shape(attrs, list(in_shapes), list(aux_shapes or []))
        if any(s is None for s in in_shapes):
            raise MXNetError(
                "op %s: cannot infer shapes with unknown inputs %s" % (self.name, in_shapes)
            )
        out_shapes, aux_s = self.abstract_eval(attrs, list(in_shapes),
                                               list(aux_shapes or []))
        return list(in_shapes), out_shapes, aux_s

    def infer_type(self, attrs, in_dtypes):
        """Return (in_dtypes, out_dtypes, aux_dtypes) with Nones filled by
        propagating the first known dtype (the reference's elemwise rule)."""
        if self._infer_type is not None:
            return self._infer_type(attrs, list(in_dtypes))
        known = [d for d in in_dtypes if d is not None]
        fill = known[0] if known else np.dtype(np.float32)
        in_dtypes = [d if d is not None else fill for d in in_dtypes]
        out_dt = in_dtypes[0] if in_dtypes else np.dtype(np.float32)
        return in_dtypes, [out_dt] * self.num_outputs(attrs), []

    def abstract_eval(self, attrs, in_shapes, aux_shapes):
        """The forward on ``meta`` float32 tensors: (out_shapes, aux_shapes)."""
        def meta(s):
            return torch.empty(tuple(s), dtype=torch.float32, device="meta")

        with torch.no_grad():
            outs, new_auxs = self.forward(OpContext(is_train=True,
                                                    device="meta"),
                                          attrs, [meta(s) for s in in_shapes],
                                          [meta(s) for s in aux_shapes])
        return [tuple(o.shape) for o in outs], [tuple(a.shape) for a in new_auxs]


def register(name, **kwargs):
    """Register operator ``name`` with the decorated forward."""

    def _reg(fn):
        op = Operator(name, fn, **kwargs)
        _OP_REGISTRY[name] = op
        for a in op.alias:
            _OP_REGISTRY[a] = op
        return fn

    return _reg


def register_simple(name, fn, arg_names=("data",), params=None, **kwargs):
    """Register a stateless op from ``fn(attrs, *tensors) -> tensor-or-list``."""

    @functools.wraps(fn)
    def _fwd(octx, attrs, args, auxs):
        out = fn(attrs, *args)
        if not isinstance(out, (list, tuple)):
            out = [out]
        return list(out), []

    op = Operator(name, _fwd, arg_names=arg_names, params=params, **kwargs)
    _OP_REGISTRY[name] = op
    for a in op.alias:
        _OP_REGISTRY[a] = op
    return op


def get_op(name):
    try:
        return _OP_REGISTRY[name]
    except KeyError:
        raise MXNetError("Operator '%s' is not registered" % name) from None


def has_op(name):
    return name in _OP_REGISTRY


def list_ops():
    return sorted(_OP_REGISTRY.keys())

