"""Custom Python operators of the port (counterpart of
``mxnet_tpu/operator.py``; reference: python/mxnet/operator.py):
``CustomOp``/``CustomOpProp`` registered with :func:`register` and run by
the ``Custom`` op, and the legacy ``NumpyOp``/``NDArrayOp``.

The JAX package runs the user's Python through ``jax.pure_callback``
inside its compiled program. The port runs it eagerly: ``Custom`` is a
``torch.autograd.Function`` whose forward calls ``CustomOp.forward`` and
whose backward calls ``CustomOp.backward`` of the same operator
instance, on port NDArrays over the tensors' own device (``asnumpy``
reads them to the host; ``assign`` writes results back as ``req`` asks:
``"write"`` for every output, ``"write"`` for each input whose gradient
is wanted and ``"null"`` for the rest). A CUDA graph would replay
whatever that Python did when the graph was captured, so ``Module``
keeps a symbol holding a ``Custom`` node off its captured step
(``Module._fused_veto``).
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError, torch_dtype
from .ops.registry import _OP_REGISTRY, Operator

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered_operators",
           "NumpyOp", "NDArrayOp"]

_CUSTOM_REGISTRY = {}


class CustomOp:
    """Base class for custom operators (reference: operator.py:396)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as ``req`` asks."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise MXNetError("unknown req %s" % req)


class CustomOpProp:
    """Operator property: shapes, types and instantiation (reference:
    operator.py:442)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def list_outputs(self):
        return ["output"]

    def list_arguments(self):
        return ["data"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad():
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Register a ``CustomOpProp`` subclass as ``op_type`` ``reg_name``."""

    def _reg(prop_cls):
        _CUSTOM_REGISTRY[reg_name] = prop_cls
        return prop_cls

    return _reg


def get_all_registered_operators():
    return sorted(_CUSTOM_REGISTRY)


# ---------------------------------------------------------------------------
# the 'Custom' op (reference: src/operator/custom/custom.cc)
# ---------------------------------------------------------------------------
def _get_prop(attrs):
    op_type = attrs.get("op_type")
    if op_type is None:
        raise MXNetError("Custom op needs op_type attr")
    if op_type not in _CUSTOM_REGISTRY:
        raise MXNetError("Custom op type '%s' not registered" % op_type)
    kwargs = {k: v for k, v in attrs.items() if k != "op_type"}
    return _CUSTOM_REGISTRY[op_type](**kwargs)


def _nd(t):
    from .ndarray import NDArray

    return NDArray(t)


class _CustomFunction(torch.autograd.Function):
    """The user's forward and backward around autograd. Inputs: the prop,
    the training flag, the argument count, then the argument and aux
    tensors; outputs: the op's outputs, then its aux states after the
    forward (no gradient)."""

    @staticmethod
    def forward(ctx, prop, is_train, n_args, *tensors):
        args, auxs = tensors[:n_args], tensors[n_args:]
        in_shapes = [tuple(a.shape) for a in args]
        in_dtypes = [np.dtype(str(a.dtype).replace("torch.", "")) for a in args]
        _, out_shapes, _ = prop.infer_shape([list(s) for s in in_shapes])
        _, out_dtypes, _ = prop.infer_type(in_dtypes)
        device = args[0].device if args else None
        op = prop.create_operator(None, in_shapes, in_dtypes)
        outs = [_nd(torch.zeros(tuple(s), dtype=torch_dtype(d), device=device))
                for s, d in zip(out_shapes, out_dtypes)]
        aux_nd = [_nd(a.detach().clone()) for a in auxs]
        op.forward(is_train, ["write"] * len(outs), [_nd(a.detach()) for a in args],
                   outs, aux_nd)
        out_t = [o.data for o in outs]
        new_aux = [a.data for a in aux_nd]
        ctx.op, ctx.n_args, ctx.aux = op, n_args, aux_nd
        ctx.save_for_backward(*args, *out_t)
        ctx.mark_non_differentiable(*new_aux)
        return tuple(out_t + new_aux)

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        args, outs = saved[:ctx.n_args], saved[ctx.n_args:]
        g_out = [_nd(torch.zeros_like(o) if g is None else g.contiguous())
                 for g, o in zip(grads, outs)]
        req = ["write" if ctx.needs_input_grad[3 + i] else "null"
               for i in range(ctx.n_args)]
        in_grad = [_nd(torch.zeros_like(a)) for a in args]
        ctx.op.backward(req, g_out, [_nd(a) for a in args], [_nd(o) for o in outs],
                        in_grad, ctx.aux)
        n_aux = len(ctx.needs_input_grad) - 3 - ctx.n_args
        return ((None, None, None)
                + tuple(None if r == "null" else g.data for g, r in zip(in_grad, req))
                + (None,) * n_aux)


def _custom_forward(octx, attrs, args, auxs):
    prop = _get_prop(attrs)
    n_out = len(prop.list_outputs())
    res = _CustomFunction.apply(prop, bool(octx.is_train), len(args), *args, *auxs)
    return list(res[:n_out]), list(res[n_out:])


def _custom_infer_shape(attrs, in_shapes, aux_shapes):
    prop = _get_prop(attrs)
    ins, outs, auxs = prop.infer_shape([list(s) if s else None for s in in_shapes])
    return ([tuple(s) for s in ins], [tuple(s) for s in outs],
            [tuple(s) for s in auxs])


# Custom takes arbitrary attrs, handed to the prop's constructor
_OP_REGISTRY["Custom"] = Operator(
    "Custom",
    _custom_forward,
    arg_names=lambda attrs: _get_prop(attrs).list_arguments(),
    aux_names=lambda attrs: _get_prop(attrs).list_auxiliary_states(),
    num_outputs=lambda attrs: len(_get_prop(attrs).list_outputs()),
    infer_shape=_custom_infer_shape,
    keep_extras=True,
)


# ---------------------------------------------------------------------------
# the legacy python-op APIs (reference: operator.py:126 NumpyOp, :226
# NDArrayOp), adapted onto CustomOp
# ---------------------------------------------------------------------------
class _LegacyProp(CustomOpProp):
    def __init__(self, legacy):
        super().__init__(need_top_grad=legacy.need_top_grad_)
        self._legacy = legacy

    def list_arguments(self):
        return self._legacy.list_arguments()

    def list_outputs(self):
        return self._legacy.list_outputs()

    def infer_shape(self, in_shape):
        res = self._legacy.infer_shape(in_shape)
        return (res[0], res[1], []) if len(res) == 2 else res

    def create_operator(self, ctx, in_shapes, in_dtypes):
        legacy = self._legacy

        class _Adapter(CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                xs = [a.asnumpy() for a in in_data]
                ys = [o.asnumpy() for o in out_data]
                legacy.forward(in_data=xs, out_data=ys)
                for o, y in zip(out_data, ys):
                    self.assign(o, req[0], y)

            def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
                ograd = [g.asnumpy() for g in out_grad]
                xs = [a.asnumpy() for a in in_data]
                ys = [o.asnumpy() for o in out_data]
                igrad = [g.asnumpy() for g in in_grad]
                legacy.backward(out_grad=ograd, in_data=xs, out_data=ys,
                                in_grad=igrad)
                for g, r, v in zip(in_grad, req, igrad):
                    self.assign(g, r, v)

        return _Adapter()


class NumpyOp:
    """Legacy numpy custom op (reference: operator.py:126): subclass,
    implement forward/backward/list_*/infer_shape, and call the instance
    on symbols: ``op = MyOp(); y = op(x, name=...)``."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def need_top_grad(self):
        return self.need_top_grad_

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def forward(self, in_data, out_data):
        raise NotImplementedError

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError

    def __call__(self, *args, **kwargs):
        from . import symbol as sym_mod

        name = "numpy_op_%d" % id(self)
        if name not in _CUSTOM_REGISTRY:
            legacy = self
            _CUSTOM_REGISTRY[name] = lambda **kw: _LegacyProp(legacy)
        kwargs["op_type"] = name
        return sym_mod.Custom(*args, **kwargs)


NDArrayOp = NumpyOp  # the same Python-side contract
