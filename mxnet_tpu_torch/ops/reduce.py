"""Reductions of the port (counterpart of ``mxnet_tpu/ops/reduce.py``).

``sum`` (alias ``sum_axis``), ``mean``, ``prod``, ``max``/``min`` (aliases
``max_axis``/``min_axis``), ``nansum``, ``nanprod`` and ``norm``, with
MXNet's axis semantics: ``axis`` unset or ``()`` reduces over everything,
``keepdims`` keeps singleton axes, ``exclude`` reduces over the
complement. ``argmax``/``argmin``/``argmax_channel`` return indices as
floats in the input's dtype (ties go to the first index, as
``jnp.argmax``), with no gradient. ``broadcast_to`` (0 keeps the axis)
and ``broadcast_axis`` (alias ``broadcast_axes``). ``max``/``min``
split the gradient of a tie evenly, as the JAX package's reduction does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import parse_shape
from .registry import Param, register_simple


def _axis_param(default=None):
    def _parse(v):
        if v is None or (isinstance(v, str) and v.strip() in ("None", "")):
            return None
        if isinstance(v, (int, np.integer)):
            return (int(v),)
        return parse_shape(v)

    return Param(_parse, default)


def _norm_axes(axis, ndim, exclude=False):
    if axis is None or axis == ():
        return tuple(range(ndim)) if not exclude else ()
    axes = tuple(sorted(a % ndim for a in axis))
    if exclude:
        axes = tuple(a for a in range(ndim) if a not in axes)
    return axes


def _reduce(fn):
    def _apply(attrs, x):
        # an empty axis set reduces over everything, as the JAX package's
        # ``axis=axes if axes else None`` does
        axes = _norm_axes(attrs["axis"], x.dim(), attrs["exclude"]) \
            or tuple(range(x.dim()))
        return fn(x, dim=axes, keepdim=attrs["keepdims"])

    return _apply


def _prod(x, dim, keepdim):
    """The product over several axes (``torch.prod`` takes one)."""
    keep = [a for a in range(x.dim()) if a not in dim]
    out = x.permute(*keep, *dim).reshape([x.shape[a] for a in keep] + [-1])
    out = out.prod(-1)
    if keepdim:
        for a in dim:
            out = out.unsqueeze(a)
    return out


def _nanprod(x, dim, keepdim):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dim, keepdim)


for _name, _fn, _aliases in (("sum", torch.sum, ("sum_axis",)),
                             ("mean", torch.mean, ()),
                             ("prod", _prod, ()),
                             ("max", torch.amax, ("max_axis",)),
                             ("min", torch.amin, ("min_axis",)),
                             ("nansum", torch.nansum, ()),
                             ("nanprod", _nanprod, ())):
    register_simple(_name, _reduce(_fn), arg_names=("data",), params={
        "axis": _axis_param(None),
        "keepdims": Param.bool(False),
        "exclude": Param.bool(False),
    }, alias=_aliases)


def _argreduce(fn):
    def _apply(attrs, x):
        ax = attrs["axis"]
        ax = None if ax is None else int(ax[0])
        out = fn(x.detach(), dim=ax)
        if attrs["keepdims"] and ax is not None:
            out = out.unsqueeze(ax)
        return out.to(x.dtype)

    return _apply


for _name, _fn in (("argmax", torch.argmax), ("argmin", torch.argmin)):
    register_simple(_name, _argreduce(_fn), arg_names=("data",),
                    params={"axis": _axis_param(None), "keepdims": Param.bool(False)})

register_simple("argmax_channel",
                lambda attrs, x: torch.argmax(x.detach(), dim=1).to(x.dtype),
                arg_names=("data",))


def _norm(attrs, x):
    axes = (_norm_axes(attrs["axis"], x.dim()) if attrs["axis"] is not None
            else tuple(range(x.dim())))
    if attrs["ord"] == 1:
        return torch.sum(torch.abs(x), dim=axes, keepdim=attrs["keepdims"])
    return torch.sqrt(torch.sum(torch.square(x), dim=axes,
                                keepdim=attrs["keepdims"]))


register_simple("norm", _norm, arg_names=("data",),
                params={"ord": Param.int(2), "axis": _axis_param(None),
                        "keepdims": Param.bool(False)})

# ---- broadcasting shape ops -------------------------------------------------
register_simple(
    "broadcast_to",
    lambda attrs, x: x.expand(*[t if t != 0 else s
                                for t, s in zip(attrs["shape"], x.shape)]),
    arg_names=("data",), params={"shape": Param.shape(())})


def _broadcast_axis(attrs, x):
    axes = attrs["axis"] if isinstance(attrs["axis"], tuple) else (attrs["axis"],)
    sizes = attrs["size"] if isinstance(attrs["size"], tuple) else (attrs["size"],)
    target = list(x.shape)
    for a, n in zip(axes, sizes):
        target[a % x.dim()] = int(n)
    return x.expand(*target)


register_simple("broadcast_axis", _broadcast_axis, arg_names=("data",),
                params={"axis": _axis_param(()), "size": Param.shape(())},
                alias=("broadcast_axes",))
