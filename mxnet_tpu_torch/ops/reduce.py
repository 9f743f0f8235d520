"""Reductions of the port (counterpart of ``mxnet_tpu/ops/reduce.py``).

``sum`` (alias ``sum_axis``) and ``mean``, with MXNet's axis semantics:
``axis`` unset or ``()`` reduces over everything, ``keepdims`` keeps
singleton axes, ``exclude`` reduces over the complement. The other reductions wait for ROADMAP A4.
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


for _name, _fn, _aliases in (("sum", torch.sum, ("sum_axis",)),
                             ("mean", torch.mean, ())):
    register_simple(_name, _reduce(_fn), arg_names=("data",), params={
        "axis": _axis_param(None),
        "keepdims": Param.bool(False),
        "exclude": Param.bool(False),
    }, alias=_aliases)
