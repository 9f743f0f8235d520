"""Shape ops of the port (counterpart of ``mxnet_tpu/ops/matrix.py``).

``Reshape``, with MXNet's special target codes (0 keep, -1 infer, -2
copy the rest, -3 merge two, -4 split one) and ``reverse``, ``Flatten``,
and what the ``mx.rnn`` cells build their graphs from: ``expand_dims``,
``SwapAxis``, ``Concat`` and ``SliceChannel`` (alias ``split``; one node
with ``num_outputs`` outputs). The rest of the file waits for ROADMAP A4.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .registry import Param, register, register_simple


def mx_reshape(shape, target, reverse=False):
    """Implement MXNet Reshape's 0/-1/-2/-3/-4 codes on a concrete shape."""
    src = list(shape)
    if reverse:
        src = src[::-1]
        target = tuple(reversed(target))
    out = []
    src_i = 0
    i = 0
    target = list(target)
    while i < len(target):
        t = target[i]
        if t == 0:
            out.append(src[src_i])
            src_i += 1
        elif t == -1:
            out.append(-1)
            src_i += 1
        elif t == -2:
            out.extend(src[src_i:])
            src_i = len(src)
        elif t == -3:
            out.append(src[src_i] * src[src_i + 1])
            src_i += 2
        elif t == -4:
            d1, d2 = target[i + 1], target[i + 2]
            cur = src[src_i]
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            src_i += 1
            i += 2
        else:
            out.append(t)
            src_i += 1
        i += 1
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1])) if len(out) > 1 else 1
        total = int(np.prod(shape)) if shape else 1
        out[out.index(-1)] = total // max(known, 1)
    if reverse:
        out = out[::-1]
    return tuple(int(d) for d in out)


def _reshape(attrs, x):
    target = attrs["shape"]
    if target is None or target == ():
        ts = attrs.get("target_shape")     # the legacy attr
        if ts:
            return x.reshape(ts)
        raise MXNetError("Reshape: shape required")
    return x.reshape(mx_reshape(tuple(x.shape), target, attrs["reverse"]))


register_simple(
    "Reshape",
    _reshape,
    arg_names=("data",),
    params={
        "shape": Param.shape(()),
        "reverse": Param.bool(False),
        "target_shape": Param.shape(()),
        "keep_highest": Param.bool(False),
    },
    alias=("reshape",),
)

register_simple(
    "Flatten",
    lambda attrs, x: x.reshape(x.shape[0], -1),
    arg_names=("data",),
    alias=("flatten",),
)

register_simple(
    "expand_dims",
    lambda attrs, x: x.unsqueeze(attrs["axis"]),
    arg_names=("data",),
    params={"axis": Param.int()},
)

register_simple(
    "SwapAxis",
    lambda attrs, x: x.transpose(attrs["dim1"], attrs["dim2"]),
    arg_names=("data",),
    params={"dim1": Param.int(0), "dim2": Param.int(0)},
    alias=("swapaxes",),
)


@register(
    "Concat",
    arg_names=lambda attrs: ["arg%d" % i for i in range(int(attrs.get("num_args", 1)))],
    params={"num_args": Param.int(1), "dim": Param.int(1)},
    key_var_num_args="num_args",
    alias=("concat",),
)
def _concat(octx, attrs, args, auxs):
    return [torch.cat(args, dim=attrs["dim"])], []


@register(
    "SliceChannel",
    arg_names=("data",),
    params={"num_outputs": Param.int(), "axis": Param.int(1),
            "squeeze_axis": Param.bool(False)},
    num_outputs=lambda attrs: int(attrs["num_outputs"]),
    output_names=lambda attrs: ["output%d" % i for i in range(int(attrs["num_outputs"]))],
    alias=("split",),
)
def _slice_channel(octx, attrs, args, auxs):
    x = args[0]
    n, axis = attrs["num_outputs"], attrs["axis"]
    if x.shape[axis] % n:
        raise MXNetError("SliceChannel: axis %d of %s does not split into %d "
                         "equal parts" % (axis, tuple(x.shape), n))
    parts = x.chunk(n, dim=axis)
    if attrs["squeeze_axis"]:
        parts = [p.squeeze(axis) for p in parts]
    return list(parts), []
