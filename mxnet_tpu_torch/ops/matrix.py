"""Shape ops of the port (counterpart of ``mxnet_tpu/ops/matrix.py``).

``Reshape``, with MXNet's special target codes (0 keep, -1 infer, -2
copy the rest, -3 merge two, -4 split one) and ``reverse``, ``Flatten``,
``transpose``, ``expand_dims``, ``SwapAxis``, ``Concat``, ``stack``,
``SliceChannel`` (alias ``split``; one node with ``num_outputs``
outputs), ``squeeze``, ``flip``, ``repeat``, ``tile``, ``where``; the
products ``dot`` and ``batch_dot`` (alias ``linalg_gemm2``); slicing
(``slice`` with ``None`` bounds, ``slice_axis``), the slice and crop
assignments, ``Crop`` and ``Pad``.

``dot`` is ``jnp.dot``, as in the JAX package: the last axis of ``lhs``
with the second-to-last of ``rhs`` (the first when ``rhs`` is 2-d, the
reference's rule; past 2-d the two differ, ``ROADMAP.md`` C8), and
``transpose_a``/``transpose_b`` reverse every axis. Products run in full
float32 (``torch.matmul``; TF32 is off in the port), as the JAX package
asks XLA for HIGHEST precision.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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


def _transpose(attrs, x):
    axes = attrs["axes"]
    if axes is None or axes == ():
        axes = tuple(reversed(range(x.dim())))
    return x.permute(*axes)


register_simple("transpose", _transpose, arg_names=("data",),
                params={"axes": Param.shape(())})


# ---- products -------------------------------------------------------------
def _rev(x):
    return x.permute(*reversed(range(x.dim())))


def _dot(attrs, lhs, rhs):
    a = _rev(lhs) if attrs["transpose_a"] else lhs
    b = _rev(rhs) if attrs["transpose_b"] else rhs
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    # numpy's dot: a's last axis against b's second-to-last (or only) one
    return torch.tensordot(a, b, dims=([a.dim() - 1], [max(b.dim() - 2, 0)]))


def _batch_dot(attrs, lhs, rhs):
    a = lhs.transpose(-1, -2) if attrs["transpose_a"] else lhs
    b = rhs.transpose(-1, -2) if attrs["transpose_b"] else rhs
    return torch.matmul(a, b)


_DOT_PARAMS = {"transpose_a": Param.bool(False), "transpose_b": Param.bool(False)}
register_simple("dot", _dot, arg_names=("lhs", "rhs"), params=dict(_DOT_PARAMS))
register_simple("batch_dot", _batch_dot, arg_names=("lhs", "rhs"),
                params=dict(_DOT_PARAMS), alias=("linalg_gemm2",))


# ---- slicing ----------------------------------------------------------------
def _parse_shape_opt(v):
    """A shape that may hold ``None`` entries: ``(None, 2)``."""
    if v is None:
        return ()
    if isinstance(v, (tuple, list)):
        return tuple(None if e is None else int(e) for e in v)
    s = str(v).strip().strip("()[]")
    if not s:
        return ()
    return tuple(None if tok.strip() == "None" else int(float(tok))
                 for tok in s.split(","))


def _region(attrs, shape):
    """The python slices of ``begin``/``end`` (``None``: the whole axis)."""
    begin, end = attrs["begin"], attrs["end"]
    idx = []
    for i in range(len(shape)):
        b = begin[i] if i < len(begin) and begin[i] is not None else 0
        e = end[i] if i < len(end) and end[i] is not None else shape[i]
        idx.append(slice(b, e))
    return tuple(idx)


_REGION_PARAMS = {"begin": Param(_parse_shape_opt), "end": Param(_parse_shape_opt)}
register_simple("slice", lambda attrs, x: x[_region(attrs, x.shape)],
                arg_names=("data",), params=dict(_REGION_PARAMS),
                alias=("crop_like_slice",))


def _opt_int(v):
    return None if v in (None, "None", "") else int(float(v))


def _slice_axis(attrs, x):
    ax = attrs["axis"] % x.dim()
    b, e = attrs["begin"], attrs["end"]
    if e is None:
        e = x.shape[ax]
    if b < 0:
        b += x.shape[ax]
    if e < 0:
        e += x.shape[ax]
    sl = [slice(None)] * x.dim()
    sl[ax] = slice(b, e)
    return x[tuple(sl)]


register_simple("slice_axis", _slice_axis, arg_names=("data",),
                params={"axis": Param.int(), "begin": Param.int(0),
                        "end": Param(_opt_int, None)})


def _slice_assign(attrs, lhs, rhs):
    out = lhs.clone()
    out[_region(attrs, lhs.shape)] = rhs.to(lhs.dtype)
    return out


def _crop_assign_scalar(attrs, x):
    out = x.clone()
    out[_region(attrs, x.shape)] = attrs["scalar"]
    return out


register_simple("_slice_assign", _slice_assign, arg_names=("lhs", "rhs"),
                params=dict(_REGION_PARAMS), alias=("_crop_assign",))
register_simple("_crop_assign_scalar", _crop_assign_scalar, arg_names=("data",),
                params=dict(_REGION_PARAMS, scalar=Param.float(0.0)),
                alias=("_slice_assign_scalar",))


# ---- reordering and repetition ----------------------------------------------
def _reverse(attrs, x):
    axes = attrs["axis"] if isinstance(attrs["axis"], tuple) else (attrs["axis"],)
    return torch.flip(x, axes)


register_simple("reverse", _reverse, arg_names=("data",),
                params={"axis": Param.shape(())}, alias=("flip",))
register_simple("tile", lambda attrs, x: x.tile(attrs["reps"]),
                arg_names=("data",), params={"reps": Param.shape()})


def _repeat(attrs, x):
    ax = attrs["axis"]
    if ax is None:      # jnp.repeat flattens first
        return torch.repeat_interleave(x.reshape(-1), attrs["repeats"])
    return torch.repeat_interleave(x, attrs["repeats"], dim=ax)


register_simple("repeat", _repeat, arg_names=("data",),
                params={"repeats": Param.int(), "axis": Param(_opt_int, None)})


@register(
    "stack",
    arg_names=lambda attrs: ["arg%d" % i for i in range(int(attrs.get("num_args", 1)))],
    params={"num_args": Param.int(1), "axis": Param.int(0)},
    key_var_num_args="num_args",
)
def _stack(octx, attrs, args, auxs):
    return [torch.stack(args, dim=attrs["axis"])], []


def _squeeze(attrs, x):
    if attrs["axis"] == ():
        return x.squeeze()
    return x.squeeze(tuple(attrs["axis"]))


register_simple("squeeze", _squeeze, arg_names=("data",),
                params={"axis": Param.shape(())})
register_simple("where",
                lambda attrs, cond, x, y: torch.where(cond.detach() != 0, x, y),
                arg_names=("condition", "x", "y"))


# ---- Pad ---------------------------------------------------------------------
def _pad_index(n, before, after, mode, device):
    """Source index of each position of an axis padded by edge or reflect
    (numpy's modes: reflect mirrors without repeating the edge)."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = i.abs() % period
    return torch.where(j >= n, period - j, j)


def _pad(attrs, x):
    pw = attrs["pad_width"]
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(x.dim())]
    mode = attrs["mode"]
    if mode == "constant":
        flat = [p for pair in reversed(pairs) for p in pair]
        return F.pad(x, flat, value=attrs["constant_value"])
    if mode not in ("edge", "reflect"):
        raise MXNetError("Pad: unknown mode %s" % mode)
    for ax, (before, after) in enumerate(pairs):
        if before or after:
            x = x.index_select(ax, _pad_index(x.shape[ax], before, after,
                                              mode, x.device))
    return x


register_simple("Pad", _pad, arg_names=("data",),
                params={"pad_width": Param.shape(),
                        "mode": Param.str("constant"),
                        "constant_value": Param.float(0.0)},
                alias=("pad",))


# ---- Crop --------------------------------------------------------------------
@register(
    "Crop",
    arg_names=lambda attrs: ["arg%d" % i for i in range(int(attrs.get("num_args", 1)))],
    params={
        "num_args": Param.int(1),
        "offset": Param.shape((0, 0)),
        "h_w": Param.shape((0, 0)),
        "center_crop": Param.bool(False),
    },
    key_var_num_args="num_args",
)
def _crop(octx, attrs, args, auxs):
    x = args[0]
    if len(args) == 2:
        th, tw = args[1].shape[2], args[1].shape[3]
    else:
        th, tw = attrs["h_w"]
    if attrs["center_crop"]:
        oh, ow = (x.shape[2] - th) // 2, (x.shape[3] - tw) // 2
    else:
        oh, ow = attrs["offset"]
    return [x[:, :, oh:oh + th, ow:ow + tw]], []
