"""Indexing ops of the port (counterpart of ``mxnet_tpu/ops/indexing.py``).

``Embedding`` and ``take``. Token ids and indices arrive as floats and
are truncated toward zero, as the JAX package's ``astype(int32)``. Out-of-range ids follow the
JAX package's ``jnp.take`` (default fill mode): an id in ``[-V, 0)``
wraps to ``id + V``, and any other id outside ``[0, V)`` yields a row of
NaN with no gradient. The gather reads a clamped index, so no id ever
reads outside the table, on the CPU or on the card, and nothing syncs
with the host to check them. ``take`` clips or wraps its indices into
range (``mode``), as ``jnp.take`` does.

``batch_take``, ``pick`` (alias ``choose_element_0index``),
``fill_element_0index``, ``one_hot``, ``gather_nd`` and ``scatter_nd``.
A negative index counts from the end, as numpy's; the gathers clamp
the index they read, so none reads outside its input. ``one_hot`` gives
an all-``off_value`` row for an index outside ``[0, depth)``, as
``jax.nn.one_hot`` does. ``scatter_nd`` adds where indices repeat
(the JAX package's ``.at[].add``). Indices carry no gradient.
"""
from __future__ import annotations

import math

import torch

from ..base import torch_dtype
from .registry import Param, get_op, register, register_simple


@register(
    "Embedding",
    arg_names=("data", "weight"),
    params={
        "input_dim": Param.int(),
        "output_dim": Param.int(),
        "dtype": Param.dtype(None),
    },
)
def _embedding(octx, attrs, args, auxs):
    ids, weight = args
    n = weight.shape[0]
    idx = ids.detach().to(torch.int64)
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    out = torch.nn.functional.embedding(idx.clamp(0, n - 1), weight)
    return [torch.where(valid[..., None], out, math.nan)], []


def _infer_embedding_shape(attrs, in_shapes, aux_shapes):
    data, weight = in_shapes
    w = (int(attrs["input_dim"]), int(attrs["output_dim"]))
    if weight is None:
        weight = w
    if data is None:
        raise ValueError("Embedding: data shape required")
    return [data, weight], [tuple(data) + (w[1],)], []


get_op("Embedding")._infer_shape = _infer_embedding_shape


def _take(attrs, a, indices):
    axis = attrs["axis"] % a.dim()
    n = a.shape[axis]
    idx = indices.detach().to(torch.int32).to(torch.int64)
    idx = idx.clamp(0, n - 1) if attrs["mode"] == "clip" else idx.remainder(n)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


register_simple(
    "take", _take, arg_names=("a", "indices"),
    params={"axis": Param.int(0), "mode": Param.str("clip")})



def _index(t, n=None):
    """Float indices as int64, truncated toward zero; with ``n``, a
    negative one counts from the end and all are clamped into range."""
    idx = t.detach().to(torch.int32).to(torch.int64)
    if n is None:
        return idx
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def _batch_take(attrs, a, indices):
    idx = _index(indices, a.shape[1])
    return a.gather(1, idx[:, None])[:, 0]


register_simple("batch_take", _batch_take, arg_names=("a", "indices"))


def _one_hot(attrs, indices):
    idx = _index(indices)
    depth = attrs["depth"]
    hot = (idx[..., None] == torch.arange(depth, device=idx.device)).to(torch.float32)
    on, off = attrs["on_value"], attrs["off_value"]
    dt = torch_dtype(attrs["dtype"] if attrs["dtype"] is not None else "float32")
    return (hot * (on - off) + off).to(dt)


register_simple(
    "one_hot", _one_hot, arg_names=("indices",),
    params={
        "depth": Param.int(),
        "on_value": Param.float(1.0),
        "off_value": Param.float(0.0),
        "dtype": Param.dtype(None),
    })


def _opt_int(v):
    return None if v in (None, "None", "") else int(float(v))


def _pick(attrs, data, index):
    ax = attrs["axis"]
    ax = data.dim() - 1 if ax is None else ax % data.dim()
    idx = _index(index, data.shape[ax])
    if idx.dim() < data.dim():
        idx = idx.unsqueeze(ax)
    out = data.gather(ax, idx)
    return out if attrs["keepdims"] else out.squeeze(ax)


register_simple("pick", _pick, arg_names=("data", "index"),
                params={"axis": Param(_opt_int, -1), "keepdims": Param.bool(False)},
                alias=("choose_element_0index",))


def _fill_element_0index(attrs, lhs, mhs, rhs):
    out = lhs.clone()
    rows = torch.arange(lhs.shape[0], device=lhs.device)
    out[rows, _index(rhs, lhs.shape[1])] = mhs.to(lhs.dtype)
    return out


register_simple("fill_element_0index", _fill_element_0index,
                arg_names=("lhs", "mhs", "rhs"))


def _nd_index(data_shape, indices):
    idx = _index(indices)
    return tuple(torch.where(idx[i] < 0, idx[i] + data_shape[i], idx[i])
                 .clamp(0, data_shape[i] - 1) for i in range(idx.shape[0]))


register_simple("gather_nd",
                lambda attrs, data, indices: data[_nd_index(data.shape, indices)],
                arg_names=("data", "indices"))


def _scatter_nd(attrs, data, indices):
    shape = tuple(attrs["shape"])
    out = torch.zeros(shape, dtype=data.dtype, device=data.device)
    return out.index_put(_nd_index(shape, indices), data, accumulate=True)


register_simple("scatter_nd", _scatter_nd, arg_names=("data", "indices"),
                params={"shape": Param.shape()})
