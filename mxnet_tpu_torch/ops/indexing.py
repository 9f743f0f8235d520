"""Indexing ops of the port (counterpart of ``mxnet_tpu/ops/indexing.py``).

``Embedding`` and ``take``. Token ids and indices arrive as floats and
are truncated toward zero, as the JAX package's ``astype(int32)``. Out-of-range ids follow the
JAX package's ``jnp.take`` (default fill mode): an id in ``[-V, 0)``
wraps to ``id + V``, and any other id outside ``[0, V)`` yields a row of
NaN with no gradient. The gather reads a clamped index, so no id ever
reads outside the table, on the CPU or on the card, and nothing syncs
with the host to check them. ``take`` clips or wraps its indices into
range (``mode``), as ``jnp.take`` does. The rest of the file waits for
ROADMAP A4.
"""
from __future__ import annotations

import math

import torch

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
