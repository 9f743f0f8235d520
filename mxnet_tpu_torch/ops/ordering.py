"""Ordering ops of the port (counterpart of ``mxnet_tpu/ops/ordering.py``):
``topk``, ``sort`` and ``argsort``.

Ties come out as in the JAX package on the CPU and on the card alike.
``jax.lax.top_k`` puts the lower index first among equal values (also
for ``is_ascend``, which takes the top of ``-x``); ``torch.topk`` on
CUDA promises no order among ties, so the k are the head of a stable
sort. ``sort`` and ``argsort`` sort ascending (stably, as ``jnp.sort``
and ``jnp.argsort``) and flip for descending order, so descending ties
come out higher index first, as in the JAX package. Indices are floats
in the input's dtype, with no gradient; ``axis=None`` works on the
flattened input.
"""
from __future__ import annotations

import torch

from .registry import Param, register, register_simple


def _axis_or_none(v):
    if v in (None, "None", ""):
        return None
    return int(float(v))


def _topk_last(x, k, is_ascend):
    """(values, int64 indices) of the top ``k`` along the last axis."""
    vals, idx = torch.sort(x, dim=-1, descending=not is_ascend, stable=True)
    return vals[..., :k], idx[..., :k]


@register(
    "topk",
    arg_names=("data",),
    params={
        "axis": Param(_axis_or_none, -1),
        "k": Param.int(1),
        "ret_typ": Param.str("indices"),
        "is_ascend": Param.bool(False),
        "dtype": Param.dtype(None),
    },
    num_outputs=lambda attrs: 2 if attrs.get("ret_typ") == "both" else 1,
)
def _topk(octx, attrs, args, auxs):
    x = args[0]
    ax = attrs["axis"]
    k = attrs["k"] if attrs["k"] > 0 else (x.numel() if ax is None else x.shape[ax])
    if ax is None:
        vals, idx = _topk_last(x.reshape(-1), k, attrs["is_ascend"])
    else:
        ax = ax % x.dim()
        vals, idx = _topk_last(x.movedim(ax, -1), k, attrs["is_ascend"])
        vals, idx = vals.movedim(-1, ax), idx.movedim(-1, ax)
    rt = attrs["ret_typ"]
    if rt == "value":
        return [vals], []
    if rt == "both":
        return [vals, idx.to(x.dtype)], []
    if rt == "mask":
        # the JAX package's mask: one_hot of the indices over the depth
        # of the topk axis (the last for axis=None), summed over axis -2
        depth = x.shape[ax if ax is not None else -1]
        hot = idx[..., None] == torch.arange(depth, device=x.device)
        return [hot.to(x.dtype).sum(-2)], []
    return [idx.to(x.dtype)], []


def _sort(attrs, x):
    ax = attrs["axis"]
    if ax is None:
        x, ax = x.reshape(-1), -1
    out = torch.sort(x, dim=ax, stable=True)[0]
    return out if attrs["is_ascend"] else torch.flip(out, (ax,))


register_simple("sort", _sort, arg_names=("data",),
                params={"axis": Param(_axis_or_none, -1),
                        "is_ascend": Param.bool(True)})


def _argsort(attrs, x):
    ax = attrs["axis"]
    v = x.detach()
    if ax is None:
        v, ax = v.reshape(-1), -1
    idx = torch.argsort(v, dim=ax, stable=True)
    if not attrs["is_ascend"]:
        idx = torch.flip(idx, (ax,))
    return idx.to(x.dtype)


register_simple("argsort", _argsort, arg_names=("data",),
                params={"axis": Param(_axis_or_none, -1),
                        "is_ascend": Param.bool(True),
                        "dtype": Param.dtype(None)})
