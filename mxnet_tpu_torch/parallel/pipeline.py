"""Pipeline parallelism (pp): GPipe microbatch pipelining over a mesh axis
(counterpart of ``mxnet_tpu/parallel/pipeline.py``).

Stages sit on the positions of the ``pp`` axis, and activations go from
stage to stage by explicit copies (:func:`.collectives.transfer`). The
schedule is GPipe's fill, steady and drain over ``M + S - 1`` ticks: at
tick ``t`` stage ``s`` runs microbatch ``t - s``. The JAX package runs
every stage on every tick and masks the fill and drain ticks away; the
port runs stage ``s`` only on ticks with a real microbatch
(``0 <= t - s < M``), which computes the same function. Backward is
autograd through the stages and the copies: one ``backward`` gives the
gradients of the whole schedule.

Stages may be heterogeneous: a list of stage functions over per-stage
parameter trees (replicated: each position reads its own stage's). With
one shared stage function the parameter leaves are stacked with leading
axis ``S`` and sharded over the axis (each stage holds its slice). Stage
0 takes the raw microbatch; the activations between stages, and so the
outputs, have one shape (``carry_shape``).
"""
from __future__ import annotations

import torch

from ..base import torch_dtype
from . import collectives as C

__all__ = ["pipeline_apply"]


def _as_tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _to_device(x, device):
    """``x`` on ``device``: itself where it lies there (parameters are read
    only in a stage), else a counted copy."""
    return C.to_position(_as_tensor(x), device)


def pipeline_apply(stage_fn, stage_params, xs, mesh, axis="pp",
                   carry_shape=None, carry_dtype=None):
    """Run ``S`` pipeline stages over mesh axis ``axis`` on ``M``
    microbatches ``xs`` (a tensor of leading size ``M``).

    ``stage_fn`` is one callable ``(params, x) -> y`` shared by all stages
    (``stage_params`` a tree of tensors with leading axis ``S``, stage
    ``s`` taking index ``s``), or a list of ``S`` callables
    (``stage_params`` a list of ``S`` trees). ``carry_shape``/
    ``carry_dtype`` describe one activation between stages (default: one
    microbatch's). Returns the ``(M,) + carry_shape`` outputs of the last
    stage on position 0's device."""
    S = mesh.shape[axis]
    if len(mesh.groups(axis)) != 1:
        raise ValueError("pipeline_apply runs over a 1-D mesh of its '%s' "
                         "axis" % axis)
    heterogeneous = isinstance(stage_fn, (list, tuple))
    if heterogeneous and len(stage_fn) != S:
        raise ValueError("got %d stage fns for a %d-way '%s' mesh axis"
                         % (len(stage_fn), S, axis))
    xs = _as_tensor(xs)
    M = xs.shape[0]
    carry_shape = tuple(xs.shape[1:] if carry_shape is None else carry_shape)
    dtype = torch_dtype(xs.dtype if carry_dtype is None else carry_dtype)
    devices = mesh.device_list
    if heterogeneous:
        params = [C.tree_map(lambda a, d=devices[s]: _to_device(a, d),
                             stage_params[s]) for s in range(S)]
        fns = list(stage_fn)
    else:
        params = [C.tree_map(lambda a, s=s: _to_device(_as_tensor(a)[s],
                                                       devices[s]),
                             stage_params) for s in range(S)]
        fns = [stage_fn] * S
    outs = [None] * M
    carry = {}   # stage -> the activation it takes on this tick
    for t in range(M + S - 1):
        nxt = {}
        for s in range(S):
            m = t - s
            if not 0 <= m < M:
                continue
            if s == 0:
                x = _to_device(xs[m], devices[0])
                if not heterogeneous:
                    x = x.to(dtype)
            else:
                x = carry[s]
            y = fns[s](params[s], x)
            if tuple(y.shape) != carry_shape:
                raise ValueError("stage %d returned %s, the carry is %s"
                                 % (s, tuple(y.shape), carry_shape))
            if s == S - 1:
                outs[m] = _to_device(y.to(dtype), devices[0])
            else:
                nxt[s + 1] = C.transfer(y, devices[s + 1])
        carry = nxt
    return torch.stack(outs)
