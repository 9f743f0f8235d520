"""A graph run over the positions of a mesh with the batch cut on one axis
(port only; the JAX package gets this from XLA's SPMD partitioner).

The JAX package's fused step jits the global-batch function over a mesh
with the batch sharded ``P("dp")``; the partitioner makes every op compute
what it computes on the global batch. The port runs the graph once per
position on that position's contiguous block of the batch, node by node
(:class:`DPGraph`), and decides per node how:

* **local** — the op runs at each position on its block. That is right
  for every op whose output rows depend only on the same rows of its
  inputs, and for every op none of whose inputs holds the batch.
* **dp** — the op has a data-parallel form (:data:`DP_FORMS`) that
  exchanges what the global batch needs: ``BatchNorm`` sums its
  per-channel sums and sums of squares over the batch axis
  (:func:`.collectives.psum`, differentiable, so the gradient flows back
  through the exchange), and the loss heads ``SoftmaxOutput`` and
  ``MakeLoss`` divide by the global count under ``normalization='batch'``
  or ``'valid'`` (``ignore_label`` included).
* **global** — an op that draws random numbers (``Dropout``, the
  sampling ops, ``rrelu``, the ``RNN`` op's dropout) runs once, at
  position 0, on the global batch joined from its group, and each
  position gets its block: the step draws what the one-position step
  draws from the same generator state, in the same order.

Which axis of each value holds the batch comes from shape inference at
the global and at the per-position input shapes: the one axis whose size
differs, by the batch axis's size, is the batch's; none means the value
is the same at every position. A node is refused (:class:`MXNetError`,
naming the op and the node) when its inputs hold the batch and

* an output does not (the op reduces over the batch axis: ``sum``,
  ``mean``, ``softmax_cross_entropy``, ... without ``axis``), or
* the shapes do not say where the batch goes, or
* the op mixes rows along the batch's axis (:data:`MIXERS`: a softmax,
  sort or scan along it, an ``RNN`` whose time axis it is, ...).

:data:`MIXERS` is what running every op of the registry both ways on the
CPU (the global batch, and two blocks joined) found
(``tests/test_torch_spmd_dp.py``). Nothing is computed per position in
silence.
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import MXNetError
from ..executor import graph_plan
from ..ops.registry import OpContext, get_op
from ..symbol import _infer
from . import collectives as C

__all__ = ["DPGraph", "batch_axis_of", "classify", "DP_FORMS", "MIXERS"]

_UNKNOWN = "unknown"


def batch_axis_of(global_shape, local_shape, n):
    """The axis of a value that holds the batch, from its shape at the
    global and at the per-position (1/``n``) batch: an int, None (the
    value holds no batch: the same at every position) or ``"unknown"``."""
    if global_shape is None or local_shape is None \
            or len(global_shape) != len(local_shape):
        return _UNKNOWN
    diff = [i for i, (g, l) in enumerate(zip(global_shape, local_shape))
            if g != l]
    if not diff:
        return None
    if len(diff) == 1 and global_shape[diff[0]] == n * local_shape[diff[0]]:
        return diff[0]
    return _UNKNOWN


def node_shapes(symbol, shapes):
    """``id(node) -> [shape of each output]`` at the given input shapes
    (None where inference cannot tell)."""
    known = {}
    _infer(symbol, dict(shapes), "shape", partial=True, known=known)
    return known


# ---------------------------------------------------------------- mixers
def _along(key, default):
    """The op mixes rows along its ``key`` attribute's axis."""
    def mixes(attrs, in_axes, ndims):
        ax = attrs.get(key, default)
        nd = ndims[0]
        if ax is None or not nd:
            return True
        axes = ax if isinstance(ax, (tuple, list)) else (ax,)
        return in_axes[0] in {int(a) % nd for a in axes}
    return mixes


def _always(attrs, in_axes, ndims):
    return True


def _rnn(attrs, in_axes, ndims):
    # data is (T, N, C): the recurrence runs along axis 0
    return in_axes[0] == 0


def _tiled(attrs, in_axes, ndims):
    # reps align with the input's trailing axes: a rep over 1 on the
    # batch's axis interleaves the positions' copies
    reps = tuple(attrs.get("reps") or ())
    k = len(reps) - ndims[0] + in_axes[0]
    return 0 <= k < len(reps) and reps[k] != 1


def _repeated(attrs, in_axes, ndims):
    # without an axis the input is flattened first: only a leading batch
    # stays in contiguous blocks
    return attrs.get("axis") is None and in_axes[0] != 0


def _sliced(attrs, in_axes, ndims):
    # begin/end name a window along the batch's axis
    a = in_axes[0]
    begin, end = tuple(attrs.get("begin") or ()), tuple(attrs.get("end") or ())
    if a >= max(len(begin), len(end)):
        return False
    b = begin[a] if a < len(begin) else None
    e = end[a] if a < len(end) else None
    return (b not in (None, 0)) or e is not None


def _softmax_output(attrs, in_axes, ndims):
    # the forward's softmax runs along axis 1 (multi_output), the last
    # axis (preserve_shape) or every axis but 0
    a = in_axes[0]
    if attrs.get("multi_output"):
        return a == 1
    if attrs.get("preserve_shape"):
        return a == ndims[0] - 1
    return a != 0


#: op (by its registered name, not an alias) -> predicate(attrs, input
#: batch axes, input ndims): True where the op mixes rows along the
#: batch's axis. Ops whose output loses the batch axis are refused before
#: these are asked.
MIXERS = {
    "softmax": _along("axis", -1),
    "log_softmax": _along("axis", -1),
    "SoftmaxOutput": _softmax_output,
    "SoftmaxActivation": lambda a, ax, nd: (ax[0] == 1 if a.get("mode") == "channel"
                                            else ax[0] != 0),
    "sort": _along("axis", -1),
    "argsort": _along("axis", -1),
    "topk": _along("axis", -1),
    "reverse": _along("axis", 0),
    "RNN": _rnn,
    "L2Normalization": lambda a, ax, nd: ax[0] != 0,
    "InstanceNorm": lambda a, ax, nd: ax[0] != 0,
    "LRN": lambda a, ax, nd: ax[0] == 1,
    "SequenceLast": _along("axis", 0),
    "SequenceMask": _along("axis", 0),
    "SequenceReverse": _along("axis", 0),
    "Concat": _along("dim", 1),
    "SliceChannel": _along("axis", 1),
    "slice_axis": _along("axis", 0),
    "repeat": _repeated,
    "tile": _tiled,
    "pick": _along("axis", -1),
    "IdentityAttachKLSparseReg": _always,
    # its data-parallel form sums statistics per channel: the batch must
    # lie on another axis than the channels
    "BatchNorm": _along("axis", 1),
    "_crop_assign_scalar": _sliced,
    "_slice_assign": _sliced,
    "slice": _sliced,
}


# ---------------------------------------------------------------- dp forms
def _batch_norm_dp(g, node, ins_pp, aux_pp, is_train):
    """``BatchNorm`` over the global batch: the per-channel sums and sums
    of squares summed over the batch axis in one exchange, then the
    JAX package's one-pass statistics (``ops/nn.py`` ``_batch_norm``)."""
    attrs = node.attrs
    if not is_train or attrs["use_global_stats"]:
        return g.local(node, ins_pp, aux_pp, is_train)
    x0 = ins_pp[0][0]
    ax = attrs["axis"] % x0.dim()
    red = tuple(i for i in range(x0.dim()) if i != ax)
    count = float(x0.numel() // x0.shape[ax]) * g.n
    parts = [torch.stack([torch.sum(ins[0], dim=red, dtype=torch.float32),
                          torch.sum(torch.square(ins[0].float()), dim=red)])
             for ins in ins_pp]
    sums = C.psum(parts, g.mesh, g.axis)
    outs_pp, aux_out = [], []
    m = attrs["momentum"]
    for (x, gamma, beta), (mmean, mvar), tot in zip(ins_pp, aux_pp, sums):
        bshape = tuple(x.shape[ax] if i == ax else 1 for i in range(x.dim()))
        if attrs["fix_gamma"]:
            gamma = torch.ones_like(gamma)
        mean = tot[0] / count
        var = torch.clamp_min(tot[1] / count - torch.square(mean), 0.0)
        inv = torch.rsqrt(var.reshape(bshape).float() + attrs["eps"]).to(x.dtype)
        out = ((x - mean.reshape(bshape).to(x.dtype)) * inv
               * gamma.reshape(bshape).to(x.dtype)
               + beta.reshape(bshape).to(x.dtype))
        outs_pp.append([out, mean.to(x.dtype), var.to(x.dtype)])
        aux_out.append([mmean * m + mean.detach() * (1 - m),
                        mvar * m + var.detach() * (1 - m)])
    return outs_pp, aux_out


def _global_count(g, locals_):
    """The sum over the batch axis of per-position counts (no gradient),
    at least 1, at every position."""
    return [torch.clamp_min(c, 1.0) for c in C.psum(locals_, g.mesh, g.axis)]


def _softmax_output_dp(g, node, ins_pp, aux_pp, is_train):
    """``SoftmaxOutput`` whose gradient divides by the global batch
    (``'batch'``) or the global count of labels it does not ignore
    (``'valid'``)."""
    from ..ops.loss import _SoftmaxOutput

    attrs = node.attrs
    norm = attrs["normalization"]
    if norm == "null":
        return g.local(node, ins_pp, aux_pp, is_train)
    data0 = ins_pp[0][0]
    if norm == "batch":
        denoms = [float(data0.shape[0] * g.n)] * len(ins_pp)
    else:
        ignore = int(attrs["ignore_label"])
        counts = []
        for data, label in ins_pp:
            lab = label.detach().to(torch.int64)
            if not attrs["multi_output"]:
                lab = lab.reshape(-1)
            if attrs["use_ignore"]:
                counts.append((lab != ignore).to(data.dtype).sum())
            else:
                counts.append(torch.full((), float(lab.numel()),
                                         dtype=data.dtype, device=data.device))
        denoms = _global_count(g, counts)
    return ([[_SoftmaxOutput.apply(data, label, attrs, d)]
             for (data, label), d in zip(ins_pp, denoms)],
            [[] for _ in ins_pp])


def _make_loss_dp(g, node, ins_pp, aux_pp, is_train):
    """``MakeLoss`` whose gradient divides by the global batch or the
    global count of outputs above ``valid_thresh``."""
    from ..ops.loss import _MakeLoss

    attrs = node.attrs
    norm = attrs["normalization"]
    if norm not in ("batch", "valid"):
        return g.local(node, ins_pp, aux_pp, is_train)
    if norm == "batch":
        denoms = [float(ins_pp[0][0].shape[0] * g.n)] * len(ins_pp)
    else:
        denoms = _global_count(g, [
            (ins[0].detach() > attrs["valid_thresh"]).to(ins[0].dtype).sum()
            for ins in ins_pp])
    return ([[_MakeLoss.apply(ins[0], attrs, d)]
             for ins, d in zip(ins_pp, denoms)],
            [[] for _ in ins_pp])


#: op name -> data-parallel form
#: ``fn(graph, node, ins per position, auxs per position, is_train) ->
#: (outputs per position, updated auxs per position)``
DP_FORMS = {
    "BatchNorm": _batch_norm_dp,
    "SoftmaxOutput": _softmax_output_dp,
    "MakeLoss": _make_loss_dp,
}


def classify(op, attrs, in_axes, out_axes, ndims, n, positions):
    """How a node runs over a mesh whose batch axis has ``n`` positions
    (of ``positions`` in all): ``"local"``, ``"dp"`` or ``"global"``, or
    the reason it cannot (a string starting ``"refused: "``)."""
    sharded = n > 1 and any(a is not None for a in in_axes)
    if sharded and (_UNKNOWN in in_axes or _UNKNOWN in out_axes):
        return "refused: the shapes do not say where the batch axis goes"
    if positions > 1 and op.stochastic(attrs):
        return "global"
    if not sharded:
        return "local"
    mixes = MIXERS.get(op.name)
    if mixes is not None and in_axes[0] is not None \
            and mixes(attrs, in_axes, ndims):
        return ("refused: it mixes rows along the batch axis (axis %s of "
                "its first input)" % in_axes[0])
    if op.name in DP_FORMS:
        return "dp"
    if any(a is None for a in out_axes):
        return "refused: it reduces over the batch axis"
    return "local"


class DPGraph:
    """``symbol`` over the positions of ``mesh`` with the batch inputs
    (``batch_names``, batch on axis 0 at ``global_shapes``) cut into
    contiguous blocks along ``axis``. Arguments and auxiliary states bind
    in the order of ``arg_names``/``aux_names``, stochastic nodes run in
    ``order_like``'s order, as :func:`..executor.build_graph_fn` does.
    Raises, naming the op and the node, for a node it cannot run."""

    def __init__(self, symbol, mesh, axis, global_shapes, batch_names,
                 arg_names, aux_names, order_like=None):
        self.mesh = mesh
        self.axis = axis
        self.n = mesh.shape.get(axis, 1)
        self.order, self.slots, self.stochastic = graph_plan(
            symbol, arg_names, aux_names, order_like)
        self.entries = symbol._entries
        local = {}
        for name, s in global_shapes.items():
            s = tuple(s)
            if name in batch_names:
                if not s or s[0] % self.n:
                    raise MXNetError(
                        "data-parallel step: the batch of %s %s does not "
                        "split over %s=%d" % (name, s, axis, self.n))
                s = (s[0] // self.n,) + s[1:]
            local[name] = s
        gs = node_shapes(symbol, global_shapes)
        try:
            ls = node_shapes(symbol, local)
        except MXNetError as e:
            raise MXNetError("data-parallel step over %s=%d: the graph's shapes "
                             "do not infer at the per-position batch (%s)"
                             % (axis, self.n, e)) from e
        self.axes = {}
        self.how = {}
        for node in self.order:
            g, l = gs.get(id(node)), ls.get(id(node))
            nout = len(g) if g is not None else (
                1 if node.is_variable else get_op(node.op).num_outputs(node.attrs))
            self.axes[id(node)] = [
                batch_axis_of(None if g is None else g[k],
                              None if l is None else l[k], self.n)
                for k in range(nout)]
            if node.is_variable:
                if self.slots[id(node)][0] and self.n > 1 \
                        and self.axes[id(node)][0] is not None:
                    raise MXNetError(
                        "data-parallel step over %s=%d: auxiliary state %s "
                        "holds the batch (a state of every row cannot be "
                        "one replica per position)" % (axis, self.n,
                                                       node.name))
                continue
            op = get_op(node.op)
            in_axes = [self.axes[id(i)][k] for i, k in node.inputs]
            ndims = [len(gs[id(i)][k]) if gs.get(id(i)) and gs[id(i)][k]
                     is not None else 0 for i, k in node.inputs]
            how = classify(op, node.attrs, in_axes, self.axes[id(node)],
                           ndims, self.n, mesh.size)
            if how.startswith("refused"):
                raise MXNetError(
                    "data-parallel step over %s=%d: op %s (node %s) has no "
                    "data-parallel form and %s" % (axis, self.n, node.op,
                                                   node.name, how[9:]))
            self.how[id(node)] = how
        # the positions whose blocks a global op joins: position 0's group
        self.group0 = mesh.groups(axis)[0] if axis in mesh.shape else [0]

    def output_axes(self):
        """The batch axis of each of the symbol's outputs (None: the same
        at every position)."""
        return [self.axes[id(n)][k] for n, k in self.entries]

    # ---- running ---------------------------------------------------------
    def local(self, node, ins_pp, aux_pp, is_train):
        op = get_op(node.op)
        outs_pp, aux_out = [], []
        for p, (ins, aux) in enumerate(zip(ins_pp, aux_pp)):
            octx = OpContext(is_train=is_train,
                             device=self.mesh.device_list[p])
            outs, upd = op.forward(octx, node.attrs, ins, aux)
            outs_pp.append(list(outs))
            aux_out.append(list(upd))
        return outs_pp, aux_out

    def _global(self, node, ins_pp, aux_pp, is_train):
        """Run ``node`` once at position 0 on the global batch (joined
        from position 0's group); each position gets its block of every
        output, or the whole of one that holds no batch."""
        op = get_op(node.op)
        mesh = self.mesh
        dev0 = mesh.device_list[0]
        in_axes = [self.axes[id(i)][k] for i, k in node.inputs]
        n_args = len(ins_pp[0])
        joined = []
        for i, a in enumerate(in_axes):
            vals = [(ins_pp[q] + aux_pp[q])[i] for q in self.group0]
            joined.append(vals[0] if a is None or len(vals) == 1 else
                          torch.cat([C.to_position(v, dev0) for v in vals],
                                    dim=a))
        octx = OpContext(is_train=is_train, device=dev0,
                         rng=_random.generator(dev0))
        outs, upd = op.forward(octx, node.attrs, joined[:n_args],
                               joined[n_args:])
        out_axes = self.axes[id(node)]
        outs_pp, aux_out = [], []
        for p, dev in enumerate(mesh.device_list):
            i = mesh.axis_index(p, self.axis) if self.axis in mesh.shape else 0
            row = []
            for o, a in zip(outs, out_axes):
                if a is not None and self.n > 1:
                    size = o.shape[a] // self.n
                    o = o.narrow(a, i * size, size)
                row.append(C.to_position(o, dev))
            outs_pp.append(row)
            aux_out.append([C.to_position(u, dev) for u in upd])
        return outs_pp, aux_out

    def __call__(self, args_pp, auxs_pp, is_train):
        """``args_pp[p]``/``auxs_pp[p]``: position p's arguments and
        auxiliary states (its block of the batch inputs). Returns
        ``(outputs per position, new auxiliary states per position)``."""
        P = self.mesh.size
        vals = {}
        new_aux = [list(a) for a in auxs_pp]
        for node in self.order:
            if node.is_variable:
                is_aux, slot = self.slots[id(node)]
                src = auxs_pp if is_aux else args_pp
                vals[id(node)] = [[src[p][slot]] for p in range(P)]
                continue
            op = get_op(node.op)
            n_args = len(op.arg_names(node.attrs))
            ins = [[vals[id(i)][p][k] for i, k in node.inputs]
                   for p in range(P)]
            ins_pp = [x[:n_args] for x in ins]
            aux_pp = [x[n_args:] for x in ins]
            how = self.how[id(node)]
            if how == "local":
                outs_pp, upd_pp = self.local(node, ins_pp, aux_pp, is_train)
            elif how == "global":
                outs_pp, upd_pp = self._global(node, ins_pp, aux_pp, is_train)
            else:
                outs_pp, upd_pp = DP_FORMS[op.name](self, node, ins_pp,
                                                    aux_pp, is_train)
            vals[id(node)] = outs_pp
            for p in range(P):
                for (inp, _), new in zip(node.inputs[n_args:], upd_pp[p]):
                    new_aux[p][self.slots[id(inp)][1]] = new
        outs = [[vals[id(n)][p][k] for n, k in self.entries] for p in range(P)]
        return outs, new_aux
