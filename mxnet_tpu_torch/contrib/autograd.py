"""Imperative autograd of the port (counterpart of
``mxnet_tpu/contrib/autograd.py``; reference:
python/mxnet/contrib/autograd.py over src/ndarray/autograd.{h,cc}).

``mark_variables`` turns each variable's tensor into a torch leaf that
requires a gradient; inside a ``train_section`` every imperative op
(``ndarray.imperative_invoke``) runs in training mode with torch autograd
on, so the ops on the marked variables build torch's graph as they run;
``backward`` hands the heads and their head gradients to
``torch.autograd.grad`` and writes each variable's gradient into the
array marked beside it (``grad_req`` ``write``, ``add`` or ``null``).
Nothing is replayed: a stochastic op's backward differentiates the mask
its forward drew (the JAX package replays its tape with a fixed key, so
its Dropout backward uses another mask: ``ROADMAP.md`` C11), and the
flash-attention ops run their backward kernels from the residuals the
forward kept.

The ops recorded since the last ``backward`` form the tape: a head must
come from it (or be a marked variable). ``backward`` without
``retain_graph`` frees the graph and clears the tape, so a second
``backward`` over the same heads raises, as the JAX package's does. The
state is per process and belongs to the user's training thread, as the
JAX package's.
"""
from __future__ import annotations

import contextlib
import functools
import weakref

import torch

from ..base import MXNetError

__all__ = [
    "set_is_training", "train_section", "test_section", "is_recording",
    "record_op", "mark_variables", "backward", "compute_gradient",
    "grad_and_loss", "grad",
]

_RECORDING = [False]
#: outputs of the ops recorded since the last backward without
#: retain_graph: id -> weak reference (an NDArray's ``==`` is elementwise,
#: so it cannot sit in a set)
_TAPE = {}
#: id(variable NDArray) -> (variable, gradient NDArray, grad_req)
_MARKED = {}


def is_recording():
    """Whether a ``train_section`` is recording."""
    return _RECORDING[0]


def record_op(op_name, attrs, inputs, outputs):
    """Called by ``ndarray.imperative_invoke`` for each op it runs while
    recording: the outputs join the tape (torch autograd holds the graph
    itself)."""
    del op_name, attrs, inputs
    if _RECORDING[0]:
        for o in outputs:
            _TAPE[id(o)] = weakref.ref(o)


def set_is_training(is_train):
    """Switch training mode (and recording) on or off; returns the
    previous mode."""
    from .. import ndarray as nd

    prev = nd._TRAIN_MODE[0]
    nd._TRAIN_MODE[0] = bool(is_train)
    _RECORDING[0] = bool(is_train)
    return prev


@contextlib.contextmanager
def train_section():
    """``with train_section():`` — ops run in training mode and are
    recorded."""
    prev = set_is_training(True)
    try:
        yield
    finally:
        set_is_training(prev)


@contextlib.contextmanager
def test_section():
    """``with test_section():`` — inference mode inside a train section."""
    prev = set_is_training(False)
    try:
        yield
    finally:
        set_is_training(prev)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Mark NDArrays as variables to compute gradients for, each with the
    NDArray its gradient is written into and its ``grad_req``."""
    from ..ndarray import NDArray

    if isinstance(variables, NDArray):
        variables = [variables]
        gradients = [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, grad, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null, got %r"
                             % (req,))
        if req != "null" and not var.data.is_floating_point():
            raise MXNetError("mark_variables: a %s array has no gradient"
                             % var.data.dtype)
        t = var.data.detach()
        var._set_data(t.requires_grad_(True) if req != "null" else t)
        _MARKED[id(var)] = (var, grad, req)


def _heads_on_tape(heads):
    for h in heads:
        ref = _TAPE.get(id(h))
        if (ref is None or ref() is not h) and id(h) not in _MARKED:
            raise MXNetError(
                "backward: an output was not recorded since the last "
                "backward (record it inside a train_section; a graph "
                "backward has freed needs retain_graph=True)")


def backward(outputs, out_grads=None, retain_graph=False):
    """Gradients of ``outputs`` (seeded with ``out_grads``, ones by
    default) with respect to the marked variables, written into their
    gradient arrays by their ``grad_req``."""
    from ..ndarray import NDArray

    if isinstance(outputs, NDArray):
        outputs = [outputs]
    if not _MARKED:
        raise MXNetError("no variables marked; call mark_variables first")
    _heads_on_tape(outputs)
    marked = [m for m in _MARKED.values() if m[2] != "null"]
    leaves = [var.data for var, _, _ in marked]
    if out_grads is None:
        seeds = [torch.ones_like(o.data) for o in outputs]
    else:
        seeds = [g.data.to(o.data.device, o.data.dtype)
                 for o, g in zip(outputs, out_grads)]
    pairs = [(o.data, s) for o, s in zip(outputs, seeds) if o.data.requires_grad]
    grads = [None] * len(leaves)
    if pairs and leaves:
        grads = torch.autograd.grad([h for h, _ in pairs], leaves,
                                    [s for _, s in pairs],
                                    retain_graph=retain_graph,
                                    allow_unused=True)
    with torch.no_grad():
        for (var, gout, req), g in zip(marked, grads):
            g = torch.zeros_like(var.data) if g is None else g
            if req == "add":
                gout.data.add_(g.to(gout.data.dtype))
            else:
                gout[:] = g
    if not retain_graph:
        _TAPE.clear()


def compute_gradient(outputs):
    """``backward(outputs)`` (the reference's older name)."""
    backward(outputs)


def grad_and_loss(func, argnum=None):
    """Wrap ``func`` so that a call returns ``(gradients, outputs)``: the
    gradients of its outputs with respect to its NDArray arguments (those
    at ``argnum`` when given)."""

    @functools.wraps(func)
    def wrapped(*args):
        from .. import ndarray as nd
        from ..ndarray import NDArray

        variables = args
        if argnum is not None:
            argnum_ = argnum if isinstance(argnum, list) else [argnum]
            variables = [args[i] for i in argnum_]
        for x in variables:
            if not isinstance(x, NDArray):
                raise MXNetError("type of autograd input should be NDArray")
        grads = [nd.zeros(x.shape, ctx=x.context, dtype=x.dtype)
                 for x in variables]
        mark_variables(variables, grads)
        with train_section():
            outputs = func(*args)
        backward([outputs] if isinstance(outputs, NDArray) else outputs)
        return grads, outputs

    return wrapped


def grad(func, argnum=None):
    """Wrap ``func`` so that a call returns the gradients of its outputs
    with respect to its NDArray arguments."""
    grad_with_loss_func = grad_and_loss(func, argnum)

    @functools.wraps(grad_with_loss_func)
    def wrapped(*args):
        return grad_with_loss_func(*args)[0]

    return wrapped
