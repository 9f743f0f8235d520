"""Torch interop of the port (counterpart of ``mxnet_tpu/torch_bridge.py``;
reference: python/mxnet/torch.py and plugin/torch, which bridge Torch
tensors and modules into the NDArray runtime).

An NDArray of the port already holds a ``torch.Tensor``, so nothing is
staged through the host: a tensor stays on the NDArray's device. The
contract is the JAX package's: a result never aliases its source (each
crossing copies), so writing into one side never changes the other.

* ``to_torch(nd_arr)`` / ``from_torch(tensor, ctx=None)`` — NDArray and
  ``torch.Tensor`` (``from_torch`` keeps the tensor's device unless
  ``ctx`` names another);
* ``function(torch_fn)`` — any torch callable as an NDArray function (the
  reference's generated ``mx.th.*``);
* ``TorchModule`` — a ``torch.nn.Module``'s forward on NDArrays, with a
  backward through torch autograd and a plain SGD ``step``.
"""
from __future__ import annotations

import torch

from . import ndarray as nd

__all__ = ["to_torch", "from_torch", "function", "TorchModule"]


def to_torch(arr):
    """NDArray -> a new ``torch.Tensor`` on the NDArray's device."""
    return arr.data.detach().clone()


def from_torch(tensor, ctx=None):
    """``torch.Tensor`` -> a new NDArray, on ``ctx`` when given, else on
    the tensor's device."""
    t = tensor.detach()
    if ctx is not None and torch.device(ctx) != t.device:
        return nd.NDArray(t.to(torch.device(ctx), copy=True))
    return nd.NDArray(t.clone())


def function(torch_fn):
    """Wrap a torch callable into an NDArray -> NDArray function."""

    def wrapped(*args, **kwargs):
        targs = [to_torch(a) if isinstance(a, nd.NDArray) else a for a in args]
        tkwargs = {k: to_torch(v) if isinstance(v, nd.NDArray) else v
                   for k, v in kwargs.items()}
        out = torch_fn(*targs, **tkwargs)
        if isinstance(out, (list, tuple)):
            return [from_torch(o) if isinstance(o, torch.Tensor) else o
                    for o in out]
        return from_torch(out) if isinstance(out, torch.Tensor) else out

    wrapped.__name__ = getattr(torch_fn, "__name__", "torch_fn")
    return wrapped


class TorchModule:
    """Run a ``torch.nn.Module`` on NDArrays with an optional backward.

    ``forward(x, is_train)`` returns an NDArray; after a training forward
    ``backward(out_grad)`` returns the input's gradient. The parameters
    stay inside the torch module; ``step(lr)`` applies a plain SGD update
    to them (the plugin's fine-tuning case)."""

    def __init__(self, module):
        self.module = module
        self._last = None

    def forward(self, x, is_train=False):
        tx = to_torch(x)
        if is_train:
            tx.requires_grad_(True)
            out = self.module(tx)
            self._last = (tx, out)
            return from_torch(out)
        self._last = None  # an eval forward drops any pending backward
        with torch.no_grad():
            return from_torch(self.module(tx))

    def backward(self, out_grad):
        if self._last is None:
            raise RuntimeError("backward before forward(is_train=True)")
        tx, out = self._last
        out.backward(to_torch(out_grad).to(out.device))
        self._last = None
        return from_torch(tx.grad)

    def step(self, lr):
        with torch.no_grad():
            for p in self.module.parameters():
                if p.grad is not None:
                    p -= lr * p.grad
                    p.grad.zero_()
