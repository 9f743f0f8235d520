"""Device context (counterpart of ``mxnet_tpu/context.py``; reference:
python/mxnet/context.py).

A :class:`Context` names a (device type, device id) pair, as in the JAX
package, and is at the same time the device string torch reads:
``Context`` is a ``str`` whose value is ``"cpu"`` or ``"cuda:<i>"``, so it
goes into every torch call that takes a device (``torch.zeros(...,
device=ctx)``, ``t.to(ctx)``, ``torch.device(ctx)``) as it is, and it
answers ``.type`` and ``.index`` as a ``torch.device`` does. It prints as
the JAX package's does (``cpu(0)``, ``gpu(1)``) and compares equal to a
``torch.device`` of the same device.

The JAX package aliases ``mx.gpu(i)`` to TPU chip ``i``; the port mirrors
that: ``gpu(i)`` and ``tpu(i)`` both name CUDA card ``i`` (the reference
example scripts say ``mx.gpu``, this repo's say ``mx.tpu``), and
``num_tpus()``/``num_gpus()`` count CUDA devices. PyTorch has one CPU
device; ``cpu(i)`` keeps its id for printing and equality only.

``with ctx:`` makes ``ctx`` the current context of this thread
(:func:`current_context`) until the block ends, as in the reference.
**Deviation from the JAX package:** outside any ``with`` block the JAX
package's current context is ``cpu(0)`` (``mxnet_tpu/context.py:85-90``);
the port's is :func:`default_device`, the first card, which raises when
there is no CUDA device: an entry point that was not asked for the CPU
runs on the card and never falls back to the host quietly. Scripts run on
the CPU inside ``with mx.cpu():``, or, for a whole process and the
processes it starts, with ``MXNET_DEFAULT_CONTEXT=cpu`` in the
environment.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError, env_str

__all__ = ["Context", "cpu", "gpu", "tpu", "current_context", "num_tpus",
           "num_gpus", "auto", "default_device", "resolve"]


class Context(str):
    """A device context: ``Context('cpu')``, ``Context('gpu', 1)``,
    ``Context('tpu', 0)`` (the card), or a copy of another ``Context``.
    With-scope semantics match the reference's."""

    _default_ctx = threading.local()

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 4: "tpu"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "tpu": 4}

    def __new__(cls, device_type, device_id=0):
        if isinstance(device_type, Context):
            typeid, device_id = device_type.device_typeid, device_type.device_id
        else:
            if device_type not in Context.devstr2type:
                raise MXNetError("unknown device type %r" % (device_type,))
            typeid = Context.devstr2type[device_type]
        device_id = int(device_id)
        on_card = Context.devtype2str[typeid] in ("gpu", "tpu")
        self = str.__new__(cls, "cuda:%d" % device_id if on_card else "cpu")
        self.device_typeid = typeid
        self.device_id = device_id
        self._old_ctx = None
        return self

    def __getnewargs__(self):
        return (self.device_type, self.device_id)

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    # ---- the torch.device face ------------------------------------------
    @property
    def type(self):
        """``"cuda"`` or ``"cpu"``, as ``torch.device.type``."""
        return "cuda" if self.device_type in ("gpu", "tpu") else "cpu"

    @property
    def index(self):
        """The card's index (None on the CPU), as ``torch.device.index``."""
        return self.device_id if self.type == "cuda" else None

    @property
    def torch_device(self):
        return torch.device(str.__str__(self))

    def __eq__(self, other):
        if isinstance(other, Context):
            return (self.device_typeid == other.device_typeid
                    and self.device_id == other.device_id)
        if isinstance(other, torch.device):
            return self.torch_device == other
        return False

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    def __repr__(self):
        return self.__str__()

    # ---- the with scope --------------------------------------------------
    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, "value", None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx


def cpu(device_id=0):
    """The host (reference: python/mxnet/context.py:95)."""
    return Context("cpu", device_id)


def gpu(device_id=0):
    """CUDA card ``device_id``."""
    return Context("gpu", device_id)


def tpu(device_id=0):
    """CUDA card ``device_id``: the port's accelerator in the place of the
    JAX package's TPU chip."""
    return Context("tpu", device_id)


def num_tpus():
    """The number of CUDA devices (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def num_gpus():
    """Reference-script alias of :func:`num_tpus`."""
    return num_tpus()


def auto(device_id=0):
    """``tpu(device_id)`` when a card is visible, else ``cpu(device_id)``
    (the JAX package's ``auto``, ``mxnet_tpu/context.py:124-129``)."""
    return tpu(device_id) if num_tpus() else cpu(device_id)


def default_device():
    """``gpu(0)``. Raises :class:`MXNetError` when CUDA is absent: an entry
    point that was not asked for the CPU must not fall back to it quietly."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device: the port runs on the card unless the caller "
            "asks for the CPU (pass device='cpu', or run inside "
            "`with mx.cpu():`)")
    return gpu(0)


def current_context():
    """The innermost ``with`` context of this thread; outside any, the
    :func:`default_device`, or ``cpu(0)`` when ``MXNET_DEFAULT_CONTEXT`` is
    ``cpu`` (the module docstring says why)."""
    v = getattr(Context._default_ctx, "value", None)
    if v is not None:
        return v
    if env_str("MXNET_DEFAULT_CONTEXT", "gpu", choices=("cpu", "gpu")) == "cpu":
        return cpu(0)
    return default_device()


def resolve(device):
    """``device`` (a Context, ``torch.device`` or string) as a
    ``torch.device``; None means :func:`current_context`."""
    if device is None:
        device = current_context()
    if isinstance(device, Context):
        return device.torch_device
    return torch.device(device)
