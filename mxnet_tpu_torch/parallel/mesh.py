"""Device meshes (counterpart of ``mxnet_tpu/parallel/mesh.py``).

The JAX package's mesh is a ``jax.sharding.Mesh``: named axes over a grid
of devices, and every collective an XLA op over an axis. The port runs
one controller, as JAX does: a :class:`Mesh` is a grid of *positions*
with named axes, each position naming the torch device it computes on.
The shards of a sharded tensor are distinct tensors, one per position,
and a collective (:mod:`.collectives`) is a set of explicit copies
between positions.

Positions may repeat a device. With no device list, :func:`build_mesh`
fills the visible cards in order and, when the mesh has more positions
than there are cards, starts again at the first: on one H100,
``build_mesh({"sp": 4})`` is four positions on ``cuda:0``. That is
logged once and shown in ``repr(mesh)``.

**Deviation by design (``ROADMAP.md`` C15).** The JAX package moves a
mesh larger than the default platform onto its virtual CPU devices
(``mxnet_tpu/parallel/mesh.py:41-59``). The port never moves to the CPU
unless the caller's device list or the current context says so (``with
mx.cpu(): build_mesh({"sp": 4})`` is four positions on the CPU, which is
how the tests run a mesh). The CPU is one torch device, so every
``cpu(i)`` is the same device.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["Mesh", "build_mesh", "local_mesh", "mesh_axis_size",
           "as_torch_device"]

_logged_repeats = set()


def as_torch_device(dev):
    """A torch device from a port ``Context``, a ``torch.device``, a device
    string, or any object with ``platform`` and ``id`` (a JAX device:
    ``cpu`` names the CPU, any other platform ``cuda:<id>``; read by
    attribute, so nothing of JAX is imported)."""
    from ..context import Context

    if isinstance(dev, Context):
        return dev.torch_device
    if isinstance(dev, (torch.device, str)):
        return torch.device(dev)
    platform = getattr(dev, "platform", None)
    if platform is not None and hasattr(dev, "id"):
        return (torch.device("cpu") if platform == "cpu"
                else torch.device("cuda", int(dev.id)))
    raise MXNetError("not a device: %r" % (dev,))


class Mesh:
    """Named axes over a grid of positions, each naming a torch device.

    ``shape`` maps each axis name to its size, in order (as the JAX
    mesh's); ``devices`` is the numpy grid of ``torch.device`` objects;
    positions are numbered in row-major (C) order of that grid."""

    def __init__(self, devices, axis_names, repeated=False):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise MXNetError("a %d-d device grid for axes %s"
                             % (self.devices.ndim, self.axis_names))
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.repeated = repeated
        #: the positions' devices in position order
        self.device_list = list(self.devices.reshape(-1))

    @property
    def size(self):
        return int(self.devices.size)

    def coords(self, pos):
        """Position ``pos``'s index along every axis, as a dict."""
        return dict(zip(self.axis_names,
                        np.unravel_index(pos, self.devices.shape)))

    def axis_index(self, pos, axis):
        return int(self.coords(pos)[axis])

    def groups(self, axis):
        """The positions that a collective over ``axis`` joins: one list per
        setting of the other axes, each in order along ``axis``."""
        k = self.axis_names.index(axis)
        grid = np.arange(self.size).reshape(self.devices.shape)
        grid = np.moveaxis(grid, k, -1).reshape(-1, self.devices.shape[k])
        return [list(map(int, g)) for g in grid]

    def __repr__(self):
        devs = ", ".join(str(d) for d in self.device_list)
        return "Mesh(%s; positions on [%s]%s)" % (
            ", ".join("%s=%d" % kv for kv in self.shape.items()), devs,
            "; devices repeat" if self.repeated else "")


def _visible_devices():
    """The devices a mesh without a device list fills: the cards, or the
    CPU when the current context is the CPU."""
    from ..context import current_context

    ctx = current_context()
    if ctx.type == "cpu":
        return [torch.device("cpu")], True
    n = torch.cuda.device_count()
    if n == 0:
        raise MXNetError("build_mesh: no CUDA device; pass CPU devices or run "
                         "inside `with mx.cpu():`")
    return [torch.device("cuda", i) for i in range(n)], False


def build_mesh(axis_sizes, devices=None):
    """A :class:`Mesh` from ``{"axis": size}`` (in order); a size of -1
    takes the rest of the devices.

    ``devices`` lists the positions' devices (port ``Context`` objects,
    ``torch.device``\\ s, strings or JAX device objects). Without it the
    positions fill the visible cards (the CPU inside ``with mx.cpu():``),
    repeating them in order when the mesh is larger."""
    names = list(axis_sizes)
    implicit = devices is None
    if implicit:
        pool, on_cpu = _visible_devices()
    else:
        pool = [as_torch_device(d) for d in devices]
    sizes = [int(s) for s in axis_sizes.values()]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = len(pool) // known if known else 0
    total = int(np.prod(sizes))
    if total <= 0:
        raise ValueError("mesh %s needs more devices, have %d"
                         % (axis_sizes, len(pool)))
    repeated = False
    if total > len(pool):
        if not implicit:
            raise ValueError("mesh %s needs %d devices, have %d"
                             % (axis_sizes, total, len(pool)))
        repeated = True
        key = (tuple(names), tuple(sizes), tuple(map(str, pool)))
        if key not in _logged_repeats:
            _logged_repeats.add(key)
            logging.info("build_mesh: %d positions over %d %s device(s); "
                         "positions repeat them in order", total, len(pool),
                         "CPU" if on_cpu else "CUDA")
        pool = [pool[i % len(pool)] for i in range(total)]
    grid = np.empty(total, dtype=object)
    grid[:] = pool[:total]
    return Mesh(grid.reshape(sizes), names, repeated=repeated)


def local_mesh(n=None, axis="dp"):
    """1-D mesh of ``n`` positions (default: one per visible device)."""
    if n is None:
        return build_mesh({axis: -1})
    return build_mesh({axis: n})


def mesh_axis_size(mesh, axis):
    return mesh.shape[axis]
