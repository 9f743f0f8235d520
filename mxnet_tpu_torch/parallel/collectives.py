"""Sharding and collectives over a :class:`~.mesh.Mesh` (port only; it
stands in for the JAX package's ``shard_map`` and ``lax.axis_index``,
``ppermute``, ``all_to_all``, ``psum`` and ``pmean``).

One controller drives every position. A sharded value is a list with one
tensor per position, in position order; :func:`shard` cuts a global
tensor by a :class:`PartitionSpec` and :func:`unshard` joins the pieces.
:func:`run_sharded` calls a body once per position with its index along
every axis, as ``shard_map`` runs a body per device.

A collective takes and returns such lists. It moves values between
positions with explicit copies (``Tensor.to(device, copy=True)``), also
where two positions name the same device: each position gets a tensor of
its own, never an alias of another position's, so an in-place update at
one position reaches no other. The copies are ordinary autograd
operations, so gradients flow back through them and a body needs no
hand-written backward. Every copy counts in telemetry's
``parallel.transfers`` and its bytes in ``parallel.transfer_bytes``.
Inside a CUDA-graph capture the copies are recorded, not run: there
:func:`tally_transfers` collects them instead, and whoever replays the
graph adds the tally per replay (:func:`count_transfers`).
"""
from __future__ import annotations

import contextlib

import torch

from .. import telemetry

__all__ = ["PartitionSpec", "P", "shard", "unshard", "run_sharded",
           "transfer", "to_position", "broadcast", "ppermute", "all_to_all",
           "psum", "pmean", "all_gather", "reduce_scatter", "gather_to",
           "tree_map", "tree_leaves", "tally_transfers", "count_transfers"]


class _Telemetry:
    """Where copies are counted outside a capture: telemetry's counters."""

    @staticmethod
    def add(n, nbytes):
        count_transfers(n, nbytes)


class _Tally(list):
    """``[copies, bytes]`` collected while a capture records copies."""

    def add(self, n, nbytes):
        self[0] += n
        self[1] += nbytes


# where transfer() counts its copies: telemetry, or a capture's tally
# (tally_transfers swaps it), so no copy recorded into a CUDA graph
# touches telemetry
_sink = _Telemetry()


def tree_map(fn, tree):
    """``fn`` over the leaves of nested lists, tuples and dicts (a
    parameter tree, as the JAX package's pytrees)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


class PartitionSpec(tuple):
    """Per dimension, the mesh axis it is split over, or None (whole).
    ``PartitionSpec()`` is a replicated value."""

    def __new__(cls, *dims):
        return tuple.__new__(cls, dims)


P = PartitionSpec


def count_transfers(n, nbytes):
    """Add ``n`` copies of ``nbytes`` in all to telemetry's counters."""
    telemetry.counter("parallel.transfers").inc(n)
    telemetry.counter("parallel.transfer_bytes").inc(nbytes)


@contextlib.contextmanager
def tally_transfers():
    """Collect the copies made inside the block into the yielded
    ``[copies, bytes]`` instead of telemetry: a CUDA graph records its
    copies once and runs them on every replay, which counts them."""
    global _sink
    prev, _sink = _sink, _Tally([0, 0])
    try:
        yield _sink
    finally:
        _sink = prev


def transfer(x, device):
    """A copy of ``x`` on ``device`` that shares no memory with ``x``
    (differentiable), counted as one cross-position copy."""
    # fwlint: disable=capture-impure — inside a capture _sink is its tally (tally_transfers): the copy is counted once there and the trainer adds the tally on every replay
    _sink.add(1, x.numel() * x.element_size())
    return x.to(device, copy=True)


def to_position(x, device):
    """``x`` on ``device``: itself where it already lies there (a read of a
    replicated value), else a counted copy."""
    # fwlint: disable=capture-impure — compares two torch.device objects (host metadata), no tensor value is read
    return x if x.device == torch.device(device) else transfer(x, device)


def _split_dims(mesh, spec, ndim):
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return [(d, a) for d, a in enumerate(spec) if a is not None]


def shard(x, mesh, spec):
    """``x`` cut by ``spec``: one piece per position, on its device. A
    dimension split over an axis of size n gives position p the piece at
    its index along that axis (contiguous, so kernels take it as it is);
    replicated dimensions stay whole."""
    dims = _split_dims(mesh, spec, x.dim())
    out = []
    for pos, dev in enumerate(mesh.device_list):
        piece = x
        for d, axis in dims:
            n = mesh.shape[axis]
            if piece.shape[d] % n:
                raise ValueError("dim %d of size %d does not split over %s=%d"
                                 % (d, piece.shape[d], axis, n))
            size = piece.shape[d] // n
            i = mesh.axis_index(pos, axis)
            piece = piece.narrow(d, i * size, size)
        out.append(to_position(piece.contiguous() if dims else piece, dev))
    return out


def unshard(parts, mesh, spec, device=None):
    """The global tensor of per-position ``parts`` sharded by ``spec``,
    on ``device`` (default: position 0's). Replicated dimensions are read
    from the first position of each group."""
    device = mesh.device_list[0] if device is None else device
    dims = _split_dims(mesh, spec, parts[0].dim())
    # the positions whose index is 0 along every axis the spec does not
    # name carry the pieces; join them axis by axis, the last split first
    named = [a for _, a in dims]
    keep = [p for p in range(mesh.size)
            if all(mesh.axis_index(p, a) == 0 for a in mesh.axis_names
                   if a not in named)]
    pieces = {tuple(mesh.axis_index(p, a) for a in named):
              to_position(parts[p], device) for p in keep}
    for k in range(len(dims) - 1, -1, -1):
        d, axis = dims[k]
        joined = {}
        for key in sorted(pieces):
            joined.setdefault(key[:k], []).append(pieces[key])
        pieces = {key: torch.cat(v, dim=d) for key, v in joined.items()}
    return pieces[()]


class Position:
    """What a body of :func:`run_sharded` knows of where it runs: its
    number, its device and ``idx[axis]``, its index along an axis (the
    JAX package's ``lax.axis_index``)."""

    def __init__(self, mesh, pos):
        self.pos = pos
        self.device = mesh.device_list[pos]
        self._coords = mesh.coords(pos)

    def __getitem__(self, axis):
        return int(self._coords[axis])


def run_sharded(fn, mesh, in_specs, out_specs):
    """A function of global tensors that cuts each by its spec in
    ``in_specs``, calls ``fn(position, *pieces)`` once per position and
    joins each result by its spec in ``out_specs`` (a spec, or a tuple of
    specs for a tuple of results). A replicated result is position 0's."""
    multi = isinstance(out_specs, (list, tuple)) and not isinstance(
        out_specs, PartitionSpec)

    def wrapped(*args):
        pieces = [shard(a, mesh, s) for a, s in zip(args, in_specs)]
        outs = [fn(Position(mesh, p), *[pc[p] for pc in pieces])
                for p in range(mesh.size)]
        if not multi:
            return unshard(outs, mesh, out_specs)
        return tuple(unshard([o[k] for o in outs], mesh, s)
                     for k, s in enumerate(out_specs))

    return wrapped


def broadcast(x, mesh):
    """A replicated value: ``x`` on every position's device (``x`` itself
    where it lies there already; a read-only value needs no copy)."""
    return [to_position(x, d) for d in mesh.device_list]


def gather_to(parts, device):
    """Every part on ``device`` (itself where it lies there)."""
    return [to_position(p, device) for p in parts]


def ppermute(xs, mesh, axis, perm):
    """``lax.ppermute``: along ``axis``, the value at index ``src`` goes to
    index ``dst`` for each ``(src, dst)`` in ``perm``; an index no pair
    sends to receives zeros."""
    out = [None] * mesh.size
    devs = mesh.device_list
    for group in mesh.groups(axis):
        for src, dst in perm:
            out[group[dst]] = transfer(xs[group[src]], devs[group[dst]])
        for p in group:
            if out[p] is None:
                out[p] = torch.zeros_like(xs[p])
    return out


def all_to_all(xs, mesh, axis, split_axis, concat_axis, tiled=True):
    """``lax.all_to_all`` over ``axis`` (n positions): each position cuts
    its value into n chunks along ``split_axis``; position j receives
    chunk j of every position i, in order of i. Tiled, the chunks are
    joined along ``concat_axis``; not tiled, ``split_axis`` must be of
    size n and the received chunks are stacked into a new ``concat_axis``
    in its place (the JAX package's semantics)."""
    out = [None] * mesh.size
    devs = mesh.device_list
    for group in mesh.groups(axis):
        n = len(group)
        chunks = [torch.chunk(xs[p], n, dim=split_axis) for p in group]
        for c, p in zip(chunks, group):
            if len(c) != n or c[0].shape[split_axis] * n != xs[p].shape[split_axis]:
                raise ValueError("dim %d of size %d does not split over %s=%d"
                                 % (split_axis, xs[p].shape[split_axis], axis, n))
        for j, p in enumerate(group):
            got = [transfer(chunks[i][j], devs[p]) for i in range(n)]
            if tiled:
                out[p] = torch.cat(got, dim=concat_axis)
            else:
                got = [g.squeeze(split_axis) for g in got]
                out[p] = torch.stack(got, dim=concat_axis)
    return out


def psum(xs, mesh, axis):
    """``lax.psum``: every position of a group gets the group's sum, on
    its own device."""
    out = [None] * mesh.size
    devs = mesh.device_list
    for group in mesh.groups(axis):
        home = devs[group[0]]
        total = xs[group[0]]
        for p in group[1:]:
            total = total + to_position(xs[p], home)
        for p in group:
            out[p] = transfer(total, devs[p])
    return out


def pmean(xs, mesh, axis):
    """``lax.pmean``: the group's mean at every position."""
    n = mesh.shape[axis]
    return [s / n for s in psum(xs, mesh, axis)]


def all_gather(xs, mesh, axis, dim=0):
    """``lax.all_gather(..., tiled=True)``: every position of a group gets
    the group's values joined along ``dim`` in order along ``axis``, on
    its own device (its own piece copied too, so no position aliases
    another's)."""
    out = [None] * mesh.size
    devs = mesh.device_list
    for group in mesh.groups(axis):
        for p in group:
            out[p] = torch.cat([transfer(xs[q], devs[p]) for q in group],
                               dim=dim)
    return out


def reduce_scatter(xs, mesh, axis, dim=0):
    """``lax.psum_scatter(..., tiled=True)``: position i of a group gets
    block i along ``dim`` of the group's sum (the blocks summed in order
    along ``axis``, as :func:`psum` sums)."""
    out = [None] * mesh.size
    devs = mesh.device_list
    for group in mesh.groups(axis):
        n = len(group)
        for i, p in enumerate(group):
            size = xs[p].shape[dim]
            if size % n:
                raise ValueError("dim %d of size %d does not split over %s=%d"
                                 % (dim, size, axis, n))
            block = size // n
            parts = [transfer(xs[q].narrow(dim, i * block, block), devs[p])
                     for q in group]
            total = parts[0]
            for part in parts[1:]:
                total = total + part
            out[p] = total
    return out
