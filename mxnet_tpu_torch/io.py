"""Data iterators of the port (counterpart of ``mxnet_tpu/io.py``;
reference: python/mxnet/io.py).

``DataDesc``, ``DataBatch``, the ``DataIter`` protocol and
``NDArrayIter`` over in-memory arrays, with ``last_batch_handle``
``pad``/``discard``/``roll_over`` and a ``shuffle`` drawn from ``seed``
(the global numpy RNG without one, as in the JAX package). Batches are
host (CPU) NDArrays; the executor group copies them to the bound
device. ``state_dict``/``load_state`` give an iterator's position, so
``fit(auto_resume=...)`` seeks instead of drawing batches.

The uint8 wire (:class:`WireSpec`): an image iterator may ship its data
as uint8 HWC batches and mark them with a ``WireSpec``; the module's
executor boundary decodes them (``_image_wire_normalize``: cast, mean,
std, transpose to float32 NCHW) on the device, and the fused step does
so inside its CUDA graph, whose static input is then the uint8 batch.
:class:`DeviceFeedIter` uploads batches from pinned host buffers on a
side stream while the card computes; ``fit`` wraps its training
iterator in one when ``MXNET_FEED_DEPTH`` is set
(:func:`maybe_device_feed`). The record readers are :mod:`.io_image`
(``ImageRecordIter``, ``ImageDetRecordIter``); ``MNISTIter`` and
``CSVIter`` read their files into an ``NDArrayIter``, and ``ResizeIter``
and ``PrefetchingIter`` wrap other iterators. Every iterator here that
can seek joins the ``state_dict`` position protocol.
"""
from __future__ import annotations

import gzip
import os
import queue
import struct
import threading
import time
from collections import namedtuple

import numpy as np
import torch

from . import fault, telemetry
from .base import MXNetError, env_int
from .context import cpu
from .ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "WireSpec",
           "apply_wire", "wire_decode_ctx", "DeviceFeedIter", "ResizeIter",
           "PrefetchingIter", "maybe_device_feed", "MNISTIter", "CSVIter",
           "ImageRecordIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name + shape (+ dtype/layout) descriptor."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype, self.layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        """DataDescs of ``[(name, shape)]``, with ``types``'s dtypes."""
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch:
    """One mini-batch: lists of data and label NDArrays, and the padding.
    ``wire``: a :class:`WireSpec` when the data arrays are in wire format
    (uint8 HWC), decoded at the executor boundary."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None,
                 wire=None):
        if data is not None and not isinstance(data, (list, tuple)):
            raise TypeError("Data must be list of NDArrays")
        if label is not None and not isinstance(label, (list, tuple)):
            raise TypeError("Label must be list of NDArrays")
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label
        self.wire = wire


class WireSpec:
    """The uint8-wire contract between an image iterator and the executor.

    An iterator that opts in (``ImageRecordIter(wire_dtype='uint8')``)
    ships its data as uint8 HWC, a quarter of float32's bytes, and
    advertises the decoded descriptor (float32 NCHW) in ``provide_data``,
    so ``bind`` and shape inference are unchanged. The mean/std normalize
    and the transpose run on the device (``_image_wire_normalize``)."""

    __slots__ = ("mean", "std", "layout", "_consts")

    def __init__(self, mean=None, std=None, layout="NHWC"):
        self.mean = None if mean is None else tuple(float(m) for m in np.ravel(mean))
        self.std = None if std is None else tuple(float(v) for v in np.ravel(std))
        self.layout = layout
        self._consts = {}

    def __eq__(self, other):
        return (isinstance(other, WireSpec) and self.mean == other.mean
                and self.std == other.std and self.layout == other.layout)

    def __hash__(self):
        return hash((self.mean, self.std, self.layout))

    def decode(self, arr):
        """Wire NDArray -> float32 NCHW NDArray, on ``arr``'s device."""
        from .ndarray import imperative_invoke

        return imperative_invoke("_image_wire_normalize", [arr],
                                 {"mean": self.mean, "std": self.std,
                                  "layout": self.layout})

    def decode_tensor(self, t):
        """The same decode on a tensor, inside the fused step's graph: the
        mean and std tensors are made on ``t``'s device once (by the eager
        first step), since a graph capture cannot copy from the host."""
        from .ops.spatial import wire_normalize

        consts = self._consts.get(t.device)
        if consts is None:
            consts = self._consts[t.device] = tuple(
                None if v is None else torch.tensor(v, dtype=torch.float32,
                                                    device=t.device)
                for v in (self.mean, self.std))
        return wire_normalize(t, *consts, layout=self.layout)

    def wire_shape(self, shape):
        """The wire (HWC) shape of a decoded (NCHW) batch shape."""
        shape = tuple(shape)
        if self.layout == "NHWC" and len(shape) == 4:
            return (shape[0], shape[2], shape[3], shape[1])
        return shape

    def decoded_desc(self, name, shape):
        """The decoded DataDesc of a wire batch shape, for ``bind``."""
        shape = tuple(shape)
        if self.layout == "NHWC" and len(shape) == 4:
            shape = (shape[0], shape[3], shape[1], shape[2])
        return DataDesc(name, shape, np.float32)

    def __repr__(self):
        return "WireSpec(mean=%s, std=%s, layout=%s)" % (
            self.mean, self.std, self.layout)


def apply_wire(batch, ctx=None):
    """Decode a wire-format batch (idempotent): ``batch`` itself when it
    carries no :class:`WireSpec`, else a new batch whose data went
    through the decode, on ``ctx`` when given (the compact uint8 moves
    there first), else where the arrays lie. Labels are never on the
    wire."""
    wire = getattr(batch, "wire", None)
    if wire is None:
        return batch

    def _decode(d):
        if ctx is not None:
            d = d.as_in_context(ctx)
        return wire.decode(d)

    return DataBatch([_decode(d) for d in batch.data], batch.label,
                     pad=batch.pad, index=batch.index,
                     bucket_key=batch.bucket_key,
                     provide_data=batch.provide_data,
                     provide_label=batch.provide_label)


def wire_decode_ctx(contexts):
    """The device a wire batch is decoded on for a consumer bound to
    ``contexts``: the one device, or None (where the batch lies) for
    several."""
    return contexts[0] if contexts and len(contexts) == 1 else None


def _state_of(data_iter):
    """``state_dict()`` of an iterator, or None when it cannot seek."""
    fn = getattr(data_iter, "state_dict", None)
    return fn() if fn is not None else None


class DataIter:
    """Base iterator."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def state_dict(self):
        """A snapshot of the position such that :meth:`load_state` makes
        the iterator yield exactly the batches that would have followed
        (taken after batch n, it resumes at batch n + 1), or None when
        the iterator cannot seek."""
        return None

    def load_state(self, state):
        """Reposition to ``state`` (from :meth:`state_dict`)."""
        raise MXNetError("%s does not support load_state" % type(self).__name__)

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


def _init_data(data, allow_empty, default_name):
    """Normalize input data to a sorted list of (name, host numpy array)."""
    if data is None:
        if not allow_empty:
            raise ValueError("data is required")
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise ValueError("data is required")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of them "
                        "or dict with them as values")
    out = {}
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        try:
            v = np.asarray(v)
        except Exception as e:
            raise TypeError("Invalid type '%s' for %s, should be NDArray or "
                            "numpy.ndarray" % (type(v), k)) from e
        # float64 narrows to float32, as nd.array does
        out[k] = v.astype(np.float32) if v.dtype == np.float64 else v
    return sorted(out.items())


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays, held on the host.

    ``num_parts``/``part_index`` take the contiguous part ``part_index`` of
    ``num_parts`` of the arrays (the dmlc InputSplit contract), then the
    shuffle, seeded by ``seed`` when given. :meth:`set_partition` cuts the
    original arrays again (elastic training); a shuffle without ``seed``
    cannot be repeated and refuses to."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", seed=None, num_parts=1,
                 part_index=0):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise ValueError("last_batch_handle must be pad, discard or "
                             "roll_over, got %r" % (last_batch_handle,))
        self._full_data = _init_data(data, allow_empty=False,
                                     default_name=data_name)
        self._full_label = _init_data(label, allow_empty=True,
                                      default_name=label_name)
        self._shuffle = shuffle
        self._seed = seed
        self.last_batch_handle = last_batch_handle
        self.num_parts = int(num_parts)
        self.part_index = int(part_index)
        self._apply_partition()
        if self._shuffle and self._seed is None:
            # never cut again (set_partition refuses): keep no second copy
            self._full_data, self._full_label = self.data, self.label

    def _apply_partition(self):
        """The iteration arrays of the current partition: its contiguous
        part, then the shuffle (the global numpy RNG without a seed)."""
        if not 0 <= self.part_index < self.num_parts:
            raise ValueError("part_index %d is not in [0, %d)"
                             % (self.part_index, self.num_parts))
        n_total = self._full_data[0][1].shape[0]
        lo, hi = 0, n_total
        if self.num_parts > 1:
            n = n_total // self.num_parts
            lo, hi = self.part_index * n, (self.part_index + 1) * n
        data = [(k, v[lo:hi]) for k, v in self._full_data]
        label = [(k, v[lo:hi]) for k, v in self._full_label]
        n = hi - lo
        self.idx = np.arange(n)
        if self._shuffle:
            rng = (np.random.RandomState(self._seed)
                   if self._seed is not None else np.random)
            rng.shuffle(self.idx)
            data = [(k, v[self.idx]) for k, v in data]
            label = [(k, v[self.idx]) for k, v in label]
        if self.last_batch_handle == "discard":
            new_n = n - n % self.batch_size
            data = [(k, v[:new_n]) for k, v in data]
            label = [(k, v[:new_n]) for k, v in label]
        self.data, self.label = data, label
        self.data_list = [x[1] for x in self.data] + [x[1] for x in self.label]
        self.num_source = len(self.data_list)
        self.num_data = self.data_list[0].shape[0]
        if self.num_data < self.batch_size:
            raise ValueError("batch_size needs to be smaller than data size.")
        self.cursor = -self.batch_size

    def set_partition(self, num_parts, part_index):
        """Cut the original arrays into part ``part_index`` of
        ``num_parts`` and rewind; :meth:`load_state` then seeks within the
        new part. The same arrays, seed and partition give the same
        stream."""
        if self._shuffle and self._seed is None:
            raise MXNetError("NDArrayIter.set_partition with shuffle=True "
                             "requires seed= (the reshuffle must be "
                             "reproducible)")
        self.num_parts = int(num_parts)
        self.part_index = int(part_index)
        self._apply_partition()

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])), v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])), v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        """Back to the first batch, ignoring a roll-over."""
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" and self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def state_dict(self):
        """The cursor is the position (the arrays, and their shuffle, are
        the caller's: a resumed process rebuilds them alike)."""
        return {"type": "NDArrayIter", "cursor": int(self.cursor)}

    def load_state(self, state):
        self.cursor = int(state["cursor"])

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, data_source):
        if self.cursor >= self.num_data:
            raise ValueError("DataIter needs reset.")
        if self.cursor + self.batch_size <= self.num_data:
            return [array(x[1][self.cursor:self.cursor + self.batch_size], ctx=cpu())
                    for x in data_source]
        pad = self.batch_size - self.num_data + self.cursor
        return [array(np.concatenate((x[1][self.cursor:], x[1][:pad]), axis=0), ctx=cpu())
                for x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class ResizeIter(DataIter):
    """``data_iter`` cut or stretched to ``size`` batches per epoch: it is
    reset and read again when it ends early (reference: io.py:254)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def state_dict(self):
        inner = _state_of(self.data_iter)
        if inner is None:
            return None
        return {"type": "ResizeIter", "cur": self.cur, "inner": inner}

    def load_state(self, state):
        self.data_iter.load_state(state["inner"])
        self.cur = int(state["cur"])
        self.current_batch = None

    def set_partition(self, num_parts, part_index):
        """Reshard the inner iterator (the resized length is the
        consumer's and stays) and rewind."""
        inner = getattr(self.data_iter, "set_partition", None)
        if inner is None:
            raise MXNetError("%s does not support set_partition"
                             % type(self.data_iter).__name__)
        inner(num_parts, part_index)
        self.cur = 0
        self.current_batch = None

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _renamed(descs, rename):
    return [DataDesc(rename[d.name], d.shape, d.dtype)
            if isinstance(d, DataDesc) else DataDesc(rename[d[0]], d[1])
            for d in descs]


# race-ok: producer and consumer alternate strict turns through the
# data_taken/data_ready Event handshake — each slot is owned by exactly one
# side at any moment, and Event.set/wait give the happens-before edge
class PrefetchingIter(DataIter):
    """One thread per inner iterator reads its next batch while the
    consumer works on this one; the batches of all the iterators are
    joined into one (reference: io.py:319).

    Each producer and the consumer take strict turns on a slot through
    the ``data_taken``/``data_ready`` events, so a slot has one owner at a
    time. The producers run a batch ahead: the position
    (``state_dict``) is each inner iterator's as of the batch the
    consumer last took, not the one fetched ahead."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        if not iters:
            raise MXNetError("PrefetchingIter needs at least one iterator")
        self.n_iter = len(iters)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = None
        self.next_batch = [None] * self.n_iter
        self.next_state = [None] * self.n_iter
        self._delivered_states = [_state_of(i) for i in self.iters]

        def prefetch(i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = self.iters[i].next()
                    self.next_state[i] = _state_of(self.iters[i])
                except StopIteration:
                    self.next_batch[i] = None
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch, args=(i,), daemon=True,
                             name="mxnet-prefetch-%d" % i)
            for i in range(self.n_iter)]
        for t in self.prefetch_threads:
            t.start()

    def __del__(self):
        self.started = False
        for e in self.data_taken:
            e.set()
        for t in self.prefetch_threads:
            t.join()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([_renamed(i.provide_data, r)
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([_renamed(i.provide_label, r)
                    for r, i in zip(self.rename_label, self.iters)], [])

    def _park_and(self, fn):
        """Wait until every producer has parked a batch, run ``fn``, drop
        the parked batches and let the producers go on."""
        for e in self.data_ready:
            e.wait()
        fn()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def reset(self):
        def rewind():
            for i in self.iters:
                i.reset()
            self._delivered_states = [_state_of(i) for i in self.iters]
        self._park_and(rewind)

    def state_dict(self):
        states = list(self._delivered_states)
        if any(s is None for s in states):
            return None
        return {"type": "PrefetchingIter", "inner": states}

    def load_state(self, state):
        def seek():
            for it, s in zip(self.iters, state["inner"]):
                it.load_state(s)
            self._delivered_states = list(state["inner"])
        self._park_and(seek)

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        if self.next_batch[0] is None:
            if any(b is not None for b in self.next_batch):
                raise MXNetError("the prefetched iterators ended at "
                                 "different batches")
            return False
        if any(b.pad != self.next_batch[0].pad for b in self.next_batch):
            raise MXNetError("the prefetched iterators' batches differ in "
                             "padding")
        self.current_batch = DataBatch(
            sum([b.data for b in self.next_batch], []),
            sum([b.label for b in self.next_batch], []),
            self.next_batch[0].pad, self.next_batch[0].index,
            provide_data=self.provide_data, provide_label=self.provide_label)
        self._delivered_states = list(self.next_state)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class _ArrayFileIter(DataIter):
    """An iterator whose file contents were read into an ``NDArrayIter``
    (``self._iter``): everything forwards to it."""

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    def reset(self):
        self._iter.reset()

    def state_dict(self):
        return _state_of(self._iter)

    def load_state(self, state):
        self._iter.load_state(state)

    def next(self):
        return self._iter.next()

    def iter_next(self):
        return self._iter.iter_next()

    def getdata(self):
        return self._iter.getdata()

    def getlabel(self):
        return self._iter.getlabel()

    def getpad(self):
        return self._iter.getpad()


class MNISTIter(_ArrayFileIter):
    """MNIST's idx files (``.gz`` too), scaled to [0, 1], shuffled with
    ``seed``, ``flat`` (N, 784) or (N, 1, 28, 28), partial batches
    discarded (reference: src/io/iter_mnist.cc:241)."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, seed=0, silent=False, num_parts=1,
                 part_index=0, input_shape=None, **kwargs):
        super().__init__(batch_size)
        imgs = self._read_images(image)
        labels = self._read_labels(label)
        if num_parts > 1:
            n = imgs.shape[0] // num_parts
            imgs = imgs[part_index * n:(part_index + 1) * n]
            labels = labels[part_index * n:(part_index + 1) * n]
        if shuffle:
            perm = np.random.RandomState(seed).permutation(imgs.shape[0])
            imgs, labels = imgs[perm], labels[perm]
        imgs = imgs.astype(np.float32) / 255.0
        if flat:
            imgs = imgs.reshape(imgs.shape[0], -1)
        else:
            imgs = imgs.reshape(imgs.shape[0], 1, 28, 28)
        if input_shape is not None:
            imgs = imgs.reshape((imgs.shape[0],) + tuple(input_shape))
        self._iter = NDArrayIter(imgs, labels.astype(np.float32),
                                 batch_size=batch_size, shuffle=False,
                                 last_batch_handle="discard")

    @staticmethod
    def _open(path):
        if path.endswith(".gz"):
            return gzip.open(path, "rb")
        if not os.path.exists(path) and os.path.exists(path + ".gz"):
            return gzip.open(path + ".gz", "rb")
        return open(path, "rb")

    def _read_images(self, path):
        with self._open(path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise MXNetError("Invalid MNIST image file %s" % path)
            return np.frombuffer(f.read(n * rows * cols),
                                 dtype=np.uint8).reshape(n, rows, cols)

    def _read_labels(self, path):
        with self._open(path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise MXNetError("Invalid MNIST label file %s" % path)
            return np.frombuffer(f.read(n), dtype=np.uint8)


class CSVIter(_ArrayFileIter):
    """Rows of a CSV file reshaped to ``data_shape``, labels from
    ``label_csv`` (zeros without one); the last batch is padded with
    ``round_batch``, else dropped (reference: src/io/iter_csv.cc:132)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=128, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
            if tuple(label_shape) == (1,):
                label = label.reshape(-1)
        else:
            label = np.zeros(data.shape[0], dtype=np.float32)
        self._iter = NDArrayIter(
            data, label, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard",
            label_name="label")


def ImageRecordIter(**kwargs):
    """``mx.io.ImageRecordIter``: :class:`.io_image.ImageRecordIter`."""
    from .io_image import ImageRecordIter as _Impl

    return _Impl(**kwargs)


# thread-confined: a slot's pinned buffers are staged and read only by the
# DeviceFeedIter thread that owns its ring
class _PinnedSlot:
    """One slot of the feed's ring: pinned host buffers by position and
    shape, and the event of the last upload that read them."""

    __slots__ = ("bufs", "event")

    def __init__(self):
        self.bufs = {}
        self.event = None

    def stage(self, key, t):
        """``t`` copied into this slot's pinned buffer ``key``."""
        buf = self.bufs.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.bufs[key] = buf
        buf.copy_(t)
        return buf


class DeviceFeedIter(DataIter):
    """Asynchronous device feed over ``data_iter`` (the JAX package's
    ``DeviceFeedIter``; the host-to-device analog of the reference's
    ``PrefetcherIter``).

    A transfer thread pulls host batches, copies each array into a pinned
    buffer of a ring, uploads it to ``ctx``'s card on a side stream with a
    non-blocking copy and parks the device batch, with the upload's
    event, in a queue of ``depth`` batches; ``next()`` makes the consumer's
    stream wait for that event, so the card, not the host, orders the
    upload before the step that reads it. A ring slot is written again
    only after its last upload's event has completed. A uint8 wire batch
    is uploaded as it is and keeps its :class:`WireSpec`: the module
    decodes it (inside the fused step's CUDA graph). On the CPU the feed
    passes the batches through its thread unchanged.

    ``state_dict`` is the inner iterator's position as of the batches
    delivered, not those fetched ahead."""

    def __init__(self, data_iter, ctx=None, depth=2):
        super().__init__(getattr(data_iter, "batch_size", 0))
        self._iter = data_iter
        self._ctx = None if ctx is None else torch.device(ctx)
        self.depth = max(1, int(depth))
        self._cuda = self._ctx is not None and self._ctx.type == "cuda"
        self._ring = [_PinnedSlot() for _ in range(self.depth + 2)]
        self._slot = 0
        self._side = torch.cuda.Stream(self._ctx) if self._cuda else None
        self._start()

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    @property
    def default_bucket_key(self):
        return self._iter.default_bucket_key

    def _upload(self, batch):
        """One host batch onto the card; returns (device batch, event)."""
        slot = self._ring[self._slot]
        self._slot = (self._slot + 1) % len(self._ring)
        if slot.event is not None:
            slot.event.synchronize()
        arrays = list(batch.data) + list(batch.label or [])
        with torch.cuda.stream(self._side):
            dev = [a if a.data.device == self._ctx else
                   NDArray(slot.stage(i, a.data).to(self._ctx, non_blocking=True))
                   for i, a in enumerate(arrays)]
            slot.event = torch.cuda.Event()
            slot.event.record(self._side)
        n = len(batch.data)
        staged = DataBatch(dev[:n], dev[n:] if batch.label is not None else None,
                           pad=batch.pad, index=batch.index,
                           bucket_key=batch.bucket_key,
                           provide_data=batch.provide_data,
                           provide_label=batch.provide_label,
                           wire=getattr(batch, "wire", None))
        return staged, slot.event

    def _feed(self, q, stop):
        gauge = telemetry.gauge("pipeline.feed_depth")
        try:
            while not stop.is_set():
                try:
                    batch = self._iter.next()
                    inner_state = _state_of(self._iter)
                except StopIteration:
                    break
                tel = telemetry.enabled()
                t0 = time.perf_counter() if tel else 0.0
                # the `stall` fault point: delay_ms wedges the transfer
                # stage past the guard's watchdog deadline
                fault.hit("stall")
                staged, event = (self._upload(batch) if self._cuda
                                 else (batch, None))
                if tel:
                    telemetry.pipeline_stage("upload").observe(
                        time.perf_counter() - t0)
                if not self._put(q, stop, ("batch", staged, event, inner_state)):
                    return
                gauge.set(q.qsize())
        except Exception as e:  # noqa: BLE001 - surfaced on the consumer side
            self._put(q, stop, ("error", e))
            return
        self._put(q, stop, None)

    @staticmethod
    def _put(q, stop, item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _start(self):
        self._last_state = _state_of(self._iter)
        self._q = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._feed,
                                        args=(self._q, self._stop),
                                        daemon=True, name="DeviceFeedIter")
        self._thread.start()

    def next(self):
        tel = telemetry.enabled()
        t0 = time.perf_counter() if tel else 0.0
        item = self._q.get()
        if tel:
            telemetry.pipeline_stage("feed_wait").observe(time.perf_counter() - t0)
        if item is None or item[0] == "error":
            # terminal: later next() calls end too instead of blocking
            self._q.put_nowait(None)
            if item is None:
                raise StopIteration
            raise item[1]
        _, staged, event, inner_state = item
        if event is not None:
            current = torch.cuda.current_stream(self._ctx)
            current.wait_event(event)
            for a in list(staged.data) + list(staged.label or []):
                a.data.record_stream(current)
        self._last_state = inner_state
        return staged

    def state_dict(self):
        if self._last_state is None:
            return None
        return {"type": "DeviceFeedIter", "inner": self._last_state}

    def load_state(self, state):
        self.close()
        self._iter.load_state(state["inner"])
        self._start()

    def set_partition(self, num_parts, part_index):
        """Reshard the inner iterator and restart the feed over it."""
        inner = getattr(self._iter, "set_partition", None)
        if inner is None:
            raise MXNetError("%s does not support set_partition"
                             % type(self._iter).__name__)
        self.close()
        inner(num_parts, part_index)
        self._start()

    def close(self):
        """Stop the transfer thread (``next()`` then raises StopIteration)."""
        self._stop.set()
        deadline = time.time() + 10
        while self._thread.is_alive() and time.time() < deadline:
            self._drain()
            self._thread.join(timeout=0.2)
        self._drain()
        self._q.put_nowait(None)

    def _drain(self):
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def reset(self):
        self.close()
        self._iter.reset()
        self._start()


def maybe_device_feed(data_iter, contexts):
    """``data_iter`` wrapped in a :class:`DeviceFeedIter` of
    ``MXNET_FEED_DEPTH`` batches onto :func:`wire_decode_ctx`'s device when
    that variable is set above 0 (``fit`` calls this), else unchanged, as
    is a feed already."""
    depth = env_int("MXNET_FEED_DEPTH", 0)
    if depth <= 0 or isinstance(data_iter, DeviceFeedIter):
        return data_iter
    return DeviceFeedIter(data_iter, ctx=wire_decode_ctx(contexts),
                          depth=depth)
