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
side stream while the card computes. The record readers are
:mod:`.io_image` (``ImageRecordIter``, ``ImageDetRecordIter``).
"""
from __future__ import annotations

import queue
import threading
import time
from collections import namedtuple

import numpy as np
import torch

from . import telemetry
from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "WireSpec",
           "apply_wire", "wire_decode_ctx", "DeviceFeedIter"]


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
    """Iterate over in-memory arrays, held on the host."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label", seed=None):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise ValueError("last_batch_handle must be pad, discard or "
                             "roll_over, got %r" % (last_batch_handle,))
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)
        n = self.data[0][1].shape[0]
        self.idx = np.arange(n)
        if shuffle:
            rng = np.random.RandomState(seed) if seed is not None else np.random
            rng.shuffle(self.idx)
            self.data = [(k, v[self.idx]) for k, v in self.data]
            self.label = [(k, v[self.idx]) for k, v in self.label]
        if last_batch_handle == "discard":
            new_n = n - n % batch_size
            self.data = [(k, v[:new_n]) for k, v in self.data]
            self.label = [(k, v[:new_n]) for k, v in self.label]
        self.last_batch_handle = last_batch_handle
        self.data_list = [x[1] for x in self.data] + [x[1] for x in self.label]
        self.num_source = len(self.data_list)
        self.num_data = self.data_list[0].shape[0]
        if self.num_data < batch_size:
            raise ValueError("batch_size needs to be smaller than data size.")
        self.cursor = -batch_size

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])), v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])), v.dtype)
                for k, v in self.label]

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
