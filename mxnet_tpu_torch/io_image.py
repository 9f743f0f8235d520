"""ImageRecordIter and ImageDetRecordIter of the port (counterpart of
``mxnet_tpu/io_image.py``) — the threaded RecordIO -> decode -> augment ->
batch pipeline.

Reference: src/io/iter_image_recordio_2.cc (ImageRecordIOParser2: chunked
InputSplit reading + OMP-parallel JPEG decode/augment :28-80, registered
:559) layered under BatchLoader (iter_batchloader.h) and PrefetcherIter
(iter_prefetcher.h).

Two backends, as in the JAX package. The Python pipeline: a reader
thread streams records, a pool of decode workers (threads; cv2 and PIL
decode release the GIL) decodes and augments, and a batcher reassembles
record order into batches behind a bounded prefetch queue; with one
decode thread its stream is reproducible bit for bit (the classification
augmenters draw from Python's global ``random``, the detection ones from
each worker's seeded ``random.Random``). The native stage
(``csrc/native/pipe.cc`` through :mod:`._native`): worker threads decode
(libjpeg, or nvJPEG on the card) and run the resize -> crop -> flip chain
in C++, drawing from a generator per (seed, epoch, worker); it is taken
when the configuration passes its eligibility gate (the uint8 wire, 3
channels, no index, no shuffle, that augmenter chain, a decoder built
in), and a configuration that asked for it by default and cannot have
it counts ``io.native_decode_fallback{reason}`` and takes the Python
pipeline. ``backend='native'`` raises instead of falling back.

Batches are host NDArrays (uint8 NHWC on the wire, else float32 NCHW);
a native batch is copied out of the stage's buffer before the buffer is
released, so a consumer may hold a batch as long as it likes.
``state_dict``/``load_state`` address a position by (epoch, batches) and
``set_partition`` reshards at an epoch's start.
"""
from __future__ import annotations

import atexit
import logging
import os
import queue
import threading
import time
import weakref

import numpy as np
import torch

from . import recordio
from . import telemetry
from .base import MXNetError
from .image import CreateAugmenter, imdecode, imdecode_np
from .io import DataBatch, DataDesc, DataIter, WireSpec
from .ndarray import NDArray

__all__ = ["ImageRecordIter", "ImageDetRecordIter"]

# iterators with live pipeline threads; closed at interpreter exit (see
# ImageRecordIter.close for why daemon-thread teardown is not enough)
_LIVE_ITERS = weakref.WeakSet()


@atexit.register
def _close_live_iters():
    for it in list(_LIVE_ITERS):
        try:
            it.close()
        # fwlint: disable=swallowed-exception — the interpreter is going down; nowhere left to report
        except Exception:  # noqa: BLE001
            pass


def _mean_std(mean_r, mean_g, mean_b, std_r, std_g, std_b):
    """The reference's mean_*/std_* kwargs -> (mean, std) arrays or None."""
    mean = None
    if mean_r or mean_g or mean_b:
        mean = np.array([mean_r, mean_g, mean_b], np.float32)
    std = None
    if std_r or std_g or std_b:
        std = np.array([std_r or 1, std_g or 1, std_b or 1], np.float32)
    return mean, std


# race-ok: the reader -> decode-worker -> batcher pipeline hands records
# through bounded Queues (their internal locks give the happens-before
# edge); each stage touches disjoint fields between handoffs, and reset()
# only runs after every stage thread joined
class ImageRecordIter(DataIter):
    _label_pad = 0.0

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=1,
                 shuffle=False, part_index=0, num_parts=1,
                 preprocess_threads=4, prefetch_buffer=4,
                 path_imgidx=None, round_batch=True, seed=0,
                 data_name="data", label_name="softmax_label",
                 # augmentation params (subset of the reference's ImageRecParserParam
                 # + ImageAugmentParam, src/io/image_aug_default.cc)
                 resize=0, rand_crop=False, rand_mirror=False, rand_resize=False,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=0.0, std_g=0.0, std_b=0.0,
                 max_random_contrast=0.0, max_random_illumination=0.0,
                 brightness=0.0, contrast=0.0, saturation=0.0, pca_noise=0.0,
                 wire_dtype=None, backend=None,
                 **kwargs):
        super().__init__(batch_size)
        self.data_shape = tuple(int(x) for x in data_shape)
        self.label_width = label_width
        self.batch_size = batch_size
        # backend: 'native' asks for the C++ stage (and raises without it),
        # 'python' pins the threaded pipeline, None takes the native stage
        # where the eligibility gate passes (with the uint8 wire, unless
        # wire_dtype pins float32) and counts the reason where it fails
        if backend not in (None, "python", "native"):
            raise MXNetError("backend must be 'python' or 'native', got %r"
                             % (backend,))
        if wire_dtype not in (None, "float32", "uint8"):
            raise MXNetError("wire_dtype must be 'float32' or 'uint8', got %r"
                             % (wire_dtype,))
        if wire_dtype == "uint8" and not self._supports_wire():
            raise MXNetError("%s does not support wire_dtype='uint8'"
                             % type(self).__name__)
        self._backend = backend
        self._native_fallback_why = None
        auto_wire = (backend != "python" and wire_dtype is None
                     and self._supports_wire())
        mean, std = _mean_std(mean_r, mean_g, mean_b, std_r, std_g, std_b)

        def _config_wire(on):
            # on the uint8 wire, batches stay uint8 HWC on the host and the
            # mean/std normalize and the transpose run on the device
            # (io.WireSpec); provide_data keeps the decoded float32 NCHW desc
            self._wire = WireSpec(mean, std, "NHWC") if on else None
            self.auglist = self._build_auglist(
                resize=resize, rand_crop=rand_crop,
                rand_resize=rand_resize, rand_mirror=rand_mirror,
                mean=None if on else mean, std=None if on else std,
                brightness=brightness or max_random_illumination / 255.0,
                contrast=contrast or max_random_contrast,
                saturation=saturation, pca_noise=pca_noise,
            )
            if on:
                # the wire stays uint8 on the host: no float round trip
                from .image import CastAug

                self.auglist = [a for a in self.auglist
                                if not isinstance(a, CastAug)]

        _config_wire(wire_dtype == "uint8" or auto_wire)
        self.path_imgrec = path_imgrec
        self.path_imgidx = path_imgidx
        self.shuffle = shuffle
        self.part_index = part_index
        self.num_parts = num_parts
        self.preprocess_threads = max(1, int(preprocess_threads))
        self.prefetch_buffer = max(1, int(prefetch_buffer))
        self.seed = seed
        self.provide_data = [DataDesc(data_name, (batch_size,) + self.data_shape)]
        if label_width > 1:
            self.provide_label = [DataDesc(label_name, (batch_size, label_width))]
        else:
            self.provide_label = [DataDesc(label_name, (batch_size,))]
        self._epoch = 0
        self._batches = 0  # batches emitted this epoch (the resume position)
        self._skipped = 0  # corrupt/undecodable records dropped (logged)
        # bad-record budget (MXNET_IO_MAX_BAD_RECORDS): unset skips forever;
        # N fails the iterator once more than N records were quarantined
        from .base import env_int

        self._max_bad = env_int("MXNET_IO_MAX_BAD_RECORDS", None)
        # the gate is decided once per iterator, so reset()/set_partition
        # rebuilds neither re-probe nor count twice
        why = None if backend == "python" else self._native_eligibility()
        if why is not None:
            if backend == "native":
                raise MXNetError("ImageRecordIter: the native decode stage "
                                 "cannot run this configuration (%s)" % why)
            if backend is None:
                self._native_fallback_why = why
                telemetry.counter("io.native_decode_fallback",
                                  reason=why).inc()
                if auto_wire:
                    _config_wire(False)
        self._start_pipeline()

    def _supports_wire(self):
        """Whether this iterator can ship uint8-HWC wire batches
        (ImageDetRecordIter can't: its det_auglist normalizes inline)."""
        return True

    def _build_auglist(self, **kwargs):
        """Classification augmenter list (ImageDetRecordIter overrides to
        skip this — its pipeline is the box-aware det_auglist)."""
        return CreateAugmenter(self.data_shape, **kwargs)

    def _process_record(self, s, use_np, rng=None):
        """One record -> (CHW float array — or HWC uint8 on the wire path —
        and flat label row). Runs on a decode worker thread (``rng``: that
        worker's seeded random.Random); ImageDetRecordIter overrides with
        the box-aware pipeline."""
        from . import fault

        # the `bad_record` fault injection point: makes this record
        # undecodable so the quarantine/budget path is testable
        # without shipping a corrupt .rec file
        if fault.hit("bad_record") is not None:
            raise MXNetError("injected bad record")
        header, img = recordio.unpack(s)
        if use_np:
            data = imdecode_np(img)
            for aug in self.auglist:
                data = aug.apply_np(data)
        else:
            data = imdecode(img)
            for aug in self.auglist:
                data = aug(data)
            data = data.asnumpy()
        arr = np.asarray(data)
        if self._wire is not None:
            # keep HWC; a float-producing augmenter (NDArray-chain fallback,
            # CastAug appended by hand) rounds back into the uint8 wire
            if arr.dtype != np.uint8:
                arr = np.clip(np.rint(arr), 0, 255).astype(np.uint8)
        else:
            arr = arr.transpose(2, 0, 1)  # HWC -> CHW
        return arr, np.asarray(header.label).reshape(-1)

    # ---- native decode stage (csrc/native/pipe.cc) -----------------------
    def _native_requested(self):
        return self._backend != "python" and self._native_fallback_why is None

    def _native_aug_plan(self):
        """Map ``auglist`` onto the native stage's fixed resize -> crop ->
        flip chain: ``(resize, crop_mode, mirror_prob)``, or None when an
        augmenter (or the order) is outside what augment.cc implements.
        Interp must be nonzero: the native resampler is PIL's BILINEAR,
        which imresize_np's PIL branch uses for every nonzero code."""
        from .image import (CenterCropAug, HorizontalFlipAug, RandomCropAug,
                            ResizeAug)

        resize, crop, mirror = 0, None, 0.0
        stage = 0  # 0: want resize/crop, 1: want crop, 2: want flip, 3: done
        for aug in self.auglist:
            t = type(aug)
            if t is ResizeAug and stage == 0 and aug.interp:
                resize, stage = int(aug.size), 1
            elif (t in (RandomCropAug, CenterCropAug) and stage <= 1
                  and aug.interp
                  and tuple(aug.size) == (self.data_shape[2],
                                          self.data_shape[1])):
                crop = 1 if t is RandomCropAug else 0
                stage = 2
            elif t is HorizontalFlipAug and stage == 2:
                mirror, stage = float(aug.p), 3
            else:
                return None
        if crop is None:
            return None
        return resize, crop, mirror

    def _native_eligibility(self):
        """The reason (``io.native_decode_fallback{reason}``) this
        configuration cannot run on the native stage, else None."""
        from . import _native

        if type(self)._process_record is not ImageRecordIter._process_record:
            return "subclass"
        if self._wire is None:
            return "wire"
        if self.data_shape[0] != 3:
            return "shape"
        if self.path_imgidx:
            return "indexed"
        if self.shuffle:
            return "shuffle"
        if self._native_aug_plan() is None:
            return "augmenters"
        try:
            lib = _native.load()
        except MXNetError:
            return "no_lib"
        if not lib.mxt_pipe_decode_available():
            return "no_jpeg"
        return None

    def _start_native(self):
        import ctypes

        from . import _native
        from .base import env_int

        lib = _native.load()
        resize, crop, mirror = self._native_aug_plan()
        threads = env_int("MXNET_DECODE_THREADS", 0) or self.preprocess_threads
        c, h, w = self.data_shape
        cfg = _native.MXTPipeConfig(
            path=self.path_imgrec.encode(),
            part_index=int(self.part_index), num_parts=int(self.num_parts),
            num_threads=max(1, int(threads)), batch_size=int(self.batch_size),
            out_h=h, out_w=w, out_c=c, label_width=int(self.label_width),
            seed=int(self.seed), epoch=int(self._epoch),
            resize=resize, crop=crop, mirror_prob=mirror,
            max_bad=-1 if self._max_bad is None else int(self._max_bad),
            prefetch=int(self.prefetch_buffer))
        handle = lib.mxt_pipe_create(ctypes.byref(cfg))
        if not handle:
            raise MXNetError("ImageRecordIter: the native decode stage could "
                             "not open %s" % self.path_imgrec)
        self._native = handle
        self._native_lib = lib
        self._native_polled = [0.0] * 6  # cumulative stats at the last poll
        _LIVE_ITERS.add(self)

    def _poll_native_stats(self):
        """Fold the native stage's cumulative counters into telemetry as
        deltas: bad records always, per-batch stage walls when enabled."""
        import ctypes

        raw = (ctypes.c_double * 6)()
        self._native_lib.mxt_pipe_stats(self._native, raw, 6)
        prev, cur = self._native_polled, list(raw)
        self._native_polled = cur
        bad = int(cur[0] - prev[0])
        if bad > 0:
            telemetry.counter("io.bad_records", source="decode").inc(bad)
            logging.warning(
                "ImageRecordIter[native]: %d corrupt record(s) quarantined "
                "(%d total)", bad, int(cur[0]))
        if telemetry.enabled():
            for i, stage in ((1, "decode_native"), (2, "augment_native"),
                             (3, "assemble_native")):
                if cur[i] > prev[i]:
                    telemetry.pipeline_stage(stage).observe(cur[i] - prev[i])

    def _native_next(self):
        """Pop the next batch of the native stage, copy it out of the
        stage's buffers and release them at once: the copy is the batch,
        so no consumer (a non-blocking upload, a slow step, a list that
        keeps batches) can see a buffer the stage has reused."""
        import ctypes

        c, h, w = self.data_shape
        dptr = ctypes.POINTER(ctypes.c_uint8)()
        lptr = ctypes.POINTER(ctypes.c_float)()
        pad = ctypes.c_int(0)
        rc = self._native_lib.mxt_pipe_pop(
            self._native, ctypes.byref(dptr), ctypes.byref(lptr),
            ctypes.byref(pad))
        self._poll_native_stats()
        if rc == 0:
            raise StopIteration
        if rc < 0:
            msg = self._native_lib.mxt_pipe_error(self._native)
            raise MXNetError((msg or b"native decode stage failed").decode())
        try:
            data = np.array(np.ctypeslib.as_array(
                dptr, shape=(self.batch_size, h, w, c)))
            label = np.array(np.ctypeslib.as_array(
                lptr, shape=(self.batch_size, self.label_width)))
        finally:
            self._native_lib.mxt_pipe_release(self._native, dptr, lptr)
        return data, label, pad.value

    # ---- pipeline --------------------------------------------------------
    def _record_stream(self):
        """Yield raw records for this worker's shard."""
        if self.path_imgidx:
            rec = recordio.MXIndexedRecordIO(self.path_imgidx, self.path_imgrec, "r")
            keys = list(rec.keys)
            if self.num_parts > 1:
                n = len(keys) // self.num_parts
                keys = keys[self.part_index * n : (self.part_index + 1) * n]
            if self.shuffle:
                rng = np.random.RandomState(self.seed + self._epoch)
                rng.shuffle(keys)
            for k in keys:
                yield rec.read_idx(k)
            rec.close()
        else:
            # native sharded reader: byte-range split + background producer
            # thread (the reference's InputSplit contract); python fallback
            # inside RecReader keeps round-robin semantics.
            rec = recordio.RecReader(
                self.path_imgrec, self.part_index, self.num_parts)
            for s in rec:
                yield s
            rec.close()

    def _start_pipeline(self):
        self._native = None
        if self._native_requested():
            self._start_native()
            return
        _LIVE_ITERS.add(self)
        self._raw_q = queue.Queue(maxsize=self.preprocess_threads * 8)
        self._out_q = queue.Queue(maxsize=self.prefetch_buffer)
        self._stop = threading.Event()

        def reader():
            try:
                for seq, s in enumerate(self._record_stream()):
                    if self._stop.is_set():
                        return
                    if not _put(self._raw_q, (seq, s)):
                        return
            finally:
                for _ in range(self.preprocess_threads):
                    _put(self._raw_q, None)

        # numpy fast path: when every augmenter has a real apply_np the
        # per-image pipeline stays in numpy; augmenters that customize
        # __call__ without a matching apply_np take the NDArray chain (the
        # shared rule: image.supports_np)
        from .image import supports_np

        use_np = all(supports_np(a) for a in self.auglist)

        def _get(q):
            # bounded wait so close()/reset() can never strand a thread
            # blocked in get() after the sentinels were drained
            while not self._stop.is_set():
                try:
                    return q.get(timeout=0.1)
                except queue.Empty:
                    continue
            return None

        def _put(q, item):
            # bounded wait so a full queue can't wedge a producer whose
            # consumer already stopped; returns False once stop is set
            # (sentinel lost, but every consumer loop also exits on stop)
            while not self._stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(wid):
            # per-worker deterministic augmentation stream: single-threaded
            # decode reproduces exactly for a given seed; with more threads
            # the streams stay deterministic but record->thread assignment
            # is scheduling-dependent (reference OMP pool has the same
            # property)
            import random as _random

            # int-tuple hash is run-stable (PYTHONHASHSEED only perturbs str)
            rng = _random.Random(hash((self.seed, self._epoch, wid)))
            # stage attribution: per-record decode+augment wall, resolved once — the registry lookup locks
            decode_hist = telemetry.pipeline_stage("decode")
            try:
                while not self._stop.is_set():
                    item = _get(self._raw_q)
                    if item is None:
                        return
                    seq, s = item
                    try:
                        tel = telemetry.enabled()
                        t0 = time.perf_counter() if tel else 0.0
                        arr, label = self._process_record(s, use_np, rng)
                        if tel:
                            decode_hist.observe(time.perf_counter() - t0)
                        _put(self._decoded_q, (seq, arr, label))
                    except Exception as e:  # noqa: BLE001 — corrupt record:
                        # quarantine: skip, but still claim the seq so
                        # reassembly can't stall; count + log so systematic
                        # failures (every record bad -> empty iterator) are
                        # diagnosable, and fail fast past the budget
                        n = self._skipped
                        self._skipped = n + 1
                        telemetry.counter("io.bad_records",
                                          source="decode").inc()
                        if n < 5 or n % 1000 == 0:
                            logging.warning(
                                "ImageRecordIter: skipping record %d (%s: %s); "
                                "%d skipped so far", seq, type(e).__name__, e, n + 1)
                        if self._max_bad is not None and n + 1 > self._max_bad:
                            _put(self._out_q, ("error", MXNetError(
                                "ImageRecordIter: %d corrupt records exceed "
                                "MXNET_IO_MAX_BAD_RECORDS=%d (last: %s: %s)"
                                % (n + 1, self._max_bad,
                                   type(e).__name__, e))))
                            return
                        _put(self._decoded_q, (seq, None, None))
            finally:
                # sentinel posts even if the thread dies, so the batcher's
                # done_workers count always completes
                _put(self._decoded_q, None)

        def batcher():
            import heapq

            c, h, w = self.data_shape
            done_workers = 0
            if self._wire is not None:
                # uint8-wire batches keep the workers' HWC layout and dtype;
                # the executor boundary restores fp32 NCHW on device
                buf_data = np.zeros((self.batch_size, h, w, c), np.uint8)
            else:
                buf_data = np.zeros((self.batch_size, c, h, w), np.float32)
            # detection iters pad with -1 (invalid class) so short labels can't
            # alias real class-0 objects; classification keeps 0
            buf_label = np.full((self.batch_size, self.label_width),
                                self._label_pad, np.float32)
            assemble_hist = telemetry.pipeline_stage("assemble")
            assemble_acc = [0.0]  # per-batch sum of slot-copy time
            i = 0
            # decode workers finish out of order; reassemble by sequence number
            # so batches keep record order (the reference's InstVector ordering,
            # iter_image_recordio_2.cc)
            pending = []
            next_seq = 0

            def _drain():
                nonlocal next_seq
                while pending and pending[0][0] == next_seq:
                    yield heapq.heappop(pending)[1:]
                    next_seq += 1

            def _emit(arr, label, i):
                tel = telemetry.enabled()
                t0 = time.perf_counter() if tel else 0.0
                buf_data[i] = arr
                buf_label[i, :] = self._label_pad
                buf_label[i, : len(label[: self.label_width])] = label[: self.label_width]
                i += 1
                full = i == self.batch_size
                if full:
                    out = (buf_data.copy(), buf_label.copy(), 0)
                if tel:
                    assemble_acc[0] += time.perf_counter() - t0
                    if full:
                        assemble_hist.observe(assemble_acc[0])
                        assemble_acc[0] = 0.0
                if full:
                    _put(self._out_q, out)
                    i = 0
                return i

            # bound on buffered out-of-order images: past this we give up on
            # strict ordering for the stuck gap rather than buffer the whole
            # shard in host RAM (one slow/huge record must not OOM the host)
            pending_cap = max(64, self.batch_size * 4, self.preprocess_threads * 16)
            while done_workers < self.preprocess_threads:
                item = _get(self._decoded_q)
                if item is None:
                    done_workers += 1
                    continue
                if item[0] < next_seq:
                    # a slow record the cap branch already skipped past: emit
                    # now (out of order) — pushing it would wedge the heap top
                    # below next_seq and stall draining until the next overflow
                    if item[1] is not None:
                        i = _emit(item[1], item[2], i)
                    continue
                heapq.heappush(pending, item)
                for arr, label in _drain():
                    if arr is not None:  # None = corrupt record, skipped
                        i = _emit(arr, label, i)
                if len(pending) > pending_cap:
                    seq, arr, label = heapq.heappop(pending)
                    logging.warning(
                        "ImageRecordIter: record %d still decoding after %d "
                        "newer records; emitting out of order to bound memory",
                        next_seq, len(pending))
                    next_seq = seq + 1
                    if arr is not None:
                        i = _emit(arr, label, i)
                    for arr, label in _drain():
                        if arr is not None:
                            i = _emit(arr, label, i)
            # stragglers (only if a worker died mid-sequence)
            while pending:
                arr, label = heapq.heappop(pending)[1:]
                if arr is not None:
                    i = _emit(arr, label, i)
            if i > 0:
                # pad the final batch (reference: round_batch/pad semantics)
                pad = self.batch_size - i
                for j in range(i, self.batch_size):
                    buf_data[j] = buf_data[j - i]
                    buf_label[j] = buf_label[j - i]
                _put(self._out_q, (buf_data.copy(), buf_label.copy(), pad))
            # stop-aware: a full queue at close() must not wedge the batcher
            # past close()'s join and leak the thread
            _put(self._out_q, None)

        self._decoded_q = queue.Queue(maxsize=self.preprocess_threads * 8)
        self._threads = [threading.Thread(target=reader, daemon=True,
                                          name="mxnet-rec-reader")]
        self._threads += [
            threading.Thread(target=worker, args=(i,), daemon=True,
                             name="mxnet-rec-decode-%d" % i)
            for i in range(self.preprocess_threads)
        ]
        self._threads.append(threading.Thread(target=batcher, daemon=True,
                                              name="mxnet-rec-batcher"))
        for t in self._threads:
            t.start()

    def close(self):
        """Stop the pipeline threads and release the reader.

        Called automatically at interpreter exit (atexit below): a daemon
        thread killed mid-``pthread_cond_wait`` inside the native reader
        aborts the process ('FATAL: exception not rethrown' — pthread_exit's
        forced unwind crossing noexcept C++ frames), so live iterators must
        wind down BEFORE CPython tears daemon threads down.
        """
        if getattr(self, "_native", None) is not None:
            self._poll_native_stats()
            self._native_lib.mxt_pipe_close(self._native)
            self._native = None
            # next() after close() raises StopIteration, as on the Python path
            self._out_q = queue.Queue()
            self._out_q.put_nowait(None)
            return
        if not hasattr(self, "_stop"):
            return
        self._stop.set()
        # drain + join until every thread is dead: a producer blocked inside
        # a bounded put can deposit one more item after a single drain pass,
        # so keep draining until the threads have actually exited (they all
        # re-check _stop within 0.1s once unblocked)
        import time as _time

        deadline = _time.time() + 10
        alive = list(self._threads)
        while alive and _time.time() < deadline:
            for q in (self._raw_q, self._decoded_q, self._out_q):
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
            for t in alive:
                t.join(timeout=0.2)
            alive = [t for t in alive if t.is_alive()]
        # final drain, then the end-of-stream marker so next() after close()
        # raises StopIteration instead of blocking (and never sees a stale
        # batch ahead of the marker)
        try:
            while True:
                self._out_q.get_nowait()
        except queue.Empty:
            pass
        try:
            self._out_q.put_nowait(None)
        except queue.Full:  # unreachable: queue just drained, threads dead
            pass

    def reset(self):
        self.close()
        self._epoch += 1
        self._batches = 0
        self._start_pipeline()

    def _next_item(self):
        """One raw ``(data, label, pad)`` from the pipeline; raises
        StopIteration at end-of-stream and re-raises a pipeline error item
        (bad-record budget exceeded) on the consumer thread."""
        if self._native is not None:
            item = self._native_next()
            self._batches += 1
            return item
        item = self._out_q.get()
        if item is None:
            raise StopIteration
        if len(item) == 2 and item[0] == "error":
            # terminal: later next() calls must stop, not block on a
            # pipeline whose workers bailed out
            try:
                self._out_q.put_nowait(None)
            except queue.Full:
                pass
            raise item[1]
        self._batches += 1
        return item

    def set_partition(self, num_parts, part_index):
        """Epoch-scoped reshard (elastic training): rebuild the decode pipeline over part ``part_index``
        of ``num_parts`` of the record stream, at the start of the current
        (seed, epoch) — the shard order stays a pure function of
        (seed, epoch, partition), so every worker's post-reshard stream is
        deterministic. Follow with :meth:`load_state` to fast-forward to a
        mid-epoch batch."""
        if not 0 <= int(part_index) < int(num_parts):
            raise MXNetError("set_partition: part %s of %s"
                             % (part_index, num_parts))
        self.close()
        self.num_parts = int(num_parts)
        self.part_index = int(part_index)
        self._batches = 0
        self._start_pipeline()

    def state_dict(self):
        """Resume position: the deterministic record stream is a function of
        (seed, epoch); the batch count within it completes the address."""
        return {"type": "ImageRecordIter", "epoch": self._epoch,
                "batches": self._batches}

    def load_state(self, state):
        """Reposition by rebuilding the (seed, epoch) pipeline and
        fast-forwarding ``batches`` batches through it. Decode-and-discard
        is deliberate: skipping raw records instead would drift by however
        many corrupt records the workers quarantined."""
        self.close()
        self._epoch = int(state["epoch"])
        self._batches = 0
        self._start_pipeline()
        for _ in range(int(state["batches"])):
            self.next()

    def next(self):
        data, label, pad = self._next_item()
        label_out = label if self.label_width > 1 else label[:, 0]
        # host NDArrays; a wire batch stays uint8 and carries its WireSpec
        return DataBatch(
            [NDArray(torch.from_numpy(data))],
            [NDArray(torch.from_numpy(np.ascontiguousarray(label_out)))],
            pad=pad, provide_data=self.provide_data,
            provide_label=self.provide_label, wire=self._wire,
        )


class ImageDetRecordIter(ImageRecordIter):
    """Detection variant: variable-object box labels per record, augmented
    box-aware in the decode workers (reference:
    src/io/iter_image_det_recordio.cc + image_det_aug_default.cc — the SSD
    pipeline: color jitter → mirror → random pad → constrained random crop
    → force resize, with boxes transformed alongside the pixels; augmenter
    params keep the reference's names/defaults, see
    ``image_det.CreateDetAugmenter``).

    Record label layout (reference det recordio contract): a flat float
    list, optionally prefixed with [header_width, object_width]; objects
    are rows of ``object_width`` floats ``[class, x0, y0, x1, y1, ...]``
    with corner coordinates normalized to [0, 1]. Batches emit
    ``(batch, max_objects, object_width)`` padded with -1 rows — the shape
    MultiBoxTarget consumes.
    """

    _label_pad = -1.0

    def _supports_wire(self):
        return False  # det_auglist normalizes inline (box-aware pipeline)

    def __init__(self, path_imgrec, data_shape, batch_size, label_width=-1,
                 max_objects=32, object_width=5,
                 rand_mirror=False, rand_mirror_prob=None,
                 resize=0, rand_crop_prob=0.0,
                 min_crop_scales=(0.0,), max_crop_scales=(1.0,),
                 min_crop_aspect_ratios=(1.0,), max_crop_aspect_ratios=(1.0,),
                 min_crop_overlaps=(0.0,), max_crop_overlaps=(1.0,),
                 min_crop_sample_coverages=(0.0,),
                 max_crop_sample_coverages=(1.0,),
                 min_crop_object_coverages=(0.0,),
                 max_crop_object_coverages=(1.0,),
                 num_crop_sampler=1, crop_emit_mode="center",
                 emit_overlap_thresh=0.3, max_crop_trials=(25,),
                 rand_pad_prob=0.0, max_pad_scale=1.0, fill_value=127,
                 inter_method=1,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=0.0, std_g=0.0, std_b=0.0,
                 brightness=0.0, contrast=0.0, saturation=0.0, **kwargs):
        from .image_det import CreateDetAugmenter

        self.object_width = int(object_width)
        # honor the reference's label_pad_width-style knob: a positive
        # label_width fixes the padded label length and implies max_objects
        self.max_objects = (int(label_width) // self.object_width
                            if int(label_width) > 0 else int(max_objects))
        mean, std = _mean_std(mean_r, mean_g, mean_b, std_r, std_g, std_b)
        if rand_mirror_prob is None:
            rand_mirror_prob = 0.5 if rand_mirror else 0.0
        self.det_auglist = CreateDetAugmenter(
            data_shape, resize=resize, rand_crop_prob=rand_crop_prob,
            min_crop_scales=min_crop_scales, max_crop_scales=max_crop_scales,
            min_crop_aspect_ratios=min_crop_aspect_ratios,
            max_crop_aspect_ratios=max_crop_aspect_ratios,
            min_crop_overlaps=min_crop_overlaps,
            max_crop_overlaps=max_crop_overlaps,
            min_crop_sample_coverages=min_crop_sample_coverages,
            max_crop_sample_coverages=max_crop_sample_coverages,
            min_crop_object_coverages=min_crop_object_coverages,
            max_crop_object_coverages=max_crop_object_coverages,
            num_crop_sampler=num_crop_sampler,
            crop_emit_mode=crop_emit_mode,
            emit_overlap_thresh=emit_overlap_thresh,
            max_crop_trials=max_crop_trials,
            rand_pad_prob=rand_pad_prob, max_pad_scale=max_pad_scale,
            rand_mirror_prob=rand_mirror_prob, fill_value=fill_value,
            inter_method=inter_method, brightness=brightness,
            contrast=contrast, saturation=saturation, mean=mean, std=std)
        kwargs.pop("rand_crop", None)
        kwargs.pop("rand_resize", None)
        super().__init__(
            path_imgrec, data_shape, batch_size,
            label_width=self.max_objects * self.object_width,
            rand_mirror=False, **kwargs)
        label_name = self.provide_label[0].name
        self.provide_label = [DataDesc(
            label_name, (batch_size, self.max_objects, self.object_width))]

    def _parse_det_boxes(self, flat):
        """Flat record label -> (n, object_width) float32 rows, header
        stripped; missing trailing per-object fields stay -1."""
        flat = np.asarray(flat, np.float32).reshape(-1)
        ow = self.object_width
        if flat.size >= 2 and float(flat[0]).is_integer() and 2 <= flat[0] <= 16:
            hdr = int(flat[0])
            if flat.size > hdr and float(flat[1]).is_integer() and flat[1] >= 5:
                ow = int(flat[1])
                flat = flat[hdr:]
        n = flat.size // ow
        rows = flat[: n * ow].reshape(n, ow)[:, : self.object_width]
        out = -np.ones((n, self.object_width), np.float32)
        out[:, : rows.shape[1]] = rows
        return out

    def _build_auglist(self, **kwargs):
        return []  # detection uses det_auglist; see _process_record

    def _process_record(self, s, use_np, rng=None):
        import random as _random

        header, img = recordio.unpack(s)
        boxes = self._parse_det_boxes(np.asarray(header.label))
        arr = imdecode_np(img)
        rng = rng or _random
        for aug in self.det_auglist:
            arr, boxes = aug.apply_np(arr, boxes, rng)
        arr = np.ascontiguousarray(np.asarray(arr).transpose(2, 0, 1))
        padded = -np.ones((self.max_objects, self.object_width), np.float32)
        n = min(boxes.shape[0], self.max_objects)
        padded[:n] = boxes[:n]
        return arr, padded.reshape(-1)

    def next(self):
        data, label, pad = self._next_item()
        boxes = label.reshape(label.shape[0], self.max_objects,
                              self.object_width)
        return DataBatch(
            [NDArray(torch.from_numpy(data))],
            [NDArray(torch.from_numpy(np.ascontiguousarray(boxes)))], pad=pad,
            provide_data=self.provide_data, provide_label=self.provide_label,
        )
