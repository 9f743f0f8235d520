"""One program per serving shape bucket: :class:`BucketGraph`, the port's
counterpart of the JAX engine's per-bucket ``compileobs.jit`` wrappers
(``mxnet_tpu/serving/engine.py``), which compile a step once per padded
shape and replay it.

On the card a bucket's step (:func:`.model.prefill`, ``decode`` or
``extend`` at that bucket's shapes) is captured once as a
``torch.cuda.CUDAGraph`` and replayed: one launch of the whole step from
the host instead of one per kernel. The capture follows the rules the
fused training step keeps (``parallel/spmd.py``):

* every tensor the step reads is static: the weights and the pool pages
  are allocated once by the engine and only written in place; the step's
  int32 inputs (tokens, positions, block tables, context lengths, the
  prompt length) live in one device buffer per graph, filled before each
  run with one ``copy_`` from one pinned host staging buffer;
* the bucket's first call runs the step eagerly on a side stream (the
  warm-up: it loads the kernels' libraries and makes cuBLAS's handles; its
  outputs are that call's result), then records it into the graph (nothing
  runs); every later call replays it and returns the graph's own output
  tensors, valid until the next call of the same bucket;
* each graph has its own private memory pool: buckets replay in any
  order, and a shared pool would hold only if they replayed in capture
  order;
* a kernel's launch count (``ops._build.Kernel.launches``) goes up by its
  launches in the captured step on every replay; the capture counts none.

Nothing falls back: a failed capture or replay raises. On the CPU the same
object runs the step eagerly on its static buffers at every call (the CPU
path the caller asked for); the first call there counts as the bucket's
build, so ``captures`` reads one per bucket used on either device.

Each build is a ``compileobs`` compile of ``program`` (its
``compile.count``/``compile.seconds`` metrics, a span on the profiler's
compile lane, the bucket's input shapes as its signature) and each later
call a run.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import compileobs

__all__ = ["BucketGraph"]


class BucketGraph:
    """``fn`` at one bucket's input shapes on ``device``, built once and
    replayed. ``fn(*inputs)`` takes the int32 input tensors (of
    ``shapes``, in order) and returns a tuple of output tensors;
    ``program`` names the program family in ``stats()`` and telemetry
    (``serving.prefill``, ``serving.decode``, ``serving.draft``,
    ``serving.verify``)."""

    def __init__(self, program, fn, shapes, device):
        self.program = program
        self.device = torch.device(device)
        self._fn = fn
        self._shapes = [tuple(int(d) for d in s) for s in shapes]
        sizes = [int(np.prod(s)) for s in self._shapes]
        self._cuda = self.device.type == "cuda"
        self._host = torch.zeros(sum(sizes), dtype=torch.int32,
                                 pin_memory=self._cuda)
        self._host_np = self._host.numpy()
        self._buf = torch.zeros(sum(sizes), dtype=torch.int32,
                                device=self.device)
        #: the static input tensors the step reads, views of one buffer
        self.inputs = []
        self._spans = []
        off = 0
        for shape, n in zip(self._shapes, sizes):
            self.inputs.append(self._buf[off:off + n].view(shape))
            self._spans.append((off, n))
            off += n
        # the last host->device copy: the host buffer is not rewritten
        # before it has landed
        self._copied = torch.cuda.Event() if self._cuda else None
        self._graph = None
        self._outs = None
        self._per_replay = {}
        #: builds (CUDA: captures; CPU: first runs), their host seconds,
        #: the calls served after the build and their host seconds (on
        #: the card: the replay's enqueue, not its device time)
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.run_s = 0.0

    @property
    def built(self):
        return self.captures > 0

    def __call__(self, *arrays):
        """Stage ``arrays`` (host int arrays of the bucket's shapes) into
        the static inputs and run the step: its output tensors."""
        self._stage(arrays)
        if not self.built:
            return self._build()
        t0 = time.perf_counter()
        if self._cuda:
            self._graph.replay()
            from ..ops import _build

            for name, n in self._per_replay.items():
                _build.KERNELS[name].launches += n
            outs = self._outs
        else:
            outs = self._fn(*self.inputs)
        dt = time.perf_counter() - t0
        self.replays += 1
        self.run_s += dt
        compileobs.note_run(self.program, dt)
        return outs

    def _stage(self, arrays):
        if len(arrays) != len(self._shapes):
            raise ValueError("%s: %d inputs for %d static buffers"
                             % (self.program, len(arrays), len(self._shapes)))
        if self._copied is not None:
            self._copied.synchronize()
        for (off, n), shape, a in zip(self._spans, self._shapes, arrays):
            a = np.asarray(a)
            if a.shape != shape:
                raise ValueError("%s: input of shape %s for a static buffer "
                                 "of %s" % (self.program, a.shape, shape))
            self._host_np[off:off + n] = a.reshape(-1)
        self._buf.copy_(self._host, non_blocking=self._cuda)
        if self._copied is not None:
            self._copied.record()

    def _build(self):
        t0 = time.perf_counter()
        wall0 = time.time()
        if not self._cuda:
            outs = self._fn(*self.inputs)
        else:
            outs = self._capture()
        dt = time.perf_counter() - t0
        self.captures += 1
        self.capture_s += dt
        compileobs.note_compile(
            self.program, dt,
            compileobs.signature(zip(("in%d" % i for i in range(len(self.inputs))),
                                     self.inputs)),
            graph_key=id(self), site="mxnet_tpu_torch/serving/graphs.py:"
                                      "BucketGraph", wall0=wall0)
        return outs

    def _capture(self):
        """Warm up on a side stream (its outputs are this call's result),
        then record the step into the graph; the launches the kernel
        wrappers count while recording become the count each replay adds,
        and are taken back from the counters."""
        from ..ops import _build

        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            outs = self._fn(*self.inputs)
        stream.wait_stream(side)
        before = {n: k.launches for n, k in _build.KERNELS.items()}
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a finalizer that calls
        # the CUDA runtime on this thread would end it (as in the fused
        # step's capture)
        gc.collect()
        gc_was = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                self._outs = self._fn(*self.inputs)
        finally:
            if gc_was:
                gc.enable()
        for n, k in _build.KERNELS.items():
            if k.launches != before[n]:
                self._per_replay[n] = k.launches - before[n]
                k.launches = before[n]
        self._graph = graph
        return outs
