"""Monitor — per-node statistics during training (counterpart of
``mxnet_tpu/monitor.py``; reference: python/mxnet/monitor.py:16, wired
through ``Executor.set_monitor_callback`` →
GraphExecutor::ExecuteMonCallback, src/executor/graph_executor.cc:761-781).

While a monitor is active (its interval's batch) the executor runs its
forward with a callback on every node's visible outputs; ``toc()`` adds
the bound arguments and their gradients. A module with a monitor
installed trains on the classic executor path (``Module.install_monitor``
leaves the fused path, carrying its state).
"""
from __future__ import annotations

import logging
import re

from . import ndarray as nd
from .ndarray import NDArray

__all__ = ["Monitor"]


def _rms(x):
    """Default statistic: RMS magnitude — a scale-free divergence
    detector."""
    return nd.norm(x) / (x.size ** 0.5)


def _render(value):
    """Format one statistic (NDArray or list of NDArrays) for display."""
    values = value if isinstance(value, list) else [value]
    parts = []
    for v in values:
        if not isinstance(v, NDArray):
            raise TypeError("a monitor statistic must be an NDArray, got %s"
                            % type(v).__name__)
        small = v.shape in ((), (1,))
        parts.append(str(v.asscalar() if small else v.asnumpy()))
    return "\t".join(parts) + "\t"


class Monitor:
    """Every ``interval`` batches, record ``stat_func`` of each array whose
    name matches ``pattern``: node outputs (delivered by the executor's
    monitored forward), then — at ``toc()`` — weights and gradients;
    ``sort`` orders the records by name."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.interval = interval
        self.stat_func = stat_func if stat_func is not None else _rms
        self.sort = sort
        self.re_prog = re.compile(pattern)
        self.activated = False
        self.step = 0
        self.exes = []
        self.queue = []  # (step, name, stat) records of the current window

    def install(self, exe):
        """Attach to a bound executor (reference: monitor.py install)."""
        exe.set_monitor_callback(self.stat_helper,
                                 is_active=lambda: self.activated)
        self.exes.append(exe)

    def stat_helper(self, name, arr):
        """Node-output hook the executor's monitored forward calls."""
        if self.activated and self.re_prog.match(name):
            self._record(name, arr)

    def _record(self, name, arr):
        self.queue.append((self.step, name, self.stat_func(arr)))

    def tic(self):
        """Open a collection window if this batch is on the interval."""
        if self.step % self.interval == 0:
            self._drain_pending_writes()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Close the window: sweep weights and gradients, return the
        records as ``(step, name, rendered value)`` tuples."""
        if not self.activated:
            return []
        self._drain_pending_writes()
        for exe in self.exes:
            for name, weight, grad in zip(exe._arg_names, exe.arg_arrays,
                                          exe.grad_arrays):
                if self.re_prog.match(name):
                    self._record(name, weight)
                if grad is not None and self.re_prog.match(name + "_grad"):
                    self._record(name + "_grad", grad)
        self.activated = False
        records = (sorted(self.queue, key=lambda r: r[1]) if self.sort
                   else self.queue)
        out = [(step, name, _render(value)) for step, name, value in records]
        self.queue = []
        return out

    def toc_print(self):
        """Log this window's records (reference: monitor.py toc_print)."""
        for step, name, rendered in self.toc():
            logging.info("Batch: %7d %30s %s", step, name, rendered)

    def _drain_pending_writes(self):
        for exe in self.exes:
            for array in exe.arg_arrays:
                array.wait_to_read()
