"""Training callbacks of the port (counterpart of ``mxnet_tpu/callback.py``;
reference: python/mxnet/callback.py): the epoch-end checkpoint callbacks
``module_checkpoint`` and ``do_checkpoint`` (file names carry the count
of completed epochs), and the batch-end callbacks ``Speedometer`` (the
throughput logger), ``log_train_metric`` and ``ProgressBar``."""
from __future__ import annotations

import logging
import math
import sys
import time

from . import telemetry

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar"]


def _every(period, fn):
    """Epoch-end callback running ``fn(epoch_1based, sym, arg, aux)`` every
    ``period`` epochs."""
    period = max(1, int(period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        epoch = iter_no + 1
        if epoch % period == 0:
            fn(epoch, sym, arg, aux)

    return _callback


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """``mod.save_checkpoint(prefix, epoch, save_optimizer_states)`` every
    ``period`` epochs."""
    return _every(period, lambda epoch, *_: mod.save_checkpoint(
        prefix, epoch, save_optimizer_states))


def do_checkpoint(prefix, period=1):
    """``model.save_checkpoint`` of the epoch's symbol and parameters every
    ``period`` epochs."""
    from .model import save_checkpoint

    return _every(period, lambda epoch, sym, arg, aux: save_checkpoint(
        prefix, epoch, sym, arg, aux))


def log_train_metric(period, auto_reset=False):
    """Log the training metric every ``period`` batches (and reset it
    after each log with ``auto_reset``)."""

    def _callback(param):
        if param.nbatch % period or param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, name, value)
        if auto_reset:
            param.eval_metric.reset()

    return _callback


class Speedometer:
    """Throughput logger: samples/sec over each ``frequent``-batch window,
    logged with the metric on the batches where ``nbatch % frequent == 0``
    (the JAX package's schedule and log lines). The speed comes from a
    wall-clock window: the port's fit loop does not record
    ``fit.step_time_seconds``, which the JAX package reads instead when it
    is there. ``auto_reset`` resets the metric after each log line."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._window_start = None  # wall time at the start of the window
        self._prev_batch = None

    def __call__(self, param):
        now = time.time()
        restarted = self._prev_batch is not None and param.nbatch < self._prev_batch
        self._prev_batch = param.nbatch
        if self._window_start is None or restarted:
            # first batch of an epoch: open a fresh timing window
            self._window_start = now
            return
        if param.nbatch % self.frequent:
            return
        speed = self.frequent * self.batch_size / (now - self._window_start)
        telemetry.gauge("speedometer.samples_per_sec").set(speed)
        telemetry.event("speedometer", epoch=param.epoch, nbatch=param.nbatch,
                        samples_per_sec=round(speed, 3))
        metric = param.eval_metric
        if metric is not None:
            pairs = metric.get_name_value()
            if self.auto_reset:
                metric.reset()
            for name, value in pairs:
                logging.info(
                    "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\tTrain-%s=%f",
                    param.epoch, param.nbatch, speed, name, value)
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, param.nbatch, speed)
        self._window_start = now


class ProgressBar:
    """An in-place ASCII progress bar over ``total`` batches."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        frac = param.nbatch / float(self.total)
        filled = int(round(self.bar_len * frac))
        bar = "=" * filled + "-" * (self.bar_len - filled)
        sys.stdout.write("[%s] %s%%\r" % (bar, math.ceil(100.0 * frac)))
