"""The host-side dependency engine (counterpart of ``mxnet_tpu/engine.py``;
reference: include/mxnet/engine.h:75-250, src/engine/engine.cc:13-39).

The card orders its own work on its streams, so this engine schedules
host work: the distributed store's pushes and pulls (:mod:`.kvstore`).
An op declares const (read) and mutable (write) variables; writes are
exclusive, reads shared, FIFO per variable. :class:`ThreadedEngine` runs
ops on the worker threads of the native engine (``csrc/native/engine.cc``,
built by :mod:`._native`; ``MXNET_CPU_WORKER_NTHREADS`` sizes the pool);
``MXNET_ENGINE_TYPE=NaiveEngine`` runs each op inline on the pushing
thread. Without the native library :class:`ThreadedEngine` raises: no
engine is chosen for the caller behind its back.

Errors: an exception raised inside a pushed op is recorded (the first
wins) and raised from the next ``wait_for_var``/``wait_all`` on any
thread, then cleared; it is never printed and dropped. The native
engine calls every op through one ctypes trampoline, which must not let
an exception escape into C++: it records it instead.

With ``MXNET_ENGINE_SANITIZER=warn|strict`` both engines check each push
against its declared variables (:mod:`.analysis.sanitizer`): a deleted
declared var raises at the push, an undeclared or const write found while
the op runs surfaces through the error slot at the next wait.
"""
from __future__ import annotations

import ctypes
import logging
import os
import threading

from . import _native, base, telemetry
from .analysis import sanitizer as _sanitizer

__all__ = ["Engine", "NaiveEngine", "ThreadedEngine", "get_engine", "Var"]


class Var:
    """A dependency token (reference: engine.h VarHandle). ``deleted`` is
    set by ``delete_variable`` so the dependency sanitizer can flag a use
    after free; the scheduler itself never reads it."""

    __slots__ = ("handle", "deleted")

    def __init__(self, handle):
        self.handle = handle
        self.deleted = False


class Engine:
    """The error contract both engines share (see the module docstring)."""

    def __init__(self):
        self._err_lock = threading.Lock()
        self._first_error = None  # guarded-by: _err_lock

    def _record_error(self, exc):
        log = logging.getLogger(__name__)
        with self._err_lock:
            if self._first_error is None:
                self._first_error = exc
                # logged now too: a program that never waits again would
                # otherwise leave no trace of the failure
                log.error("engine: pushed fn failed; will re-raise at the "
                          "next wait_for_var/wait_all", exc_info=exc)
                return
        log.error("engine: dropping secondary error (an earlier one is "
                  "pending re-raise at the next wait)", exc_info=exc)

    def _raise_pending(self):
        with self._err_lock:
            err, self._first_error = self._first_error, None
        if err is not None:
            raise err

    def new_variable(self):
        raise NotImplementedError

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0):
        raise NotImplementedError

    def wait_for_var(self, var):
        raise NotImplementedError

    def wait_all(self):
        raise NotImplementedError

    def delete_variable(self, var):
        raise NotImplementedError


class NaiveEngine(Engine):
    """Push runs the op (reference: src/engine/naive_engine.cc); its error
    still surfaces at the next wait, as with :class:`ThreadedEngine`.
    ``KeyboardInterrupt`` and ``SystemExit`` propagate at once: this is the
    pushing thread."""

    def new_variable(self):
        return Var(None)

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0):
        if _sanitizer.active():
            # strict mode raises HERE on a deleted declared var (caller bug,
            # synchronous by design); in-fn checks ride inside the wrapper
            _sanitizer.check_declared(const_vars, mutable_vars)
            fn = _sanitizer.wrap_push(fn, const_vars, mutable_vars)
        if telemetry.enabled():
            telemetry.counter("engine.pushes").inc()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — raised at the next wait
            self._record_error(e)

    def wait_for_var(self, var):
        self._raise_pending()

    def wait_all(self):
        self._raise_pending()

    def delete_variable(self, var):
        var.deleted = True


class ThreadedEngine(Engine):
    """The native threaded engine. A pushed callable is kept (by id) until
    its op runs; the C++ side calls it on a worker thread through the one
    trampoline."""

    def __init__(self, num_workers=None):
        super().__init__()
        lib = _native.load()   # raises MXNetError when it cannot be built
        if num_workers is None:
            num_workers = base.env_int("MXNET_CPU_WORKER_NTHREADS",
                                       min(8, os.cpu_count() or 1))
        self._lib = lib
        self._handle = lib.mxt_engine_create(num_workers)
        self._pending_lock = threading.Lock()
        self._pending = {}   # guarded-by: _pending_lock
        self._next_id = 1    # guarded-by: _pending_lock

        def trampoline(arg):
            with self._pending_lock:
                fn = self._pending.pop(int(arg))
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — never into C++
                self._record_error(e)

        self._trampoline = _native.ENGINE_FN(trampoline)  # kept alive

    def new_variable(self):
        return Var(self._lib.mxt_engine_new_var(self._handle))

    @staticmethod
    def _var_array(vars_):
        arr = (ctypes.c_void_p * max(len(vars_), 1))()
        for i, v in enumerate(vars_):
            arr[i] = v.handle
        return arr

    def push(self, fn, const_vars=(), mutable_vars=(), priority=0):
        if _sanitizer.active():
            _sanitizer.check_declared(const_vars, mutable_vars)
            fn = _sanitizer.wrap_push(fn, const_vars, mutable_vars)
        if telemetry.enabled():
            telemetry.counter("engine.pushes").inc()
        with self._pending_lock:
            key = self._next_id
            self._next_id += 1
            self._pending[key] = fn
        try:
            self._lib.mxt_engine_push(
                self._handle, ctypes.cast(self._trampoline, ctypes.c_void_p),
                key, self._var_array(const_vars), len(const_vars),
                self._var_array(mutable_vars), len(mutable_vars), priority)
        except BaseException:
            # the native side never saw the op: its trampoline will never
            # pop the entry
            with self._pending_lock:
                self._pending.pop(key, None)
            raise

    def wait_for_var(self, var):
        self._lib.mxt_engine_wait_for_var(self._handle, var.handle)
        self._raise_pending()

    def wait_all(self):
        self._lib.mxt_engine_wait_all(self._handle)
        self._raise_pending()

    def delete_variable(self, var):
        var.deleted = True
        self._lib.mxt_engine_delete_var(self._handle, var.handle)

    def __del__(self):
        try:
            self._lib.mxt_engine_wait_all(self._handle)
            self._lib.mxt_engine_destroy(self._handle)
        # fwlint: disable=swallowed-exception — interpreter teardown: the library's globals may be gone already
        except Exception:  # noqa: BLE001
            pass


_engine = None
_engine_lock = threading.Lock()


def get_engine():
    """The process's engine (reference: Engine::Get): ``MXNET_ENGINE_TYPE``
    ``NaiveEngine``, else :class:`ThreadedEngine`."""
    global _engine
    with _engine_lock:
        if _engine is None:
            kind = base.env_str("MXNET_ENGINE_TYPE", "ThreadedEngine")
            _engine = NaiveEngine() if kind == "NaiveEngine" else ThreadedEngine()
        return _engine
