"""The parameter-server process (counterpart of
``mxnet_tpu/kvstore_server.py``; reference: python/mxnet/kvstore_server.py).

A process launched with ``DMLC_ROLE=server`` (``tools/launch.py``) blocks
inside ``import mxnet_tpu_torch`` (:func:`_init_kvstore_server_module`),
serving one shard of the keys over the port's copy of the JAX package's
transport (``csrc/native/ps.cc``) until worker 0 stops it. A sync server
merges every worker's push of a key before it updates (BSP); an async one
(a worker sent ``sync:0``) updates on each push.

The update runs the real optimizer that worker 0 pickled
(``KVStore.set_optimizer``) key by key on flat float32 views of the
server's buffers. Without one the merged value is stored as it is. The
weights and optimizer states live on the host, as CPU tensors: the server
shares its machine with workers that train on the card, and it never
creates a CUDA context.

All Python work (unpickling the optimizer, the updates) runs on the
server's main thread, fed by a queue: the transport's connection threads
only enqueue and wait. The main thread stays inside ``import
mxnet_tpu_torch`` for the process's life, holding the package's import
lock, so a connection thread must never import from the package; this
module imports what they need at its top.

A failed update leaves the key's weight as it was; it is counted and
logged, and past ``MXNET_KV_SERVER_MAX_UPDATE_FAILURES`` (default 10; 0:
the first) the server stops with an error rather than keep serving stale
weights.

The optimizer is pickled under ``mxnet_tpu_torch.optimizer`` names: a
cluster is one package. A worker of the JAX package cannot drive a server
of the port, or the reverse, though the wire is the same.

Not ported (``ROADMAP.md`` A6c): replicas and their failover, the
membership registry, server checkpoints, the statistics and trace
channels.
"""
from __future__ import annotations

import base64
import ctypes
import logging
import os
import pickle
import queue
import sys
import threading

import numpy as np
import torch

from . import _native
from . import optimizer as opt
from .base import env_int
from .ndarray import NDArray
from .utils.atomic_file import atomic_write, read_verified

__all__ = ["KVStoreServer", "_init_kvstore_server_module"]

log = logging.getLogger(__name__)


class KVStoreServer:
    """One shard of the parameter server (reference: kvstore_server.py:20
    KVStoreServer)."""

    def __init__(self, port=None, num_workers=None, sync=True):
        # raises MXNetError when the library cannot be built or loaded
        lib = _native.load()
        self._lib = lib
        if port is None:
            port = (int(os.environ.get("DMLC_PS_ROOT_PORT", "9091"))
                    + int(os.environ.get("DMLC_SERVER_ID", "0")))
        if num_workers is None:
            num_workers = int(os.environ.get("DMLC_NUM_WORKER", "1"))
        self._handle = lib.mxt_ps_server_create(port, num_workers,
                                                1 if sync else 0)
        if not self._handle:
            raise RuntimeError("cannot bind PS server port %d" % port)
        self._port = port
        self._updater = None   # the Updater of the pickled optimizer
        self._updater_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._updates_applied = 0      # guarded-by: _stats_lock
        self._update_failures = 0      # guarded-by: _stats_lock
        self._last_update_error = None  # guarded-by: _stats_lock
        self._max_update_failures = env_int(
            "MXNET_KV_SERVER_MAX_UPDATE_FAILURES", 10)
        self._exec_q = queue.Queue()
        self._apply_cb = _native.UPDATER_FN(self._apply)   # kept alive
        self._command_cb = _native.COMMAND_FN(self._command)
        lib.mxt_ps_server_set_updater(
            self._handle, ctypes.cast(self._apply_cb, ctypes.c_void_p))
        lib.mxt_ps_server_set_command_handler(
            self._handle, ctypes.cast(self._command_cb, ctypes.c_void_p))

    # ---- the main thread's queue -----------------------------------------
    def _on_main(self, fn):
        """Run ``fn`` on the main thread and wait; returns its exception,
        or None."""
        done = threading.Event()
        box = {}

        def task():
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — the caller decides
                box["err"] = e
            finally:
                done.set()

        self._exec_q.put(task)
        done.wait()
        return box.get("err")

    # ---- callbacks from the transport's connection threads ---------------
    def _apply(self, key, grad_ptr, weight_ptr, n):
        """Update ``key``'s ``n`` stored floats with the merged push (or
        store the push when there is no optimizer)."""
        grad = np.ctypeslib.as_array(
            ctypes.cast(grad_ptr, ctypes.POINTER(ctypes.c_float)), (n,))
        weight = np.ctypeslib.as_array(
            ctypes.cast(weight_ptr, ctypes.POINTER(ctypes.c_float)), (n,))
        with self._updater_lock:
            updater = self._updater
        if updater is None:
            weight[:] = grad
            return
        key = int(key)

        def work():
            w = NDArray(torch.from_numpy(weight.copy()))
            updater(key, NDArray(torch.from_numpy(grad.copy())), w)
            weight[:] = w.asnumpy()

        err = self._on_main(work)
        if err is None:
            with self._stats_lock:
                self._updates_applied += 1
        else:
            self._note_update_failure(key, err)

    def _command(self, cmd_ptr, n):
        cmd = ctypes.string_at(cmd_ptr, n)
        if cmd.startswith(b"optim:"):
            blob = base64.b64decode(cmd[6:])
            err = self._on_main(lambda: self._set_optimizer(pickle.loads(blob)))
            if err is not None:
                log.error("kvstore-server: cannot install the optimizer: %r",
                          err)
        elif cmd.strip() == b"stats":
            log.warning("kvstore-server stats: %s", self.stats())
        elif not cmd.startswith((b"ping", b"sync:")):
            # (the transport itself handles ping and sync:)
            log.error("kvstore-server: command %r is not ported yet "
                      "(ROADMAP.md A6c); ignored", cmd[:32])

    def _note_update_failure(self, key, err):
        """Count a failed update (the weight kept its value); past the
        threshold, queue a task that raises out of :meth:`run`."""
        with self._stats_lock:
            self._update_failures += 1
            self._last_update_error = "key %d: %r" % (key, err)
            failures = self._update_failures
        log.error("kvstore-server: updater failed for key %d (%d failure(s) "
                  "so far, threshold %d): %r", key, failures,
                  self._max_update_failures, err)
        if failures > self._max_update_failures:
            stats = self.stats()

            def die():
                raise RuntimeError(
                    "kvstore-server: %d optimizer updates failed (threshold "
                    "%d) — refusing to keep serving stale weights; last "
                    "error: %s" % (stats["update_failures"],
                                   self._max_update_failures,
                                   stats["last_update_error"])) from err

            self._exec_q.put(die)

    # ---- the optimizer -----------------------------------------------------
    def _set_optimizer(self, optimizer):
        """Install ``optimizer``; a re-sent optimizer keeps the states."""
        updater = opt.get_updater(optimizer)
        with self._updater_lock:
            if self._updater is not None:
                updater.states = self._updater.states
            self._updater = updater

    def save_states(self, fname):
        """Write the optimizer states (the ``.states`` format: a pickled
        ``{key: numpy state}``)."""
        with self._updater_lock:
            updater = self._updater
        if updater is None:
            raise RuntimeError("kvstore-server: no optimizer installed")
        with atomic_write(fname) as f:
            f.write(updater.get_states())

    def load_states(self, fname):
        """Adopt a ``.states`` file's optimizer states."""
        with self._updater_lock:
            updater = self._updater
        if updater is None:
            raise RuntimeError("kvstore-server: no optimizer installed")
        updater.set_states(read_verified(fname))

    def stats(self):
        """Health counters."""
        with self._stats_lock:
            return {"updates_applied": self._updates_applied,
                    "update_failures": self._update_failures,
                    "last_update_error": self._last_update_error,
                    "has_optimizer": self._updater is not None}

    # ---- serving -------------------------------------------------------------
    def run(self):
        """Serve until a worker sends the stop command, running the Python
        work on this thread."""
        def waiter():
            self._lib.mxt_ps_server_wait(self._handle)
            self._exec_q.put(None)

        t = threading.Thread(target=waiter, daemon=True,
                             name="mxnet-kv-server-waiter")
        t.start()
        while True:
            task = self._exec_q.get()
            if task is None:
                break
            task()
        t.join()
        # the destroy joins the connection threads, whose handlers may
        # still queue work (an async push racing the stop): a drainer runs
        # it so their waits cannot wedge the join
        stop = threading.Event()

        def drainer():
            while not stop.is_set():
                try:
                    task = self._exec_q.get(timeout=0.05)
                except queue.Empty:
                    continue
                if task is not None:
                    task()

        d = threading.Thread(target=drainer, name="mxnet-kv-server-drainer")
        d.start()
        self._lib.mxt_ps_server_destroy(self._handle)
        stop.set()
        d.join()
        self._handle = None


def _init_kvstore_server_module():
    """Serve, then exit, in a process whose ``DMLC_ROLE`` is ``server``
    (reference: kvstore_server.py:58-68, called from ``import mxnet``); a
    ``scheduler`` exits at once: workers reach the servers directly. On
    exit the server writes one line to stderr with its counters and
    whether this process ever initialized CUDA (it must not)."""
    role = os.environ.get("DMLC_ROLE", "")
    if role == "server":
        server = KVStoreServer()
        server.run()
        print("kvstore-server %s: stopped; %s; cuda initialized: %s"
              % (os.environ.get("DMLC_SERVER_ID", "0"), server.stats(),
                 torch.cuda.is_initialized()), file=sys.stderr, flush=True)
        sys.exit(0)
    if role == "scheduler":
        sys.exit(0)
