"""KVStore (counterpart of ``mxnet_tpu/kvstore.py``; reference:
include/mxnet/kvstore.h:26, src/kvstore/kvstore_local.h, comm.h,
kvstore_dist.h).

Two stores, chosen by :func:`create` from the type string with the JAX
package's names:

* :class:`KVStore` — one process. ``push`` reduces the values of a key
  (on the host for ``local*`` types, :class:`CommHost`; on the first
  value's device for ``device`` types, :class:`CommDevice`) and either
  runs the updater (``set_optimizer``/``set_updater``) on the stored
  value or stores the sum; ``pull`` copies the stored value out. A
  ``dist_*`` type without a launcher's ``DMLC_PS_ROOT_URI`` is this
  store, with one worker, as in the JAX package.
* :class:`KVStoreDist` — a worker of a parameter-server cluster started by
  ``tools/launch.py`` (the ``DMLC_*`` environment). It speaks the JAX
  package's wire through the port's copy of ``ps.cc``
  (``csrc/native/ps.cc``, built by :mod:`._native`): a key's flattened
  float32 value goes to server ``key % num_servers``; ``dist_sync``
  servers merge every worker's push before the update (BSP), and
  ``dist_async`` servers apply each push as it comes. Pushes run on the
  :mod:`.engine`'s threads with a variable per key, so a key's push and
  pull stay ordered while different keys overlap. The servers
  (:mod:`.kvstore_server`) run the optimizer on the host.

Not ported (``ROADMAP.md`` A6c; each raises where it is asked for): server
replicas (``MXNET_KV_REPLICAS``), elastic membership (``MXNET_ELASTIC``),
a relaunched worker's recovery (``DMLC_PS_RECOVERY``), the cluster-stats
publisher and straggler attribution, and the server trace statistics.
"""
from __future__ import annotations

import base64
import ctypes
import os
import pickle
import random
import threading
import time
import zlib

import numpy as np
import torch

from . import _native, telemetry
from . import ndarray as nd
from . import optimizer as opt
from .base import MXNetError, env_flag, env_float, env_int
from .ndarray import NDArray

__all__ = ["KVStore", "KVStoreDist", "create", "plan_buckets",
           "DEFAULT_KV_BUCKET_MB", "Comm", "CommHost", "CommDevice",
           "KVProtocolError"]

DEFAULT_KV_BUCKET_MB = 4.0

# the JAX package's type names (src/kvstore/kvstore.cc:22-41)
TYPES = ("local", "local_allreduce_cpu", "local_update_cpu", "device",
         "local_allreduce_device", "dist_sync", "dist_async",
         "dist_sync_device", "dist_async_device", "dist")


def _later(what):
    return MXNetError("%s is not ported yet (ROADMAP.md A6c)" % what)


def plan_buckets(nbytes_list, bucket_bytes):
    """Split a forward-ordered list of gradient sizes into buckets of about
    ``bucket_bytes``, in reverse order (last layers first, the order the
    backward makes them). Returns lists of indices into ``nbytes_list``; an
    entry larger than the bound is a bucket of its own."""
    bucket_bytes = max(float(bucket_bytes), 1.0)
    buckets = []
    cur, cur_bytes = [], 0.0
    for i in reversed(range(len(nbytes_list))):
        sz = float(nbytes_list[i])
        if cur and cur_bytes + sz > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0.0
        cur.append(i)
        cur_bytes += sz
        if cur_bytes >= bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0.0
    if cur:
        buckets.append(cur)
    return buckets


class _StepSyncMeter:
    """One step's bucketed sync: the RPCs' busy wall (summed on the engine
    threads) and the issuing thread's blocking wait; the overlap is the
    busy wall in excess of the wait."""

    __slots__ = ("_lock", "busy_seconds", "wait_seconds")

    def __init__(self):
        self._lock = threading.Lock()
        self.busy_seconds = 0.0  # guarded-by: _lock
        self.wait_seconds = 0.0  # guarded-by: _lock

    def add_busy(self, seconds):
        with self._lock:
            self.busy_seconds += seconds

    def timed(self, fn):
        """``fn`` with its wall added to the busy total."""
        def run():
            t0 = time.perf_counter()
            try:
                return fn()
            finally:
                self.add_busy(time.perf_counter() - t0)
        return run

    def wait(self, fn):
        """Run blocking harvest work, adding its wall to the wait total."""
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            with self._lock:
                self.wait_seconds += time.perf_counter() - t0

    def overlap_seconds(self):
        with self._lock:
            return max(self.busy_seconds - self.wait_seconds, 0.0)


def _key_list(key):
    if isinstance(key, (int, str)):
        return [key], True
    return list(key), False


def _value_list(value, n):
    """Values (or outs) grouped per key: one list of NDArrays per key."""
    if isinstance(value, NDArray):
        return [[value]]
    if n == 1:
        if isinstance(value[0], NDArray):
            return [list(value)]
        return [list(v) for v in value]
    return [[v] if isinstance(v, NDArray) else list(v) for v in value]


def _grouped(key, value):
    keys, single = _key_list(key)
    if single:
        return keys, [[value] if isinstance(value, NDArray) else list(value)]
    return keys, _value_list(value, len(keys))


def _str_key_int(k):
    """A string key's integer: the same in every process (Python's
    ``hash`` of a string is seeded per process)."""
    return zlib.crc32(k.encode()) & 0x7FFFFFFF


class Comm:
    """Reduce and broadcast within a process (reference: comm.h:18)."""

    def reduce(self, arrays):
        raise NotImplementedError

    def broadcast(self, src, dsts):
        for d in dsts:
            src.copyto(d)


class CommHost(Comm):
    """The sum on the host (reference: CommCPU, comm.h:62), in float32 on
    the first value's device."""

    def reduce(self, arrays):
        if len(arrays) == 1:
            return arrays[0]
        acc = arrays[0].asnumpy()
        for a in arrays[1:]:
            acc = acc + a.asnumpy()
        return nd.array(acc, ctx=arrays[0].context)


class CommDevice(Comm):
    """The sum on one of the values' devices (reference: CommDevice,
    comm.h:211): the owner of a key is chosen round-robin when the key is
    first reduced."""

    def __init__(self):
        self._owner = {}
        self._next = 0

    def reduce_key(self, key, arrays):
        if len(arrays) == 1:
            return arrays[0]
        if key not in self._owner:
            self._owner[key] = self._next % len(arrays)
            self._next += 1
        owner = arrays[self._owner[key]]
        total = owner.data.clone()
        for a in arrays:
            if a is not owner:
                total += a.data.to(total.device)
        return NDArray(total)

    def reduce(self, arrays):
        return self.reduce_key(0, arrays)


class KVStore:
    """The single-process store (reference: kvstore_local.h:22,
    python/mxnet/kvstore.py:49)."""

    def __init__(self, name="local"):
        self.name = name
        self._store = {}
        self._updater = None
        self._comm = CommDevice() if "device" in name else CommHost()
        self._optimizer = None

    @property
    def type(self):
        return self.name

    def _reduce(self, k, vs):
        if isinstance(self._comm, CommDevice):
            return self._comm.reduce_key(k, vs)
        return self._comm.reduce(vs)

    def init(self, key, value):
        keys, values = _grouped(key, value)
        for k, vs in zip(keys, values):
            if k in self._store:
                raise MXNetError("key %s already initialized" % str(k))
            self._store[k] = vs[0].copy()

    def push(self, key, value, priority=0):
        """Reduce each key's values; run the updater on the stored value
        with the sum, or store the sum when there is no updater."""
        keys, grouped = _grouped(key, value)
        for k, vs in zip(keys, grouped):
            if k not in self._store:
                raise MXNetError("key %s not initialized" % str(k))
            merged = self._reduce(k, vs)
            if self._updater is not None:
                idx = k if isinstance(k, int) else _str_key_int(k)
                stored = self._store[k]
                if merged.context != stored.context:
                    merged = merged.as_in_context(stored.context)
                self._updater(idx, merged, stored)
            else:
                self._store[k] = merged.copy()

    def pull(self, key, out=None, priority=0):
        """Copy each key's stored value into its outs."""
        if out is None:
            raise MXNetError("pull needs out")
        keys, outs = _grouped(key, out)
        for k, os_ in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("key %s not initialized" % str(k))
            self._comm.broadcast(self._store[k], os_)

    def set_updater(self, updater):
        self._updater = updater

    _set_updater = set_updater

    def set_optimizer(self, optimizer):
        """Run ``optimizer``'s updater on every push (reference:
        kvstore.py:226-267)."""
        self._optimizer = optimizer
        self.set_updater(opt.get_updater(optimizer))

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def barrier(self):
        """One process: nothing to wait for."""

    def get_num_dead_node(self, node_id=0, timeout=120):
        """A single-process store has no peers to lose."""
        return 0

    @property
    def is_recovery(self):
        """Whether this process restarts into a running job
        (``DMLC_PS_RECOVERY=1``)."""
        return env_flag("DMLC_PS_RECOVERY")

    def save_optimizer_states(self, fname):
        from .utils.atomic_file import atomic_write

        if self._updater is None:
            raise MXNetError("no optimizer states to save: set_optimizer first")
        with atomic_write(fname) as fout:
            fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        from .utils.atomic_file import read_verified

        if self._updater is None:
            raise MXNetError("no optimizer to load states into: "
                             "set_optimizer first")
        self._updater.set_states(read_verified(fname))


class KVProtocolError(MXNetError):
    """Client and server disagree deterministically (a pull of the wrong
    size): not a transport failure, never retried."""


class KVStoreDist(KVStore):
    """A worker of a parameter-server cluster (reference:
    src/kvstore/kvstore_dist.h: push is the local reduce, then a push of
    the flattened float32 value to the key's server; pull pulls into a
    buffer, then broadcasts; the barrier counts arrivals on server 0).

    The cluster comes from ``tools/launch.py``'s environment:
    ``DMLC_PS_ROOT_URI``/``DMLC_PS_ROOT_PORT`` locate server 0, server i
    listens on the port plus i, ``DMLC_NUM_SERVER``, ``DMLC_NUM_WORKER``,
    and ``DMLC_WORKER_ID`` is this worker's rank.

    The weights live on the servers, which update them with the optimizer
    rank 0 sends (``set_optimizer``); the first ``init`` of a key comes
    from rank 0 and every worker waits at a barrier after it."""

    def __init__(self, name):
        super().__init__(name)
        if env_int("MXNET_KV_REPLICAS", 0) > 0:
            raise _later("server replication (MXNET_KV_REPLICAS > 0)")
        if env_flag("MXNET_ELASTIC"):
            raise _later("elastic membership (MXNET_ELASTIC=1)")
        if env_flag("DMLC_PS_RECOVERY"):
            raise _later("rejoining a running job (DMLC_PS_RECOVERY=1)")
        # raises MXNetError when the library cannot be built or loaded:
        # a dist store never quietly becomes the single-process one
        self._lib = _native.load()
        host = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
        port = int(os.environ.get("DMLC_PS_ROOT_PORT", "9091"))
        self._num_servers = int(os.environ.get("DMLC_NUM_SERVER", "1"))
        self._server_addrs = [(host, port + s) for s in range(self._num_servers)]
        self._nw = int(os.environ.get("DMLC_NUM_WORKER", "1"))
        self._rank = int(os.environ.get("DMLC_WORKER_ID", "0"))
        self._clients = []
        for h, p in self._server_addrs:
            c = self._lib.mxt_ps_client_create(h.encode(), p)
            if not c:
                raise MXNetError("cannot reach PS server %s:%d" % (h, p))
            self._clients.append(c)
        if "async" in name and self._rank == 0:
            for c in self._clients:
                self._lib.mxt_ps_client_command(c, b"sync:0")
        from .engine import get_engine

        self._engine = get_engine()
        self._key_vars = {}
        self._update_on_kvstore = True
        telemetry.set_rank(self._rank)
        for c in self._clients:
            self._lib.mxt_ps_client_set_identity(c, self._rank)

    # ---- routing -----------------------------------------------------------
    def _ikey(self, k):
        return k if isinstance(k, int) else _str_key_int(k)

    def _client_for(self, ikey):
        return self._clients[ikey % self._num_servers]

    def _addr_for(self, ikey):
        return self._server_addrs[ikey % self._num_servers]

    def _var(self, k):
        if k not in self._key_vars:
            self._key_vars[k] = self._engine.new_variable()
        return self._key_vars[k]

    # ---- resilience ----------------------------------------------------------
    @staticmethod
    def _retry_config():
        """``MXNET_KV_RETRIES`` more attempts after a failure (0: none);
        ``MXNET_KV_TIMEOUT_MS`` bounds the liveness probe."""
        return (env_int("MXNET_KV_RETRIES", 3),
                max(env_int("MXNET_KV_TIMEOUT_MS", 10000), 1))

    def _with_retry(self, what, ikey, attempt_fn):
        """``attempt_fn`` with bounded retry and jittered exponential
        backoff. A failure is classified by fresh deadline-bounded probes
        of the key's server (of every server when ``ikey`` is None): an
        unreachable server, or a dead connection to a live one, fails at
        once with the node named; a reachable server that errs is retried.

        Retrying a push or barrier cannot apply it twice: the client never
        reconnects (``ps.cc``), so once its connection is gone every later
        call fails before touching the wire; only attempts that never
        reached the server run again."""
        retries, timeout_ms = self._retry_config()
        if ikey is None:
            addrs = list(self._server_addrs)
            conns = [(self._server_addrs[0], self._clients[0])]
        else:
            addrs = [self._addr_for(ikey)]
            conns = [(addrs[0], self._client_for(ikey))]
        attempt = 0
        while True:
            try:
                return attempt_fn()
            except KVProtocolError:
                raise
            except MXNetError as err:
                telemetry.counter("kvstore.rpc_failures", op=what).inc()
                if retries == 0:
                    raise
                dead = self._probe_dead(addrs, timeout_ms)
                if dead:
                    raise MXNetError(
                        "kvstore %s failed: server(s) %s unreachable (dead "
                        "node) — failing fast (cause: %s)"
                        % (what, ", ".join("%s:%d" % a for a in dead),
                           err)) from err
                bad = [a for a, c in conns
                       if self._lib.mxt_ps_client_probe(c, b"ping",
                                                         timeout_ms) != 0]
                if bad:
                    raise MXNetError(
                        "kvstore %s failed: this worker's connection to "
                        "server(s) %s is dead (the server is alive) and the "
                        "client does not reconnect; restart the worker "
                        "(cause: %s)"
                        % (what, ", ".join("%s:%d" % a for a in bad),
                           err)) from err
                attempt += 1
                if attempt > retries:
                    raise MXNetError(
                        "kvstore %s to live server(s) %s still failing after "
                        "%d retries: %s"
                        % (what, ", ".join("%s:%d" % a for a in addrs),
                           retries, err)) from err
                telemetry.counter("kvstore.retries", op=what).inc()
                delay = min(0.05 * (1 << (attempt - 1)), 2.0)
                time.sleep(delay * (0.5 + random.random()))

    def _probe_dead(self, addrs, timeout_ms):
        """The (host, port) pairs whose probe on a fresh connection failed;
        the probes run at once, under one shared deadline."""
        results = [None] * len(addrs)

        def probe(i, host, port):
            results[i] = self._lib.mxt_ps_probe(host.encode(), port, timeout_ms)

        threads = [threading.Thread(target=probe, args=(i, h, p), daemon=True,
                                    name="mxnet-kv-probe-%d" % i)
                   for i, (h, p) in enumerate(addrs)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + timeout_ms / 1000.0 + 5
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0))
        return [a for a, t, r in zip(addrs, threads, results)
                if t.is_alive() or r != 0]

    # ---- the wire ------------------------------------------------------------
    def _zpush(self, ikey, flat):
        """Push one key's flattened float32 value (a contiguous numpy
        array)."""
        def attempt():
            rc = self._lib.mxt_ps_client_push(
                self._client_for(ikey), ikey,
                flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), flat.size)
            if rc != 0:
                raise MXNetError("push rpc failed for key %d" % ikey)
        self._with_retry("push", ikey, attempt)

    def _zpull(self, ikey, n):
        """Pull ``n`` float32 values of one key."""
        out = np.empty(n, np.float32)

        def attempt():
            got = self._lib.mxt_ps_client_pull(
                self._client_for(ikey), ikey,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
            if got < 0:
                raise MXNetError("pull rpc failed for key %d" % ikey)
            if got != n:
                raise KVProtocolError(
                    "pull size mismatch for key %d: server sent %d floats, "
                    "expected %d" % (ikey, got, n))
            return out
        return self._with_retry("pull", ikey, attempt)

    @staticmethod
    def _wire(arr):
        """An NDArray's value as the wire's flat float32 host array (a
        bf16 or f16 gradient is cast: the wire is float32)."""
        t = arr.data.detach()
        if t.dtype != torch.float32:
            t = t.float()
        return np.ascontiguousarray(t.cpu().numpy().reshape(-1))

    # ---- API -------------------------------------------------------------------
    def init(self, key, value):
        keys, values = _grouped(key, value)
        if self._rank == 0:
            for k, vs in zip(keys, values):
                self._zpush(self._ikey(k), self._wire(vs[0]))
        self.barrier()

    def push(self, key, value, priority=0, _meter=None):
        keys, grouped = _grouped(key, value)
        for k, vs in zip(keys, grouped):
            flat = self._wire(self._reduce(k, vs))
            ikey = self._ikey(k)

            def fn(ikey=ikey, flat=flat):
                self._zpush(ikey, flat)
            if _meter is not None:
                fn = _meter.timed(fn)
            self._engine.push(fn, mutable_vars=[self._var(k)],
                              priority=priority)

    def _broadcast_flat(self, flat, os_):
        src = NDArray(torch.from_numpy(flat.reshape(os_[0].shape)))
        self._comm.broadcast(src, os_)

    def pull(self, key, out=None, priority=0):
        if out is None:
            raise MXNetError("pull needs out")
        keys, outs = _grouped(key, out)
        for k, os_ in zip(keys, outs):
            # ordered after the key's pushes; a failed push raises here
            self._engine.wait_for_var(self._var(k))
            n = int(np.prod(os_[0].shape))
            self._broadcast_flat(self._zpull(self._ikey(k), n), os_)

    def bucket_bytes_limit(self):
        """``MXNET_KV_BUCKET_MB`` in bytes, or None when it is 0 (bucketing
        off)."""
        mb = env_float("MXNET_KV_BUCKET_MB", DEFAULT_KV_BUCKET_MB)
        if mb is None or mb <= 0:
            return None
        return mb * (1 << 20)

    def pull_async(self, key, out=None, priority=0, _meter=None):
        """A pull as an engine op after the key's pushes, copying into
        ``out`` on an engine thread; :meth:`wait_key` harvests it."""
        os_ = [out] if isinstance(out, NDArray) else list(out)
        n = int(np.prod(os_[0].shape))
        ikey = self._ikey(key)

        def run():
            zpull = (lambda: self._zpull(ikey, n)) if _meter is None \
                else _meter.timed(lambda: self._zpull(ikey, n))
            self._broadcast_flat(zpull(), os_)
        self._engine.push(run, mutable_vars=[self._var(key)],
                          priority=priority)

    def wait_key(self, key):
        """Block until the key's pushes and pulls are done; a recorded
        engine error is raised here."""
        self._engine.wait_for_var(self._var(key))

    def bucketed_push_pull(self, pairs, on_bucket=None):
        """The bucketed sync both dist step paths run: ``pairs`` is the
        forward-ordered list of ``(int key, push value, pull out)``. Each
        bucket's pushes are issued in reverse order with its pulls behind
        them on the engine; the buckets are harvested in issue order and
        ``on_bucket(bucket_pairs)`` consumes each while later buckets' RPCs
        are still on the wire. Returns False when bucketing is off
        (``MXNET_KV_BUCKET_MB=0``): the caller then pushes and pulls key by
        key."""
        limit = self.bucket_bytes_limit()
        if limit is None:
            return False

        def nbytes(value):
            v0 = value[0] if isinstance(value, (list, tuple)) else value
            return int(np.prod(v0.shape)) * 4   # the float32 wire
        plan = plan_buckets([nbytes(v) for _, v, _ in pairs], limit)
        meter = _StepSyncMeter()
        for bucket in plan:
            for i in bucket:
                key, value, _ = pairs[i]
                self.push(key, value, priority=-key, _meter=meter)
            for i in bucket:
                key, _, out = pairs[i]
                self.pull_async(key, out=out, priority=-key, _meter=meter)
        for bucket in plan:
            meter.wait(lambda b=bucket: [self.wait_key(pairs[i][0]) for i in b])
            if on_bucket is not None:
                on_bucket([pairs[i] for i in bucket])
        overlap = meter.overlap_seconds()
        if overlap > 0:
            telemetry.counter("kv.overlap_seconds").inc(overlap)
        return True

    def set_optimizer(self, optimizer):
        """Rank 0 sends the pickled optimizer to every server, which
        updates the weights with it; all workers meet at a barrier."""
        if self._rank == 0:
            self._send_command_to_servers(0, pickle.dumps(optimizer))
        self.barrier()
        self._optimizer = optimizer

    def _send_command_to_servers(self, head, body):
        cmd = b"optim:" + base64.b64encode(body)
        for c in self._clients:
            self._lib.mxt_ps_client_command(c, cmd)

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._nw

    @property
    def is_recovery(self):
        return False

    def barrier(self):
        """Wait for this worker's queued RPCs, then for every worker at
        server 0."""
        self._engine.wait_all()

        def attempt():
            if self._lib.mxt_ps_client_barrier(self._clients[0]) != 0:
                raise MXNetError("barrier rpc failed")
        self._with_retry("barrier", None, attempt)

    def get_num_dead_node(self, node_id=0, timeout=120):
        """The servers that do not answer a probe on a fresh connection
        within ``timeout`` seconds (all probed at once)."""
        del node_id
        return len(self._probe_dead(self._server_addrs,
                                    max(int(timeout * 1000), 1)))

    def start_cluster_stats(self, interval_s=None):
        raise _later("the cluster-stats publisher")

    def request_server_trace(self):
        raise _later("the server trace statistics")

    def save_optimizer_states(self, fname):
        raise MXNetError("the optimizer states of a dist store live on its "
                         "servers: they are not saved from a worker")

    load_optimizer_states = save_optimizer_states

    def _stop_servers(self):
        """Stop every server (rank 0, at the end of the job)."""
        for c in self._clients:
            self._lib.mxt_ps_client_stop(c)

    def __del__(self):
        try:
            for c in self._clients:
                self._lib.mxt_ps_client_destroy(c)
        except Exception:  # noqa: BLE001 — interpreter teardown: the
            pass           # library's globals may be gone already


def create(name="local"):
    """A store by type string (reference: src/kvstore/kvstore.cc:22-41).
    A ``dist*`` type under a launcher (``DMLC_PS_ROOT_URI`` set) is a
    :class:`KVStoreDist`; every other type, and a ``dist*`` type without
    one, is the single-process :class:`KVStore`."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name not in TYPES:
        raise MXNetError("Unknown KVStore type %s" % name)
    if name.startswith("dist") and "DMLC_PS_ROOT_URI" in os.environ:
        return KVStoreDist(name)
    return KVStore(name)

