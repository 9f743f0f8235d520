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

The HA and elastic half: replicated server groups and failover onto a
promoted backup (``MXNET_KV_REPLICAS``), the membership epoch and the
registry client the elastic session (:mod:`.elastic`, ``MXNET_ELASTIC``)
drives, a relaunched worker's rejoin (``DMLC_PS_RECOVERY``), the servers'
counters and per-rank traces (``request_server_stats``,
``request_server_trace``) and the cluster-stats publisher with straggler
attribution (``start_cluster_stats``, ``cluster_stats``): each worker
overwrites a persistent reserved key (:func:`telemetry_slot`) on the
registry's server with its snapshot every second.
"""
from __future__ import annotations

import base64
import ctypes
import json
import logging
import os
import pickle
import random
import threading
import time
import zlib

import numpy as np
import torch

from . import _native, fault, telemetry
from . import ndarray as nd
from . import optimizer as opt
from .base import MXNetError, env_bool, env_flag, env_float, env_int
from .ndarray import NDArray

__all__ = ["KVStore", "KVStoreDist", "create", "plan_buckets",
           "DEFAULT_KV_BUCKET_MB", "Comm", "CommHost", "CommDevice",
           "KVProtocolError", "KVMembershipError", "TELEMETRY_KEY_BASE",
           "telemetry_slot"]

DEFAULT_KV_BUCKET_MB = 4.0

# the JAX package's type names (src/kvstore/kvstore.cc:22-41)
TYPES = ("local", "local_allreduce_cpu", "local_update_cpu", "device",
         "local_allreduce_device", "dist_sync", "dist_async",
         "dist_sync_device", "dist_async_device", "dist")


# Keys at or below TELEMETRY_KEY_BASE are persistent on a server
# (``ps.cc`` kPersistentKeyMax; other negative keys are erased after one
# pull): each worker overwrites one with its cluster snapshot, which any
# number of observers can read.
TELEMETRY_KEY_BASE = -(1 << 20)


def telemetry_slot(rank):
    """The persistent reserved key worker ``rank`` publishes on."""
    return TELEMETRY_KEY_BASE - int(rank)


def _pick_straggler(snaps, factor=2.0, max_age_s=None, now=None):
    """The straggling rank of ``{rank: snapshot or None}``, or None.

    Under BSP every rank's raw step wall is the slowest one's (the others
    wait in the sync), so ranks are compared on their self time per step,
    ``(data_wait + compute + guard) / steps`` of their ``window``. A rank
    is the straggler when its self time is at least ``factor`` times the
    lower median; its stage is its largest self stage. Snapshots older
    than ``max_age_s`` and empty windows are left out; fewer than two
    judged ranks name nobody."""
    per = {}
    now = now if now is not None else time.time()
    for r, s in snaps.items():
        if not s:
            continue
        if max_age_s is not None and now - float(s.get("ts", 0)) > max_age_s:
            continue
        w = s.get("window") or {}
        n = w.get("steps") or 0
        if n <= 0:
            continue
        stages = {k: float(w.get(k, 0.0)) / n
                  for k in ("data_wait", "compute", "kv_sync", "guard")}
        self_time = stages["data_wait"] + stages["compute"] + stages["guard"]
        per[int(r)] = (self_time, stages, float(w.get("step_time", 0.0)) / n)
    if len(per) < 2:
        return None
    times = sorted(t for t, _, _ in per.values())
    # the lower median: on two ranks the upper one is the straggler's own
    median = times[(len(times) - 1) // 2]
    worst = max(per, key=lambda r: per[r][0])
    self_time, stages, step_time = per[worst]
    if median <= 0 or self_time < factor * median:
        return None
    stage = max(("data_wait", "compute", "guard"), key=lambda k: stages[k])
    return {"rank": worst, "stage": stage,
            "self_time": round(self_time, 6), "median": round(median, 6),
            "ratio": round(self_time / median, 3),
            "step_time": round(step_time, 6), "stages": stages}


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


class KVMembershipError(MXNetError):
    """This worker's membership epoch is stale: the cluster reconfigured (a
    worker or a server was lost, or a worker joined) and the server refused
    the request, so nothing of a departed membership lands. Never retried:
    the elastic session resyncs with the registry, rolls back, reshards and
    goes on (:mod:`.elastic`)."""

    def __init__(self, msg, op=None, key=None):
        super().__init__(msg)
        self.op = op
        self.key = key


def _membership_reject(op, key):
    """A counted :class:`KVMembershipError` for a refused ``op``."""
    telemetry.counter("kv.membership.rejected", op=op).inc()
    return KVMembershipError(
        "kvstore %s rejected for key %s: this worker's membership epoch is "
        "stale (the cluster reconfigured); resync with the registry before "
        "retrying" % (op, key), op=op, key=key)


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
    from rank 0 and every worker waits at a barrier after it.

    Keys go to server groups (``kvstore_server.plan_server_groups``; one
    server each without ``MXNET_KV_REPLICAS``): ``ikey % num_groups``, sent
    to the group's primary in the server map ``_smap``. Every RPC carries
    this worker's rank, its step (:meth:`set_step`) and, once elastic, its
    membership epoch; a refused one raises :class:`KVMembershipError`.
    Under elastic training with replicas a dead server is reported to the
    registry and raises :class:`KVMembershipError` too, so the session
    reconfigures onto the promoted backup instead of dying."""

    def __init__(self, name):
        super().__init__(name)
        # raises MXNetError when the library cannot be built or loaded:
        # a dist store never quietly becomes the single-process one
        self._lib = _native.load()
        host = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
        port = int(os.environ.get("DMLC_PS_ROOT_PORT", "9091"))
        self._num_servers = int(os.environ.get("DMLC_NUM_SERVER", "1"))
        self._server_addrs = [(host, port + s) for s in range(self._num_servers)]
        self._nw = int(os.environ.get("DMLC_NUM_WORKER", "1"))
        self._rank = int(os.environ.get("DMLC_WORKER_ID", "0"))
        from .kvstore_server import plan_server_groups

        self._replicas = env_int("MXNET_KV_REPLICAS", 0)
        try:
            self._groups = plan_server_groups(self._num_servers,
                                              self._replicas)
        except ValueError as e:
            raise MXNetError(str(e)) from e
        self._ngroups = len(self._groups)
        self._smap = [g[0] for g in self._groups]   # group -> primary
        self._registry_sid = self._groups[0][0]
        self._ha = False            # elastic_enable() with replicas
        self._server_loss = False   # an RPC found a dead server
        self._dead_clients = []     # replaced handles, freed in __del__
        self._stats_skip = {}       # server addr -> monotonic skip-until
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
        self._elastic = False
        self._mepoch = 0
        self._reserved_seq = 0
        self._step = 0
        self._bsp_synced_step = None  # last step a bsp_sync event fired for
        self._bsp_lock = threading.Lock()
        self._barrier_seq = 0
        self._cluster = None            # the _ClusterStatsPublisher
        self._publish_inflight = None   # a snapshot publish still blocked
        telemetry.set_rank(self._rank)
        for c in self._clients:
            self._lib.mxt_ps_client_set_identity(c, self._rank)

    # ---- routing -----------------------------------------------------------
    def _ikey(self, k):
        return k if isinstance(k, int) else _str_key_int(k)

    def _sid_for(self, ikey):
        return self._smap[ikey % self._ngroups]

    def _client_for(self, ikey):
        return self._clients[self._sid_for(ikey)]

    def _addr_for(self, ikey):
        return self._server_addrs[self._sid_for(ikey)]

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
        of the key's server (of every mapped primary when ``ikey`` is
        None): an unreachable server, or a dead connection to a live one,
        fails at once with the node named — or, under HA, is reported to
        the registry and raises :class:`KVMembershipError`; a reachable
        server that errs is retried.

        Retrying a push or barrier cannot apply it twice: the client never
        reconnects by itself (``ps.cc``), so once its connection is gone
        every later call fails before touching the wire; only attempts
        that never reached the server run again."""
        retries, timeout_ms = self._retry_config()
        if ikey is None:
            addrs = [self._server_addrs[s] for s in sorted(set(self._smap))]
            conns = [(self._server_addrs[self._smap[0]],
                      self._clients[self._smap[0]])]
        else:
            addrs = [self._addr_for(ikey)]
            conns = [(addrs[0], self._client_for(ikey))]
        attempt = 0
        while True:
            try:
                return attempt_fn()
            except (KVProtocolError, KVMembershipError):
                raise
            except MXNetError as err:
                telemetry.counter("kvstore.rpc_failures", op=what).inc()
                if retries == 0:
                    raise
                dead = self._probe_dead(addrs, timeout_ms)
                if dead:
                    if self._ha:
                        self._report_server_loss(dead, err)
                        raise KVMembershipError(
                            "kvstore %s failed: server(s) %s unreachable — "
                            "reconfiguring onto backup(s) (cause: %s)"
                            % (what, ", ".join("%s:%d" % a for a in dead),
                               err)) from err
                    raise MXNetError(
                        "kvstore %s failed: server(s) %s unreachable (dead "
                        "node) — failing fast (cause: %s)"
                        % (what, ", ".join("%s:%d" % a for a in dead),
                           err)) from err
                bad = [a for a, c in conns
                       if self._lib.mxt_ps_client_probe(c, b"ping",
                                                         timeout_ms) != 0]
                if bad:
                    if self._ha:
                        # the server lives: adopt_server_map() reconnects
                        self._report_server_loss(bad, err)
                        raise KVMembershipError(
                            "kvstore %s failed: connection to server(s) %s "
                            "lost (server alive) — reconfiguring with a "
                            "fresh connection (cause: %s)"
                            % (what, ", ".join("%s:%d" % a for a in bad),
                               err)) from err
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
                telemetry.counter("kvstore.backoff_ms", op=what).inc(
                    int(delay * 1000))
                time.sleep(delay * (0.5 + random.random()))

    def _probe_dead(self, addrs, timeout_ms):
        """The (host, port) pairs whose probe on a fresh connection failed;
        the probes run at once, under one shared deadline. Sets the
        ``kvstore.dead_nodes`` gauge (a partial probe only raises it)."""
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
        dead = [a for a, t, r in zip(addrs, threads, results)
                if t.is_alive() or r != 0]
        g = telemetry.gauge("kvstore.dead_nodes")
        if len(addrs) == len(self._server_addrs) or len(dead) > g.value:
            g.set(len(dead))
        return dead

    # ---- server failover -------------------------------------------------------
    def _report_server_loss(self, dead_addrs, err):
        """Tell the registry which servers this worker found dead (it
        probes before evicting), and flag the loss: the session then waits
        for a newer epoch before it resumes."""
        self._server_loss = True
        for a in dead_addrs:
            try:
                sid = self._server_addrs.index(tuple(a))
            except ValueError:
                continue
            telemetry.counter("kvstore.server_loss_reports",
                              server="%s:%d" % tuple(a)).inc()
            if not self.registry_command("mb_srv_dead:%d" % sid,
                                         timeout_ms=2000):
                # the registry may be failing over too: its heartbeat
                # lapse is the backstop
                telemetry.counter("kv.membership.heartbeat_failures").inc()
        logging.warning("kvstore rank %d: server(s) %s unreachable — reported "
                        "to registry, awaiting new server map (cause: %s)",
                        self._rank,
                        ", ".join("%s:%d" % tuple(a) for a in dead_addrs), err)

    def consume_server_loss(self):
        """Return and clear the server-loss flag."""
        loss, self._server_loss = self._server_loss, False
        return loss

    def _client_sid(self, sid):
        """The client of server ``sid``, made anew under HA when its
        connection died (a promoted or relaunched server takes new ones).
        A replaced handle is kept until ``__del__``: an engine thread may
        still hold it."""
        c = self._clients[sid]
        if c and not self._lib.mxt_ps_client_is_dead(c):
            return c
        host, port = self._server_addrs[sid]
        fresh = self._lib.mxt_ps_client_create2(host.encode(), port, 50)
        if not fresh:
            return c    # still down: the caller's probe or deadline decides
        self._lib.mxt_ps_client_set_identity(fresh, self._rank)
        self._lib.mxt_ps_client_set_epoch(fresh, self._mepoch)
        self._lib.mxt_ps_client_set_step(fresh, self._step)
        if c:
            self._dead_clients.append(c)
        self._clients[sid] = fresh
        logging.info("kvstore rank %d: reconnected to server %d (%s:%d)",
                     self._rank, sid, host, port)
        return fresh

    def adopt_server_map(self, smap):
        """Route by the registry's group -> primary map and reconnect to
        every server the routing needs. A group with no live member keeps
        its old target: its RPCs fail and show the outage instead of
        sending its keys elsewhere."""
        if not smap or not self._ha:
            return
        try:
            smap = [None if s is None else int(s) for s in smap]
        except (TypeError, ValueError):
            logging.warning("kvstore: malformed server map %r ignored", smap)
            return
        if len(smap) != self._ngroups or any(
                s is not None and not 0 <= s < self._num_servers
                for s in smap):
            logging.warning("kvstore: server map %r does not match %d "
                            "groups over %d servers — ignored",
                            smap, self._ngroups, self._num_servers)
            return
        new = [old if s is None else s for s, old in zip(smap, self._smap)]
        if new != self._smap:
            logging.warning("kvstore rank %d: adopting server map %s -> %s",
                            self._rank, self._smap, new)
            telemetry.event("server_map_adopted", rank=self._rank,
                            smap=list(new))
            self._smap = new
        for sid in sorted(set(self._smap) | set(self._groups[0])):
            self._client_sid(sid)

    # ---- the wire ------------------------------------------------------------
    def _zpush(self, ikey, flat):
        """Push one key's flattened float32 value (a contiguous numpy
        array)."""
        def attempt():
            rule = fault.hit("kv_push")
            if rule is not None and rule.get("drop") not in (None, "0"):
                raise MXNetError("injected push drop for key %d" % ikey)
            rc = self._lib.mxt_ps_client_push(
                self._client_for(ikey), ikey,
                flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), flat.size)
            if rc == -2:
                raise _membership_reject("push", ikey)
            if rc != 0:
                raise MXNetError("push rpc failed for key %d" % ikey)
        self._timed("kvstore.push_latency_seconds", ikey,
                    lambda: self._with_retry("push", ikey, attempt))
        if telemetry.enabled():
            self._maybe_emit_bsp_sync()

    def _zpull(self, ikey, n):
        """Pull ``n`` float32 values of one key."""
        out = np.empty(n, np.float32)

        def attempt():
            rule = fault.hit("kv_pull")
            if rule is not None and rule.get("drop") not in (None, "0"):
                raise MXNetError("injected pull drop for key %d" % ikey)
            got = self._lib.mxt_ps_client_pull(
                self._client_for(ikey), ikey,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
            if got == -2:
                raise _membership_reject("pull", ikey)
            if got < 0:
                raise MXNetError("pull rpc failed for key %d" % ikey)
            if got != n:
                raise KVProtocolError(
                    "pull size mismatch for key %d: server sent %d floats, "
                    "expected %d" % (ikey, got, n))
            return out
        return self._timed("kvstore.pull_latency_seconds", ikey,
                           lambda: self._with_retry("pull", ikey, attempt))

    @staticmethod
    def _timed(name, ikey, fn):
        """``fn()``; its wall, retries included, goes to histogram ``name``
        while telemetry is on (the cluster snapshot's ``kv_sync``)."""
        if not telemetry.enabled():
            return fn()
        t0 = time.perf_counter()
        try:
            return fn()
        finally:
            telemetry.histogram(name, key=ikey).observe(time.perf_counter() - t0)

    def _zinit(self, ikey, arr_np):
        """Overwrite a key's value on its server (no merge, no optimizer):
        the elastic coordinator re-seeds the servers with it."""
        flat = np.ascontiguousarray(np.asarray(arr_np).reshape(-1), np.float32)

        def attempt():
            rc = self._lib.mxt_ps_client_init(
                self._client_for(ikey), ikey,
                flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), flat.size)
            if rc == -2:
                raise _membership_reject("init", ikey)
            if rc != 0:
                raise MXNetError("init rpc failed for key %d" % ikey)
        self._with_retry("init", ikey, attempt)

    @staticmethod
    def _wire(arr):
        """An NDArray's value as the wire's flat float32 host array (a
        bf16 or f16 gradient is cast: the wire is float32)."""
        t = arr.data.detach()
        if t.dtype != torch.float32:
            t = t.float()
        return np.ascontiguousarray(t.cpu().numpy().reshape(-1))

    # ---- elastic membership ----------------------------------------------------
    def elastic_enable(self):
        """Put every server in elastic mode: push, pull, init and barrier
        are checked against the membership epoch from now on. With
        replicas, a dead server then reconfigures instead of failing."""
        self._elastic = True
        self._ha = self._replicas > 0
        for c in self._clients:
            self._lib.mxt_ps_client_command(c, b"elastic:1")

    @property
    def membership_epoch(self):
        """The epoch this worker stamps on every request."""
        return self._mepoch

    @property
    def _elastic_join(self):
        """A relaunched elastic worker before it joined: it skips the init
        traffic (the servers hold the trained state); the rendezvous is
        the elastic session's."""
        return self._elastic and self.is_recovery

    def set_membership_epoch(self, epoch):
        """Stamp ``epoch`` on every later RPC (the elastic session, after
        it reconciled with the registry)."""
        epoch = int(epoch)
        self._mepoch = epoch
        for c in self._clients:
            self._lib.mxt_ps_client_set_epoch(c, epoch)
        telemetry.gauge("kv.membership.epoch").set(epoch)
        telemetry.event("mepoch_adopted", epoch=epoch, step_id=self._step)

    def set_step(self, step_id):
        """Stamp ``step_id`` on every later RPC (fit: ``epoch << 32 |
        nbatch``): the servers record each rank's last step."""
        step_id = int(step_id)
        self._step = step_id
        for c in self._clients:
            self._lib.mxt_ps_client_set_step(c, step_id)

    @property
    def step_id(self):
        return self._step

    def _maybe_emit_bsp_sync(self):
        """One ``bsp_sync`` event per step, when the step's first push
        response arrives: the server releases a merged round to every
        worker at once, so the event's wall time is a cross-worker sync
        point (``tools/trace_merge.py`` aligns clocks on it). Pushes run on
        engine threads: the check-and-set is locked, so a step has one."""
        step = self._step
        with self._bsp_lock:
            if step == self._bsp_synced_step:
                return
            self._bsp_synced_step = step
        telemetry.event("bsp_sync", step_id=step)

    # ---- the registry ------------------------------------------------------------
    def _registry_probe(self, cmd, timeout_ms):
        """Send ``cmd`` to the registry: the server believed to host it,
        then the rest of group 0 in standby order. Returns the client that
        acknowledged (and remembers its server), or None."""
        cands = [self._registry_sid] + [s for s in self._groups[0]
                                        if s != self._registry_sid]
        for sid in cands:
            c = self._client_sid(sid) if self._ha else self._clients[sid]
            if c and self._lib.mxt_ps_client_probe(c, cmd, timeout_ms) == 0:
                if sid != self._registry_sid:
                    logging.info("kvstore rank %d: registry moved to server "
                                 "%d", self._rank, sid)
                    telemetry.counter("kv.registry.failover_probes").inc()
                    self._registry_sid = sid
                return c
            if not self._ha:
                break
        return None

    def _registry_client(self):
        """The client of the server hosting the registry."""
        if self._ha:
            return self._client_sid(self._registry_sid)
        return self._clients[self._registry_sid]

    def registry_command(self, cmd, timeout_ms=None):
        """A deadline-bounded command to the registry; True when it
        acknowledged."""
        if timeout_ms is None:
            _, timeout_ms = self._retry_config()
        if isinstance(cmd, str):
            cmd = cmd.encode()
        return self._registry_probe(cmd, timeout_ms) is not None

    def _fresh_reserved_key(self):
        """A negative key no other worker or recent call uses: where a
        server publishes a payload for this worker to pull (erased after
        one pull). The sequence wraps before the observer band at
        -(1 << 19) and the persistent telemetry slots."""
        self._reserved_seq += 1
        key = -(2 + self._rank + self._reserved_seq * max(self._nw, 1))
        if key <= -(1 << 19):
            self._reserved_seq = 1
            key = -(2 + self._rank + max(self._nw, 1))
        return key

    def _bounded_pull(self, client, key, cap, timeout_ms):
        """Pull ``key`` into a new ``cap``-float buffer within a deadline
        (the pull itself has none): on a daemon thread, abandoned on
        expiry, whose closure keeps the buffer alive for a late answer.
        Returns ``(floats received or None, buffer)``."""
        buf = np.zeros(cap, np.float32)
        result = [None]

        def pull():
            result[0] = self._lib.mxt_ps_client_pull(
                client, key, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                cap)

        t = threading.Thread(target=pull, daemon=True,
                             name="mxnet-kv-reserved-pull")
        t.start()
        t.join(timeout_ms / 1000.0)
        if t.is_alive():
            return None, buf
        return result[0], buf

    def registry_fetch(self, cmd_prefix, timeout_ms=None):
        """A payload the registry publishes on demand (``<cmd_prefix>:<a
        reserved key>``, then a pull of that key): the bytes, or None when
        the registry did not answer in time."""
        from .kvstore_server import decode_bytes_vec

        if timeout_ms is None:
            _, timeout_ms = self._retry_config()
        key = self._fresh_reserved_key()
        client = self._registry_probe(("%s:%d" % (cmd_prefix, key)).encode(),
                                      timeout_ms)
        if client is None:
            return None
        cap = 65536
        got, buf = self._bounded_pull(client, key, cap, timeout_ms)
        if got is None or got <= 0 or got > cap:
            return None
        return decode_bytes_vec(buf[:got])

    # ---- API -------------------------------------------------------------------
    def init(self, key, value):
        if self._elastic_join:
            # the servers hold the trained weights; the survivors meet this
            # worker in the elastic join, not at this barrier
            return
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
        engine error (a failed push, a stale epoch) is raised here."""
        self._engine.wait_for_var(self._var(key))

    def bucketed_push_pull(self, pairs, on_bucket=None):
        """The bucketed sync both dist step paths run: ``pairs`` is the
        forward-ordered list of ``(int key, push value, pull out)``. Each
        bucket's pushes are issued in reverse order with its pulls behind
        them on the engine; the buckets are harvested in issue order and
        ``on_bucket(bucket_pairs)`` consumes each while later buckets' RPCs
        are still on the wire. Returns False when bucketing is off
        (``MXNET_KV_BUCKET_MB=0``): the caller then pushes and pulls key by
        key. A fused ``dist_sync_device`` step over several local contexts
        pushes one value per key, its positions' gradients already summed
        on the device (``fused_path._step_dist``), as the classic path
        pushes its contexts' list."""
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
        updates the weights with it; all workers meet at a barrier. A
        rejoining elastic worker sends nothing: the servers kept theirs
        and its slots."""
        if self._elastic_join:
            self._optimizer = optimizer
            return
        if self._rank == 0:
            self._send_command_to_servers(0, pickle.dumps(optimizer))
        self.barrier()
        self._optimizer = optimizer

    def _send_command_to_servers(self, head, body):
        cmd = b"optim:" + base64.b64encode(body)
        for sid in range(self._num_servers):
            c = self._client_sid(sid) if self._ha else self._clients[sid]
            self._lib.mxt_ps_client_command(c, cmd)

    @property
    def rank(self):
        return self._rank

    @property
    def num_workers(self):
        return self._nw

    @property
    def is_recovery(self):
        """Whether this process was relaunched into a running job
        (``DMLC_PS_RECOVERY=1``, set by ``tools/launch.py --elastic``)."""
        return env_flag("DMLC_PS_RECOVERY")

    def barrier(self):
        """Wait for this worker's queued RPCs, then for every worker at the
        primary of group 0 (server 0 without failover)."""
        self._engine.wait_all()

        def attempt():
            rc = self._lib.mxt_ps_client_barrier(self._clients[self._smap[0]])
            if rc == -2:
                raise _membership_reject("barrier", 0)
            if rc != 0:
                raise MXNetError("barrier rpc failed")
        if not telemetry.enabled():
            self._with_retry("barrier", None, attempt)
            return
        self._barrier_seq += 1
        t0 = time.perf_counter()
        with telemetry.span("kv.barrier", "kvstore", seq=self._barrier_seq,
                            step_id=self._step):
            self._with_retry("barrier", None, attempt)
        telemetry.event("barrier", seq=self._barrier_seq, step_id=self._step,
                        wait_s=round(time.perf_counter() - t0, 6))

    def get_num_dead_node(self, node_id=0, timeout=120):
        """The servers that do not answer a probe on a fresh connection
        within ``timeout`` seconds (all probed at once)."""
        del node_id
        return len(self._probe_dead(self._server_addrs,
                                    max(int(timeout * 1000), 1)))

    # ---- server statistics and traces --------------------------------------------
    def _stats_skipped(self, addr):
        """True while ``addr`` is in the penalty window of a failed stats
        or trace request: the poll skips it without touching the wire."""
        if time.monotonic() < self._stats_skip.get(addr, 0.0):
            telemetry.counter("kv.stats_unreachable", server=addr).inc()
            return True
        return False

    def _stats_unreachable(self, addr, timeout_ms):
        telemetry.counter("kv.stats_unreachable", server=addr).inc()
        self._stats_skip[addr] = time.monotonic() + timeout_ms / 1000.0

    def _ask_servers(self, verb, fetch):
        """``{"host:port": fetch(client, key) | None}``: each server is sent
        ``<verb>:<a reserved key>`` (it publishes its answer there), then
        ``fetch`` pulls the key, every step deadline-bounded; a server that
        does not answer is None and skipped for one deadline."""
        _, timeout_ms = self._retry_config()
        out = {}
        for i in range(self._num_servers):
            addr = "%s:%d" % self._server_addrs[i]
            if self._stats_skipped(addr):
                out[addr] = None
                continue
            c = self._client_sid(i) if self._ha else self._clients[i]
            key = self._fresh_reserved_key()
            if self._lib.mxt_ps_client_probe(
                    c, ("%s:%d" % (verb, key)).encode(), timeout_ms) != 0:
                logging.warning("kvstore: server %s did not acknowledge %s "
                                "(dead or wedged?)", addr, verb)
                self._stats_unreachable(addr, timeout_ms)
                out[addr] = None
                continue
            out[addr] = fetch(c, key, timeout_ms)
            if out[addr] is None:
                self._stats_unreachable(addr, timeout_ms)
        return out

    def request_server_stats(self):
        """Every server's counters: ``{"host:port": {"updates_applied",
        "update_failures", "has_optimizer", the HA counters} | None}``."""
        from .kvstore_server import STATS_VEC_LEN, decode_stats_vec

        def fetch(c, key, timeout_ms):
            got, buf = self._bounded_pull(c, key, STATS_VEC_LEN, timeout_ms)
            if got != STATS_VEC_LEN:
                logging.warning("kvstore: a server acknowledged stats but the "
                                "pull %s", "timed out" if got is None
                                else "returned %s" % got)
                return None
            return decode_stats_vec(buf)
        return self._ask_servers("stats_to", fetch)

    def request_server_trace(self):
        """Every server's per-rank RPC attribution: ``{"host:port":
        {"per_rank": {rank: {"last_step", "last_mepoch", "pushes", "pulls",
        "barriers", "inits"}}} | None}`` (JSON keys: ranks are strings)."""
        return self._ask_servers("trace_to", self._pull_published_json)

    def _pull_published_json(self, client, key, timeout_ms, cap=65536):
        """A JSON payload published under ``key``, or None (timeout, short
        read, undecodable)."""
        from .kvstore_server import decode_bytes_vec

        got, buf = self._bounded_pull(client, key, cap, timeout_ms)
        if got is None or got <= 0 or got > cap:
            return None
        raw = decode_bytes_vec(buf[:got])
        if not raw:
            return None
        try:
            return json.loads(raw.decode())
        except ValueError:
            return None

    # ---- cluster statistics -------------------------------------------------------
    def _snapshot_cumulative(self):
        """This process's cumulative step split: steps, step wall, data
        wait, compute, guard, and ``kv_sync`` — the push, pull and barrier
        walls less what the bucketed step overlapped."""
        steps, step_sum = telemetry.totals("fit.step_time_seconds")
        _, data_wait = telemetry.totals("fit.data_wait_seconds")
        _, compute = telemetry.totals("fit.compute_seconds")
        _, guard = telemetry.totals("fit.guard_seconds")
        _, push = telemetry.totals("kvstore.push_latency_seconds")
        _, pull = telemetry.totals("kvstore.pull_latency_seconds")
        _, barrier = telemetry.totals("kv.barrier")
        _, overlap = telemetry.totals("kv.overlap_seconds")
        return {"steps": steps, "step_time": step_sum, "data_wait": data_wait,
                "compute": compute,
                "kv_sync": max(push + pull + barrier - overlap, 0.0),
                "kv_overlap": overlap, "guard": guard}

    @staticmethod
    def _snapshot_compile():
        from . import compileobs

        s = compileobs.summary(include_recompiles=False)
        out = {"programs": s["programs"], "count": s["compile_count"],
               "seconds": round(s["compile_seconds"], 3),
               "recompiles": s["recompile_count"]}
        if "cache_hits" in s:
            # the compile cache is on: which ranks started warm (mxtop)
            out["cache_hits"] = int(s["cache_hits"])
            out["cache_misses"] = int(s["cache_misses"])
        last = compileobs.last_recompile()
        if last:
            out["last_recompile"] = {"program": last.get("program"),
                                     "cause": last.get("cause")}
        return out

    def build_cluster_snapshot(self, window=None, cum=None):
        """This worker's snapshot (JSON-able): rank, step, membership
        epoch, throughput, queue depths, key counters, compiles, the
        cumulative step split and, from the publisher, the ``window`` of
        the last completed steps, which straggler attribution compares."""
        snap = {
            "rank": self._rank, "ts": time.time(), "step_id": self._step,
            "mepoch": self._mepoch,
            "imgs_per_sec": telemetry.totals("fit.imgs_per_sec")[1],
            "queues": {"engine": telemetry.totals("engine.queue_depth")[1],
                       "feed": telemetry.totals("pipeline.feed_depth")[1]},
            "counters": {
                "rejected": telemetry.totals("kv.membership.rejected")[1],
                "rpc_failures": telemetry.totals("kvstore.rpc_failures")[1],
                "dead_nodes": telemetry.totals("kvstore.dead_nodes")[1],
                "bad_steps": telemetry.totals("guard.bad_steps")[1]},
            "compile": self._snapshot_compile(),
            "cum": cum if cum is not None else self._snapshot_cumulative(),
        }
        if window is not None:
            snap["window"] = window
        return snap

    def publish_cluster_snapshot(self, snap=None):
        """Overwrite this worker's persistent slot on the registry's server
        (:func:`telemetry_slot`) with ``snap``. Advisory: a failure is
        counted, never raised, and a server that wedges costs one bounded
        wait (the publish runs on an abandoned daemon thread; later ones
        are dropped while it hangs). Returns the snapshot, or None."""
        from .kvstore_server import encode_bytes_vec

        if snap is None:
            snap = self.build_cluster_snapshot()
        if self._publish_inflight is not None \
                and self._publish_inflight.is_alive():
            telemetry.counter("kv.cluster.publish_failures").inc()
            return None
        vec = encode_bytes_vec(json.dumps(snap).encode())
        result = [None]
        client = self._registry_client()

        def init():
            result[0] = self._lib.mxt_ps_client_init(
                client, telemetry_slot(self._rank),
                vec.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), vec.size)

        _, timeout_ms = self._retry_config()
        t = threading.Thread(target=init, daemon=True,
                             name="mxnet-kv-snapshot-publish")
        t.start()
        t.join(timeout_ms / 1000.0)
        if t.is_alive():
            self._publish_inflight = t
            telemetry.counter("kv.cluster.publish_failures").inc()
            return None
        self._publish_inflight = None
        if result[0] != 0:
            telemetry.counter("kv.cluster.publish_failures").inc()
            return None
        return snap

    def fetch_cluster_snapshot(self, rank, timeout_ms=None):
        """Rank ``rank``'s last published snapshot, or None."""
        if timeout_ms is None:
            _, timeout_ms = self._retry_config()
        return self._pull_published_json(self._registry_client(),
                                         telemetry_slot(rank), timeout_ms)

    def cluster_stats(self, timeout_ms=None, max_age_s=30.0):
        """The cluster's merged view, from the workers' published slots:
        ``{"workers": {rank: snapshot | None}, "mepoch": the newest epoch,
        "straggler": attribution | None}``. ``max_age_s`` keeps a dead
        rank's last snapshot out of the verdict."""
        workers = {r: self.fetch_cluster_snapshot(r, timeout_ms)
                   for r in range(self._nw)}
        mepochs = [s["mepoch"] for s in workers.values() if s]
        return {"workers": workers,
                "mepoch": max(mepochs) if mepochs else self._mepoch,
                "straggler": _pick_straggler(
                    workers, env_float("MXNET_STRAGGLER_FACTOR", 2.0),
                    max_age_s=max_age_s)}

    def start_cluster_stats(self, interval_s=None):
        """Start this worker's publisher (once; fit does on a dist store)
        and turn telemetry on, which the step split needs. Returns it, or
        None when ``MXNET_CLUSTER_STATS=0``."""
        if self._cluster is not None:
            return self._cluster
        if not env_bool("MXNET_CLUSTER_STATS", True):
            return None
        if interval_s is None:
            interval_s = env_float("MXNET_CLUSTER_STATS_INTERVAL_S", 1.0)
        telemetry.enable()
        self._cluster = _ClusterStatsPublisher(
            self, interval_s, env_float("MXNET_STRAGGLER_FACTOR", 2.0))
        self._cluster.start()
        return self._cluster

    def stop_cluster_stats(self):
        """Stop the publisher (idempotent)."""
        if self._cluster is not None:
            self._cluster.close()
            self._cluster = None

    def save_optimizer_states(self, fname):
        raise MXNetError("the optimizer states of a dist store live on its "
                         "servers: they are not saved from a worker")

    load_optimizer_states = save_optimizer_states

    def _stop_servers(self):
        """Stop every server (rank 0, at the end of the job); under HA a
        relaunched server is reached on a new connection."""
        for sid in range(self._num_servers):
            c = self._client_sid(sid) if self._ha else self._clients[sid]
            self._lib.mxt_ps_client_stop(c)

    def __del__(self):
        try:
            for c in self._clients + self._dead_clients:
                self._lib.mxt_ps_client_destroy(c)
        # fwlint: disable=swallowed-exception — interpreter teardown: the library's globals may be gone already
        except Exception:  # noqa: BLE001
            pass


class _ClusterStatsPublisher:
    """A worker's cluster-statistics thread: every ``interval_s`` it
    publishes the worker's snapshot (with the window of its last completed
    steps, :meth:`_window`); on rank 0 of a multi-worker job it also reads every rank's
    and names the straggler: the ``kv.straggler.rank`` gauge each round
    (-1: none), one ``kv.straggler`` event and warning per new naming."""

    def __init__(self, kv, interval_s, factor):
        self._kv = kv
        self._interval = max(float(interval_s), 0.05)
        self._factor = float(factor)
        self._stop = threading.Event()
        self._last_cum = None
        self._last_window = None
        self._named = None
        self._logged_failure = False
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mxnet-kv-cluster-stats")

    def start(self):
        self._thread.start()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)

    def _window(self, cum):
        """The step split since the last publish that carried a step; until
        another step completes, that last populated window again (C17:
        the JAX package publishes an empty one, so with steps longer than
        the interval two ranks' slots, populated a sleep apart, are
        seldom both populated and the straggler goes unnamed)."""
        if self._last_cum is None:
            self._last_cum = cum
            return {k: 0.0 for k in cum}
        d = {k: max(cum[k] - self._last_cum.get(k, 0.0), 0.0) for k in cum}
        if d["steps"] <= 0:
            return self._last_window or d
        self._last_cum = cum
        # compute net of the sync it contains (the classic path waits
        # inside update)
        d["compute"] = max(d["compute"] - d["kv_sync"], 0.0)
        self._last_window = d
        return d

    def _loop(self):
        kv = self._kv
        while not self._stop.wait(self._interval):
            try:
                cum = kv._snapshot_cumulative()
                kv.publish_cluster_snapshot(kv.build_cluster_snapshot(
                    window=self._window(cum), cum=cum))
                if kv.rank == 0 and kv.num_workers > 1:
                    self._attribute()
                self._logged_failure = False
            except Exception:  # noqa: BLE001 — observability degrades,
                # training never; counted, logged once per outage
                telemetry.counter("kv.cluster.publish_failures").inc()
                if not self._logged_failure:
                    self._logged_failure = True
                    logging.getLogger(__name__).warning(
                        "kvstore: cluster-stats publish failed (will keep "
                        "retrying quietly)", exc_info=True)

    def _attribute(self):
        kv = self._kv
        snaps = {r: kv.fetch_cluster_snapshot(r) for r in range(kv.num_workers)}
        max_age = max(5 * self._interval, 5.0)
        res = _pick_straggler(snaps, self._factor, max_age_s=max_age)
        if res is None:
            # all clear only when two fresh windows could be judged
            now = time.time()
            populated = sum(1 for s in snaps.values()
                            if s and (s.get("window") or {}).get("steps", 0) > 0
                            and now - float(s.get("ts", 0)) <= max_age)
            if populated >= 2:
                telemetry.gauge("kv.straggler.rank").set(-1)
                self._named = None
            return
        telemetry.gauge("kv.straggler.rank").set(res["rank"])
        key = (res["rank"], res["stage"])
        if key == self._named:
            return
        self._named = key
        telemetry.event("kv.straggler", step_id=kv.step_id,
                        **{k: v for k, v in res.items() if k != "stages"})
        logging.getLogger(__name__).warning(
            "kvstore: straggler — rank %d, dominant stage %s (%.1fx the "
            "cluster-median self time)", res["rank"], res["stage"],
            res["ratio"])


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
