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

All Python work (unpickling the optimizer, the updates, installing a
replicated or restored optimizer slot) runs on the server's main thread,
fed by a queue: the transport's connection threads only enqueue and wait.
The main thread stays inside ``import mxnet_tpu_torch`` for the process's
life, holding the package's import lock, so no other thread — connection
handlers, the replication, checkpoint, heartbeat and standby threads, the
registry's monitor — may import from the package; this module imports
what they need at its top.

A failed update leaves the key's weight as it was; it is counted and
logged, and past ``MXNET_KV_SERVER_MAX_UPDATE_FAILURES`` (default 10; 0:
the first) the server stops with an error rather than keep serving stale
weights.

High availability and elastic membership (the JAX package's, on the same
wire):

* ``MXNET_KV_REPLICAS=R`` puts the servers in groups of ``R + 1``
  (:func:`plan_server_groups`): group g serves the keys
  ``ikey % num_groups == g`` from its primary, and the primary forwards
  every applied round (the weight as a direct overwrite, the key's
  optimizer slot as ``repl:``) to its backups, at most one round ahead.
* ``MXNET_KV_SERVER_CKPT_STEPS=N`` writes the optimizer slots every N
  applied rounds to ``MXNET_KV_SERVER_CKPT_DIR`` (atomic, CRC-checked); a
  server relaunched with ``DMLC_PS_RECOVERY=1`` starts from that file, and
  a missing or corrupt file is a cold start, logged.
* ``MXNET_ELASTIC=1`` (``launch.py --elastic``): the first server of group
  0 hosts the :class:`MembershipRegistry` (workers and servers join and
  heartbeat; a lapse bumps the membership epoch, a dead primary's first
  live backup is promoted); the rest of group 0 stand by to resume it from
  its replicated snapshot.
* ``stats_to:<key>`` and ``trace_to:<key>`` publish the server's counters
  and its per-rank RPC attribution under a reserved key that the asking
  worker then pulls.

The optimizer is pickled under ``mxnet_tpu_torch.optimizer`` names: a
cluster is one package. A worker of the JAX package cannot drive a server
of the port, or the reverse, though the wire is the same.
"""
from __future__ import annotations

import base64
import ctypes
import json
import logging
import os
import pickle
import queue
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

from . import _native, fault, telemetry
from .analysis import witness
from . import optimizer as opt
from .base import env_flag, env_float, env_int, env_str
from .ndarray import NDArray
from .utils.atomic_file import atomic_write, read_verified

__all__ = ["KVStoreServer", "MembershipRegistry", "plan_server_groups",
           "_init_kvstore_server_module", "STATS_VEC_LEN",
           "encode_stats_vec", "decode_stats_vec", "encode_bytes_vec",
           "decode_bytes_vec"]

log = logging.getLogger(__name__)


def plan_server_groups(num_servers, replicas):
    """The server ids split into replicated groups of ``replicas + 1``:
    group g serves the keys ``ikey % num_groups == g``, its first member is
    the primary at start, the others its backups in failover order.
    ``replicas=0`` gives one group per server, the sharding without HA."""
    num_servers = int(num_servers)
    replicas = int(replicas)
    if replicas < 0:
        raise ValueError("MXNET_KV_REPLICAS must be >= 0, got %d" % replicas)
    width = replicas + 1
    if num_servers % width:
        raise ValueError(
            "MXNET_KV_REPLICAS=%d needs a server count divisible by %d, "
            "got %d server(s)" % (replicas, width, num_servers))
    return [list(range(g * width, (g + 1) * width))
            for g in range(num_servers // width)]


# The vector a server publishes for ``stats_to:<key>``: each counter as two
# 24-bit words (float32 holds integers exactly only to 2^24), the
# has_optimizer flag, then the HA counters. The order is the wire: fields
# are appended, never reordered, so a decoder reading the older, shorter
# vector still parses its prefix.
_STATS_COUNTER_FIELDS = ("updates_applied", "update_failures")
_STATS_COUNTER_FIELDS_HA = (
    "repl_forwards", "repl_acks", "repl_failures", "repl_lag_rounds",
    "ckpt_writes", "ckpt_restores", "ckpt_bytes")
STATS_VEC_LEN = (2 * len(_STATS_COUNTER_FIELDS) + 1
                 + 2 * len(_STATS_COUNTER_FIELDS_HA))


def encode_stats_vec(stats):
    """A stats dict as the float32 wire vector (low and high 24 bits)."""
    vec = []
    for f in _STATS_COUNTER_FIELDS:
        v = int(stats[f])
        vec += [float(v & 0xFFFFFF), float(v >> 24)]
    vec.append(1.0 if stats["has_optimizer"] else 0.0)
    for f in _STATS_COUNTER_FIELDS_HA:
        v = int(stats.get(f, 0))
        vec += [float(v & 0xFFFFFF), float(v >> 24)]
    return np.array(vec, np.float32)


def decode_stats_vec(arr):
    """The inverse of :func:`encode_stats_vec`; a vector without the HA
    counters decodes without them."""
    vals = [int(round(float(x))) for x in arr]
    out = {}
    for i, f in enumerate(_STATS_COUNTER_FIELDS):
        out[f] = vals[2 * i] | (vals[2 * i + 1] << 24)
    base = 2 * len(_STATS_COUNTER_FIELDS)
    out["has_optimizer"] = bool(vals[base])
    for i, f in enumerate(_STATS_COUNTER_FIELDS_HA):
        lo = base + 1 + 2 * i
        if lo + 1 >= len(vals):
            break
        out[f] = vals[lo] | (vals[lo + 1] << 24)
    return out


def encode_bytes_vec(payload):
    """Bytes as the float32 vector ``[len, b0, b1, ...]`` (the channel the
    membership table, snapshots and traces travel on)."""
    vec = np.empty(len(payload) + 1, np.float32)
    vec[0] = len(payload)
    if payload:
        vec[1:] = np.frombuffer(payload, np.uint8)
    return vec


def decode_bytes_vec(arr):
    """The inverse of :func:`encode_bytes_vec`; a longer buffer is fine (a
    pull hands over a fixed-size one), a torn one gives None."""
    n = int(round(float(arr[0])))
    if n < 0 or n > len(arr) - 1:
        return None
    return bytes(np.asarray(np.round(arr[1:1 + n]), np.uint8))


def _root_addr():
    return (os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1"),
            int(os.environ.get("DMLC_PS_ROOT_PORT", "9091")))


class MembershipRegistry:
    """The cluster's membership, hosted on the first server of group 0.

    Workers join (``mb_join``), heartbeat (``mb_hb``), leave, report done
    and read the table (``mb_get``, published under a reserved key). The
    registry owns the membership epoch: every change after the first
    ``num_workers`` joins (a lapse, a leave, a rejoin) bumps it, and the
    new ``mepoch:<epoch>:<workers>`` reaches every server before the table
    shows it, so once a worker reads an epoch every server already rejects
    the one before.

    Servers heartbeat too (``mb_srv_hb``): a lapse, or a worker's
    probe-confirmed ``mb_srv_dead``, evicts a server; when it was its
    group's primary the first live backup is promoted, the new key-group
    map (``smap``) goes to every server, then the epoch bumps. A rejoining
    server comes back as a backup (the map is sticky), unless its group had
    no live member. Server lapses are watched only once a server has
    beaten. The registry copies its own state to group 0's standbys every
    timeout (``mb_sync``).

    ``broadcast`` and ``probe`` are injectable (the tests); the defaults
    send each command on a deadline-bounded probe and probe a server on a
    fresh connection."""

    def __init__(self, num_workers, heartbeat_timeout_s=None,
                 broadcast=None, logger=None, num_servers=None,
                 replicas=None, probe=None, resume=None):
        # imports nothing: a standby builds a registry on its own thread
        self._target = int(num_workers)
        self._timeout_s = (heartbeat_timeout_s if heartbeat_timeout_s
                           is not None else env_float(
                               "MXNET_ELASTIC_HEARTBEAT_TIMEOUT_S", 5.0))
        self._logger = logger or log
        self._broadcast = (broadcast if broadcast is not None
                           else self._broadcast_to_servers)
        self._lock = threading.Lock()
        self._lock = witness.declare(
            "mxnet_tpu_torch.kvstore_server.MembershipRegistry._lock",
            self._lock)
        self._alive = {}      # rank -> monotonic time of its last beat
        self._last_step = {}  # rank -> the training step it last reported
        self._epoch = 0
        self._formed = False
        self._done = False
        self._pos = None      # the restart position the coordinator published
        self._bcast_clients = None   # sid -> (addr, client), made at first use
        if num_servers is None:
            num_servers = int(os.environ.get("DMLC_NUM_SERVER", "1"))
        if replicas is None:
            replicas = env_int("MXNET_KV_REPLICAS", 0)
        self._groups = plan_server_groups(num_servers, replicas)
        now = time.monotonic()
        self._srv_alive = {s: now for s in range(int(num_servers))}
        self._smap = [g[0] for g in self._groups]   # group -> primary
        self._srv_monitoring = False   # armed by the first server beat
        self._srv_probe = probe if probe is not None else self._probe_server
        self._sync_at = now
        if resume:
            self._resume_from(resume)
        self._stop = threading.Event()
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name="mxnet-kv-membership-monitor")
        self._monitor.start()

    def _resume_from(self, snap):
        """Take over a predecessor's :meth:`snapshot`. Beat times travel as
        ages (monotonic clocks are per process): the dead predecessor's
        beat then lapses here within a timeout."""
        now = time.monotonic()
        with self._lock:
            self._epoch = int(snap.get("epoch", 0))
            self._formed = bool(snap.get("formed", False))
            self._done = bool(snap.get("done", False))
            self._pos = snap.get("pos")
            self._last_step = {int(r): int(s)
                               for r, s in (snap.get("steps") or {}).items()}
            self._alive = {int(r): now - float(age)
                           for r, age in (snap.get("workers") or {}).items()}
            if snap.get("servers") is not None:
                self._srv_alive = {int(s): now - float(age)
                                   for s, age in snap["servers"].items()}
            if snap.get("smap"):
                self._smap = [None if s is None else int(s)
                              for s in snap["smap"]]
            self._srv_monitoring = bool(snap.get("srv_monitoring", False))

    def snapshot(self):
        """The registry's state as JSON-able data (``mb_sync``)."""
        with self._lock:
            now = time.monotonic()
            return {"epoch": self._epoch, "formed": self._formed,
                    "done": self._done, "pos": self._pos,
                    "steps": {str(r): s for r, s in self._last_step.items()},
                    "workers": {str(r): now - t
                                for r, t in self._alive.items()},
                    "servers": {str(s): now - t
                                for s, t in self._srv_alive.items()},
                    "smap": list(self._smap),
                    "srv_monitoring": self._srv_monitoring}

    # ---- workers -----------------------------------------------------------
    def join(self, rank, step=None):
        """Register ``rank`` (its first beat). After formation every join
        bumps the epoch, a rank still listed alive too: its rejoin means
        its last incarnation died, and a round it half-pushed must go."""
        rank = int(rank)
        with self._lock:
            self._alive[rank] = time.monotonic()
            if step is not None:
                self._last_step[rank] = int(step)
            if not self._formed:
                if len(self._alive) >= self._target:
                    self._formed = True
                    self._logger.info(
                        "membership: formed with workers %s (epoch %d)",
                        sorted(self._alive), self._epoch)
                return self._epoch
            telemetry.event("worker_joined", rank=rank,
                            epoch=self._epoch + 1,
                            last_step=self._last_step.get(rank))
            self._bump_locked("worker %d joined" % rank)
            return self._epoch

    def heartbeat(self, rank, step=None):
        """Refresh a known member (an evicted rank must join again)."""
        with self._lock:
            if int(rank) in self._alive:
                self._alive[int(rank)] = time.monotonic()
                if step is not None:
                    self._last_step[int(rank)] = int(step)

    def leave(self, rank):
        """A member leaves: the reconfiguration of a lapse, at once."""
        with self._lock:
            if int(rank) in self._alive:
                del self._alive[int(rank)]
                if self._formed:
                    telemetry.event("worker_lost", rank=int(rank),
                                    reason="leave", epoch=self._epoch + 1,
                                    last_step=self._last_step.get(int(rank)))
                    self._bump_locked("worker %s left" % rank)

    def done(self, rank):
        """``rank`` finished training: removed without a bump (all workers
        end at the same boundary), and the table's ``done`` tells a worker
        relaunched late to exit. Ranks that did not report done are still
        watched: one killed after a peer finished must still bump, or the
        peer's last barrier would wait for it forever."""
        with self._lock:
            self._alive.pop(int(rank), None)
            self._done = True

    def set_pos(self, payload):
        """The restart position the coordinator published (epoch, nbatch,
        iterator state, membership epoch), for a joiner to enter at."""
        with self._lock:
            self._pos = payload

    # ---- servers -----------------------------------------------------------
    def server_heartbeat(self, sid):
        """Refresh server ``sid``; an unknown one rejoins as a backup of its
        group (or revives a group with no live member). The first server
        beat arms the lapse watch and restarts every server's clock."""
        sid = int(sid)
        with self._lock:
            self._arm_srv_locked()
            if sid in self._srv_alive:
                self._srv_alive[sid] = time.monotonic()
                return
            self._srv_alive[sid] = time.monotonic()
            telemetry.event("server_rejoined", sid=sid, epoch=self._epoch)
            self._logger.warning(
                "membership: server %d rejoined as a backup of its group "
                "(smap %s)", sid, self._smap)
            self._reconfigure_servers_locked(rejoined=sid)

    server_join = server_heartbeat

    def server_suspect(self, sid):
        """A worker found server ``sid`` dead: evict it only when a probe
        on a fresh connection (outside the lock) confirms it."""
        sid = int(sid)
        with self._lock:
            if sid not in self._srv_alive:
                return
        if self._srv_probe(sid):
            self._logger.info(
                "membership: server %d reported dead by a worker but "
                "answers probes — keeping it", sid)
            return
        with self._lock:
            if sid in self._srv_alive:
                del self._srv_alive[sid]
                telemetry.event("server_lost", sid=sid,
                                reason="worker_report", epoch=self._epoch)
                self._reconfigure_servers_locked(lost=sid)

    def table(self):
        """The membership table workers read (JSON-able)."""
        with self._lock:
            return {"epoch": self._epoch, "workers": sorted(self._alive),
                    "target": self._target, "formed": self._formed,
                    "done": self._done, "pos": self._pos,
                    "steps": dict(self._last_step),
                    "smap": list(self._smap),
                    "servers": sorted(self._srv_alive)}

    def close(self):
        """Stop the monitor and close the broadcast connections (a server
        stops only once every connection into it has closed)."""
        self._stop.set()
        self._monitor.join(timeout=5)
        with self._lock:
            clients, self._bcast_clients = self._bcast_clients or {}, {}
        lib = _native.load() if clients else None
        for _, c in clients.values():
            if c:
                lib.mxt_ps_client_destroy(c)

    # ---- internals ---------------------------------------------------------
    def _bump_locked(self, why):
        """(holds ``_lock``) Bump the epoch and tell every server before
        any worker can read it."""
        self._epoch += 1
        self._pos = None   # the last membership's position is stale
        workers = len(self._alive)
        telemetry.counter("kv.membership.reconfigures").inc()
        telemetry.gauge("kv.membership.epoch").set(self._epoch)
        self._logger.warning("membership: epoch %d (%s) — %d worker(s): %s",
                             self._epoch, why, workers, sorted(self._alive))
        self._broadcast("mepoch:%d:%d" % (self._epoch, max(workers, 1)))

    def _arm_srv_locked(self):
        if not self._srv_monitoring:
            self._srv_monitoring = True
            now = time.monotonic()
            for s in self._srv_alive:
                self._srv_alive[s] = now

    def _recompute_smap_locked(self):
        """Keep each group's live primary; a dead one gives way to the
        group's first live member. Returns the ``(group, old, new)``
        changes."""
        changed = []
        for gi, members in enumerate(self._groups):
            cur = self._smap[gi]
            if cur is not None and cur in self._srv_alive:
                continue
            new = next((s for s in members if s in self._srv_alive), None)
            if new != cur:
                self._smap[gi] = new
                changed.append((gi, cur, new))
        return changed

    def _reconfigure_servers_locked(self, lost=None, rejoined=None):
        """A server left or came back: recompute the map, send it to every
        live server, and bump the epoch only when a primary changed (the
        map goes first: once a worker reconfigures, the servers already
        route and replicate on it)."""
        changed = self._recompute_smap_locked()
        promotions = [c for c in changed if c[2] is not None]
        self._broadcast("smap:" + json.dumps(
            {"smap": self._smap, "alive": sorted(self._srv_alive)}))
        for gi, _, new in changed:
            if new is None:
                self._logger.error(
                    "membership: server group %d lost ALL members %s — its "
                    "key range is unservable until one rejoins",
                    gi, self._groups[gi])
        if not promotions:
            if lost is not None:
                self._logger.warning(
                    "membership: backup server %s lost — no promotion "
                    "needed (smap %s)", lost, self._smap)
            return
        for gi, old, new in promotions:
            telemetry.counter("kv.replication.failovers").inc()
            telemetry.event("server_promoted", group=gi, old_primary=old,
                            new_primary=new, epoch=self._epoch + 1)
        what = ["group %d: %s->%s" % c for c in promotions]
        self._bump_locked("server %s lost — promoted %s" % (lost, what)
                          if lost is not None else
                          "server %s rejoined — revived %s" % (rejoined, what))

    def _probe_server(self, sid):
        """Whether server ``sid`` answers a probe on a fresh connection."""
        host, port = _root_addr()
        timeout_ms = max(min(int(self._timeout_s * 1000), 2000), 100)
        return _native.load().mxt_ps_probe(host.encode(), port + int(sid),
                                           timeout_ms) == 0

    def _broadcast_to_servers(self, cmd):
        """(holds ``_lock``) Send ``cmd`` to every live server, each on a
        deadline-bounded probe: a wedged server costs one timeout."""
        lib = _native.load()
        host, port = _root_addr()
        if self._bcast_clients is None:
            self._bcast_clients = {}
            for s in range(sum(len(g) for g in self._groups)):
                self._bcast_clients[s] = (
                    "%s:%d" % (host, port + s),
                    lib.mxt_ps_client_create2(host.encode(), port + s, 30))
        timeout_ms = max(int(self._timeout_s * 1000), 1)
        alive = set(self._srv_alive)  # fwlint: disable=unguarded-shared-write — every caller holds _lock (reached through the self._broadcast indirection)
        for s, (addr, c) in self._bcast_clients.items():
            if s not in alive:
                continue
            if not c or lib.mxt_ps_client_is_dead(c):
                if c:
                    lib.mxt_ps_client_destroy(c)
                c = lib.mxt_ps_client_create2(host.encode(), port + s, 30)
                self._bcast_clients[s] = (addr, c)
            if not c or lib.mxt_ps_client_probe(c, cmd.encode(),
                                                timeout_ms) != 0:
                self._logger.error(
                    "membership: server %s did not acknowledge %r — a stale "
                    "epoch may briefly survive there", addr, cmd[:64])

    def _sync_standbys(self):
        """Send the registry's snapshot to group 0's standbys."""
        if len(self._groups[0]) < 2:
            return
        payload = base64.b64encode(
            json.dumps(self.snapshot()).encode()).decode()
        with self._lock:
            self._broadcast("mb_sync:" + payload)

    def _monitor_loop(self):
        while not self._stop.wait(max(self._timeout_s / 4.0, 0.1)):
            now = time.monotonic()
            sync_due = False
            with self._lock:
                if self._srv_monitoring:
                    dead = [s for s, t in self._srv_alive.items()
                            if now - t > self._timeout_s]
                    for s in dead:
                        del self._srv_alive[s]
                        telemetry.event("server_lost", sid=s,
                                        reason="heartbeat_lapse",
                                        epoch=self._epoch)
                    if dead:
                        self._logger.warning(
                            "membership: server heartbeat lapse: %s",
                            sorted(dead))
                        self._reconfigure_servers_locked(lost=sorted(dead))
                    if now >= self._sync_at:
                        self._sync_at = now + self._timeout_s
                        sync_due = True
                if self._formed:
                    expired = [r for r, t in self._alive.items()
                               if now - t > self._timeout_s]
                    for r in expired:
                        del self._alive[r]
                        telemetry.event("worker_lost", rank=r,
                                        reason="heartbeat_lapse",
                                        epoch=self._epoch + 1,
                                        last_step=self._last_step.get(r))
                    if expired:
                        self._bump_locked(
                            "heartbeat lapse: worker(s) %s" % sorted(expired))
            if sync_due:
                try:
                    self._sync_standbys()
                except Exception:  # noqa: BLE001 — a failed copy costs the
                    # standby's freshness, never the registry
                    self._logger.exception("membership: mb_sync failed")


class KVStoreServer:
    """One shard of the parameter server (reference: kvstore_server.py:20
    KVStoreServer)."""

    def __init__(self, port=None, num_workers=None, sync=True):
        # raises MXNetError when the library cannot be built or loaded
        lib = _native.load()
        self._lib = lib
        self._sid = int(os.environ.get("DMLC_SERVER_ID", "0"))
        host, root_port = _root_addr()
        if port is None:
            port = root_port + self._sid
        if num_workers is None:
            num_workers = int(os.environ.get("DMLC_NUM_WORKER", "1"))
        self._handle = lib.mxt_ps_server_create(port, num_workers,
                                                1 if sync else 0)
        if not self._handle:
            raise RuntimeError("cannot bind PS server port %d" % port)
        self._port = port
        self._num_workers = int(num_workers)
        self._updater = None   # the Updater of the pickled optimizer
        self._optimizer_obj = None
        self._updater_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats_lock = witness.declare(
            "mxnet_tpu_torch.kvstore_server.KVStoreServer._stats_lock",
            self._stats_lock)
        self._updates_applied = 0      # guarded-by: _stats_lock
        self._update_failures = 0      # guarded-by: _stats_lock
        self._last_update_error = None  # guarded-by: _stats_lock
        # guarded-by: _stats_lock
        self._ha_stats = dict.fromkeys(_STATS_COUNTER_FIELDS_HA, 0)
        self._max_update_failures = env_int(
            "MXNET_KV_SERVER_MAX_UPDATE_FAILURES", 10)
        self._exec_q = queue.Queue()
        self._self_client = None       # loopback client for publishes
        self._self_client_lock = threading.Lock()

        # ---- groups, replication, membership ------------------------------
        self._elastic = env_flag("MXNET_ELASTIC")
        self._replicas = env_int("MXNET_KV_REPLICAS", 0)
        self._nservers = int(os.environ.get("DMLC_NUM_SERVER", "1"))
        self._groups = plan_server_groups(self._nservers, self._replicas)
        self._gi = next((i for i, g in enumerate(self._groups)
                         if self._sid in g), None)
        group = self._groups[self._gi] if self._gi is not None else [self._sid]
        self._backups = [s for s in group if s != self._sid]
        self._hb_timeout_s = env_float("MXNET_ELASTIC_HEARTBEAT_TIMEOUT_S", 5.0)
        self._ha_lock = threading.Lock()
        self._ha_lock = witness.declare(
            "mxnet_tpu_torch.kvstore_server.KVStoreServer._ha_lock",
            self._ha_lock)
        self._alive_sids = set(range(self._nservers))  # guarded-by: _ha_lock
        self._smap_view = [g[0] for g in self._groups]  # guarded-by: _ha_lock
        self._primary = group[0] == self._sid          # guarded-by: _ha_lock
        self._mb_sync = None    # the standby's last registry snapshot
        self._pending_states = None   # slots awaiting an optimizer (main)
        self._repl_recv_seq = {}      # key -> last replicated round (main)
        # one round in flight per key: offering the next round of a key
        # waits (bounded) for the last one's forward, so a backup is never
        # more than one round behind
        self._repl_cv = threading.Condition()
        self._repl_inflight = set()   # guarded-by: _repl_cv
        self._repl_seq = 0            # guarded-by: _repl_cv
        self._repl_done_seq = 0       # guarded-by: _repl_cv
        self._repl_clients = {}       # sid -> client; guarded-by: _repl_cv
        self._mepoch = 0              # guarded-by: _repl_cv
        self._reg_clients = {}        # sid -> client (heartbeat thread)
        self._repl_wait_s = min(self._hb_timeout_s, 2.0)
        self._repl_q = queue.Queue()
        self._ha_stop = threading.Event()
        self._ha_threads = []

        # ---- optimizer-slot checkpoints -------------------------------------
        self._ckpt_steps = env_int("MXNET_KV_SERVER_CKPT_STEPS", 0)
        ckpt_dir = env_str("MXNET_KV_SERVER_CKPT_DIR", "") or os.path.join(
            tempfile.gettempdir(), "mxnet-kv-server-ckpt-%d" % os.getuid())
        self._ckpt_path = os.path.join(ckpt_dir,
                                       "kv_server_%d.optstate" % self._sid)
        self._ckpt_count = 0          # applied rounds (main thread)
        self._ckpt_q = queue.Queue()
        if self._ckpt_steps > 0:
            os.makedirs(ckpt_dir, exist_ok=True)
        if env_flag("DMLC_PS_RECOVERY"):
            self._restore_checkpoint()

        # the first member of group 0 hosts the registry; the rest of group
        # 0 stand by to resume it, in group order
        self._registry = None
        if self._elastic and self._sid == self._groups[0][0]:
            self._registry = MembershipRegistry(num_workers)

        self._apply_cb = _native.UPDATER_FN(self._apply)   # kept alive
        self._command_cb = _native.COMMAND_FN(self._command)
        lib.mxt_ps_server_set_updater(
            self._handle, ctypes.cast(self._apply_cb, ctypes.c_void_p))
        lib.mxt_ps_server_set_command_handler(
            self._handle, ctypes.cast(self._command_cb, ctypes.c_void_p))
        self._start_ha_threads()

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
        store the push when there is no optimizer); a primary with backups
        then offers the round for replication."""
        grad = np.ctypeslib.as_array(
            ctypes.cast(grad_ptr, ctypes.POINTER(ctypes.c_float)), (n,))
        weight = np.ctypeslib.as_array(
            ctypes.cast(weight_ptr, ctypes.POINTER(ctypes.c_float)), (n,))
        # the `kill_server` fault point: dies while slots and replication
        # are in flight, the case promotion must survive
        fault.kill_server(self._sid)
        key = int(key)
        with self._updater_lock:
            updater = self._updater
        # read under the lock a promotion flips it under: a round is offered
        # by the server that is primary when the round lands
        with self._ha_lock:
            primary = self._primary
        repl = self._replicas > 0 and primary and self._backups
        if updater is None:
            weight[:] = grad
            if repl:
                self._repl_offer(key, weight.copy(), None)
            return
        box = {}

        def work():
            fault.hit("server_updater")
            w = NDArray(torch.from_numpy(weight.copy()))
            updater(key, NDArray(torch.from_numpy(grad.copy())), w)
            weight[:] = w.asnumpy()
            if repl:
                box["state"] = self._slot_state_blob(key)
            self._ckpt_tick_main()

        err = self._on_main(work)
        if err is None:
            with self._stats_lock:
                self._updates_applied += 1
            telemetry.counter("kvstore_server.updates_applied").inc()
            if repl:
                self._repl_offer(key, weight.copy(), box.get("state"))
        else:
            self._note_update_failure(key, err)

    def _command(self, cmd_ptr, n):
        """The transport's command callback: 0 acknowledges, 1 refuses
        (see :meth:`_handle_membership`)."""
        cmd = ctypes.string_at(cmd_ptr, n)
        try:
            return 1 if self._dispatch(cmd) is False else 0
        except Exception:  # noqa: BLE001 — a bad command must not take the
            # connection thread down
            log.exception("kvstore-server %d: command %r failed", self._sid,
                          cmd[:48])
            return 0

    def _dispatch(self, cmd):
        """Act on ``cmd``; False when this server refuses it."""
        if cmd.startswith(b"optim:"):
            blob = base64.b64decode(cmd[6:])
            err = self._on_main(lambda: self._set_optimizer(pickle.loads(blob)))
            if err is not None:
                log.error("kvstore-server: cannot install the optimizer: %r",
                          err)
        elif cmd.startswith(b"mepoch:"):
            # the transport already adopted it; replication clients stamp it
            self._adopt_mepoch(int(cmd.split(b":")[1]))
        elif cmd.startswith(b"smap:"):
            self._adopt_smap(cmd[5:])
        elif cmd.startswith(b"repl:"):
            self._handle_repl(cmd)
        elif cmd.strip() == b"stats":
            log.warning("kvstore-server stats: %s", self.stats())
        elif cmd.startswith(b"stats_to:"):
            log.warning("kvstore-server stats: %s", self.stats())
            self._publish_vec(int(cmd[9:]), encode_stats_vec(self.stats()))
        elif cmd.startswith(b"trace_to:"):
            payload = json.dumps({"per_rank": self.trace_stats()}).encode()
            self._publish_vec(int(cmd[9:]), encode_bytes_vec(payload))
        elif cmd.startswith(b"mb_"):
            return self._handle_membership(cmd)
        elif not cmd.startswith((b"ping", b"sync:", b"elastic:")):
            # (the transport itself acts on ping, sync: and elastic:)
            log.error("kvstore-server %d: unknown command %r ignored",
                      self._sid, cmd[:32])

    def _note_update_failure(self, key, err):
        """Count a failed update (the weight kept its value); past the
        threshold, queue a task that raises out of :meth:`run`."""
        telemetry.counter("kvstore_server.update_failures").inc()
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

    # ---- groups and replication --------------------------------------------
    def _start_ha_threads(self):
        def start(name, target):
            t = threading.Thread(target=target, daemon=True, name=name)
            t.start()
            self._ha_threads.append(t)

        if self._replicas > 0 and self._backups:
            start("mxnet-kv-replication", self._repl_loop)
        if self._ckpt_steps > 0:
            start("mxnet-kv-server-ckpt-writer", self._ckpt_writer_loop)
        if self._elastic and self._nservers > 1:
            # a lone server has nobody to fail over to: no beats
            start("mxnet-kv-server-heartbeat", self._hb_loop)
        if self._elastic and self._registry is None and self._gi == 0:
            start("mxnet-kv-registry-standby", self._standby_loop)

    def _adopt_mepoch(self, epoch):
        with self._repl_cv:
            self._mepoch = epoch = int(epoch)
            clients = [c for c in self._repl_clients.values() if c]
        for c in clients:
            self._lib.mxt_ps_client_set_epoch(c, epoch)

    def _adopt_smap(self, payload):
        """The registry's key-group map and live set: a primary picks its
        replication targets from it, a backup learns it was promoted."""
        m = json.loads(payload.decode())
        with self._ha_lock:
            self._alive_sids = {int(s) for s in m.get("alive", [])}
            smap = [None if s is None else int(s) for s in m.get("smap", [])]
            if len(smap) == len(self._smap_view):
                self._smap_view = smap
            was = self._primary
            self._primary = (self._gi is not None
                             and self._smap_view[self._gi] == self._sid)
            now = self._primary
        if now and not was:
            log.warning("kvstore-server %d: PROMOTED to primary of group %d "
                        "(smap %s)", self._sid, self._gi, smap)
        elif was and not now:
            log.warning("kvstore-server %d: demoted to backup of group %d "
                        "(smap %s)", self._sid, self._gi, smap)

    def _repl_targets(self):
        with self._ha_lock:
            return [s for s in self._backups if s in self._alive_sids]

    def _repl_offer(self, key, weight_np, state_blob):
        """Queue an applied round for the backups (connection thread, after
        the round committed here). Waits, at most ``_repl_wait_s``, while
        the key's last round is still being forwarded; past that the round
        is queued anyway (a forward carries the whole weight, so a skipped
        wait delays a backup, never corrupts it)."""
        with self._repl_cv:
            deadline = time.monotonic() + self._repl_wait_s
            while key in self._repl_inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._repl_cv.wait(remaining)
            self._repl_inflight.add(key)
            self._repl_seq += 1
            seq = self._repl_seq
            lag = self._repl_seq - self._repl_done_seq
        telemetry.gauge("kv.replication.lag_rounds").set(lag)
        with self._stats_lock:
            self._ha_stats["repl_lag_rounds"] = lag
        self._repl_q.put((key, weight_np, state_blob, seq))

    def _repl_loop(self):
        lib = self._lib
        while not self._ha_stop.is_set():
            item = self._repl_q.get()
            if item is None:
                break
            key, vec, state_blob, seq = item
            forwards = acks = failures = 0
            for sid in self._repl_targets():
                forwards += 1
                ok = False
                try:
                    c = self._repl_client(sid)
                    if c and lib.mxt_ps_client_init(
                            c, key, vec.ctypes.data_as(
                                ctypes.POINTER(ctypes.c_float)),
                            vec.size) == 0:
                        ok = state_blob is None or lib.mxt_ps_client_probe(
                            c, b"repl:%d:%d:%s" % (key, seq,
                                                   base64.b64encode(state_blob)),
                            int(self._repl_wait_s * 1000)) == 0
                except Exception:  # noqa: BLE001 — a sick backup must never
                    # stall the primary's data path
                    log.exception("kvstore-server %d: replication forward "
                                  "to %d failed", self._sid, sid)
                if ok:
                    acks += 1
                else:
                    failures += 1
            telemetry.counter("kv.replication.forwards").inc(forwards)
            if acks:
                telemetry.counter("kv.replication.acks").inc(acks)
            if failures:
                telemetry.counter("kv.replication.errors").inc(failures)
            with self._stats_lock:
                self._ha_stats["repl_forwards"] += forwards
                self._ha_stats["repl_acks"] += acks
                self._ha_stats["repl_failures"] += failures
            with self._repl_cv:
                self._repl_inflight.discard(key)
                self._repl_done_seq = seq
                lag = self._repl_seq - seq
                self._repl_cv.notify_all()
            # the rounds still queued once this one went out (the JAX
            # package's server sets the lag only when it queues a round,
            # so there it keeps reading 1 after the last forward)
            telemetry.gauge("kv.replication.lag_rounds").set(lag)
            with self._stats_lock:
                self._ha_stats["repl_lag_rounds"] = lag

    def _repl_client(self, sid):
        """The replication thread's client of backup ``sid``, made again
        (bounded connect) after the backup restarted."""
        lib = self._lib
        with self._repl_cv:
            c = self._repl_clients.get(sid)
        if c and not lib.mxt_ps_client_is_dead(c):
            return c
        if c:
            lib.mxt_ps_client_destroy(c)
        host, port = _root_addr()
        c = lib.mxt_ps_client_create2(host.encode(), port + sid, 10)
        with self._repl_cv:
            if c:
                lib.mxt_ps_client_set_epoch(c, self._mepoch)
            self._repl_clients[sid] = c
        return c

    def _handle_repl(self, cmd):
        """A backup's side of a forward: ``repl:<key>:<seq>:<b64 pickled
        state>`` (the weight came just before, as a direct overwrite on the
        same connection). The slot is installed on the main thread."""
        key_s, _, rest = cmd[5:].partition(b":")
        seq_s, _, b64 = rest.partition(b":")
        key, seq = int(key_s), int(seq_s)

        def install():
            state = pickle.loads(base64.b64decode(b64))
            if self._updater is not None:
                self._updater.states[key] = opt._from_np(state)
            else:
                if self._pending_states is None:
                    self._pending_states = {}
                self._pending_states[key] = state
            self._repl_recv_seq[key] = seq
            self._ckpt_tick_main()

        err = self._on_main(install)
        if err is not None:
            log.error("kvstore-server %d: replicated slot install failed for "
                      "key %d: %r", self._sid, key, err)

    def _slot_state_blob(self, key):
        """(main thread) The key's optimizer slot as pickled numpy, or None
        when it has none."""
        u = self._updater
        state = None if u is None else u.states.get(key)
        if state is None:
            return None
        return pickle.dumps(opt._to_np(state))

    # ---- optimizer-slot checkpoints -----------------------------------------
    def _ckpt_tick_main(self):
        """(main thread) Count a round; every ``MXNET_KV_SERVER_CKPT_STEPS``
        pickle the slots and hand them to the writer thread (the fsync
        stays off the update path)."""
        if self._ckpt_steps <= 0:
            return
        self._ckpt_count += 1
        if self._ckpt_count % self._ckpt_steps:
            return
        u = self._updater
        if u is not None and u.states:
            states = {k: opt._to_np(v) for k, v in u.states.items()}
        elif self._pending_states:
            states = dict(self._pending_states)
        else:
            return   # a stateless optimizer: nothing durable to write
        self._ckpt_q.put(pickle.dumps({"optimizer": self._optimizer_obj,
                                       "states": states,
                                       "updates_applied": self._ckpt_count}))

    def _ckpt_writer_loop(self):
        while not self._ha_stop.is_set():
            blob = self._ckpt_q.get()
            if blob is None:
                break
            try:
                with atomic_write(self._ckpt_path,
                                  fault_name="server_ckpt_write") as w:
                    w.write(blob)
                telemetry.counter("kv.server_ckpt.writes").inc()
                telemetry.counter("kv.server_ckpt.bytes").inc(len(blob))
                with self._stats_lock:
                    self._ha_stats["ckpt_writes"] += 1
                    self._ha_stats["ckpt_bytes"] += len(blob)
                    first = self._ha_stats["ckpt_writes"] == 1
                # the first at warning: where durability landed, once
                (log.warning if first else log.info)(
                    "kvstore-server %d: optimizer-state checkpoint (%d bytes, "
                    "states crc 0x%08x) -> %s", self._sid, len(blob),
                    zlib.crc32(blob), self._ckpt_path)
            except Exception:  # noqa: BLE001 — a failed write costs
                # durability, never the serving path
                telemetry.counter("kv.server_ckpt.errors").inc()
                log.exception("kvstore-server %d: optimizer-state checkpoint "
                              "write failed", self._sid)

    def _restore_checkpoint(self):
        """(``DMLC_PS_RECOVERY=1``, before serving) Take the optimizer slots
        from the last checkpoint. A missing file is a cold start; a corrupt
        one (CRC) or an unreadable one is a cold start, counted and
        logged."""
        if not os.path.exists(self._ckpt_path):
            return
        try:
            blob = read_verified(self._ckpt_path)
            snap = pickle.loads(blob)
            self._pending_states = dict(snap.get("states") or {})
            if snap.get("optimizer") is not None:
                self._set_optimizer(snap["optimizer"])
            telemetry.counter("kv.server_ckpt.restores").inc()
            with self._stats_lock:
                self._ha_stats["ckpt_restores"] += 1
            log.warning("kvstore-server %d: restored optimizer state for %d "
                        "key(s) from %s (%d bytes, states crc 0x%08x) — warm "
                        "start", self._sid, len(snap.get("states") or {}),
                        self._ckpt_path, len(blob), zlib.crc32(blob))
        except Exception:  # noqa: BLE001 — a CRC mismatch, a torn pickle:
            # a cold start, never a dead slot
            self._pending_states = None
            telemetry.counter("kv.server_ckpt.errors").inc()
            log.exception("kvstore-server %d: optimizer-state checkpoint %s "
                          "unreadable — cold start (momentum resets)",
                          self._sid, self._ckpt_path)

    # ---- the registry: heartbeats, standby, commands --------------------------
    def _hb_loop(self):
        """Beat to the registry: directly when it lives here, else to group
        0's members in failover order until one acknowledges (which is how
        the beat finds a resumed registry)."""
        period = max(self._hb_timeout_s / 3.0, 0.1)
        target = [self._groups[0][0]]
        while not self._ha_stop.wait(period):
            try:
                reg = self._registry
                if reg is not None:
                    reg.server_heartbeat(self._sid)
                else:
                    self._send_registry_hb(target)
            except Exception:  # noqa: BLE001 — the beat must never die
                log.exception("kvstore-server %d: heartbeat failed", self._sid)

    def _send_registry_hb(self, target):
        lib = self._lib
        host, port = _root_addr()
        cmd = b"mb_srv_hb:%d" % self._sid
        timeout_ms = max(int(self._hb_timeout_s * 500), 100)
        cands = [target[0]] + [s for s in self._groups[0]
                               if s not in (target[0], self._sid)]
        for sid in cands:
            c = self._reg_clients.get(sid)
            if c and lib.mxt_ps_client_is_dead(c):
                lib.mxt_ps_client_destroy(c)
                c = None
            if not c:
                c = lib.mxt_ps_client_create2(host.encode(), port + sid, 10)
                self._reg_clients[sid] = c
            if c and lib.mxt_ps_client_probe(c, cmd, timeout_ms) == 0:
                target[0] = sid
                return
        log.warning("kvstore-server %d: no registry candidate %s "
                    "acknowledged a heartbeat", self._sid, cands)

    def _standby_loop(self):
        """A member of group 0 after the registry's host: once every member
        before it is dead (two rounds of fresh-connection probes, after one
        was seen alive), resume the registry here from the last
        ``mb_sync`` snapshot."""
        lib = self._lib
        host, port = _root_addr()
        preds = self._groups[0][:self._groups[0].index(self._sid)]
        probe_ms = max(min(int(self._hb_timeout_s * 500), 2000), 100)
        period = max(self._hb_timeout_s / 2.0, 0.1)
        seen_alive = False
        dead_rounds = 0
        while not self._ha_stop.wait(period):
            if self._registry is not None:
                return
            if any(lib.mxt_ps_probe(host.encode(), port + s, probe_ms) == 0
                   for s in preds):
                seen_alive = True
                dead_rounds = 0
                continue
            if not seen_alive:
                continue   # the launch: predecessors not up yet
            dead_rounds += 1
            if dead_rounds < 2:
                continue
            snap = None
            with self._ha_lock:
                raw = self._mb_sync
            if raw:
                try:
                    snap = json.loads(base64.b64decode(raw).decode())
                except Exception:  # noqa: BLE001 — a torn snapshot is worse
                    # than none: resume cold
                    log.exception("kvstore-server %d: mb_sync snapshot "
                                  "unreadable", self._sid)
            telemetry.counter("kv.replication.failovers").inc()
            telemetry.event("registry_failover", sid=self._sid,
                            predecessors=preds, with_snapshot=bool(snap))
            log.warning("kvstore-server %d: registry predecessor(s) %s dead — "
                        "resuming the membership registry here (%s snapshot)",
                        self._sid, preds, "with" if snap else "WITHOUT")
            # race-ok: one-shot rebind by the sole standby thread (runs only
            # after every predecessor died); concurrent readers see the old
            # None or the fully constructed registry, nothing in between
            self._registry = MembershipRegistry(self._num_workers, resume=snap)
            return

    def _handle_membership(self, cmd):
        """A worker's ``mb_*`` command. Only the registry's host serves
        it; elsewhere it is refused (False), so the sender moves on to the
        next candidate at once and never takes this server for the
        registry's host — but for ``mb_sync``, the registry's snapshot to
        its standbys. (The JAX package's server acknowledges and drops
        such a command: a worker whose command to a slow host timed out
        then stuck to a standby that never publishes a table.)"""
        if cmd.startswith(b"mb_sync:"):
            with self._ha_lock:
                self._mb_sync = cmd[8:].decode()
            return None
        reg = self._registry
        if reg is None:
            return False
        name, _, arg = cmd.decode().partition(":")
        if name in ("mb_join", "mb_hb"):
            # "<rank>[:<step>]": the step dates membership events
            rank, _, step = arg.partition(":")
            (reg.join if name == "mb_join" else reg.heartbeat)(
                int(rank), int(step) if step else None)
        elif name == "mb_leave":
            reg.leave(int(arg))
        elif name == "mb_done":
            reg.done(int(arg))
        elif name == "mb_pos":
            reg.set_pos(json.loads(base64.b64decode(arg).decode()))
        elif name in ("mb_srv_hb", "mb_srv_join"):
            reg.server_heartbeat(int(arg))
        elif name == "mb_srv_dead":
            # probe-confirmed; blocks this connection thread one deadline
            reg.server_suspect(int(arg))
        elif name == "mb_get":
            self._publish_vec(int(arg), encode_bytes_vec(
                json.dumps(reg.table()).encode()))

    def _publish_vec(self, key, vec):
        """Push ``vec`` into this server's own store under the reserved key
        ``key`` (a negative key always takes the overwrite path: no merge,
        no optimizer), before the command's response is sent, so the
        worker's pull finds it. The push holds ``_self_client_lock``, which
        the shutdown takes before destroying the client."""
        with self._self_client_lock:
            if self._self_client is None:
                c = self._lib.mxt_ps_client_create(b"127.0.0.1", self._port)
                if not c:
                    raise RuntimeError("cannot open a loopback client to port "
                                       "%d" % self._port)
                self._self_client = c
            rc = self._lib.mxt_ps_client_push(
                self._self_client, key,
                vec.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), vec.size)
        if rc != 0:
            raise RuntimeError("loopback publish push failed (key %d)" % key)

    def trace_stats(self):
        """The transport's per-rank RPC attribution: ``{rank: {"last_step",
        "last_mepoch", "pushes", "pulls", "barriers", "inits"}}`` — the
        worker step each rank's traffic last carried, and how much of it
        this shard handled. Unidentified clients (loopback, observers) are
        not counted."""
        cap = 7 * 256
        buf = (ctypes.c_double * cap)()
        n = self._lib.mxt_ps_server_trace_stats(self._handle, buf, cap)
        out = {}
        for i in range(0, max(n, 0), 7):
            rank, step, mepoch, pushes, pulls, barriers, inits = buf[i:i + 7]
            out[int(rank)] = {"last_step": int(step),
                              "last_mepoch": int(mepoch),
                              "pushes": int(pushes), "pulls": int(pulls),
                              "barriers": int(barriers), "inits": int(inits)}
        return out

    # ---- the optimizer -----------------------------------------------------
    def _set_optimizer(self, optimizer):
        """Install ``optimizer``. The slots survive: those of the updater it
        replaces (a re-sent, rescaled optimizer), else those restored or
        replicated before any optimizer existed."""
        updater = opt.get_updater(optimizer)
        with self._updater_lock:
            prev = self._updater
        if prev is not None and prev.states:
            updater.states = prev.states
            updater._on_host = set(prev._on_host)
        elif self._pending_states:
            updater.states = {k: opt._from_np(v)
                              for k, v in self._pending_states.items()}
            updater._on_host = set(updater.states)
            self._pending_states = None
        self._optimizer_obj = optimizer
        with self._updater_lock:
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
        """Health counters, the HA ones included."""
        with self._stats_lock:
            out = {"updates_applied": self._updates_applied,
                   "update_failures": self._update_failures,
                   "last_update_error": self._last_update_error,
                   "has_optimizer": self._updater is not None}
            out.update(self._ha_stats)
        return out

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
        # the HA threads hold clients into the transport: stop them first.
        # Every client this process holds into a server is closed before
        # the destroy below, which waits for the connections into this one
        # to close: servers stopping together never wait on each other
        self._ha_stop.set()
        self._repl_q.put(None)
        self._ckpt_q.put(None)
        for th in self._ha_threads:
            th.join(timeout=2)
        if self._registry is not None:
            self._registry.close()
        with self._repl_cv:
            held = list(self._repl_clients.values())
            self._repl_clients = {}
        held += list(self._reg_clients.values())
        self._reg_clients = {}
        for c in held:
            if c:
                self._lib.mxt_ps_client_destroy(c)
        with self._self_client_lock:
            if self._self_client is not None:
                self._lib.mxt_ps_client_destroy(self._self_client)
                self._self_client = None
        self._lib.mxt_ps_server_destroy(self._handle)
        stop.set()
        d.join()
        # race-ok: shutdown epilogue — the waiter thread exited before the
        # destroy above, so nothing else can observe this rebind
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
        # one write: the servers of a launcher share its stderr
        sys.stderr.flush()
        os.write(2, ("kvstore-server %s: stopped; %s; cuda initialized: %s\n"
                     % (os.environ.get("DMLC_SERVER_ID", "0"), server.stats(),
                        torch.cuda.is_initialized())).encode())
        sys.exit(0)
    if role == "scheduler":
        sys.exit(0)
