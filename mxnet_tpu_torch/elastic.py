"""Elastic training: a worker's membership session (counterpart of
``mxnet_tpu/elastic.py``).

The servers own the membership (``kvstore_server.MembershipRegistry``, on
the first server of group 0). Once a job runs elastic every push, pull,
init and barrier carries the worker's membership epoch (``ps.cc``
``MsgHeader.mepoch``), and a request from a departed membership is refused
with :class:`~.kvstore.KVMembershipError`: nothing of a dead or stale
worker lands.

:class:`ElasticSession` is the worker's half. It joins the registry
(``mb_join``), heartbeats it on a thread, and owns the two recoveries the
fit loop drives:

* :meth:`ElasticSession.reconfigure` — a survivor hit a
  ``KVMembershipError`` (a worker or a server was lost, or a worker
  joined). It drains the engine under the old epoch, adopts the registry's
  server map and epoch, reshards the data over the new membership
  (``set_partition``), rolls back to the guard's last snapshot, and on the
  lowest surviving rank re-seeds the servers' weights from it (a direct
  overwrite: no merge, no optimizer) and publishes the restart position.
* :meth:`ElasticSession.join` — a worker relaunched by ``tools/launch.py
  --elastic`` (``DMLC_PS_RECOVERY=1``) waits for that position, adopts the
  epoch and its shard, pulls the parameters and enters the loop where the
  survivors restart.

On the fused path both the rollback and the joiner's pull write into the
tensors the gradient CUDA graph captured (``Module.set_params`` and the
executor group's arrays, copied in place at the next step).

Variables: ``MXNET_ELASTIC`` turns it on (``launch.py --elastic`` sets it
for every process), ``MXNET_ELASTIC_HEARTBEAT_S`` and
``MXNET_ELASTIC_HEARTBEAT_TIMEOUT_S`` pace failure detection,
``MXNET_ELASTIC_JOIN_TIMEOUT_S`` bounds a joiner's wait,
``MXNET_ELASTIC_MAX_RESTARTS`` (the launcher's) caps relaunches.
"""
from __future__ import annotations

import base64
import json
import logging
import pickle
import threading
import time

from . import telemetry
from .base import MXNetError, env_bool, env_float

__all__ = ["ElasticSession", "enabled", "prepare"]


def enabled():
    """Whether this process trains elastic (``MXNET_ELASTIC``)."""
    return env_bool("MXNET_ELASTIC")


def prepare(kvstore, logger=None):
    """``fit``'s ``kvstore`` for an elastic job: ``(kvstore, session or
    None)``. A ``dist*`` type string is made into the store here (the
    session must put the servers in elastic mode before the optimizer
    reaches them); a store that is not a parameter-server worker trains
    without a session, logged."""
    from . import kvstore as kvs

    logger = logger or logging.getLogger(__name__)
    if isinstance(kvstore, str) and "dist" in kvstore:
        kvstore = kvs.create(kvstore)
    if isinstance(kvstore, kvs.KVStoreDist):
        session = ElasticSession(kvstore, logger=logger)
        session.start()
        return kvstore, session
    logger.warning("MXNET_ELASTIC is set but kvstore %r is not a distributed "
                   "PS store — training continues without elasticity", kvstore)
    return kvstore, None


class ElasticSession:
    """One worker's membership session (see the module docstring)."""

    def __init__(self, kv, logger=None):
        self._kv = kv
        self.rank = kv.rank
        self.logger = logger or logging.getLogger(__name__)
        self._hb_interval = env_float("MXNET_ELASTIC_HEARTBEAT_S", 1.0)
        self._join_timeout = env_float("MXNET_ELASTIC_JOIN_TIMEOUT_S", 300.0)
        self.joining = bool(kv.is_recovery)
        # (num_workers, rank) under the current membership: the data
        # partition follows it
        self.effective = (kv.num_workers, kv.rank)
        self._stop = threading.Event()
        self._hb_thread = None
        self._closed = False

    # ---- lifecycle ---------------------------------------------------------
    def start(self):
        """Put the servers in elastic mode, join the registry and start
        heartbeating (once). An unreachable registry raises: a worker never
        trains on without one."""
        if self._hb_thread is not None:
            return
        self._kv.elastic_enable()
        if not self._kv.registry_command(
                "mb_join:%d:%d" % (self.rank, self._kv.step_id)):
            raise MXNetError("elastic: membership registry (server 0) did not "
                             "acknowledge the join — is the cluster up?")
        self._hb_thread = threading.Thread(target=self._hb_loop, daemon=True,
                                           name="mxnet-elastic-heartbeat")
        self._hb_thread.start()

    def _hb_loop(self):
        while not self._stop.wait(self._hb_interval):
            # the beat carries the step: the registry dates events with it
            if not self._kv.registry_command(
                    "mb_hb:%d:%d" % (self.rank, self._kv.step_id)):
                # the registry reads the missing beat as a lapse, which is
                # what an unreachable worker is
                telemetry.counter("kv.membership.heartbeat_failures").inc()

    def close(self, done=True):
        """Stop heartbeating; ``done=True`` also reports the end of
        training (the registry stops watching this rank, and a worker
        relaunched late exits instead of waiting to join)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if done:
            self._kv.registry_command("mb_done:%d" % self.rank)
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)

    # ---- the registry's table -------------------------------------------------
    def sync(self, timeout_s=None):
        """The membership table, fetched again until ``timeout_s`` (ten
        heartbeats by default); raises when the registry stays silent."""
        deadline = time.monotonic() + (timeout_s if timeout_s is not None
                                       else self._hb_interval * 10)
        while True:
            raw = self._kv.registry_fetch("mb_get")
            if raw:
                try:
                    return json.loads(raw.decode())
                except ValueError:
                    pass   # a torn publish: fetch again
            if time.monotonic() > deadline:
                raise MXNetError("elastic: membership registry unreachable "
                                 "(no table within the deadline)")
            time.sleep(min(self._hb_interval / 2.0, 0.2))

    def _shard_of(self, table):
        workers = table["workers"]
        if self.rank not in workers:
            return None
        return (len(workers), workers.index(self.rank))

    # ---- the survivor ------------------------------------------------------------
    def reconfigure(self, module, train_data, guard):
        """Recover from a ``KVMembershipError`` (see the module docstring).
        Returns ``(epoch, nbatch, iter_restored)`` as ``guard.rollback``
        does; fit resumes its inner loop there."""
        from .kvstore import KVMembershipError

        kv = self._kv
        if guard is None or guard.last_snapshot is None:
            raise MXNetError(
                "elastic: membership changed but no guard snapshot exists to "
                "roll back to (fit enables a rollback guard in elastic mode — "
                "was the guard disabled?)")
        guard.suspend_watchdog()
        # 1. drain under the old epoch: every in-flight push completed or
        # was refused; twice, so an error recorded during the first drain
        # does not reach the next membership's traffic
        for _ in range(2):
            try:
                kv._engine.wait_all()
            except KVMembershipError:
                pass   # the event being recovered from
        # 2. the registry's membership; rejoin when it evicted this worker
        # (a stall outlived the timeout). After a dead server, wait for an
        # epoch past ours: the old one routes to the dead server
        server_loss = kv.consume_server_loss()
        hb_timeout = env_float("MXNET_ELASTIC_HEARTBEAT_TIMEOUT_S", 5.0)
        srv_deadline = time.monotonic() + max(30.0, hb_timeout * 6)
        rejoins = 0
        while True:
            table = self.sync()
            shard = self._shard_of(table)
            if shard is None:
                rejoins += 1
                if rejoins > 10:
                    raise MXNetError("elastic: could not rejoin the "
                                     "membership after eviction")
                self.logger.warning("elastic: registry evicted this worker "
                                    "(rank %d) — rejoining", self.rank)
                kv.registry_command("mb_join:%d:%d" % (self.rank, kv.step_id))
                continue
            if server_loss and int(table["epoch"]) <= kv.membership_epoch:
                if time.monotonic() > srv_deadline:
                    raise MXNetError(
                        "elastic: a server is unreachable but the registry "
                        "never promoted a backup (no epoch bump within the "
                        "deadline) — is the whole group down?")
                time.sleep(min(self._hb_interval / 2.0, 0.2))
                continue
            break
        epoch = int(table["epoch"])
        # the map before the epoch, as the registry broadcasts them
        kv.adopt_server_map(table.get("smap") or [])
        kv.set_membership_epoch(epoch)
        new_nw, new_rank = shard
        old_nw, old_rank = self.effective
        # 3. reshard; the rollback below seeks the new shard to the
        # snapshot's batch
        if (new_nw, new_rank) != (old_nw, old_rank):
            set_part = getattr(train_data, "set_partition", None)
            if set_part is None:
                self.logger.warning(
                    "elastic: %s has no set_partition — continuing on the "
                    "old shard (duplicate/missing samples until the next "
                    "restart)", type(train_data).__name__)
            else:
                set_part(new_nw, new_rank)
                telemetry.event("reshard", num_workers=new_nw, rank=new_rank,
                                epoch=epoch)
        # race-ok: atomic tuple rebind on the restart path; stats readers
        # tolerate sampling the previous membership for one tick
        self.effective = (new_nw, new_rank)
        # 4. every survivor rolls back to the same snapshot (BSP lockstep,
        # one snapshot cadence)
        r_epoch, r_nbatch, iter_restored = guard.rollback(module, train_data)
        # 5. the gradients are now summed over new_nw workers
        self._rescale_optimizer(module, old_nw, new_nw, resend=new_rank == 0)
        # 6. the coordinator makes the servers match the snapshot and says
        # where training restarts
        if new_rank == 0:
            self._reinit_server_params(module)
            self._publish_pos(epoch, r_epoch, r_nbatch,
                              guard.last_snapshot.iter_state)
        telemetry.event("elastic_reconfigured", epoch=epoch,
                        num_workers=new_nw, rank=new_rank,
                        resume_epoch=r_epoch, resume_nbatch=r_nbatch,
                        step_id=kv.step_id)
        self.logger.warning(
            "elastic: reconfigured to membership epoch %d (%d worker(s), this "
            "rank shard %d/%d) — resuming at epoch %d batch %d",
            epoch, new_nw, new_rank, new_nw, r_epoch, r_nbatch)
        return r_epoch, r_nbatch, iter_restored

    def _rescale_optimizer(self, module, old_nw, new_nw, resend):
        """Keep the update's scale when the summed batch changes; the
        coordinator re-sends the optimizer (the servers keep its slots)."""
        opt = getattr(module, "_optimizer", None)
        if opt is None or old_nw == new_nw or not old_nw or not new_nw:
            return
        opt.rescale_grad = opt.rescale_grad * float(old_nw) / float(new_nw)
        if resend and getattr(module, "_update_on_kvstore", False):
            self._kv._send_command_to_servers(0, pickle.dumps(opt))
            self.logger.warning(
                "elastic: optimizer rescaled for %d->%d workers and re-sent "
                "to the servers (server-side per-key slots are preserved "
                "across the resend)", old_nw, new_nw)

    def _reinit_server_params(self, module):
        """Overwrite every parameter key on the servers with the module's
        (rolled-back) parameters."""
        names = module._exec_group.param_names
        arg, _ = module.get_params()
        for idx, name in enumerate(names):
            self._kv._zinit(idx, arg[name].asnumpy())
        self.logger.info("elastic: re-seeded %d server keys from the rollback "
                         "snapshot", len(names))

    def _publish_pos(self, mepoch, epoch, nbatch, iter_state):
        payload = json.dumps({"mepoch": mepoch, "epoch": epoch,
                              "nbatch": nbatch,
                              "iter_state": iter_state}).encode()
        self._kv.registry_command(b"mb_pos:" + base64.b64encode(payload))

    # ---- the joiner -----------------------------------------------------------
    def join(self, module, train_data):
        """A relaunched worker's entry (see the module docstring): returns
        ``(begin_epoch, resume_state)`` for fit, or None when the registry
        says training already finished."""
        kv = self._kv
        deadline = time.monotonic() + self._join_timeout
        while True:
            table = self.sync()
            if table.get("done"):
                self.logger.info("elastic: training already finished — "
                                 "nothing to rejoin")
                return None
            pos = table.get("pos")
            shard = self._shard_of(table)
            if pos is not None and shard is not None and \
                    int(pos.get("mepoch", -1)) == int(table["epoch"]):
                break
            if time.monotonic() > deadline:
                raise MXNetError(
                    "elastic: join timed out waiting for the survivors' "
                    "restart position (MXNET_ELASTIC_JOIN_TIMEOUT_S)")
            time.sleep(min(self._hb_interval / 2.0, 0.2))
        epoch = int(table["epoch"])
        kv.adopt_server_map(table.get("smap") or [])
        kv.set_membership_epoch(epoch)
        new_nw, new_rank = shard
        old_nw = self.effective[0]
        self.effective = (new_nw, new_rank)
        set_part = getattr(train_data, "set_partition", None)
        if set_part is not None:
            set_part(new_nw, new_rank)
            telemetry.event("reshard", num_workers=new_nw, rank=new_rank,
                            epoch=epoch)
        # the coordinator re-seeded the servers before it published: this
        # pull is its snapshot
        self._pull_params(module)
        self._rescale_optimizer(module, old_nw, new_nw, resend=False)
        telemetry.event("worker_rejoined", epoch=epoch, num_workers=new_nw,
                        rank=new_rank, resume_epoch=pos["epoch"],
                        resume_nbatch=pos["nbatch"], step_id=kv.step_id)
        self.logger.warning(
            "elastic: joined membership epoch %d as shard %d/%d — entering "
            "at epoch %d batch %d", epoch, new_rank, new_nw, pos["epoch"],
            pos["nbatch"])
        return int(pos["epoch"]), {"nbatch": int(pos["nbatch"]),
                                   "iter_state": pos.get("iter_state")}

    def _pull_params(self, module):
        """The servers' parameters into the executor group, then into the
        module's host copies (the fused path copies those in place into
        its captured tensors at the next step)."""
        group = module._exec_group
        for idx, arrs in enumerate(group.param_arrays):
            self._kv.pull(idx, arrs, priority=-idx)
        group.get_params(module._arg_params, module._aux_params)
        module._params_dirty = False
        fused = getattr(module, "_fused", None)
        if fused is not None:
            fused.invalidate()
