"""The port's cluster observability (``mxnet_tpu_torch/kvstore.py``'s
cluster-stats publisher, the servers' per-rank traces) held against the
JAX package's on the CPU: straggler attribution on the same snapshots, a
raw port server attributing RPCs to rank and step while keeping
diagnostic traffic out of the training counts, the persistent telemetry
slots, the stall dump's membership metrics and the rank label on events,
and two CPU clusters: one worker's snapshot and trace round trip, and two
workers whose ``cluster_stats()`` holds both ranks and names the one that
sleeps in its data path."""
import ctypes
import json
import os
import sys
import time

import numpy as np
import pytest

import mxnet_tpu as J
import mxnet_tpu_torch as T
from mxnet_tpu_torch import _native
from mxnet_tpu_torch.kvstore_server import decode_bytes_vec, encode_bytes_vec

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_elastic import _free_port  # noqa: E402
from test_torch_server_ha import _run_cluster  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_telemetry():
    T.telemetry.reset()
    yield
    T.telemetry.disable()
    T.telemetry.reset()
    T.telemetry.set_rank(None)


# ---------------------------------------------------------------------------
# straggler attribution, in both packages
# ---------------------------------------------------------------------------


def _snap(rank, steps=10, data_wait=0.0, compute=0.1, kv_sync=0.0,
          guard_s=0.0, ts=None):
    per_step = data_wait + compute + kv_sync + guard_s
    return {"rank": rank, "ts": ts if ts is not None else time.time(),
            "window": {"steps": steps, "step_time": per_step * steps,
                       "data_wait": data_wait * steps,
                       "compute": compute * steps,
                       "kv_sync": kv_sync * steps, "guard": guard_s * steps}}


NOW = 1.0e9

CASES = {
    # BSP equalizes the raw wall: rank 2 is named off its self time
    "bsp_equalized": ({0: _snap(0, compute=0.05, kv_sync=0.45, ts=NOW),
                       1: _snap(1, compute=0.05, kv_sync=0.45, ts=NOW),
                       2: _snap(2, data_wait=0.4, compute=0.05, kv_sync=0.05,
                                ts=NOW)}, {}),
    "balanced": ({r: _snap(r, compute=0.1, kv_sync=0.02, ts=NOW)
                  for r in range(4)}, {}),
    "one_rank": ({0: _snap(0, compute=1.0, ts=NOW)}, {}),
    "stale": ({0: _snap(0, compute=0.01, ts=NOW),
               1: _snap(1, compute=1.0, ts=NOW - 120)}, {"max_age_s": 30.0}),
    "fresh": ({0: _snap(0, compute=0.01, ts=NOW),
               1: _snap(1, compute=1.0, ts=NOW)}, {"max_age_s": 30.0}),
    "empty_and_missing": ({0: _snap(0, compute=0.01, ts=NOW), 1: None,
                           2: _snap(2, steps=0, ts=NOW),
                           3: _snap(3, compute=0.5, ts=NOW)}, {}),
    "guard_stage": ({0: _snap(0, compute=0.02, ts=NOW),
                     1: _snap(1, compute=0.02, guard_s=0.3, ts=NOW),
                     2: _snap(2, compute=0.03, ts=NOW)}, {}),
    "under_factor": ({0: _snap(0, compute=0.1, ts=NOW),
                      1: _snap(1, compute=0.19, ts=NOW)}, {}),
}
EXPECTED = {"bsp_equalized": (2, "data_wait"), "balanced": None,
            "one_rank": None, "stale": None, "fresh": (1, "compute"),
            "empty_and_missing": (3, "compute"), "guard_stage": (1, "guard"),
            "under_factor": None}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pick_straggler_matches_jax(name):
    snaps, kw = CASES[name]
    got = T.kv._pick_straggler(snaps, 2.0, now=NOW, **kw)
    assert got == J.kv._pick_straggler(snaps, 2.0, now=NOW, **kw)
    want = EXPECTED[name]
    assert (None if got is None else (got["rank"], got["stage"])) == want
    if got is not None:
        assert got["ratio"] >= 2.0


def test_publisher_window_holds_the_last_completed_steps():
    """C17: between steps the port republishes the last populated window
    where the JAX package publishes an empty one; with steps, both give
    the same delta, compute net of the sync."""
    def cum(steps, t):
        return {"steps": steps, "step_time": t, "data_wait": t / 2,
                "compute": t / 2, "kv_sync": t / 4, "kv_overlap": 0.0,
                "guard": 0.0}

    seq = [cum(0, 0.0), cum(2, 1.0), cum(2, 1.0), cum(2, 1.0), cum(3, 1.6)]
    port = T.kv._ClusterStatsPublisher(None, 1.0, 2.0)
    jax = J.kv._ClusterStatsPublisher(None, 1.0, 2.0)
    got = [port._window(c) for c in seq]
    want = [jax._window(c) for c in seq]
    assert got[1] == want[1] and got[4] == want[4]
    assert got[1]["steps"] == 2 and got[1]["compute"] == 0.25
    assert got[2] == got[3] == got[1]          # held until the next step
    assert want[2]["steps"] == want[3]["steps"] == 0   # the JAX package's
    assert got[4]["steps"] == 1


def test_telemetry_slots_are_disjoint_from_the_diagnostic_keys():
    assert T.kv.TELEMETRY_KEY_BASE == J.kv.TELEMETRY_KEY_BASE
    for r in (0, 1, 5, 255):
        assert T.kv.telemetry_slot(r) == J.kv.telemetry_slot(r)
    assert T.kv.telemetry_slot(0) == T.kv.TELEMETRY_KEY_BASE
    assert T.kv.telemetry_slot(5) == T.kv.TELEMETRY_KEY_BASE - 5
    assert T.kv.telemetry_slot(0) < -(1 << 19) < -2
    # a worker's reserved keys wrap before the observer band
    kv = object.__new__(T.kv.KVStoreDist)
    kv._rank, kv._nw, kv._reserved_seq = 1, 2, 0
    keys = [kv._fresh_reserved_key() for _ in range(300000)]
    assert max(keys) <= -2 and min(keys) > -(1 << 19)


def test_stall_dump_covers_the_membership_metrics_and_events_carry_rank():
    assert "kv." in T.guard.STATE_SUMMARY_PREFIXES
    T.telemetry.enable()
    T.telemetry.gauge("kv.membership.epoch").set(3)
    T.telemetry.counter("kv.membership.rejected", op="push").inc(2)
    T.telemetry.gauge("kv.straggler.rank").set(1)
    T.telemetry.gauge("kvstore.dead_nodes").set(0)
    state = T.telemetry.state_summary(T.guard.STATE_SUMMARY_PREFIXES)
    assert state["kv.membership.epoch"] == 3
    assert state["kv.membership.rejected{op=push}"] == 2
    assert state["kv.straggler.rank"] == 1
    T.telemetry.set_rank(4)
    assert T.telemetry.event("epoch_start", epoch=0)["rank"] == 4
    # an explicit rank (the registry naming a lost worker) wins
    assert T.telemetry.event("worker_lost", rank=9)["rank"] == 9


# ---------------------------------------------------------------------------
# a raw port server: the trace identity on the wire
# ---------------------------------------------------------------------------


@pytest.fixture
def raw_server():
    lib = _native.load()
    port = _free_port()
    srv = lib.mxt_ps_server_create(port, 1, 1)
    assert srv
    client = lib.mxt_ps_client_create(b"127.0.0.1", port)
    assert client
    yield lib, srv, client, port
    lib.mxt_ps_client_destroy(client)
    lib.mxt_ps_server_destroy(srv)


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _push(lib, client, key, arr, init=False):
    arr = np.ascontiguousarray(arr, np.float32)
    fn = lib.mxt_ps_client_init if init else lib.mxt_ps_client_push
    return fn(client, key, _ptr(arr), arr.size)


def _pull(lib, client, key, cap=1024):
    buf = np.zeros(cap, np.float32)
    return lib.mxt_ps_client_pull(client, key, _ptr(buf), cap), buf


def _trace(lib, srv):
    buf = (ctypes.c_double * 70)()
    n = lib.mxt_ps_server_trace_stats(srv, buf, 70)
    return [int(x) for x in buf[:n]]


def test_server_attributes_rpcs_to_rank_and_step(raw_server):
    lib, srv, client, _ = raw_server
    lib.mxt_ps_client_set_identity(client, 3)
    step = (5 << 32) | 42
    lib.mxt_ps_client_set_step(client, step)
    assert _push(lib, client, 0, np.ones(4)) == 0
    assert _pull(lib, client, 0)[0] == 4
    rank, last_step, _, pushes, pulls, barriers, inits = _trace(lib, srv)
    assert (rank, last_step, pushes, pulls) == (3, step, 1, 1)
    lib.mxt_ps_client_set_step(client, step + 1)
    assert _push(lib, client, 0, np.ones(4)) == 0
    t = _trace(lib, srv)
    assert t[1] == step + 1 and t[3] == 2


def test_unidentified_and_diagnostic_traffic_stay_out_of_the_counts(raw_server):
    lib, srv, client, port = raw_server
    assert _push(lib, client, 0, np.ones(2)) == 0      # no identity: unseen
    assert lib.mxt_ps_probe(b"127.0.0.1", port, 2000) == 0
    assert _trace(lib, srv) == []
    lib.mxt_ps_client_set_identity(client, 0)
    # a telemetry-slot write records the step, not a push, pull or init
    assert _push(lib, client, T.kv.telemetry_slot(0), np.ones(3), init=True) == 0
    t = _trace(lib, srv)
    assert len(t) == 7 and (t[3], t[4], t[6]) == (0, 0, 0)


def test_persistent_telemetry_slot_survives_pulls(raw_server):
    lib, _, client, _ = raw_server
    payload = json.dumps({"rank": 0, "x": 1}).encode()
    vec = encode_bytes_vec(payload)
    key = T.kv.telemetry_slot(0)
    assert _push(lib, client, key, vec, init=True) == 0
    for _ in range(3):
        got, buf = _pull(lib, client, key)
        assert got == vec.size and decode_bytes_vec(buf[:got]) == payload
    vec2 = encode_bytes_vec(json.dumps({"rank": 0, "x": 2}).encode())
    assert _push(lib, client, key, vec2, init=True) == 0
    got, buf = _pull(lib, client, key)
    assert json.loads(decode_bytes_vec(buf[:got]).decode())["x"] == 2
    # other reserved keys are read once
    assert _push(lib, client, -7, np.ones(4)) == 0
    assert _pull(lib, client, -7)[0] == 4
    assert _pull(lib, client, -7)[0] == 0


# ---------------------------------------------------------------------------
# clusters
# ---------------------------------------------------------------------------

WORKER_CLUSTER_STATS = r"""
import json
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry

kv = mx.kv.create("dist_sync")
kv.set_step((3 << 32) | 9)
kv.init(0, mx.nd.ones((4,)))
telemetry.enable()
telemetry.histogram("fit.step_time_seconds").observe(0.2)
telemetry.histogram("fit.data_wait_seconds").observe(0.15)
snap = kv.publish_cluster_snapshot()
assert snap is not None and snap["rank"] == 0, snap
stats = kv.cluster_stats()
mine = stats["workers"][0]
assert mine is not None and mine["step_id"] == (3 << 32) | 9, stats
assert mine["cum"]["steps"] == 1 and abs(mine["cum"]["data_wait"] - 0.15) < 1e-9
srv = kv.request_server_stats()
assert list(srv.values())[0]["updates_applied"] == 0, srv
trace = kv.request_server_trace()
row = next(iter(trace.values()))["per_rank"]["0"]
assert row["last_step"] == (3 << 32) | 9 and row["pushes"] >= 1, row
kv._stop_servers()
print("CLUSTER_STATS_OK", json.dumps(row))
"""


def test_cluster_stats_round_trip_on_one_worker():
    rc, out, err = _run_cluster(WORKER_CLUSTER_STATS, 1, 1, {})
    assert rc == 0, (out, err[-4000:])
    assert "CLUSTER_STATS_OK" in out, (out, err[-4000:])


# rank 1 sleeps in its data path once WARMUP batches went by: the fit loop
# times that as its data wait, and rank 0's publisher names it
STRAGGLER_FIT = r"""
import json
import os
import time

import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import telemetry

rng = np.random.RandomState(7)
X = rng.randn(256, 10).astype(np.float32)
y = (X.sum(axis=1) > 0).astype(np.float32)
np.random.seed(7)
kv = mx.kv.create("dist_sync")
rank, nw = kv.rank, kv.num_workers
WARMUP = 4


class PacedIter(mx.io.NDArrayIter):
    served = 0

    def next(self):
        PacedIter.served += 1
        time.sleep(0.3 if rank == 1 and PacedIter.served > WARMUP else 0.01)
        return super().next()


it = PacedIter(X, y, batch_size=16, num_parts=nw, part_index=rank)
net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4, name="fc1")
mod = mx.mod.Module(mx.sym.SoftmaxOutput(net, name="softmax"),
                    context=mx.cpu())
probe = {}


def watch(param):
    if rank != 0 or "named" in probe:
        return
    evs = [e for e in telemetry.events("kv.straggler")
           if e.get("stage") == "data_wait"]
    if not evs:
        return
    probe["named"] = dict(evs[-1])
    probe["at"] = param.epoch * 8 + param.nbatch
    for _ in range(40):
        stats = kv.cluster_stats()
        if ((stats["workers"].get(1) or {}).get("window") or {}).get("steps"):
            probe["stats"] = stats
            break
        time.sleep(0.1)


mod.fit(it, num_epoch=3, kvstore=kv, optimizer="sgd",
        optimizer_params={"learning_rate": 0.05}, eval_metric="acc",
        batch_end_callback=watch)
if rank == 0:
    trace = kv.request_server_trace()
    per_rank = next(iter(trace.values()))["per_rank"]
    stats = probe.get("stats") or {}
    os.write(1, ("PROBE %s\n" % json.dumps({
        "named": probe.get("named"), "at": probe.get("at"),
        "ranks": sorted((stats.get("workers") or {}).keys()),
        "held": sorted(r for r, s in (stats.get("workers") or {}).items() if s),
        "window1": ((stats.get("workers") or {}).get(1) or {}).get("window"),
        "straggler": stats.get("straggler"), "trace": per_rank})).encode())
kv.barrier()
if rank == 0:
    kv._stop_servers()
print("WORKER_OK", rank)
"""


def test_two_workers_cluster_stats_name_the_sleeping_rank():
    """``cluster_stats()`` on rank 0 holds both ranks' snapshots; rank 1,
    slowed by 0.3 s per batch in its data path after 4 batches, is named
    (stage ``data_wait``) within 5 steps of the delay, its window
    dominated by that stage; the server's trace attributes pushes and
    pulls to both ranks and to the last step (epoch 2, batch 7)."""
    rc, out, err = _run_cluster(STRAGGLER_FIT, 2, 1, {
        "MXNET_CLUSTER_STATS_INTERVAL_S": "0.15",
        "MXNET_STRAGGLER_FACTOR": "2.0"})
    assert rc == 0, (out, err[-4000:])
    assert out.count("WORKER_OK") == 2, (out, err[-4000:])
    probe = json.loads(next(l for l in out.splitlines()
                            if l.startswith("PROBE "))[6:])
    assert probe["named"]["rank"] == 1, probe
    assert probe["named"]["stage"] == "data_wait", probe
    assert probe["at"] <= 4 + 5, probe
    assert probe["held"] == [0, 1], probe
    w1 = probe["window1"]
    assert w1["data_wait"] > w1["compute"] and w1["data_wait"] > w1["guard"]
    last = (2 << 32) | 7
    for r in ("0", "1"):
        row = probe["trace"][r]
        assert row["pushes"] > 0 and row["pulls"] > 0, probe["trace"]
        assert row["last_step"] == last, probe["trace"]
