"""The port's elastic training (``mxnet_tpu_torch/elastic.py``, the
registry's worker half in ``kvstore_server.py``, the membership epoch in
``kvstore.py``) held against the JAX package's on the CPU: the registry's
worker scenarios fed to both packages' registries (formation, heartbeat
lapse, the rejoin of a live rank, the restart position, done), the
``NDArrayIter`` partitions and seeded reshuffles batch for batch against
the JAX iterator, stale-epoch pushes, pulls and barriers refused by a port
server, the ``kill_worker`` fault point, and the whole cycle under
``tools/launch.py --elastic``: a worker killed mid-epoch, the survivor
reconfigured, the relaunched worker rejoined, and both ending bitwise
equal on the shards a fresh iterator gives."""
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as J
import mxnet_tpu_torch as T
from mxnet_tpu import kvstore_server as jsrv
from mxnet_tpu_torch import kvstore_server as tsrv
from mxnet_tpu_torch.base import MXNetError

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_server_ha import MLP_FIT, _done_lines, _run_cluster  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# the registry's worker scenarios, in both packages
# ---------------------------------------------------------------------------


def _registry(srv, timeout=0.3):
    sent = []
    return srv.MembershipRegistry(2, heartbeat_timeout_s=timeout,
                                  broadcast=sent.append), sent


def _wait_epoch(reg, beat=None, limit=5.0):
    deadline = time.monotonic() + limit
    while reg.table()["epoch"] == 0 and time.monotonic() < deadline:
        if beat is not None:
            reg.heartbeat(beat)
        time.sleep(0.05)


def _formation(srv):
    reg, sent = _registry(srv)
    try:
        first = reg.join(0)
        t0 = reg.table()
        second = reg.join(1)
        return [first, t0["formed"], second, reg.table(), sent]
    finally:
        reg.close()


def _lapse(srv):
    reg, sent = _registry(srv, timeout=0.25)
    try:
        reg.join(0)
        reg.join(1)
        _wait_epoch(reg, beat=0)          # 0 beats, 1 lapses
        t = reg.table()
        reg.heartbeat(1)                  # a lapsed rank stays out
        return [t["epoch"], t["workers"], reg.table()["workers"], sent]
    finally:
        reg.close()


def _live_rejoin(srv):
    reg, sent = _registry(srv, timeout=60)
    try:
        reg.join(0)
        reg.join(1)
        reg.join(1)                       # its last incarnation died
        t = reg.table()
        return [t["epoch"], t["workers"], sent]
    finally:
        reg.close()


def _pos(srv):
    reg, sent = _registry(srv, timeout=60)
    try:
        reg.join(0)
        reg.join(1)
        reg.set_pos({"mepoch": 0, "epoch": 2, "nbatch": 5})
        before = reg.table()["pos"]
        reg.leave(1)                      # the bump makes the position stale
        t = reg.table()
        return [before, t["epoch"], t["pos"], sent]
    finally:
        reg.close()


def _done(srv):
    reg, sent = _registry(srv, timeout=0.25)
    try:
        reg.join(0)
        reg.join(1)
        reg.done(0)
        t = reg.table()
        deadline = time.monotonic() + 0.7
        while time.monotonic() < deadline:   # 1 beats: nothing may bump
            reg.heartbeat(1)
            time.sleep(0.05)
        quiet = [reg.table()["epoch"], list(sent)]
        _wait_epoch(reg)                  # 1 never reported done: it lapses
        return [t["done"], t["workers"], quiet, reg.table()["epoch"], sent]
    finally:
        reg.close()


SCENARIOS = {"formation": _formation, "lapse": _lapse,
             "live_rejoin": _live_rejoin, "pos": _pos, "done": _done}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_registry_worker_scenarios_match_jax(name):
    got = SCENARIOS[name](tsrv)
    assert got == SCENARIOS[name](jsrv)
    if name == "formation":
        assert got[:3] == [0, False, 0]
        assert got[3]["formed"] and got[3]["workers"] == [0, 1]
        assert got[3]["epoch"] == 0 and got[4] == []
    elif name == "lapse":
        assert got == [1, [0], [0], ["mepoch:1:1"]]
    elif name == "live_rejoin":
        assert got == [1, [0, 1], ["mepoch:1:2"]]
    elif name == "pos":
        assert got == [{"mepoch": 0, "epoch": 2, "nbatch": 5}, 1, None,
                       ["mepoch:1:1"]]
    else:
        assert got == [True, [1], [0, []], 1, ["mepoch:1:1"]]


# ---------------------------------------------------------------------------
# NDArrayIter partitions, against the JAX iterator
# ---------------------------------------------------------------------------


def _batches(it, n=None):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy().copy(), b.label[0].asnumpy().copy(),
                    b.pad))
        if n is not None and len(out) == n:
            break
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (xa, ya, pa), (xb, yb, pb) in zip(a, b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
        assert pa == pb


def _arrays(n=64, seed=3):
    rng = np.random.RandomState(seed)
    return rng.randn(n, 4).astype(np.float32), np.arange(n, dtype=np.float32)


@pytest.mark.parametrize("parts", [1, 2, 3])
@pytest.mark.parametrize("shuffle_seed", [None, 11], ids=["ordered", "seeded"])
def test_ndarrayiter_partitions_match_jax(parts, shuffle_seed):
    X, y = _arrays()
    kw = dict(batch_size=5, shuffle=shuffle_seed is not None,
              seed=shuffle_seed, num_parts=parts)
    whole = []
    for p in range(parts):
        got = _batches(T.io.NDArrayIter(X, y, part_index=p, **kw))
        _same(got, _batches(J.io.NDArrayIter(X, y, part_index=p, **kw)))
        whole += got
    if parts > 1 and shuffle_seed is None:
        # contiguous parts: together the first parts*(n//parts) rows
        n = (64 // parts) * parts
        seen = np.concatenate([x[:5 - pad] for x, _, pad in whole])
        np.testing.assert_array_equal(seen, X[:n])


def test_ndarrayiter_set_partition_gives_the_fresh_stream():
    X, y = _arrays()
    fresh = _batches(T.io.NDArrayIter(X, y, batch_size=8, num_parts=2,
                                      part_index=1))
    it = T.io.NDArrayIter(X, y, batch_size=8, num_parts=2, part_index=0)
    it.next()
    it.next()
    it.set_partition(2, 1)
    it.reset()
    _same(_batches(it), fresh)
    # the position protocol seeks within the new part
    it.set_partition(2, 1)
    it.load_state({"type": "NDArrayIter", "cursor": 8})
    _same(_batches(it), fresh[2:])
    jit = J.io.NDArrayIter(X, y, batch_size=8, num_parts=2, part_index=0)
    jit.set_partition(2, 1)
    jit.load_state({"type": "NDArrayIter", "cursor": 8})
    _same(_batches(jit), fresh[2:])


def test_ndarrayiter_seeded_shuffle_is_reproducible_across_reshards():
    X = np.arange(48, dtype=np.float32).reshape(48, 1)
    y = np.zeros(48, np.float32)
    kw = dict(batch_size=4, shuffle=True, seed=11)
    a = T.io.NDArrayIter(X, y, num_parts=2, part_index=0, **kw)
    b = T.io.NDArrayIter(X, y, num_parts=3, part_index=2, **kw)
    b.set_partition(2, 0)
    want = _batches(a)
    _same(_batches(b), want)
    jb = J.io.NDArrayIter(X, y, num_parts=3, part_index=2, **kw)
    jb.set_partition(2, 0)
    _same(_batches(jb), want)


def test_unseeded_shuffle_refuses_to_reshard_and_resize_passes_through():
    it = T.io.NDArrayIter(np.zeros((16, 2), np.float32),
                          np.zeros(16, np.float32), batch_size=4, shuffle=True)
    with pytest.raises(MXNetError, match="seed"):
        it.set_partition(2, 0)
    X, y = _arrays(32)
    resized = T.io.ResizeIter(T.io.NDArrayIter(X, y, batch_size=4), 3)
    resized.set_partition(2, 1)
    _same(_batches(resized),
          _batches(T.io.NDArrayIter(X, y, batch_size=4, num_parts=2,
                                    part_index=1), 3))


# ---------------------------------------------------------------------------
# stale-epoch traffic refused by a port server
# ---------------------------------------------------------------------------


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def one_server(monkeypatch):
    """A port server on a free port and the launcher's environment of one
    worker; stopped (by the test's store) and joined at the end."""
    port = _free_port()
    for k, v in {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(port),
                 "DMLC_NUM_WORKER": "1", "DMLC_NUM_SERVER": "1",
                 "DMLC_WORKER_ID": "0", "MXNET_KV_TIMEOUT_MS": "3000"}.items():
        monkeypatch.setenv(k, v)
    for k in ("MXNET_ELASTIC", "MXNET_KV_REPLICAS", "DMLC_PS_RECOVERY",
              "DMLC_ROLE", "DMLC_SERVER_ID"):
        monkeypatch.delenv(k, raising=False)
    server = tsrv.KVStoreServer(port=port, num_workers=1)
    t = threading.Thread(target=server.run, daemon=True)
    t.start()
    yield server
    t.join(timeout=30)
    assert not t.is_alive()


def test_stale_epoch_push_pull_and_barrier_are_refused(one_server):
    T.telemetry.reset()
    kv = T.kv.create("dist_sync")
    with T.cpu():
        kv.elastic_enable()
        kv.init(0, T.nd.ones((4,)))
        # the registry's command, sent directly: this worker is now stale
        assert kv._lib.mxt_ps_client_command(kv._clients[0], b"mepoch:5:1") == 0

        def rejected(op):
            return T.telemetry.counter("kv.membership.rejected", op=op).value

        with pytest.raises(T.kv.KVMembershipError) as e:
            kv._zpush(0, np.ones(4, np.float32))
        assert e.value.op == "push"
        with pytest.raises(T.kv.KVMembershipError) as e:
            kv._zpull(0, 4)
        assert e.value.op == "pull"
        with pytest.raises(T.kv.KVMembershipError):
            kv.barrier()
        assert (rejected("push"), rejected("pull"), rejected("barrier")) == \
            (1, 1, 1)
        # an engine push refused on a worker thread reaches the waiter as
        # the same class
        kv.push(0, T.nd.ones((4,)))
        with pytest.raises(T.kv.KVMembershipError):
            kv.wait_key(0)
        kv.set_membership_epoch(5)
        out = T.nd.zeros((4,))
        kv.pull(0, out=out)
        np.testing.assert_array_equal(out.asnumpy(), 1.0)  # nothing landed
        kv.push(0, T.nd.ones((4,)) * 3)
        kv.pull(0, out=out)
        np.testing.assert_array_equal(out.asnumpy(), 3.0)
        kv.barrier()
    kv._stop_servers()


def test_dropped_rpcs_are_retried_and_a_failed_update_is_counted(one_server):
    """The ``kv_push``/``kv_pull`` points fail one attempt each, which the
    store retries; ``server_updater`` fails one update, which the server
    counts, keeping the weight."""
    T.telemetry.reset()
    kv = T.kv.create("dist_sync")
    with T.cpu():
        kv.init(0, T.nd.ones((4,)))
        kv.set_optimizer(T.optimizer.SGD(learning_rate=1.0, rescale_grad=1.0))
        out = T.nd.zeros((4,))
        with T.fault.inject("kv_push:drop=1,times=1;kv_pull:drop=1,times=1"):
            kv.push(0, T.nd.ones((4,)))
            kv.pull(0, out=out)
        np.testing.assert_array_equal(out.asnumpy(), 0.0)   # 1 - 1 * 1
        assert T.telemetry.counter("kvstore.retries", op="push").value == 1
        assert T.telemetry.counter("kvstore.retries", op="pull").value == 1
        with T.fault.inject("server_updater:raise=1,times=1"):
            kv.push(0, T.nd.ones((4,)))
            kv.pull(0, out=out)
        np.testing.assert_array_equal(out.asnumpy(), 0.0)   # kept
        stats = kv.request_server_stats()
        assert list(stats.values())[0]["update_failures"] == 1, stats
        kv.barrier()
    kv._stop_servers()


# ---------------------------------------------------------------------------
# the kill_worker fault point
# ---------------------------------------------------------------------------

FAULT_SCRIPT = r"""
import os, sys
os.environ["MXNET_FAULT_SPEC"] = "kill_worker:rank=1,after=2"
from mxnet_tpu_torch import fault
for _ in range(5):
    fault.kill_worker(0)  # another rank: no hit
fault.kill_worker(1)
fault.kill_worker(1)
print("ALIVE"); sys.stdout.flush()
fault.kill_worker(1)      # the third hit of rank 1 fires
print("SURVIVED")
"""


def test_kill_worker_targets_by_rank_after_its_own_hits():
    env = {k: v for k, v in os.environ.items() if k != "MXNET_FAULT_SPEC"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", FAULT_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, (proc.stdout, proc.stderr)
    assert "ALIVE" in proc.stdout and "SURVIVED" not in proc.stdout


# ---------------------------------------------------------------------------
# the whole cycle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_type", ["dist_sync", "dist_sync_device"],
                         ids=["classic", "fused"])
def test_worker_kill_reconfigure_rejoin_end_to_end(kv_type, tmp_path):
    """Worker 1 is SIGKILLed at its 21st batch (mid-epoch 2 of 10, 8 per
    epoch): the survivor reconfigures (epoch bump, reshard, rollback) and
    trains alone, the launcher relaunches worker 1, it rejoins, and both
    end bitwise equal, each having run its last epoch on shard (2, rank) of
    the original arrays as a fresh iterator gives it. ``dist_sync_device``
    runs the fused hybrid step on the CPU."""
    rc, out, err = _run_cluster(MLP_FIT, 2, 1, {
        "MXNET_FAULT_SPEC": "kill_worker:rank=1,after=20,times=1",
        "MXNET_ELASTIC_HEARTBEAT_S": "0.5",
        "MXNET_ELASTIC_HEARTBEAT_TIMEOUT_S": "2",
        "MXNET_KV_SERVER_CKPT_DIR": str(tmp_path),
        "KV_TYPE": kv_type, "WAIT_FOR": "worker:1"},
        launch_args=("--elastic",))
    assert rc == 0, (out, err[-6000:])
    assert out.count("WORKER_OK") == 2, (out, err[-6000:])
    info = _done_lines(out)
    assert info[1]["recovered"] == "1" and info[0]["recovered"] == "0", info
    assert "elastic: reconfigured to membership epoch" in err
    assert "elastic: joined membership epoch" in err
    assert info[0]["sig"] == info[1]["sig"], info
    rng = np.random.RandomState(42)
    X = rng.randn(256, 10).astype(np.float32)
    for rank in (0, 1):
        shard = X[rank * 128:(rank + 1) * 128]
        want = [float(np.abs(shard[k * 16:(k + 1) * 16]).sum())
                for k in range(8)]
        got = [float(v) for v in info[rank]["last"].split(",")]
        assert got == want, (rank, got, want)
    stops = [l for l in err.splitlines() if l.startswith("kvstore-server")
             and "stopped" in l]
    assert len(stops) == 1 and stops[0].endswith("cuda initialized: False")
