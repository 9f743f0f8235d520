"""The port's parameter-server HA half (``mxnet_tpu_torch/kvstore_server.py``,
the worker side in ``kvstore.py``) held against the JAX package's on the
CPU: the server-group plan, the stats and bytes wire vectors decoded across
packages, the membership registry's server scenarios fed to both packages'
registries with the same events (the same epochs, maps, tables and
broadcasts; a snapshot of one resumed by the other), the server's
optimizer-slot checkpoints, the ``kill_server`` fault point, a replicated
cluster, and the whole cycle under ``tools/launch.py --elastic``: a
primary killed mid-training, its backup promoted, the workers moved to the
new server map, the dead slot relaunched from its checkpoint and back as a
backup, and the two workers ending bitwise equal."""
import base64
import ctypes
import json
import os
import pickle
import queue
import signal
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

import mxnet_tpu_torch as T
from mxnet_tpu import kvstore_server as jsrv
from mxnet_tpu_torch import kvstore_server as tsrv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port(n=1):
    """A port P with P..P+n-1 all free: server i listens on P+i, so a
    cluster of n servers needs the run (concurrent runs of these tests
    must not hand two clusters overlapping runs)."""
    for _ in range(100):
        socks = []
        try:
            s = socket.socket()
            socks.append(s)
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
            for i in range(1, n):
                t = socket.socket()
                socks.append(t)
                t.bind(("127.0.0.1", port + i))
            return port
        except OSError:
            continue
        finally:
            for t in socks:
                t.close()
    raise RuntimeError("no run of %d free ports" % n)


def _run_cluster(script, n_workers, n_servers, env_extra, timeout=240,
                 launch_args=()):
    """``tools/launch.py`` over ``python -c script`` in its own process
    group, killed past ``timeout``: (exit code, stdout, stderr)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("DMLC_")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["MXNET_DEFAULT_CONTEXT"] = "cpu"
    env.update(env_extra)
    cmd = [sys.executable, os.path.join(ROOT, "tools", "launch.py"),
           "-n", str(n_workers), "-s", str(n_servers),
           "--port", str(_free_port(n_servers)), *launch_args,
           sys.executable, "-c", script]
    proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError("cluster hung: %s %s" % (out, err[-4000:]))
    return proc.returncode, out, err


# ---------------------------------------------------------------------------
# the server-group plan
# ---------------------------------------------------------------------------


def _plan(srv, n, r):
    try:
        return srv.plan_server_groups(n, r)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("replicas", [-1, 0, 1, 2, 3])
def test_plan_server_groups_matches_jax(replicas):
    for n in range(1, 13):
        assert _plan(tsrv, n, replicas) == _plan(jsrv, n, replicas), n
    assert tsrv.plan_server_groups(4, 1) == [[0, 1], [2, 3]]
    assert tsrv.plan_server_groups(3, 0) == [[0], [1], [2]]
    with pytest.raises(ValueError, match="divisible"):
        tsrv.plan_server_groups(1, 1)
    with pytest.raises(ValueError, match=">= 0"):
        tsrv.plan_server_groups(4, -1)


# ---------------------------------------------------------------------------
# the wire vectors, across packages
# ---------------------------------------------------------------------------


def _full_stats():
    s = {"updates_applied": (1 << 30) + 7, "update_failures": 3,
         "has_optimizer": True}
    for i, f in enumerate(tsrv._STATS_COUNTER_FIELDS_HA):
        s[f] = (1 << 26) + i        # past float32's exact integers
    return s


@pytest.mark.parametrize("enc,dec", [(jsrv, tsrv), (tsrv, jsrv)],
                         ids=["jax_to_port", "port_to_jax"])
def test_stats_vec_decodes_across_packages(enc, dec):
    assert tsrv.STATS_VEC_LEN == jsrv.STATS_VEC_LEN
    assert tsrv._STATS_COUNTER_FIELDS_HA == jsrv._STATS_COUNTER_FIELDS_HA
    stats = _full_stats()
    vec = enc.encode_stats_vec(stats)
    assert vec.dtype == np.float32 and len(vec) == dec.STATS_VEC_LEN
    np.testing.assert_array_equal(vec, dec.encode_stats_vec(stats))
    assert dec.decode_stats_vec(vec) == stats
    # the pre-HA server's 5-entry prefix: the HA counters are absent
    old = dec.decode_stats_vec(vec[:5])
    assert old == {"updates_applied": (1 << 30) + 7, "update_failures": 3,
                   "has_optimizer": True}
    # a stats dict without the HA counters encodes them as zero
    zero = dec.decode_stats_vec(enc.encode_stats_vec(
        {"updates_applied": 1, "update_failures": 0, "has_optimizer": False}))
    assert all(zero[f] == 0 for f in tsrv._STATS_COUNTER_FIELDS_HA)


@pytest.mark.parametrize("enc,dec", [(jsrv, tsrv), (tsrv, jsrv)],
                         ids=["jax_to_port", "port_to_jax"])
def test_bytes_vec_decodes_across_packages(enc, dec):
    for payload in (b"", b"x", b'{"epoch": 3, "workers": [0, 2]}',
                    bytes(range(256))):
        vec = enc.encode_bytes_vec(payload)
        np.testing.assert_array_equal(vec, dec.encode_bytes_vec(payload))
        assert dec.decode_bytes_vec(vec) == payload
        padded = np.concatenate([vec, np.zeros(7, np.float32)])
        assert dec.decode_bytes_vec(padded) == payload
    torn = enc.encode_bytes_vec(b"hello")[:3]
    assert dec.decode_bytes_vec(torn) is None


# ---------------------------------------------------------------------------
# the registry's server scenarios, in both packages
# ---------------------------------------------------------------------------


def _ha_registry(srv, probe=lambda sid: False, resume=None, num_servers=4,
                 replicas=1):
    sent = []
    reg = srv.MembershipRegistry(1, heartbeat_timeout_s=60,
                                 broadcast=sent.append,
                                 num_servers=num_servers, replicas=replicas,
                                 probe=probe, resume=resume)
    return reg, sent


def _beat_all(reg, n=4):
    for sid in range(n):
        reg.server_heartbeat(sid)


def _table(reg):
    t = reg.table()
    t["steps"] = {int(k): v for k, v in t["steps"].items()}
    return t


def _promote(srv):
    reg, sent = _ha_registry(srv)
    try:
        reg.join(0)
        _beat_all(reg)
        quiet = list(sent)
        reg.server_suspect(2)          # group 1's primary; the probe agrees
        return [quiet, list(sent), _table(reg)]
    finally:
        reg.close()


def _veto(srv):
    reg, sent = _ha_registry(srv, probe=lambda sid: True)
    try:
        reg.join(0)
        _beat_all(reg)
        reg.server_suspect(2)
        return [list(sent), _table(reg)]
    finally:
        reg.close()


def _backup_loss(srv):
    reg, sent = _ha_registry(srv)
    try:
        reg.join(0)
        _beat_all(reg)
        reg.server_suspect(1)          # group 0's backup
        return [list(sent), _table(reg)]
    finally:
        reg.close()


def _sticky_rejoin(srv):
    reg, sent = _ha_registry(srv)
    trace = []
    try:
        reg.join(0)
        _beat_all(reg)
        reg.server_suspect(2)
        trace.append(_table(reg))
        reg.server_heartbeat(2)        # relaunched: back as a backup
        trace.append(_table(reg))
        reg.server_suspect(2)
        reg.server_suspect(3)          # group 1 lost every member
        trace.append(_table(reg))
        reg.server_heartbeat(3)        # the first rejoiner revives it
        trace.append(_table(reg))
        return [list(sent), trace]
    finally:
        reg.close()


SCENARIOS = {"promote": _promote, "probe_veto": _veto,
             "backup_loss": _backup_loss, "sticky_rejoin": _sticky_rejoin}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_registry_server_scenarios_match_jax(name):
    got = SCENARIOS[name](tsrv)
    assert got == SCENARIOS[name](jsrv)
    if name == "promote":
        quiet, sent, t = got
        assert quiet == []
        assert t["smap"] == [0, 3] and t["servers"] == [0, 1, 3]
        assert t["epoch"] == 1
        # the map reaches every server before any worker reads the epoch
        assert sent[0].startswith("smap:") and sent[1] == "mepoch:1:1"
        assert json.loads(sent[0][5:]) == {"smap": [0, 3], "alive": [0, 1, 3]}
    elif name == "probe_veto":
        sent, t = got
        assert sent == [] and t["smap"] == [0, 2] and t["epoch"] == 0
    elif name == "backup_loss":
        sent, t = got
        assert t["smap"] == [0, 2] and t["epoch"] == 0
        assert len(sent) == 1 and sent[0].startswith("smap:")
    else:
        sent, (promoted, rejoined, dead, revived) = got
        assert promoted["smap"] == [0, 3] and promoted["epoch"] == 1
        assert rejoined["smap"] == [0, 3] and rejoined["epoch"] == 1
        assert 2 in rejoined["servers"]
        assert dead["smap"] == [0, None] and dead["epoch"] == 1
        assert revived["smap"] == [0, 3] and revived["epoch"] == 2


@pytest.mark.parametrize("src,dst", [(jsrv, tsrv), (tsrv, jsrv)],
                         ids=["jax_to_port", "port_to_jax"])
def test_registry_snapshot_resumes_in_the_other_package(src, dst):
    reg, _ = _ha_registry(src)
    try:
        reg.join(0, step=17)
        _beat_all(reg)
        reg.server_suspect(2)          # epoch 1, smap [0, 3]
        snap = json.loads(json.dumps(reg.snapshot()))
    finally:
        reg.close()
    reg2, _ = _ha_registry(dst, resume=snap)
    try:
        t = _table(reg2)
        assert t["epoch"] == 1 and t["smap"] == [0, 3]
        assert t["workers"] == [0] and t["formed"]
        assert t["steps"] == {0: 17}
        assert t["servers"] == [0, 1, 3]
    finally:
        reg2.close()


@pytest.mark.parametrize("srv", [jsrv, tsrv], ids=["jax", "port"])
def test_registry_syncs_its_snapshot_to_the_standbys(srv):
    reg, sent = _ha_registry(srv)
    try:
        reg.join(0)
        _beat_all(reg)
        reg._sync_standbys()
        msgs = [m for m in sent if m.startswith("mb_sync:")]
        assert len(msgs) == 1
        snap = json.loads(base64.b64decode(msgs[0][len("mb_sync:"):]))
        assert snap["smap"] == [0, 2] and snap["formed"]
    finally:
        reg.close()
    reg, sent = _ha_registry(srv, num_servers=2, replicas=0)
    try:
        reg._sync_standbys()          # group 0 has no standby
        assert sent == []
    finally:
        reg.close()


# ---------------------------------------------------------------------------
# the server's optimizer-slot checkpoints (a server without a transport)
# ---------------------------------------------------------------------------


def _ckpt_shim(path, steps=4, pending=None):
    srv = object.__new__(tsrv.KVStoreServer)
    srv._sid = 0
    srv._ckpt_path = str(path)
    srv._ckpt_steps = steps
    srv._ckpt_count = 0
    srv._updater = None
    srv._updater_lock = threading.Lock()
    srv._optimizer_obj = None
    srv._pending_states = pending
    srv._ckpt_q = queue.Queue()
    srv._ha_stop = threading.Event()
    srv._stats_lock = threading.Lock()
    srv._ha_stats = dict.fromkeys(tsrv._STATS_COUNTER_FIELDS_HA, 0)
    return srv


def _write(srv):
    srv._ckpt_q.put(None)
    srv._ckpt_writer_loop()           # the queued blob, then the stop


def test_server_checkpoint_round_trip_warm_starts(tmp_path):
    T.telemetry.reset()
    path = tmp_path / "kv_server_0.optstate"
    states = {3: np.arange(6, dtype=np.float32),
              7: (np.float64(0.5), np.ones(2, np.float32))}
    srv = _ckpt_shim(path, steps=4, pending=states)
    for _ in range(7):                # one write, at the fourth round
        srv._ckpt_tick_main()
    assert srv._ckpt_q.qsize() == 1
    _write(srv)
    assert path.exists() and srv._ha_stats["ckpt_writes"] == 1
    assert srv._ha_stats["ckpt_bytes"] > 0
    assert T.telemetry.counter("kv.server_ckpt.writes").value == 1
    back = _ckpt_shim(path)
    back._restore_checkpoint()
    assert back._ha_stats["ckpt_restores"] == 1
    assert set(back._pending_states) == {3, 7}
    np.testing.assert_array_equal(back._pending_states[3], states[3])
    assert back._pending_states[7][0] == 0.5
    np.testing.assert_array_equal(back._pending_states[7][1], states[7][1])


def test_server_checkpoint_installs_its_optimizer_and_slots(tmp_path):
    """A checkpoint with an optimizer: the relaunched server's updater
    holds the slots, which the next update moves on from."""
    path = tmp_path / "kv_server_0.optstate"
    sgd = T.optimizer.SGD(learning_rate=0.5, momentum=0.9, rescale_grad=1.0)
    srv = _ckpt_shim(path, steps=1)
    srv._set_optimizer(sgd)
    w = T.nd.array(np.ones(4, np.float32), ctx=T.cpu())
    srv._updater(2, T.nd.array(np.full(4, 2.0, np.float32), ctx=T.cpu()), w)
    srv._ckpt_tick_main()
    _write(srv)
    back = _ckpt_shim(path)
    back._restore_checkpoint()
    assert back._pending_states is None and back._updater is not None
    np.testing.assert_array_equal(back._updater.states[2].asnumpy(),
                                  srv._updater.states[2].asnumpy())
    assert back._optimizer_obj.momentum == 0.9


def test_server_checkpoint_skips_stateless_and_is_off_by_default(tmp_path):
    srv = _ckpt_shim(tmp_path / "x.optstate", steps=2, pending=None)
    for _ in range(8):                # plain SGD: no slots to keep
        srv._ckpt_tick_main()
    assert srv._ckpt_q.qsize() == 0
    srv = _ckpt_shim(tmp_path / "x.optstate", steps=0,
                     pending={0: np.ones(2, np.float32)})
    for _ in range(64):
        srv._ckpt_tick_main()
    assert srv._ckpt_q.qsize() == 0 and srv._ckpt_count == 0


def test_server_checkpoint_corrupt_or_missing_is_a_cold_start(tmp_path):
    path = tmp_path / "kv_server_0.optstate"
    srv = _ckpt_shim(path, pending={0: np.ones(4, np.float32)})
    srv._ckpt_q.put(pickle.dumps({"optimizer": None,
                                  "states": srv._pending_states,
                                  "updates_applied": 4}))
    _write(srv)
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF        # the CRC must catch a flipped byte
    path.write_bytes(bytes(raw))
    T.telemetry.reset()
    back = _ckpt_shim(path)
    back._restore_checkpoint()        # never raises
    assert back._pending_states is None
    assert back._ha_stats["ckpt_restores"] == 0
    assert T.telemetry.counter("kv.server_ckpt.errors").value == 1
    T.telemetry.reset()
    missing = _ckpt_shim(tmp_path / "never_written.optstate")
    missing._restore_checkpoint()
    assert missing._pending_states is None
    assert T.telemetry.counter("kv.server_ckpt.errors").value == 0


def test_stats_penalty_window_skips_a_dead_server():
    import time

    T.telemetry.reset()
    kv = object.__new__(T.kv.KVStoreDist)
    kv._stats_skip = {}
    addr = "127.0.0.1:19091"
    assert not kv._stats_skipped(addr)
    kv._stats_unreachable(addr, timeout_ms=150)
    assert kv._stats_skipped(addr)
    assert T.telemetry.counter("kv.stats_unreachable", server=addr).value == 2
    assert not kv._stats_skipped("127.0.0.1:19092")
    time.sleep(0.2)
    assert not kv._stats_skipped(addr)


# ---------------------------------------------------------------------------
# the kill_server fault point
# ---------------------------------------------------------------------------

FAULT_SCRIPT = r"""
import os, sys
os.environ["MXNET_FAULT_SPEC"] = "kill_server:server_id=1"
from mxnet_tpu_torch import fault
fault.kill_server(0)      # another target: no hit, no kill
fault.kill_server(3)
print("ALIVE"); sys.stdout.flush()
fault.kill_server(1)
print("SURVIVED")
"""


def test_kill_server_targets_by_server_id():
    env = {k: v for k, v in os.environ.items() if k != "MXNET_FAULT_SPEC"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", FAULT_SCRIPT], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -signal.SIGKILL, (proc.stdout, proc.stderr)
    assert "ALIVE" in proc.stdout and "SURVIVED" not in proc.stdout
    # the same spec in-process: a rule aimed elsewhere counts no hit
    with T.fault.inject("kill_server:server_id=1,after=5") as rules:
        T.fault.kill_server(0)
        T.fault.kill_server(2)
        assert rules[0]["hits"] == 0


# ---------------------------------------------------------------------------
# registry commands at a server that does not host the registry
# ---------------------------------------------------------------------------


def _server_shim(registry=None):
    """The command path of a server of group 0 (no transport of its own)."""
    srv = object.__new__(tsrv.KVStoreServer)
    srv._sid = 1
    srv._registry = registry
    srv._ha_lock = threading.Lock()
    srv._mb_sync = None
    return srv


@pytest.fixture
def group0():
    """Two raw transports standing for group 0's servers: 0 hosts the
    registry and answers its commands after ``delay[0]`` seconds; 1 is a
    standby (the port's command handler on a server with no registry)."""
    from mxnet_tpu_torch import _native
    lib = _native.load()
    delay = [0.0]

    def slow_host(ptr, n):
        import time
        time.sleep(delay[0])
        return 0

    standby = _server_shim()
    handlers = [_native.COMMAND_FN(slow_host),
                _native.COMMAND_FN(standby._command)]
    servers, clients = [], []
    port = _free_port(2)
    try:
        for i, h in enumerate(handlers):
            s = lib.mxt_ps_server_create(port + i, 1, 1)
            assert s
            servers.append(s)
            lib.mxt_ps_server_set_command_handler(
                s, ctypes.cast(h, ctypes.c_void_p))
            c = lib.mxt_ps_client_create(b"127.0.0.1", port + i)
            assert c
            clients.append(c)
        kv = object.__new__(T.kv.KVStoreDist)
        kv._lib, kv._rank, kv._ha = lib, 0, True
        kv._groups, kv._registry_sid = [[0, 1]], 0
        kv._clients = clients
        yield lib, kv, standby, delay
    finally:
        for c in clients:
            lib.mxt_ps_client_destroy(c)
        for s in servers:
            lib.mxt_ps_server_destroy(s)


def test_a_standby_refuses_registry_commands_and_acknowledges_the_rest(group0):
    lib, kv, standby, _ = group0
    c = kv._clients[1]
    for cmd in (b"mb_get:-5", b"mb_hb:0:3", b"mb_srv_hb:3", b"mb_srv_dead:2"):
        assert lib.mxt_ps_client_probe(c, cmd, 2000) != 0, cmd
    assert lib.mxt_ps_client_probe(c, b"mb_sync:c25hcA==", 2000) == 0
    assert standby._mb_sync == "c25hcA=="
    assert lib.mxt_ps_client_probe(c, b"ping", 2000) == 0


def test_a_slow_registry_host_keeps_the_workers_commands(group0):
    """A command to the registry's host that outlives its deadline must not
    move the worker to a standby: a standby never publishes a table, so
    every later fetch would time out there (an elastic fit's reconfigure
    then raised "membership registry unreachable")."""
    _, kv, _, delay = group0
    delay[0] = 0.6
    assert not kv.registry_command("mb_srv_dead:2", timeout_ms=200)
    assert kv._registry_sid == 0
    delay[0] = 0.0
    assert kv.registry_command("mb_hb:0:1", timeout_ms=2000)
    assert kv._registry_sid == 0
    # a worker that took the standby for the host finds the host again
    kv._registry_sid = 1
    assert kv.registry_command("mb_hb:0:2", timeout_ms=2000)
    assert kv._registry_sid == 0


def test_a_standby_that_resumed_the_registry_takes_its_commands(group0):
    _, kv, standby, delay = group0
    beats = []

    class Resumed:
        def heartbeat(self, rank, step=None):
            beats.append((rank, step))

    delay[0] = 0.6                     # the host wedged
    standby._registry = Resumed()
    assert kv.registry_command("mb_hb:0:7", timeout_ms=200)
    assert kv._registry_sid == 1 and beats == [(0, 7)]
    delay[0] = 0.0
    assert kv.registry_command("mb_hb:0:8", timeout_ms=2000)
    assert kv._registry_sid == 1 and beats[-1] == (0, 8)


# ---------------------------------------------------------------------------
# clusters under tools/launch.py
# ---------------------------------------------------------------------------

WORKER_GROUPS = r"""
import numpy as np
import mxnet_tpu_torch as mx

kv = mx.kv.create("dist_sync")
assert kv._ngroups == 2 and kv._smap == [0, 2], (kv._ngroups, kv._smap)
for k in range(5):                      # keys go to groups, to the primary
    kv.init(k, mx.nd.ones((3,)) * (k + 1))
out = mx.nd.zeros((3,))
for k in range(5):
    kv.pull(k, out=out)
    assert np.allclose(out.asnumpy(), k + 1), (k, out.asnumpy())
kv.push(2, mx.nd.ones((3,)) * 5)        # no optimizer: the push is stored
kv.pull(2, out=out)
assert np.allclose(out.asnumpy(), 5.0), out.asnumpy()
# the primary forwards each applied round to its backup from a thread of
# its own (at most one round behind): wait for that before counting
import time
deadline = time.time() + 30.0
while True:
    stats = kv.request_server_stats()
    if (len(stats) == 4 and all(s is not None for s in stats.values())
            and all("repl_forwards" in s for s in stats.values())
            and all(s.get("repl_lag_rounds", 0) == 0 for s in stats.values())
            and sum(s["repl_forwards"] for s in stats.values()) >= 1):
        break
    assert time.time() < deadline, ("replication did not catch up", stats)
    time.sleep(0.05)
assert len(stats) == 4 and all(s is not None for s in stats.values()), stats
assert all("repl_forwards" in s for s in stats.values()), stats
assert sum(s["repl_forwards"] for s in stats.values()) >= 1, stats
assert sum(s["repl_acks"] for s in stats.values()) >= 1, stats
assert sum(s["repl_failures"] for s in stats.values()) == 0, stats
kv.barrier()
kv._stop_servers()
print("WORKER_OK")
"""


def test_replicated_groups_serve_and_report_stats():
    rc, out, err = _run_cluster(WORKER_GROUPS, 1, 4,
                                {"MXNET_KV_REPLICAS": "1"})
    assert rc == 0, (out, err[-4000:])
    assert "WORKER_OK" in out, (out, err[-4000:])
    lines = [l for l in err.splitlines() if l.startswith("kvstore-server")
             and "stopped" in l]
    assert len(lines) == 4 and all(l.endswith("cuda initialized: False")
                                   for l in lines), lines


# the MLP fit both the HA and the elastic cycle run; rank 0 holds its
# batch-end until the relaunched process is back, so the cycle completes
# inside the fit however long the relaunch takes
MLP_FIT = r"""
import json
import os
import time

# the kill rule is the first incarnation's: a relaunch must not re-kill
if os.environ.get("DMLC_PS_RECOVERY"):
    os.environ.pop("MXNET_FAULT_SPEC", None)

import numpy as np
import mxnet_tpu_torch as mx

rng = np.random.RandomState(42)
X = rng.randn(256, 10).astype(np.float32)
w_true = rng.randn(10, 1).astype(np.float32)
y = (X @ w_true > 0).astype(np.float32).reshape(-1)
np.random.seed(42)

kv = mx.kv.create(os.environ.get("KV_TYPE", "dist_sync"))
rank, nw = kv.rank, kv.num_workers
it = mx.io.NDArrayIter(X, y, batch_size=16, shuffle=False, num_parts=nw,
                       part_index=rank)
net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=8, name="fc1")
net = mx.sym.Activation(net, act_type="relu")
net = mx.sym.FullyConnected(net, num_hidden=2, name="fc2")
net = mx.sym.SoftmaxOutput(net, name="softmax")
mod = mx.mod.Module(net, context=mx.cpu())
WAIT_FOR = os.environ["WAIT_FOR"]       # "server:2" or "worker:1"
stream, held = [], []


def back(table):
    kind, who = WAIT_FOR.split(":")
    return int(who) in table["servers" if kind == "server" else "workers"]


def record(param):
    b = param.locals["data_batch"]
    stream.append((param.epoch, float(np.abs(b.data[0].asnumpy()).sum())))
    if rank != 0 or held or kv.membership_epoch < 1:
        return
    deadline = time.time() + 120
    while time.time() < deadline:
        raw = kv.registry_fetch("mb_get")
        if raw and back(json.loads(raw.decode())):
            held.append(time.time())
            return
        time.sleep(0.1)
    raise SystemExit("the relaunched process never came back")


NUM_EPOCH = 10
mod.fit(it, num_epoch=NUM_EPOCH, kvstore=kv, optimizer="sgd",
        optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
        initializer=mx.init.Xavier(rnd_type="gaussian", magnitude=2.0),
        eval_metric="acc", force_init=True, batch_end_callback=record)
arg, _ = mod.get_params()
sig = float(sum(float(np.abs(v.asnumpy()).sum()) for v in arg.values()))
last = [c for e, c in stream if e == NUM_EPOCH - 1][-8:]
os.write(1, ("DONE rank=%d recovered=%s sig=%r smap=%s last=%s\n"
             % (rank, os.environ.get("DMLC_PS_RECOVERY", "0"), sig,
                ",".join(str(s) for s in kv._smap),
                ",".join(repr(c) for c in last))).encode())
kv.barrier()
if rank == 0:
    kv._stop_servers()
print("WORKER_OK", rank)
"""


def _done_lines(out):
    info = {}
    for line in out.splitlines():
        if line.startswith("DONE "):
            fields = dict(f.split("=", 1) for f in line.split()[1:])
            info[int(fields["rank"])] = fields
    return info


def test_server_kill_promote_rejoin_end_to_end(tmp_path):
    """Server 2, group 1's primary, is SIGKILLed after 40 applied updates
    (mid-epoch 2): the registry promotes backup 3 and bumps the epoch, the
    workers reconfigure onto the map [0, 3] and finish bitwise equal; the
    launcher relaunches server 2, which restores its optimizer slots from
    its checkpoint and rejoins as a backup. Every server, the relaunched
    one too, stops without having touched CUDA."""
    rc, out, err = _run_cluster(
        MLP_FIT, 2, 4, {
            "MXNET_FAULT_SPEC": "kill_server:server_id=2,after=40,times=1",
            "MXNET_KV_REPLICAS": "1",
            "MXNET_KV_SERVER_CKPT_STEPS": "8",
            "MXNET_KV_SERVER_CKPT_DIR": str(tmp_path / "ckpt"),
            "MXNET_ELASTIC_HEARTBEAT_S": "0.5",
            # ten missed beats before a process counts as dead: under the
            # whole suite's load a live worker or server can miss four
            "MXNET_ELASTIC_HEARTBEAT_TIMEOUT_S": "5",
            "WAIT_FOR": "server:2"}, launch_args=("--elastic",))
    assert rc == 0, (out, err[-6000:])
    assert out.count("WORKER_OK") == 2, (out, err[-6000:])
    info = _done_lines(out)
    assert sorted(info) == [0, 1], out
    assert info[0]["smap"] == info[1]["smap"] == "0,3", info
    assert info[0]["sig"] == info[1]["sig"], info
    for event in ("PROMOTED to primary", "adopting server map",
                  "relaunching server 2", "optimizer-state checkpoint",
                  "restored optimizer state", "rejoined as a backup"):
        assert event in err, (event, err[-6000:])
    stops = [l for l in err.splitlines()
             if l.startswith("kvstore-server") and "stopped" in l]
    # the killed incarnation writes nothing; the relaunched server 2 does
    assert sorted(l.split(":")[0] for l in stops) == [
        "kvstore-server %d" % i for i in range(4)], stops
    assert "'ckpt_restores': 1" in next(l for l in stops
                                        if l.startswith("kvstore-server 2"))
    assert all(l.endswith("cuda initialized: False") for l in stops), stops
