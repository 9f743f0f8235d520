"""The port's cluster tools, ``mxnet_tpu_torch/tools/trace_merge.py`` and
``mxnet_tpu_torch/tools/mxtop.py``, against the repo's own
``tools/trace_merge.py`` and ``tools/mxtop.py``, on the CPU.

The same synthetic per-rank profiler traces and telemetry sinks, with
known clock offsets, merge to the same JSON through both copies (the
repo's run as a subprocess: it is standard library only), and the offsets
come back; mxtop's frame rendered by both tools from the same decoded
snapshots is the same text. One port ``dist_sync`` cluster on the CPU (2
workers, 1 server, per-rank telemetry sinks and profiler traces) then
covers the live path: each worker's sink holds one ``bsp_sync`` per step
with the step ids ``kv.step_id`` stamped, ``mxtop --once`` run while it
trains shows both ranks with their step times, and the merged trace has
the two worker lanes, aligned, and the ``cluster`` lane of the server.
"""
import importlib.util
import json
import os
import random
import signal
import socket
import subprocess
import sys

import pytest

from mxnet_tpu_torch.tools import mxtop as tmxtop
from mxnet_tpu_torch.tools import trace_merge as ttm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TRACE_MERGE = os.path.join(ROOT, "tools", "trace_merge.py")


def _jax_mxtop():
    spec = importlib.util.spec_from_file_location(
        "_jax_mxtop", os.path.join(ROOT, "tools", "mxtop.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# synthetic per-rank inputs with known clock offsets
# ---------------------------------------------------------------------------

OFFSETS = {0: 0.0, 1: 2.5, 2: -1.25}   # each rank's clock minus rank 0's
T0 = 1.7e9


def _write_inputs(d, serving=False):
    rng = random.Random(5)
    for rank, off in OFFSETS.items():
        jit = [rng.uniform(-2e-4, 2e-4) for _ in range(12)]
        lines = []
        for step in range(8):
            t = T0 + 0.1 * step + off + jit[step]
            lines.append({"ts": t, "type": "event", "event": "bsp_sync",
                          "rank": rank, "step_id": step})
        for seq in (1, 2):
            lines.append({"ts": T0 + 0.4 * seq + off + jit[8 + seq],
                          "type": "event", "event": "barrier", "rank": rank,
                          "seq": seq, "step_id": seq * 4})
        lines.append({"ts": T0 + 0.05 + off, "type": "event",
                      "event": "epoch_start", "rank": rank, "epoch": 0})
        lines.append({"ts": T0 + 0.33 + off, "type": "event",
                      "event": "compile", "rank": rank,
                      "program": "fused.grad_step", "seconds": 0.2})
        if rank == 0:
            # the subject's lane: rank 2's
            lines.append({"ts": T0 + 0.5, "type": "event",
                          "event": "worker_lost", "rank": 2, "epoch": 2})
        if rank == 2:
            lines.append({"ts": T0 + 0.6 + off, "type": "event",
                          "event": "kv.straggler", "rank": 2, "stage":
                          "data_wait", "straggler": 2})
        lines.append({"ts": T0 + 0.9 + off, "type": "snapshot",
                      "rank": rank, "counters": {}})
        with open(os.path.join(d, "telemetry.%d.jsonl" % rank), "w") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
            f.write('{"ts": 17, "type": "ev')     # a torn last line
        us = lambda t: (t + off) * 1e6   # noqa: E731
        events = [
            {"name": "process_name", "cat": "__metadata", "ph": "M",
             "pid": 4000 + rank, "tid": 0,
             "args": {"name": "rank %d" % rank, "rank": rank}},
            {"name": "fused.step", "cat": "executor", "ph": "X",
             "ts": us(T0 + 0.11), "dur": 5e4, "pid": 4000 + rank, "tid": 7},
            {"name": "kv.barrier", "cat": "kvstore", "ph": "X",
             "ts": us(T0 + 0.79), "dur": 1e4 + 37 * rank, "pid": 4000 + rank,
             "tid": 7, "args": {"seq": 3, "step_id": 12}},
            {"name": "compile[fused.step]", "cat": "compile", "ph": "X",
             "ts": us(T0 + 0.01), "dur": 2e4, "pid": 4000 + rank,
             "tid": 99},
        ]
        with open(os.path.join(d, "profile.%d.json" % (4000 + rank)),
                  "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    # a rank-less server sink: its annotations go on the cluster lane (a
    # record with a rank field would name the file's rank)
    with open(os.path.join(d, "telemetry.s0.jsonl"), "w") as f:
        for rec in ({"ts": T0 + 0.03, "type": "event",
                     "event": "mepoch_adopted", "epoch": 1},
                    {"ts": T0 + 0.5, "type": "event",
                     "event": "elastic_reconfigured", "epoch": 2}):
            f.write(json.dumps(rec) + "\n")
    if serving:
        with open(os.path.join(d, "serving.jsonl"), "w") as f:
            for i, state in enumerate(("submitted", "admitted", "decoding",
                                       "preempted", "readmitted", "replayed",
                                       "finished")):
                f.write(json.dumps({
                    "ts": T0 + 0.01 * i, "type": "event",
                    "event": "serving.request", "engine": "e0",
                    "request_id": "r1", "state": state,
                    "preemptions": 1}) + "\n")
            f.write(json.dumps({"ts": T0, "type": "event",
                                "event": "serving.step_timeline",
                                "engine": "e0", "occupancy": 3,
                                "queue": 1}) + "\n")


@pytest.mark.parametrize("serving", [False, True],
                         ids=["cluster", "serving_lanes"])
def test_trace_merge_matches_the_repo_tool(tmp_path, serving):
    d = tmp_path / "run"
    d.mkdir()
    _write_inputs(str(d), serving)
    extra = ["--serving-lanes"] if serving else []
    outs = {}
    for name, cmd in (
            ("jax", [sys.executable, JAX_TRACE_MERGE]),
            ("port", [sys.executable, "-m",
                      "mxnet_tpu_torch.tools.trace_merge"])):
        path = str(tmp_path / ("%s.json" % name))
        p = subprocess.run(cmd + ["-o", path, "--validate"] + extra + [str(d)],
                           cwd=ROOT, capture_output=True, text=True,
                           timeout=120,
                           env=dict(os.environ, PYTHONPATH=ROOT))
        assert p.returncode == 0, (p.stdout, p.stderr)
        with open(path) as f:
            outs[name] = json.load(f)
        outs[name + "_stdout"] = p.stdout.replace(path, "OUT")
    assert outs["port"] == outs["jax"]
    assert outs["port_stdout"] == outs["jax_stdout"]
    trace = outs["port"]
    assert ttm.lane_pids(trace) == [0, 1, 2]
    assert ttm.validate_trace(trace) == []
    names = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert "cluster" in names.values()
    offs = trace["otherData"]["clock_offsets"]
    for rank, off in OFFSETS.items():
        for f in ("telemetry.%d.jsonl" % rank, "profile.%d.json" % (4000 + rank)):
            o = offs[f]
            if rank == 0:
                assert o["offset_s"] == 0.0
                continue
            assert abs(o["offset_s"] + off) < 5e-4, (f, o)
            assert o["residual_s"] < 5e-4 and o["sync_points"] >= 1, (f, o)
    if serving:
        assert list(ttm.serving_request_lanes(trace).values()) == ["req r1"]


def test_trace_merge_in_process_api():
    ins = [{"path": "a", "kind": "jsonl", "rank": 0, "events": [],
            "sync": {("bsp_sync", 1): 10.0, ("bsp_sync", 2): 11.0},
            "annotations": [], "serving": [], "serving_steps": []},
           {"path": "b", "kind": "jsonl", "rank": 1, "events": [],
            "sync": {("bsp_sync", 1): 13.0, ("bsp_sync", 2): 14.002},
            "annotations": [], "serving": [], "serving_steps": []}]
    off = ttm.estimate_offsets(ins)
    assert off["a"]["offset_s"] == 0.0
    assert off["b"]["offset_s"] == pytest.approx(-3.0, abs=3e-3)
    assert off["b"]["sync_points"] == 2


# ---------------------------------------------------------------------------
# mxtop's frames
# ---------------------------------------------------------------------------

NOW = 1.7e9 + 100.0


def _snap(rank, step_s, data_wait, age, hits=None):
    comp = {"programs": 3, "count": 4, "seconds": 12.5, "recompiles": rank}
    if rank:
        comp["last_recompile"] = {"program": "fused.step", "cause": "batch"}
    if hits is not None:
        comp["cache_hits"], comp["cache_misses"] = hits, 1
    return {"rank": rank, "ts": NOW - age, "step_id": (2 << 32) | 5,
            "mepoch": 1 + rank, "imgs_per_sec": 123.4 * (rank + 1),
            "queues": {"engine": 2, "feed": rank},
            "counters": {"rejected": 0, "rpc_failures": 0},
            "compile": comp,
            "window": {"steps": 8, "step_time": 8 * step_s,
                       "data_wait": data_wait, "compute": 8 * step_s * 0.5,
                       "kv_sync": 0.1, "kv_overlap": 0.05, "guard": 0.01}}


@pytest.mark.parametrize("case", ["plain", "straggler", "missing"])
def test_mxtop_frame_matches_the_repo_tool(case):
    J = _jax_mxtop()
    snaps = {0: _snap(0, 0.2, 0.1, 0.5, hits=7), 1: _snap(1, 0.21, 0.2, 1.0)}
    if case == "straggler":
        snaps[1] = _snap(1, 0.9, 6.5, 0.3)
    if case == "missing":
        snaps[2] = None
    membership = {"workers": [0, 1], "done": False}
    for factor in (2.0, 1.5):
        got = tmxtop.render(snaps, membership, factor, now=NOW)
        want = J.render(snaps, membership, factor, now=NOW)
        assert got == want
    lines = got.splitlines()
    assert lines[2].split()[:2] == ["0", "e2/b5"]
    assert "7/8" in lines[2]
    if case == "straggler":
        assert "STRAGGLER: rank 1" in lines[0]


def test_mxtop_serving_panel_matches_the_repo_tool():
    J = _jax_mxtop()
    stats = {"engine": "e0", "steps": 40, "completed": 9, "failed": 0,
             "preemptions": 2, "active": 3, "waiting": 1,
             "kv_blocks_used": 10, "kv_blocks_total": 64,
             "kv_blocks_frag_slots": 5, "tokens_per_sec": 88.5,
             "ttft_p50_s": 0.012, "ttft_p99_s": 0.04,
             "latency_p50_s": 0.3, "latency_p99_s": None,
             "slo": {"goodput": 0.9, "ttft_target_ms": 200,
                     "tpot_target_ms": 50, "burning": True,
                     "attainment": {"ttft": 1.0, "tpot": 0.8}},
             "prefix": {"enabled": True, "lookups": 4, "hits": 2,
                        "hit_rate": 0.5, "hit_blocks": 3,
                        "shared_blocks": 1, "kv_bytes_saved": 4096},
             "spec": {"enabled": True, "k": 3, "draft": "self",
                      "proposed_tokens": 30, "accepted_tokens": 21,
                      "acceptance_rate": 0.7},
             "resilience": {"shed": 1}, "supervisor": {"restarts": 0,
                                                       "max_restarts": 3},
             "phases": {"prefill": {"p50_s": 0.01, "p99_s": 0.02,
                                    "total_s": 0.5}}}
    assert tmxtop.render_serving(stats) == J.render_serving(stats)


# ---------------------------------------------------------------------------
# one port cluster: bsp_sync, mxtop --once while it trains, the merge
# ---------------------------------------------------------------------------

CLUSTER = r"""
import json
import os
import subprocess
import sys
import time

out_dir = os.environ["TOOLS_OUT"]
# every process of the job (the server too) traces into one directory
os.environ["MXNET_PROFILER_FILENAME"] = os.path.join(
    out_dir, "trace", "profile.%d.json" % os.getpid())

import numpy as np
import mxnet_tpu_torch as mx

rng = np.random.RandomState(3)
X = rng.randn(128, 10).astype(np.float32)
y = (X.sum(axis=1) > 0).astype(np.float32)
kv = mx.kv.create("dist_sync")
rank = kv.rank


class Paced(mx.io.NDArrayIter):
    # steps that span the publisher's interval, so its windows fill
    def next(self):
        time.sleep(0.1)
        return super().next()


it = Paced(X, y, batch_size=16, num_parts=kv.num_workers, part_index=rank)
net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=8, name="fc1")
net = mx.sym.FullyConnected(mx.sym.Activation(net, act_type="relu"),
                            num_hidden=2, name="fc2")
mod = mx.mod.Module(mx.sym.SoftmaxOutput(net, name="softmax"),
                    context=mx.cpu())
stamped, frames = [], []


def batch_end(param):
    stamped.append(kv.step_id)
    if rank or frames or (param.epoch, param.nbatch) != (1, 1):
        return
    deadline = time.time() + 20
    while time.time() < deadline:
        ws = kv.cluster_stats()["workers"]
        if all(((ws.get(r) or {}).get("window") or {}).get("steps")
               for r in (0, 1)):
            break
        time.sleep(0.1)
    # an observer of the plane: none of this job's sinks or roles
    env = {k: v for k, v in os.environ.items()
           if k not in ("MXNET_TELEMETRY_FILE", "MXNET_PROFILER_AUTOSTART",
                        "MXNET_PROFILER_FILENAME", "DMLC_ROLE")}
    p = subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.tools.mxtop",
                        "--once"], env=env, capture_output=True, text=True,
                       timeout=120)
    frames.append({"rc": p.returncode, "out": p.stdout,
                   "err": p.stderr[-2000:]})


mod.fit(it, num_epoch=2, kvstore=kv, optimizer="sgd",
        optimizer_params={"learning_rate": 0.05},
        batch_end_callback=batch_end)
with open(os.path.join(out_dir, "done-%d.json" % rank), "w") as f:
    json.dump({"rank": rank, "stamped": stamped, "frames": frames,
               "cache_dir": os.environ.get("MXNET_COMPILE_CACHE_DIR",
                                           "UNSET")}, f)
kv.barrier()
if rank == 0:
    kv._stop_servers()
print("WORKER_OK", rank)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_port_cluster_bsp_sync_mxtop_and_merged_trace(tmp_path):
    out = tmp_path / "out"
    (out / "trace").mkdir(parents=True)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DMLC_") and k != "MXNET_COMPILE_CACHE_DIR"}
    env.update({
        "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", ""),
        "MXNET_DEFAULT_CONTEXT": "cpu", "OMP_NUM_THREADS": "1",
        "TOOLS_OUT": str(out),
        "MXNET_TELEMETRY_FILE": str(out / "trace" / "telemetry.{rank}.jsonl"),
        "MXNET_PROFILER_AUTOSTART": "1",
        "MXNET_CLUSTER_STATS_INTERVAL_S": "0.15"})
    cmd = [sys.executable, os.path.join(ROOT, "tools", "launch.py"), "-n",
           "2", "-s", "1", "--port", str(_free_port()), sys.executable, "-c",
           CLUSTER]
    proc = subprocess.Popen(cmd, env=env, cwd=str(tmp_path),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        stdout, stderr = proc.communicate()
        raise AssertionError("cluster hung: %s %s" % (stdout, stderr[-4000:]))
    assert proc.returncode == 0, (stdout, stderr[-4000:])
    assert stdout.count("WORKER_OK") == 2, (stdout, stderr[-4000:])
    done = {}
    for r in (0, 1):
        with open(out / ("done-%d.json" % r)) as f:
            done[r] = json.load(f)
        # a launch without --elastic leaves the compile cache alone
        assert done[r]["cache_dir"] == "UNSET"

    # one bsp_sync per step, with the step ids kv.step_id stamped
    for r in (0, 1):
        with open(out / "trace" / ("telemetry.%d.jsonl" % r)) as f:
            recs = [json.loads(l) for l in f if l.strip()]
        ids = [e["step_id"] for e in recs if e.get("event") == "bsp_sync"]
        assert all(e.get("rank") == r for e in recs
                   if e.get("event") == "bsp_sync")
        assert len(ids) == len(set(ids)), ids
        assert set(ids) == set(done[r]["stamped"]), (ids, done[r]["stamped"])
        assert len(ids) == 8     # 2 epochs x 4 batches

    # mxtop --once while the cluster trained: both ranks, their step times
    frame = done[0]["frames"][0]
    assert frame["rc"] == 0, frame
    rows = {l.split()[0]: l.split() for l in frame["out"].splitlines()
            if l[:1].isdigit()}
    assert sorted(rows) == ["0", "1"], frame["out"]
    for r in ("0", "1"):
        assert float(rows[r][3]) > 0.0, frame["out"]   # step_ms

    # the merge: two aligned worker lanes and the server's cluster lane
    merged = str(tmp_path / "merged.json")
    p = subprocess.run([sys.executable, "-m",
                        "mxnet_tpu_torch.tools.trace_merge", "-o", merged,
                        "--validate", str(out / "trace")], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert p.returncode == 0, (p.stdout, p.stderr)
    with open(merged) as f:
        trace = json.load(f)
    assert ttm.lane_pids(trace) == [0, 1]
    names = sorted(e["args"]["name"] for e in trace["traceEvents"]
                   if e.get("ph") == "M" and e.get("name") == "process_name")
    assert names == ["cluster", "rank 0", "rank 1"], names
    offs = trace["otherData"]["clock_offsets"]
    one = offs["telemetry.1.jsonl"]
    assert one["sync_points"] >= 8, offs
    # one host, one clock: the offset is the sync points' jitter
    assert abs(one["offset_s"]) < 0.05 and one["residual_s"] < 0.05, offs
