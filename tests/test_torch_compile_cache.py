"""The port's persistent compile cache (``mxnet_tpu_torch/compile_cache.py``)
on the CPU.

The key, marker, prune and fingerprint cases of the JAX package's suite;
the artifact store with its checksum; the compile registry's warm/cold
classification and ``compile_report``'s hit rate and warm-vs-cold
``compare``; and the cache over the nvcc libraries across processes:
``ops/_build.build`` with a stand-in ``nvcc`` (a script that logs each
call and compiles a tiny C source with ``g++``). The cold process builds
and saves the library; a warm one, on a fresh build directory, makes no
compiler call, loads the library with ``ctypes`` and calls it; after the
artifact is corrupted the next process counts an error and rebuilds.
``tools/launch.py --elastic`` hands a port worker the cache directory.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

from mxnet_tpu_torch import compile_cache, compileobs, telemetry
from mxnet_tpu_torch.tools import compile_report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_dir(tmp_path):
    d = str(tmp_path / "cc")
    assert compile_cache.enable(d)
    yield d
    compile_cache.disable()


@pytest.fixture(autouse=True)
def _no_ambient_cache():
    was = compile_cache.cache_dir()
    compile_cache.disable()
    yield
    compile_cache.disable()
    if was:
        compile_cache.enable(was)


# ---------------------------------------------------------------------------
# keys, markers, artifacts, pruning
# ---------------------------------------------------------------------------

def test_module_is_inert_until_enabled():
    assert not compile_cache.enabled() and compile_cache.cache_dir() is None
    assert compile_cache.classify_compile("p", "k") is None
    assert compile_cache.load_executable("k") is None
    s = compile_cache.stats()
    assert s["enabled"] is False and "aot_artifacts" not in s
    assert "cache_hits" not in compileobs.summary()


def test_make_key_stable_and_sensitive(cache_dir):
    sig = (("[0]", "", (4, 3), "float32"),)
    k1 = compile_cache.make_key("p", ("d", 1), sig)
    assert k1 == compile_cache.make_key("p", ("d", 1), sig)
    assert k1 != compile_cache.make_key("p", ("d", 2), sig)
    assert k1 != compile_cache.make_key("q", ("d", 1), sig)
    assert k1 != compile_cache.make_key(
        "p", ("d", 1), (("[0]", "", (8, 3), "float32"),))


def test_classify_compile_miss_then_hit(cache_dir):
    key = compile_cache.make_key("prog", "dig", ())
    h0 = telemetry.counter("compile.cache_hits", program="prog").value
    m0 = telemetry.counter("compile.cache_misses", program="prog").value
    assert compile_cache.classify_compile("prog", key, 1.0) == "miss"
    assert compile_cache.classify_compile("prog", key, 1.0) == "hit"
    # the caller's own verdict wins over the marker
    assert compile_cache.classify_compile("prog", key, 1.0, hit=False) == \
        "miss"
    assert telemetry.counter("compile.cache_hits",
                             program="prog").value == h0 + 1
    assert telemetry.counter("compile.cache_misses",
                             program="prog").value == m0 + 2


def test_artifact_round_trip(cache_dir, tmp_path):
    src = tmp_path / "lib.so"
    src.write_bytes(b"\x7fELF" + bytes(range(256)) * 8)
    assert compile_cache.save_executable("k1", str(src), "nvcc.x")
    dest = str(tmp_path / "copy.so")
    assert compile_cache.load_executable("k1", "nvcc.x", dest=dest) == dest
    assert open(dest, "rb").read() == src.read_bytes()
    assert compile_cache.load_executable("k1") == src.read_bytes()
    s = compile_cache.stats()
    assert s["aot_artifacts"] == 1 and s["aot_bytes"] > src.stat().st_size


@pytest.mark.parametrize("damage", ["garbage", "flipped", "torn"])
def test_corrupt_artifact_counts_error_and_falls_back(cache_dir, tmp_path,
                                                      damage):
    key = "deadbeef" * 5
    path = os.path.join(cache_dir, "aot", key)
    if damage == "garbage":
        with open(path, "wb") as f:
            f.write(b"this is not a library")
    else:
        src = tmp_path / "lib.so"
        src.write_bytes(bytes(range(256)) * 4)
        assert compile_cache.save_executable(key, str(src))
        blob = bytearray(open(path, "rb").read())
        if damage == "flipped":
            blob[100] ^= 0xFF
        else:
            blob = blob[:500]
        with open(path, "wb") as f:
            f.write(bytes(blob))
    e0 = telemetry.totals("compile.cache_errors")[1]
    assert compile_cache.load_executable(key, "prog",
                                         dest=str(tmp_path / "x")) is None
    assert telemetry.totals("compile.cache_errors")[1] == e0 + 1
    assert not os.path.exists(path)      # removed: the rebuild overwrites
    assert not os.path.exists(str(tmp_path / "x"))


def test_prune_evicts_oldest(cache_dir):
    for i in range(4):
        p = os.path.join(cache_dir, "aot", "k%d" % i)
        with open(p, "wb") as f:
            f.write(b"x" * (1 << 20))
        os.utime(p, (i, i))
    assert compile_cache.prune(2) == 2
    assert sorted(os.listdir(os.path.join(cache_dir, "aot"))) == ["k2", "k3"]


def test_prune_spares_markers_and_unpairs_evicted_artifacts(cache_dir):
    for i in range(4):
        p = os.path.join(cache_dir, "aot", "k%d" % i)
        with open(p, "wb") as f:
            f.write(b"x" * (1 << 20))
        os.utime(p, (10 + i, 10 + i))
        m = os.path.join(cache_dir, "meta", "k%d" % i)
        with open(m, "w") as f:
            f.write("k%d" % i)
        os.utime(m, (0, 0))  # markers are the oldest files by far
    compile_cache.prune(3)
    assert sorted(os.listdir(os.path.join(cache_dir, "aot"))) == ["k2", "k3"]
    assert sorted(os.listdir(os.path.join(cache_dir, "meta"))) == \
        ["k2", "k3"]


def test_fingerprint_pins_framework_identity(cache_dir):
    fp = compile_cache.fingerprint()
    for part in ("torch=", "cuda=", "nvcc=", "device=", "cap=", "n=",
                 "mxt=", "csrc="):
        assert part in fp, (part, fp)
    assert fp == compile_cache.fingerprint()


def test_compile_registry_classifies_with_the_cache_on(cache_dir):
    sig = (("x", "", (2, 3), "float32"),)
    was = telemetry.enabled()
    telemetry.enable()      # the event log keeps events while it is on
    try:
        compileobs.note_compile("test.cc_prog", 0.5, sig, digest="dig")
        compileobs.note_compile("test.cc_prog", 0.1, sig, digest="dig")
    finally:
        if not was:
            telemetry.disable()
    assert telemetry.counter("compile.cache_misses",
                             program="test.cc_prog").value == 1
    assert telemetry.counter("compile.cache_hits",
                             program="test.cc_prog").value == 1
    evs = [e for e in telemetry.events("compile")
           if e.get("program") == "test.cc_prog"]
    assert [e["cached"] for e in evs[-2:]] == [False, True]
    s = compileobs.summary()
    assert {"cache_hits", "cache_misses", "cache_errors"} <= set(s)
    rep = compile_report.from_registry()
    row = [p for p in rep["programs"] if p["program"] == "test.cc_prog"][0]
    assert (row["cache_hits"], row["cache_misses"]) == (1, 1)


# ---------------------------------------------------------------------------
# compile_report: hit-rate column + compare
# ---------------------------------------------------------------------------

def _ev(program, seconds, cached):
    return {"type": "event", "event": "compile", "program": program,
            "seconds": seconds, "cached": cached, "ts": 1.0}


def test_compile_report_hit_rate_from_events():
    rep = compile_report.analyze([
        _ev("nvcc.flash_fwd", 2.0, False),
        _ev("nvcc.flash_fwd", 0.1, True),
        _ev("fused.step", 0.05, True),
    ])
    t = rep["totals"]
    assert t["cache_hits"] == 2 and t["cache_misses"] == 1
    assert t["cache_hit_rate"] == round(2 / 3, 4)
    progs = {p["program"]: p for p in rep["programs"]}
    assert progs["nvcc.flash_fwd"]["cache_hits"] == 1
    assert progs["nvcc.flash_fwd"]["cache_misses"] == 1
    text = compile_report.render(rep)
    assert "hit-rate" in text and "cache 2/3 hit" in text


def test_compile_report_hit_counters_from_snapshots():
    snap = {"type": "snapshot", "ts": 2.0,
            "histograms": {"compile.seconds{program=p}":
                           {"count": 3, "sum": 1.5}},
            "gauges": {"compile.run_seconds{program=p}": 0.7},
            "counters": {"compile.cache_hits{program=p}": 2,
                         "compile.cache_misses{program=p}": 1}}
    rep = compile_report.analyze([snap])
    p = rep["programs"][0]
    assert (p["cache_hits"], p["cache_misses"]) == (2, 1)
    assert rep["totals"]["cache_hit_rate"] == round(2 / 3, 4)


def test_compile_report_compare():
    cold = compile_report.analyze([
        _ev("nvcc.flash_fwd", 2.0, False), _ev("fused.step", 0.5, False)])
    warm = compile_report.analyze([
        _ev("nvcc.flash_fwd", 0.2, True), _ev("fused.step", 0.1, True)])
    t = compile_report.compare(cold, warm)["totals"]
    assert t["cold_seconds"] == 2.5 and t["warm_seconds"] == pytest.approx(0.3)
    assert t["reduction_pct"] == 88.0
    assert t["warm_cold_compiles"] == 0 and t["warm_cache_hit_rate"] == 1.0
    text = compile_report.render_compare(compile_report.compare(cold, warm))
    assert "88.0% reduction" in text


def test_compile_report_compare_cli(tmp_path, capsys):
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    with open(a, "w") as f:
        f.write(json.dumps(_ev("p", 1.0, False)) + "\n")
    with open(b, "w") as f:
        f.write(json.dumps(_ev("p", 0.25, True)) + "\n")
    assert compile_report.main(["--compare", a, b]) == 0
    out = capsys.readouterr().out
    assert "75.0% reduction" in out and "warm hit rate 100%" in out


# ---------------------------------------------------------------------------
# the nvcc libraries across processes, with a stand-in compiler
# ---------------------------------------------------------------------------

STUB_NVCC = r"""#!/usr/bin/env python3
import subprocess, sys
args = sys.argv[1:]
with open(%(log)r, "a") as f:
    f.write(" ".join(args) + "\n")
out = args[args.index("-o") + 1]
sys.exit(subprocess.call(["g++", "-x", "c", "-shared", "-fPIC", "-O1",
                          "-o", out, args[-1]]))
"""

KERNEL_SRC = r"""
int mxt_stub_add(int x) { return x + 1; }
const char* mxt_stub_add_error_string(int code) { return "stub"; }
"""

WARM_SCRIPT = r"""
import ctypes, json, sys
from mxnet_tpu_torch import compile_cache, compileobs, telemetry
from mxnet_tpu_torch.ops import _build

_build.CSRC, _build.BUILD_DIR = sys.argv[1], sys.argv[2]
k = _build.Kernel("stub_add", [ctypes.c_int])
_build.build([k])
print(json.dumps({
    "result": k._load()(41), "nvcc_runs": _build.nvcc_runs,
    "program": k.program,
    "hits": telemetry.counter("compile.cache_hits", program=k.program).value,
    "misses": telemetry.counter("compile.cache_misses",
                                program=k.program).value,
    "errors": telemetry.totals("compile.cache_errors")[1],
    "summary": {x: compileobs.summary().get(x) for x in
                ("cache_hits", "cache_misses", "cache_errors")},
    "key": k.cache_key()}))
"""


def _stub_env(tmp_path):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "nvcc.log"
    nvcc = bindir / "nvcc"
    nvcc.write_text(STUB_NVCC % {"log": str(log)})
    nvcc.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "stub_add.cu").write_text(KERNEL_SRC)
    env = dict(os.environ)
    env["PATH"] = str(bindir) + os.pathsep + env.get("PATH", "")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["MXNET_COMPILE_CACHE_DIR"] = str(tmp_path / "cc")
    return env, log, str(csrc)


def _one_process(env, csrc, build_dir):
    out = subprocess.run([sys.executable, "-c", WARM_SCRIPT, csrc,
                          build_dir], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, (out.stdout, out.stderr[-3000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def _compiler_calls(log):
    return len(log.read_text().splitlines()) if log.exists() else 0


def test_nvcc_libraries_warm_start_across_processes(tmp_path):
    env, log, csrc = _stub_env(tmp_path)
    cold = _one_process(env, csrc, str(tmp_path / "build0"))
    assert cold["result"] == 42 and cold["nvcc_runs"] == 1
    assert _compiler_calls(log) == 1
    assert (cold["hits"], cold["misses"], cold["errors"]) == (0, 1, 0)
    artifact = tmp_path / "cc" / "aot" / cold["key"]
    assert artifact.exists()
    # a fresh build directory, the same cache: no compiler call at all
    warm = _one_process(env, csrc, str(tmp_path / "build1"))
    assert warm["result"] == 42 and warm["nvcc_runs"] == 0
    assert _compiler_calls(log) == 1
    assert (warm["hits"], warm["misses"], warm["errors"]) == (1, 0, 0)
    assert warm["summary"] == {"cache_hits": 1, "cache_misses": 0,
                               "cache_errors": 0}
    assert warm["key"] == cold["key"]
    # a corrupt artifact: counted, rebuilt, overwritten
    blob = bytearray(artifact.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    artifact.write_bytes(bytes(blob))
    fixed = _one_process(env, csrc, str(tmp_path / "build2"))
    assert fixed["result"] == 42 and fixed["nvcc_runs"] == 1
    assert _compiler_calls(log) == 2
    assert fixed["errors"] >= 1 and fixed["misses"] == 1
    again = _one_process(env, csrc, str(tmp_path / "build3"))
    assert again["nvcc_runs"] == 0 and again["errors"] == 0
    assert _compiler_calls(log) == 2


def test_a_library_found_built_is_saved_to_the_cache(tmp_path):
    env, log, csrc = _stub_env(tmp_path)
    env.pop("MXNET_COMPILE_CACHE_DIR")
    build_dir = str(tmp_path / "build0")
    first = _one_process(env, csrc, build_dir)     # no cache: a plain build
    assert first["nvcc_runs"] == 1
    env["MXNET_COMPILE_CACHE_DIR"] = str(tmp_path / "cc")
    second = _one_process(env, csrc, build_dir)    # found built: saved
    assert second["nvcc_runs"] == 0
    assert (tmp_path / "cc" / "aot" / second["key"]).exists()
    third = _one_process(env, csrc, str(tmp_path / "build1"))
    assert third["nvcc_runs"] == 0 and third["hits"] == 1
    assert _compiler_calls(log) == 1


# ---------------------------------------------------------------------------
# launch.py --elastic hands the workers a cache directory
# ---------------------------------------------------------------------------

ELASTIC_PROBE = r"""
import os
if os.environ.get("DMLC_ROLE") == "worker":
    from mxnet_tpu_torch import compile_cache
    print("CACHE_DIR=%s ENABLED=%s" % (
        os.environ.get("MXNET_COMPILE_CACHE_DIR", "UNSET"),
        compile_cache.enabled()))
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_elastic_launch_sets_the_port_workers_cache_dir(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DMLC_") and k != "MXNET_COMPILE_CACHE_DIR"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["MXNET_DEFAULT_CONTEXT"] = "cpu"
    env["TMPDIR"] = str(tmp_path)
    env["MXNET_KV_SERVER_CKPT_DIR"] = str(tmp_path / "ckpt")
    cmd = [sys.executable, os.path.join(ROOT, "tools", "launch.py"),
           "-n", "1", "-s", "1", "--port", str(_free_port()), "--elastic",
           sys.executable, "-c", textwrap.dedent(ELASTIC_PROBE)]
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, (out.stdout, out.stderr[-3000:])
    line = [l for l in out.stdout.splitlines() if l.startswith("CACHE_DIR=")]
    assert len(line) == 1, out.stdout
    assert "mxnet-compile-cache-" in line[0] and \
        line[0].startswith("CACHE_DIR=" + str(tmp_path)), line
    assert line[0].endswith("ENABLED=True"), line
