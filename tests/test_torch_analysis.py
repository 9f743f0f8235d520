"""The port's static analysis (``mxnet_tpu_torch/analysis``) against the JAX
package's on the CPU: the eleven portable fwlint rules give the same
findings on the JAX suite's own cases, suppressions, fingerprints and the
baseline ratchet agree, the lock graph and the thread roots agree after the
package name is substituted; the port's four CUDA-graph rules on their own
positive and negative cases; and the whole-port gate (the linter exits 0
against the port's baseline, without importing torch or jax)."""
import ast
import json
import os
import re
import subprocess
import sys
import textwrap
import threading
import time

import pytest

import mxnet_tpu.analysis as JA  # noqa: F401 — the JAX side of the parity
from mxnet_tpu.analysis import baseline as jbase, checkers as jcheck, \
    concurrency as jconc, fwlint as jfw, lockgraph as jlg
from mxnet_tpu_torch.analysis import baseline as tbase, checkers as tcheck, \
    concurrency as tconc, fwlint as tfw, lockgraph as tlg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TESTS = os.path.join(ROOT, "tests_tpu", "test_analysis.py")

PORTABLE = ("env-raw-read", "bare-except", "swallowed-exception",
            "thread-hygiene", "lock-discipline", "lock-order",
            "mutable-default-arg", "unguarded-shared-write",
            "check-then-act", "unbalanced-acquire", "guard-mismatch")
PORT_RULES = ("host-sync", "untracked-capture", "capture-impure",
              "recapture-hazard")

# the JAX suite's cases for each portable rule, by test function
CASES = {
    "env-raw-read": ("test_env_raw_read_positive",
                     "test_env_raw_read_negative",
                     "test_inline_suppression_same_line_and_line_above",
                     "test_trailing_suppression_does_not_leak_to_next_line",
                     "test_suppression_with_ascii_hyphen_reason"),
    "bare-except": ("test_bare_except_positive_negative",),
    "swallowed-exception": ("test_swallowed_exception_positive_negative",),
    "thread-hygiene": ("test_thread_hygiene_positive",
                       "test_thread_hygiene_negative",
                       "test_thread_hygiene_self_attr_join"),
    "lock-discipline": (
        "test_lock_discipline_positive_negative",
        "test_lock_discipline_module_lock_cannot_satisfy_class_owned",
        "test_lock_discipline_local_alias_resolves",
        "test_lock_discipline_alias_of_any_lock_name",
        "test_lock_discipline_local_shadow_of_module_name",
        "test_lock_discipline_module_level_lock",
        "test_lock_discipline_class_lock_cannot_satisfy_module_annotation",
        "test_lock_discipline_async_with"),
    "lock-order": ("test_lock_order_lexical_cycle",
                   "test_lock_order_transitive_cycle_through_call",
                   "test_lock_order_consistent_order_clean",
                   "test_lock_order_blocking_under_shared_lock",
                   "test_lock_order_condition_wait_on_held_lock_exempt",
                   "test_lock_order_transitive_blocking_through_helper",
                   "test_lock_order_condition_wait_helper_exempt",
                   "test_lock_order_blocking_under_private_lock_clean",
                   "test_lock_order_string_and_path_join_not_blocking"),
    "mutable-default-arg": ("test_mutable_default_arg",
                            "mutable_default_negative"),
    "unguarded-shared-write": (
        "test_shared_write_two_roots_positive",
        "test_publish_once_is_clean", "test_dominant_lock_outlier",
        "test_fully_guarded_single_access_is_clean",
        "test_alias_resolved_guard_is_clean",
        "test_handler_thread_root_and_per_connection_exemption"),
    "check-then-act": ("test_check_then_act_positive",
                       "test_check_then_act_negative_lock_spans_test_and_set"),
    "unbalanced-acquire": (
        "test_unbalanced_acquire_positive_and_handoff_negative",),
    "guard-mismatch": ("test_guard_mismatch_positive_and_negative",
                       "guard_mismatch_negative"),
}


def _jax_sources():
    """test name -> the multi-line source strings its body assigns."""
    tree = ast.parse(open(JAX_TESTS).read())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        out[fn.name] = [textwrap.dedent(n.value.value) for n in ast.walk(fn)
                        if isinstance(n, ast.Assign)
                        and isinstance(n.value, ast.Constant)
                        and isinstance(n.value.value, str)
                        and "\n" in n.value.value]
    return out


_SOURCES = _jax_sources()
# the JAX suite holds this rule's negative inside its positive source
_SOURCES["mutable_default_negative"] = [
    "def ok(a, b=None, c=(), d='x', *, e=frozenset()):\n    return a\n"]
# ... and this one's negative is its positive with the annotation fixed
_SOURCES["guard_mismatch_negative"] = [
    _SOURCES["test_guard_mismatch_positive_and_negative"][0].replace(
        "guarded-by: lk_a", "guarded-by: lk_b")]
PARITY = [(rule, name, i) for rule, names in CASES.items() for name in names
          for i in range(len(_SOURCES.get(name, ())))]


def _renamed(text):
    return re.sub(r"\bmxnet_tpu\b", "mxnet_tpu_torch", text)


def _keyed(findings, rename=False):
    return sorted((f.rule, f.line, f.col,
                   _renamed(f.message) if rename else f.message)
                  for f in findings)


def test_every_case_was_found():
    """The parity table is not vacuous: every named JAX test still exists
    and assigns at least one source."""
    missing = [n for names in CASES.values() for n in names
               if not _SOURCES.get(n)]
    assert not missing, missing
    assert len(PARITY) >= 40


@pytest.mark.parametrize("rule,name,i", PARITY)
def test_portable_rule_parity(rule, name, i):
    src = _SOURCES[name][i]
    j = jfw.lint_source(src, path="mxnet_tpu/fake.py", select=[rule])
    t = tfw.lint_source(src, path="mxnet_tpu_torch/fake.py", select=[rule])
    assert _keyed(t) == _keyed(j, rename=True)
    # and with every rule on: the portable ones still agree
    j = [f for f in jfw.lint_source(src, path="mxnet_tpu/fake.py")
         if f.rule in PORTABLE]
    t = [f for f in tfw.lint_source(src, path="mxnet_tpu_torch/fake.py")
         if f.rule in PORTABLE]
    assert _keyed(t) == _keyed(j, rename=True)


@pytest.mark.parametrize("rule", PORTABLE)
def test_portable_rule_has_positive_and_negative_case(rule):
    got = [bool(tfw.lint_source(_SOURCES[n][i], path="mxnet_tpu_torch/fake.py",
                                select=[rule]))
           for r, n, i in PARITY if r == rule]
    assert True in got and False in got, (rule, got)


def test_env_raw_read_helper_file_parity():
    src = 'import os\nv = os.environ.get("MXNET_X")\n'
    for pkg, fw in (("mxnet_tpu", jfw), ("mxnet_tpu_torch", tfw)):
        assert fw.lint_source(src, path=pkg + "/base.py",
                              select=["env-raw-read"]) == []
        assert len(fw.lint_source(src, path=pkg + "/other.py",
                                  select=["env-raw-read"])) == 1


def test_rule_sets():
    assert set(jfw.RULES) - {"device-escape", "untracked-jit",
                             "trace-impure", "recompile-hazard"} \
        == set(PORTABLE)
    assert set(tfw.RULES) == set(PORTABLE) | set(PORT_RULES)


# ------------------------------------------ suppressions, fingerprints, baseline
SUPPRESSED = """
import os
a = os.environ.get("MXNET_A")  # fwlint: disable=env-raw-read — reason
# fwlint: disable=env-raw-read — reason
b = os.environ.get("MXNET_B")
c = os.environ.get("MXNET_C")  # fwlint: disable=thread-hygiene (wrong rule)
d = os.environ.get("MXNET_D")  # fwlint: disable=env-raw-read,bare-except - x
e = os.environ.get("MXNET_E")
try:
    x = 1
except:  # fwlint: disable=all — a test of the catch-all
    x = 2
"""


def test_suppressions_and_fingerprints_agree():
    j = jfw.lint_source(SUPPRESSED, path="m.py")
    t = tfw.lint_source(SUPPRESSED, path="m.py")
    assert [f.line for f in t] == [6, 8]
    assert [(f.rule, f.line, f.fingerprint, f.message) for f in t] == \
        [(f.rule, f.line, f.fingerprint, f.message) for f in j]
    drifted = "# a comment pushing things down\n\n" + SUPPRESSED
    assert [f.fingerprint for f in tfw.lint_source(drifted, path="m.py")] \
        == [f.fingerprint for f in t]


def test_baseline_files_and_diffs_agree(tmp_path):
    src = SUPPRESSED + 'f = os.environ.get("MXNET_F")\n'
    found_j = jfw.lint_source(src, path="m.py")
    found_t = tfw.lint_source(src, path="m.py")
    jbase.save(str(tmp_path / "j.json"), found_j)
    tbase.save(str(tmp_path / "t.json"), found_t)
    jdoc = json.load(open(tmp_path / "j.json"))
    tdoc = json.load(open(tmp_path / "t.json"))
    assert jdoc["findings"] == tdoc["findings"]
    assert jdoc["version"] == tdoc["version"] == 1
    # the port reads a baseline the JAX package wrote (and the other way)
    assert tbase.load(str(tmp_path / "j.json")) == jbase.load(
        str(tmp_path / "t.json"))
    later = src.replace('f = os.environ.get("MXNET_F")\n',
                        'g = os.environ.get("MXNET_G")\n')
    jd = jbase.diff(jfw.lint_source(later, path="m.py"),
                    jbase.load(str(tmp_path / "j.json")))
    td = tbase.diff(tfw.lint_source(later, path="m.py"),
                    tbase.load(str(tmp_path / "t.json")))
    assert [[f.fingerprint for f in x] for x in td[:2]] + [td[2]] == \
        [[f.fingerprint for f in x] for x in jd[:2]] + [jd[2]]
    assert len(td[0]) == 1 and "MXNET_G" in td[0][0].message
    assert len(td[2]) == 1


def test_run_lint_ratchet(tmp_path):
    repo = tmp_path / "repo"
    (repo / "pkg").mkdir(parents=True)
    mod = repo / "pkg" / "m.py"
    mod.write_text('import os\nv = os.environ.get("MXNET_X")\n')
    bl = repo / "baseline.json"
    tbase.save(str(bl), tfw.lint_paths(["pkg"], str(repo)))
    assert [len(x) for x in tfw.run_lint(
        ["pkg"], root=str(repo), baseline_path=str(bl))] == [0, 1, 0]
    mod.write_text('import os\nv = os.environ.get("MXNET_X")\n'
                   'w = os.environ.get("MXNET_Y")\n')
    new, known, _ = tfw.run_lint(["pkg"], root=str(repo),
                                 baseline_path=str(bl))
    assert len(new) == 1 and len(known) == 1
    with pytest.raises(FileNotFoundError):
        tfw.lint_paths(["nope"], str(repo))


# ------------------------------------------------- lock graph, thread roots
THREE_LOCKS = """
import threading

class Eng:
    def __init__(self):
        self.la = threading.Lock()
        self.lb = threading.Lock()
        self.lc = threading.Lock()

    def step(self):
        with self.la:
            with self.lb:
                with self.lc:
                    pass
"""


def _graph_sources():
    out = [("fake3.py", THREE_LOCKS)]
    for name in CASES["lock-order"] + CASES["unguarded-shared-write"]:
        for i, src in enumerate(_SOURCES[name]):
            out.append(("%s_%d.py" % (name[5:], i), src))
    return out


@pytest.mark.parametrize("fname,src", _graph_sources(),
                         ids=[f for f, _ in _graph_sources()])
def test_lock_graph_parity(fname, src):
    gj = jlg.build([jfw.FileContext("mxnet_tpu/" + fname, src)])
    gt = tlg.build([tfw.FileContext("mxnet_tpu_torch/" + fname, src)])
    ren = {(_renamed(a), _renamed(b)) for a, b in gj.edge_set()}
    assert gt.edge_set() == ren
    assert [tuple(map(_renamed, c)) for c in gj.cycles()] == gt.cycles()
    assert _renamed(gj.to_dot()) == gt.to_dot()
    if fname == "fake3.py":
        assert gt.edge_set() == {
            ("mxnet_tpu_torch.fake3.Eng.la", "mxnet_tpu_torch.fake3.Eng.lb"),
            ("mxnet_tpu_torch.fake3.Eng.la", "mxnet_tpu_torch.fake3.Eng.lc"),
            ("mxnet_tpu_torch.fake3.Eng.lb", "mxnet_tpu_torch.fake3.Eng.lc")}


ROOTS = """
import atexit
import threading
from http.server import BaseHTTPRequestHandler

class Pump:
    def __init__(self):
        self.n = 0

    def _loop(self):
        self._tick()

    def _tick(self):
        self.n += 1

    def start(self):
        threading.Thread(target=self._loop, name="pump", daemon=True).start()
        threading.Timer(1.0, self._tick).start()

def spawn(name, target):
    threading.Thread(target=target, name=name, daemon=True).start()

def _flush():
    pass

def go(p):
    spawn("flusher", _flush)

atexit.register(_flush)

class Handler(BaseHTTPRequestHandler):
    def do_GET(self):
        _flush()
"""


def test_thread_roots_parity():
    mj = jconc.build_model([jfw.FileContext("mxnet_tpu/spawns.py", ROOTS)])
    mt = tconc.build_model([tfw.FileContext("mxnet_tpu_torch/spawns.py",
                                            ROOTS)])
    assert _renamed(mj.dump_roots()) == mt.dump_roots()
    labels = {r.label for r in mt.roots}
    assert {"thread(pump)", "thread(flusher)", "timer(self._tick)",
            "atexit(_flush)", "http-handler(Handler)", "main"} <= labels


# ----------------------------------------------------- the port's four rules
def _lint(src, path="mxnet_tpu_torch/fake.py", rule=None):
    return tfw.lint_source(textwrap.dedent(src), path=path,
                           select=[rule] if rule else None)


def _hot(src, rule="host-sync"):
    return _lint(src, path="mxnet_tpu_torch/module/fake.py", rule=rule)


def test_host_sync_positive():
    src = """
    import numpy as np
    import torch

    def step(arr, dev):
        t = torch.zeros(4, device=dev)
        a = float(t)                    # __float__ is .item()
        if t.sum() > 0:                 # a device boolean
            pass
        b = t.cpu()                     # the explicit copy
        c = t.sum().item()
        m = np.mean(arr.data)           # NDArray.data is the held tensor
        msg = f"loss={t}"               # the repr copies
        h = arr.asnumpy()
        torch.cuda.synchronize()
        u = arr.data.to(dev).tolist()
        return a, b, c, m, msg, h, u
    """
    found = _hot(src)
    assert [f.line for f in found] == [7, 8, 10, 11, 12, 13, 14, 15, 16]
    assert all(f.rule == "host-sync" for f in found)
    assert any("torch.zeros(..., device=...)" in s for s in found[0].chain)
    assert any(".data" in s for s in found[4].chain)


def test_host_sync_negative_and_scoping():
    src = """
    import numpy as np
    import torch

    def step(lr, nbatch, arr):
        x = float(lr)                       # a Python scalar
        if nbatch > 0:
            pass
        h = torch.zeros(4, device="cpu")    # on the host
        y = float(h)
        z = arr.asnumpy()                   # flagged once ...
        w = np.asarray(z)                   # ... z is host from here on
        n = z.tolist()
        k = torch.ones(3).numpy()           # a host tensor
        return x, y, w, n, k
    """
    assert [f.line for f in _hot(src)] == [11]
    # outside the hot path nothing is flagged
    assert _lint(src, path="mxnet_tpu_torch/metric.py", rule="host-sync") \
        == []
    for hot in ("mxnet_tpu_torch/serving/x.py", "mxnet_tpu_torch/executor.py",
                "mxnet_tpu_torch/parallel/spmd.py"):
        assert len(_lint(src, path=hot, rule="host-sync")) == 1


def test_host_sync_kernel_wrapper_and_suppression():
    src = """
    from ..ops.attention import flash_attention

    def step(q, k, v):
        o = flash_attention(q, k, v)
        if o.isfinite().all():
            pass
        return int(o.argmax().cpu())  # fwlint: disable=host-sync — egress
    """
    found = _hot(src)
    assert [f.line for f in found] == [6]
    assert "kernel wrapper" in " ".join(found[0].chain)


def test_untracked_capture_positive():
    src = """
    import subprocess
    import torch
    from torch.cuda import graph

    def cap(fn):
        g = torch.cuda.CUDAGraph()
        with graph(g):
            fn()
        return g

    def manual(g):
        g.capture_begin()

    def compiled(fn):
        return torch.compile(fn)

    def build(src):
        subprocess.run(["nvcc", "-o", "x.so", src])
    """
    found = _lint(src, rule="untracked-capture")
    assert [f.line for f in found] == [7, 8, 13, 16, 19]
    assert "torch.cuda.CUDAGraph" in found[0].message


def test_untracked_capture_negative():
    """Charged to the registry (in the capturing function, or a same-file
    helper it calls) is clean, as is an nvcc run in the build modules."""
    src = """
    import torch
    from mxnet_tpu_torch import compileobs

    class G:
        def _capture(self):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                pass
            return g

        def build(self):
            g = self._capture()
            compileobs.note_compile("p", 0.1)
            return g

    def step(fn):
        graph = torch.cuda.CUDAGraph()
        with compileobs.record_compile("p", ()), torch.cuda.graph(graph):
            fn()
    """
    assert _lint(src, rule="untracked-capture") == []
    nvcc = 'import subprocess\nsubprocess.Popen(["nvcc", "-c", "a.cu"])\n'
    for path in tcheck.BUILD_FILES:
        assert _lint(nvcc, path=path, rule="untracked-capture") == []
    assert len(_lint(nvcc, rule="untracked-capture")) == 1


def test_present_capture_sites_are_clean():
    paths = ["mxnet_tpu_torch/parallel/spmd.py",
             "mxnet_tpu_torch/serving/graphs.py",
             "mxnet_tpu_torch/ops/_build.py"]
    assert tfw.lint_paths(paths, ROOT, select=["untracked-capture"]) == []
    assert tfw.lint_paths(["mxnet_tpu_torch"], ROOT,
                          select=["untracked-capture",
                                  "recapture-hazard"]) == []


def test_capture_impure_positive():
    src = """
    import gc
    import time
    import torch
    from mxnet_tpu_torch import telemetry

    _SEEN = []

    def body(x):
        telemetry.counter("steps").inc()   # counted once, at capture
        t = time.perf_counter()            # a clock read baked in
        _SEEN.append(x)                    # outer container mutation
        y = x.sum().item()                 # a host sync
        torch.cuda.synchronize()           # ends the capture
        s = torch.cuda.Stream()            # a new stream ends it too
        b = torch.empty(4, pin_memory=True)
        return x * t

    def capture(g, x):
        gc.disable()
        with torch.cuda.graph(g):
            body(x)

    def capture_gc_on(g, x):
        with torch.cuda.graph(g):
            x.add_(1)
    """
    found = _lint(src, rule="capture-impure")
    assert sorted(f.line for f in found) == [10, 11, 12, 13, 14, 15, 16, 25]
    gc_on = [f for f in found if f.line == 25]
    assert "garbage collector" in gc_on[0].message


def test_capture_impure_reaches_through_a_lambda_and_across_files():
    """The fused step's shape: the capturing helper calls a parameter, the
    caller passes a lambda, and the lambda's callee lives in another
    file."""
    main_src = textwrap.dedent("""
    import gc
    import torch
    import pkg.helper as H

    class T:
        def _capture_slot(self, g, fn):
            gc.collect()
            gc.disable()
            with torch.cuda.graph(g):
                fn()

        def _capture(self, g, x):
            self._capture_slot(g, lambda: self._run(x))

        def _run(self, x):
            return H.inner(x)
    """)
    helper_src = textwrap.dedent("""
    import time

    def inner(x):
        time.sleep(0)
        return x * 2
    """)
    ctxs = [tfw.FileContext("pkg/main.py", main_src),
            tfw.FileContext("pkg/helper.py", helper_src)]
    found = tcheck.check_capture_impure(ctxs)
    assert [(f.path, f.line) for f in found] == [("pkg/helper.py", 5)]
    assert "time.sleep" in found[0].message


def test_capture_impure_negative():
    src = """
    import gc
    import torch

    def body(x, out):
        acc = []
        for i in range(4):
            acc.append(x * i)             # a local list
        out.copy_(sum(acc[1:], acc[0]))
        return out

    def capture(g, x, out):
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(g):
                body(x, out)
        finally:
            gc.enable()

    def not_captured(x):
        torch.cuda.synchronize()
        return x.item()
    """
    assert _lint(src, rule="capture-impure") == []


def test_recapture_hazard_positive():
    src = """
    import numpy as np

    class E:
        def __init__(self, fn):
            self._graphs = {}
            self._decode_graphs = {B: BucketGraph("d", fn, [(B,)], "cuda")
                                   for B in (1, 2, 4)}

        def _slot(self, slot):
            g = self._graphs.get(slot)
            return g

        def run(self, reqs, nbatch):
            g = self._decode_graphs[len(reqs)]     # an un-bucketed key
            self._slot(nbatch)                     # a per-step key
            for i, r in enumerate(reqs):
                g(np.zeros(len(r)))                # fine: g is a local
                self._decode_graphs[4](np.zeros(len(r)))  # per-step shape
    """
    found = _lint(src, rule="recapture-hazard")
    assert [f.line for f in found] == [15, 16, 19]
    assert all("fresh CUDA graph" in f.message for f in found)
    assert any("per-step scalar by name" in " ".join(f.chain) for f in found)


def test_recapture_hazard_negative():
    src = """
    import numpy as np

    def _bucket_for(n, buckets):
        return min(b for b in buckets if b >= n)

    class E:
        def __init__(self, fn):
            self._prefill_graphs = self._build(fn)

        def _build(self, fn):
            return {S: BucketGraph("p", fn, [(1, S)], "cuda")
                    for S in (16, 32)}

        def run(self, replay):
            L = len(replay)
            S = _bucket_for(L, (16, 32))
            toks = np.zeros((1, S), np.int32)
            self._prefill_graphs[S](toks, np.array([L], np.int32))
    """
    assert _lint(src, rule="recapture-hazard") == []


# --------------------------------------------------------- the whole-port gate
def test_port_lint_gate_standalone():
    """The CLI exits 0 against the port's baseline, well inside 30 s, and
    imports neither torch nor jax (``-X importtime`` lists every module the
    run imports)."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "mxnet_tpu_torch.tools.fwlint", "--baseline",
         "mxnet_tpu_torch/analysis/fwlint_baseline.json"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    wall = time.perf_counter() - t0
    assert res.returncode == 0, res.stdout + res.stderr[-3000:]
    assert "fwlint: ok" in res.stdout
    assert wall < 30, wall
    mods = [l.rsplit("|", 1)[-1].strip() for l in res.stderr.splitlines()
            if l.startswith("import time:")]
    assert "mxnet_tpu_torch.analysis.checkers" in mods
    bad = [m for m in mods if m.split(".")[0] in ("torch", "jax", "jaxlib",
                                                  "numpy", "mxnet_tpu")]
    assert not bad, bad
    rules = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.fwlint",
         "--list-rules"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=60).stdout.split()
    assert sorted(rules) == sorted(PORTABLE + PORT_RULES)


def test_port_baseline_only_holds_live_findings():
    """Every baselined fingerprint still fires (none is stale), and the
    triage froze nothing of the four concurrency families but
    unguarded-shared-write and no host-sync or capture rule."""
    base = tbase.load(os.path.join(ROOT, "mxnet_tpu_torch", "analysis",
                                   "fwlint_baseline.json"))
    new, known, stale = tfw.run_lint(
        ["mxnet_tpu_torch", "chip_smoke.py"], root=ROOT,
        baseline_path="mxnet_tpu_torch/analysis/fwlint_baseline.json")
    assert new == [] and stale == []
    assert len(known) == len(base)
    rules = [rec["rule"] for rec in base.values()]
    for r in ("check-then-act", "unbalanced-acquire", "guard-mismatch",
              "untracked-capture", "recapture-hazard", "host-sync"):
        assert r not in rules


def test_cli_modes(tmp_path, capsys):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "port_fwlint_cli", os.path.join(ROOT, "mxnet_tpu_torch", "tools",
                                        "fwlint.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    assert cli.main(["--root", ROOT, "mxnet_tpu_torchx"]) == 2
    bl = tmp_path / "bl.json"
    assert cli.main(["--baseline", str(bl), "--update-baseline", "--select",
                     "env-raw-read", "--root", ROOT]) == 2
    assert not bl.exists()
    assert cli.main(["--dump-lock-graph", "--root", ROOT,
                     "mxnet_tpu_torch/serving",
                     "mxnet_tpu_torch/kvstore_server.py"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("digraph lock_order")
    assert "mxnet_tpu_torch.kvstore_server.KVStoreServer._ha_lock" in out
    assert cli.main(["--dump-thread-roots", "--root", ROOT]) == 0
    out = capsys.readouterr().out
    for root in ("thread(DeviceFeedIter)", "thread(mxnet-telemetry-flusher)",
                 "thread(mxnet-kv-replication)",
                 "thread(mxnet-kv-server-heartbeat)",
                 "thread(mxnet-kv-server-waiter)",
                 "thread(mxnet-kv-registry-standby)",
                 "thread(serving-engine-driver)", "main  (spawned at <main>:0"):
        assert root in out, root
    seeded = tmp_path / "seeded.py"
    seeded.write_text("def step(x):\n    return float(x.data)\n")
    (tmp_path / "mxnet_tpu_torch" / "module").mkdir(parents=True)
    (tmp_path / "mxnet_tpu_torch" / "module" / "m.py").write_text(
        seeded.read_text())
    js = tmp_path / "out.json"
    assert cli.main(["--root", str(tmp_path), "--json-out", str(js),
                     "mxnet_tpu_torch"]) == 1
    rec = json.load(open(js))["new"]
    assert [r["rule"] for r in rec] == ["host-sync"]
    capsys.readouterr()
    assert cli.main(["--root", str(tmp_path), "--explain",
                     rec[0]["fingerprint"][:8], "mxnet_tpu_torch"]) == 0
    assert ".data — the tensor an NDArray holds" in capsys.readouterr().out
