"""The runtime half of the port's ``analysis/`` against the JAX package's on
the CPU: the engine dependency sanitizer (the same script of pushes gives the
same counter deltas for the four violation kinds; strict mode raises at the
wait and, for a deleted var, at the push; off, the NDArray accessors are the
original objects) and the lock witness's seeded static graph
(``seed_static``/``unknown_edge``); plus the kvstore server's ``_primary``
read the port's linter found outside ``_ha_lock``."""
import re
import textwrap
import threading
import time

import pytest

import mxnet_tpu as J
import mxnet_tpu_torch as T
from mxnet_tpu import engine as jengine, telemetry as jtel
from mxnet_tpu.analysis import fwlint as jfw, lockgraph as jlg, \
    sanitizer as jsan, witness as jwit
from mxnet_tpu_torch import engine as tengine, telemetry as ttel
from mxnet_tpu_torch.analysis import fwlint as tfw, lockgraph as tlg, \
    sanitizer as tsan, witness as twit
from mxnet_tpu_torch.base import MXNetError

KINDS = ("undeclared_mutation", "const_write", "use_after_free",
         "undeclared_read")
PKGS = {"jax": (J, jengine, jsan, jtel), "torch": (T, tengine, tsan, ttel)}


def _ones(mx, n=2):
    if mx is T:
        return T.nd.ones((n,), ctx=T.cpu())
    return J.nd.ones((n,))


def _counts(san, tel):
    return {k: tel.counter(san.COUNTER_PREFIX + k).value for k in KINDS}


@pytest.fixture(autouse=True)
def _off():
    yield
    for san in (jsan, tsan):
        san.configure(None)
    for w in (jwit, twit):
        w.configure(None)
        w.seed_static(None)
        w.reset_observations()


def _script(pkg):
    """One script of pushes over three tracked arrays in warn mode: the
    counter deltas and the arrays' final values."""
    mx, eng_mod, san, tel = PKGS[pkg]
    eng = eng_mod.NaiveEngine()
    a, b, c = _ones(mx), _ones(mx), _ones(mx)
    va, vb, vc = (eng.new_variable() for _ in range(3))
    for arr, var in ((a, va), (b, vb), (c, vc)):
        san.attach(arr, var)
    san.configure("warn")
    before = _counts(san, tel)

    def assign():
        a[:] = b

    def accumulate():
        c.__iadd__(a)

    # write b declared nowhere (and read it): undeclared_mutation + read
    eng.push(lambda: b._set_data(b.data * 2), const_vars=[va])
    # write a declared const
    eng.push(lambda: a._set_data(a.data + 1), const_vars=[va])
    # declared correctly
    eng.push(lambda: b._set_data(a.data * 3), const_vars=[va],
             mutable_vars=[vb])
    eng.push(assign, const_vars=[vb], mutable_vars=[va])
    eng.push(accumulate, const_vars=[va], mutable_vars=[vc])
    # a const write through a[:] = b (declared: the JAX package's a[:]
    # also reads a, for its dtype), and an undeclared read
    eng.push(assign, const_vars=[vb, va])
    eng.push(lambda: c.data)
    # touch a deleted var (declaring nothing, so only the access trips)
    eng.delete_variable(vc)
    eng.push(lambda: c.data)
    eng.wait_all()
    after = _counts(san, tel)
    san.configure(None)
    return ({k: after[k] - before[k] for k in KINDS},
            [x.asnumpy().tolist() for x in (a, b, c)])


def test_sanitizer_counter_parity():
    got, want = _script("torch"), _script("jax")
    assert got == want
    deltas = got[0]
    assert deltas["undeclared_mutation"] == 1 and deltas["const_write"] == 2
    assert deltas["use_after_free"] == 1 and deltas["undeclared_read"] >= 2


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_sanitizer_strict_raises_at_wait_and_push(pkg):
    mx, eng_mod, san, _ = PKGS[pkg]
    eng = eng_mod.NaiveEngine()
    a, b = _ones(mx), _ones(mx)
    va, vb = eng.new_variable(), eng.new_variable()
    san.attach(a, va)
    san.attach(b, vb)
    san.configure("strict")
    eng.push(lambda: b._set_data(b.data * 2), const_vars=[va])
    with pytest.raises(san.EngineSanitizerError) as ei:
        eng.wait_all()
    assert ei.value.kind == "undeclared_mutation"
    assert b.asnumpy()[0] == 2.0  # the fn ran to completion first
    # the error slot is read-and-clear: the engine stays usable
    eng.push(lambda: None, mutable_vars=[vb])
    eng.wait_all()
    eng.push(lambda: a._set_data(a.data + 1), const_vars=[va])
    with pytest.raises(san.EngineSanitizerError) as ei:
        eng.wait_for_var(va)
    assert ei.value.kind == "const_write"
    # reads never raise, even strict
    eng.push(lambda: b.data)
    eng.wait_all()
    eng.delete_variable(vb)
    with pytest.raises(san.EngineSanitizerError) as ei:
        eng.push(lambda: None, const_vars=[vb])
    assert ei.value.kind == "use_after_free"
    assert isinstance(ei.value, J.base.MXNetError if pkg == "jax"
                      else MXNetError)


def test_sanitizer_off_leaves_the_original_accessors():
    from mxnet_tpu_torch.ndarray import NDArray

    names = ("data", "_set_data", "__setitem__", "_inplace")
    tsan.configure(None)
    orig = [NDArray.__dict__[n] for n in names]
    tsan.configure("warn")
    assert all(NDArray.__dict__[n] is not o for n, o in zip(names, orig))
    tsan.configure("strict")
    tsan.configure(None)
    assert all(NDArray.__dict__[n] is o for n, o in zip(names, orig))
    assert NDArray.data.fget.__qualname__ == "NDArray.data"


def test_sanitizer_view_routes_to_its_base():
    eng = tengine.NaiveEngine()
    a = T.nd.ones((4, 3), ctx=T.cpu())
    va = eng.new_variable()
    tsan.attach(a, va)
    view = a[1]
    assert view._engine_var is None and tsan.var_of(view) is va
    assert tsan.var_of(a[1:3]) is va
    assert tsan.var_of(a.reshape((12,))) is None  # imperative ops copy
    assert tsan.var_of(T.nd.ones((4, 3), ctx=T.cpu())) is None
    tsan.configure("strict")
    eng.push(lambda: view._set_data(view.data * 0), const_vars=[va])
    with pytest.raises(tsan.EngineSanitizerError) as ei:
        eng.wait_all()
    assert ei.value.kind == "const_write"
    # rebound to a fresh tensor, the array's old views report nothing
    a._set_data(a.data.clone())
    assert tsan.var_of(view) is None and tsan.var_of(a) is va


def test_sanitizer_on_the_threaded_engines_workers():
    """The record has to land on the native worker thread the ctypes
    trampoline runs the op on."""
    eng = tengine.ThreadedEngine(2)
    a, b = _ones(T), _ones(T)
    va, vb = eng.new_variable(), eng.new_variable()
    tsan.attach(a, va)
    tsan.attach(b, vb)
    tsan.configure("strict")
    ran_on = []

    def fn():
        ran_on.append(threading.get_ident())
        b._set_data(b.data + 1)

    eng.push(fn, const_vars=[va])
    with pytest.raises(tsan.EngineSanitizerError) as ei:
        eng.wait_for_var(va)
        eng.wait_all()
    assert ei.value.kind == "undeclared_mutation"
    assert ran_on and ran_on[0] != threading.get_ident()
    eng.push(lambda: b._set_data(a.data * 5), const_vars=[va],
             mutable_vars=[vb])
    eng.wait_all()
    assert b.asnumpy()[0] == 5.0


@pytest.mark.parametrize("value,mode", [("warn", "warn"), ("strict", "strict"),
                                        ("bogus", None)])
def test_sanitizer_env_configuration(monkeypatch, value, mode):
    for san in (jsan, tsan):
        monkeypatch.setenv("MXNET_ENGINE_SANITIZER", value)
        san._mode = san._UNSET  # force a re-read of the env
        assert san.mode() == mode


def test_engine_pushes_counted_with_telemetry_on():
    eng = tengine.NaiveEngine()
    was = ttel.enabled()
    ttel.enable()
    try:
        n0 = ttel.counter("engine.pushes").value
        eng.push(lambda: None)
        eng.wait_all()
        assert ttel.counter("engine.pushes").value == n0 + 1
    finally:
        if not was:
            ttel.disable()
    for k in KINDS:
        name = "engine.sanitizer." + k
        assert ttel.METRIC_HELP[name] == jtel.METRIC_HELP[name]


# ---------------------------------------------------------------- witness
THREE_LOCKS = textwrap.dedent("""
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
""")


def _renamed(x):
    return re.sub(r"\bmxnet_tpu\b", "mxnet_tpu_torch", x)


def _witness_script(pkg):
    """The JAX suite's two seeded cases: a known edge passes and an unknown
    one raises; lockgraph's own three-lock edges replayed clean, then an
    off-graph nesting raises. Returns what each step saw."""
    w, fw, lg, tel = {"jax": (jwit, jfw, jlg, jtel),
                      "torch": (twit, tfw, tlg, ttel)}[pkg]
    p = "mxnet_tpu" if pkg == "jax" else "mxnet_tpu_torch"
    out = []
    w.configure("strict")
    a, b, c = (w.declare("%s.fake.U%s" % (p, x), threading.Lock())
               for x in "ABC")
    w.seed_static({("%s.fake.UA" % p, "%s.fake.UB" % p)})
    with a:
        with b:
            pass
    try:
        with a:
            with c:
                pass
        out.append(None)
    except w.LockWitnessError as e:
        out.append(e.kind)
    out.append(a.acquire(blocking=False) and c.acquire(blocking=False))
    c.release()
    a.release()
    out.append(sorted(w.observed_edges()))
    w.reset_observations()
    graph = lg.build([fw.FileContext("%s/fake3.py" % p, THREE_LOCKS)])
    edges = graph.edge_set()
    w.seed_static(edges)
    la, lb, lc = (w.declare(i, threading.Lock())
                  for i in sorted({s for e in edges for s in e}))
    before = tel.counter(w.COUNTER_ORDER).value
    with la:
        with lb:
            with lc:
                pass
    with la:
        with lc:
            pass
    out.append(tel.counter(w.COUNTER_ORDER).value - before)
    out.append(w.observed_edges() == edges)
    ld = w.declare("%s.fake3.Eng.ld" % p, threading.Lock())
    try:
        with la:
            with ld:
                pass
        out.append(None)
    except w.LockWitnessError as e:
        out.append(e.kind)
    out.append(tel.counter(w.COUNTER_ORDER).value - before)
    # unseeded, an inversion is still caught
    w.seed_static(None)
    try:
        with lb:
            with la:
                pass
        out.append(None)
    except w.LockWitnessError as e:
        out.append(e.kind)
    out.append(sorted(w.observed_edges()))
    return json_ready(out)


def json_ready(x):
    return _renamed(repr(x))


def test_witness_seeded_parity():
    got = _witness_script("torch")
    assert got == _witness_script("jax")
    assert "'unknown_edge'" in got and "'order_inversion'" in got


def test_witness_off_is_pristine_and_modes():
    twit.configure(None)
    lk = threading.Lock()
    assert twit.declare("mxnet_tpu_torch.fake.Off._lock", lk) is lk
    assert "seed_static" in twit.__all__


# ------------------------------------------------- the _primary read (fix)
def test_kvstore_server_reads_primary_under_the_ha_lock():
    """A promotion flips ``_primary`` under ``_ha_lock``; an update that
    lands while the flip is in progress must wait for it and see the new
    role (two threads: the promoting one holds the lock while the update
    arrives)."""
    import ctypes

    import numpy as np

    from mxnet_tpu_torch import kvstore_server as kvs

    srv = object.__new__(kvs.KVStoreServer)
    srv._sid = 0
    srv._updater_lock = threading.Lock()
    srv._updater = None
    srv._replicas = 1
    srv._backups = [1]
    srv._ha_lock = threading.Lock()
    srv._primary = False
    offered = []
    srv._repl_offer = lambda key, w, s: offered.append(key)
    grad = np.arange(4, dtype=np.float32)
    weight = np.zeros(4, np.float32)
    holding, done = threading.Event(), threading.Event()

    def promote():
        with srv._ha_lock:
            holding.set()
            time.sleep(0.3)   # the update arrives mid-flip
            srv._primary = True

    def update():
        srv._apply(7, grad.ctypes.data_as(ctypes.c_void_p),
                   weight.ctypes.data_as(ctypes.c_void_p), 4)
        done.set()

    p = threading.Thread(target=promote, name="promote", daemon=True)
    u = threading.Thread(target=update, name="update", daemon=True)
    p.start()
    assert holding.wait(5)
    u.start()
    assert not done.wait(0.1)  # blocked behind the promotion's lock
    p.join(5)
    u.join(5)
    assert done.is_set()
    assert offered == [7]      # offered by the server that is now primary
    assert weight.tolist() == grad.tolist()
