"""The port's C boundary (``mxnet_tpu_torch/csrc/capi/``, built by
``mxnet_tpu_torch/_capi.py``) driven by compiled clients on the CPU: the
predict API, the pure C++ ``.params`` and RecordIO codecs, rtc and the
profiler, the long tail of ``c_api.h`` and imperative autograd.

Every client compiles unchanged against the port's headers and library:
the JAX package's own test clients (``tests/c/*.c`` and the client texts
of ``tests/test_c_*.py``, imported, not copied) and the port's
``csrc/capi/clients/predict_client.c``. Each runs in a process of its own
with ``MXNET_DEFAULT_CONTEXT=cpu`` (its embedded interpreter imports the
port, never the JAX package), and its outputs are held to what the JAX
package's Python computes for the same inputs in this process. The JAX
package's C library is never built here (its own tests build it).
"""
import importlib.util
import json
import os
import re
import subprocess

import numpy as np
import pytest

import mxnet_tpu as J
from mxnet_tpu import predict as jpred
from mxnet_tpu_torch import _capi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JSRC = os.path.join(ROOT, "mxnet_tpu", "src")
CLIENTS = os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "capi", "clients")
RTOL = 1e-5
ATOL = 1e-6
# the JAX package's C shims and the entry points each exports
SHIMS = {"c_predict_api.cc": 12, "c_api_ndarray.cc": 20,
         "c_api_recordio.cc": 8, "c_api_train.cc": 86}


def reference(name):
    """A JAX-side test module, imported for its client texts."""
    spec = importlib.util.spec_from_file_location(
        "_capi_reference_" + name, os.path.join(ROOT, "tests", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def compile_clients(out_dir, clients):
    """Compile {name: (source text or path, "c" | "c++")} against the port
    at once; returns {name: executable}."""
    flags = _capi.client_flags()
    procs, exes = {}, {}
    for name, (source, lang) in clients.items():
        path = source
        if not os.path.exists(source):
            path = os.path.join(out_dir, name + (".c" if lang == "c" else ".cpp"))
            with open(path, "w") as f:
                f.write(source)
        exes[name] = os.path.join(out_dir, name)
        cmd = (["gcc", "-O1", path] if lang == "c"
               else ["g++", "-std=c++17", "-O1", path])
        procs[name] = subprocess.Popen(
            cmd + ["-o", exes[name]] + flags + ["-lm"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        out = p.communicate(timeout=600)[0]
        assert p.returncode == 0, (name, out[-3000:])
    return exes


def run(exe, *args, cwd=None, timeout=300):
    return subprocess.run([exe, *map(str, args)], capture_output=True,
                          text=True, env=_capi.client_env(cpu=True), cwd=cwd,
                          timeout=timeout)


@pytest.fixture(scope="module")
def exes(tmp_path_factory):
    tp, tr, trp = (reference("test_c_predict"), reference("test_c_recordio"),
                   reference("test_c_rtc_profiler"))
    return compile_clients(str(tmp_path_factory.mktemp("capi")), {
        "predict_cpp": (tp.CLIENT_CPP, "c++"),
        "ndarray_c": (tp.C_NDARRAY_CLIENT, "c++"),
        "recordio": (tr.CLIENT_CPP, "c++"),
        "rtc_profiler": (trp.CLIENT_CPP, "c++"),
        "longtail": (os.path.join(ROOT, "tests", "c", "api_longtail_client.c"),
                     "c"),
        "autograd": (os.path.join(ROOT, "tests", "c", "autograd_client.c"),
                     "c"),
        "predict_client": (os.path.join(CLIENTS, "predict_client.c"), "c")})


# ---- the library ----------------------------------------------------------
def _exports(lib):
    out = subprocess.run(["nm", "-D", "--defined-only", lib],
                         capture_output=True, text=True, check=True).stdout
    return {line.split()[-1] for line in out.splitlines()
            if line.split()[-2:-1] == ["T"] and line.split()[-1].startswith("MX")}


def test_library_exports_the_jax_shims_entry_points(tmp_path):
    """``nm -D`` of the port's library against ``nm -D`` of the JAX
    package's four shim sources compiled into a scratch library (their
    own build directory is left alone): the same 126 ``MX*`` names, 12
    predict, 20 NDArray, 8 RecordIO and 86 training."""
    import sysconfig

    objs, procs = [], []
    for src in SHIMS:
        objs.append(str(tmp_path / (src + ".o")))
        procs.append(subprocess.Popen(
            ["g++", "-O0", "-std=c++17", "-fPIC", "-c",
             "-I" + sysconfig.get_config_var("INCLUDEPY"),
             os.path.join(JSRC, src), "-o", objs[-1]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out = p.communicate(timeout=600)[0]
        assert p.returncode == 0, out[-3000:]
    jax_lib = str(tmp_path / "libjax_shims.so")
    subprocess.run(["g++", "-shared", "-o", jax_lib] + objs, check=True)
    want = _exports(jax_lib)
    got = _exports(_capi.build())
    assert len(want) == sum(SHIMS.values()) == 126
    assert got == want, (sorted(want - got), sorted(got - want))
    for src, n in SHIMS.items():
        port = open(os.path.join(_capi.SRC_DIR, src)).read()
        assert len(re.findall(r"^MXNET_DLL\b", port, re.M)) == n, src


def test_build_compiles_only_the_ports_sources(monkeypatch, tmp_path):
    """The library is compiled from ``mxnet_tpu_torch/csrc/capi`` alone, in
    a directory named by the digest, as ``libmxtpu_predict.so``."""
    commands = []

    class Done:
        returncode = 0
        stderr = ""
        stdout = ""

    def fake_run(cmd, **kw):
        commands.append(list(cmd))
        if "-o" in cmd:
            open(cmd[cmd.index("-o") + 1], "wb").close()
        return Done()

    monkeypatch.setattr(_capi, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_capi, "_built", {})
    monkeypatch.setattr(_capi.subprocess, "run", fake_run)
    path = _capi.build()
    assert os.path.basename(path) == "libmxtpu_predict.so"
    assert re.fullmatch(r"capi-[0-9a-f]{16}",
                        os.path.basename(os.path.dirname(path)))
    build = [c for c in commands if any(a.endswith(".cc") for a in c)]
    assert len(build) == 1
    sources = [a for a in build[0] if a.endswith((".cc", ".c", ".cpp"))]
    assert sorted(map(os.path.basename, sources)) == sorted(_capi.SOURCES)
    capi_dir = os.path.realpath(_capi.SRC_DIR)
    assert all(os.path.dirname(os.path.realpath(a)) == capi_dir
               for a in sources)
    assert not any("mxnet_tpu" + os.sep + "src" in a for a in build[0])
    assert capi_dir == os.path.realpath(
        os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "capi"))


def test_build_without_a_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_capi, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_capi, "_built", {})
    monkeypatch.setattr(_capi.shutil, "which", lambda _: None)
    with pytest.raises(Exception, match="g..? not found"):
        _capi.build()


# ---- predict ----------------------------------------------------------------
def _checkpoint(tmp, name, net, data_shape, label_shape, seed):
    """The JAX package's save_checkpoint of ``net`` with seeded
    parameters."""
    mod = J.mod.Module(net, context=J.cpu())
    mod.bind(data_shapes=[("data", data_shape)],
             label_shapes=[("softmax_label", label_shape)])
    mod.init_params(J.init.Xavier())
    rng = np.random.RandomState(seed)
    mod.set_params({k: J.nd.array(rng.uniform(-0.5, 0.5, v.shape).astype(
        np.float32)) for k, v in mod.get_params()[0].items()}, {})
    prefix = str(tmp / name)
    mod.save_checkpoint(prefix, 1)
    return prefix + "-symbol.json", prefix + "-0001.params"


def _mlp():
    net = J.sym.FullyConnected(J.sym.Variable("data"), num_hidden=4,
                               name="fc1")
    net = J.sym.Activation(net, act_type="relu")
    net = J.sym.FullyConnected(net, num_hidden=2, name="fc2")
    return J.sym.SoftmaxOutput(net, name="softmax")


def _jax_predict(sym_path, params_path, shapes, x):
    with open(sym_path) as f, open(params_path, "rb") as g:
        p = jpred.Predictor(f.read(), g.read(), input_shapes=shapes)
    return p.forward(data=x).get_output(0)


def test_predict_clients_match_jax(exes, tmp_path):
    """``test_c_predict.py``'s C++ client (``mxnet_predict.hpp``) and the
    port's ``predict_client.c`` over checkpoints the JAX package wrote:
    the MLP and a small Transformer-LM, against the JAX Predictor."""
    lm = importlib.import_module("mxnet_tpu.models.transformer_lm")
    B, S = 2, 16
    lm_shapes = {"data": (B, S), "softmax_label": (B, S)}
    lm_sym, lm_params = _checkpoint(tmp_path, "lm", lm.get_symbol(
        vocab_size=64, num_layers=2, model_dim=32, num_heads=2, ffn_dim=64,
        seq_len=S), (B, S), (B, S), 1)
    mlp_sym, mlp_params = _checkpoint(tmp_path, "mlp", _mlp(), (1, 8), (1,),
                                      2)

    r = run(exes["predict_cpp"], mlp_sym, mlp_params)
    assert r.returncode == 0, (r.stdout, r.stderr)
    word, n, total, n_params = r.stdout.split()
    want = _jax_predict(mlp_sym, mlp_params, {"data": (1, 8)},
                        (np.arange(8, dtype=np.float32) / 8)[None])
    assert (word, int(n), int(n_params)) == ("OUT", want.size, 4)
    assert abs(float(total) - float(want.sum())) < 1e-5

    tokens = np.random.RandomState(3).randint(0, 64, (B, S)).astype(np.float32)
    tokens.tofile(tmp_path / "tokens.f32")
    x = np.random.RandomState(4).randn(5, 8).astype(np.float32)
    x.tofile(tmp_path / "x.f32")
    r = run(exes["predict_client"], 3, lm_sym, lm_params, tmp_path / "tokens.f32",
            tmp_path / "lm.f32", 2, B, S, "+softmax_label", 2, B, S,
            mlp_sym, mlp_params, tmp_path / "x.f32", tmp_path / "mlp.f32", 2,
            5, 8)
    assert r.returncode == 0, (r.stdout, r.stderr)
    lines = r.stdout.splitlines()
    assert lines[0] == "JOB 0 SHAPE %d 64" % (B * S)
    assert lines[2] == "JOB 1 SHAPE 5 2"
    assert all(float(lines[i].split()[-1]) > 0 for i in (1, 3))
    for out, sym, params, shapes, inp in (
            ("lm.f32", lm_sym, lm_params, lm_shapes, tokens),
            ("mlp.f32", mlp_sym, mlp_params, {"data": (5, 8)}, x)):
        want = _jax_predict(sym, params, shapes, inp)
        got = np.fromfile(tmp_path / out, np.float32).reshape(want.shape)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_predict_client_reports_errors(exes, tmp_path):
    """A failed entry point returns -1 and ``MXGetLastError`` says why: the
    client stops with the message."""
    sym, params = _checkpoint(tmp_path, "mlp", _mlp(), (1, 8), (1,), 2)
    np.zeros(9, np.float32).tofile(tmp_path / "x.f32")
    r = run(exes["predict_client"], 1, sym, params, tmp_path / "x.f32",
            tmp_path / "out.f32", 2, 1, 9)
    assert r.returncode == 1
    assert r.stderr.startswith("FAIL MXPredCreate")
    message = r.stderr.split("): ", 1)[1]
    assert "(8)" in message and "(9)" in message, message


# ---- the pure C++ codecs ------------------------------------------------
def test_ndarray_client_files_are_the_jax_packages(exes, tmp_path):
    """``test_c_predict.py``'s pure-C NDArray client: its ``MXNDArraySave``
    file is the JAX package's ``nd.save`` of the same dict byte for byte,
    up to the 16-byte CRC32 footer (``MXCR``, crc, length) that the
    Python writers add and no reader needs (the reference's never reads
    it); it reads a JAX-written file, and the JAX package reads its."""
    py_file = tmp_path / "from_python.params"
    J.nd.save(str(py_file), {"x": J.nd.array(np.arange(4, dtype=np.float32))})
    c_file = tmp_path / "from_c.params"
    r = run(exes["ndarray_c"], c_file, py_file)
    assert r.returncode == 0, (r.returncode, r.stdout, r.stderr)
    assert "C-NDARRAY OK" in r.stdout
    want = tmp_path / "want.params"
    J.nd.save(str(want), {"arg:w": J.nd.array(
        np.arange(6, dtype=np.float32).reshape(2, 3))})
    got, full = c_file.read_bytes(), want.read_bytes()
    assert full[:len(got)] == got
    footer = full[len(got):]
    assert len(footer) == 16 and footer[:4] == b"MXCR"
    assert int.from_bytes(footer[8:], "little") == len(got)
    loaded = J.nd.load(str(c_file))
    np.testing.assert_array_equal(loaded["arg:w"].asnumpy(),
                                  np.arange(6, dtype=np.float32).reshape(2, 3))


def test_recordio_client_files_are_the_jax_packages(exes, tmp_path):
    """``test_c_recordio.py``'s client: the file it writes equals the JAX
    package's ``MXRecordIO`` writing the same records, byte for byte, at
    the same record offsets; it reads a JAX-written file back."""
    from mxnet_tpu.recordio import MXRecordIO

    records = [b"hello", b"", b"recordio-interchange!"]
    c_rec = tmp_path / "c.rec"
    r = run(exes["recordio"], "out", c_rec)
    assert r.returncode == 0, (r.stdout, r.stderr)
    py_rec = str(tmp_path / "py.rec")
    w = MXRecordIO(py_rec, "w")
    tells = []
    for rec in records:
        tells.append(w.tell())
        w.write(rec)
    w.close()
    assert c_rec.read_bytes() == open(py_rec, "rb").read()
    assert [int(l.split()[1]) for l in r.stdout.splitlines()] == tells

    w = MXRecordIO(str(tmp_path / "py2.rec"), "w")
    for rec in (b"alpha", b"x" * 1000):
        w.write(rec)
    w.close()
    r = run(exes["recordio"], "in", tmp_path / "py2.rec")
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert r.stdout.splitlines() == ["REC 5 alpha", "REC 1000 xxxxxxxxxxxx"]


# ---- the training C API's long tail --------------------------------------
def test_rtc_and_profiler_client(exes, tmp_path):
    """``test_c_rtc_profiler.py``'s client: an rtc kernel (the client checks
    ``z = 2x + y``, as the JAX package's ``Rtc`` computes it) and a profile
    dumped as chrome-trace JSON."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    y = 100 - x
    z = J.nd.zeros((3, 4))
    J.rtc.Rtc("saxpy", [("x", None), ("y", None)], [("z", None)],
              "z = 2.0 * x + y").push([J.nd.array(x), J.nd.array(y)], [z])
    np.testing.assert_allclose(z.asnumpy(), 2 * x + y)
    profile = tmp_path / "profile.json"
    r = run(exes["rtc_profiler"], profile)
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "RTC-OK" in r.stdout
    trace = json.loads(profile.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    assert isinstance(events, list) and events


def test_long_tail_client(exes):
    """``tests/c/api_longtail_client.c``: imperative invoke, shape
    inference, NDArray views and raw bytes, creator introspection and the
    monitor callback. Its op count is the JAX package's, and the monitor
    sees as many node outputs as the JAX executor's monitor does on the
    client's graph (FullyConnected 7 -> relu, batch 4 x 3)."""
    r = run(exes["longtail"])
    assert r.returncode == 0, (r.stdout, r.stderr)
    m = re.match(r"OK monitor_hits=(\d+) ops=(\d+)", r.stdout)
    assert m, r.stdout
    from mxnet_tpu.ops.registry import list_ops

    net = J.sym.Activation(J.sym.FullyConnected(
        J.sym.Variable("data"), num_hidden=7, name="fc1"), act_type="relu",
        name="act")
    ex = net.simple_bind(J.cpu(), grad_req="null", data=(4, 3))
    hits = []
    ex.set_monitor_callback(lambda name, arr: hits.append(name))
    ex.forward(is_train=False)
    assert (int(m.group(1)), int(m.group(2))) == (len(hits), len(list_ops()))


def test_autograd_client(exes):
    """``tests/c/autograd_client.c``: z = sum(x^2) recorded through
    ``MXImperativeInvoke``; the client checks 2x, a second value, and that
    a null request leaves its gradient alone; the same gradient is the
    JAX package's autograd's."""
    from mxnet_tpu.contrib import autograd

    x = J.nd.array(np.array([1.0, -2.0, 3.0], np.float32))
    g = J.nd.zeros((3,))
    autograd.mark_variables([x], [g])
    with autograd.train_section():
        z = J.nd.sum(J.nd.square(x))
    autograd.compute_gradient([z])
    np.testing.assert_allclose(g.asnumpy(), 2 * x.asnumpy())
    r = run(exes["autograd"])
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert r.stdout.startswith("OK"), r.stdout
