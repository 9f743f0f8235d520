"""The port's Python-free artifact (A8b): ``mxnet_tpu_torch.export_artifact``
and the runtime ``libmxtpu_predict_native.so`` (``csrc/native_rt/``, built
by ``mxnet_tpu_torch._predict_native``), held against the JAX package's
exporter and executors and against the port's own executor and fused step.

The compiled clients are the JAX package's own, unchanged
(``tests/c/predict_native_client.c``, ``tests/c/train_native_client.c``),
linked against the port's runtime and run with ``MXNET_DEFAULT_CONTEXT=cpu``:
their processes load no Python. Tolerances: the port's executor and fused
step 1e-6 (the same ATen kernels in the same order), the JAX package's
executor 1e-5 (as its own test bounds its runtime) and its SPMDTrainer
1e-4 over five steps. The program sections differ by design (C34): the
JAX package's StableHLO is refused by the port's runtime.
"""
import ctypes
import json
import os
import shutil
import struct
import subprocess

import numpy as np
import pytest

import mxnet_tpu as J
import mxnet_tpu_torch as T
from mxnet_tpu_torch import _predict_native as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CDIR = os.path.join(ROOT, "tests", "c")

needs_gcc = pytest.mark.skipif(shutil.which("gcc") is None,
                               reason="no C toolchain")

LM = dict(vocab_size=100, num_layers=2, model_dim=64, num_heads=2, ffn_dim=128,
          seq_len=16)


# ---- nets --------------------------------------------------------------------
def mlp(mx, hidden=16, classes=4):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=hidden, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=classes, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def conv_bn(mx, fix_gamma=True, hidden=3):
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                             name="conv1")
    net = mx.sym.BatchNorm(net, name="bn1", fix_gamma=fix_gamma)
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = mx.sym.Flatten(net)
    net = mx.sym.FullyConnected(net, num_hidden=hidden, name="fc")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def attn(mx):
    """Flash attention on the data (the plain version on the CPU) behind
    the two scalar ops the graph passes fold scalar chains into."""
    data = mx.sym.Variable("data")
    net = mx.sym.contrib.FlashAttention(data, data * 2, data + 1, name="attn")
    net = mx.sym.Flatten(net)
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def dropout_mlp(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = mx.sym.Dropout(net, p=0.5, name="drop")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def lm(mx):
    import importlib

    mod = importlib.import_module(mx.__name__ + ".models.transformer_lm")
    return mod.get_symbol(**LM)


def _params_of(net, shapes, seed, scale=0.2):
    """Seeded float32 parameters and auxiliary states of ``net`` (the port's
    symbol) at input ``shapes``."""
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = net.infer_shape(**shapes)
    args = {n: (rs.randn(*s) * scale).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in shapes and not n.endswith("label")}
    auxs = {}
    for n, s in zip(net.list_auxiliary_states(), aux_shapes):
        auxs[n] = (1 + 0.1 * rs.rand(*s) if n.endswith("var")
                   else 0.1 * rs.randn(*s)).astype(np.float32)
    return args, auxs


CASES = {
    "mlp": (mlp, {"data": (2, 8)}, 7),
    "conv": (lambda mx: conv_bn(mx, fix_gamma=False), {"data": (2, 1, 14, 14)}, 11),
    "conv_fix_gamma": (conv_bn, {"data": (2, 1, 14, 14)}, 12),
    "lm": (lm, {"data": (2, LM["seq_len"]),
                "softmax_label": (2, LM["seq_len"])}, 13),
    "attn": (attn, {"data": (2, 2, 16, 8)}, 14),
    "dropout": (dropout_mlp, {"data": (4, 8)}, 15),
}


def _case(name):
    build, shapes, seed = CASES[name]
    args, auxs = _params_of(build(T), shapes, seed)
    return build, shapes, args, auxs


def _input(name, shapes, seed=3):
    rs = np.random.RandomState(seed)
    shp = shapes["data"]
    if name == "lm":
        return rs.randint(0, LM["vocab_size"], size=shp).astype(np.float32)
    return rs.randn(*shp).astype(np.float32)


def _sections(path):
    raw = open(path, "rb").read()
    (mlen,) = struct.unpack("<Q", raw[8:16])
    off = 16 + mlen
    (plen,) = struct.unpack("<Q", raw[off:off + 8])
    off += 8 + plen
    (qlen,) = struct.unpack("<Q", raw[off:off + 8])
    return raw[16:16 + mlen], raw[off + 8:off + 8 + qlen]


def _without_port_keys(manifest):
    m = dict(manifest)
    for k in ("platform", "program_format", "optimizer_params"):
        m.pop(k, None)
    return m


# ---- fixtures ------------------------------------------------------------------
@pytest.fixture(scope="module")
def native():
    """The runtime's path (built once per module)."""
    return P.build()


def _compile(tmp, src, name):
    exe = str(tmp / name)
    res = subprocess.run(["gcc", "-O2", "-o", exe, src] + P.client_flags(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return exe


@pytest.fixture(scope="module")
def clients(native, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("clients")
    return {"predict": _compile(tmp, os.path.join(CDIR, "predict_native_client.c"),
                                "pnc"),
            "train": _compile(tmp, os.path.join(CDIR, "train_native_client.c"),
                              "tnc")}


def _run(cmd, **kw):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          env=P.client_env(cpu=True), **kw)


# ---- the container and the manifest ------------------------------------------------
def test_container_round_trip_both_ways(tmp_path):
    build, shapes, args, _ = _case("mlp")
    tp, jp = str(tmp_path / "t.mxa"), str(tmp_path / "j.mxa")
    net = build(T)
    mt = T.export_predict_artifact(net, args, {}, shapes, tp, platform="cpu")
    mj = J.export_predict_artifact(build(J), args, {}, shapes, jp,
                                   platform="cpu")
    for path, want in ((tp, mt), (jp, mj)):
        for reader in (T.export_artifact.load_artifact_manifest,
                       J.export_artifact.load_artifact_manifest):
            got, plen, qlen = reader(path)
            assert got == want and plen > 0 and qlen > 0
            with open(path, "rb") as f:
                f.seek(8)
                (mlen,) = struct.unpack("<Q", f.read(8))
            assert os.path.getsize(path) == 8 + 8 + mlen + 8 + plen + 8 + qlen
    assert mt["program_format"] == "mxnet-symbol-json"
    assert mt["platform"] == "cpu" and "program_format" not in mj
    # the port's program is the symbol JSON of the graph the executor runs
    raw = open(tp, "rb").read()
    off = 16 + struct.unpack("<Q", raw[8:16])[0]
    (plen,) = struct.unpack("<Q", raw[off:off + 8])
    program = json.loads(raw[off + 8:off + 8 + plen])
    assert program["nodes"][-1]["op"] == "SoftmaxOutput"
    assert program == json.loads(T.graphpass.optimize(net).tojson())


@pytest.mark.parametrize("name", sorted(CASES))
def test_predict_manifest_and_params_are_the_jax_packages(name, tmp_path):
    """Equal manifests but for ``platform`` and ``program_format`` (the
    ``kept`` flags included: a ``fix_gamma`` BatchNorm's gamma is dropped
    as ``jax.export`` drops it, a loss head's label kept) and byte-equal
    params sections."""
    build, shapes, args, auxs = _case(name)
    tp, jp = str(tmp_path / "t.mxa"), str(tmp_path / "j.mxa")
    mt = T.export_predict_artifact(build(T), args, auxs, shapes, tp,
                                   platform="cpu")
    mj = J.export_predict_artifact(build(J), args, auxs, shapes, jp,
                                   platform="cpu")
    assert _without_port_keys(mt) == _without_port_keys(mj)
    assert _sections(tp)[1] == _sections(jp)[1]
    if name == "conv_fix_gamma":
        assert "arg:bn1_gamma" not in mt["params"]


TRAIN_EXPORTS = {
    "sgd_momentum": (mlp, {"data": (8, 8)}, "sgd",
                     {"learning_rate": 0.1, "momentum": 0.9}, None),
    "sgd": (mlp, {"data": (8, 8)}, "sgd", {"learning_rate": 0.1, "wd": 1e-3}, None),
    "adam": (mlp, {"data": (8, 8)}, "adam", {"learning_rate": 0.01}, None),
    "conv_bn_bf16": (conv_bn, {"data": (4, 1, 8, 8)}, "sgd",
                     {"learning_rate": 0.1, "momentum": 0.9}, "bfloat16"),
}


@pytest.mark.parametrize("name", sorted(TRAIN_EXPORTS))
def test_train_manifest_and_params_are_the_jax_packages(name, tmp_path):
    build, shapes, opt, opt_params, cd = TRAIN_EXPORTS[name]
    args, auxs = _params_of(build(T), shapes, 5)
    tp, jp = str(tmp_path / "t.mxa"), str(tmp_path / "j.mxa")
    kw = dict(optimizer=opt, optimizer_params=opt_params, arg_params=args,
              aux_params=auxs, platform="cpu", compute_dtype=cd, seed=4)
    mt = T.export_train_artifact(build(T), shapes, tp, **kw)
    mj = J.export_train_artifact(build(J), shapes, jp, **kw)
    assert _without_port_keys(mt) == _without_port_keys(mj)
    assert _sections(tp)[1] == _sections(jp)[1]
    op = mt["optimizer_params"]
    assert set(op["lr_mult"]) == {a["name"] for a in mt["args"]
                                  if a["role"] == "param"}
    assert op["wd"] == opt_params.get("wd", 0.0)


def test_export_refusals(tmp_path):
    build, shapes, args, _ = _case("mlp")
    del args["fc1_bias"]
    with pytest.raises(T.MXNetError, match="fc1_bias"):
        T.export_predict_artifact(build(T), args, {}, shapes,
                                  str(tmp_path / "x.mxa"), platform="cpu")
    with pytest.raises(ValueError, match="divide"):
        T.export_train_artifact(mlp(T), {"data": (9, 8)},
                                str(tmp_path / "y.mxa"), platform="cpu",
                                num_devices=2)


# ---- the runtime ----------------------------------------------------------------
def test_runtime_links_no_libpython(native):
    out = subprocess.run(["ldd", native], capture_output=True, text=True,
                         timeout=60).stdout
    names = [line.split()[0] for line in out.splitlines() if line.strip()]
    assert names and not [n for n in names if "python" in n.lower()], out
    assert any(n.startswith("libtorch_cpu") for n in names), out


def _port_forward(name, build, shapes, args, auxs, x):
    net = build(T)
    with T.cpu():
        ex = net.simple_bind(T.cpu(), grad_req="null", **shapes)
        for k, v in args.items():
            ex.arg_dict[k][:] = v
        for k, v in auxs.items():
            ex.aux_dict[k][:] = v
        ex.arg_dict["data"][:] = x
        return ex.forward(is_train=False)[0].asnumpy()


def _jax_forward(name, build, shapes, args, auxs, x):
    ex = build(J).simple_bind(J.cpu(), grad_req="null", **shapes)
    for k, v in args.items():
        ex.arg_dict[k][:] = v
    for k, v in auxs.items():
        ex.aux_dict[k][:] = v
    ex.arg_dict["data"][:] = x
    return ex.forward(is_train=False)[0].asnumpy()


@needs_gcc
@pytest.mark.parametrize("name", ["mlp", "conv", "conv_fix_gamma", "lm", "attn",
                                  "dropout"])
def test_c_client_predicts_as_the_executors(name, clients, tmp_path):
    """The unchanged JAX-side C client, linked against the port's runtime:
    within 1e-6 of the port's executor, 1e-5 of the JAX package's."""
    build, shapes, args, auxs = _case(name)
    path = str(tmp_path / "m.mxa")
    T.export_predict_artifact(build(T), args, auxs, shapes, path,
                              platform="cpu")
    x = _input(name, shapes)
    x.tofile(str(tmp_path / "in.f32"))
    r = _run([clients["predict"], path, "data", str(tmp_path / "in.f32"),
              str(tmp_path / "out.f32")])
    assert r.returncode == 0, r.stdout + r.stderr
    ref_t = _port_forward(name, build, shapes, args, auxs, x)
    ref_j = _jax_forward(name, build, shapes, args, auxs, x)
    out = np.fromfile(str(tmp_path / "out.f32"), np.float32).reshape(ref_t.shape)
    np.testing.assert_allclose(out, ref_t, atol=1e-6, rtol=0)
    np.testing.assert_allclose(out, ref_j, atol=1e-5, rtol=1e-5)


@needs_gcc
def test_shape_validation_and_ndlist(native, tmp_path):
    """The JAX package's check program (``test_predict_native.py``): a
    caller shape that differs from the artifact's is refused naming the
    re-export, and MXNDListCreate parses a .params blob in C++."""
    build, shapes, args, _ = _case("mlp")
    path = str(tmp_path / "mlp.mxa")
    T.export_predict_artifact(build(T), args, {}, shapes, path, platform="cpu")
    params_path = str(tmp_path / "p.params")
    T.nd.save(params_path, {k: T.nd.array(v, ctx=T.cpu())
                            for k, v in args.items()})
    src = open(os.path.join(ROOT, "tests", "test_predict_native.py")).read()
    csrc = src.split('src = r"""', 1)[1].split('"""', 1)[0]
    (tmp_path / "check.c").write_text(csrc)
    exe = _compile(tmp_path, str(tmp_path / "check.c"), "check")
    r = _run([exe, path, params_path])
    assert r.returncode == 0, r.stdout + r.stderr


def _cfloat(values):
    arr = np.ascontiguousarray(values, np.float32)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def test_partial_out_and_forward_in_process(tmp_path, monkeypatch):
    """MXPredCreatePartialOut picks internal outputs by their internals
    names; dev_type 1 is the CPU; values as the port's executor's."""
    monkeypatch.delenv("MXNET_DEFAULT_CONTEXT", raising=False)
    build, shapes, args, auxs = _case("conv")
    path = str(tmp_path / "c.mxa")
    T.export_predict_artifact(build(T), args, auxs, shapes, path,
                              platform="cpu")
    lib = P.load()
    blob = open(path, "rb").read()
    keys = (ctypes.c_char_p * 2)(b"bn1_output", b"fc_output")
    h = ctypes.c_void_p()
    assert lib.MXPredCreatePartialOut(None, blob, len(blob), 1, 0, 0, None,
                                      None, None, 2, keys,
                                      ctypes.byref(h)) == 0, lib.MXGetLastError()
    x = _input("conv", shapes)
    _, xp = _cfloat(x)
    assert lib.MXPredSetInput(h, b"data", xp, x.size) == 0
    assert lib.MXPredForward(h) == 0, lib.MXGetLastError()
    net = build(T)
    internals = net.get_internals()
    group = T.sym.Group([internals["bn1_output"], internals["fc_output"]])
    with T.cpu():
        ex = group.simple_bind(T.cpu(), grad_req="null", **shapes)
        for k, v in args.items():
            ex.arg_dict[k][:] = v
        for k, v in auxs.items():
            ex.aux_dict[k][:] = v
        ex.arg_dict["data"][:] = x
        want = [o.asnumpy() for o in ex.forward(is_train=False)]
    for i, ref in enumerate(want):
        shape_p = ctypes.POINTER(ctypes.c_uint)()
        ndim = ctypes.c_uint()
        assert lib.MXPredGetOutputShape(h, i, ctypes.byref(shape_p),
                                        ctypes.byref(ndim)) == 0
        assert tuple(shape_p[k] for k in range(ndim.value)) == ref.shape
        out = np.zeros(ref.shape, np.float32)
        assert lib.MXPredGetOutput(h, i, _cfloat(out)[1], out.size) == 0
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    assert lib.MXPredFree(h) == 0
    # an output key that names nothing is refused
    bad = (ctypes.c_char_p * 1)(b"nope_output")
    assert lib.MXPredCreatePartialOut(None, blob, len(blob), 1, 0, 0, None,
                                      None, None, 1, bad, ctypes.byref(h)) == -1
    assert b"nope_output" in lib.MXGetLastError()


def test_kernel_counters_stay_zero_on_the_cpu(tmp_path):
    build, shapes, args, auxs = _case("lm")
    path = str(tmp_path / "lm.mxa")
    T.export_predict_artifact(build(T), args, auxs, shapes, path,
                              platform="cpu")
    lib = P.load()
    for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "flash_wide_fwd"):
        P.kernel_launches(k, reset=True)
    h = ctypes.c_void_p()
    assert lib.MXPredCreateFromFile(path.encode(), 1, 0, ctypes.byref(h)) == 0, \
        lib.MXGetLastError()
    assert lib.MXPredForward(h) == 0, lib.MXGetLastError()
    assert lib.MXPredFree(h) == 0
    assert [P.kernel_launches(k) for k in ("flash_fwd", "flash_bwd_dkv",
                                           "flash_bwd_dq", "flash_wide_fwd")] \
        == [0, 0, 0, 0]
    assert P.kernel_launches("no_such_kernel") == -1


@needs_gcc
def test_artifacts_that_fail_cleanly(clients, tmp_path):
    """A JAX package artifact is refused naming C34; a crafted train
    artifact whose manifest shape exceeds its record fails at create
    (``test_corrupt_mxa_shape_mismatch_fails_cleanly``); a predict client
    without the CPU asked for and no card fails saying so."""
    build, shapes, args, _ = _case("mlp")
    jp = str(tmp_path / "j.mxa")
    J.export_predict_artifact(build(J), args, {}, shapes, jp, platform="cpu")
    np.zeros(16, np.float32).tofile(str(tmp_path / "in.f32"))
    r = _run([clients["predict"], jp, "data", str(tmp_path / "in.f32"),
              str(tmp_path / "o.f32")])
    assert r.returncode != 0 and "C34" in r.stderr, r.stdout + r.stderr

    path = str(tmp_path / "ok.mxa")
    T.export_train_artifact(mlp(T), {"data": (8, 8)}, path, optimizer="sgd",
                            optimizer_params={"learning_rate": 0.1},
                            platform="cpu")
    raw = open(path, "rb").read()
    (mlen,) = struct.unpack("<Q", raw[8:16])
    manifest = json.loads(raw[16:16 + mlen].decode())
    next(a for a in manifest["args"] if a["role"] == "param")["shape"][0] *= 4
    mjs = json.dumps(manifest, indent=1).encode()
    bad = str(tmp_path / "bad.mxa")
    with open(bad, "wb") as f:
        f.write(raw[:8] + struct.pack("<Q", len(mjs)) + mjs + raw[16 + mlen:])
    np.zeros(64, np.float32).tofile(str(tmp_path / "d.f32"))
    np.zeros(8, np.float32).tofile(str(tmp_path / "l.f32"))
    r = _run([clients["train"], bad, str(tmp_path / "d.f32"),
              str(tmp_path / "l.f32"), "8", "1", "0.1",
              str(tmp_path / "o.params"), str(tmp_path / "loss.txt")])
    assert r.returncode != 0 and "shape mismatch" in r.stdout + r.stderr

    import torch

    if not torch.cuda.is_available():
        tp = str(tmp_path / "t.mxa")
        T.export_predict_artifact(build(T), args, {}, shapes, tp,
                                  platform="cpu")
        r = subprocess.run([clients["predict"], tp, "data",
                            str(tmp_path / "in.f32"), str(tmp_path / "o.f32")],
                           capture_output=True, text=True, timeout=300,
                           env=P.client_env(cpu=False))
        assert r.returncode != 0 and "no CUDA device" in r.stderr, r.stderr


# ---- training ---------------------------------------------------------------------
def _blobs(n, dim, seed):
    rs = np.random.RandomState(seed)
    centers = rs.randn(3, dim).astype(np.float32) * 3
    y = np.arange(n) % 3
    x = centers[y] + rs.randn(n, dim).astype(np.float32)
    return x.astype(np.float32), y.astype(np.float32)


def _train_data(name, batch, steps):
    n = batch * steps
    if name == "lm":
        rs = np.random.RandomState(8)
        seq = LM["seq_len"]
        x = rs.randint(0, LM["vocab_size"], size=(n, seq)).astype(np.float32)
        y = np.roll(x, -1, axis=1)
        return x, y
    if name in ("conv_bn", "conv_bn_bf16"):
        x, y = _blobs(n, 8, 4)
        xi = np.zeros((n, 1, 8, 8), np.float32)
        for r in range(8):
            xi[:, 0, r, :] = np.roll(x, r, axis=1)
        return xi, y
    return _blobs(n, 8, 9)


TRAIN = {
    # name: (net, data shape per batch, optimizer, params, compute dtype)
    "mlp": (lambda mx: mlp(mx, 32, 3), (16, 8), "sgd",
            {"learning_rate": 0.05, "momentum": 0.9}, None),
    "conv_bn": (conv_bn, (16, 1, 8, 8), "sgd",
                {"learning_rate": 0.02, "momentum": 0.9}, None),
    "conv_bn_bf16": (lambda mx: conv_bn(mx, fix_gamma=False), (16, 1, 8, 8),
                     "sgd", {"learning_rate": 0.02, "momentum": 0.9},
                     "bfloat16"),
    "lm": (lm, (4, LM["seq_len"]), "adam", {"learning_rate": 0.001}, None),
}
STEPS = 5


def _port_fused(net, shapes, label_shapes, opt, opt_params, cd, args, auxs,
                x, y, batch):
    from mxnet_tpu_torch.parallel.spmd import SPMDTrainer
    import torch

    pnames = [n for n in net.list_arguments() if n not in shapes
              and n not in label_shapes]
    optimizer = T.optimizer.create(opt, sym=net,
                                   param_idx2name={n: n for n in pnames},
                                   **opt_params)
    tr = SPMDTrainer(net, "cpu", list(shapes.items()), optimizer,
                     label_shapes=list(label_shapes.items()), compute_dtype=cd)
    params = {n: torch.tensor(args[n]) for n in tr.param_names}
    tauxs = {n: torch.tensor(auxs[n]) for n in tr.aux_names}
    states = tr.init_opt_state()
    buf = tr.input_buffers()
    (dname,), (lname,) = list(shapes), list(label_shapes)
    for s in range(STEPS):
        buf[dname].copy_(torch.tensor(x[s * batch:(s + 1) * batch]))
        buf[lname].copy_(torch.tensor(
            y[s * batch:(s + 1) * batch].reshape(label_shapes[lname])))
        tr.step(params, tauxs, states)
    return ({n: v.numpy() for n, v in params.items()},
            {n: v.numpy() for n, v in tauxs.items()})


def _jax_fused(net, shapes, label_shapes, opt, opt_params, cd, args, auxs,
               x, y, batch):
    import jax

    from mxnet_tpu.parallel import build_mesh
    from mxnet_tpu.parallel.spmd import SPMDTrainer

    with jax.default_matmul_precision("highest"):
        mesh = build_mesh({"dp": 1}, list(jax.devices("cpu"))[:1])
        tr = SPMDTrainer(net, mesh, data_shapes=list(shapes.items()),
                         label_shapes=list(label_shapes.items()),
                         optimizer=opt, optimizer_params=opt_params,
                         compute_dtype=cd)
        params = {n: jax.device_put(args[n]) for n in tr.param_names}
        jauxs = {n: jax.device_put(auxs[n]) for n in tr.aux_names}
        states = tr.init_opt_state()
        (dname,), (lname,) = list(shapes), list(label_shapes)
        for s in range(STEPS):
            inputs = {dname: x[s * batch:(s + 1) * batch],
                      lname: y[s * batch:(s + 1) * batch].reshape(
                          label_shapes[lname])}
            params, jauxs, states, _ = tr.step(params, jauxs, states, inputs)
    return ({n: np.asarray(v) for n, v in params.items()},
            {n: np.asarray(v) for n, v in jauxs.items()})


@needs_gcc
@pytest.mark.parametrize("name", sorted(TRAIN))
def test_c_client_trains_as_the_fused_step(name, clients, tmp_path):
    """Five steps of the unchanged JAX-side C training client on the port's
    runtime against five of the port's fused step (1e-6) and of the JAX
    package's SPMDTrainer (1e-4; bfloat16 below), from the same parameters
    over the same batches; the saved file loads with ``nd.load`` and holds
    the moved auxiliary states."""
    build, dshape, opt, opt_params, cd = TRAIN[name]
    batch = dshape[0]
    lr = float(np.float32(opt_params["learning_rate"]))
    opt_params = dict(opt_params, learning_rate=lr)
    net = build(T)
    shapes = {"data": dshape}
    if name == "lm":
        label_shapes = {"softmax_label": dshape}
    else:
        label_shapes = {"softmax_label": (batch,)}
    args, auxs = _params_of(net, dict(shapes, **label_shapes), 21, scale=0.1)
    path = str(tmp_path / "t.mxa")
    T.export_train_artifact(net, dict(shapes, **label_shapes), path,
                            optimizer=opt, optimizer_params=opt_params,
                            arg_params=args, aux_params=auxs, platform="cpu",
                            compute_dtype=cd)
    x, y = _train_data(name, batch, STEPS)
    x.tofile(str(tmp_path / "data.f32"))
    y.tofile(str(tmp_path / "labels.f32"))
    out = str(tmp_path / "out.params")
    r = _run([clients["train"], path, str(tmp_path / "data.f32"),
              str(tmp_path / "labels.f32"), str(batch), str(STEPS), repr(lr),
              out, str(tmp_path / "loss.txt")])
    assert r.returncode == 0, r.stdout + r.stderr
    saved = {k: v.asnumpy() for k, v in T.nd.load(out).items()}
    assert set(saved) == {"arg:" + n for n in args} | {"aux:" + n for n in auxs}
    tp, ta = _port_fused(net, shapes, label_shapes, opt, opt_params, cd, args,
                         auxs, x, y, batch)
    jp, ja = _jax_fused(build(J), shapes, label_shapes, opt, opt_params, cd,
                        args, auxs, x, y, batch)
    jtol = {n: 1e-4 for n in list(args) + list(auxs)}
    if cd is not None:
        # bfloat16 rounds at different places in the two packages (the JAX
        # package sums gradients in bfloat16, test_torch_fused.py): held
        # within twice the largest move the JAX package's own bfloat16 step
        # makes from its float32 step on this run
        jf, jfa = _jax_fused(build(J), shapes, label_shapes, opt, opt_params,
                             None, args, auxs, x, y, batch)
        spread = max(float(np.abs(ref[n] - f32[n]).max())
                     for ref, f32 in ((jp, jf), (ja, jfa)) for n in ref)
        jtol = {n: 2 * spread for n in jtol}
    for n in args:
        np.testing.assert_allclose(saved["arg:" + n], tp[n], atol=1e-6, rtol=0,
                                   err_msg=n)
        np.testing.assert_allclose(saved["arg:" + n], jp[n], atol=jtol[n],
                                   rtol=1e-4, err_msg=n)
    for n in auxs:
        np.testing.assert_allclose(saved["aux:" + n], ta[n], atol=1e-6, rtol=0,
                                   err_msg=n)
        np.testing.assert_allclose(saved["aux:" + n], ja[n], atol=jtol[n],
                                   rtol=1e-4, err_msg=n)
        assert np.abs(saved["aux:" + n] - auxs[n]).max() > 1e-4  # carried


@needs_gcc
def test_c_client_trains_mlp_past_90_percent(clients, tmp_path):
    """The JAX package's headline check on its runtime, on the port's: a C
    process trains the MLP from Xavier to >90 % train accuracy and its
    checkpoint scores that in the port's Module."""
    net = mlp(T, 32, 3)
    batch = 32
    path = str(tmp_path / "mlp.mxa")
    T.export_train_artifact(net, {"data": (batch, 8)}, path, optimizer="sgd",
                            optimizer_params={"learning_rate": 0.02,
                                              "momentum": 0.9},
                            platform="cpu", seed=3)
    x, y = _blobs(128, 8, 5)
    x.tofile(str(tmp_path / "data.f32"))
    y.tofile(str(tmp_path / "labels.f32"))
    out = str(tmp_path / "trained.params")
    r = _run([clients["train"], path, str(tmp_path / "data.f32"),
              str(tmp_path / "labels.f32"), str(batch), "200", "0.02", out,
              str(tmp_path / "loss.txt")])
    assert r.returncode == 0, r.stdout + r.stderr
    losses = [float(line.split()[1]) for line in open(tmp_path / "loss.txt")]
    assert losses[-1] < losses[0] * 0.1, losses
    saved = T.nd.load(out)
    with T.cpu():
        mod = T.mod.Module(net, label_names=["softmax_label"], context=T.cpu())
        mod.bind(data_shapes=[("data", (batch, 8))],
                 label_shapes=[("softmax_label", (batch,))], for_training=False)
        mod.set_params({k[4:]: v for k, v in saved.items()}, {})
        correct = 0
        for i in range(0, len(x), batch):
            b = T.io.DataBatch(data=[T.nd.array(x[i:i + batch], ctx=T.cpu())],
                               label=[])
            mod.forward(b, is_train=False)
            pred = mod.get_outputs()[0].asnumpy().argmax(axis=1)
            correct += (pred == y[i:i + batch]).sum()
    assert correct / len(x) > 0.9


@needs_gcc
def test_dropout_step_replays_from_its_seed(clients, tmp_path):
    """A stochastic train artifact draws its masks from a generator seeded
    with ``seed + t``: two runs of the same artifact save the same
    parameters, an artifact with another seed others (C34: not the JAX
    package's bits)."""
    net = dropout_mlp(T)
    batch = 16
    args, _ = _params_of(net, {"data": (batch, 8)}, 22, scale=0.3)
    x, y = _blobs(batch * 3, 8, 6)
    x.tofile(str(tmp_path / "data.f32"))
    y.tofile(str(tmp_path / "labels.f32"))
    saved = {}
    for run, seed in (("a", 4), ("b", 4), ("c", 5)):
        path = str(tmp_path / ("d%s.mxa" % run))
        m = T.export_train_artifact(net, {"data": (batch, 8)}, path,
                                    optimizer="sgd",
                                    optimizer_params={"learning_rate": 0.1},
                                    arg_params=args, platform="cpu", seed=seed)
        assert [a["kept"] for a in m["args"] if a["role"] == "t"] == [True]
        out = str(tmp_path / ("%s.params" % run))
        r = _run([clients["train"], path, str(tmp_path / "data.f32"),
                  str(tmp_path / "labels.f32"), str(batch), "3", "0.1", out,
                  str(tmp_path / "loss.txt")])
        assert r.returncode == 0, r.stdout + r.stderr
        saved[run] = {k: v.asnumpy() for k, v in T.nd.load(out).items()}
    assert all(np.array_equal(saved["a"][k], saved["b"][k]) for k in saved["a"])
    assert any(not np.array_equal(saved["a"][k], saved["c"][k])
               for k in saved["a"])


# ---- tools/export_model.py --------------------------------------------------------
def test_export_model_tool_both_subcommands(tmp_path, monkeypatch, capsys):
    """Both subcommands on a saved checkpoint, in this process (the tool's
    ``main``), with the platform of the current device."""
    from mxnet_tpu_torch.tools import export_model

    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    build, shapes, args, _ = _case("mlp")
    prefix = str(tmp_path / "model")
    with T.cpu():
        T.model.save_checkpoint(prefix, 3, build(T),
                                {k: T.nd.array(v, ctx=T.cpu())
                                 for k, v in args.items()}, {})
    pout = str(tmp_path / "p.mxa")
    export_model.main(["predict", "--prefix", prefix, "--epoch", "3",
                       "--shape", "data:2,8", "--out", pout])
    summary = json.loads(capsys.readouterr().out)
    assert summary["kind"] == "predict" and summary["platform"] == "cpu"
    assert summary["inputs"] == ["data", "softmax_label"]
    tout = str(tmp_path / "t.mxa")
    export_model.main(["train", "--symbol", prefix + "-symbol.json",
                       "--shape", "data:8,8", "--optimizer", "adam",
                       "--lr", "0.01", "--out", tout])
    summary = json.loads(capsys.readouterr().out)
    assert summary["optimizer"] == "Adam" and summary["state_slots"] == 8
    m, _, _ = T.export_artifact.load_artifact_manifest(tout)
    assert m["kind"] == "train" and m["platform"] == "cpu"
    with pytest.raises(SystemExit, match="--bf16"):
        export_model.main(["predict", "--prefix", prefix, "--epoch", "3",
                           "--shape", "data:2,8", "--out", pout, "--bf16"])


# ---- the runtime's rules beyond SGD and Adam -------------------------------------
RULES = {
    # name: (optimizer, params): each of fused_opt's rules the runtime gained
    "nag": ("nag", {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-3}),
    "adagrad": ("adagrad", {"learning_rate": 0.05, "clip_gradient": 0.5}),
    "rmsprop": ("rmsprop", {"learning_rate": 0.01, "wd": 1e-3}),
    "rmsprop_centered": ("rmsprop", {"learning_rate": 0.01, "centered": True,
                                     "clip_weights": 0.5,
                                     "rescale_grad": 0.5}),
    "adadelta": ("adadelta", {"learning_rate": 1.0, "wd": 1e-3}),
    "ftrl": ("ftrl", {"learning_rate": 0.1, "lamda1": 0.01}),
}
RULE_STEPS = 3


def _train_native_in_process(lib, path, batches, lr, tmp_path):
    """The runtime's steps through ctypes in this process: the parameters
    saved after each (``MXTrainNativeSaveParams``)."""
    h = ctypes.c_void_p()
    assert lib.MXTrainNativeCreateFromFile(path.encode(), ctypes.byref(h)) == 0, \
        lib.MXGetLastError()
    after = []
    for x, y in batches:
        for name, v in ((b"data", x), (b"softmax_label", y)):
            arr, ptr = _cfloat(v)
            assert lib.MXTrainNativeSetInput(h, name, ptr, arr.size) == 0, \
                lib.MXGetLastError()
        assert lib.MXTrainNativeStep(h, ctypes.c_float(lr)) == 0, \
            lib.MXGetLastError()
        out = str(tmp_path / "step.params")
        assert lib.MXTrainNativeSaveParams(h, out.encode()) == 0
        after.append({k[4:]: v.asnumpy() for k, v in T.nd.load(out).items()
                      if k.startswith("arg:")})
    assert lib.MXTrainNativeFree(h) == 0
    return after


def _fused_per_step(net, shapes, opt, opt_params, args, batches):
    """The port's SPMDTrainer on the CPU over the same batches: the
    parameters after each step."""
    import torch

    from mxnet_tpu_torch.parallel.spmd import SPMDTrainer

    pnames = [n for n in net.list_arguments() if n not in shapes]
    optimizer = T.optimizer.create(opt, sym=net,
                                   param_idx2name={n: n for n in pnames},
                                   **opt_params)
    tr = SPMDTrainer(net, "cpu", [("data", shapes["data"])], optimizer,
                     label_shapes=[("softmax_label", shapes["softmax_label"])])
    params = {n: torch.tensor(args[n]) for n in tr.param_names}
    states = tr.init_opt_state()
    buf = tr.input_buffers()
    after = []
    for x, y in batches:
        buf["data"].copy_(torch.tensor(x))
        buf["softmax_label"].copy_(torch.tensor(y))
        tr.step(params, {}, states)
        after.append({n: v.numpy().copy() for n, v in params.items()})
    return after


@pytest.mark.parametrize("name", sorted(RULES))
def test_runtime_rules_step_as_the_fused_step(name, tmp_path, monkeypatch):
    """Three steps of the small LM's train artifact under each of NAG,
    AdaGrad, RMSProp (plain and centered), AdaDelta and Ftrl, through the
    runtime in this process, against the port's fused step over the same
    batches: every parameter within 1e-6 after every step."""
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    opt, opt_params = RULES[name]
    lr = float(np.float32(opt_params["learning_rate"]))
    opt_params = dict(opt_params, learning_rate=lr)
    batch = 4
    shapes = {"data": (batch, LM["seq_len"]),
              "softmax_label": (batch, LM["seq_len"])}
    net = lm(T)
    args, _ = _params_of(net, shapes, 31, scale=0.1)
    path = str(tmp_path / "t.mxa")
    m = T.export_train_artifact(net, shapes, path, optimizer=opt,
                                optimizer_params=opt_params, arg_params=args,
                                platform="cpu")
    rule = T.parallel.fused_opt.make_rule(T.optimizer.create(opt, **opt_params))
    assert m["nslot"] == rule.nslot
    x, y = _train_data("lm", batch, RULE_STEPS)
    batches = [(x[s * batch:(s + 1) * batch], y[s * batch:(s + 1) * batch])
               for s in range(RULE_STEPS)]
    got = _train_native_in_process(P.load(), path, batches, lr, tmp_path)
    want = _fused_per_step(net, shapes, opt, opt_params, args, batches)
    for s in range(RULE_STEPS):
        for n in args:
            np.testing.assert_allclose(got[s][n], want[s][n], atol=1e-6,
                                       rtol=0, err_msg="step %d %s" % (s + 1, n))
    assert any(np.abs(got[-1][n] - args[n]).max() > 1e-5 for n in args)


def test_runtime_refuses_a_rule_the_fused_step_lacks(tmp_path, monkeypatch):
    """An artifact whose manifest names an optimizer with no fused rule
    (SGLD: ``fused_opt.make_rule`` refuses it, so no exporter writes one)
    fails at create, naming it."""
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    with pytest.raises(ValueError, match="SGLD"):
        T.parallel.fused_opt.make_rule(T.optimizer.create("sgld"))
    path = str(tmp_path / "ok.mxa")
    T.export_train_artifact(mlp(T), {"data": (8, 8)}, path, optimizer="sgd",
                            optimizer_params={"learning_rate": 0.1},
                            platform="cpu")
    raw = open(path, "rb").read()
    (mlen,) = struct.unpack("<Q", raw[8:16])
    manifest = json.loads(raw[16:16 + mlen].decode())
    manifest["optimizer"] = "SGLD"
    mjs = json.dumps(manifest, indent=1).encode()
    bad = str(tmp_path / "sgld.mxa")
    with open(bad, "wb") as f:
        f.write(raw[:8] + struct.pack("<Q", len(mjs)) + mjs + raw[16 + mlen:])
    lib = P.load()
    h = ctypes.c_void_p()
    assert lib.MXTrainNativeCreateFromFile(bad.encode(), ctypes.byref(h)) == -1
    assert b"'SGLD' has no fused rule" in lib.MXGetLastError()
