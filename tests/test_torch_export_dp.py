"""The data-parallel train artifact (``export_train_artifact(num_devices=N)``
and the runtime's step over N positions, ``csrc/native_rt/dp.cc``) and
``Executor.reshape``, held against the JAX package (its dp export and
runtime, its ``SPMDTrainer`` over a dp mesh of its virtual CPU devices) and
the port's own one-position artifact and data-parallel ``SPMDTrainer``.

The positions lie on the CPU here (``MXNET_DEFAULT_CONTEXT=cpu``; C37:
positions of one device are distinct positions). Tolerances: the JAX
package's own bound for dp 8 against one device, 1e-5; the port's
``SPMDTrainer`` at the same dp 1e-6 (the same ATen calls in the same order,
bitwise so far on the CPU); dp 2 against dp 1 with the same masks 1e-6 of
each tensor's largest (each position multiplies half the rows, so the sums
round otherwise); BatchNorm's global statistics 1e-5.
"""
import ctypes
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as J
import mxnet_tpu_torch as T
from mxnet_tpu_torch import _predict_native as P

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_train_native_spmd as jspmd  # noqa: E402
from test_torch_export_artifact import (  # noqa: E402,F401 — fixtures
    _blobs, _cfloat, _params_of, _run, _sections, _train_native_in_process,
    clients, conv_bn, dropout_mlp, native, needs_gcc)

LM = dict(vocab_size=64, num_layers=2, model_dim=32, num_heads=2, ffn_dim=64,
          seq_len=16)
MLP_OPT = {"learning_rate": 0.1, "momentum": 0.9}


@pytest.fixture(autouse=True)
def _cpu_positions(monkeypatch):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")


def _export_mlp(mx, path, n):
    """tests/test_train_native_spmd.py's export, through package ``mx``."""
    return mx.export_train_artifact(
        jspmd._mlp() if mx is J else _port_mlp(), {"data": (32, 8)}, path,
        optimizer="sgd", optimizer_params=MLP_OPT, platform="cpu", seed=3,
        num_devices=n, arg_params=jspmd._shared_params())


def _port_mlp():
    data = T.sym.Variable("data")
    net = T.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = T.sym.Activation(net, act_type="relu")
    net = T.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return T.sym.SoftmaxOutput(net, name="softmax")


def _program(path):
    raw = open(path, "rb").read()
    off = 16 + struct.unpack("<Q", raw[8:16])[0]
    (plen,) = struct.unpack("<Q", raw[off:off + 8])
    return json.loads(raw[off + 8:off + 8 + plen])


def _rewrite_manifest(path, out, edit):
    raw = open(path, "rb").read()
    (mlen,) = struct.unpack("<Q", raw[8:16])
    manifest = json.loads(raw[16:16 + mlen].decode())
    edit(manifest)
    mjs = json.dumps(manifest, indent=1).encode()
    with open(out, "wb") as f:
        f.write(raw[:8] + struct.pack("<Q", len(mjs)) + mjs + raw[16 + mlen:])


def _mlp_batches():
    """_run_steps' batch: the same one every step."""
    rs = np.random.RandomState(0)
    x = rs.randn(32, 8).astype(np.float32)
    y = (np.arange(32) % 3).astype(np.float32)
    return [(x, y)] * 3


def _worst_of_largest(got, want):
    return max(float(np.abs(got[n] - want[n]).max())
               / max(float(np.abs(want[n]).max()), 1e-30) for n in want)


# ---- the manifest --------------------------------------------------------------
def test_dp_manifest_is_the_jax_packages(tmp_path):
    """The same keys but ``compile_options`` (XLA's, C34), the same
    role/shape/sharding/kept of every arg and output, and a params section
    byte-equal to the JAX package's dp 8 export and to the port's dp 1
    export; the program carries each node's form and batch axes."""
    tp, jp, t1 = (str(tmp_path / n) for n in ("t.mxa", "j.mxa", "t1.mxa"))
    mt = _export_mlp(T, tp, 8)
    mj = _export_mlp(J, jp, 8)
    _export_mlp(T, t1, 1)
    port_only = {"program_format", "optimizer_params"}
    assert set(mt) - port_only == set(mj) - {"compile_options"}
    for k in set(mt) - port_only - {"args", "outputs"}:
        assert mt[k] == mj[k], k
    fields = ("name", "role", "shape", "dtype", "sharding", "kept", "donated")
    for rows in ("args", "outputs"):
        assert [[r.get(f) for f in fields] for r in mt[rows]] == \
            [[r.get(f) for f in fields] for r in mj[rows]], rows
    tags = {a["role"]: a["sharding"] for a in mt["args"]}
    assert tags == {"param": "rep", "state": "rep", "data": "batch",
                    "label": "batch", "lr": "rep", "t": "rep"}
    assert {o["name"]: o["sharding"] for o in mt["outputs"]}[
        "softmax_output"] == "batch"
    assert _sections(tp)[1] == _sections(jp)[1] == _sections(t1)[1]
    plan = _program(tp)["dp"]
    nodes = _program(tp)["nodes"]
    assert plan["num_devices"] == 8 and len(plan["forms"]) == len(nodes)
    forms = {n["name"]: f for n, f in zip(nodes, plan["forms"])}
    assert forms["softmax"] == "dp" and forms["fc1"] == "local"
    assert forms["data"] is None
    assert "dp" not in _program(t1)


def test_dp_export_refusals(tmp_path):
    """A batch the positions do not divide (both packages' ValueError), and
    an op ``parallel/dp.py`` refuses, named with its node before any
    initializer draws."""
    for mx, net in ((T, _port_mlp()), (J, jspmd._mlp())):
        with pytest.raises(ValueError, match="divide"):
            mx.export_train_artifact(net, {"data": (30, 8)},
                                     str(tmp_path / "bad.mxa"),
                                     optimizer="sgd", platform="cpu",
                                     num_devices=8)
    data = T.sym.Variable("data")
    fc = T.sym.FullyConnected(data, num_hidden=4, name="fc")
    net = T.sym.MakeLoss(T.sym.sum(fc, name="total"), name="loss")
    state = torch.random.get_rng_state()
    with pytest.raises(T.MXNetError, match=r"op sum \(node total\).*reduces "
                       "over the batch axis"):
        T.export_train_artifact(net, {"data": (8, 3)},
                                str(tmp_path / "sum.mxa"), platform="cpu",
                                num_devices=2)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert not os.path.exists(str(tmp_path / "sum.mxa"))


# ---- training --------------------------------------------------------------------
def test_dp8_mlp_trains_as_dp1_and_as_the_jax_dp8_run(tmp_path):
    """Three steps of the dp 8 MLP through the runtime on eight CPU
    positions: within 1e-5 of the port's dp 1 artifact and of the JAX
    package's dp 8 artifact run as its own test runs it."""
    lib = P.load()
    paths = {n: str(tmp_path / ("t%d.mxa" % n)) for n in (1, 8)}
    for n, path in paths.items():
        _export_mlp(T, path, n)
    got = {n: _train_native_in_process(lib, path, _mlp_batches(), 0.1,
                                       tmp_path)[-1]
           for n, path in paths.items()}
    for name in got[1]:
        np.testing.assert_allclose(got[8][name], got[1][name], atol=1e-5,
                                   rtol=0, err_msg=name)
    jp = str(tmp_path / "j8.mxa")
    man = _export_mlp(J, jp, 8)
    carry = jspmd._run_steps(jp, 8)
    for a, v in zip(man["args"], carry):
        if a["role"] == "param":
            np.testing.assert_allclose(got[8][a["name"]], v, atol=1e-5,
                                       rtol=0, err_msg=a["name"])


def _spmd_steps(net, shapes, args, auxs, batches, n, opt, opt_params):
    """The port's SPMDTrainer over ``n`` CPU positions: (params, auxs)
    after the last batch."""
    from mxnet_tpu_torch.parallel import build_mesh
    from mxnet_tpu_torch.parallel.spmd import SPMDTrainer

    with T.cpu():
        mesh = build_mesh({"dp": n})
    tr = SPMDTrainer(net, mesh, [("data", shapes["data"])], opt,
                     dict(opt_params),
                     label_shapes=[("softmax_label", shapes["softmax_label"])])
    params = tr.place({k: torch.tensor(args[k]) for k in tr.param_names})
    tauxs = tr.place({k: torch.tensor(auxs[k]) for k in tr.aux_names})
    states = tr.init_opt_state()
    buf = tr.input_buffers()
    for x, y in batches:
        buf["data"].copy_(torch.tensor(x))
        buf["softmax_label"].copy_(torch.tensor(y.reshape(shapes["softmax_label"])))
        tr.step(params, tauxs, states)
    return ({k: tr.gather(k, v).numpy() for k, v in params.items()},
            {k: tr.gather(k, v).numpy() for k, v in tauxs.items()})


def _jax_spmd_steps(net, shapes, args, auxs, batches, n, opt, opt_params):
    """The JAX package's SPMDTrainer over a dp ``n`` mesh of its virtual CPU
    devices (``net`` its symbol): (params, auxs) after the last batch."""
    import jax

    from mxnet_tpu.parallel import build_mesh
    from mxnet_tpu.parallel.spmd import SPMDTrainer

    with jax.default_matmul_precision("highest"):
        tr = SPMDTrainer(net, build_mesh({"dp": n}, jax.devices("cpu")[:n]),
                         data_shapes=[("data", shapes["data"])],
                         label_shapes=[("softmax_label",
                                        shapes["softmax_label"])],
                         optimizer=opt, optimizer_params=dict(opt_params))
        params = {k: jax.device_put(args[k], tr.param_shardings[k])
                  for k in tr.param_names}
        jauxs = {k: jax.device_put(auxs[k], tr.repl) for k in tr.aux_names}
        states = tr.init_opt_state()
        for x, y in batches:
            params, jauxs, states, _ = tr.step(
                params, jauxs, states,
                {"data": x, "softmax_label": y.reshape(shapes["softmax_label"])})
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in jauxs.items()})


def _runtime_steps(path, batches, lr, tmp_path):
    """(params, auxs) the runtime saves after ``batches``."""
    lib = P.load()
    h = ctypes.c_void_p()
    assert lib.MXTrainNativeCreateFromFile(path.encode(), ctypes.byref(h)) == 0, \
        lib.MXGetLastError()
    for x, y in batches:
        for name, v in ((b"data", x), (b"softmax_label", y)):
            arr, ptr = _cfloat(v)
            assert lib.MXTrainNativeSetInput(h, name, ptr, arr.size) == 0, \
                lib.MXGetLastError()
        assert lib.MXTrainNativeStep(h, ctypes.c_float(lr)) == 0, \
            lib.MXGetLastError()
    out = str(tmp_path / "saved.params")
    assert lib.MXTrainNativeSaveParams(h, out.encode()) == 0
    assert lib.MXTrainNativeFree(h) == 0
    saved = {k: v.asnumpy() for k, v in T.nd.load(out).items()}
    return ({k[4:]: v for k, v in saved.items() if k.startswith("arg:")},
            {k[4:]: v for k, v in saved.items() if k.startswith("aux:")})


def _conv_batches(batch, steps):
    x, y = _blobs(batch * steps, 8, 4)
    xi = np.stack([np.roll(x, r, axis=1) for r in range(8)], axis=1)[:, None]
    return [(xi[s * batch:(s + 1) * batch], y[s * batch:(s + 1) * batch])
            for s in range(steps)]


def test_batchnorm_at_dp2_takes_the_global_statistics(tmp_path):
    """A conv + BatchNorm net at dp 2: parameters and moving statistics
    within 1e-5 of dp 1's and of the JAX package's SPMDTrainer over a dp 2
    mesh, and equal to the port's SPMDTrainer dp 2's (1e-6); statistics of
    one position's block alone would move the moving statistics more than
    ten times that bound away."""
    net = conv_bn(T, fix_gamma=False)
    shapes = {"data": (16, 1, 8, 8), "softmax_label": (16,)}
    args, auxs = _params_of(net, shapes, 5)
    batches = _conv_batches(16, 2)
    opt = {"learning_rate": 0.1}
    got = {}
    for n in (1, 2):
        path = str(tmp_path / ("c%d.mxa" % n))
        T.export_train_artifact(net, {"data": shapes["data"]}, path,
                                optimizer="sgd", optimizer_params=opt,
                                platform="cpu", arg_params=args,
                                aux_params=auxs, num_devices=n)
        got[n] = _runtime_steps(path, batches, 0.1, tmp_path)
    want = _spmd_steps(net, shapes, args, auxs, batches, 2, "sgd", opt)
    jax_want = _jax_spmd_steps(conv_bn(J, fix_gamma=False), shapes, args,
                               auxs, batches, 2, "sgd", opt)
    for k in (0, 1):
        assert set(got[2][k]) == set(jax_want[k])
        for name in got[1][k]:
            np.testing.assert_allclose(got[2][k][name], got[1][k][name],
                                       atol=1e-5, rtol=0, err_msg=name)
            np.testing.assert_allclose(got[2][k][name], jax_want[k][name],
                                       atol=1e-5, rtol=0, err_msg=name)
            np.testing.assert_allclose(got[2][k][name], want[k][name],
                                       atol=1e-6, rtol=0, err_msg=name)
    # one position's block through a one-position artifact of its size
    half = str(tmp_path / "half.mxa")
    T.export_train_artifact(net, {"data": (8, 1, 8, 8)}, half,
                            optimizer="sgd", optimizer_params=opt,
                            platform="cpu", arg_params=args, aux_params=auxs)
    block = _runtime_steps(half, [(x[:8], y[:8]) for x, y in batches[:1]],
                           0.1, tmp_path)
    first = _runtime_steps(str(tmp_path / "c2.mxa"), batches[:1], 0.1,
                           tmp_path)
    # ten times the bound above: the check can tell the two apart
    assert max(float(np.abs(block[1][n] - first[1][n]).max())
               for n in first[1]) > 1e-4


def test_dropout_at_dp2_draws_dp1s_masks(tmp_path):
    """A Dropout MLP at dp 2: the masks drawn once at position 0 on the
    joined batch from the generator seeded ``seed + t`` are dp 1's, so
    the parameters are dp 1's within 1e-6 of each one's largest; another
    seed's masks part them by far more."""
    net = dropout_mlp(T)
    args, _ = _params_of(net, {"data": (16, 8)}, 22, scale=0.3)
    x, y = _blobs(16 * 3, 8, 6)
    batches = [(x[s * 16:(s + 1) * 16], y[s * 16:(s + 1) * 16])
               for s in range(3)]
    got = {}
    for n, seed in ((1, 4), (2, 4), (2, 5)):
        path = str(tmp_path / ("d%d_%d.mxa" % (n, seed)))
        m = T.export_train_artifact(net, {"data": (16, 8)}, path,
                                    optimizer="sgd",
                                    optimizer_params={"learning_rate": 0.1},
                                    arg_params=args, platform="cpu", seed=seed,
                                    num_devices=n)
        got[(n, seed)] = _runtime_steps(path, batches, 0.1, tmp_path)[0]
    forms = dict(zip([nd["name"] for nd in _program(path)["nodes"]],
                     _program(path)["dp"]["forms"]))
    assert forms["drop"] == "global" and m["num_devices"] == 2
    assert _worst_of_largest(got[(2, 4)], got[(1, 4)]) <= 1e-6
    assert _worst_of_largest(got[(2, 5)], got[(1, 4)]) > 1e-3


def test_lm_at_dp2_is_the_spmd_trainer_at_dp2(tmp_path):
    """The 2-layer d 32 Transformer-LM (the flash op's plain version on the
    CPU) at dp 2, three Adam steps through the runtime: within 1e-6 of the
    port's SPMDTrainer over a dp 2 mesh and within 1e-5 of the JAX
    package's."""
    import importlib

    with T.name.NameManager():
        net = importlib.import_module("mxnet_tpu_torch.models.transformer_lm") \
            .get_symbol(**LM)
    with J.name.NameManager():
        jnet = importlib.import_module("mxnet_tpu.models.transformer_lm") \
            .get_symbol(**LM)
    shapes = {"data": (4, LM["seq_len"]), "softmax_label": (4, LM["seq_len"])}
    args, _ = _params_of(net, shapes, 31, scale=0.1)
    rs = np.random.RandomState(8)
    batches = []
    for _ in range(3):
        x = rs.randint(0, LM["vocab_size"], size=shapes["data"]).astype(np.float32)
        batches.append((x, np.roll(x, -1, axis=1)))
    opt = {"learning_rate": 0.01}
    path = str(tmp_path / "lm.mxa")
    T.export_train_artifact(net, shapes, path, optimizer="adam",
                            optimizer_params=opt, arg_params=args,
                            platform="cpu", num_devices=2)
    got, _ = _runtime_steps(path, batches, 0.01, tmp_path)
    want, _ = _spmd_steps(net, shapes, args, {}, batches, 2, "adam", opt)
    jax_want, _ = _jax_spmd_steps(jnet, shapes, args, {}, batches, 2, "adam",
                                  opt)
    assert set(jax_want) == set(args)
    for name in args:
        np.testing.assert_allclose(got[name], want[name], atol=1e-6, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(got[name], jax_want[name], atol=1e-5,
                                   rtol=0, err_msg=name)
    assert max(float(np.abs(got[n] - args[n]).max()) for n in args) > 1e-3


# ---- refusals -----------------------------------------------------------------------
def test_runtime_refuses_a_crafted_dp_manifest(tmp_path, monkeypatch):
    """A carried arg tagged ``batch``, a batch tag on a dim the positions do
    not divide, a dp manifest over a program with no plan for it: each
    fails at create with the JAX runtime's words; a card asked for with
    none present raises."""
    lib = P.load()
    ok = str(tmp_path / "ok.mxa")
    _export_mlp(T, ok, 2)

    def refused(edit, words, src=ok):
        bad = str(tmp_path / "bad.mxa")
        _rewrite_manifest(src, bad, edit)
        h = ctypes.c_void_p()
        assert lib.MXTrainNativeCreateFromFile(bad.encode(),
                                               ctypes.byref(h)) == -1
        assert words in lib.MXGetLastError().decode()

    def sharded_carry(m):
        next(a for a in m["args"] if a["role"] == "param")["sharding"] = "batch"

    def odd_batch(m):
        next(a for a in m["args"] if a["role"] == "data")["shape"][0] = 31

    refused(sharded_carry, "is sharded; only replicated carry is supported")
    refused(odd_batch, "batch dim does not divide num_devices")
    one = str(tmp_path / "one.mxa")
    _export_mlp(T, one, 1)
    refused(lambda m: m.update(num_devices=2), "carries no data-parallel plan",
            src=one)
    if not torch.cuda.is_available():
        monkeypatch.delenv("MXNET_DEFAULT_CONTEXT")
        h = ctypes.c_void_p()
        assert lib.MXTrainNativeCreateFromFile(ok.encode(),
                                               ctypes.byref(h)) == -1
        assert b"no CUDA device" in lib.MXGetLastError()


# ---- the C client ------------------------------------------------------------------
@needs_gcc
def test_c_client_trains_the_dp8_artifact(clients, tmp_path):
    """The JAX package's own C client, unchanged, trains the dp 8 MLP on
    eight CPU positions (``tests/test_train_native_spmd.py``'s run): the
    loss falls below half its first, and the saved file loads in both
    packages."""
    path = str(tmp_path / "dp8.mxa")
    _export_mlp(T, path, 8)
    rs = np.random.RandomState(11)
    cent = rs.randn(3, 8).astype(np.float32) * 3
    y = (np.arange(128) % 3).astype(np.float32)
    x = (cent[y.astype(int)] + rs.randn(128, 8)).astype(np.float32)
    x.tofile(str(tmp_path / "d.f32"))
    y.tofile(str(tmp_path / "l.f32"))
    out = str(tmp_path / "o.params")
    r = _run([clients["train"], path, str(tmp_path / "d.f32"),
              str(tmp_path / "l.f32"), "32", "300", "0.05", out,
              str(tmp_path / "loss.txt")])
    assert r.returncode == 0, r.stdout + r.stderr
    losses = [float(line.split()[1]) for line in open(tmp_path / "loss.txt")]
    assert losses[-1] < losses[0] * 0.5, losses
    for mx in (T, J):
        saved = mx.nd.load(out)
        assert sorted(saved) == sorted("arg:" + n for n in
                                       jspmd._shared_params())


# ---- tools/export_model.py --------------------------------------------------------
def test_export_model_tool_num_devices(tmp_path, capsys):
    from mxnet_tpu_torch.tools import export_model

    prefix = str(tmp_path / "mlp")
    _port_mlp().save(prefix + "-symbol.json")
    out = str(tmp_path / "t.mxa")
    export_model.main(["train", "--symbol", prefix + "-symbol.json",
                       "--shape", "data:32,8", "--num-devices", "8",
                       "--out", out])
    summary = json.loads(capsys.readouterr().out)
    assert summary["num_devices"] == 8
    m, _, _ = T.export_artifact.load_artifact_manifest(out)
    assert m["num_devices"] == 8 and "dp" in _program(out)
    with pytest.raises(ValueError, match="divide"):
        export_model.main(["train", "--symbol", prefix + "-symbol.json",
                           "--shape", "data:30,8", "--num-devices", "8",
                           "--out", out])


# ---- Executor.reshape ----------------------------------------------------------------
def _reshape_net(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=6, name="fc1")
    net = mx.sym.BatchNorm(net, name="bn", fix_gamma=False)
    net = mx.sym.Activation(net, act_type="tanh")
    net = mx.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _reshaped(mx, ctx, params, auxs, x, y):
    """Bind at batch 8, reshape to batch 4, run forward and backward there:
    (identity of each array, zeros of each new one, outputs, gradients)."""
    ex = _reshape_net(mx).simple_bind(ctx, data=(8, 5))
    for k, v in params.items():
        ex.arg_dict[k][:] = v
    for k, v in auxs.items():
        ex.aux_dict[k][:] = v
    new = ex.reshape(data=(4, 5), softmax_label=(4,))
    same = ([a is b for a, b in zip(ex.arg_arrays, new.arg_arrays)],
            [a is b for a, b in zip(ex.grad_arrays, new.grad_arrays)],
            [a is b for a, b in zip(ex.aux_arrays, new.aux_arrays)])
    zeros = [float(np.abs(new.arg_dict[n].asnumpy()).max())
             for n in ("data", "softmax_label")]
    new.arg_dict["data"][:] = x
    new.arg_dict["softmax_label"][:] = y
    out = new.forward(is_train=True)[0].asnumpy()
    new.backward()
    grads = {n: new.grad_dict[n].asnumpy() for n in params}
    # the shared weight: an update through one executor is the other's
    ex.arg_dict["fc1_weight"][:] = 0.5
    shared = float(new.arg_dict["fc1_weight"].asnumpy().max())
    return same, zeros, out, grads, shared


def test_executor_reshape_is_the_jax_packages():
    """The port's ``Executor.reshape`` against the JAX package's on the same
    seeded inputs: the same arrays shared (the parameters, their gradients
    and the moving statistics), zeros where the shape changed, forward and
    backward at the new shape within 1e-6, and an unusable shape refused."""
    rs = np.random.RandomState(4)
    shapes = {"fc1_weight": (6, 5), "fc1_bias": (6,), "bn_gamma": (6,),
              "bn_beta": (6,), "fc2_weight": (3, 6), "fc2_bias": (3,)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    auxs = {"bn_moving_mean": rs.randn(6).astype(np.float32),
            "bn_moving_var": (1 + rs.rand(6)).astype(np.float32)}
    x = rs.randn(4, 5).astype(np.float32)
    y = np.array([0, 2, 1, 2], np.float32)
    with T.cpu():
        got = _reshaped(T, T.cpu(), params, auxs, x, y)
    want = _reshaped(J, J.cpu(), params, auxs, x, y)
    assert got[0] == want[0]
    assert got[0][0] == [False, True, True, True, True, True, True, False]
    assert got[1] == want[1] == [0.0, 0.0] and got[4] == want[4] == 0.5
    np.testing.assert_allclose(got[2], want[2], atol=1e-6, rtol=0)
    for n in params:
        np.testing.assert_allclose(got[3][n], want[3][n], atol=1e-6, rtol=0,
                                   err_msg=n)
    ex = _reshape_net(T).simple_bind(T.cpu(), data=(8, 5))
    with pytest.raises(T.MXNetError):
        ex.reshape(softmax_label=(4,))
