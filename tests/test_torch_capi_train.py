"""The port's training C API (``mxnet_tpu_torch/capi_train.py`` behind
``csrc/capi/c_api_train.cc``) driven by compiled C++ trainers on the CPU.

The clients compile unchanged against the port's headers and library:
the C++ trainer, kvstore and data-iterator clients of
``tests/test_cpp_package.py`` and the C trainer of ``tests/test_c_train.py``
(imported, not copied), ``examples/cpp/lenet.cpp``, and the port's
``csrc/capi/clients/lm_trainer.cpp`` (the Transformer-LM through
``mxnet_cpp.hpp``). Each runs in a process of its own with
``MXNET_DEFAULT_CONTEXT=cpu``; what it writes is read by the JAX package
in this process and held to the JAX package's own forward, gradients and
scores on the same inputs.
"""
import importlib
import os

import numpy as np
import pytest

import mxnet_tpu as J
import mxnet_tpu_torch as T
from test_torch_capi import compile_clients, reference, run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIENTS = os.path.join(ROOT, "mxnet_tpu_torch", "csrc", "capi", "clients")
RTOL = 1e-5
ATOL = 1e-6
LM = dict(vocab_size=64, num_layers=2, model_dim=32, num_heads=2, ffn_dim=64,
          seq_len=16)


@pytest.fixture(scope="module")
def exes(tmp_path_factory):
    cp, ct = reference("test_cpp_package"), reference("test_c_train")
    return compile_clients(str(tmp_path_factory.mktemp("capi_train")), {
        "cpp_trainer": (cp.TRAINER_CPP, "c++"),
        "cpp_kvstore": (cp.KVSTORE_CPP, "c++"),
        "cpp_dataiter": (cp.DATAITER_CPP, "c++"),
        "c_trainer": (ct.TRAINER_CPP, "c++"),
        "lenet": (os.path.join(ROOT, "examples", "cpp", "lenet.cpp"), "c++"),
        "lm_trainer": (os.path.join(CLIENTS, "lm_trainer.cpp"), "c++")})


def _outputs_match(sym_path, params_path, data_shape, label_shape, x):
    """The forward of a C-trained checkpoint in both packages on the CPU:
    returns the JAX package's outputs after holding the port's to them."""
    outs = []
    for M, ctx in ((J, J.cpu()), (T, T.cpu())):
        sym = M.sym.load(sym_path)
        loaded = M.nd.load(params_path)
        args = {k[4:]: v for k, v in loaded.items() if k.startswith("arg:")}
        mod = M.mod.Module(sym, context=ctx)
        mod.bind(data_shapes=[("data", data_shape)],
                 label_shapes=[("softmax_label", label_shape)],
                 for_training=False)
        mod.set_params(args, {})
        mod.forward(M.io.DataBatch([M.nd.array(x, ctx=ctx)], None),
                    is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)
    return outs[0]


def test_cpp_trainer_interchanges_with_jax(exes, tmp_path):
    """``test_cpp_package.py``'s conv net, built and trained in C++ with the
    momentum optimizer; the JAX package loads its checkpoint and scores the
    same task, and the port's forward of it equals the JAX package's."""
    sym_path = str(tmp_path / "cppnet-symbol.json")
    params_path = str(tmp_path / "cppnet-0001.params")
    r = run(exes["cpp_trainer"], sym_path, params_path)
    assert r.returncode == 0, (r.stdout, r.stderr)
    out = dict(zip(r.stdout.split()[::2], r.stdout.split()[1::2]))
    assert int(out["NARGS"]) == 8 and int(out["LOADED"]) == 6
    assert float(out["ACC"]) > 0.9
    loaded = J.nd.load(params_path)
    assert {k[4:] for k in loaded if k.startswith("arg:")} == {
        "conv1_weight", "conv1_bias", "fc1_weight", "fc1_bias",
        "fc2_weight", "fc2_bias"}
    # the task of test_cpp_package.py's re-score
    rng = np.random.RandomState(7)
    X = rng.uniform(-1, 1, size=(32, 1, 8, 8)).astype(np.float32)
    Y = (rng.uniform(size=32) > 0.5).astype(np.float32)
    flat = X.reshape(32, 64)
    flat[np.arange(32)[Y > 0.5][:, None], np.arange(32)[None, :]] += 0.4
    flat[np.arange(32)[Y < 0.5][:, None], 32 + np.arange(32)[None, :]] += 0.4
    prob = _outputs_match(sym_path, params_path, (32, 1, 8, 8), (32,), X)
    assert (prob.argmax(1) == Y).mean() > 0.85


def test_cpp_kvstore_and_dataiter(exes, tmp_path):
    """``test_cpp_package.py``'s kvstore client (the pulled value is the
    last push, as the JAX package's local store gives) and its CSVIter
    client (3 batches of 3 over 8 rows, the last padded by 1, as the JAX
    package's CSVIter)."""
    r = run(exes["cpp_kvstore"])
    assert r.returncode == 0, (r.stdout, r.stderr)
    assert "RANK 0 SIZE 1" in r.stdout and "OK" in r.stdout
    kv = J.kv.create("local")
    kv.init(9, J.nd.ones((4, 3)))
    a = J.nd.array(np.arange(12, dtype=np.float32).reshape(4, 3) * 0.5)
    kv.push(9, a)
    out = J.nd.zeros((4, 3))
    kv.pull(9, out=out)
    np.testing.assert_allclose(out.asnumpy(), a.asnumpy())

    rows = np.arange(32, dtype=np.float32).reshape(8, 4)
    data_csv, label_csv = tmp_path / "data.csv", tmp_path / "label.csv"
    np.savetxt(data_csv, rows, delimiter=",", fmt="%.1f")
    np.savetxt(label_csv, np.arange(8, dtype=np.float32), delimiter=",",
               fmt="%.1f")
    r = run(exes["cpp_dataiter"], data_csv, label_csv)
    assert r.returncode == 0, (r.stdout, r.stderr)
    it = J.io.CSVIter(data_csv=str(data_csv), label_csv=str(label_csv),
                      data_shape=(4,), batch_size=3, round_batch=True)
    batches = list(it)
    assert "BATCHES %d PAD %d" % (len(batches), batches[-1].pad) in r.stdout
    assert "RESET-OK" in r.stdout


def test_c_trainer_json_symbol(exes, tmp_path):
    """``test_c_train.py``'s C++ trainer over a symbol JSON the JAX package
    wrote: 6 arguments, over 90 % training accuracy."""
    net = J.sym.FullyConnected(J.sym.Variable("data"), num_hidden=16,
                               name="fc1")
    net = J.sym.Activation(net, act_type="relu")
    net = J.sym.FullyConnected(net, num_hidden=2, name="fc2")
    net = J.sym.SoftmaxOutput(net, name="softmax")
    sym_file = tmp_path / "mlp-symbol.json"
    sym_file.write_text(net.tojson())
    r = run(exes["c_trainer"], sym_file)
    assert r.returncode == 0, (r.stdout, r.stderr)
    words = r.stdout.split()
    assert words[0] == "ARGS" and int(words[1]) == len(net.list_arguments())
    assert float(words[3]) > 0.90, r.stdout


def test_lenet_example(exes, tmp_path):
    """``examples/cpp/lenet.cpp`` as shipped: it trains, and the checkpoint
    it writes in its working directory forwards alike in both packages."""
    r = run(exes["lenet"], cwd=tmp_path)
    assert r.returncode == 0, (r.stdout, r.stderr)
    acc = float(r.stdout.split("train accuracy (last 10 batches):")[1].split()[0])
    assert acc > 0.9, r.stdout
    x = np.random.RandomState(5).uniform(0, 1, (8, 1, 16, 16)).astype(
        np.float32)
    prob = _outputs_match(str(tmp_path / "lenet-symbol.json"),
                          str(tmp_path / "lenet-0001.params"),
                          (8, 1, 16, 16), (8,), x)
    assert prob.shape == (8, 10)


def test_lm_trainer_matches_jax(exes, tmp_path):
    """``csrc/capi/clients/lm_trainer.cpp`` (the phase-26 trainer) on a small
    Transformer-LM on the CPU: step 1's gradients against the JAX
    package's executor and the port's Python executor on the same
    parameters and batch; the loss falls over 20 SGD steps."""
    lm = importlib.import_module("mxnet_tpu.models.transformer_lm")
    B, S = 4, LM["seq_len"]
    net = lm.get_symbol(**LM)
    ex = net.simple_bind(J.cpu(), grad_req="write", data=(B, S),
                         softmax_label=(B, S))
    rng = np.random.RandomState(8)
    init = {k: rng.uniform(-0.3, 0.3, v.shape).astype(np.float32)
            for k, v in ex.arg_dict.items()
            if k not in ("data", "softmax_label")}
    X = rng.randint(0, LM["vocab_size"], (B, S)).astype(np.float32)
    Y = ((X + 1) % LM["vocab_size"]).astype(np.float32)
    J.nd.save(str(tmp_path / "init.params"),
              {"arg:" + k: J.nd.array(v) for k, v in init.items()})
    (tmp_path / "lm-symbol.json").write_text(net.tojson())
    X.tofile(tmp_path / "data.f32")
    Y.tofile(tmp_path / "label.f32")
    r = run(exes["lm_trainer"], tmp_path / "lm-symbol.json",
            tmp_path / "init.params", tmp_path / "data.f32",
            tmp_path / "label.f32", B, S, 20, 0.01, "cpu",
            tmp_path / "grads.params")
    assert r.returncode == 0, (r.stdout, r.stderr)
    loss = {int(l.split()[1]): float(l.split()[2])
            for l in r.stdout.splitlines() if l.startswith("LOSS")}
    assert sorted(loss) == [1, 20] and loss[20] < loss[1], r.stdout
    got = J.nd.load(str(tmp_path / "grads.params"))
    assert sorted(got) == sorted("grad:" + k for k in init)

    for k, v in init.items():
        ex.arg_dict[k][:] = v
    ex.arg_dict["data"][:] = X
    ex.arg_dict["softmax_label"][:] = Y
    prob = ex.forward(is_train=True)[0].asnumpy()
    ex.backward()
    want_loss = float(-np.log(prob[np.arange(B * S), Y.ravel().astype(int)])
                      .mean())
    assert abs(loss[1] - want_loss) <= 1e-5 * abs(want_loss)
    tex = T.sym.load(str(tmp_path / "lm-symbol.json")).simple_bind(
        T.cpu(), grad_req="write", data=(B, S), softmax_label=(B, S))
    for k, v in init.items():
        tex.arg_dict[k][:] = v
    tex.arg_dict["data"][:] = X
    tex.arg_dict["softmax_label"][:] = Y
    tex.forward(is_train=True)
    tex.backward()
    for k in init:
        g = got["grad:" + k].asnumpy()
        # the port's own executor in this process: the same arithmetic
        np.testing.assert_array_equal(g, tex.grad_dict[k].asnumpy().ravel())
        want = ex.grad_dict[k].asnumpy().ravel()
        scale = np.abs(want).max()
        assert np.abs(g - want).max() <= 1e-4 * scale + 1e-7, k
