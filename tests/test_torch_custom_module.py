"""Custom operators, the legacy NumpyOp, SequentialModule and
PythonLossModule of the port against the JAX package: the cases of
``tests/test_custom_op.py`` and the Sequential/Python cases of
``tests/test_module.py``, each run through both packages from the same
seeded parameters and data. Values within 1e-5 (one op), parameters
after a fit within 1e-4 of the largest.
"""
import importlib

import numpy as np
import pytest

import mxnet_tpu as J
import mxnet_tpu_torch as T

PACKAGES = (J, T)
FIT_TOL = 1e-4


def _register_sqr(mx):
    """``sqr_test`` of tests/test_custom_op.py in package ``mx``."""
    mxop = importlib.import_module(mx.__name__ + ".operator")

    class Sqr(mxop.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0].asnumpy() ** 2)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        2 * in_data[0].asnumpy() * out_grad[0].asnumpy())

    @mxop.register("sqr_test")
    class SqrProp(mxop.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return Sqr()

    return mxop


@pytest.fixture(autouse=True)
def _sqr_registered():
    for mx in PACKAGES:
        _register_sqr(mx)


def test_custom_imperative():
    x = np.arange(6).reshape(2, 3).astype(np.float32)
    got = [mx.nd.Custom(mx.nd.array(x, ctx=mx.cpu()), op_type="sqr_test").asnumpy()
           for mx in PACKAGES]
    np.testing.assert_array_equal(got[1], got[0])
    np.testing.assert_allclose(got[1], x ** 2)


def test_custom_symbolic_forward_backward():
    x = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    g = np.random.RandomState(1).rand(3, 4).astype(np.float32)
    res = []
    for mx in PACKAGES:
        y = mx.sym.Custom(mx.sym.Variable("data"), op_type="sqr_test", name="sqr")
        exe = y.simple_bind(ctx=mx.cpu(), data=(3, 4))
        exe.arg_dict["data"][:] = x
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward(out_grads=[mx.nd.array(g, ctx=mx.cpu())])
        res.append((out, exe.grad_dict["data"].asnumpy(), y.tojson()))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-5)
    np.testing.assert_allclose(res[1][1], 2 * x * g, rtol=1e-5)
    np.testing.assert_allclose(res[1][1], res[0][1], rtol=1e-5)
    assert res[1][2] == res[0][2]


def _fit_custom(mx, kvstore):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=6, name="fc")
    net = mx.sym.Custom(net, op_type="sqr_test", name="csqr")
    net = mx.sym.SoftmaxOutput(net, name="softmax")
    rng = np.random.RandomState(3)
    X = rng.rand(20, 5).astype(np.float32)
    y = rng.randint(0, 6, (20,)).astype(np.float32)
    params = {"fc_weight": rng.uniform(-0.1, 0.1, (6, 5)).astype(np.float32),
              "fc_bias": np.zeros(6, np.float32)}
    it = mx.io.NDArrayIter(X, y, batch_size=10)
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.fit(it, num_epoch=2, optimizer="sgd", kvstore=kvstore,
            optimizer_params={"learning_rate": 0.05},
            arg_params={k: mx.nd.array(v, ctx=mx.cpu()) for k, v in params.items()})
    out = mod.predict(it).asnumpy()
    return mod, out, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_custom_in_graph_with_loss_matches_jax():
    _, j_out, j_par = _fit_custom(J, "local")
    mod, t_out, t_par = _fit_custom(T, "device")
    # host Python is never replayed from a captured step: the classic path
    assert mod._fused is None
    assert "Custom" in mod._fused_veto("device")
    assert t_out.shape == (20, 6) and np.isfinite(t_out).all()
    np.testing.assert_allclose(t_out, j_out, rtol=1e-5, atol=1e-6)
    for k in j_par:
        assert np.abs(t_par[k] - j_par[k]).max() <= FIT_TOL * np.abs(j_par[k]).max()


def test_numpy_op_legacy():
    x = np.random.RandomState(1).randn(4, 3).astype(np.float32)
    res = []
    for mx in PACKAGES:
        mxop = importlib.import_module(mx.__name__ + ".operator")

        class MySigmoid(mxop.NumpyOp):
            def __init__(self):
                super().__init__(need_top_grad=True)

            def list_arguments(self):
                return ["data"]

            def list_outputs(self):
                return ["output"]

            def infer_shape(self, in_shape):
                return in_shape, [in_shape[0]]

            def forward(self, in_data, out_data):
                out_data[0][:] = 1.0 / (1.0 + np.exp(-in_data[0]))

            def backward(self, out_grad, in_data, out_data, in_grad):
                y = out_data[0]
                in_grad[0][:] = out_grad[0] * y * (1 - y)

        y = MySigmoid()(mx.sym.Variable("x"), name="mysig")
        exe = y.simple_bind(ctx=mx.cpu(), x=(4, 3))
        exe.arg_dict["x"][:] = x
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward(out_grads=[mx.nd.ones((4, 3), ctx=mx.cpu())])
        res.append((out, exe.grad_dict["x"].asnumpy()))
    np.testing.assert_allclose(res[1][0], 1 / (1 + np.exp(-x)), rtol=1e-5)
    np.testing.assert_allclose(res[1][1], res[1][0] * (1 - res[1][0]), rtol=1e-4)
    for a, b in zip(res[1], res[0]):
        np.testing.assert_allclose(a, b, rtol=1e-5)


def test_custom_registry_listing():
    assert "sqr_test" in T.operator.get_all_registered_operators()
    assert set(J.operator.__all__) == set(T.operator.__all__)


def _toy_data(n=256, d=8, k=3, seed=0):
    r = np.random.RandomState(seed)
    x = r.randn(n, d).astype(np.float32)
    w = r.randn(d, k).astype(np.float32)
    return x, (x @ w).argmax(1).astype(np.float32)


def _seeded(names_shapes, seed):
    r = np.random.RandomState(seed)
    return {n: (r.uniform(-0.3, 0.3, s) if n.endswith("weight") else np.zeros(s)
                ).astype(np.float32) for n, s in names_shapes}


def _sequential(mx):
    sym = mx.sym
    net1 = sym.FullyConnected(sym.Variable("data"), num_hidden=16, name="fc1")
    net1 = sym.Activation(net1, act_type="relu")
    net2 = sym.FullyConnected(sym.Variable("data"), num_hidden=3, name="fc2")
    net2 = sym.SoftmaxOutput(net2, name="softmax")
    smod = mx.mod.SequentialModule()
    smod.add(mx.mod.Module(net1, label_names=None, context=mx.cpu()))
    smod.add(mx.mod.Module(net2, context=mx.cpu()), take_labels=True, auto_wiring=True)
    return smod


def test_sequential_module_fit_matches_jax():
    x, y = _toy_data()
    params = _seeded([("fc1_weight", (16, 8)), ("fc1_bias", (16,)),
                      ("fc2_weight", (3, 16)), ("fc2_bias", (3,))], 7)
    res = []
    for mx in PACKAGES:
        train = mx.io.NDArrayIter(x, y, batch_size=32)
        smod = _sequential(mx)
        smod.bind(train.provide_data, train.provide_label)
        smod.init_params()
        for stage in smod._stages:
            own = stage.module.get_params()[0]
            stage.module.set_params({n: mx.nd.array(params[n], ctx=mx.cpu())
                                     for n in own}, {})
        smod.fit(train, num_epoch=2, optimizer="sgd",
                 optimizer_params={"learning_rate": 0.5, "momentum": 0.9})
        acc = smod.score(train, "acc")[0][1]
        res.append(({n: v.asnumpy() for n, v in smod.get_params()[0].items()}, acc,
                    smod.output_shapes, smod.data_names, smod.output_names))
    assert res[1][1] > 0.8
    assert res[1][1] == pytest.approx(res[0][1], abs=1 / 256)
    for n, v in res[0][0].items():
        assert np.abs(res[1][0][n] - v).max() <= FIT_TOL * np.abs(v).max(), n
    assert [tuple(s) for s in res[1][2]] == [tuple(s) for s in res[0][2]]
    assert res[1][3:] == res[0][3:]


def test_sequential_module_rejects_repeated_param_names():
    for mx in PACKAGES:
        net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4, name="fc")
        smod = mx.mod.SequentialModule()
        smod.add(mx.mod.Module(net, label_names=None, context=mx.cpu()))
        smod.add(mx.mod.Module(net, label_names=None, context=mx.cpu()), auto_wiring=True)
        smod.bind([("data", (2, 4))])
        with pytest.raises(ValueError, match="repeat across stages"):
            smod.init_params()
        with pytest.raises(ValueError, match="typo"):
            smod.add(mx.mod.Module(net, context=mx.cpu()), take_label=True)


def _softmax_grad(scores, labels):
    s = scores.asnumpy()
    p = np.exp(s - s.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    p[np.arange(len(p)), labels.asnumpy().astype(int)] -= 1
    return p / len(p)


def test_python_loss_module_matches_jax():
    """A Module under a PythonLossModule whose gradient is computed in
    numpy: three forward/backward/update steps, as the reference's
    python-loss example drives them."""
    x, y = _toy_data(n=64)
    params = _seeded([("fc_weight", (3, 8)), ("fc_bias", (3,))], 9)
    res = []
    for mx in PACKAGES:
        net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3, name="fc")
        smod = mx.mod.SequentialModule()
        smod.add(mx.mod.Module(net, label_names=None, context=mx.cpu()))
        loss = mx.mod.PythonLossModule(grad_func=_softmax_grad)
        smod.add(loss, take_labels=True, auto_wiring=True)
        train = mx.io.NDArrayIter(x, y, batch_size=16)
        smod.bind(train.provide_data, train.provide_label)
        smod.init_params()
        smod._stages[0].module.set_params(
            {n: mx.nd.array(v, ctx=mx.cpu()) for n, v in params.items()}, {})
        smod.init_optimizer(optimizer="sgd", optimizer_params={"learning_rate": 1.0})
        for _, batch in zip(range(3), train):
            smod.forward(batch, is_train=True)
            smod.backward()
            smod.update()
        res.append(({n: v.asnumpy() for n, v in smod.get_params()[0].items()},
                    smod.get_outputs()[0].asnumpy(), loss.output_shapes,
                    loss.data_names))
    for n, v in res[0][0].items():
        assert np.abs(res[1][0][n] - v).max() <= FIT_TOL * np.abs(v).max(), n
    np.testing.assert_allclose(res[1][1], res[0][1], rtol=1e-5, atol=1e-6)
    assert res[1][2:] == res[0][2:]
