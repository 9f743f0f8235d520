"""The rest of the port's Python surface against the JAX package, on the
CPU: the torch bridge (``mx.th``), ``contrib.caffe`` (``CaffeOp`` and
``CaffeLoss`` on ``tests/test_caffe_op.py``'s prototxts: the same
symbol JSON and, with the same weights, the same outputs within 1e-6),
the notebook callbacks, the generated op docs and the reference's test
helpers (``check_numeric_gradient``, ``check_symbolic_forward``/
``backward``, ``check_consistency`` over two CPU contexts)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as J
import mxnet_tpu_torch as T
from mxnet_tpu.contrib import caffe as JC
from mxnet_tpu_torch import test_utils as TU
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import caffe as TC

CONV_RELU = """
layer { name: "c1" type: "Convolution" bottom: "data" top: "c1"
  convolution_param { num_output: 4 kernel_size: 1 } }
layer { name: "r1" type: "ReLU" bottom: "c1" top: "r1" }
"""
TRUNK = """
layer { name: "ip1" type: "InnerProduct" bottom: "data" top: "ip1"
  inner_product_param { num_output: 16 } }
layer { name: "relu1" type: "ReLU" bottom: "ip1" top: "relu1" }
"""
BN_POOL = """
layer { name: "c1" type: "Convolution" bottom: "data" top: "c1"
  convolution_param { num_output: 3 kernel_size: 3 pad: 1 } }
layer { name: "bn" type: "BatchNorm" bottom: "c1" top: "c1" }
layer { name: "sc" type: "Scale" bottom: "c1" top: "c1" }
layer { name: "p" type: "Pooling" bottom: "c1" top: "p"
  pooling_param { pool: AVE kernel_size: 2 stride: 2 } }
layer { name: "e" type: "Eltwise" bottom: "p" bottom: "p" top: "e"
  eltwise_param { operation: SUM coeff: 0.5 coeff: 2.0 } }
"""
LOSS = """
layer { name: "ip" type: "InnerProduct" bottom: "data" top: "ip"
  inner_product_param { num_output: 3 } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label" }
"""
CAFFE = {"conv_relu": (CONV_RELU, (2, 3, 5, 5), "op"),
         "trunk": (TRUNK, (4, 10), "op"),
         "bn_pool": (BN_POOL, (2, 2, 6, 6), "op"),
         "loss": (LOSS, (4, 6), "loss")}


def _caffe_forward(mx, caffe, name):
    text, shape, kind = CAFFE[name]
    fn = caffe.CaffeLoss if kind == "loss" else caffe.CaffeOp
    # a fresh name counter: unnamed nodes (Eltwise's scalar multiplies) are
    # numbered by what the process built before
    with mx.name.NameManager():
        net = fn(mx.sym.Variable("data"), prototxt=text, name="cf")
    shapes = {"data": shape}
    exe = net.simple_bind(mx.cpu(), grad_req="null", **shapes)
    r = np.random.RandomState(0)
    for n in sorted(exe.arg_dict):
        exe.arg_dict[n][:] = r.standard_normal(exe.arg_dict[n].shape).astype(np.float32)
    for n in sorted(exe.aux_dict):
        exe.aux_dict[n][:] = r.uniform(0.5, 1.5, exe.aux_dict[n].shape).astype(np.float32)
    return net, [o.asnumpy() for o in exe.forward(is_train=False)]


@pytest.mark.parametrize("name", sorted(CAFFE))
def test_caffe_op_matches_jax(name):
    jnet, jout = _caffe_forward(J, JC, name)
    tnet, tout = _caffe_forward(T, TC, name)
    assert tnet.list_arguments() == jnet.list_arguments()
    assert tnet.list_auxiliary_states() == jnet.list_auxiliary_states()
    assert tnet.tojson() == jnet.tojson()
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_caffe_op_rejections_match_jax():
    data = T.sym.Variable("data")
    with pytest.raises(MXNetError, match="data layers"):
        TC.CaffeOp(data, prototxt='layer { name: "d" type: "Data" }')
    with pytest.raises(MXNetError, match="no input or earlier layer"):
        TC.CaffeOp(data, prototxt='layer { name: "e" type: "Eltwise" '
                                  'bottom: "data" bottom: "ghost" top: "e" }')
    with pytest.raises(MXNetError, match="at least one input"):
        TC.CaffeOp(prototxt='layer { name: "r" type: "ReLU" bottom: "x" }')
    with pytest.raises(MXNetError, match="grad_scale"):
        TC.CaffeLoss(data, prototxt=LOSS, grad_scale=2.0)
    assert T.contrib.caffe.CaffeOp is TC.CaffeOp


def test_caffe_trunk_trains_inside_module():
    trunk = TC.CaffeOp(T.sym.Variable("data"), prototxt=TRUNK, name="cf")
    net = T.sym.SoftmaxOutput(T.sym.FullyConnected(trunk, num_hidden=2,
                                                   name="out"), name="softmax")
    r = np.random.RandomState(3)
    X = r.randn(64, 10).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    mod = T.mod.Module(net, context=T.cpu())
    mod.fit(T.io.NDArrayIter(X, y, batch_size=16), num_epoch=8,
            optimizer="sgd", optimizer_params={"learning_rate": 0.2},
            initializer=T.init.Xavier(), kvstore="device")
    acc = mod.score(T.io.NDArrayIter(X, y, batch_size=16), "acc")[0][1]
    assert acc > 0.9
    assert "cf_ip1_weight" in mod.get_params()[0]


# ---- the torch bridge ----------------------------------------------------------
def test_torch_bridge_never_aliases_and_keeps_the_device():
    a = T.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3), ctx=T.cpu())
    t = T.th.to_torch(a)
    t += 1
    np.testing.assert_array_equal(a.asnumpy(), np.arange(6).reshape(2, 3))
    src = torch.ones(3)
    b = T.torch.from_torch(src)
    src += 5
    np.testing.assert_array_equal(b.asnumpy(), np.ones(3))
    assert b.context == src.device
    j = J.th.to_torch(J.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3)))
    np.testing.assert_array_equal(t.numpy() - 1, j.numpy())
    fn = T.th.function(torch.matmul)
    out = fn(a, T.nd.array(np.ones((3, 2), np.float32), ctx=T.cpu()))
    jfn = J.th.function(torch.matmul)
    jout = jfn(J.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3)),
               J.nd.array(np.ones((3, 2), np.float32)))
    np.testing.assert_array_equal(out.asnumpy(), jout.asnumpy())


def test_torch_module_forward_backward_step_match_jax():
    outs = []
    for mx in (J, T):
        torch.manual_seed(0)
        lin = torch.nn.Linear(4, 3)
        tm = mx.th.TorchModule(lin)
        x = mx.nd.array(np.random.RandomState(1).standard_normal((2, 4))
                        .astype(np.float32), ctx=mx.cpu())
        y = tm.forward(x, is_train=True)
        gx = tm.backward(mx.nd.array(np.ones((2, 3), np.float32), ctx=mx.cpu()))
        tm.step(0.1)
        outs.append([y.asnumpy(), gx.asnumpy(), lin.weight.detach().numpy().copy()])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    with pytest.raises(RuntimeError):
        T.th.TorchModule(torch.nn.Linear(4, 3)).backward(None)


# ---- notebook callbacks and op docs -----------------------------------------------
def test_pandas_logger_and_learning_curve():
    pd = pytest.importorskip("pandas")
    from mxnet_tpu_torch.module.base_module import BatchEndParam
    from mxnet_tpu_torch.notebook.callback import LiveLearningCurve, PandasLogger

    logger = PandasLogger(batch_size=8, frequent=1)
    curve = LiveLearningCurve("accuracy", display_freq=100)
    metric = T.metric.Accuracy()
    metric.update([T.nd.array(np.array([0, 1], np.float32), ctx=T.cpu())],
                  [T.nd.array(np.array([[0.9, 0.1], [0.2, 0.8]], np.float32),
                              ctx=T.cpu())])
    for n in range(3):
        p = BatchEndParam(epoch=0, nbatch=n, eval_metric=metric, locals=None)
        logger.train_cb(p)
        curve.train_cb(p)
    logger.epoch_cb(0)
    assert isinstance(logger.train_df, pd.DataFrame)
    assert list(logger.train_df["accuracy"]) == [1.0, 1.0, 1.0]
    assert len(logger.epoch_df) == 1
    assert curve.data["train"] == [1.0, 1.0, 1.0]
    assert set(logger.callback_args()) == {"batch_end_callback",
                                           "eval_batch_end_callback",
                                           "epoch_end_callback"}


@pytest.mark.parametrize("op", ["Convolution", "FullyConnected", "Dropout",
                                "SoftmaxOutput", "_contrib_MultiBoxPrior",
                                "_image_wire_normalize"])
def test_build_doc_lists_what_the_jax_docs_list(op):
    from mxnet_tpu import op_doc as JOD
    from mxnet_tpu_torch import op_doc as TOD

    def head(text):
        # inputs, aliases, parameters and outputs: the registry's facts
        lines = text.split("\n")
        return [ln for ln in lines if ln.startswith(("Inputs", "Aliases", "Outputs"))
                or " : " in ln]

    got = TOD.build_doc(op)
    assert head(got) == head(JOD.build_doc(op))
    assert T.symbol_doc.build_doc is TOD.build_doc
    assert T.ndarray_doc.attach_docs is TOD.attach_docs
    assert getattr(T.sym, op).__doc__.startswith("Symbolic form of operator")
    assert "Inputs:" in getattr(T.nd, op).__doc__


# ---- the reference's test helpers --------------------------------------------------
def test_check_numeric_gradient_and_symbolic_checks():
    x = T.sym.Variable("x")
    w = T.sym.Variable("w")
    net = T.sym.tanh(T.sym.FullyConnected(x, w, num_hidden=3, no_bias=True))
    r = np.random.RandomState(0)
    loc = {"x": r.standard_normal((2, 4)).astype(np.float32),
           "w": r.standard_normal((3, 4)).astype(np.float32) * 0.5}
    TU.check_numeric_gradient(net, loc, numeric_eps=1e-2, rtol=2e-2,
                              atol=1e-3, ctx=T.cpu())
    y = np.tanh(loc["x"] @ loc["w"].T)
    TU.check_symbolic_forward(net, loc, [y], rtol=1e-5, atol=1e-6, ctx=T.cpu())
    g = r.standard_normal((2, 3)).astype(np.float32)
    dpre = g * (1 - y ** 2)
    TU.check_symbolic_backward(net, loc, [g], {"x": dpre @ loc["w"],
                                               "w": dpre.T @ loc["x"]},
                               rtol=1e-5, atol=1e-5, ctx=T.cpu())
    TU.check_symbolic_backward(net, loc, [g], {"x": dpre @ loc["w"],
                                               "w": dpre.T @ loc["x"]},
                               rtol=1e-5, atol=1e-5, grad_req="add",
                               ctx=T.cpu())
    bad = {"x": dpre @ loc["w"] + 1.0, "w": dpre.T @ loc["x"]}
    with pytest.raises(AssertionError, match="EXPECTED_x"):
        TU.check_symbolic_backward(net, loc, [g], bad, ctx=T.cpu())
    assert TU.simple_forward(net, ctx=T.cpu(), **loc).shape == (2, 3)
    with pytest.raises(MXNetError):
        TU.default_context()            # no card here: the card is the default


def test_check_consistency_across_two_cpu_contexts():
    net = T.sym.SoftmaxOutput(T.sym.FullyConnected(T.sym.Variable("data"),
                                                   num_hidden=4, name="fc"),
                              name="softmax")
    ctx_list = [{"ctx": T.cpu(), "shapes": {"data": (3, 5)}},
                {"ctx": T.cpu(0), "shapes": {"data": (3, 5)}}]
    exes = TU.check_consistency(net, ctx_list)
    assert len(exes) == 2
    np.testing.assert_array_equal(exes[0].grad_dict["fc_weight"].asnumpy(),
                                  exes[1].grad_dict["fc_weight"].asnumpy())
    # two different symbols do disagree
    other = T.sym.SoftmaxOutput(T.sym.FullyConnected(
        T.sym.relu(T.sym.Variable("data")), num_hidden=4, name="fc"),
        name="softmax")
    worst = TU.check_consistency([net, other], ctx_list, raise_on_err=False)
    assert worst > 1.0
    with pytest.raises(AssertionError):
        TU.check_consistency([net, other], ctx_list)


def test_tolerance_helpers_match_jax():
    from mxnet_tpu import test_utils as JU

    a = np.array([1.0, 2.0, 3.0])
    b = np.array([1.0, 2.1, 3.0])
    assert TU.reldiff(a, b) == JU.reldiff(a, b)
    assert TU.find_max_violation(a, b)[0] == JU.find_max_violation(a, b)[0]
    assert TU.almost_equal(a, a + 1e-9) and not TU.almost_equal(a, b)
    assert TU.same(a, a.copy())
    with pytest.raises(AssertionError, match="Error"):
        TU.assert_almost_equal(a, b)
