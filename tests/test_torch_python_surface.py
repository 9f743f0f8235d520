"""The port's visualization, log module, the ``log_train_metric`` and
``ProgressBar`` callbacks and ``Symbol.eval`` against the JAX package: the same text and values from the same input
(the cases of ``tests/test_viz.py`` and ``tests/test_misc.py``)."""
import contextlib
import io
import logging

import numpy as np
import pytest

import mxnet_tpu as J
import mxnet_tpu_torch as T


def _small_net(mx):
    data = mx.sym.Variable("data")
    net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1), name="conv")
    net = mx.sym.BatchNorm(net, name="bn")
    net = mx.sym.Activation(net, act_type="relu", name="relu")
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max", name="pool")
    net = mx.sym.Flatten(net, name="flat")
    net = mx.sym.FullyConnected(net, num_hidden=10, name="fc")
    return mx.sym.SoftmaxOutput(net, name="softmax")


@pytest.mark.parametrize("shape", [None, {"data": (1, 1, 8, 8)}])
def test_print_summary_matches_jax(shape):
    outs = []
    for mx in (J, T):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mx.viz.print_summary(_small_net(mx), shape=shape)
        outs.append(buf.getvalue())
    assert outs[1] == outs[0]
    if shape:
        total = int([ln for ln in outs[1].splitlines() if "Total params" in ln][0].split()[-1])
        assert total == 80 + 1290 + 16


def test_plot_network_without_graphviz_or_with_it():
    try:
        import graphviz  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="graphviz"):
            T.viz.plot_network(_small_net(T))
        return
    src = T.viz.plot_network(_small_net(T), shape={"data": (1, 1, 8, 8)}).source
    assert src == J.viz.plot_network(_small_net(J), shape={"data": (1, 1, 8, 8)}).source


def test_graph_view_keeps_weights_when_asked():
    from mxnet_tpu_torch import visualization as tv
    from mxnet_tpu import visualization as jv

    shape = {"data": (1, 1, 8, 8)}
    got = [(i.name, i.op, i.preds, i.out_shape, i.param_count)
           for i in tv._graph_view_all_vars(_small_net(T), shape)]
    want = [(i.name, i.op, i.preds, i.out_shape, i.param_count)
            for i in jv._graph_view_all_vars(_small_net(J), shape)]
    assert got == want and any(name == "conv_weight" for name, *_ in got)


def test_log_module_matches_jax():
    lines = []
    for mx in (J, T):
        logger = mx.log.get_logger("surface_%s" % mx.__name__, level=mx.log.DEBUG)
        stream = io.StringIO()
        handler = logging.StreamHandler(stream)
        handler.setFormatter(mx.log._Formatter(colored=False))
        logger.addHandler(handler)
        logger.info("hello %d", 7)
        n = len(logger.handlers)
        assert len(mx.log.get_logger("surface_%s" % mx.__name__).handlers) == n
        lines.append(stream.getvalue())
    assert lines[1].startswith("I") and lines[1].rstrip().endswith("] hello 7")
    assert lines[0].startswith("I") and lines[0].rstrip().endswith("] hello 7")
    with pytest.warns(DeprecationWarning):
        T.log.getLogger("surface_old")


def _param(mx, nbatch):
    metric = mx.metric.Accuracy()
    metric.update([mx.nd.array(np.zeros(4), ctx=mx.cpu())],
                  [mx.nd.array(np.eye(4)[[0, 1, 0, 0]], ctx=mx.cpu())])
    from collections import namedtuple
    Param = namedtuple("BatchEndParams", ["epoch", "nbatch", "eval_metric", "locals"])
    return Param(epoch=1, nbatch=nbatch, eval_metric=metric, locals=None)


def test_log_train_metric_and_progress_bar_match_jax(caplog, capsys):
    got = []
    for mx in (J, T):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            mx.callback.log_train_metric(5)(_param(mx, 7))     # not on the period
            mx.callback.log_train_metric(5, auto_reset=True)(_param(mx, 10))
        mx.callback.ProgressBar(total=40, length=20)(_param(mx, 10))
        got.append(([r.getMessage() for r in caplog.records if r.name == "root"],
                    capsys.readouterr().out))
    assert got[1] == got[0]
    assert got[1][0] == ["Iter[1] Batch[10] Train-accuracy=0.750000"]
    assert got[1][1] == "[=====---------------] 25%\r"


def test_symbol_eval_matches_jax():
    x = np.random.RandomState(0).rand(3, 3).astype(np.float32) * 4
    res = []
    for mx in (J, T):
        with mx.name.NameManager():
            s = mx.sym.Cast(mx.sym.Variable("x") * 2.0, dtype="int32", name="c")
        out = s.eval(ctx=mx.cpu(), x=mx.nd.array(x, ctx=mx.cpu()))[0]
        res.append(out.asnumpy())
    assert res[1].dtype == np.int32
    np.testing.assert_array_equal(res[1], res[0])
