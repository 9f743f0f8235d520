"""``group2ctx`` placement (``mxnet_tpu_torch/placed.py``), several
contexts per module (``module/executor_group.py``) and
``executor_manager.py`` of the port against the JAX package's on the CPU.

The CPU is one torch device, so ``bind(group2ctx=...)`` with CPU contexts
does not place (``_placed`` is None, ``ROADMAP.md`` C15) and computes the
same numbers as the JAX package, which places them on its virtual
devices. :class:`PlacedGraph` segments by context, so built directly over
``cpu(1)``/``cpu(2)`` its segments and copies are real, and it is held
against the single-context executor and the JAX package's placed one.
Tolerance: 1e-5 relative (the JAX group2ctx tests'), 1e-6 for the fits'
parameters."""
import numpy as np
import pytest
import torch

import mxnet_tpu as J
import mxnet_tpu_torch as T
from mxnet_tpu.executor_manager import DataParallelExecutorManager as JManager
from mxnet_tpu_torch.executor_manager import (DataParallelExecutorManager,
                                              _split_input_slice)
from mxnet_tpu_torch.placed import PlacedGraph

TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_on_the_cpu():
    with T.cpu():
        yield


def _fc_net(mx):
    data = mx.sym.Variable("data")
    with mx.AttrScope(ctx_group="stage1"):
        fc1 = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
        act1 = mx.sym.Activation(fc1, act_type="relu")
    with mx.AttrScope(ctx_group="stage2"):
        fc2 = mx.sym.FullyConnected(act1, num_hidden=4, name="fc2")
    return mx.sym.MakeLoss(mx.sym.sum(fc2 * fc2), name="loss")


def _bn_net(mx, p):
    data = mx.sym.Variable("data")
    with mx.AttrScope(ctx_group="stage1"):
        fc1 = mx.sym.FullyConnected(data, num_hidden=8, name="fc1")
        bn = mx.sym.BatchNorm(fc1, name="bn")
        do = mx.sym.Dropout(bn, p=p, name="do")
    with mx.AttrScope(ctx_group="stage2"):
        fc2 = mx.sym.FullyConnected(do, num_hidden=4, name="fc2")
    return mx.sym.MakeLoss(mx.sym.sum(fc2 * fc2), name="loss")


def _interleaved_net(mx):
    data = mx.sym.Variable("data")
    with mx.AttrScope(ctx_group="a"):
        h = mx.sym.FullyConnected(data, num_hidden=8, name="g1")
    with mx.AttrScope(ctx_group="b"):
        h = mx.sym.Activation(h, act_type="tanh")
        h = mx.sym.FullyConnected(h, num_hidden=8, name="g2")
    with mx.AttrScope(ctx_group="a"):
        h = mx.sym.FullyConnected(h, num_hidden=3, name="g3")
    return mx.sym.MakeLoss(mx.sym.sum(h * h), name="loss")


def _values(net, shapes, seed):
    """Seeded values for every argument of ``net``."""
    arg_shapes, _, _ = net.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    return {n: rs.rand(*s).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)}


def _run(mx, net, shapes, values, group2ctx=None, out_grads=None):
    """Bind on cpu(0) (with ``group2ctx``), one training forward and
    backward: (executor, outputs, grads, auxs)."""
    ex = net.simple_bind(mx.cpu(0), grad_req="write", group2ctx=group2ctx,
                         **shapes)
    for name, arr in ex.arg_dict.items():
        arr[:] = values[name]
    outs = [o.asnumpy() for o in ex.forward(is_train=True)]
    ex.backward(out_grads=None if out_grads is None
                else [mx.nd.array(g) for g in out_grads])
    grads = {k: v.asnumpy() for k, v in ex.grad_dict.items() if v is not None}
    auxs = {k: v.asnumpy() for k, v in ex.aux_dict.items()}
    return ex, outs, grads, auxs


def _placed(net, group2ctx, values, is_train=True, out_grads=None):
    """A PlacedGraph over cpu contexts, run directly: (graph, outputs,
    grads by name, new auxs)."""
    args = [torch.tensor(values[n]) for n in net.list_arguments()]
    _, _, aux_shapes = net.infer_shape(data=values["data"].shape)
    auxs = [torch.zeros(s) for s in aux_shapes]   # as simple_bind binds them
    pg = PlacedGraph(net, group2ctx, T.cpu(0), net.list_arguments(),
                     net.list_auxiliary_states(), lambda name, t: t)
    outs, new_aux = pg.forward(args, auxs, is_train)
    ogs = out_grads or [torch.ones_like(o) for o in outs]
    grads = pg.backward([torch.as_tensor(g) for g in ogs])
    return (pg, [o.numpy() for o in outs],
            {n: g.numpy() for n, g in zip(net.list_arguments(), grads)
             if g is not None},
            {n: a.numpy() for n, a in zip(net.list_auxiliary_states(), new_aux)})


def _close(got, want, what="", of_largest=False):
    assert set(want) <= set(got) or set(got) <= set(want), what
    largest = max(np.abs(w).max() for w in want.values())
    for k in set(got) & set(want):
        if of_largest:
            tol = dict(rtol=0, atol=TOL * largest)
        else:
            tol = dict(rtol=TOL, atol=1e-7)
        np.testing.assert_allclose(got[k], want[k], err_msg="%s %s" % (what, k),
                                   **tol)


def test_placed_graph_segments_by_context_and_matches_jax():
    shapes = {"data": (2, 6)}
    values = _values(_fc_net(T), shapes, 0)
    g2c = {"stage1": T.cpu(1), "stage2": T.cpu(2)}
    pg, outs, grads, _ = _placed(_fc_net(T), g2c, values)
    assert [str(s.ctx) for s in pg.segments] == ["cpu(1)", "cpu(2)", "cpu(0)"]
    assert pg.arg_ctx == {"data": T.cpu(1), "fc1_weight": T.cpu(1),
                          "fc1_bias": T.cpu(1), "fc2_weight": T.cpu(2),
                          "fc2_bias": T.cpu(2)}
    _, j_outs, j_grads, _ = _run(J, _fc_net(J), shapes, values,
                                 {"stage1": J.cpu(1), "stage2": J.cpu(2)})
    _, s_outs, s_grads, _ = _run(T, _fc_net(T), shapes, values)
    for got in (outs, s_outs):
        np.testing.assert_allclose(got[0], j_outs[0], rtol=TOL)
    _close(grads, j_grads, "placed")
    _close(s_grads, j_grads, "single")
    # stage1 -> stage2 -> loss and the cotangents back: four copies
    assert pg.transfer_count == 4


def test_placed_graph_batchnorm_aux_and_dropout_masks():
    """BatchNorm's moving statistics come back from their segment; a
    Dropout mask is drawn once and the backward's recompute draws the same
    one (the gradient equals the single-context executor's from the same
    seed); with p = 0 everything equals the JAX package's placed run."""
    shapes = {"data": (4, 6)}
    values = _values(_bn_net(T, 0.5), shapes, 1)
    g2c = {"stage1": T.cpu(1), "stage2": T.cpu(2)}
    T.random.seed(11)
    _, outs, grads, auxs = _placed(_bn_net(T, 0.5), g2c, values)
    T.random.seed(11)
    _, s_outs, s_grads, s_auxs = _run(T, _bn_net(T, 0.5), shapes, values)
    np.testing.assert_allclose(outs[0], s_outs[0], rtol=TOL)
    _close(grads, s_grads, "dropout")
    _close(auxs, s_auxs, "aux")
    assert not np.allclose(auxs["bn_moving_mean"], 0)
    assert np.isfinite(grads["fc1_weight"]).all() and np.abs(grads["fc1_weight"]).sum() > 0
    # a different draw gives a different step: the mask is really there
    T.random.seed(12)
    _, other, _, _ = _placed(_bn_net(T, 0.5), g2c, values)
    assert not np.allclose(other[0], outs[0])

    _, outs0, grads0, auxs0 = _placed(_bn_net(T, 0.0), g2c, values)
    _, j_outs, j_grads, j_auxs = _run(
        J, _bn_net(J, 0.0), shapes, values,
        {"stage1": J.cpu(1), "stage2": J.cpu(2)})
    np.testing.assert_allclose(outs0[0], j_outs[0], rtol=TOL)
    # BatchNorm's gradients sum the batch at magnitudes ~1e2, and fc1's bias
    # gradient is 0 up to rounding: held to 1e-5 of the largest gradient
    _close(grads0, j_grads, "bn", of_largest=True)
    _close(auxs0, j_auxs, "bn aux")


def test_placed_graph_interleaved_groups_roundtrip():
    """a -> b -> a: the values cross the boundary twice; the loss falls to
    the default context, a fourth segment."""
    shapes = {"data": (2, 5)}
    net = _interleaved_net(T)
    values = _values(net, shapes, 3)
    pg, outs, grads, _ = _placed(net, {"a": T.cpu(3), "b": T.cpu(4)}, values)
    assert [str(s.ctx) for s in pg.segments] == ["cpu(3)", "cpu(4)", "cpu(3)",
                                                "cpu(0)"]
    _, j_outs, j_grads, _ = _run(J, _interleaved_net(J), shapes, values,
                                 {"a": J.cpu(3), "b": J.cpu(4)})
    np.testing.assert_allclose(outs[0], j_outs[0], rtol=TOL)
    _close(grads, j_grads, "interleaved")
    assert pg.transfer_count == 6


def test_placed_graph_variable_passthrough_output_grad():
    """A variable among the outputs: its head gradient is its argument
    gradient."""
    def net(mx):
        data, w = mx.sym.Variable("data"), mx.sym.Variable("extra")
        with mx.AttrScope(ctx_group="a"):
            h = mx.sym.FullyConnected(data, num_hidden=3, name="vp")
        return mx.sym.Group([mx.sym.MakeLoss(mx.sym.sum(h * h)), w])

    shapes = {"data": (2, 4), "extra": (2, 3)}
    values = _values(net(T), shapes, 5)
    _, _, j_grads, _ = _run(J, net(J), shapes, values, {"a": J.cpu(1)},
                            out_grads=[np.ones((), np.float32),
                                       np.full((2, 3), 2.5, np.float32)])
    args = [torch.tensor(values[n]) for n in net(T).list_arguments()]
    sym = net(T)
    pg = PlacedGraph(sym, {"a": T.cpu(1)}, T.cpu(0), sym.list_arguments(), [],
                     lambda name, t: t)
    outs, _ = pg.forward(args, [], True)
    grads = pg.backward([torch.ones_like(outs[0]), torch.full((2, 3), 2.5)])
    got = {n: g.numpy() for n, g in zip(sym.list_arguments(), grads)}
    _close(got, j_grads, "passthrough")
    np.testing.assert_allclose(got["extra"], 2.5)


def test_bind_group2ctx_on_cpu_contexts_runs_as_one_segment():
    """Every cpu(i) is the one CPU device: the bind does not place, and its
    numbers are the JAX package's placed ones (C15)."""
    shapes = {"data": (2, 6)}
    values = _values(_fc_net(T), shapes, 0)
    ex, outs, grads, _ = _run(T, _fc_net(T), shapes, values,
                              {"stage1": T.cpu(1), "stage2": T.cpu(2)})
    jex, j_outs, j_grads, _ = _run(J, _fc_net(J), shapes, values,
                                   {"stage1": J.cpu(1), "stage2": J.cpu(2)})
    assert ex._placed is None and jex._placed is not None
    np.testing.assert_allclose(outs[0], j_outs[0], rtol=TOL)
    _close(grads, j_grads, "collapsed")


# ------------------------------------------------------ several contexts
def _mlp(mx):
    net = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(net, num_hidden=16, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=2, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _xy():
    rng = np.random.RandomState(0)
    X = rng.randn(48, 8).astype(np.float32)
    return X, (X.sum(1) > 0).astype(np.float32)


def _init_params(mx):
    arg_shapes, _, _ = _mlp(mx).infer_shape(data=(12, 8))
    rs = np.random.RandomState(4)
    return {n: rs.randn(*s).astype(np.float32) * 0.3
            for n, s in zip(_mlp(mx).list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


def test_split_input_slice_is_the_jax_packages():
    from mxnet_tpu.executor_manager import _split_input_slice as jsplit

    for b, w in ((10, [1, 1]), (12, [1, 2]), (7, [3, 1, 1]), (32, [1, 1, 2])):
        assert _split_input_slice(b, w) == jsplit(b, w)
    with pytest.raises(ValueError):
        _split_input_slice(2, [1, 1, 1])


def test_module_fit_over_two_contexts_matches_jax():
    """``context=[cpu(0), cpu(1)]``, ``work_load_list=[1, 2]``: one
    executor per context on a third and two thirds of the batch, the
    gradients summed by the kvstore; against the JAX package's same fit
    and the port's one-context fit."""
    X, y = _xy()
    res = {}
    for name, mx, ctx, wl in (
            ("jax", J, [J.cpu(0), J.cpu(1)], [1, 2]),
            ("port", T, [T.cpu(0), T.cpu(1)], [1, 2]),
            ("one", T, [T.cpu(0)], None)):
        mod = mx.mod.Module(_mlp(mx), context=ctx, work_load_list=wl)
        it = mx.io.NDArrayIter(X, y, batch_size=12)
        mod.fit(it, num_epoch=2, optimizer="sgd", kvstore="local",
                optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
                arg_params={k: mx.nd.array(v) for k, v in _init_params(mx).items()})
        res[name] = ({k: v.asnumpy() for k, v in mod.get_params()[0].items()},
                     mod.score(it, "acc")[0][1])
        if name == "port":
            assert len(mod._exec_group.execs) == 2
            assert [s.stop - s.start for s in mod._exec_group.slices] == [4, 8]
            assert mod._fused is None
            # the JAX package's vetoes: a non-uniform load keeps the
            # classic path; with a uniform one, 'local' on CPU contexts
            # does too, and 'device' fuses over two positions (C37)
            assert mod._fused_veto("device") == "non-uniform work_load_list"
            even = T.mod.Module(_mlp(T), context=ctx)
            even.bind(it.provide_data, it.provide_label)
            jeven = J.mod.Module(_mlp(J), context=[J.cpu(0), J.cpu(1)])
            jeven.bind(it.provide_data, it.provide_label)
            assert even._fused_veto("local").startswith("kvstore='local' on")
            assert jeven._fused_veto("local").startswith("kvstore='local' on")
            assert even._fused_veto("device") is None
            assert jeven._fused_veto("device") is None
            it.reset()
            mod.forward(next(iter(it)), is_train=False)
            assert mod.get_outputs()[0].shape == (12, 2)
            assert len(mod.get_outputs(merge_multi_context=False)[0]) == 2
    for k in res["jax"][0]:
        np.testing.assert_allclose(res["port"][0][k], res["jax"][0][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(res["port"][0][k], res["one"][0][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert res["port"][1] == res["jax"][1]


def test_executor_manager_matches_jax():
    """The pre-Module loop over two contexts: scatter, forward, backward,
    a per-context updater, copy_to the averaged parameters."""
    X, y = _xy()
    got = {}
    for name, mx, cls in (("jax", J, JManager), ("port", T, DataParallelExecutorManager)):
        it = mx.io.NDArrayIter(X, y, batch_size=12)
        ctx = [mx.cpu(0), mx.cpu(1)]
        mgr = cls(_mlp(mx), ctx, it, work_load_list=[1, 2])
        mgr.set_params({k: mx.nd.array(v) for k, v in _init_params(mx).items()},
                       {})
        updater = mx.optimizer.get_updater(mx.optimizer.create(
            "sgd", learning_rate=0.5, momentum=0.9, rescale_grad=1.0 / 12))
        metric = mx.metric.create("acc")
        for batch in it:
            mgr.load_data_batch(batch)
            mgr.forward(is_train=True)
            mgr.backward()
            for idx, (ws, gs) in enumerate(zip(mgr.param_arrays, mgr.grad_arrays)):
                for k, (w, g) in enumerate(zip(ws, gs)):
                    updater(idx * len(ctx) + k, g, w)
            mgr.update_metric(metric, batch.label)
        out = {n: mx.nd.zeros(a[0].shape) for n, a in
               zip(mgr.param_names, mgr.param_arrays)}
        mgr.copy_to(out, {})
        got[name] = ({k: v.asnumpy() for k, v in out.items()}, metric.get()[1])
    for k in got["jax"][0]:
        np.testing.assert_allclose(got["port"][0][k], got["jax"][0][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert got["port"][1] == got["jax"][1]
    with pytest.raises(T.MXNetError):
        DataParallelExecutorManager(_mlp(T), [T.cpu(0)], T.io.NDArrayIter(
            X, y, batch_size=12), sym_gen=lambda k: None)
