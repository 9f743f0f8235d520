"""Parity of the port's learning-rate schedules, optimizers, fused rules,
initializers and metrics with the JAX package, on the CPU.

Schedules: every scheduler's rate over updates 0-50, boundaries included,
equal to the JAX package's. Optimizers: five updates of each new
optimizer from the same numpy weights and gradients within 1e-6 of the
JAX package's (SGLD with the same noise installed on both sides); their
``.states`` files load across the packages. Fused rules: the fused step
against the serial Updater within 1e-6 for each new rule, and across a
``MultiFactorScheduler`` boundary equal before it and apart, on the
parameters after the first, on the boundary step (the documented skew).
Initializers: Constant, Bilinear, Load and Mixed equal to the JAX
package's; Orthogonal orthogonal; MSRAPrelu's variance within 5 standard
errors. Metrics: values equal to the JAX package's on the same numpy
predictions.
"""
import math

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.parallel import fused_opt
from mxnet_tpu_torch.parallel.spmd import SPMDTrainer

TOL = 1e-6
STEPS = 5
SHAPES = {"fc_weight": (4, 3), "fc_bias": (4,)}


# ------------------------------------------------------------ schedules
def _schedulers(mx):
    s = mx.lr_scheduler
    return [s.FactorScheduler(step=5, factor=0.5, stop_factor_lr=2e-3),
            s.FactorScheduler(step=1, factor=0.9),
            s.MultiFactorScheduler(step=[3, 10, 25], factor=0.1),
            s.PolyScheduler(max_update=40, base_lr=0.1, pwr=2),
            s.CosineScheduler(max_update=40, base_lr=0.1, final_lr=1e-3,
                              warmup_steps=5)]


@pytest.mark.parametrize("i", range(5), ids=["factor", "factor-each",
                                              "multifactor", "poly", "cosine"])
def test_scheduler_matches_jax_over_50_updates(i):
    j, t = _schedulers(jmx)[i], _schedulers(tmx)[i]
    jo = jmx.optimizer.SGD(learning_rate=0.1, lr_scheduler=j)
    to = tmx.optimizer.SGD(learning_rate=0.1, lr_scheduler=t)
    assert t.base_lr == j.base_lr == 0.1
    for k in range(51):
        assert t(k) == j(k), k
    assert jo.lr_scheduler is j and to.lr_scheduler is t


def test_multifactor_boundary_is_strict_and_logged_once(caplog):
    import logging

    s = tmx.lr_scheduler.MultiFactorScheduler(step=[3], factor=0.5)
    s.base_lr = 1.0
    with caplog.at_level(logging.INFO):
        got = [s(k) for k in (0, 3, 4, 5, 4)]
    assert got == [1.0, 1.0, 0.5, 0.5, 0.5]
    assert sum("learning rate is now" in r.message for r in caplog.records) == 1


def test_host_step_values_reads_the_scheduler_before_the_increments():
    """The fused step's (lr, t): the scheduler at num_update before this
    step's increments, t after them (the JAX package's order)."""
    s = tmx.lr_scheduler.FactorScheduler(step=2, factor=0.1)
    o = tmx.optimizer.Adam(learning_rate=1.0, lr_scheduler=s)
    seen = [fused_opt.host_step_values(o, ["a", "b"]) for _ in range(5)]
    assert [t for _, t in seen] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([lr for lr, _ in seen],
                               [1.0, 1.0, 1.0, 0.1, 0.1])


# ------------------------------------------------------------ optimizers
OPTS = [
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("nag", {"learning_rate": 0.1}),
    ("sgld", {"learning_rate": 0.05}),
    ("dcasgd", {"learning_rate": 0.1, "lamda": 0.1}),
    ("ccsgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adagrad", {"learning_rate": 0.1}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True, "clip_weights": 0.5}),
    ("adadelta", {}),
    ("ftrl", {"learning_rate": 0.1, "lamda1": 0.01}),
    ("test", {}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "lr_scheduler": "multi"}),
]
IDS = ["%s-%d" % (n, i) for i, (n, _) in enumerate(OPTS)]


def _make(mx, name, kwargs):
    kw = dict(kwargs, wd=0.01, rescale_grad=0.5, clip_gradient=0.8)
    if kw.get("lr_scheduler") == "multi":
        kw["lr_scheduler"] = mx.lr_scheduler.MultiFactorScheduler(step=[3],
                                                                  factor=0.1)
    return mx.optimizer.create(name, param_idx2name={0: "fc_weight",
                                                     1: "fc_bias"}, **kw)


def _steps_np():
    rng = np.random.RandomState(1)
    w0 = {n: rng.randn(*s).astype(np.float32) * 0.5 for n, s in SHAPES.items()}
    grads = [{n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
             for _ in range(STEPS)]
    noise = [{n: rng.randn(*s).astype(np.float32) for n, s in SHAPES.items()}
             for _ in range(STEPS)]
    return w0, grads, noise


def _install_noise(monkeypatch, noise):
    """SGLD's N(0, sqrt(lr)) draws replaced by the same numpy noise in both
    packages (one array per update, in update order)."""
    import mxnet_tpu.ndarray as jnd
    import mxnet_tpu_torch.ndarray as tnd

    flat = [noise[k][n] for k in range(STEPS) for n in SHAPES]
    seq = {"j": iter(flat), "t": iter(flat)}
    monkeypatch.setattr(
        jnd, "random_normal",
        lambda loc=0.0, scale=1.0, shape=None, ctx=None, **k: jmx.nd.array(
            next(seq["j"]) * np.float32(scale)), raising=False)
    monkeypatch.setattr(
        tnd, "random_normal",
        lambda loc=0.0, scale=1.0, shape=None, ctx=None, **k: tmx.nd.array(
            next(seq["t"]) * np.float32(scale), ctx=tmx.cpu()), raising=False)


def _leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _leaves(s)]
    return [state.asnumpy()]


def _run_updates(mx, name, kwargs, ctx):
    w0, grads, _ = _steps_np()
    opt = _make(mx, name, kwargs)
    upd = mx.optimizer.get_updater(opt)
    ws = {n: mx.nd.array(w0[n], ctx=ctx) for n in SHAPES}
    trace = []
    for k in range(STEPS):
        for i, n in enumerate(SHAPES):
            upd(i, mx.nd.array(grads[k][n], ctx=ctx), ws[n])
        trace.append(([ws[n].asnumpy().copy() for n in SHAPES],
                      [x.copy() for i in range(2) for x in _leaves(upd.states[i])]))
    return trace, upd


@pytest.mark.parametrize("name,kwargs", OPTS, ids=IDS)
def test_optimizer_matches_jax_over_5_updates(monkeypatch, name, kwargs):
    _install_noise(monkeypatch, _steps_np()[2])
    jt, _ = _run_updates(jmx, name, kwargs, jmx.cpu())
    tt, _ = _run_updates(tmx, name, kwargs, tmx.cpu())
    for k, ((jw, js), (tw, ts)) in enumerate(zip(jt, tt)):
        for a, b in zip(tw + ts, jw + js):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL,
                                       err_msg="update %d" % k)
    assert not np.allclose(tt[-1][0][0], _steps_np()[0]["fc_weight"])


def test_dcasgd_with_momentum():
    """The JAX package's DCASGD cannot run with momentum (it tests a
    buffer's truth); the port's keeps the buffer: its update written out
    in numpy."""
    w0, grads, _ = _steps_np()
    opt = tmx.optimizer.DCASGD(learning_rate=0.1, momentum=0.9, lamda=0.1,
                               rescale_grad=0.5)
    upd = tmx.optimizer.get_updater(opt)
    w = tmx.nd.array(w0["fc_weight"], ctx=tmx.cpu())
    ref_w, ref_m, prev = w0["fc_weight"].copy(), 0.0, w0["fc_weight"].copy()
    for k in range(STEPS):
        g = grads[k]["fc_weight"]
        upd(0, tmx.nd.array(g, ctx=tmx.cpu()), w)
        gs = g * np.float32(0.5)
        ref_m = ref_m * np.float32(0.9) + np.float32(-0.1) * (
            gs + np.float32(0.1) * gs * gs * (ref_w - prev))
        prev = ref_w.copy()
        ref_w = ref_w + ref_m
        np.testing.assert_allclose(w.asnumpy(), ref_w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name,kwargs", [o for o in OPTS if o[0] not in ("nag",)
                                         or o[1].get("momentum")],
                         ids=[i for i, o in zip(IDS, OPTS) if o[0] != "nag"
                              or o[1].get("momentum")])
def test_states_files_load_across_packages(monkeypatch, name, kwargs):
    """A port ``.states`` payload loads into the JAX package's Updater and
    back, leaf for leaf."""
    _install_noise(monkeypatch, _steps_np()[2])
    _, tu = _run_updates(tmx, name, kwargs, tmx.cpu())
    data = tu.get_states()
    ju = jmx.optimizer.get_updater(_make(jmx, name, kwargs))
    ju.set_states(data)
    back = tmx.optimizer.get_updater(_make(tmx, name, kwargs))
    back.set_states(ju.get_states())
    for i in tu.states:
        a, b, c = (_leaves(tu.states[i]), _leaves(ju.states[i]),
                   _leaves(back.states[i]))
        assert len(a) == len(b) == len(c)
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)


# ------------------------------------------------------------ fused rules
BATCH, DIM, HID = 8, 6, 5
FUSED = [o for o in OPTS if o[0] not in ("sgld", "dcasgd", "test")]
FUSED_IDS = [i for i, o in zip(IDS, OPTS) if o[0] not in ("sgld", "dcasgd", "test")]


def _net():
    data = tmx.sym.Variable("data")
    fc = tmx.sym.FullyConnected(data, num_hidden=HID, name="fc")
    return tmx.sym.SoftmaxOutput(fc, name="softmax")


def _fused_vs_serial(name, kwargs, steps):
    """(serial, fused) parameters after each of ``steps`` steps from the
    same start on the same batch."""
    net = _net()
    rng = np.random.RandomState(7)
    x = rng.rand(BATCH, DIM).astype(np.float32)
    y = rng.randint(0, HID, (BATCH,)).astype(np.float32)
    names = ["fc_weight", "fc_bias"]
    w0 = {"fc_weight": rng.rand(HID, DIM).astype(np.float32) - 0.5,
          "fc_bias": rng.rand(HID).astype(np.float32) - 0.5}
    ex = net.simple_bind(ctx=tmx.cpu(), data=(BATCH, DIM),
                         softmax_label=(BATCH,))
    for n in names:
        ex.arg_dict[n][:] = w0[n]
    opt = _make(tmx, name, kwargs)
    upd = tmx.optimizer.get_updater(opt)
    serial = []
    for _ in range(steps):
        ex.forward(is_train=True, data=x, softmax_label=y)
        ex.backward()
        for i, n in enumerate(names):
            upd(i, ex.grad_dict[n], ex.arg_dict[n])
        serial.append({n: ex.arg_dict[n].asnumpy().copy() for n in names})
    tr = SPMDTrainer(net, "cpu", [("data", (BATCH, DIM))], _make(tmx, name, kwargs),
                     label_shapes=[("softmax_label", (BATCH,))])
    params = {n: torch.tensor(w0[n]) for n in tr.param_names}
    states = tr.init_opt_state()
    buf = tr.input_buffers()
    buf["data"].copy_(torch.tensor(x))
    buf["softmax_label"].copy_(torch.tensor(y))
    fused, lrs = [], []
    for _ in range(steps):
        tr.step(params, {}, states)
        lrs.append(tr.step_lr)
        fused.append({n: params[n].numpy().copy() for n in names})
    return serial, fused, lrs


@pytest.mark.parametrize("name,kwargs", FUSED, ids=FUSED_IDS)
def test_fused_rule_matches_serial_updater(name, kwargs):
    if "lr_scheduler" in kwargs:
        kwargs = dict(kwargs, lr_scheduler=None)
    serial, fused, _ = _fused_vs_serial(name, kwargs, 3)
    for k, (s, f) in enumerate(zip(serial, fused)):
        for n in s:
            np.testing.assert_allclose(f[n], s[n], rtol=TOL, atol=TOL,
                                       err_msg="%s step %d" % (n, k))


def test_fused_scheduler_boundary_skew():
    """MultiFactorScheduler(step=[3]): the fused step writes the schedule's
    rate at the step's count (0.1, 0.1, 0.1, 0.1, 0.01); the serial Updater
    evaluates it per parameter as the count advances, so on step 3 its
    second parameter already takes 0.01: equal before the boundary step,
    apart on it (the first parameter still equal), the JAX package's
    documented one-step skew."""
    serial, fused, lrs = _fused_vs_serial("sgd", OPTS[-1][1], 5)
    np.testing.assert_allclose(lrs, [0.1, 0.1, 0.1, 0.1, 0.01])
    for k in range(3):
        for n in serial[k]:
            np.testing.assert_allclose(fused[k][n], serial[k][n], rtol=TOL,
                                       atol=TOL)
    np.testing.assert_allclose(fused[3]["fc_weight"], serial[3]["fc_weight"],
                               rtol=TOL, atol=TOL)
    assert np.abs(fused[3]["fc_bias"] - serial[3]["fc_bias"]).max() > 1e-4


def test_make_rule_names_the_jax_rules():
    for name, kwargs in FUSED:
        o = _make(tmx, name, dict(kwargs, lr_scheduler=None))
        assert fused_opt.supported(o)
    for name in ("sgld", "dcasgd", "test"):
        assert not fused_opt.supported(tmx.optimizer.create(name))
    with pytest.raises(ValueError, match="Ftrl"):
        fused_opt.make_rule(tmx.optimizer.create("sgld"))


def test_rmsprop_fused_states_load_both_layouts():
    """The fused RMSProp rule writes its one slot as the serial Updater's
    1-tuple and reads the JAX fused path's bare array too."""
    rule = fused_opt.make_rule(tmx.optimizer.RMSProp())
    st = rule.init_state((2, 2), "cpu")
    assert isinstance(rule.to_serial(st), tuple) and len(rule.to_serial(st)) == 1
    bare = np.ones((2, 2), np.float32)
    assert len(rule.from_serial(bare)) == 1
    assert len(rule.from_serial((bare,))) == 1


# ------------------------------------------------------------ initializers
def _init_both(make, name, shape):
    j = jmx.nd.zeros(shape)
    t = tmx.nd.zeros(shape, ctx=tmx.cpu())
    make(jmx)(jmx.initializer.InitDesc(name), j)
    make(tmx)(tmx.initializer.InitDesc(name), t)
    return j.asnumpy(), t.asnumpy()


@pytest.mark.parametrize("case", ["constant", "bilinear", "upsampling", "load",
                                  "mixed"])
def test_deterministic_initializers_match_jax(case):
    src = np.random.RandomState(2).randn(3, 4).astype(np.float32)
    make, name, shape = {
        "constant": (lambda mx: mx.init.Constant(0.37), "c_weight", (3, 4)),
        "bilinear": (lambda mx: mx.init.Bilinear(), "up_weight", (2, 1, 4, 4)),
        "upsampling": (lambda mx: mx.init.Zero(), "x_upsampling", (1, 1, 6, 6)),
        "load": (lambda mx: mx.init.Load({"arg:l_weight": src},
                                         default_init=mx.init.One()),
                 "l_weight", (3, 4)),
        "mixed": (lambda mx: mx.init.Mixed(["^b_", ".*"],
                                           [mx.init.Constant(2.0), mx.init.One()]),
                  "b_weight", (3, 4)),
    }[case]
    j, t = _init_both(make, name, shape)
    np.testing.assert_array_equal(t, j)


def test_load_and_mixed_fall_back_and_raise():
    ld = tmx.init.Load({"a_weight": np.zeros((2, 2), np.float32)},
                       default_init=tmx.init.Constant(3.0))
    arr = tmx.nd.zeros((2,), ctx=tmx.cpu())
    ld("other_weight", arr)
    assert np.all(arr.asnumpy() == 3.0)
    with pytest.raises(AssertionError):
        tmx.init.Load({"a_weight": np.zeros((2, 2), np.float32)})("b", arr)
    with pytest.raises(AssertionError):
        ld("a_weight", tmx.nd.zeros((3,), ctx=tmx.cpu()))
    with pytest.raises(ValueError, match="did not match"):
        tmx.init.Mixed(["^x"], [tmx.init.One()])("y_weight", arr)


@pytest.mark.parametrize("shape,rand_type", [((6, 10), "uniform"),
                                             ((4, 2, 3, 3), "normal"),
                                             ((12, 5), "uniform")])
def test_orthogonal_is_orthogonal(shape, rand_type):
    arr = tmx.nd.zeros(shape, ctx=tmx.cpu())
    tmx.init.Orthogonal(scale=1.5, rand_type=rand_type,
                        rng=torch.Generator().manual_seed(0))("o_weight", arr)
    q = arr.asnumpy().reshape(shape[0], -1)
    small = min(q.shape)
    gram = q @ q.T if q.shape[0] == small else q.T @ q
    np.testing.assert_allclose(gram, 1.5 ** 2 * np.eye(small), atol=1e-5)


def test_msraprelu_variance_and_dumps():
    slope = 0.25
    shape = (256, 64, 3, 3)
    arr = tmx.nd.zeros(shape, ctx=tmx.cpu())
    init = tmx.init.MSRAPrelu(factor_type="in", slope=slope,
                              rng=torch.Generator().manual_seed(1))
    init("m_weight", arr)
    x = arr.asnumpy().ravel()
    want = 2.0 / (1 + slope ** 2) / (64 * 9)
    assert abs(x.var() - want) <= 5 * want * math.sqrt(2.0 / x.size)
    assert abs(x.mean()) <= 5 * math.sqrt(want / x.size)
    assert init.dumps() == jmx.init.MSRAPrelu(factor_type="in", slope=slope).dumps()


# ------------------------------------------------------------------ metrics
def _metric_case(rng):
    labels = rng.randint(0, 6, (10,)).astype(np.float32)
    preds = rng.rand(10, 6).astype(np.float32)
    return labels, preds


@pytest.mark.parametrize("name,kwargs", [
    ("top_k_accuracy", {"top_k": 3}), ("top_k_accuracy", {"top_k": 5}),
    ("topkaccuracy", {"top_k": 2}), ("acc", {}), ("f1", {}), ("mae", {}),
    ("mse", {}), ("rmse", {}), ("loss", {}), ("torch", {}), ("caffe", {}),
    ("ce", {})])
def test_metric_matches_jax(name, kwargs):
    rng = np.random.RandomState(4)
    jm, tm = (mx.metric.create(name, **kwargs) for mx in (jmx, tmx))
    assert type(tm).__name__ == type(jm).__name__
    for _ in range(3):
        labels, preds = _metric_case(rng)
        if name == "f1":
            labels = (labels > 2).astype(np.float32)
            preds = preds[:, :2]
        if name in ("mae", "mse", "rmse"):
            preds = preds[:, :1]
        if name == "ce":
            preds = preds / preds.sum(1, keepdims=True)
        jm.update([jmx.nd.array(labels)], [jmx.nd.array(preds)])
        tm.update([tmx.nd.array(labels, ctx=tmx.cpu())],
                  [tmx.nd.array(preds, ctx=tmx.cpu())])
    (jn, jv), (tn, tv) = jm.get(), tm.get()
    assert tn == jn
    np.testing.assert_allclose(tv, jv, rtol=1e-6)


def test_topk_flat_predictions_and_custom_metrics():
    rng = np.random.RandomState(5)
    labels = rng.randint(0, 4, (12,)).astype(np.float32)
    ids = rng.randint(0, 4, (12,)).astype(np.float32)
    res = []
    for mx, ctx in ((jmx, jmx.cpu()), (tmx, tmx.cpu())):
        m = mx.metric.TopKAccuracy(top_k=3)
        m.update([mx.nd.array(labels, ctx=ctx)], [mx.nd.array(ids, ctx=ctx)])

        def half_abs(label, pred):
            return float(np.abs(label - pred.ravel()).sum() / 2), label.size

        c1 = mx.metric.create(half_abs)
        c2 = mx.metric.np(lambda label, pred: float(np.mean(pred)), name="mp")
        for c in (c1, c2):
            c.update([mx.nd.array(labels, ctx=ctx)], [mx.nd.array(ids, ctx=ctx)])
        res.append((m.get(), c1.get(), c2.get()))
    assert res[0] == res[1]
    with pytest.raises(ValueError):
        tmx.metric.TopKAccuracy(top_k=1)
    with pytest.raises(ValueError, match="Metric must"):
        tmx.metric.create("no-such-metric")
