"""The port's data-parallel fused step (A6d) against the JAX package's.

``SPMDTrainer`` over a ``dp`` mesh of CPU positions (``with mx.cpu():
build_mesh(...)``; the CPU is one torch device, so the positions repeat
it, C37) against the JAX package's trainer over its 2 and 4 host devices
(``tests/conftest.py``), fed the same numpy inputs from seeds: the ten
fused rules, global BatchNorm statistics, the loss heads' global
normalizations, Dropout's masks, ``param_rules``, ``Module.fit`` over
two CPU contexts, bucketing over one shared mesh state, the vetoes, and
a two-worker ``dist_sync_device`` cluster with two positions each. Every
op of the registry runs both ways (the global batch, and its blocks at
the positions joined): each agrees, or the trainer refuses it and names
it.
"""
import os
import pickle
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as J
import mxnet_tpu_torch as T
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.executor import build_graph_fn
from mxnet_tpu_torch.ops import registry as TR
from mxnet_tpu_torch.parallel import build_mesh, collectives as C, dp as DP
from mxnet_tpu_torch.parallel.spmd import SPMDTrainer
from mxnet_tpu_torch.test_utils import op_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH, DIM, HID = 8, 6, 4
STEPS = 3


@pytest.fixture(autouse=True)
def _on_the_cpu():
    # the port's current context is the card's unless asked (C14)
    with T.cpu():
        yield


def _mesh(n, axes=None):
    with T.cpu():
        return build_mesh(axes or {"dp": n})


def _jax_mesh(n, axes=None):
    import jax
    from mxnet_tpu.parallel import build_mesh as jbuild

    return jbuild(axes or {"dp": n}, jax.devices("cpu")[:n])


def _mlp(mx, norm="null", **kw):
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data, num_hidden=HID, name="fc")
    return mx.sym.SoftmaxOutput(fc, name="softmax", normalization=norm, **kw)


def _data(seed=7, batch=BATCH, dim=DIM, classes=HID):
    rng = np.random.RandomState(seed)
    x = rng.rand(batch, dim).astype(np.float32)
    y = rng.randint(0, classes, (batch,)).astype(np.float32)
    return x, y


def _weights(shapes, names, seed=3):
    rng = np.random.RandomState(seed)
    return {n: (rng.rand(*shapes[n]).astype(np.float32) - 0.5) for n in names}


def _aux0(shapes, names):
    return {n: (np.ones if "var" in n else np.zeros)(shapes[n], np.float32)
            for n in names}


def _port_run(net, mesh, inputs, opt, opt_params, w0, steps=STEPS,
              param_rules=None, seed=None, compute_dtype=None, aux0=None):
    """``steps`` fused steps of the port's trainer: (params, auxs, the last
    step's outputs, trainer), whole, as numpy."""
    shapes = {n: v.shape for n, v in inputs.items()}
    data = [(n, s) for n, s in shapes.items() if n == "data"]
    label = [(n, s) for n, s in shapes.items() if n != "data"]
    tr = SPMDTrainer(net, mesh, data, opt, dict(opt_params), label_shapes=label,
                     param_rules=param_rules, compute_dtype=compute_dtype)
    params = tr.place({n: torch.tensor(w0[n]) for n in tr.param_names})
    a0 = aux0 or _aux0(tr.aux_shapes, tr.aux_names)
    auxs = tr.place({n: torch.tensor(a0[n]) for n in tr.aux_names})
    states = tr.init_opt_state()
    buf = tr.input_buffers()
    for n, v in inputs.items():
        buf[n].copy_(torch.tensor(v))
    if seed is not None:
        T.random.seed(seed)
    outs = None
    for _ in range(steps):
        outs = tr.step(params, auxs, states)
    whole = lambda d: {n: tr.gather(n, v).numpy().copy() for n, v in d.items()}
    return whole(params), whole(auxs), [o.numpy().copy() for o in outs], tr


def _jax_run(net, n, inputs, opt, opt_params, w0, steps=STEPS, aux0=None,
             compute_dtype=None):
    import jax

    from mxnet_tpu.parallel.spmd import SPMDTrainer as JTrainer

    shapes = {k: v.shape for k, v in inputs.items()}
    with jax.default_matmul_precision("highest"):
        tr = JTrainer(net, _jax_mesh(n),
                      data_shapes=[(k, s) for k, s in shapes.items() if k == "data"],
                      label_shapes=[(k, s) for k, s in shapes.items() if k != "data"],
                      optimizer=opt, optimizer_params=dict(opt_params),
                      compute_dtype=compute_dtype)
        params = {k: jax.device_put(w0[k], tr.param_shardings[k])
                  for k in tr.param_names}
        a0 = aux0 or _aux0(tr.aux_shapes, tr.aux_names)
        auxs = {k: jax.device_put(a0[k], tr.repl) for k in tr.aux_names}
        states = tr.init_opt_state()
        outs = None
        for _ in range(steps):
            params, auxs, states, outs = tr.step(params, auxs, states, inputs)
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in auxs.items()},
            [np.asarray(o) for o in outs])


def _close(got, want, rtol, atol, what=""):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg="%s %s" % (what, k))


# ---------------------------------------------------------------------------
# the ten fused rules at dp 2, against the JAX package's dp 2 trainer
# ---------------------------------------------------------------------------
OPTS = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01, "rescale_grad": 1.0 / BATCH}),
    ("sgd", {"learning_rate": 0.1, "rescale_grad": 1.0 / BATCH}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01,
             "clip_gradient": 0.02, "rescale_grad": 1.0 / BATCH}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01, "rescale_grad": 1.0 / BATCH}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01, "rescale_grad": 1.0 / BATCH}),
    ("adagrad", {"learning_rate": 0.1, "wd": 0.01, "rescale_grad": 1.0 / BATCH}),
    ("rmsprop", {"learning_rate": 0.01, "wd": 0.01, "rescale_grad": 1.0 / BATCH}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True, "clip_weights": 0.8,
                 "rescale_grad": 1.0 / BATCH}),
    ("adadelta", {"wd": 0.01, "rescale_grad": 1.0 / BATCH}),
    ("ftrl", {"learning_rate": 0.1, "wd": 0.01, "rescale_grad": 1.0 / BATCH}),
]


@pytest.mark.parametrize("name,kwargs", OPTS,
                         ids=["%s-%d" % (n, i) for i, (n, _) in enumerate(OPTS)])
def test_dp2_rule_matches_the_jax_dp2_trainer(name, kwargs):
    x, y = _data()
    inputs = {"data": x, "softmax_label": y}
    net = _mlp(T)
    w0 = _weights(dict(zip(net.list_arguments(), net.infer_shape(
        data=x.shape, softmax_label=y.shape)[0])), ["fc_weight", "fc_bias"])
    got, _, _, tr = _port_run(net, _mesh(2), inputs, name, kwargs, w0)
    assert tr.dp == 2 and tr.mesh.size == 2
    want, _, _ = _jax_run(_mlp(J), 2, inputs, name, kwargs, w0)
    _close(got, want, 2e-5, 2e-6, name)
    assert all(np.abs(got[k] - w0[k]).max() > 0 for k in w0)


def test_dp_1_2_4_agree_and_the_batch_must_split():
    x, y = _data()
    inputs = {"data": x, "softmax_label": y}
    net = _mlp(T, "batch")
    w0 = _weights({"fc_weight": (HID, DIM), "fc_bias": (HID,)},
                  ["fc_weight", "fc_bias"])
    runs = [_port_run(net, _mesh(n), inputs, "adam", {"learning_rate": 0.05},
                      w0) for n in (1, 2, 4)]
    for got in runs[1:]:
        _close(got[0], runs[0][0], 0, 1e-6, "params")
        np.testing.assert_allclose(got[2][0], runs[0][2][0], rtol=0, atol=1e-6)
    with pytest.raises(MXNetError, match="does not split over dp=3"):
        SPMDTrainer(net, _mesh(3), [("data", (BATCH, DIM))], "sgd",
                    label_shapes=[("softmax_label", (BATCH,))])


# ---------------------------------------------------------------------------
# ops that read the whole batch
# ---------------------------------------------------------------------------
def _conv_bn(mx):
    data = mx.sym.Variable("data")
    c = mx.sym.Convolution(data, num_filter=4, kernel=(3, 3), pad=(1, 1),
                           name="conv")
    b = mx.sym.BatchNorm(c, fix_gamma=False, name="bn")
    a = mx.sym.Activation(b, act_type="relu")
    p = mx.sym.Pooling(a, global_pool=True, kernel=(1, 1), pool_type="avg")
    f = mx.sym.FullyConnected(mx.sym.Flatten(p), num_hidden=3, name="fc")
    return mx.sym.SoftmaxOutput(f, name="softmax")


def test_batchnorm_takes_global_statistics():
    rng = np.random.RandomState(5)
    x = rng.randn(8, 2, 5, 5).astype(np.float32) * 2 + 1
    y = rng.randint(0, 3, (8,)).astype(np.float32)
    inputs = {"data": x, "softmax_label": y}
    net = _conv_bn(T)
    arg_shapes, _, aux_shapes = net.infer_shape(data=x.shape, softmax_label=y.shape)
    shapes = dict(zip(net.list_arguments(), arg_shapes))
    names = [n for n in net.list_arguments() if n not in inputs]
    w0 = _weights(shapes, names)
    opt = ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "rescale_grad": 1 / 8})
    p2, a2, _, _ = _port_run(net, _mesh(2), inputs, *opt, w0)
    p1, a1, _, _ = _port_run(_conv_bn(T), _mesh(1), inputs, *opt, w0)
    jp, ja, _ = _jax_run(_conv_bn(J), 2, inputs, *opt, w0)
    _close(p2, jp, 1e-5, 1e-6, "params vs jax")
    _close(a2, ja, 1e-5, 1e-6, "moving stats vs jax")
    _close(p2, p1, 1e-5, 1e-6, "params vs dp 1")
    _close(a2, a1, 1e-5, 1e-6, "moving stats vs dp 1")
    # per-position statistics would have moved the moving mean elsewhere
    halves = [x[:4].mean(axis=(0, 2, 3)), x[4:].mean(axis=(0, 2, 3))]
    assert np.abs(halves[0] - halves[1]).max() > 0.1


@pytest.mark.parametrize("norm,kw", [
    ("valid", {"use_ignore": True, "ignore_label": 1}),
    ("batch", {}),
    ("valid", {"multi_output": True, "use_ignore": True, "ignore_label": 0}),
], ids=["valid-ignore", "batch", "valid-multi_output"])
def test_softmax_output_normalizes_over_the_global_batch(norm, kw):
    rng = np.random.RandomState(9)
    if kw.get("multi_output"):
        x = rng.rand(BATCH, HID, 3).astype(np.float32)
        y = rng.randint(0, HID, (BATCH, 3)).astype(np.float32)
        # position 1's block ignores more labels than position 0's
        y[4:, :2] = 0
    else:
        x, y = _data(11)
        y[4:7] = 1
    inputs = {"data": x, "softmax_label": y}

    def net(mx):
        data = mx.sym.Variable("data")
        if kw.get("multi_output"):
            h = mx.sym.Convolution(data, num_filter=HID, kernel=(1,), name="fc")
        else:
            h = mx.sym.FullyConnected(data, num_hidden=HID, name="fc")
        return mx.sym.SoftmaxOutput(h, name="softmax", normalization=norm, **kw)

    tnet = net(T)
    shapes = dict(zip(tnet.list_arguments(), tnet.infer_shape(
        data=x.shape, softmax_label=y.shape)[0]))
    w0 = _weights(shapes, [n for n in shapes if n not in inputs])
    opt = ("sgd", {"learning_rate": 0.5})
    p2, _, _, _ = _port_run(tnet, _mesh(2), inputs, *opt, w0)
    p1, _, _, _ = _port_run(net(T), _mesh(1), inputs, *opt, w0)
    jp, _, _ = _jax_run(net(J), 2, inputs, *opt, w0)
    _close(p2, jp, 1e-5, 1e-6, "vs jax")
    _close(p2, p1, 1e-5, 1e-6, "vs dp 1")


@pytest.mark.parametrize("norm", ["batch", "valid"])
def test_make_loss_normalizes_over_the_global_batch(norm):
    x, _ = _data(13)
    x[:4] -= 0.6     # position 0's block has fewer outputs above 0

    def net(mx):
        h = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=HID,
                                  name="fc")
        return mx.sym.MakeLoss(h, normalization=norm, name="loss")

    w0 = _weights({"fc_weight": (HID, DIM), "fc_bias": (HID,)},
                  ["fc_weight", "fc_bias"])
    opt = ("sgd", {"learning_rate": 0.1})
    p2, _, _, _ = _port_run(net(T), _mesh(2), {"data": x}, *opt, w0)
    p1, _, _, _ = _port_run(net(T), _mesh(1), {"data": x}, *opt, w0)
    jp, _, _ = _jax_run(net(J), 2, {"data": x}, *opt, w0)
    _close(p2, jp, 1e-5, 1e-6, "vs jax")
    _close(p2, p1, 1e-6, 1e-7, "vs dp 1")


def test_dropout_draws_the_masks_of_the_one_position_step():
    x, y = _data(17)
    inputs = {"data": x, "softmax_label": y}

    def net():
        h = T.sym.FullyConnected(T.sym.Variable("data"), num_hidden=HID, name="fc")
        h = T.sym.Dropout(h, p=0.5, name="drop")
        return T.sym.SoftmaxOutput(h, name="softmax")

    w0 = _weights({"fc_weight": (HID, DIM), "fc_bias": (HID,)},
                  ["fc_weight", "fc_bias"])
    opt = ("sgd", {"learning_rate": 0.3})
    p1, _, o1, _ = _port_run(net(), _mesh(1), inputs, *opt, w0, seed=21)
    after1 = T.random.generator(torch.device("cpu")).get_state()
    p2, _, o2, _ = _port_run(net(), _mesh(2), inputs, *opt, w0, seed=21)
    after2 = T.random.generator(torch.device("cpu")).get_state()
    # three steps drew the same numbers and left the generator alike
    assert torch.equal(after1, after2)
    _close(p2, p1, 0, 1e-6, "params")
    np.testing.assert_allclose(o2[0], o1[0], rtol=0, atol=1e-6)
    # another seed draws other masks
    p3, _, _, _ = _port_run(net(), _mesh(2), inputs, *opt, w0, seed=22)
    assert any(np.abs(p3[k] - p2[k]).max() > 1e-4 for k in p2)


def test_dropout_masks_bitwise_through_the_graph():
    """Straight through the data-parallel graph: two positions draw the
    mask a whole-batch run draws from the same generator state."""
    sym = T.sym.Dropout(T.sym.Variable("data"), p=0.5, name="drop")
    x = torch.ones(8, 5)
    T.random.seed(3)
    want, _ = build_graph_fn(sym)([x], [], True, torch.device("cpu"))
    g = DP.DPGraph(sym, _mesh(2), "dp", {"data": (8, 5)}, {"data"},
                   ["data"], [])
    T.random.seed(3)
    outs, _ = g([[x[:4]], [x[4:]]], [[], []], True)
    torch.testing.assert_close(torch.cat([outs[0][0], outs[1][0]]), want[0],
                               rtol=0, atol=0)
    assert g.how[id(sym._entries[0][0])] == "global"


# ---------------------------------------------------------------------------
# param_rules: storage sharded, numbers unchanged (C38)
# ---------------------------------------------------------------------------
def test_param_rules_shard_storage_and_match_the_unsharded_step_bitwise():
    x, y = _data(23)
    inputs = {"data": x, "softmax_label": y}
    net = _mlp(T)
    w0 = _weights({"fc_weight": (HID, DIM), "fc_bias": (HID,)},
                  ["fc_weight", "fc_bias"])
    opt = ("adam", {"learning_rate": 0.05, "wd": 0.01})
    want, _, _, _ = _port_run(net, _mesh(1), inputs, *opt, w0)
    rules = {r"fc_weight": C.P("tp", None)}
    for axes in ({"dp": 1, "tp": 2}, {"dp": 2, "tp": 2}):
        mesh = _mesh(None, axes)
        got, _, _, tr = _port_run(_mlp(T), mesh, inputs, *opt, w0,
                                  param_rules=rules)
        for k in want:
            if axes["dp"] == 1:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
        assert tr.shard_dims == {"fc_weight": (0, "tp"), "fc_bias": None}
        assert tr.shard_shape("fc_weight") == (HID // 2, DIM)
        st = tr.init_opt_state()
        assert [tuple(s.shape) for s in st["fc_weight"][0]] == [(HID // 2, DIM)] * 2
        assert [tuple(s.shape) for s in st["fc_bias"][0]] == [(HID,)] * 2
    # the JAX package's rules shard the same weight, and train to the same
    import jax

    from mxnet_tpu.parallel.spmd import SPMDTrainer as JTrainer
    from jax.sharding import PartitionSpec as JP

    jtr = JTrainer(_mlp(J), _jax_mesh(2, {"dp": 1, "tp": 2}),
                   data_shapes=[("data", x.shape)],
                   label_shapes=[("softmax_label", y.shape)],
                   optimizer="adam", optimizer_params=opt[1],
                   param_rules={r"fc_weight": JP("tp", None)})
    assert jtr.param_shardings["fc_weight"].spec == JP("tp", None)
    with pytest.raises(MXNetError, match="does not split over tp=3"):
        SPMDTrainer(net, _mesh(None, {"dp": 1, "tp": 3}), [("data", x.shape)],
                    "sgd", label_shapes=[("softmax_label", y.shape)],
                    param_rules=rules)


# ---------------------------------------------------------------------------
# what the trainer refuses, naming it
# ---------------------------------------------------------------------------
def test_a_graph_that_reads_other_positions_rows_is_refused_by_name():
    h = T.sym.FullyConnected(T.sym.Variable("data"), num_hidden=HID, name="fc")
    loss = T.sym.MakeLoss(T.sym.sum(h, name="total"), name="loss")
    with pytest.raises(MXNetError, match=r"op sum \(node total\).*reduces over the batch"):
        SPMDTrainer(loss, _mesh(2), [("data", (BATCH, DIM))], "sgd")
    sm = T.sym.softmax(h, axis=0, name="colsoft")
    net = T.sym.MakeLoss(sm, name="loss")
    with pytest.raises(MXNetError, match=r"op softmax \(node colsoft\).*mixes rows"):
        SPMDTrainer(net, _mesh(2), [("data", (BATCH, DIM))], "sgd")
    # one position computes the whole batch: nothing to refuse
    SPMDTrainer(loss, _mesh(1), [("data", (BATCH, DIM))], "sgd")


def test_state_must_be_one_value_per_position():
    net = _mlp(T)
    tr = SPMDTrainer(net, _mesh(2), [("data", (BATCH, DIM))], "sgd",
                     label_shapes=[("softmax_label", (BATCH,))])
    params = {n: torch.zeros(tr.arg_shapes[n]) for n in tr.param_names}
    with pytest.raises(MXNetError, match="one value per position"):
        tr.step(params, {}, tr.init_opt_state())
    placed = tr.place(params)
    assert all(a.data_ptr() != b.data_ptr() for a, b in placed.values())


# ---------------------------------------------------------------------------
# every op of the registry, both ways
# ---------------------------------------------------------------------------
_NOT_BATCH = {"weight", "bias", "gamma", "beta", "parameters"}
_SWEEP = op_cases(sorted(TR.list_ops()))


def _sweep_graph(case):
    if case.setup is not None:
        case.setup(T)
    op = getattr(T.sym, case.name)
    probe = op(name="probe", **case.attrs)
    n_args = len(probe.list_arguments())
    n_aux = len(probe.list_auxiliary_states())
    args = [T.sym.Variable("in%d" % i) for i in range(n_args)]
    auxs = [T.sym.Variable("aux%d" % i) for i in range(n_aux)]
    sym = (op(*(args + auxs), name="op", **case.attrs) if args or auxs
           else op(name="op", **case.attrs))
    return sym, n_args


def _both_ways(case, force_local=False):
    """Run the case on the global batch and over n positions (n the least
    divisor of its leading size), outputs joined, input gradients joined
    or summed. Returns ("agree"|"differ"|"refused"|"skip", detail)."""
    sym, n_args = _sweep_graph(case)
    ins = case.inputs
    if not n_args or ins[0].ndim == 0 or ins[0].shape[0] < 2:
        return "skip", "no batch on axis 0 of the first input"
    size = ins[0].shape[0]
    n = min(d for d in range(2, size + 1) if size % d == 0)
    node = sym._entries[0][0]
    names = list(TR.get_op(node.op).arg_names(node.attrs))
    arg_names, aux_names = sym.list_arguments(), sym.list_auxiliary_states()
    batch = {arg_names[i] for i in range(n_args)
             if ins[i].ndim and ins[i].shape[0] == size
             and names[i] not in _NOT_BATCH}
    shapes = {arg_names[i]: ins[i].shape for i in range(n_args)}
    classify = DP.classify
    if force_local:
        DP.classify = lambda op, *a: "global" if op.stochastic(a[0]) else "local"
    try:
        g = DP.DPGraph(sym, _mesh(n), "dp", shapes, batch, arg_names, aux_names)
    except MXNetError as e:
        return "refused", str(e)
    finally:
        DP.classify = classify
    grad = lambda a: bool(case.grad and a.dtype.kind == "f")
    T.random.seed(7)
    leaves = [torch.tensor(a).requires_grad_(grad(a)) for a in ins[:n_args]]
    outs, new_aux = build_graph_fn(sym)(
        leaves, [torch.tensor(a) for a in ins[n_args:]], case.train,
        torch.device("cpu"))
    r = np.random.RandomState(11)
    heads = [torch.tensor(r.standard_normal(tuple(o.shape))).to(o.dtype)
             if o.is_floating_point() else None for o in outs]
    want_leaves = [l for l in leaves if l.requires_grad]
    pairs = [(o, h) for o, h in zip(outs, heads) if h is not None and o.requires_grad]
    want_g = (torch.autograd.grad([o for o, _ in pairs], want_leaves,
                                  [h for _, h in pairs], allow_unused=True)
              if pairs and want_leaves else [])
    T.random.seed(7)
    args_pp = []
    for p in range(n):
        row = []
        for i in range(n_args):
            a = ins[i]
            if arg_names[i] in batch:
                b = size // n
                a = a[p * b:(p + 1) * b]
            row.append(torch.tensor(a).requires_grad_(grad(ins[i])))
        args_pp.append(row)
    outs_pp, aux_pp = g(args_pp, [[torch.tensor(a) for a in ins[n_args:]]
                                  for _ in range(n)], case.train)
    axes = g.output_axes()
    bad = []

    def close(x, y):
        if x is None or y is None:
            return all(v is None or not torch.any(v != 0) for v in (x, y))
        x, y = x.detach().double(), y.detach().double()
        return x.shape == y.shape and bool(
            torch.allclose(x, y, rtol=1e-5, atol=1e-5, equal_nan=True))

    for k, a in enumerate(axes):
        got = (outs_pp[0][k] if a is None else
               torch.cat([outs_pp[p][k] for p in range(n)], dim=a))
        if not close(got, outs[k]):
            bad.append("output %d" % k)
    for k, a in enumerate(new_aux):
        if not all(close(aux_pp[p][k], a) for p in range(n)):
            bad.append("aux %d" % k)
    prs = []
    for k, (a, h) in enumerate(zip(axes, heads)):
        for p in range(n):
            o = outs_pp[p][k]
            if h is None or not o.requires_grad or (a is None and p):
                continue
            b = None if a is None else h.shape[a] // n
            prs.append((o, h if a is None else h.narrow(a, p * b, b)))
    flat = [l for row in args_pp for l in row if l.requires_grad]
    got_g = (torch.autograd.grad([o for o, _ in prs], flat, [h for _, h in prs],
                                 allow_unused=True) if prs and flat else [])
    if want_g:
        it = iter(got_g)
        per = {}
        for row in args_pp:
            for i, l in enumerate(row):
                if l.requires_grad:
                    per.setdefault(i, []).append(next(it))
        k = 0
        for i, l in enumerate(leaves):
            if not l.requires_grad:
                continue
            gs = [z if z is not None else torch.zeros_like(args_pp[p][i])
                  for p, z in enumerate(per[i])]
            tot = torch.cat(gs) if arg_names[i] in batch else sum(gs[1:], gs[0])
            if not close(tot, want_g[k]):
                bad.append("gradient of %s" % arg_names[i])
            k += 1
    return ("differ" if bad else "agree"), ", ".join(bad)


@pytest.mark.parametrize("cid", sorted(_SWEEP))
def test_every_op_both_ways(cid):
    """The global batch against the positions' blocks joined: they agree,
    or the data-parallel graph refuses the op by name. A refusal for
    mixing rows is a real one: forced to run per position, it differs."""
    case = _SWEEP[cid]
    res, why = _both_ways(case)
    assert res in ("agree", "refused", "skip"), (cid, res, why)
    if res == "refused":
        assert "op %s (node op)" % case.name in why \
            or "auxiliary state" in why or "do not infer" in why, why
        if "mixes rows" in why:
            assert _both_ways(case, force_local=True)[0] == "differ", cid


# ---------------------------------------------------------------------------
# the split step (grad_step / apply_grads) over a mesh
# ---------------------------------------------------------------------------
def test_grad_step_and_apply_grads_over_a_mesh_are_the_step():
    x, y = _data(29)
    net = _mlp(T)
    w0 = _weights({"fc_weight": (HID, DIM), "fc_bias": (HID,)},
                  ["fc_weight", "fc_bias"])
    want, _, _, _ = _port_run(net, _mesh(2), {"data": x, "softmax_label": y},
                              "adam", {"learning_rate": 0.05}, w0, steps=2)
    tr = SPMDTrainer(_mlp(T), _mesh(2), [("data", x.shape)], "adam",
                     {"learning_rate": 0.05},
                     label_shapes=[("softmax_label", y.shape)])
    params = tr.place({n: torch.tensor(w0[n]) for n in tr.param_names})
    states = tr.init_opt_state()
    tr.input_buffers()["data"].copy_(torch.tensor(x))
    tr.input_buffers()["softmax_label"].copy_(torch.tensor(y))
    for _ in range(2):
        tr.grad_step(params, {})
        for n in tr.param_names:   # both positions hold the summed gradient
            torch.testing.assert_close(tr.grad_buffers(1)[n],
                                       tr.grad_buffers(0)[n], rtol=0, atol=0)
        tr.apply_grads(params, states)
    for n in want:
        np.testing.assert_array_equal(tr.gather(n, params[n]).numpy(), want[n])


# ---------------------------------------------------------------------------
# Module.fit over several contexts
# ---------------------------------------------------------------------------
MB, MDIM, MCLASSES = 16, 12, 6


def _mod_net(mx):
    data = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    h = mx.sym.Activation(h, act_type="relu")
    h = mx.sym.FullyConnected(h, num_hidden=MCLASSES, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _mod_iter(mx, n=64, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, MDIM).astype(np.float32)
    y = rng.randint(0, MCLASSES, (n,)).astype(np.float32)
    return mx.io.NDArrayIter(X, y, batch_size=MB)


def _mod_init(net, mx):
    shapes = dict(zip(net.list_arguments(), net.infer_shape(
        data=(MB, MDIM), softmax_label=(MB,))[0]))
    w = _weights(shapes, [n for n in shapes if n not in ("data", "softmax_label")], 5)
    return {k: mx.nd.array(v) for k, v in w.items()}


def test_module_fit_over_two_cpu_contexts_is_fused_and_matches_jax():
    opt_params = {"learning_rate": 0.3, "momentum": 0.9, "wd": 0.001}
    got = {}
    for name, mx, ctx in (("port", T, [T.cpu(0), T.cpu(1)]),
                          ("jax", J, [J.cpu(0), J.cpu(1)]),
                          ("one", T, [T.cpu(0)])):
        net = _mod_net(mx)
        mod = mx.mod.Module(net, context=ctx)
        mod.fit(_mod_iter(mx), num_epoch=2, optimizer="sgd",
                optimizer_params=dict(opt_params), kvstore="device",
                arg_params=_mod_init(net, mx))
        assert mod._fused is not None, name
        got[name] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
        if name == "port":
            st = mod._fused.state
            assert st.mesh.size == 2 and st.mesh.shape == {"dp": 2}
            assert mod._fused.trainer.dp == 2
            # replicas, never aliases, and equal after the fit
            for n, reps in st.pos_params.items():
                assert reps[0] is st.params[n]
                assert reps[0].data_ptr() != reps[1].data_ptr()
                torch.testing.assert_close(reps[0], reps[1], rtol=0, atol=0)
    _close(got["port"], got["jax"], 1e-5, 1e-5, "port vs jax")
    _close(got["port"], got["one"], 1e-5, 1e-5, "dp 2 vs one context")


def test_fused_two_contexts_get_params_is_coherent_and_writes_reach_every_replica():
    mod = T.mod.Module(_mod_net(T), context=[T.cpu(0), T.cpu(1)])
    it = _mod_iter(T)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(T.init.Xavier())
    mod.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    assert mod._fused is not None
    batch = next(iter(it))
    before = {n: a.asnumpy().copy() for n, a in mod.get_params()[0].items()}
    mod.forward_backward(batch)
    mod.update()
    after = mod.get_params()[0]
    assert any(np.abs(after[n].asnumpy() - before[n]).max() > 0 for n in before)
    assert mod.get_outputs()[0].shape == (MB, MCLASSES)
    mod.set_params({n: T.nd.array(v) for n, v in before.items()}, {},
                   force_init=True)
    mod.forward_backward(batch)
    mod.update()
    st = mod._fused.state
    for n, reps in st.pos_params.items():
        torch.testing.assert_close(reps[0], reps[1], rtol=0, atol=0)


def test_fused_two_contexts_states_files_in_both_layouts():
    mod = T.mod.Module(_mod_net(T), context=[T.cpu(0), T.cpu(1)])
    it = _mod_iter(T)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(T.init.Xavier())
    mod.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    fused = mod._fused
    names = fused.trainer.param_names
    rng = np.random.RandomState(0)
    mom = {n: rng.rand(*fused.trainer.arg_shapes[n]).astype(np.float32)
           for n in names}
    stride = {i * 2 + k: mom[n] for i, n in enumerate(names) for k in range(2)}
    fused.set_states_bytes(pickle.dumps(stride))
    canon = pickle.loads(fused.get_states_bytes())
    assert set(canon) == set(range(len(names)))
    for i, n in enumerate(names):
        np.testing.assert_allclose(canon[i], mom[n])
    mod.forward_backward(next(iter(it)))
    mod.update()
    # the staged slots reached both positions before the step
    st = fused.state
    for n in names:
        torch.testing.assert_close(st.pos_states[n][0][0], st.pos_states[n][1][0],
                                   rtol=0, atol=0)
    # without update_on_kvstore the file is one copy per context, as the
    # JAX package writes it
    mod._update_on_kvstore = False
    per_dev = pickle.loads(fused.get_states_bytes())
    assert set(per_dev) == set(range(2 * len(names)))
    for i in range(len(names)):
        np.testing.assert_array_equal(per_dev[2 * i], per_dev[2 * i + 1])


def _bucket_sym_gen(mx):
    def gen(key):
        data = mx.sym.Variable("data")
        pooled = mx.sym.sum(data, axis=1)
        h = mx.sym.FullyConnected(pooled, num_hidden=16, name="bfc1")
        h = mx.sym.Activation(h, act_type="relu")
        h = mx.sym.FullyConnected(h, num_hidden=MCLASSES, name="bfc2")
        return mx.sym.SoftmaxOutput(h, name="softmax"), ("data",), ("softmax_label",)
    return gen


def _bucketed(mx, ctx):
    rng = np.random.RandomState(0)
    bmod = mx.mod.BucketingModule(_bucket_sym_gen(mx), default_bucket_key=5,
                                  context=ctx)
    bmod.bind([("data", (MB, 5, MDIM))], [("softmax_label", (MB,))])
    bmod.init_params(mx.init.One())
    bmod.init_optimizer(kvstore="device", optimizer="sgd",
                        optimizer_params={"learning_rate": 0.02, "momentum": 0.9})
    for i in range(6):
        seq = 3 if i % 2 else 5
        X = rng.rand(MB, seq, MDIM).astype(np.float32)
        y = rng.randint(0, MCLASSES, (MB,)).astype(np.float32)
        batch = mx.io.DataBatch(
            [mx.nd.array(X)], [mx.nd.array(y)], pad=0, bucket_key=seq,
            provide_data=[mx.io.DataDesc("data", (MB, seq, MDIM))],
            provide_label=[mx.io.DataDesc("softmax_label", (MB,))])
        bmod.forward(batch, is_train=True)
        bmod.backward()
        bmod.update()
    return bmod, {k: v.asnumpy() for k, v in bmod.get_params()[0].items()}


def test_bucketing_over_one_shared_mesh_state_matches_jax():
    bmod, got = _bucketed(T, [T.cpu(0), T.cpu(1)])
    _, want = _bucketed(J, [J.cpu(0), J.cpu(1)])
    mods = list(bmod._buckets.values())
    assert len(mods) == 2 and all(m._fused is not None for m in mods)
    assert len({id(m._fused.state) for m in mods}) == 1
    assert len({id(m._fused.trainer.mesh) for m in mods}) == 1
    assert all(m._fused.trainer._graphs["step"].warm
               and m._fused.trainer.dp == 2 for m in mods)
    _close(got, want, 1e-5, 1e-5, "bucketed dp 2 vs jax")


def test_vetoes_the_same_context_twice_and_mixed_types():
    it = _mod_iter(T)
    for ctx, jctx, why in (
            ([T.cpu(0), T.cpu(0)], None, "the same context is named twice"),
            ([T.cpu(0), T.gpu(0)], [J.cpu(0), J.tpu(0)],
             "mixed device types in context list")):
        mod = T.mod.Module(_mod_net(T), context=ctx)
        mod._grad_req = "write"     # the rules a bind would reach
        assert mod._fused_veto("device").startswith(why)
        if jctx is not None:
            jmod = J.mod.Module(_mod_net(J), context=jctx)
            jmod._grad_req = "write"
            assert jmod._fused_veto("device") == why
    mod = T.mod.Module(_mod_net(T), context=[T.cpu(0), T.cpu(1)])
    mod.bind(it.provide_data, it.provide_label)
    assert mod._fused_veto("device") is None
    assert mod._fused_veto("dist_sync_device") is None
    assert "A6d" not in (mod._fused_veto("local") or "")


# ---------------------------------------------------------------------------
# dist_sync_device: two workers, two local positions each
# ---------------------------------------------------------------------------
DIST_WORKER = r"""
import os
import numpy as np
import mxnet_tpu_torch as mx

with mx.cpu():
    kv = mx.kv.create("dist_sync_device")
    rank = kv.rank
    r = np.random.RandomState(0)
    X = r.randn(64, 6).astype(np.float32)
    Y = (X[:, 0] + X[:, 1] > 0).astype(np.float32) + (X[:, 2] > 1)
    shard = slice(rank, None, kv.num_workers)
    h = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=16, name="fc1")
    h = mx.sym.Activation(h, act_type="relu")
    h = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
    net = mx.sym.SoftmaxOutput(h, name="softmax")
    init = mx.init.Xavier(rng=__import__("torch").Generator().manual_seed(rank))
    mod = mx.mod.Module(net, context=[mx.cpu(0), mx.cpu(1)])
    mod.fit(mx.io.NDArrayIter(X[shard], Y[shard], batch_size=8), num_epoch=2,
            kvstore=kv, initializer=init, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    assert mod._fused is not None and mod._fused._dist_kv() is kv
    assert mod._fused.state.mesh.size == 2
    st = mod._fused.state
    for n, reps in st.pos_params.items():
        assert bool((reps[0] == reps[1]).all()), n
    params = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    np.savez(os.path.join(os.environ["OUT_DIR"], "dp-%d.npz" % rank), **params)
    kv.barrier()
    if rank == 0:
        kv._stop_servers()
print("WORKER_OK", rank)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_dist_sync_device_with_two_local_positions_per_worker(tmp_path):
    """Two workers, each ``Module(context=[cpu(0), cpu(1)])`` under
    ``dist_sync_device``: the hybrid step sums over the local positions,
    then the servers sum over the workers. Both workers end bitwise
    equal, and equal a one-process fused fit of the joined batches."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("DMLC_")}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OUT_DIR"] = str(tmp_path)
    env.setdefault("OMP_NUM_THREADS", "2")
    path = str(tmp_path / "worker.py")
    with open(path, "w") as f:
        f.write(DIST_WORKER)
    cmd = [sys.executable, os.path.join(ROOT, "tools", "launch.py"), "-n", "2",
           "-s", "1", "--port", str(_free_port()), sys.executable, path]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError("cluster hung: %s %s" % (out, err[-4000:]))
    assert proc.returncode == 0 and out.count("WORKER_OK") == 2, (out, err[-4000:])
    w = [dict(np.load(str(tmp_path / ("dp-%d.npz" % r)))) for r in (0, 1)]
    for k in w[0]:
        np.testing.assert_array_equal(w[0][k], w[1][k], err_msg=k)
    # the same global batches in one process: batch i is worker 0's batch
    # i then worker 1's, and rank 0's initial weights
    r = np.random.RandomState(0)
    X = r.randn(64, 6).astype(np.float32)
    Y = (X[:, 0] + X[:, 1] > 0).astype(np.float32) + (X[:, 2] > 1)
    xs, ys = [X[0::2], X[1::2]], [Y[0::2], Y[1::2]]
    order = np.concatenate([np.concatenate([xs[k][i:i + 8] for k in (0, 1)])
                            for i in range(0, 32, 8)])
    lorder = np.concatenate([np.concatenate([ys[k][i:i + 8] for k in (0, 1)])
                             for i in range(0, 32, 8)])
    with T.cpu():
        h = T.sym.FullyConnected(T.sym.Variable("data"), num_hidden=16, name="fc1")
        h = T.sym.Activation(h, act_type="relu")
        h = T.sym.FullyConnected(h, num_hidden=3, name="fc2")
        mod = T.mod.Module(T.sym.SoftmaxOutput(h, name="softmax"),
                           context=[T.cpu(0), T.cpu(1)])
        mod.fit(T.io.NDArrayIter(order, lorder, batch_size=16), num_epoch=2,
                kvstore="device", optimizer="sgd",
                initializer=T.init.Xavier(rng=torch.Generator().manual_seed(0)),
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
        want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    _close(w[0], want, 1e-5, 1e-6, "cluster vs one process")


# ---------------------------------------------------------------------------
# the slice as a whole: the Transformer-LM fit over two contexts
# ---------------------------------------------------------------------------
LM = dict(vocab_size=23, num_layers=2, model_dim=32, num_heads=2, ffn_dim=48,
          seq_len=16)


def test_lm_fit_over_two_contexts_matches_the_jax_packages():
    """The zoo Transformer-LM (flash attention at each position: the plain
    version here), ``Module.fit`` over ``[cpu(0), cpu(1)]`` with
    ``kvstore='device'`` in both packages, Adam, 2 epochs of 4 batches:
    5e-5 absolute, as the one-context LM parity test, and against the
    port's one-context fit."""
    import importlib

    import jax

    JLM = importlib.import_module("mxnet_tpu.models.transformer_lm")
    TLM = importlib.import_module("mxnet_tpu_torch.models.transformer_lm")
    with J.name.NameManager():
        js = JLM.get_symbol(**LM)
    with T.name.NameManager():
        ts = TLM.get_symbol(**LM)
    shapes = dict(zip(ts.list_arguments(),
                      ts.infer_shape(data=(4, 16), softmax_label=(4, 16))[0]))
    rng = np.random.RandomState(0)
    params = {n: (rng.randn(*s) * 0.1).astype(np.float32)
              for n, s in shapes.items() if n not in ("data", "softmax_label")}
    rng = np.random.RandomState(1)
    X = ((rng.randint(0, 23, (16, 1)) + np.arange(16)) % 23).astype(np.float32)
    Y = ((X + 1) % 23).astype(np.float32)
    got = {}
    for name, mx, sym, ctx in (("jax", J, js, [J.cpu(0), J.cpu(1)]),
                               ("port", T, ts, [T.cpu(0), T.cpu(1)]),
                               ("one", T, ts, [T.cpu(0)])):
        mod = mx.mod.Module(sym, context=ctx)
        with jax.default_device(jax.devices("cpu")[0]):
            mod.fit(mx.io.NDArrayIter(X, Y, batch_size=4), num_epoch=2,
                    kvstore="device", optimizer="adam",
                    optimizer_params={"learning_rate": 0.01},
                    arg_params={n: mx.nd.array(v) for n, v in params.items()})
        assert mod._fused is not None, name
        got[name] = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
    for n in params:
        np.testing.assert_allclose(got["port"][n], got["jax"][n], rtol=0,
                                   atol=5e-5, err_msg=n)
        np.testing.assert_allclose(got["port"][n], got["one"][n], rtol=0,
                                   atol=5e-5, err_msg=n)
        assert not np.array_equal(got["port"][n], params[n]), n
