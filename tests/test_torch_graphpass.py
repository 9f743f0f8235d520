"""The port's graph-pass pipeline (``mxnet_tpu_torch/graphpass``) against
the JAX package's, on the CPU.

Every pass case of the JAX package's own suite runs on the port: identity
elimination, scalar-chain and init-constant folding, the CSE merge rules,
the fusion-group annotation, the opt-in shape bucketing, the
``MXNET_GRAPH_PASSES`` ladder and the binding-surface fallback. Across
the packages, ``mlp``, ``lenet`` and a small Transformer-LM (vocab 128, 2
layers, d 32, 2 heads, ffn 64, seq 16) built in the JAX package and loaded
into the port from JSON optimize to the same JSON, the same
``symbol_digest`` and the same ``graphpass.*`` counts. The port's
executor with the passes on matches the JAX executor (outputs and
gradients within 1e-5, the JAX package's parity bound) and itself with
the passes off; a fused fit's Dropout masks are the same, bit for bit,
with the passes on and off.
"""
import importlib

import numpy as np
import pytest

import mxnet_tpu as J
import mxnet_tpu_torch as T
from mxnet_tpu.name import NameManager as JNameManager
from mxnet_tpu_torch import compile_cache, compileobs, graphpass, telemetry
from mxnet_tpu_torch.name import NameManager
from mxnet_tpu_torch.ops import sample
from mxnet_tpu_torch.symbol import _topo_order

mx = T
TOL = 1e-5
SMALL_LM = dict(vocab_size=128, num_layers=2, model_dim=32, num_heads=2,
                ffn_dim=64, seq_len=16)


@pytest.fixture(autouse=True)
def _default_passes(monkeypatch):
    monkeypatch.delenv("MXNET_GRAPH_PASSES", raising=False)


def _nodes(sym):
    return _topo_order(sym._entries)


def _n_nodes(sym):
    return len(_nodes(sym))


# ---------------------------------------------------------------------------
# canonicalize: digest stability
# ---------------------------------------------------------------------------

def test_canonicalize_makes_operand_order_irrelevant():
    a, b = mx.sym.Variable("a"), mx.sym.Variable("b")
    lhs = (a * 2.0) + (b * 3.0)
    rhs = (b * 3.0) + (a * 2.0)
    assert compileobs.symbol_digest(
        graphpass.run_pass("canonicalize", lhs)) == \
        compileobs.symbol_digest(graphpass.run_pass("canonicalize", rhs))
    assert compileobs.symbol_digest(graphpass.optimize(lhs)) == \
        compileobs.symbol_digest(graphpass.optimize(rhs))
    assert compileobs.symbol_digest(lhs) != compileobs.symbol_digest(rhs)


def test_canonicalize_preserves_numerics_exactly():
    a, b = mx.sym.Variable("a"), mx.sym.Variable("b")
    s = mx.sym.elemwise_add(b, a)
    c = graphpass.run_pass("canonicalize", s)
    feed = {"a": mx.nd.array([1.5, 2.0], ctx=mx.cpu()),
            "b": mx.nd.array([3.25, -1.0], ctx=mx.cpu())}
    np.testing.assert_array_equal(s.bind(mx.cpu(), dict(feed)).forward()[0].asnumpy(),
                                  c.bind(mx.cpu(), dict(feed)).forward()[0].asnumpy())


def test_digest_distinguishes_variable_slot_wiring():
    a, b, p = (mx.sym.Variable(n) for n in "abp")
    s1 = (a + b) - a
    s2 = (a + p) - p
    assert compileobs.symbol_digest(s1) != compileobs.symbol_digest(s2)
    s3 = (p + b) - p
    assert compileobs.symbol_digest(s1) == compileobs.symbol_digest(s3)


def test_name_binding_never_serves_the_wrong_graph(tmp_path):
    # (a+b)-a computes b, (a+p)-p computes a: the optimized graphs may
    # share a digest, but each executor binds its own arrays by name, with
    # the compile cache on as off
    compile_cache.enable(str(tmp_path / "cc"))
    try:
        a, b, p = (mx.sym.Variable(n) for n in "abp")
        ex1 = ((a + b) - a).bind(mx.cpu(), {
            "a": mx.nd.array([1.0], ctx=mx.cpu()),
            "b": mx.nd.array([2.0], ctx=mx.cpu())})
        np.testing.assert_array_equal(ex1.forward()[0].asnumpy(), [2.0])
        ex2 = ((a + p) - p).bind(mx.cpu(), {
            "a": mx.nd.array([1.0], ctx=mx.cpu()),
            "p": mx.nd.array([5.0], ctx=mx.cpu())})
        np.testing.assert_array_equal(ex2.forward()[0].asnumpy(), [1.0])
    finally:
        compile_cache.disable()


def test_digest_includes_edge_wiring():
    a, b = mx.sym.Variable("a"), mx.sym.Variable("b")
    d1 = compileobs.symbol_digest(mx.sym.elemwise_sub(a, b))
    d2 = compileobs.symbol_digest(mx.sym.elemwise_sub(b, a))
    s1 = mx.sym.elemwise_sub(a * 2.0, b)
    s2 = mx.sym.elemwise_sub(b, a * 2.0)
    assert compileobs.symbol_digest(s1) != compileobs.symbol_digest(s2)
    assert d1 == d2  # names are excluded by design


# ---------------------------------------------------------------------------
# fold_constants
# ---------------------------------------------------------------------------

def test_identity_scalar_ops_eliminated():
    x = mx.sym.Variable("x")
    y = mx.sym.FullyConnected(((x * 1.0) + 0.0) ** 1.0, num_hidden=4,
                              name="fc")
    opt = graphpass.run_pass("fold_constants", y)
    assert _n_nodes(opt) == _n_nodes(y) - 3
    assert [n.op for n in _nodes(opt) if not n.is_variable] == \
        ["FullyConnected"]


def test_scalar_chains_fold():
    x = mx.sym.Variable("x")
    y = mx.sym.FullyConnected(x * 2.0 * 3.0 + 1.0 - 4.0, num_hidden=4)
    opt = graphpass.run_pass("fold_constants", y)
    scalars = [(n.op, n.attrs.get("scalar")) for n in _nodes(opt)
               if not n.is_variable and "scalar" in n.attrs]
    assert ("_mul_scalar", 6.0) in scalars
    assert ("_plus_scalar", -3.0) in scalars
    assert len(scalars) == 2


def test_init_constants_fold_to_full():
    z = mx.sym.ones((3, 4)) * 2.5
    out = mx.sym.FullyConnected(z, num_hidden=2)
    opt = graphpass.run_pass("fold_constants", out)
    inits = [n for n in _nodes(opt)
             if not n.is_variable and n.op in ("_ones", "_full")]
    assert len(inits) == 1 and inits[0].op == "_full"
    assert inits[0].attrs["value"] == 2.5
    ex = graphpass.optimize(z).bind(mx.cpu(), {})
    np.testing.assert_array_equal(ex.forward()[0].asnumpy(),
                                  np.full((3, 4), 2.5, np.float32))


def test_output_nodes_never_eliminated():
    x = mx.sym.Variable("x")
    y = x * 1.0
    opt = graphpass.run_pass("fold_constants", y)
    assert opt.list_outputs() == y.list_outputs()
    assert _n_nodes(opt) == _n_nodes(y)


# ---------------------------------------------------------------------------
# CSE
# ---------------------------------------------------------------------------

def test_cse_merges_identical_subtrees():
    x = mx.sym.Variable("x")
    fc = mx.sym.FullyConnected(x, num_hidden=4, name="fc")
    s = mx.sym.Activation(fc, act_type="relu") + \
        mx.sym.Activation(fc, act_type="relu")
    opt = graphpass.run_pass("eliminate_common_subexpr", s)
    assert _n_nodes(opt) == _n_nodes(s) - 1
    assert len([n for n in _nodes(opt) if n.op == "Activation"]) == 1


@pytest.mark.parametrize("build", [
    lambda x: mx.sym.Dropout(x, p=0.5, name="d1") +
    mx.sym.Dropout(x, p=0.5, name="d2"),
    lambda x: mx.sym.BatchNorm(x, name="bn1") + mx.sym.BatchNorm(x, name="bn2"),
    lambda x: mx.sym.LeakyReLU(x, act_type="leaky", name="l1") +
    mx.sym.LeakyReLU(x, act_type="leaky", name="l2"),
    lambda x: mx.sym.random_uniform(shape=(2, 3), name="u1") +
    mx.sym.random_uniform(shape=(2, 3), name="u2") + x,
], ids=["dropout", "batchnorm", "leakyrelu", "sampling"])
def test_cse_never_merges_stochastic_or_stateful(build):
    # LeakyReLU draws only as rrelu, but counts as stochastic whatever its
    # attrs (as in the JAX package, so both merge the same nodes)
    s = build(mx.sym.Variable("x"))
    assert _n_nodes(graphpass.run_pass("eliminate_common_subexpr", s)) == \
        _n_nodes(s)


# ---------------------------------------------------------------------------
# fuse_elemwise / bucket_shapes
# ---------------------------------------------------------------------------

def test_fuse_elemwise_annotates_chains():
    x = mx.sym.Variable("x")
    y = mx.sym.FullyConnected(
        mx.sym.Activation(x * 2.0 + 1.0, act_type="relu"), num_hidden=4)
    opt = graphpass.run_pass("fuse_elemwise", y)
    groups = {n.name: n._extra_attrs.get("__fuse_group__")
              for n in _nodes(opt) if not n.is_variable}
    chain = [g for g in groups.values() if g is not None]
    assert len(chain) == 3 and len(set(chain)) == 1
    assert groups[[n for n in groups if "fullyconnected" in n][0]] is None
    # annotation only: the digest (op + attrs + wiring) is untouched
    assert compileobs.symbol_digest(opt) == compileobs.symbol_digest(y)


def test_bucket_shapes_is_opt_in_and_pads_batch():
    assert "bucket_shapes" not in graphpass.DEFAULT_PIPELINE
    x = mx.sym.Variable("x", shape=(13, 7))
    opt = graphpass.run_pass("bucket_shapes", x)
    assert opt._entries[0][0]._extra_attrs["__shape__"] == str((16, 7))


# ---------------------------------------------------------------------------
# the ladder + the safety fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,want", [
    ("none", ()), ("off", ()), ("0", ()), (None, "default"),
    ("default,-cse", ("canonicalize", "fold_constants", "fuse_elemwise")),
    ("canonicalize,cse", ("canonicalize", "eliminate_common_subexpr")),
    ("default,bucket_shapes", "default+bucket"),
    ("no_such_pass", ()),
])
def test_env_ladder(monkeypatch, spec, want):
    if spec is None:
        monkeypatch.delenv("MXNET_GRAPH_PASSES", raising=False)
    else:
        monkeypatch.setenv("MXNET_GRAPH_PASSES", spec)
    if want == "default":
        want = graphpass.DEFAULT_PIPELINE
    elif want == "default+bucket":
        want = graphpass.DEFAULT_PIPELINE + ("bucket_shapes",)
    assert graphpass.active_passes() == want
    assert J.graphpass.active_passes() == want


def test_optimize_falls_back_when_surface_breaks():
    def evil(sym):  # drops an argument: breaks the binding surface
        g = sym.__copy__()
        for node in _topo_order(g._entries):
            node.inputs = [(i, k) for i, k in node.inputs
                           if not (i.is_variable and i.name.endswith("bias"))]
        return g

    graphpass.PASS_REGISTRY["_evil"] = evil
    try:
        y = mx.sym.FullyConnected(mx.sym.Variable("x"), num_hidden=4,
                                  name="fc")
        before = telemetry.counter("graphpass.fallbacks").value
        assert graphpass.optimize(y, passes=("_evil",)) is y
        assert telemetry.counter("graphpass.fallbacks").value == before + 1
    finally:
        del graphpass.PASS_REGISTRY["_evil"]


def test_optimize_survives_raising_pass():
    def bomb(sym):
        raise RuntimeError("boom")

    graphpass.PASS_REGISTRY["_bomb"] = bomb
    try:
        y = mx.sym.FullyConnected(mx.sym.Variable("x") * 1.0, num_hidden=4)
        before = telemetry.counter("graphpass.errors",
                                   **{"pass": "_bomb"}).value
        out = graphpass.optimize(y, passes=("_bomb", "fold_constants"))
        assert _n_nodes(out) == _n_nodes(y) - 1
        assert telemetry.counter("graphpass.errors",
                                 **{"pass": "_bomb"}).value == before + 1
    finally:
        del graphpass.PASS_REGISTRY["_bomb"]


# ---------------------------------------------------------------------------
# zoo sweep: binding surface + digest determinism
# ---------------------------------------------------------------------------

_ZOO = [
    ("resnet", "get_symbol",
     dict(num_classes=10, num_layers=20, image_shape="3,28,28")),
    ("inception_bn", "get_symbol", dict(num_classes=10)),
    ("googlenet", "get_symbol", dict(num_classes=10)),
    ("alexnet", "get_symbol", dict(num_classes=10)),
    ("vgg", "get_symbol", dict(num_classes=10)),
    ("lenet", "get_symbol", dict(num_classes=10)),
    ("mlp", "get_symbol", dict(num_classes=10)),
    ("transformer_lm", "get_symbol", dict()),
    ("ssd", "get_symbol", dict()),
    ("dcgan", "make_generator", dict()),
    ("dcgan", "make_discriminator", dict()),
    ("lstm_lm", "get_symbol", dict()),
]


@pytest.mark.parametrize("model,fn,kw", _ZOO,
                         ids=["%s.%s" % (m, f) for m, f, _ in _ZOO])
def test_zoo_passes_preserve_binding_surface(model, fn, kw):
    mod = importlib.import_module("mxnet_tpu_torch.models." + model)
    with NameManager():
        sym = getattr(mod, fn)(**kw)
        if model == "lstm_lm":
            sym = sym(16)[0]
    opt = graphpass.optimize(sym)
    assert sorted(opt.list_arguments()) == sorted(sym.list_arguments())
    assert sorted(opt.list_auxiliary_states()) == \
        sorted(sym.list_auxiliary_states())
    assert opt.list_outputs() == sym.list_outputs()
    assert compileobs.symbol_digest(opt) == \
        compileobs.symbol_digest(graphpass.optimize(sym))


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

_CROSS = [("mlp", dict(num_classes=10)), ("lenet", dict(num_classes=10)),
          ("transformer_lm", SMALL_LM)]

_COUNTERS = [("graphpass.nodes_eliminated", {"pass": "fold_constants"}),
             ("graphpass.nodes_eliminated",
              {"pass": "eliminate_common_subexpr"}),
             ("graphpass.nodes_fused", {}), ("graphpass.fallbacks", {})]


def _jax_symbol(model, kw):
    mod = importlib.import_module("mxnet_tpu.models." + model)
    with JNameManager():
        return mod.get_symbol(**kw)


def _counts(tel):
    return [tel.counter(name, **labels).value for name, labels in _COUNTERS]


@pytest.mark.parametrize("model,kw", _CROSS, ids=[m for m, _ in _CROSS])
def test_optimized_graph_equals_the_jax_packages(model, kw):
    js = _jax_symbol(model, kw)
    ts = mx.sym.load_json(js.tojson())
    j0, t0 = _counts(J.telemetry), _counts(telemetry)
    jo = J.graphpass.optimize(js)
    to = graphpass.optimize(ts)
    j1, t1 = _counts(J.telemetry), _counts(telemetry)
    assert to.tojson() == jo.tojson()
    assert compileobs.symbol_digest(to) == J.compileobs.symbol_digest(jo)
    assert [b - a for a, b in zip(t0, t1)] == [b - a for a, b in zip(j0, j1)]
    # the passes did something on the LM: identity is then post-pass
    if model == "transformer_lm":
        assert _n_nodes(to) < _n_nodes(ts)
        assert compileobs.symbol_digest(to) != compileobs.symbol_digest(ts)


def _shapes(model, kw):
    if model == "mlp":
        return dict(data=(8, 784), softmax_label=(8,))
    if model == "lenet":
        return dict(data=(4, 1, 28, 28), softmax_label=(4,))
    return dict(data=(2, kw["seq_len"]), softmax_label=(2, kw["seq_len"]))


def _seeded(names_shapes, model, kw, seed=7):
    rs = np.random.RandomState(seed)
    out = {}
    for name, shape in sorted(names_shapes):
        if name.endswith("label"):
            out[name] = (rs.rand(*shape) * 4).astype(np.int64).astype(np.float32)
        elif name == "data" and model == "transformer_lm":
            out[name] = rs.randint(0, kw["vocab_size"], shape).astype(np.float32)
        elif name == "data":
            out[name] = rs.randn(*shape).astype(np.float32)
        else:
            out[name] = (rs.randn(*shape) * 0.1).astype(np.float32)
    return out


def _run(pkg, sym, model, kw):
    shapes = _shapes(model, kw)
    ex = sym.simple_bind(ctx=pkg.cpu(), **shapes)
    vals = _seeded([(n, a.shape) for n, a in ex.arg_dict.items()], model, kw)
    for n, v in vals.items():
        ex.arg_dict[n][:] = v
    ex.forward(is_train=True)
    ex.backward()
    outs = [o.asnumpy() for o in ex.outputs]
    grads = {n: g.asnumpy() for n, g in ex.grad_dict.items() if g is not None}
    return ex, outs, grads


@pytest.mark.parametrize("model,kw", _CROSS, ids=[m for m, _ in _CROSS])
def test_executor_with_passes_matches_the_jax_executor(model, kw,
                                                       monkeypatch):
    js = _jax_symbol(model, kw)
    ts = mx.sym.load_json(js.tojson())
    tex, t_outs, t_grads = _run(T, ts, model, kw)
    # the executor runs the optimized graph and names it by its digest
    assert tex._opt_symbol is not ts
    assert tex._prog_eval.digest == compileobs.symbol_digest(
        graphpass.optimize(ts))
    _, j_outs, j_grads = _run(J, js, model, kw)
    for a, b in zip(t_outs, j_outs):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    assert sorted(t_grads) == sorted(j_grads)
    for n in t_grads:
        np.testing.assert_allclose(t_grads[n], j_grads[n], rtol=TOL, atol=TOL,
                                   err_msg=n)
    # and against the port with the passes off
    monkeypatch.setenv("MXNET_GRAPH_PASSES", "none")
    oex, o_outs, o_grads = _run(T, ts, model, kw)
    assert oex._opt_symbol is ts
    for a, b in zip(t_outs, o_outs):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    for n in t_grads:
        np.testing.assert_allclose(t_grads[n], o_grads[n], rtol=TOL,
                                   atol=TOL, err_msg=n)


# ---------------------------------------------------------------------------
# Dropout under the passes: the same masks in the fused fit
# ---------------------------------------------------------------------------

def _dropout_net(swap):
    data = mx.sym.Variable("data")
    a = mx.sym.Dropout(mx.sym.FullyConnected(data, num_hidden=6, name="fa"),
                       p=0.5, name="da")
    b = mx.sym.Dropout(mx.sym.FullyConnected(data, num_hidden=6, name="fb"),
                       p=0.5, name="db")
    h = (b + a) if swap else (a + b)
    h = mx.sym.Dropout(mx.sym.Activation(h * 1.0, act_type="relu"), p=0.3,
                       name="dc")
    out = mx.sym.FullyConnected(h, num_hidden=3, name="fo")
    return mx.sym.SoftmaxOutput(out, name="softmax")


_DROPOUT_MASK = sample.dropout_mask


def _dropout_order(sym):
    return [n.name for n in _nodes(sym) if n.op == "Dropout"]


def _fused_fit_masks(sym, monkeypatch, passes):
    if passes:
        monkeypatch.delenv("MXNET_GRAPH_PASSES", raising=False)
    else:
        monkeypatch.setenv("MXNET_GRAPH_PASSES", "none")
    masks = []
    orig = _DROPOUT_MASK

    def tap(rng, shape, keep, dtype, device):
        m = orig(rng, shape, keep, dtype, device)
        masks.append(m.detach().clone().numpy())
        return m

    monkeypatch.setattr(sample, "dropout_mask", tap)
    rs = np.random.RandomState(3)
    X = rs.randn(16, 5).astype(np.float32)
    y = rs.randint(0, 3, 16).astype(np.float32)
    it = mx.io.NDArrayIter(X, y, batch_size=4, shuffle=False)
    mx.random.seed(11)
    np.random.seed(11)
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.fit(it, num_epoch=1, kvstore="device", optimizer="sgd",
            optimizer_params={"learning_rate": 0.1},
            initializer=mx.init.Xavier())
    assert mod._fused is not None
    assert (mod._fused.trainer._opt_symbol is not sym) == passes
    args, _ = mod.get_params()
    return masks, {n: v.asnumpy() for n, v in args.items()}


def test_fused_fit_dropout_masks_equal_with_passes_on_and_off(monkeypatch):
    # canonicalize reorders the sum's operands in one of the two builds,
    # which would change the order the masks are drawn in
    reordered = [s for s in (_dropout_net(False), _dropout_net(True))
                 if _dropout_order(graphpass.optimize(s)) != _dropout_order(s)]
    assert reordered
    for swap in (False, True):
        sym = _dropout_net(swap)
        on_masks, on_params = _fused_fit_masks(sym, monkeypatch, True)
        off_masks, off_params = _fused_fit_masks(sym, monkeypatch, False)
        assert len(on_masks) == len(off_masks) == 12   # 3 Dropouts x 4 steps
        for a, b in zip(on_masks, off_masks):
            np.testing.assert_array_equal(a, b)
        for n in on_params:
            np.testing.assert_allclose(on_params[n], off_params[n],
                                       rtol=TOL, atol=TOL, err_msg=n)


def test_installed_decisions_reach_the_optimized_graph():
    # test_utils.installed_decisions keys a ReLU's choices on its node's
    # attrs object: the passes keep that object for the nodes they leave
    # alone, so the choices still reach the executor's optimized graph
    from mxnet_tpu_torch import test_utils

    data = mx.sym.Variable("data")
    h = mx.sym.Activation(mx.sym.FullyConnected(data, num_hidden=4,
                                                name="fc") * 1.0,
                          act_type="relu", name="r")
    net = mx.sym.FullyConnected(h, num_hidden=3, name="out")
    ex = net.simple_bind(ctx=mx.cpu(), data=(2, 5))
    assert ex._opt_symbol is not net
    rs = np.random.RandomState(0)
    for n, a in ex.arg_dict.items():
        a[:] = rs.randn(*a.shape).astype(np.float32)
    closed = np.zeros((2, 4), np.float32)       # every unit switched off
    with test_utils.installed_decisions(net, {"r_output": closed}):
        got = ex.forward()[0].asnumpy()
    want = np.broadcast_to(ex.arg_dict["out_bias"].asnumpy(), (2, 3))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(ex.forward()[0].asnumpy(), want)
