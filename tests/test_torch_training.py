"""Parity of the PyTorch port's training path with the JAX package, on CPU.

The same numpy inputs (made from a seed) go through the JAX package and
through the port with CPU tensors, where every kernel wrapper takes its
plain PyTorch version: the Transformer-LM symbol (JSON byte for byte,
arguments, shapes), each ported op's forward and gradient, the
SoftmaxOutput gradient, one SGD-momentum and one Adam step, NDArrayIter
batches, the metrics, an Executor forward/backward of the tiny LM and
``Module.fit`` from identical parameters. Sizes are tiny (vocab 23, 2
layers, d 32, 2 heads, ffn 48, T 16, batch 4) so the file runs in
seconds. Float32 on both sides: where only the summation order differs
the tolerance is 1e-5 (relative and absolute) unless a test says why.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as JR
from mxnet_tpu.ops.matrix import mx_reshape as j_mx_reshape
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry as TR
from mxnet_tpu_torch.ops.matrix import mx_reshape as t_mx_reshape

JLM = importlib.import_module("mxnet_tpu.models.transformer_lm")
TLM = importlib.import_module("mxnet_tpu_torch.models.transformer_lm")

TOL = 1e-5
LM = dict(vocab_size=23, num_layers=2, model_dim=32, num_heads=2, ffn_dim=48,
          seq_len=16)
B, T, V = 4, LM["seq_len"], LM["vocab_size"]


def _cpu():
    return jax.devices("cpu")[0]


def _symbols():
    with jmx.name.NameManager():
        js = JLM.get_symbol(**LM)
    with tmx.name.NameManager():
        ts = TLM.get_symbol(**LM)
    return js, ts


def _lm_params(seed=0, scale=0.1):
    _, ts = _symbols()
    shapes = dict(zip(ts.list_arguments(),
                      ts.infer_shape(data=(B, T), softmax_label=(B, T))[0]))
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * scale).astype(np.float32)
            for n, s in shapes.items() if n not in ("data", "softmax_label")}


def _lm_data(n=16, seed=1):
    """examples/train_lm.py's synthetic stream: token t+1 = token t + 1."""
    rng = np.random.RandomState(seed)
    X = (rng.randint(0, V, (n, 1)) + np.arange(T)) % V
    return X.astype(np.float32), ((X + 1) % V).astype(np.float32)


# ------------------------------------------------------------------ symbol
def test_transformer_lm_symbol_matches_jax():
    js, ts = _symbols()
    assert ts.tojson() == js.tojson()                 # byte for byte
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_outputs() == js.list_outputs()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states() == []
    assert ts.attr_dict() == js.attr_dict()
    shapes = dict(data=(B, T), softmax_label=(B, T))
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)
    jt = js.infer_type(data=np.float32, softmax_label=np.float32)
    tt = ts.infer_type(data=np.float32, softmax_label=np.float32)
    assert [np.dtype(d) for d in tt[0]] == [np.dtype(d) for d in jt[0]]


def test_symbol_json_round_trips_between_packages():
    js, ts = _symbols()
    back = tmx.sym.load_json(js.tojson())
    assert back.tojson() == js.tojson()
    assert jmx.sym.load_json(ts.tojson()).tojson() == ts.tojson()


def test_symbol_arithmetic_and_auto_names_match_jax():
    def build(mx):
        with mx.name.NameManager():
            a, b = mx.sym.Variable("a"), mx.sym.Variable("b")
            s = (a + b) * 2.0 - a / b + 1.5
            s = mx.sym.Reshape(mx.sym.broadcast_add(s, b), shape=(0, -1))
            return mx.sym.mean(s, axis=1, keepdims=True) + (-a)

    assert build(tmx).tojson() == build(jmx).tojson()


# --------------------------------------------------------------------- ops
def _op_inputs(rng, name, shapes):
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    if name == "sqrt":
        xs[0] = np.abs(xs[0]) + 0.5
    if name == "broadcast_div":
        xs[1] = np.abs(xs[1]) + 0.5
    if name == "Embedding":
        xs[0] = rng.randint(0, shapes[1][0], shapes[0]).astype(np.float32)
    if name == "SoftmaxOutput":
        xs[1] = rng.randint(0, shapes[0][1], shapes[1]).astype(np.float32)
    return xs


# (op, attrs, input shapes, indices of the inputs that take a gradient)
OPS = [
    ("elemwise_add", {}, [(3, 4), (3, 4)], (0, 1)),
    ("broadcast_add", {}, [(2, 3, 4), (1, 1, 4)], (0, 1)),
    ("broadcast_minus", {}, [(2, 3, 4), (2, 3, 1)], (0, 1)),
    ("broadcast_mul", {}, [(2, 3, 4), (1, 3, 4)], (0, 1)),
    ("broadcast_div", {}, [(2, 3, 4), (2, 3, 1)], (0, 1)),
    ("_plus_scalar", {"scalar": 1e-5}, [(3, 4)], (0,)),
    ("square", {}, [(3, 4)], (0,)),
    ("sqrt", {}, [(3, 4)], (0,)),
    ("mean", {"axis": -1, "keepdims": True}, [(2, 3, 4)], (0,)),
    ("mean", {"axis": (0, 2)}, [(2, 3, 4)], (0,)),
    ("Reshape", {"shape": (-1, 4)}, [(2, 3, 4)], (0,)),
    ("Reshape", {"shape": (0, -3)}, [(2, 3, 4)], (0,)),
    ("Reshape", {"shape": (-4, 1, -1, -2)}, [(2, 3, 4)], (0,)),
    ("Embedding", {"input_dim": 7, "output_dim": 5}, [(2, 3), (7, 5)], (1,)),
    ("FullyConnected", {"num_hidden": 5}, [(3, 4), (5, 4), (5,)], (0, 1, 2)),
    ("FullyConnected", {"num_hidden": 5, "no_bias": True, "flatten": False},
     [(2, 3, 4), (5, 4)], (0, 1)),
    ("Activation", {"act_type": "relu"}, [(3, 4)], (0,)),
    ("Activation", {"act_type": "tanh"}, [(3, 4)], (0,)),
    ("Activation", {"act_type": "sigmoid"}, [(3, 4)], (0,)),
    ("Activation", {"act_type": "softrelu"}, [(3, 4)], (0,)),
    ("SoftmaxOutput", {}, [(6, 7), (6,)], (0,)),
    ("_contrib_MultiHeadAttention", {"num_heads": 2},
     [(2, 16, 8), (24, 8), (8, 8)], (0, 1, 2)),
    ("_contrib_FlashAttention", {"causal": True},
     [(1, 2, 16, 8), (1, 2, 16, 8), (1, 2, 16, 8)], (0, 1, 2)),
]


@pytest.mark.parametrize("name,attrs,shapes,diff", OPS,
                         ids=["%s-%d" % (o[0], i) for i, o in enumerate(OPS)])
def test_op_forward_and_gradient_match_jax(name, attrs, shapes, diff):
    """Forward, head-gradient backward and inferred shapes of each ported
    op against the JAX op on the same inputs. Tolerance: 2e-5 of the
    array's largest magnitude — attention and FullyConnected sum many
    terms in another order, so an element that cancels to a small value
    keeps only the absolute error of its terms."""
    rng = np.random.RandomState(len(name) + len(shapes))
    xs = _op_inputs(rng, name, shapes)
    jop, top = JR.get_op(name), TR.get_op(name)
    jattrs, _ = jop.canonicalize_attrs(dict(attrs))
    tattrs, _ = top.canonicalize_attrs(dict(attrs))

    def jfwd(*dargs):
        args = [jnp.asarray(x) for x in xs]
        for i, a in zip(diff, dargs):
            args[i] = a
        return jop.forward(JR.OpContext(is_train=True), jattrs, args, [])[0][0]

    with jax.default_device(_cpu()):
        jout, vjp = jax.vjp(jfwd, *[jnp.asarray(xs[i]) for i in diff])
        g = rng.randn(*jout.shape).astype(np.float32)
        jgrads = vjp(jnp.asarray(g))

    targs = [torch.from_numpy(x.copy()) for x in xs]
    for i in diff:
        targs[i].requires_grad_(True)
    tout = top.forward(TR.OpContext(is_train=True), tattrs, targs, [])[0][0]
    tgrads = torch.autograd.grad(tout, [targs[i] for i in diff],
                                 torch.from_numpy(g))

    def close(got, ref):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got, ref, rtol=2e-5,
                                   atol=2e-5 * max(1.0, np.abs(ref).max()))

    close(tout.detach().numpy(), jout)
    for jg, tg in zip(jgrads, tgrads):
        close(tg.numpy(), jg)
    # shape inference, all inputs known
    assert top.infer_shape(tattrs, list(shapes), [])[1] == \
        [tuple(s) for s in jop.infer_shape(jattrs, list(shapes), [])[1]]


@pytest.mark.parametrize("name,attrs,shapes", [
    ("FullyConnected", {"num_hidden": 5}, [(3, 2, 2), None, None]),
    ("Embedding", {"input_dim": 7, "output_dim": 5}, [(2, 3), None]),
    ("_contrib_MultiHeadAttention", {"num_heads": 2}, [(2, 16, 8), None, None]),
])
def test_infer_shape_fills_parameters_like_jax(name, attrs, shapes):
    jop, top = JR.get_op(name), TR.get_op(name)
    got = top.infer_shape(top.canonicalize_attrs(attrs)[0], list(shapes), [])
    ref = jop.infer_shape(jop.canonicalize_attrs(attrs)[0], list(shapes), [])
    assert [list(map(tuple, x)) for x in got] == [list(map(tuple, x)) for x in ref]


@pytest.mark.parametrize("target", [(-1,), (0, -1), (-2,), (0, -3), (-3, 0),
                                    (-4, 2, -1, -2), (-4, -1, 1, 3, 4),
                                    (4, -1), (0, 0, -1)])
def test_reshape_special_codes_match_jax(target):
    src = (2, 3, 4)
    assert t_mx_reshape(src, target) == j_mx_reshape(src, target)
    if -4 not in target:     # reversed, -4 would lose the two dims after it
        assert t_mx_reshape(src, target, reverse=True) == \
            j_mx_reshape(src, target, reverse=True)


def test_embedding_out_of_range_ids_follow_jax_take():
    """Ids in [-V, 0) wrap, other out-of-range ids give a NaN row (JAX's
    default fill mode), truncation toward zero for fractional ids; no id
    reads outside the table."""
    w = np.arange(20, dtype=np.float32).reshape(4, 5)
    ids = np.array([[0, 3, 4, -1], [-4, -5, 7, 2.7]], np.float32)
    jop, top = JR.get_op("Embedding"), TR.get_op("Embedding")
    attrs = {"input_dim": 4, "output_dim": 5}
    with jax.default_device(_cpu()):
        ref = np.asarray(jop.forward(JR.OpContext(), jop.canonicalize_attrs(attrs)[0],
                                     [jnp.asarray(ids), jnp.asarray(w)], [])[0][0])
    tw = torch.from_numpy(w).requires_grad_(True)
    out = top.forward(TR.OpContext(), top.canonicalize_attrs(attrs)[0],
                      [torch.from_numpy(ids), tw], [])[0][0]
    np.testing.assert_array_equal(out.detach().numpy(), ref)
    assert np.isnan(ref[0, 2]).all() and np.isnan(ref[1, 1]).all()
    # a NaN row takes no gradient; the wrapped and in-range rows do
    (g,) = torch.autograd.grad(torch.nan_to_num(out).sum(), tw)
    np.testing.assert_array_equal(g.numpy().sum(axis=1), [10.0, 0.0, 5.0, 10.0])


@pytest.mark.parametrize("attrs", [
    {},
    {"use_ignore": True, "ignore_label": 2.0, "normalization": "valid"},
    {"normalization": "batch", "grad_scale": 0.5},
    {"smooth_alpha": 0.1},
    {"out_grad": True},
    {"multi_output": True, "use_ignore": True, "ignore_label": 1.0},
    {"preserve_shape": True},
])
def test_softmax_output_gradient_matches_jax(attrs):
    """The declared gradient p - onehot (scaled, masked, normalized,
    smoothed), ignoring the head gradient unless out_grad is set."""
    rng = np.random.RandomState(3)
    if attrs.get("multi_output"):
        x = rng.randn(3, 5, 4).astype(np.float32)
        lab = rng.randint(0, 5, (3, 4)).astype(np.float32)
    else:
        x = rng.randn(6, 7).astype(np.float32)
        lab = rng.randint(0, 7, (6,)).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    jop, top = JR.get_op("SoftmaxOutput"), TR.get_op("SoftmaxOutput")
    ja, ta = jop.canonicalize_attrs(attrs)[0], top.canonicalize_attrs(attrs)[0]
    with jax.default_device(_cpu()):
        out, vjp = jax.vjp(lambda d: jop.forward(JR.OpContext(True), ja,
                                                 [d, jnp.asarray(lab)], [])[0][0],
                           jnp.asarray(x))
        (ref,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    tout = top.forward(TR.OpContext(True), ta, [tx, torch.from_numpy(lab)], [])[0][0]
    (tg,) = torch.autograd.grad(tout, tx, torch.from_numpy(g))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(out), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
    assert TR.get_op("SoftmaxOutput").is_loss


# --------------------------------------------------------------- optimizer
@pytest.mark.parametrize("name,kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("sgd", {"learning_rate": 0.1, "wd": 0.01, "clip_gradient": 0.5}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01, "clip_gradient": 0.5}),
])
def test_optimizer_steps_match_jax(name, kw):
    """Two updates of a weight and a bias (no weight decay on the bias by
    name) with rescale and clipping: weights and states match."""
    rng = np.random.RandomState(4)
    names = {0: "fc_weight", 1: "fc_bias"}
    ws = [rng.randn(5, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    grads = [[rng.randn(*w.shape).astype(np.float32) * 3 for w in ws]
             for _ in range(2)]
    common = dict(kw, rescale_grad=0.25, param_idx2name=names)
    with jax.default_device(_cpu()):
        ju = jmx.optimizer.get_updater(jmx.optimizer.create(name, **common))
        jw = [jmx.nd.array(w, ctx=jmx.cpu()) for w in ws]
        for gs in grads:
            ju.update_all([(i, jmx.nd.array(g, ctx=jmx.cpu()), jw[i])
                           for i, g in enumerate(gs)])
    tu = tmx.optimizer.get_updater(tmx.optimizer.create(name, **common))
    tw = [tmx.nd.array(w, ctx=tmx.cpu()) for w in ws]
    for gs in grads:
        tu.update_all([(i, tmx.nd.array(g, ctx=tmx.cpu()), tw[i])
                       for i, g in enumerate(gs)])
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=TOL, atol=TOL)
    for i in range(2):
        js, ts = ju.states[i], tu.states[i]
        js = js if isinstance(js, (tuple, list)) else [js]
        ts = ts if isinstance(ts, (tuple, list)) else [ts]
        for a, b in zip(ts, js):
            if b is not None:
                np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=TOL, atol=TOL)
    assert tu.optimizer._index_update_count == ju.optimizer._index_update_count


# ----------------------------------------------------------------------- io
def _batches(mx, it, epochs=2):
    out = []
    for _ in range(epochs):
        for b in it:
            out.append(([d.asnumpy() for d in b.data], [l.asnumpy() for l in b.label],
                        b.pad))
        it.reset()
    return out


@pytest.mark.parametrize("kw", [
    dict(last_batch_handle="pad"),
    dict(last_batch_handle="roll_over"),
    dict(last_batch_handle="discard"),
    dict(last_batch_handle="pad", shuffle=True, seed=5),
])
def test_ndarrayiter_batches_match_jax(kw):
    X = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    Y = np.arange(10, dtype=np.float32)
    jb = _batches(jmx, jmx.io.NDArrayIter(X, Y, batch_size=4, **kw))
    tb = _batches(tmx, tmx.io.NDArrayIter(X, Y, batch_size=4, **kw))
    assert len(tb) == len(jb)
    for (td, tl, tp), (jd, jl, jp) in zip(tb, jb):
        assert tp == jp
        for a, b in zip(td + tl, jd + jl):
            np.testing.assert_array_equal(a, b)
    it = tmx.io.NDArrayIter(X, Y, batch_size=4)
    assert it.provide_data[0].shape == (4, 3) and it.provide_label[0].name == "softmax_label"


# ------------------------------------------------------------------ metric
@pytest.mark.parametrize("metric,kw", [
    ("Perplexity", {"ignore_label": None}),
    ("Perplexity", {"ignore_label": 0}),
    ("Accuracy", {}),
])
def test_metrics_match_jax(metric, kw):
    rng = np.random.RandomState(6)
    logits = rng.randn(2, 12, 5).astype(np.float32)
    preds = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    labels = rng.randint(0, 5, (2, 3, 4)).astype(np.float32)
    jm = getattr(jmx.metric, metric)(**kw)
    tm = getattr(tmx.metric, metric)(**kw)
    for p, l in zip(preds, labels):
        jm.update([jmx.nd.array(l, ctx=jmx.cpu())], [jmx.nd.array(p, ctx=jmx.cpu())])
        tm.update([tmx.nd.array(l, ctx=tmx.cpu())], [tmx.nd.array(p, ctx=tmx.cpu())])
    assert tm.get()[0] == jm.get()[0]
    np.testing.assert_allclose(tm.get()[1], jm.get()[1], rtol=TOL)
    assert isinstance(tmx.metric.create("acc"), tmx.metric.Accuracy)
    assert isinstance(tmx.metric.create(["acc", "ce"]), tmx.metric.CompositeEvalMetric)


@pytest.mark.parametrize("auto_reset,with_metric", [(True, True), (False, True),
                                                    (True, False)])
def test_speedometer_matches_jax(monkeypatch, caplog, auto_reset, with_metric):
    """Both Speedometers driven by the same batch-end params over two
    epochs of 7 batches on one fake clock (0.5 s per batch): the same log
    lines (schedule, speed, metric values) and the same metric resets."""
    import time as _time

    clock = iter(np.arange(0.0, 100.0, 0.5))
    monkeypatch.setattr(_time, "time", lambda: float(next(clock)))
    preds = np.full((2, 3), 1.0 / 3, np.float32)
    lines = {}
    for mx, P in ((jmx, jmx.module.base_module.BatchEndParam),
                  (tmx, tmx.module.base_module.BatchEndParam)):
        metric = mx.metric.Perplexity(ignore_label=None) if with_metric else None
        speedo = mx.callback.Speedometer(4, frequent=3, auto_reset=auto_reset)
        caplog.clear()
        with caplog.at_level("INFO"):
            for epoch in range(2):
                for nbatch in range(7):
                    if metric is not None:
                        metric.update([mx.nd.array(np.zeros(2, np.float32), ctx=mx.cpu())],
                                      [mx.nd.array(preds, ctx=mx.cpu())])
                    speedo(P(epoch=epoch, nbatch=nbatch, eval_metric=metric, locals=None))
        lines[mx.__name__] = [r.getMessage() for r in caplog.records
                              if "Speed:" in r.getMessage()]
    assert lines["mxnet_tpu_torch"] == lines["mxnet_tpu"]
    assert len(lines["mxnet_tpu"]) == 4           # batches 3 and 6 of each epoch
    assert "Speed: 8.00 samples/sec" in lines["mxnet_tpu"][0]   # 3 x 4 in 1.5 s


# ---------------------------------------------------------------- executor
def test_executor_forward_backward_matches_jax():
    """The tiny LM bound with simple_bind: outputs and every parameter's
    gradient after forward(is_train=True) + backward(), then grad_req
    'add' accumulating a second backward."""
    js, ts = _symbols()
    params = _lm_params()
    X, Y = _lm_data(B)
    grads = {}
    for mx, sym, ctx in ((jmx, js, jmx.cpu()), (tmx, ts, tmx.cpu())):
        exe = sym.simple_bind(ctx=ctx, data=(B, T), softmax_label=(B, T))
        for n, v in params.items():
            exe.arg_dict[n][:] = v
        exe.arg_dict["data"][:] = X
        exe.arg_dict["softmax_label"][:] = Y
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward()
        grads[mx] = (out, {n: exe.grad_dict[n].asnumpy() for n in params})
    (jout, jg), (tout, tg) = grads[jmx], grads[tmx]
    np.testing.assert_allclose(tout, jout, rtol=TOL, atol=TOL)
    for n in params:
        np.testing.assert_allclose(tg[n], jg[n], rtol=1e-4, atol=TOL, err_msg=n)

    exe = ts.simple_bind(ctx=tmx.cpu(), grad_req="add", data=(B, T),
                         softmax_label=(B, T))
    for n, v in params.items():
        exe.arg_dict[n][:] = v
    exe.forward(is_train=True, data=X, softmax_label=Y)
    exe.backward()
    exe.forward(is_train=True)
    exe.backward()
    for n in ("embed_weight", "layer0_attn_in_weight", "lm_head_bias"):
        np.testing.assert_allclose(exe.grad_dict[n].asnumpy(), 2 * tg[n],
                                   rtol=1e-4, atol=TOL)
    assert exe.grad_dict["data"] is not None   # simple_bind gives every arg one


def test_executor_rejects_unported_options():
    _, ts = _symbols()
    with pytest.raises(MXNetError):
        ts.simple_bind(ctx=tmx.cpu(), group2ctx={"a": tmx.cpu()}, data=(B, T),
                       softmax_label=(B, T))


# ------------------------------------------------------------------ module
@pytest.mark.parametrize("optimizer,kw,atol", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, 5e-5),
    ("adam", {"learning_rate": 3e-3}, 1e-4),
])
def test_module_fit_matches_jax(optimizer, kw, atol):
    """Module.fit for 2 epochs x 4 batches from the same parameters: final
    parameters and the last epoch's training perplexity. SGD: 5e-5 absolute
    (float32 summation order compounding over 8 steps). Adam: 1e-4
    absolute — Adam divides by sqrt(v), so a near-zero gradient whose
    rounding differs between the packages can move a weight by up to lr
    per step; the bound stays 30x below lr = 3e-3, so a step of the wrong
    sign would still fail it."""
    js, ts = _symbols()
    params = _lm_params()
    X, Y = _lm_data(16)
    jmet = jmx.metric.Perplexity(ignore_label=None)
    tmet = tmx.metric.Perplexity(ignore_label=None)
    jm = jmx.mod.Module(js, context=jmx.cpu())
    jm.fit(jmx.io.NDArrayIter(X, Y, batch_size=B), num_epoch=2, optimizer=optimizer,
           optimizer_params=kw, eval_metric=jmet,
           arg_params={n: jmx.nd.array(v, ctx=jmx.cpu()) for n, v in params.items()})
    tm = tmx.mod.Module(ts, context=tmx.cpu())
    tm.fit(tmx.io.NDArrayIter(X, Y, batch_size=B), num_epoch=2, optimizer=optimizer,
           optimizer_params=kw, eval_metric=tmet, arg_params=params)
    ja, _ = jm.get_params()
    ta, _ = tm.get_params()
    assert sorted(ta) == sorted(ja)
    for n in params:
        np.testing.assert_allclose(ta[n].asnumpy(), ja[n].asnumpy(), rtol=0,
                                   atol=atol, err_msg=n)
        assert not np.array_equal(ta[n].asnumpy(), params[n]), n   # it trained
    np.testing.assert_allclose(tmet.get()[1], jmet.get()[1], rtol=TOL)
    # score runs inference forwards with the trained weights
    js_score = jm.score(jmx.io.NDArrayIter(X, Y, batch_size=B),
                        jmx.metric.Perplexity(ignore_label=None))[0][1]
    ts_score = tm.score(tmx.io.NDArrayIter(X, Y, batch_size=B),
                        tmx.metric.Perplexity(ignore_label=None))[0][1]
    np.testing.assert_allclose(ts_score, js_score, rtol=1e-4)


def test_module_fit_learns_and_counts_one_forward_per_step():
    """A seeded Xavier fit on CPU: perplexity falls, and every step runs
    the flash forward once per layer and the backward once per layer (the
    metric reads the training forward's outputs)."""
    from mxnet_tpu_torch.ops import attention as TA

    _, ts = _symbols()
    X, Y = _lm_data(16)
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = TA.flash_attention_forward, TA.flash_attention_backward

    def count_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def count_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    epochs = []
    mp = pytest.MonkeyPatch()
    mp.setattr(TA, "flash_attention_forward", count_fwd)
    mp.setattr(TA, "flash_attention_backward", count_bwd)
    try:
        m = tmx.mod.Module(ts, context=tmx.cpu())
        m.fit(tmx.io.NDArrayIter(X, Y, batch_size=B), num_epoch=4,
              optimizer="adam", optimizer_params={"learning_rate": 1e-2},
              initializer=tmx.init.Xavier(rng=torch.Generator().manual_seed(0)),
              eval_metric=tmx.metric.Perplexity(ignore_label=None),
              epoch_end_callback=lambda e, s, a, x: epochs.append(e),
              batch_end_callback=lambda p: epochs.append(
                  p.eval_metric.get()[1]) if p.nbatch == 3 else None)
    finally:
        mp.undo()
    steps = 4 * 4
    assert calls == {"fwd": LM["num_layers"] * steps, "bwd": LM["num_layers"] * steps}
    ppl = [v for v in epochs if isinstance(v, float)]
    assert len(ppl) == 4 and all(np.isfinite(ppl)) and ppl[-1] < ppl[0] < V * 2


def test_initializer_dispatch_and_seeded_draws():
    """Each Variable's own __init__ first (pos_embed Normal(0.02), gamma
    One, beta Zero), then the global Xavier for *_weight; a seeded
    generator reproduces the draws."""
    _, ts = _symbols()

    def init(seed):
        m = tmx.mod.Module(ts, context=tmx.cpu())
        m.bind(data_shapes=[("data", (B, T))], label_shapes=[("softmax_label", (B, T))])
        m.init_params(tmx.init.Xavier(rng=torch.Generator().manual_seed(seed)))
        return {n: a.asnumpy() for n, a in m.get_params()[0].items()}

    a, b, c = init(0), init(0), init(1)
    for n in a:
        np.testing.assert_array_equal(a[n], b[n])
    assert not np.array_equal(a["embed_weight"], c["embed_weight"])
    assert (a["layer0_ln1_gamma"] == 1).all() and (a["final_ln_beta"] == 0).all()
    assert abs(a["pos_embed_weight"].std() - 0.02) < 0.005
    w = a["layer0_ffn1_weight"]                       # (48, 32): Xavier avg
    bound = np.sqrt(3.0 / ((32 + 48) / 2.0))
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.9 * bound
    assert (a["layer0_ffn1_bias"] == 0).all()


def test_module_without_context_needs_cuda(monkeypatch):
    """Entry points run on the card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ts = _symbols()
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmx.mod.Module(ts)
    with pytest.raises(MXNetError, match="no CUDA device"):
        ts.simple_bind(data=(B, T), softmax_label=(B, T))


def test_fit_rejects_unported_options():
    _, ts = _symbols()
    X, Y = _lm_data(8)
    # auto_resume is ported (tests/test_torch_resume.py); monitor and guard
    # are not
    for kw in ({"monitor": object()}, {"guard": "skip"}):
        with pytest.raises(MXNetError, match="ROADMAP"):
            tmx.mod.Module(ts, context=tmx.cpu()).fit(
                tmx.io.NDArrayIter(X, Y, batch_size=B), num_epoch=1, **kw)
    with pytest.raises(MXNetError):
        tmx.mod.Module(ts, context=[tmx.cpu(), tmx.cpu()]).bind(
            data_shapes=[("data", (B, T))], label_shapes=[("softmax_label", (B, T))])


def test_package_namespaces_mirror_jax():
    for name in ("nd", "sym", "mod", "io", "init", "optimizer", "metric",
                 "models", "callback", "Executor", "NameManager", "AttrScope"):
        assert hasattr(tmx, name) and hasattr(jmx, name), name
    assert callable(tmx.models.transformer_lm)
    assert hasattr(tmx.sym.contrib, "MultiHeadAttention")
