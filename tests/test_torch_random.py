"""Parity of the port's randomness and of its sampling, Dropout, LRN and
LeakyReLU ops with the JAX package, on the CPU.

``mx.random``: seeding reproduces a stream; the CPU generator is
PyTorch's default one. The sampling ops: symbol JSON byte for byte,
output shapes and dtypes, and the first and second moments of 10^5 draws
within 5 standard errors of the JAX op's (the values differ: threefry
against PyTorch's generators). ``Dropout``: its mask, its kept share
(within 5 standard errors), ``mode='always'``, the identity in
inference, the gradient ``grad * mask``, and forward and gradient equal
to the JAX package's with the same mask installed on both sides. ``LRN``
and ``LeakyReLU`` (the modes that draw nothing): forward and gradient
within 1e-5 relative of the JAX package's; an even LRN window raises in
both; ``rrelu`` draws its slopes within its bounds in training.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import sample
from mxnet_tpu_torch.ops.registry import OpContext, get_op

N_DRAWS = 100000
SIGMAS = 5.0
REL = 1e-5


def _both(build):
    with jmx.name.NameManager():
        js = build(jmx)
    with tmx.name.NameManager():
        ts = build(tmx)
    return js, ts


# ------------------------------------------------------------ mx.random
def test_seed_reproduces_the_stream_on_the_cpu():
    cpu = tmx.cpu()
    tmx.random.seed(11)
    a = tmx.random.uniform(0, 1, shape=(64,), ctx=cpu).asnumpy()
    b = tmx.random.normal(0, 1, shape=(64,), ctx=cpu).asnumpy()
    tmx.random.seed(11)
    assert np.array_equal(tmx.random.uniform(0, 1, shape=(64,), ctx=cpu).asnumpy(), a)
    assert np.array_equal(tmx.random.normal(0, 1, shape=(64,), ctx=cpu).asnumpy(), b)
    c = tmx.random.uniform(0, 1, shape=(64,), ctx=cpu).asnumpy()
    assert not np.array_equal(c, a)
    ints = tmx.random.randint(3, 7, shape=(1000,), ctx=cpu)
    assert ints.dtype == np.int32
    assert set(np.unique(ints.asnumpy())) == {3, 4, 5, 6}
    with pytest.raises(ValueError):
        tmx.random.seed(1.5)


def test_cpu_generator_is_torch_default_one():
    """Initializers and ops on the CPU draw from PyTorch's default
    generator, so torch.manual_seed and mx.random.seed seed the same
    stream."""
    assert tmx.random.generator("cpu") is torch.default_generator
    torch.manual_seed(5)
    a = tmx.nd.random_normal(shape=(8,), ctx=tmx.cpu()).asnumpy()
    tmx.random.seed(5)
    assert np.array_equal(tmx.nd.random_normal(shape=(8,), ctx=tmx.cpu()).asnumpy(), a)


def test_sampling_op_without_a_generator_raises():
    op = get_op("_random_uniform")
    attrs, _ = op.canonicalize_attrs({"shape": (3,)})
    with pytest.raises(MXNetError, match="no generator"):
        op.forward(OpContext(is_train=True, device="cpu"), attrs, [], [])


# ------------------------------------------------------------ sample ops
# (op, attrs): every _random_* op of the JAX package and an _sample_* op
# of each distribution with per-row parameters
RANDOM_OPS = [
    ("_random_uniform", {"low": -2.0, "high": 3.0}),
    ("_random_normal", {"loc": 1.5, "scale": 2.0}),
    ("_random_gamma", {"alpha": 2.5, "beta": 1.5}),
    ("_random_exponential", {"lam": 4.0}),
    ("_random_poisson", {"lam": 3.5}),
    ("_random_negative_binomial", {"k": 3, "p": 0.4}),
    ("_random_randint", {"low": -3, "high": 9}),
]
SAMPLE_OPS = [
    ("_sample_uniform", {"low": [0.0, -4.0], "high": [1.0, 4.0]}),
    ("_sample_normal", {"mu": [0.0, 5.0], "sigma": [1.0, 0.5]}),
    ("_sample_gamma", {"alpha": [1.0, 3.0], "beta": [2.0, 0.5]}),
    ("_sample_exponential", {"lam": [1.0, 5.0]}),
    ("_sample_poisson", {"lam": [2.0, 6.0]}),
    ("_sample_negative_binomial", {"k": [2.0, 5.0], "p": [0.5, 0.3]}),
]


def _random_draw(mx, op, attrs, n, ctx):
    return getattr(mx.nd, op)(shape=(n,), ctx=ctx, **attrs)


def _sample_draw(mx, op, params, n, ctx):
    nds = [mx.nd.array(np.asarray(v, np.float32), ctx=ctx) for v in params.values()]
    return getattr(mx.nd, op)(*nds, shape=(n,))


def _moments_agree(t, j):
    """First and second moments of two samples along the last axis within
    SIGMAS standard errors of their difference."""
    t = t.astype(np.float64)
    j = j.astype(np.float64)
    n = t.shape[-1]
    for k in (1, 2):
        a, b = t ** k, j ** k
        se = np.sqrt((a.var(-1) + b.var(-1)) / n)
        assert np.all(np.abs(a.mean(-1) - b.mean(-1)) <= SIGMAS * se + 1e-12), (k, a.mean(-1), b.mean(-1), se)


@pytest.mark.parametrize("op,attrs", RANDOM_OPS, ids=[o for o, _ in RANDOM_OPS])
def test_random_op_matches_jax(op, attrs):
    js, ts = _both(lambda mx: getattr(mx.sym, op)(shape=(4, 3), name="r", **attrs))
    assert ts.tojson() == js.tojson()
    assert ts.infer_shape() == js.infer_shape()
    tmx.random.seed(0)
    jmx.random.seed(0)
    t = _random_draw(tmx, op, attrs, N_DRAWS, tmx.cpu())
    j = _random_draw(jmx, op, attrs, N_DRAWS, jmx.cpu())
    assert t.shape == j.shape == (N_DRAWS,)
    assert t.dtype == j.dtype
    _moments_agree(t.asnumpy(), j.asnumpy())
    if op in ("_random_uniform", "_random_randint"):
        lo, hi = attrs["low"], attrs["high"]
        assert lo <= t.asnumpy().min() and t.asnumpy().max() < hi


@pytest.mark.parametrize("op,params", SAMPLE_OPS, ids=[o for o, _ in SAMPLE_OPS])
def test_sample_op_matches_jax(op, params):
    names = list(params)
    js, ts = _both(lambda mx: getattr(mx.sym, op)(
        *[mx.sym.Variable(n) for n in names], shape=(5,), name="s"))
    assert ts.tojson() == js.tojson()
    shapes = {n: (2,) for n in names}
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)
    t = _sample_draw(tmx, op, params, N_DRAWS // 2, tmx.cpu())
    j = _sample_draw(jmx, op, params, N_DRAWS // 2, jmx.cpu())
    assert t.shape == j.shape == (2, N_DRAWS // 2)
    assert t.dtype == j.dtype
    _moments_agree(t.asnumpy(), j.asnumpy())


def test_sample_multinomial_matches_jax():
    probs = np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]], np.float32)
    js, ts = _both(lambda mx: mx.sym.sample_multinomial(
        mx.sym.Variable("p"), shape=(4,), get_prob=True, name="m"))
    assert ts.tojson() == js.tojson()
    assert ts.infer_shape(p=(2, 3)) == js.infer_shape(p=(2, 3))
    t_ids, t_lp = tmx.nd.sample_multinomial(tmx.nd.array(probs, ctx=tmx.cpu()),
                                            shape=(N_DRAWS // 2,), get_prob=True)
    j_ids, _ = jmx.nd.sample_multinomial(jmx.nd.array(probs),
                                         shape=(N_DRAWS // 2,), get_prob=True)
    assert t_ids.shape == j_ids.shape == (2, N_DRAWS // 2)
    assert t_ids.dtype == j_ids.dtype == np.int32
    ids = t_ids.asnumpy()
    np.testing.assert_allclose(t_lp.asnumpy(),
                               np.log(np.take_along_axis(probs, ids, 1)), rtol=1e-6)
    _moments_agree(ids, j_ids.asnumpy())


def test_sample_op_dtype_attr():
    t = tmx.nd.random_uniform(shape=(3,), dtype="float16", ctx=tmx.cpu())
    j = jmx.nd.random_uniform(shape=(3,), dtype="float16")
    assert t.dtype == j.dtype == np.float16
    t = tmx.nd.random_poisson(lam=2.0, shape=(3,), dtype="int32", ctx=tmx.cpu())
    j = jmx.nd.random_poisson(lam=2.0, shape=(3,), dtype="int32")
    assert t.dtype == j.dtype == np.int32


# ------------------------------------------------------------- Dropout
def _dropout_exe(mx, p, mode, shape, ctx):
    s = mx.sym.Dropout(mx.sym.Variable("data"), p=p, mode=mode, name="drop")
    exe = s.simple_bind(ctx=ctx, data=shape)
    return s, exe


def test_dropout_mask_share_mode_and_gradient():
    shape, p = (200, 500), 0.3
    keep = 1 - p
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    g = np.random.RandomState(1).randn(*shape).astype(np.float32)
    masks = []
    orig = sample.dropout_mask

    def tap(*a, **k):
        masks.append(orig(*a, **k))
        return masks[-1]

    _, exe = _dropout_exe(tmx, p, "training", shape, tmx.cpu())
    exe.arg_dict["data"][:] = x
    sample.dropout_mask = tap
    try:
        y = exe.forward(is_train=True)[0].asnumpy()
        exe.backward(out_grads=[tmx.nd.array(g, ctx=tmx.cpu())])
    finally:
        sample.dropout_mask = orig
    assert len(masks) == 1
    m = masks[0].numpy()
    assert set(np.unique(m)) == {0.0, np.float32(1.0) / np.float32(keep)}
    n = m.size
    share = float((m > 0).mean())
    assert abs(share - keep) <= SIGMAS * np.sqrt(keep * p / n)
    np.testing.assert_array_equal(y, x * m)
    np.testing.assert_array_equal(exe.grad_dict["data"].asnumpy(), g * m)
    # inference: the identity
    assert np.array_equal(exe.forward(is_train=False)[0].asnumpy(), x)
    # mode='always' drops in inference too
    _, exe2 = _dropout_exe(tmx, p, "always", shape, tmx.cpu())
    exe2.arg_dict["data"][:] = x
    y2 = exe2.forward(is_train=False)[0].asnumpy()
    assert 0 < (y2 == 0).mean() < 1
    # the imperative op outside training passes the data through
    xa = tmx.nd.array(x, ctx=tmx.cpu())
    assert np.array_equal(tmx.nd.Dropout(xa, p=p).asnumpy(), x)


def test_dropout_in_training_without_a_generator_raises():
    op = get_op("Dropout")
    attrs, _ = op.canonicalize_attrs({"p": 0.5})
    with pytest.raises(MXNetError, match="no generator"):
        op.forward(OpContext(is_train=True, device="cpu"), attrs,
                   [torch.ones(3, 4)], [])


@pytest.mark.parametrize("p", [0.5, 0.2])
def test_dropout_matches_jax_with_installed_mask(monkeypatch, p):
    """The same bernoulli mask installed on both sides: forward and
    gradient of a Dropout between two FullyConnected layers equal the JAX
    package's."""
    import jax
    import jax.numpy as jnp

    keep = 1.0 - p
    rng = np.random.RandomState(3)
    bern = rng.rand(6, 16) < keep
    x = rng.randn(6, 5).astype(np.float32)
    w1 = rng.randn(16, 5).astype(np.float32)
    w2 = rng.randn(4, 16).astype(np.float32)
    og = rng.randn(6, 4).astype(np.float32)
    monkeypatch.setattr(jax.random, "bernoulli",
                        lambda key, pr, shape: jnp.asarray(bern))
    monkeypatch.setattr(sample, "dropout_mask",
                        lambda rng_, shape, k, dtype, device:
                        torch.from_numpy(bern).to(dtype) / k)

    def build(mx):
        h = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=16,
                                  no_bias=True, name="fa%d" % int(p * 10))
        h = mx.sym.Dropout(h, p=p, name="dr%d" % int(p * 10))
        return mx.sym.FullyConnected(h, num_hidden=4, no_bias=True,
                                     name="fb%d" % int(p * 10))

    js, ts = _both(build)
    assert ts.tojson() == js.tojson()
    res = {}
    for mx, s, ctx in ((jmx, js, jmx.cpu()), (tmx, ts, tmx.cpu())):
        exe = s.simple_bind(ctx=ctx, data=x.shape)
        names = s.list_arguments()
        exe.arg_dict["data"][:] = x
        exe.arg_dict[names[1]][:] = w1
        exe.arg_dict[names[2]][:] = w2
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward(out_grads=[mx.nd.array(og, ctx=ctx)])
        res[mx] = (out, [exe.grad_dict[n].asnumpy() for n in names])
    (jo, jg), (to, tg) = res[jmx], res[tmx]
    np.testing.assert_allclose(to, jo, rtol=REL, atol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=REL, atol=1e-5)


# ------------------------------------------------------ LRN, LeakyReLU
def _fwd_bwd_both(build, inputs, seed=5):
    js, ts = _both(build)
    assert ts.tojson() == js.tojson()
    shapes = {n: v.shape for n, v in inputs.items()}
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)
    og = np.random.RandomState(seed).randn(*ts.infer_shape(**shapes)[1][0]).astype(np.float32)
    res = []
    for mx, s, ctx in ((jmx, js, jmx.cpu()), (tmx, ts, tmx.cpu())):
        exe = s.simple_bind(ctx=ctx, **shapes)
        for n, v in inputs.items():
            exe.arg_dict[n][:] = v
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward(out_grads=[mx.nd.array(og, ctx=ctx)])
        res.append((out, {n: exe.grad_dict[n].asnumpy() for n in inputs}))
    (jo, jg), (to, tg) = res
    scale = np.abs(jo).max()
    np.testing.assert_allclose(to, jo, rtol=REL, atol=REL * scale)
    for n in inputs:
        gs = np.abs(jg[n]).max()
        np.testing.assert_allclose(tg[n], jg[n], rtol=REL, atol=REL * gs, err_msg=n)


@pytest.mark.parametrize("nsize,alpha,beta,knorm", [
    (5, 1e-4, 0.75, 2.0), (3, 0.5, 0.6, 1.0), (1, 0.2, 0.75, 1.5), (7, 2e-2, 0.9, 2.0)])
def test_lrn_matches_jax(nsize, alpha, beta, knorm):
    x = np.random.RandomState(nsize).randn(2, 9, 5, 4).astype(np.float32) * 3
    _fwd_bwd_both(lambda mx: mx.sym.LRN(mx.sym.Variable("data"), nsize=nsize,
                                        alpha=alpha, beta=beta, knorm=knorm,
                                        name="lrn"), {"data": x})


def test_lrn_even_window_raises_in_both():
    """An even window (nsize // 2 channels each side) gives C + 1 channels:
    the JAX package fails to broadcast it, the port says so."""
    js, ts = _both(lambda mx: mx.sym.LRN(mx.sym.Variable("data"), nsize=4,
                                         name="lrn"))
    with pytest.raises(Exception):
        js.infer_shape(data=(2, 6, 3, 3))
    with pytest.raises(MXNetError, match="even"):
        ts.infer_shape(data=(2, 6, 3, 3))
    with pytest.raises(MXNetError, match="even"):
        tmx.nd.LRN(tmx.nd.ones((2, 6, 3, 3), ctx=tmx.cpu()), nsize=4)


@pytest.mark.parametrize("act,extra", [
    ("leaky", {"slope": 0.1}), ("elu", {"slope": 0.7}), ("prelu", {})])
def test_leaky_relu_matches_jax(act, extra):
    rng = np.random.RandomState(4)
    inputs = {"data": rng.randn(3, 4, 5).astype(np.float32)}
    if act == "prelu":
        inputs["lr_gamma"] = (rng.rand(4) * 0.5).astype(np.float32)

    def build(mx):
        kw = dict(extra)
        if act == "prelu":
            kw["gamma"] = mx.sym.Variable("lr_gamma")
        return mx.sym.LeakyReLU(mx.sym.Variable("data"), act_type=act,
                                name="lr", **kw)

    _fwd_bwd_both(build, inputs)


def test_rrelu_inference_matches_jax_and_training_draws_in_bounds():
    x = np.random.RandomState(2).randn(8, 6).astype(np.float32)
    lo, hi = 0.1, 0.4
    j = jmx.nd.LeakyReLU(jmx.nd.array(x), act_type="rrelu", lower_bound=lo,
                         upper_bound=hi).asnumpy()
    t = tmx.nd.LeakyReLU(tmx.nd.array(x, ctx=tmx.cpu()), act_type="rrelu",
                         lower_bound=lo, upper_bound=hi).asnumpy()
    np.testing.assert_allclose(t, j, rtol=REL)
    s = tmx.sym.LeakyReLU(tmx.sym.Variable("data"), act_type="rrelu",
                          lower_bound=lo, upper_bound=hi)
    exe = s.simple_bind(ctx=tmx.cpu(), data=x.shape)
    exe.arg_dict["data"][:] = x
    y = exe.forward(is_train=True)[0].asnumpy()
    neg = x < 0
    slopes = y[neg] / x[neg]
    assert np.all(slopes >= lo - 1e-6) and np.all(slopes <= hi + 1e-6)
    assert np.array_equal(y[~neg], x[~neg])
    # one slope per sample
    per_row = [np.unique(np.round((y[i] / x[i])[neg[i]], 5)) for i in range(8)]
    assert all(len(r) <= 1 for r in per_row)
    op = get_op("LeakyReLU")
    attrs, _ = op.canonicalize_attrs({"act_type": "rrelu"})
    assert op.stochastic(attrs)
    assert not op.stochastic(op.canonicalize_attrs({"act_type": "leaky"})[0])
    with pytest.raises(MXNetError, match="no generator"):
        op.forward(OpContext(is_train=True, device="cpu"), attrs,
                   [torch.ones(2, 2)], [])
