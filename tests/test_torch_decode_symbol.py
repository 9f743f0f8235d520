"""Parity of the port's decode symbol and its ops with the JAX package, on
the CPU.

``get_decode_symbol`` must serialize to the JAX package's JSON byte for
byte; bound at (batch, 1) in both packages with the same numpy
parameters, ``decode_step`` gives the same probabilities at every
position (1e-5), and so does the serving model fed the same parameters
through ``serving.model.as_device_params``. The port's decode symbol
reproduces its own training symbol's full forward (the mirror of
``tests/test_models.py``), honours the overflow contract (NaN output,
caches bitwise unchanged, ``decode_step`` raises) and writes detached
caches. The new ops (``_contrib_CachedMultiHeadAttention``,
``_contrib_PagedAttention``, ``take`` in both modes, ``softmax``,
``log_softmax``) equal the JAX ops through ``mx.nd``; the paged op there
is the plain version (the ``paged_decode`` kernel runs only on the card,
where ``chip_smoke.py`` phase 16 holds the op against it).
"""
import importlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.serving import model as jmodel
from mxnet_tpu_torch.ops.registry import has_op
from mxnet_tpu_torch.serving import ServingConfig, model

J_LM = importlib.import_module("mxnet_tpu.models.transformer_lm")
T_LM = importlib.import_module("mxnet_tpu_torch.models.transformer_lm")

CFG = dict(vocab_size=29, num_layers=2, model_dim=32, num_heads=2,
           ffn_dim=48, seq_len=16)
BATCH = 3
PROB_TOL = 1e-5
OP_TOL = 1e-5


def _serving_cfg():
    c = dict(CFG)
    c["max_len"] = c.pop("seq_len")
    return ServingConfig(**c, block_size=8, num_blocks=16, max_batch=4,
                         prefix_cache=False, spec_k=0, max_queue=0,
                         default_timeout_ms=0)


def _params():
    """Seeded numpy weights under the training graph's names."""
    return jmodel.random_params(_serving_cfg(), seed=5)


def _bind(pkg, lm, params):
    ex = lm.get_decode_symbol(**CFG).simple_bind(
        ctx=pkg.cpu(), grad_req="null", data=(BATCH, 1))
    for n, a in ex.arg_dict.items():
        if n in params:
            a[:] = params[n]
    return ex


def _tokens(seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, CFG["vocab_size"], (BATCH, CFG["seq_len"]))


@pytest.mark.parametrize("over", [{}, dict(num_layers=1, num_heads=4,
                                              seq_len=32, vocab_size=100)])
def test_decode_symbol_json_equals_jax(over):
    kw = dict(CFG, **over)
    # fresh name managers: auto-named nodes count from 0 on both sides
    with jmx.name.NameManager():
        want = J_LM.get_decode_symbol(**kw).tojson()
    with tmx.name.NameManager():
        got = T_LM.get_decode_symbol(**kw).tojson()
    assert got == want


def test_registry_has_the_decode_ops():
    for name in ("_contrib_CachedMultiHeadAttention", "_contrib_PagedAttention",
                 "take", "softmax", "log_softmax"):
        assert has_op(name), name


def test_decode_steps_match_jax_and_the_serving_model():
    """Per step: the port's decode executor = the JAX one, and = the
    softmax of the serving model's decode logits (parameters carried as
    numpy arrays into both executors and through ``as_device_params``)."""
    params = _params()
    jex, tex = _bind(jmx, J_LM, params), _bind(tmx, T_LM, params)
    cfg = _serving_cfg()
    dev = model.as_device_params(params, cfg, device="cpu")
    shape = (cfg.num_layers, cfg.num_blocks, cfg.block_size, cfg.num_heads,
             cfg.model_dim // cfg.num_heads)
    kp, vp = torch.zeros(shape), torch.zeros(shape)
    nb = cfg.max_len // cfg.block_size
    tables = torch.arange(1, 1 + BATCH * nb, dtype=torch.int32).reshape(
        BATCH, nb)
    toks = _tokens()
    for t in range(CFG["seq_len"]):
        want = J_LM.decode_step(jex, toks[:, t], t, CFG["seq_len"])
        got = T_LM.decode_step(tex, toks[:, t], t, CFG["seq_len"])
        np.testing.assert_allclose(got, want, rtol=0, atol=PROB_TOL)
        pos = torch.full((BATCH,), t, dtype=torch.int32)
        _n, logits, _k, _v = model.decode(
            dev, torch.from_numpy(toks[:, t].astype(np.int32)), pos, tables,
            pos + 1, kp, vp, cfg)
        np.testing.assert_allclose(torch.softmax(logits, -1).numpy(), got,
                                   rtol=0, atol=PROB_TOL)


def test_decode_symbol_matches_full_forward():
    """The mirror of tests/test_models.py's KV-cache test, on the port."""
    V, L, M, H, F, T = 17, 2, 32, 2, 48, 12
    kw = dict(vocab_size=V, num_layers=L, model_dim=M, num_heads=H,
              ffn_dim=F, seq_len=T)
    ex_train = T_LM.get_symbol(**kw).simple_bind(
        ctx=tmx.cpu(), data=(1, T), softmax_label=(1, T))
    rng = np.random.RandomState(0)
    for n, a in ex_train.arg_dict.items():
        if n not in ("data", "softmax_label"):
            a[:] = (rng.rand(*a.shape) * 0.2 - 0.1).astype(np.float32)
    toks = rng.randint(0, V, (1, T)).astype(np.float32)
    ex_train.arg_dict["data"][:] = toks
    ex_train.forward(is_train=False)
    full = ex_train.outputs[0].asnumpy().reshape(T, V)
    ex = T_LM.get_decode_symbol(**kw).simple_bind(ctx=tmx.cpu(),
                                                  grad_req="null",
                                                  data=(1, 1))
    for n, a in ex.arg_dict.items():
        if n in ex_train.arg_dict and n != "data":
            a[:] = ex_train.arg_dict[n].asnumpy()
    for t in range(T):
        ex.arg_dict["data"][:] = toks[:, t:t + 1]
        ex.arg_dict["position"][:] = np.array([t], np.float32)
        ex.forward(is_train=True)  # aux write-back persists the caches
        np.testing.assert_allclose(ex.outputs[0].asnumpy()[0], full[t],
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("grad_req", ["null", "write"])
def test_overflow_contract_and_detached_caches(grad_req):
    params = _params()
    ex = T_LM.get_decode_symbol(**CFG).simple_bind(
        ctx=tmx.cpu(), grad_req=grad_req, data=(BATCH, 1))
    for n, a in ex.arg_dict.items():
        if n in params:
            a[:] = params[n]
    toks = _tokens(1)
    T = CFG["seq_len"]
    for t in range(3):
        T_LM.decode_step(ex, toks[:, t], t, T)
    for a in ex.aux_dict.values():
        assert not a.data.requires_grad and a.data.grad_fn is None
    before = {n: a.asnumpy().copy() for n, a in ex.aux_dict.items()}
    for bad in (T, T + 3, -1):
        ex.arg_dict["position"][:] = np.array([bad], np.float32)
        ex.forward(is_train=True)
        assert np.isnan(ex.outputs[0].asnumpy()).all(), bad
        for n, a in ex.aux_dict.items():
            assert np.array_equal(a.asnumpy(), before[n]), (bad, n)
    with pytest.raises(ValueError, match="max_len"):
        T_LM.decode_step(ex, toks[:, 0], T, T)
    # an inference forward reads the caches but never writes them back
    ex.arg_dict["position"][:] = np.array([3], np.float32)
    ex.forward(is_train=False)
    for n, a in ex.aux_dict.items():
        assert np.array_equal(a.asnumpy(), before[n]), n


# ------------------------------------------------------------ the ops
def _nd_pair(arrays):
    return ([jmx.nd.array(a, ctx=jmx.cpu()) for a in arrays],
            [tmx.nd.array(a, ctx=tmx.cpu()) for a in arrays])


@pytest.mark.parametrize("pos", [0, 5, 7, 8, -1])
def test_cached_mha_op_matches_jax(pos):
    rng = np.random.RandomState(pos + 10)
    B, M, H, L = 2, 16, 2, 8
    arrays = [rng.randn(B, 1, M).astype(np.float32),
              (rng.randn(3 * M, M) * 0.3).astype(np.float32),
              (rng.randn(M, M) * 0.3).astype(np.float32),
              np.array([pos], np.float32),
              rng.randn(B, H, L, M // H).astype(np.float32),
              rng.randn(B, H, L, M // H).astype(np.float32)]
    (jx, *jr), (tx, *tr) = _nd_pair(arrays)
    jout = jmx.nd.contrib.CachedMultiHeadAttention(jx, *jr, num_heads=H,
                                                   max_len=L)
    tout = tmx.nd.contrib.CachedMultiHeadAttention(tx, *tr, num_heads=H,
                                                   max_len=L)
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), rtol=0,
                               atol=OP_TOL)
    for j, t in zip(jr[3:], tr[3:]):   # the caches, written back
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=0,
                                   atol=OP_TOL)
    if not 0 <= pos < L:
        assert np.isnan(tout.asnumpy()).all()
        np.testing.assert_array_equal(tr[3].asnumpy(), arrays[4])


@pytest.mark.parametrize("sm_scale", [-1.0, 0.3])
def test_paged_attention_op_matches_jax(sm_scale):
    rng = np.random.RandomState(2)
    B, N, bs, H, D, nb = 3, 9, 4, 2, 8, 2
    lens = np.array([1, 5, 0], np.float32)    # float, as a graph holds them
    tables = np.stack([rng.permutation(np.arange(1, N))[:nb]
                       for _ in range(B)]).astype(np.float32)
    arrays = [rng.randn(B, H, D).astype(np.float32),
              rng.randn(N, bs, H, D).astype(np.float32),
              rng.randn(N, bs, H, D).astype(np.float32), tables, lens]
    jin, tin = _nd_pair(arrays)
    want = jmx.nd.contrib.PagedAttention(*jin, sm_scale=sm_scale).asnumpy()
    got = tmx.nd.contrib.PagedAttention(*tin, sm_scale=sm_scale).asnumpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL)
    assert np.array_equal(got[2], np.zeros_like(got[2]))   # context 0
    # the same op from mx.sym through a bound executor
    names = ("query", "key_pages", "value_pages", "block_table",
             "context_len")
    net = tmx.sym.contrib.PagedAttention(
        *[tmx.sym.Variable(n) for n in names], sm_scale=sm_scale)
    ex = net.bind(tmx.cpu(), dict(zip(names, tin)), grad_req="null")
    ex.forward()
    np.testing.assert_allclose(ex.outputs[0].asnumpy(), want, rtol=0,
                               atol=OP_TOL)


@pytest.mark.parametrize("mode", ["clip", "wrap"])
@pytest.mark.parametrize("axis", [0, 1])
def test_take_matches_jax(mode, axis):
    rng = np.random.RandomState(4)
    a = rng.randn(5, 6).astype(np.float32)
    idx = np.array([[0.0, 2.7, -1.2], [4.9, 7.0, -8.0]], np.float32)
    jin, tin = _nd_pair([a, idx])
    want = jmx.nd.take(*jin, axis=axis, mode=mode).asnumpy()
    got = tmx.nd.take(*tin, axis=axis, mode=mode).asnumpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op", ["softmax", "log_softmax"])
@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_softmax_family_matches_jax(op, axis):
    rng = np.random.RandomState(6)
    x = (rng.randn(3, 4, 5) * 4).astype(np.float32)
    jin, tin = _nd_pair([x])
    want = getattr(jmx.nd, op)(*jin, axis=axis, temperature=2.0).asnumpy()
    got = getattr(tmx.nd, op)(*tin, axis=axis, temperature=2.0).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
