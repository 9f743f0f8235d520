"""The port's operator surface against the JAX package, one case per op.

Every op name the port registers beyond its first 107 (the core
operator surface: elementwise, matrix, reduction, indexing, ordering,
layer, loss, creation, optimizer-update and spatial ops; the contrib ops
and ``Custom``; aliases included) and a few variants of their modes: the same ``mx.sym.<op>`` is
built in both packages, bound with ``simple_bind`` on the CPU, fed the
same seeded inputs (``mxnet_tpu_torch.test_utils``) and the same seeded
head gradient, and the outputs, input gradients and aux states are
compared: rtol 1e-5 / atol 1e-6 for smooth float32 ops, bit for bit
for comparison, rounding, indexing and ordering ops (ties included).
The JAX package runs as its own tests run it on the CPU.
"""
import numpy as np
import pytest

import mxnet_tpu as J
import mxnet_tpu_torch as T
from mxnet_tpu.ops import registry as JR
from mxnet_tpu_torch.ops import registry as TR
from mxnet_tpu_torch.test_utils import op_cases, run_case

RTOL, ATOL = 1e-5, 1e-6

#: the names the port registered before its core operator surface
PORTED_BEFORE = frozenset("""
Activation BatchNorm BatchNorm_v1 Concat Convolution Convolution_v1 Dropout
Embedding Flatten FullyConnected LRN LeakyReLU Pooling Pooling_v1 RNN Reshape
SliceChannel Softmax SoftmaxOutput SwapAxis _Div _DivScalar _Minus _MinusScalar
_Mul _MulScalar _Plus _PlusScalar _RDivScalar _RMinusScalar
_contrib_CachedMultiHeadAttention _contrib_FlashAttention
_contrib_MultiHeadAttention _contrib_PagedAttention _copy _div _div_scalar
_full _minus _minus_scalar _mul _mul_scalar _ones _plus _plus_scalar
_random_exponential _random_gamma _random_negative_binomial _random_normal
_random_poisson _random_randint _random_uniform _rdiv_scalar _rminus_scalar
_sample_exponential _sample_gamma _sample_multinomial _sample_negative_binomial
_sample_normal _sample_poisson _sample_uniform _sub _zeros broadcast_add
broadcast_div broadcast_minus broadcast_mul broadcast_plus broadcast_sub concat
elemwise_add elemwise_div elemwise_mul elemwise_sub expand_dims flatten
identity log_softmax mean negative normal ones_like random_exponential
random_gamma random_negative_binomial random_normal random_poisson
random_randint random_uniform reshape sample_exponential sample_gamma
sample_multinomial sample_negative_binomial sample_normal sample_poisson
sample_uniform softmax split sqrt square sum sum_axis swapaxes take uniform
zeros_like""".split())

#: what the port leaves for later: nothing (the uint8 wire's decode, the
#: last name, came with the data pipeline)
NOT_PORTED = frozenset()

NEW = sorted(set(TR.list_ops()) - PORTED_BEFORE)
CASES = op_cases(NEW)


def test_coverage_is_all_but_contrib_custom_and_the_wire():
    import mxnet_tpu.operator  # noqa: F401 - registers Custom
    assert set(JR.list_ops()) - set(TR.list_ops()) == NOT_PORTED
    assert len(NOT_PORTED) == 0
    assert len(set(JR.list_ops())) == 297
    assert PORTED_BEFORE <= set(TR.list_ops())
    # 167 names of the core surface, contrib_ops.py's 21, Custom and the
    # wire's _image_wire_normalize
    assert len(NEW) == 190
    assert set(NEW) <= set(CASES)


def _close(got, want, exact, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64),
                                   rtol=RTOL, atol=ATOL, equal_nan=True,
                                   err_msg=what)


@pytest.mark.parametrize("cid", sorted(CASES))
def test_op_matches_jax(cid):
    case = CASES[cid]
    exact = case.kind == "exact"
    j_out, j_grad, j_aux = run_case(J, case, J.cpu())
    t_out, t_grad, t_aux = run_case(T, case, T.cpu())
    assert len(t_out) == len(j_out)
    for i, (a, b) in enumerate(zip(t_out, j_out)):
        assert a.dtype == b.dtype, (cid, i, a.dtype, b.dtype)
        _close(a, b, exact, "%s output %d" % (cid, i))
    assert sorted(t_grad) == sorted(j_grad)
    for n in j_grad:
        _close(t_grad[n], j_grad[n], exact, "%s gradient of %s" % (cid, n))
    for i, (a, b) in enumerate(zip(t_aux, j_aux)):
        _close(a, b, exact, "%s aux %d" % (cid, i))


@pytest.mark.parametrize("op", ["round", "rint"])
def test_round_half_to_even(op):
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    got = getattr(T.nd, op)(T.nd.array(x, ctx=T.cpu())).asnumpy()
    want = getattr(J.nd, op)(J.nd.array(x, ctx=J.cpu())).asnumpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [-2, -2, -0, 0, 2, 2, 4])


def test_infer_shape_and_json_match_jax():
    """Each case's symbol: the same JSON byte for byte, and the same
    inferred shapes from the data shapes alone."""
    for cid, case in sorted(CASES.items()):
        syms = []
        for mx in (J, T):
            if case.setup is not None:
                case.setup(mx)
            with mx.name.NameManager():
                syms.append(getattr(mx.sym, case.name)(name="op", **case.attrs))
        assert syms[0].tojson() == syms[1].tojson(), cid


UPDATES = {
    "sgd_mom_update": (("mom",), {"momentum": 0.9}),
    "adam_update": (("mean", "var"), {"beta1": 0.8, "beta2": 0.9}),
    "rmsprop_update": (("n",), {"gamma1": 0.9}),
    "rmspropalex_update": (("n", "g", "delta"), {"gamma1": 0.9, "gamma2": 0.8}),
}


@pytest.mark.parametrize("op", sorted(UPDATES))
def test_update_ops_write_states_in_place(op):
    """C7: the port writes the state arguments in place (the reference's
    FMutateInputs); they equal the JAX op's hidden outputs, which the JAX
    package's imperative call drops (its state arrays stay as they were)."""
    states, extra = UPDATES[op]
    r = np.random.RandomState(3)
    w, g = r.randn(5).astype(np.float32), r.randn(5).astype(np.float32)
    st = [np.abs(r.randn(5)).astype(np.float32) + 1 for _ in states]
    attrs = dict(lr=0.1, wd=0.01, **extra)
    jop = JR.get_op(op)
    jattrs, _ = jop.canonicalize_attrs(attrs)
    import jax.numpy as jnp
    want, _ = jop.forward(JR.OpContext(), jattrs,
                          [jnp.asarray(a) for a in [w, g] + st], [])
    # the port: the weight written to out=w, every state in place
    tw = T.nd.array(w, ctx=T.cpu())
    tst = [T.nd.array(s, ctx=T.cpu()) for s in st]
    held = [s.data for s in tst]
    getattr(T.nd, op)(tw, T.nd.array(g, ctx=T.cpu()), *tst, out=tw, **attrs)
    np.testing.assert_allclose(tw.asnumpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-7)
    for s, h, ref in zip(tst, held, want[1:]):
        assert s.data is h       # the same tensor, written in place
        np.testing.assert_allclose(s.asnumpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
    # the JAX package: the weight updates, the states stay unchanged
    jw = J.nd.array(w, ctx=J.cpu())
    jst = [J.nd.array(s, ctx=J.cpu()) for s in st]
    getattr(J.nd, op)(jw, J.nd.array(g, ctx=J.cpu()), *jst, out=jw, **attrs)
    np.testing.assert_allclose(jw.asnumpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-7)
    for s, before in zip(jst, st):
        np.testing.assert_array_equal(s.asnumpy(), before)
