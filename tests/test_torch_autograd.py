"""The port's imperative autograd (``contrib.autograd``) against the JAX
package's, on the CPU.

Each case of ``tests/test_autograd.py`` runs through both packages on the
same seeded numpy inputs and the gradients are compared (float32, rtol
1e-5 / atol 1e-6). ``_contrib_FlashAttention`` and
``_contrib_MultiHeadAttention`` recorded under a ``train_section`` run the
port's plain flash forward and backward on the CPU (the card runs the
K1/K2a/K2b kernels through the same ``torch.autograd.Function``); their
gradients are held against the JAX package's ``jax.vjp`` replay of its
tape, to the flash tolerance of ``tests/test_torch_attention.py`` (2e-5).
The port records the forward's own Dropout mask; the JAX package replays
its tape with a fixed key (``ROADMAP.md`` C11), which the C11 case shows.
"""
import numpy as np
import pytest

import mxnet_tpu as J
import mxnet_tpu_torch as T
from mxnet_tpu.contrib import autograd as JAG
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import autograd as TAG

RTOL, ATOL = 1e-5, 1e-6
FLASH_TOL = 2e-5


def _nd(mx, a):
    return mx.nd.array(np.asarray(a, np.float32), ctx=mx.cpu())


def _ag(mx):
    return JAG if mx is J else TAG


# ---- the cases of tests/test_autograd.py, each through both packages ----
def case_backward_elemwise(mx):
    ag = _ag(mx)
    x = _nd(mx, [1.0, 2.0, 3.0])
    gx = mx.nd.zeros((3,), ctx=mx.cpu())
    ag.mark_variables(x, gx)
    with ag.train_section():
        y = x * x + 2 * x
    ag.backward([y])
    return [gx.asnumpy(), y.asnumpy()]


def case_backward_with_head_grad(mx):
    ag = _ag(mx)
    x = _nd(mx, [[1.0, 2.0], [3.0, 4.0]])
    gx = mx.nd.zeros((2, 2), ctx=mx.cpu())
    ag.mark_variables(x, gx)
    with ag.train_section():
        y = x * x
    ag.backward([y], out_grads=[_nd(mx, [[1.0, 0.0], [0.0, 2.0]])])
    return [gx.asnumpy()]


def case_grad_req_add(mx):
    ag = _ag(mx)
    x = _nd(mx, np.ones(4))
    gx = _nd(mx, np.full(4, 10.0))
    ag.mark_variables(x, gx, grad_reqs="add")
    with ag.train_section():
        y = 3 * x
    ag.backward([y])
    return [gx.asnumpy()]


def case_grad_and_loss(mx):
    ag = _ag(mx)

    @ag.grad_and_loss
    def f(x):
        return mx.nd.square(x)

    grads, loss = f(_nd(mx, [1.0, 2.0, 3.0]))
    return [grads[0].asnumpy(), loss.asnumpy()]


def case_grad_argnum(mx):
    ag = _ag(mx)

    def f(x, w):
        return x * w

    grads = ag.grad(f, argnum=1)(_nd(mx, [1.0, 2.0]), _nd(mx, [4.0, 5.0]))
    return [grads[0].asnumpy()]


def case_chained_ops_through_matmul(mx):
    ag = _ag(mx)
    x = _nd(mx, np.arange(6).reshape(2, 3))
    w = _nd(mx, np.random.RandomState(0).standard_normal((3, 3)))
    gw = mx.nd.zeros((3, 3), ctx=mx.cpu())
    ag.mark_variables(w, gw)
    with ag.train_section():
        z = mx.nd.sum(mx.nd.tanh(mx.nd.dot(x, w)))
    ag.backward([z])
    return [gw.asnumpy(), z.asnumpy()]


def case_layers_and_test_section(mx):
    """FullyConnected, softmax and a BatchNorm with its aux states, a
    test_section inside the train section (inference BatchNorm)."""
    ag = _ag(mx)
    r = np.random.RandomState(1)
    x = _nd(mx, r.standard_normal((4, 6)))
    w = _nd(mx, r.standard_normal((5, 6)) * 0.3)
    b = _nd(mx, r.standard_normal(5))
    gamma, beta = _nd(mx, np.ones(5)), _nd(mx, np.zeros(5))
    mm, mv = _nd(mx, np.zeros(5)), _nd(mx, np.ones(5))
    grads = [mx.nd.zeros(a.shape, ctx=mx.cpu()) for a in (w, b, gamma)]
    ag.mark_variables([w, b, gamma], grads)
    with ag.train_section():
        h = mx.nd.FullyConnected(x, w, b, num_hidden=5)
        h = mx.nd.BatchNorm(h, gamma, beta, mm, mv, fix_gamma=False)
        with ag.test_section():
            probe = mx.nd.BatchNorm(h, gamma, beta, mm, mv, fix_gamma=False)
        y = mx.nd.softmax(h) * _nd(mx, r.standard_normal((4, 5)))
    ag.backward([y])
    return [g.asnumpy() for g in grads] + [mm.asnumpy(), mv.asnumpy(),
                                           probe.asnumpy()]


CASES = {f.__name__[5:]: f for f in (
    case_backward_elemwise, case_backward_with_head_grad, case_grad_req_add,
    case_grad_and_loss, case_grad_argnum, case_chained_ops_through_matmul,
    case_layers_and_test_section)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_autograd_case_matches_jax(name):
    want = CASES[name](J)
    got = CASES[name](T)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)


def test_train_test_sections_gate_dropout():
    x = _nd(T, np.ones(256))
    with TAG.train_section():
        y_train = T.nd.Dropout(x, p=0.5)
    with TAG.test_section():
        y_test = T.nd.Dropout(x, p=0.5)
    np.testing.assert_array_equal(y_test.asnumpy(), x.asnumpy())
    yt = y_train.asnumpy()
    assert (yt == 0).any() and np.allclose(yt[yt != 0], 2.0)
    assert not TAG.is_recording()


# ---- the flash-attention ops under autograd ------------------------------
def _flash_grads(mx, q, k, v, g, causal):
    ag = _ag(mx)
    arrs = [_nd(mx, a) for a in (q, k, v)]
    grads = [mx.nd.zeros(a.shape, ctx=mx.cpu()) for a in arrs]
    ag.mark_variables(arrs, grads)
    with ag.train_section():
        out = mx.nd.contrib.FlashAttention(*arrs, causal=causal)
    ag.backward([out], out_grads=[_nd(mx, g)])
    return [out.asnumpy()] + [x.asnumpy() for x in grads]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_under_autograd_matches_jax_vjp(causal):
    r = np.random.RandomState(3 + causal)
    q, k, v, g = (r.standard_normal((2, 2, 40, 16)).astype(np.float32)
                  for _ in range(4))
    want = _flash_grads(J, q, k, v, g, causal)
    got = _flash_grads(T, q, k, v, g, causal)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=FLASH_TOL, atol=FLASH_TOL,
                                   err_msg=name)


def _mha_grads(mx, x, wi, wo, g):
    ag = _ag(mx)
    arrs = [_nd(mx, a) for a in (x, wi, wo)]
    grads = [mx.nd.zeros(a.shape, ctx=mx.cpu()) for a in arrs]
    ag.mark_variables(arrs, grads)
    with ag.train_section():
        h = mx.nd.contrib.MultiHeadAttention(*arrs, num_heads=2, causal=True)
        y = mx.nd.relu(h + arrs[0])
    ag.backward([y], out_grads=[_nd(mx, g)])
    return [y.asnumpy()] + [a.asnumpy() for a in grads]


def test_multi_head_attention_block_under_autograd_matches_jax_vjp():
    r = np.random.RandomState(11)
    x = r.standard_normal((2, 24, 16)).astype(np.float32)
    wi = (r.standard_normal((48, 16)) * 0.25).astype(np.float32)
    wo = (r.standard_normal((16, 16)) * 0.25).astype(np.float32)
    g = r.standard_normal((2, 24, 16)).astype(np.float32)
    want = _mha_grads(J, x, wi, wo, g)
    got = _mha_grads(T, x, wi, wo, g)
    for name, a, b in zip(("y", "dx", "d_in_weight", "d_out_weight"), got, want):
        np.testing.assert_allclose(a, b, rtol=FLASH_TOL, atol=FLASH_TOL,
                                   err_msg=name)


# ---- C11: the gradient's Dropout mask is the forward's -------------------
def _dropout_masks(mx):
    ag = _ag(mx)
    mx.random.seed(0)
    x = _nd(mx, np.ones((4, 64)))
    gx = mx.nd.zeros((4, 64), ctx=mx.cpu())
    ag.mark_variables(x, gx)
    with ag.train_section():
        y = mx.nd.Dropout(x, p=0.5)
    ag.backward([y])
    return y.asnumpy() != 0, gx.asnumpy() != 0, gx.asnumpy()


def test_c11_dropout_gradient_uses_the_forward_mask():
    fwd, bwd, g = _dropout_masks(T)
    assert 0 < fwd.sum() < fwd.size
    np.testing.assert_array_equal(bwd, fwd)
    np.testing.assert_array_equal(g[fwd], 2.0)
    # the JAX package replays its tape with PRNGKey(0): another mask
    jfwd, jbwd, _ = _dropout_masks(J)
    assert (jfwd == jbwd).mean() < 0.9


# ---- the tape, writes and errors -------------------------------------------
def test_second_backward_raises_unless_the_graph_is_retained():
    for retain in (True, False):
        q = _nd(T, np.random.RandomState(0).standard_normal((1, 1, 8, 8)))
        gq = T.nd.zeros(q.shape, ctx=T.cpu())
        TAG.mark_variables(q, gq)
        with TAG.train_section():
            out = T.nd.contrib.FlashAttention(q, q, q)
        TAG.backward([out], retain_graph=retain)
        first = gq.asnumpy().copy()
        if retain:
            TAG.backward([out])
            np.testing.assert_allclose(gq.asnumpy(), first, rtol=1e-6)
        else:
            with pytest.raises(MXNetError, match="retain_graph"):
                TAG.backward([out])
    with pytest.raises(KeyError):
        # the JAX package raises too: its cleared tape no longer has the head
        x = _nd(J, [1.0, 2.0])
        JAG.mark_variables(x, J.nd.zeros((2,), ctx=J.cpu()))
        with JAG.train_section():
            y = x * x
        JAG.backward([y])
        JAG.backward([y])


def test_writes_are_constants_and_marked_variables_refuse_them():
    """``out=`` and aux writes are not recorded (a later op reads a
    constant, as in the JAX package's replay); writing into a marked
    variable inside a train section raises."""
    x = _nd(T, [1.0, 2.0, 3.0])
    gx = T.nd.zeros((3,), ctx=T.cpu())
    buf = T.nd.zeros((3,), ctx=T.cpu())
    TAG.mark_variables(x, gx)
    with TAG.train_section():
        T.nd.square(x, out=buf)
        y = buf * x
        with pytest.raises(MXNetError, match="marked for autograd"):
            T.nd.square(buf, out=x)
    TAG.backward([y])
    np.testing.assert_allclose(gx.asnumpy(), [1.0, 4.0, 9.0])
    jx = _nd(J, [1.0, 2.0, 3.0])
    jgx = J.nd.zeros((3,), ctx=J.cpu())
    jbuf = J.nd.zeros((3,), ctx=J.cpu())
    JAG.mark_variables(jx, jgx)
    with JAG.train_section():
        J.nd.square(jx, out=jbuf)
        jy = jbuf * jx
    JAG.backward([jy])
    np.testing.assert_allclose(gx.asnumpy(), jgx.asnumpy())


def test_no_marked_variables_and_null_grad_req():
    TAG._MARKED.clear()
    with pytest.raises(MXNetError, match="no variables marked"):
        TAG.backward([_nd(T, [1.0])])
    x, w = _nd(T, [1.0, 2.0]), _nd(T, [3.0, 4.0])
    gx, gw = T.nd.zeros((2,), ctx=T.cpu()), _nd(T, [7.0, 7.0])
    TAG.mark_variables([x, w], [gx, gw], grad_reqs=["write", "null"])
    with TAG.train_section():
        y = x * w
    TAG.backward([y])
    np.testing.assert_array_equal(gx.asnumpy(), [3.0, 4.0])
    np.testing.assert_array_equal(gw.asnumpy(), [7.0, 7.0])
    with pytest.raises(MXNetError):
        TAG.mark_variables(x, gx, grad_reqs="sum")
