"""The modifier and bidirectional RNN cells of the port against the JAX
package, on the CPU: ``ResidualCell``, ``ZoneoutCell``,
``BidirectionalCell`` (merged and per-step outputs) and a bidirectional
``FusedRNNCell``'s ``unfuse``, each unrolled into a symbol whose JSON is
the JAX package's byte for byte, then bound and run forward and backward
from the same seeded inputs and head gradients (1e-5 absolute and
relative; gradients through the recurrence 1e-4 relative). Zoneout draws
its masks from each package's own generator, so it is compared in
inference (no zoneout), and its training masks are checked on the port
alone: each unit is the new or the previous value.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

TOL = 1e-5
GRAD_RTOL = 1e-4
T, N, H = 4, 3, 5


def _both(build):
    with jmx.name.NameManager():
        js = build(jmx)
    with tmx.name.NameManager():
        ts = build(tmx)
    return js, ts


def _run(mx, sym, inputs, out_grads, ctx, is_train=True):
    exe = sym.simple_bind(ctx=ctx, **{n: v.shape for n, v in inputs.items()})
    for n, v in inputs.items():
        exe.arg_dict[n][:] = v
    outs = [o.asnumpy() for o in exe.forward(is_train=is_train)]
    if not is_train:
        return outs, {}
    exe.backward(out_grads=[mx.nd.array(g, ctx=ctx) for g in out_grads])
    return outs, {n: exe.grad_dict[n].asnumpy() for n in inputs}


def _inputs(sym, seed=3):
    rng = np.random.RandomState(seed)
    shapes = {"data": (N, T, H)}
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    return {n: (rng.randn(*s) * (1.0 if n == "data" else 0.3)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)}


def _check(js, ts, is_train=True):
    assert ts.tojson() == js.tojson()
    inputs = _inputs(ts)
    shapes = {n: v.shape for n, v in inputs.items()}
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)
    rng = np.random.RandomState(7)
    ogs = [rng.randn(*s).astype(np.float32) for s in ts.infer_shape(**shapes)[1]]
    jo, jg = _run(jmx, js, inputs, ogs, jmx.cpu(), is_train)
    to, tg = _run(tmx, ts, inputs, ogs, tmx.cpu(), is_train)
    assert len(to) == len(jo)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], rtol=GRAD_RTOL, atol=TOL, err_msg=n)


def _build(make, merge=True, with_states=False):
    def build(mx):
        cell = make(mx)
        outs, states = cell.unroll(T, inputs=mx.sym.Variable("data"),
                                   merge_outputs=merge)
        outs = outs if isinstance(outs, mx.sym.Symbol) else mx.sym.Group(outs)
        return mx.sym.Group([outs] + list(states)) if with_states else outs

    return build


CELLS = {
    "residual_lstm": lambda mx: mx.rnn.ResidualCell(
        mx.rnn.LSTMCell(H, prefix="l0_")),
    "residual_gru_stack": lambda mx: _stack(mx, mx.rnn.ResidualCell(
        mx.rnn.GRUCell(H, prefix="g0_")), mx.rnn.RNNCell(H, prefix="r1_")),
    "bidirectional_lstm": lambda mx: mx.rnn.BidirectionalCell(
        mx.rnn.LSTMCell(H, prefix="l_"), mx.rnn.LSTMCell(H, prefix="r_")),
    "bidirectional_gru": lambda mx: mx.rnn.BidirectionalCell(
        mx.rnn.GRUCell(H, prefix="l_"), mx.rnn.GRUCell(H, prefix="r_"),
        output_prefix="bgru_"),
}


def _stack(mx, *cells):
    s = mx.rnn.SequentialRNNCell()
    for c in cells:
        s.add(c)
    return s


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_matches_jax(name, merge):
    _check(*_both(_build(CELLS[name], merge=merge, with_states=True)))


@pytest.mark.parametrize("p", [(0.5, 0.0), (0.0, 0.5), (0.3, 0.4)])
def test_zoneout_matches_jax_in_inference(p):
    def make(mx):
        return mx.rnn.ZoneoutCell(mx.rnn.LSTMCell(H, prefix="z_"),
                                  zoneout_outputs=p[0], zoneout_states=p[1])

    _check(*_both(_build(make, with_states=True)), is_train=False)


def test_zoneout_training_keeps_new_or_previous_values():
    """Training zoneout through the port's Dropout masks: each output unit
    of a step is that step's LSTM output or the previous zoned output."""
    with tmx.name.NameManager():
        plain = _build(lambda mx: mx.rnn.LSTMCell(H, prefix="z_"), merge=False)(tmx)
        zoned = _build(lambda mx: mx.rnn.ZoneoutCell(
            mx.rnn.LSTMCell(H, prefix="z_"), zoneout_outputs=0.5),
            merge=False)(tmx)
    inputs = _inputs(plain)
    tmx.random.seed(0)
    zo, _ = _run(tmx, zoned, inputs, None, tmx.cpu(), is_train=False)
    po, _ = _run(tmx, plain, inputs, None, tmx.cpu(), is_train=False)
    np.testing.assert_allclose(zo[0], po[0], rtol=TOL, atol=TOL)
    exe = zoned.simple_bind(ctx=tmx.cpu(), **{n: v.shape for n, v in inputs.items()})
    for n, v in inputs.items():
        exe.arg_dict[n][:] = v
    outs = [o.asnumpy() for o in exe.forward(is_train=True)]
    # step 0 zones against zeros: each unit is the output or 0
    assert np.all((outs[0] == 0) | np.isclose(outs[0], po[0], atol=1e-6))
    assert 0 < (outs[0] == 0).mean() < 1


def test_zoneout_refuses_fused_and_bidirectional():
    with pytest.raises(MXNetError):
        tmx.rnn.ZoneoutCell(tmx.rnn.FusedRNNCell(H, prefix="f_"))
    with pytest.raises(MXNetError):
        tmx.rnn.ZoneoutCell(tmx.rnn.BidirectionalCell(
            tmx.rnn.LSTMCell(H, prefix="l_"), tmx.rnn.LSTMCell(H, prefix="r_")))


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
def test_bidirectional_unfuse_matches_jax(mode):
    """A two-layer bidirectional FusedRNNCell's unfuse: the same stack of
    BidirectionalCells as the JAX package's, with the same values."""
    def make(mx):
        return mx.rnn.FusedRNNCell(H, num_layers=2, mode=mode, bidirectional=True,
                                   prefix="f_").unfuse()

    js, ts = _both(_build(make, with_states=True))
    _check(js, ts)
    # the unfused cells' names: one BidirectionalCell per layer
    assert "f_bi_%s_1out" % mode in ts.tojson()
