"""Parity of the port's RNN stack with the JAX package, on the CPU.

The same numpy inputs (from a seed) go through the JAX package and the
port: the fused ``RNN`` op in its four modes, two layers, bidirectional,
with state outputs (outputs, final states and the gradients of data,
parameters and initial states under seeded head gradients); the cells'
unrolled symbols (JSON byte for byte) and their forward and backward; a
``FusedRNNCell`` against its ``unfuse``; ``unpack_weights`` /
``pack_weights``; ``BucketSentenceIter`` batches; the creation ops, the
``SliceChannel``/``Concat``/``sum`` the cells build from; the RNN
initializers and the RNN checkpoint helpers. Sizes are tiny. Float32 on
both sides: outputs 1e-5 absolute and relative (only the summation order
differs), gradients through the recurrence 1e-5 absolute and 1e-4
relative.
"""
import importlib

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

TOL = 1e-5
GRAD_RTOL = 1e-4
T, N, I, H = 4, 3, 5, 6


def _both(build):
    """``build(mx)`` in each package under a fresh NameManager."""
    with jmx.name.NameManager():
        js = build(jmx)
    with tmx.name.NameManager():
        ts = build(tmx)
    return js, ts


def _run(mx, sym, inputs, out_grads, ctx):
    """forward(is_train) + backward(out_grads) of ``sym`` bound to
    ``inputs``: (outputs, {name: gradient})."""
    exe = sym.simple_bind(ctx=ctx, **{n: v.shape for n, v in inputs.items()})
    for n, v in inputs.items():
        exe.arg_dict[n][:] = v
    outs = [o.asnumpy() for o in exe.forward(is_train=True)]
    exe.backward(out_grads=[mx.nd.array(g, ctx=ctx) for g in out_grads])
    return outs, {n: exe.grad_dict[n].asnumpy() for n in inputs}


def _check_both(js, ts, inputs, seed=7):
    assert ts.tojson() == js.tojson()
    shapes = {n: v.shape for n, v in inputs.items()}
    assert ts.infer_shape(**shapes) == js.infer_shape(**shapes)
    rng = np.random.RandomState(seed)
    out_shapes = ts.infer_shape(**shapes)[1]
    ogs = [rng.randn(*s).astype(np.float32) for s in out_shapes]
    jo, jg = _run(jmx, js, inputs, ogs, jmx.cpu())
    to, tg = _run(tmx, ts, inputs, ogs, tmx.cpu())
    assert len(jo) == len(to)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    for n in inputs:
        np.testing.assert_allclose(tg[n], jg[n], rtol=GRAD_RTOL, atol=TOL,
                                   err_msg=n)
    return to, tg


# ---------------------------------------------------------------- RNN op
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_rnn_op_matches_jax(mode, bidirectional):
    """Two layers, state outputs: outputs, final h (and c), and gradients
    of data, the packed parameters and the initial states."""
    from mxnet_tpu_torch.ops.rnn_ops import rnn_param_size
    from mxnet_tpu.ops.rnn_ops import rnn_param_size as j_size

    L, d = 2, 2 if bidirectional else 1

    def build(mx):
        kw = dict(state=mx.sym.Variable("h0"))
        if mode == "lstm":
            kw["state_cell"] = mx.sym.Variable("c0")
        return mx.sym.RNN(data=mx.sym.Variable("data"),
                          parameters=mx.sym.Variable("params"), state_size=H,
                          num_layers=L, bidirectional=bidirectional, mode=mode,
                          state_outputs=True, name="rnn", **kw)

    js, ts = _both(build)
    psize = rnn_param_size(L, I, H, bidirectional, mode)
    assert psize == j_size(L, I, H, bidirectional, mode)
    rng = np.random.RandomState(0)
    inputs = {"data": rng.randn(T, N, I).astype(np.float32),
              "params": (rng.randn(psize) * 0.3).astype(np.float32),
              "h0": (rng.randn(L * d, N, H) * 0.5).astype(np.float32)}
    if mode == "lstm":
        inputs["c0"] = (rng.randn(L * d, N, H) * 0.5).astype(np.float32)
    outs, _ = _check_both(js, ts, inputs)
    assert outs[0].shape == (T, N, H * d)
    assert len(outs) == (3 if mode == "lstm" else 2)


def test_rnn_op_output_only_and_names():
    def build(mx):
        return mx.sym.RNN(data=mx.sym.Variable("data"), state_size=H,
                          num_layers=1, mode="gru", name="g")

    js, ts = _both(build)
    assert ts.list_arguments() == js.list_arguments() == [
        "data", "g_parameters", "g_state"]
    assert ts.list_outputs() == js.list_outputs() == ["g_output"]


def test_rnn_dropout_between_layers_raises_in_training():
    """Dropout between layers draws its mask from the graph's generator:
    the op raises in training when it is given none; bound, it runs, and
    the first layer's output is dropped (inference draws nothing)."""
    from mxnet_tpu_torch.ops import sample
    from mxnet_tpu_torch.ops.registry import OpContext, get_op

    s = tmx.sym.RNN(data=tmx.sym.Variable("data"), state_size=H, num_layers=2,
                    mode="lstm", p=0.5, name="r")
    exe = s.simple_bind(ctx=tmx.cpu(), data=(T, N, I))
    rng = np.random.RandomState(4)
    for n, a in exe.arg_dict.items():
        a[:] = rng.randn(*a.shape).astype(np.float32) * 0.3
    ref = exe.forward(is_train=False)[0].asnumpy()
    op = get_op("RNN")
    attrs = s._entries[0][0].attrs
    args = [a.data for a in exe.arg_arrays]
    with pytest.raises(MXNetError, match="no generator"):
        op.forward(OpContext(is_train=True, device="cpu"), attrs, args, [])
    drawn = []
    orig = sample.dropout_mask

    def ones(rng_, shape, keep, dtype, device):
        drawn.append(tuple(shape))
        return torch.ones(shape, dtype=dtype)

    sample.dropout_mask = ones
    try:
        kept = exe.forward(is_train=True)[0].asnumpy()
    finally:
        sample.dropout_mask = orig
    assert drawn == [(T, N, H)]
    np.testing.assert_allclose(kept, ref, rtol=1e-6, atol=1e-7)
    dropped = exe.forward(is_train=True)[0].asnumpy()
    assert not np.allclose(dropped, ref)


# ----------------------------------------------------------------- cells
def _cell_inputs(seed=1, names=None):
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.3).astype(np.float32) for n, s in names.items()}


@pytest.mark.parametrize("kind", ["rnn_tanh", "rnn_relu", "lstm", "gru", "stack"])
def test_cell_unroll_matches_jax(kind):
    """Written-out cells unrolled over a (N, T, I) input, merged outputs:
    JSON, shapes, outputs and every gradient."""
    def make(mx):
        r = mx.rnn
        if kind == "rnn_tanh":
            return r.RNNCell(H, prefix="c_")
        if kind == "rnn_relu":
            return r.RNNCell(H, activation="relu", prefix="c_")
        if kind == "lstm":
            return r.LSTMCell(H, prefix="c_")
        if kind == "gru":
            return r.GRUCell(H, prefix="c_")
        stack = r.SequentialRNNCell()
        stack.add(r.LSTMCell(H, prefix="c0_"))
        stack.add(r.GRUCell(H, prefix="c1_"))
        return stack

    def build(mx):
        cell = make(mx)
        outs, states = cell.unroll(T, inputs=mx.sym.Variable("data"),
                                   merge_outputs=True)
        return mx.sym.Group([outs] + list(states))

    js, ts = _both(build)
    shapes = dict(zip(ts.list_arguments(),
                      ts.infer_shape(data=(N, T, I))[0]))
    outs, _ = _check_both(js, ts, _cell_inputs(names=shapes))
    assert outs[0].shape == (N, T, H)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_fused_cell_unroll_matches_jax(mode):
    """``FusedRNNCell`` over an NTC input (swapped to TNC around the RNN
    op), 2 layers, next states out, begin states from ``_zeros`` with the
    0 batch broadcast."""
    def build(mx):
        cell = mx.rnn.FusedRNNCell(H, num_layers=2, mode=mode, prefix="f_",
                                   get_next_state=True)
        outs, states = cell.unroll(T, inputs=mx.sym.Variable("data"),
                                   layout="NTC", merge_outputs=True)
        return mx.sym.Group([outs] + states)

    js, ts = _both(build)
    shapes = dict(zip(ts.list_arguments(), ts.infer_shape(data=(N, T, I))[0]))
    assert list(shapes) == ["data", "f_parameters"]
    outs, _ = _check_both(js, ts, _cell_inputs(names=shapes))
    assert outs[0].shape == (N, T, H)


def _fused_to_unfused(flat, num_layers, mode, prefix):
    """The packed vector as the unfused cells' per-layer arrays (the
    packing contract of ops/rnn_ops.py)."""
    from mxnet_tpu_torch.ops.rnn_ops import _gates

    g = _gates(mode)
    out, off = {}, 0
    for layer in range(num_layers):
        isz = I if layer == 0 else H
        for name, shape in (("i2h_weight", (g * H, isz)), ("h2h_weight", (g * H, H)),
                            ("i2h_bias", (g * H,)), ("h2h_bias", (g * H,))):
            n = int(np.prod(shape))
            out["%sl%d_%s" % (prefix, layer, name)] = flat[off:off + n].reshape(shape)
            off += n
    assert off == flat.size
    return out


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
def test_unfuse_matches_fused(mode):
    """The fused op and its unfused stack over the same packed weights
    give the same outputs (1e-5); the unfused stack's JSON is the JAX
    package's."""
    cell = tmx.rnn.FusedRNNCell(H, num_layers=2, mode=mode, prefix="p_")
    data = tmx.sym.Variable("data")
    fused, _ = cell.unroll(T, inputs=data, layout="NTC", merge_outputs=True)
    stack = cell.unfuse()
    unfused, _ = stack.unroll(T, inputs=data, layout="NTC", merge_outputs=True)
    psize = fused.infer_shape(data=(N, T, I))[0][1][0]
    rng = np.random.RandomState(3)
    flat = (rng.randn(psize) * 0.3).astype(np.float32)
    x = rng.randn(N, T, I).astype(np.float32)
    f = fused.simple_bind(ctx=tmx.cpu(), data=(N, T, I))
    f.arg_dict["data"][:] = x
    f.arg_dict["p_parameters"][:] = flat
    u = unfused.simple_bind(ctx=tmx.cpu(), data=(N, T, I))
    u.arg_dict["data"][:] = x
    for n, v in _fused_to_unfused(flat, 2, mode, "p_").items():
        u.arg_dict[n][:] = v
    np.testing.assert_allclose(u.forward()[0].asnumpy(), f.forward()[0].asnumpy(),
                               rtol=TOL, atol=TOL)

    def build(mx):
        s = mx.rnn.FusedRNNCell(H, num_layers=2, mode=mode, prefix="p_").unfuse()
        return s.unroll(T, inputs=mx.sym.Variable("data"), merge_outputs=True)[0]

    js, ts = _both(build)
    assert ts.tojson() == js.tojson()


@pytest.mark.parametrize("kind", ["lstm", "gru", "rnn"])
def test_pack_unpack_weights_round_trip(kind):
    """``unpack_weights`` splits i2h/h2h per gate as the JAX package does
    (names and values, bit for bit); ``pack_weights`` inverts it."""
    def make(mx):
        return {"lstm": mx.rnn.LSTMCell, "gru": mx.rnn.GRUCell,
                "rnn": mx.rnn.RNNCell}[kind](H, prefix="w_")

    g = {"lstm": 4, "gru": 3, "rnn": 1}[kind]
    rng = np.random.RandomState(5)
    raw = {"w_i2h_weight": rng.randn(g * H, I), "w_i2h_bias": rng.randn(g * H),
           "w_h2h_weight": rng.randn(g * H, H), "w_h2h_bias": rng.randn(g * H),
           "other": rng.randn(2)}
    raw = {k: v.astype(np.float32) for k, v in raw.items()}
    j = make(jmx).unpack_weights({k: jmx.nd.array(v, ctx=jmx.cpu()) for k, v in raw.items()})
    cell = make(tmx)
    t = cell.unpack_weights({k: tmx.nd.array(v, ctx=tmx.cpu()) for k, v in raw.items()})
    assert sorted(t) == sorted(j)
    for k in t:
        np.testing.assert_array_equal(t[k].asnumpy(), j[k].asnumpy(), err_msg=k)
    back = cell.pack_weights(t)
    assert sorted(back) == sorted(raw)
    for k in raw:
        np.testing.assert_array_equal(back[k].asnumpy(), raw[k], err_msg=k)


def test_begin_state_and_waiting_cells():
    cell = tmx.rnn.LSTMCell(H, prefix="b_")
    states = cell.begin_state()
    assert [s.name for s in states] == ["b_begin_state_0", "b_begin_state_1"]
    assert states[0].attr("__layout__") == "NC"
    assert tmx.rnn.DropoutCell(0.5).state_info == []
    # the cells that waited for the operator surface are built: a modifier
    # takes over its base cell's states, and the base cell then refuses
    # to be called directly
    for wrap in (lambda c: tmx.rnn.ZoneoutCell(c, 0.5), tmx.rnn.ResidualCell,
                 tmx.rnn.ModifierCell):
        base = tmx.rnn.LSTMCell(H, prefix="m_")
        modifier = wrap(base)
        with pytest.raises(MXNetError, match="modifier"):
            base.begin_state()
        assert len(modifier.begin_state()) == 2
    bi = tmx.rnn.BidirectionalCell(tmx.rnn.LSTMCell(H, prefix="l_"),
                                   tmx.rnn.LSTMCell(H, prefix="r_"))
    assert len(bi.state_info) == 4
    stack = tmx.rnn.FusedRNNCell(H, num_layers=2, bidirectional=True).unfuse()
    assert [type(c).__name__ for c in stack._cells] == ["BidirectionalCell"] * 2


# ------------------------------------------------------------------ io
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_bucket_sentence_iter_matches_jax(layout):
    """Same sentences, numpy seeded alike before each package's iterator:
    the same batches (data, labels, bucket keys, shapes) over two epochs."""
    rng = np.random.RandomState(2)
    sents = [list(rng.randint(1, 30, rng.randint(2, 14))) for _ in range(90)]
    its = []
    for mx in (jmx, tmx):
        np.random.seed(11)
        its.append(mx.rnn.BucketSentenceIter(sents, 4, buckets=[5, 9, 12],
                                             invalid_label=0, layout=layout))
    j, t = its
    assert t.default_bucket_key == j.default_bucket_key == 12
    assert [tuple(d) for d in t.provide_data] == [tuple(d) for d in j.provide_data]
    assert t.provide_data[0].layout == layout
    for epoch in range(2):
        np.random.seed(100 + epoch)
        j.reset()
        np.random.seed(100 + epoch)
        t.reset()
        jb, tb = list(j), list(t)
        assert len(jb) == len(tb) > 10
        for a, b in zip(jb, tb):
            assert a.bucket_key == b.bucket_key
            assert b.data[0].context == tmx.cpu()
            np.testing.assert_array_equal(b.data[0].asnumpy(), a.data[0].asnumpy())
            np.testing.assert_array_equal(b.label[0].asnumpy(), a.label[0].asnumpy())
            assert tuple(b.provide_data[0].shape) == tuple(a.provide_data[0].shape)


def test_encode_sentences_matches_jax():
    sents = [["a", "b", "c"], ["b", "d"], ["e", "a"]]
    for kw in ({}, {"invalid_label": 0, "start_label": 0},
               {"vocab": {"a": 1, "b": 2, "c": 3, "d": 4, "e": 5, "\n": 0}}):
        assert tmx.rnn.encode_sentences(sents, **kw) == \
            jmx.rnn.encode_sentences(sents, **kw)
    with pytest.raises(ValueError):
        tmx.rnn.encode_sentences([["z"]], vocab={"a": 1})


# ------------------------------------------------------------------ ops
def test_creation_ops_match_jax():
    """``_zeros``/``_ones``/``_full`` with the 0 batch made 1 and broadcast
    by the op after it; ``zeros_like``/``ones_like``."""
    def build(mx):
        x = mx.sym.Variable("x")
        z = mx.sym.zeros((0, 4), name="z")
        o = mx.sym.ones((2, 0), name="o")
        f = mx.sym._full(shape=(3, 4), value=2.5, name="f")
        return mx.sym.Group([x + z, o, f * x, mx.sym.zeros_like(x) + 1,
                             mx.sym.ones_like(x) * x])

    js, ts = _both(build)
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    outs, grads = _check_both(js, ts, {"x": x})
    assert outs[1].shape == (2, 1) and (outs[1] == 1).all()


@pytest.mark.parametrize("squeeze", [False, True])
def test_slice_channel_concat_sum_match_jax(squeeze):
    def build(mx):
        x = mx.sym.Variable("x")
        parts = mx.sym.SliceChannel(x, num_outputs=3, axis=1, squeeze_axis=squeeze,
                                    name="s")
        cat = mx.sym.Concat(*[mx.sym.expand_dims(p, axis=1) if squeeze else p
                              for p in reversed(list(parts))], dim=1, name="c")
        return mx.sym.Group([cat, mx.sym.sum(x, axis=(0, 2)), mx.sym.split(
            x, num_outputs=2, axis=2)[1], mx.sym.SwapAxis(x, dim1=0, dim2=2),
            mx.sym.sum(x, axis=1, keepdims=True, exclude=True)])

    js, ts = _both(build)
    x = np.random.RandomState(1).randn(2, 3, 4).astype(np.float32)
    _check_both(js, ts, {"x": x})
    with pytest.raises(MXNetError):
        ts[0].infer_shape(x=(2, 4, 4))


# ------------------------------------------------------------ initializers
def test_rnn_initializers():
    """LSTMBias puts the forget bias in the second quarter; FusedRNN fills
    the packed vector block by block (weights by the global initializer,
    biases zero but LSTM's forget quarter of the i2h and h2h biases)."""
    from mxnet_tpu_torch.ops.rnn_ops import rnn_param_size

    arr = tmx.nd.zeros((4 * H,), ctx=tmx.cpu())
    tmx.init.LSTMBias(forget_bias=2.0)("c_i2h_bias", arr)
    a = arr.asnumpy()
    assert (a[H:2 * H] == 2.0).all() and (np.delete(a, np.s_[H:2 * H]) == 0).all()
    assert tmx.init.LSTMBias(1.5).dumps() == jmx.init.LSTMBias(1.5).dumps()

    cell = tmx.rnn.FusedRNNCell(H, num_layers=2, mode="lstm", prefix="q_")
    out, _ = cell.unroll(T, inputs=tmx.sym.Variable("data"), merge_outputs=True)
    psize = rnn_param_size(2, I, H, False, "lstm")
    vec = tmx.nd.zeros((psize,), ctx=tmx.cpu())
    attrs = out.attr_dict()["q_parameters"]
    glob = tmx.init.Xavier(rng=torch.Generator().manual_seed(0))
    glob(tmx.initializer.InitDesc("q_parameters", attrs), vec)
    blocks = _fused_to_unfused(vec.asnumpy(), 2, "lstm", "q_")
    for layer in range(2):
        b = blocks["q_l%d_i2h_bias" % layer]
        assert (b[H:2 * H] == 1.0).all() and (np.delete(b, np.s_[H:2 * H]) == 0).all()
        w = blocks["q_l%d_i2h_weight" % layer]
        bound = np.sqrt(3.0 / ((w.shape[0] + w.shape[1]) / 2.0))
        assert 0.5 * bound < np.abs(w).max() <= bound


# ------------------------------------------------------------- checkpoints
def test_rnn_checkpoint_round_trip_and_cross_package(tmp_path):
    """save_rnn_checkpoint writes the per-gate split, load_rnn_checkpoint
    packs it back; the JAX package reads the port's files."""
    stack = tmx.rnn.SequentialRNNCell()
    stack.add(tmx.rnn.LSTMCell(H, prefix="k_"))
    out, _ = stack.unroll(T, inputs=tmx.sym.Variable("data"), merge_outputs=True)
    shapes = dict(zip(out.list_arguments(), out.infer_shape(data=(N, T, I))[0]))
    rng = np.random.RandomState(9)
    args = {n: tmx.nd.array(rng.randn(*s).astype(np.float32), ctx=tmx.cpu())
            for n, s in shapes.items() if n != "data"}
    prefix = str(tmp_path / "rnn")
    tmx.rnn.do_rnn_checkpoint(stack, prefix, period=2)(1, out, args, {})
    _, saved, _ = jmx.model.load_checkpoint(prefix, 2)
    assert "k_i2h_f_weight" in saved and "k_i2h_weight" not in saved
    _, back, _ = tmx.rnn.load_rnn_checkpoint(stack, prefix, 2)
    assert sorted(back) == sorted(args)
    for n in args:
        np.testing.assert_array_equal(back[n].asnumpy(), args[n].asnumpy())


JLSTM = importlib.import_module("mxnet_tpu.models.lstm_lm")


@pytest.mark.parametrize("fused", [False, True])
def test_lstm_lm_symbol_matches_jax(fused):
    kw = dict(num_embed=8, num_hidden=6, num_layers=2, vocab_size=20, fused=fused)
    with jmx.name.NameManager():
        js = JLSTM.get_symbol(**kw)(7)[0]
    with tmx.name.NameManager():
        ts = tmx.models.lstm_lm(**kw)(7)[0]
    assert ts.tojson() == js.tojson()
    assert ts.infer_shape(data=(3, 7), softmax_label=(3, 7)) == \
        js.infer_shape(data=(3, 7), softmax_label=(3, 7))
