"""The port's predict API (``mxnet_tpu_torch/predict.py``) against the JAX
package's (``mxnet_tpu/predict.py``) on the CPU.

Two checkpoints, each written once by the JAX package's
``Module.save_checkpoint``: a small Transformer-LM (2 layers, width 32; its
attention is the flash op, whose port wrapper takes its plain version on
CPU tensors) and the ``fc1/relu/fc2/softmax`` net of
``tests/test_c_predict.py``. Both packages' ``Predictor`` read the same
files and get the same numpy inputs; outputs agree to rtol 1e-5. Also the
partial-output and ``reshape`` paths, the byte-oriented ``_c_*`` helpers
the C shim calls, unprefixed ``.params`` keys, and the default context
(C14: the card, never a silent CPU).
"""
import importlib
import io

import numpy as np
import pytest

import mxnet_tpu as J
import mxnet_tpu_torch as T
from mxnet_tpu import predict as jpred
from mxnet_tpu_torch import predict as tpred
from mxnet_tpu_torch.base import MXNetError

RTOL = 1e-5
ATOL = 1e-6
LM = dict(vocab_size=64, num_layers=2, model_dim=32, num_heads=2, ffn_dim=64,
          seq_len=16)
BATCH = 3


def _mlp_symbol():
    net = J.sym.FullyConnected(J.sym.Variable("data"), num_hidden=4,
                               name="fc1")
    net = J.sym.Activation(net, act_type="relu")
    net = J.sym.FullyConnected(net, num_hidden=2, name="fc2")
    return J.sym.SoftmaxOutput(net, name="softmax")


def _save(tmp, name, net, data_shape, label_shape, seed):
    """The JAX package's Module.save_checkpoint of ``net`` with seeded
    parameters; returns (symbol JSON, params bytes)."""
    mod = J.mod.Module(net, context=J.cpu())
    mod.bind(data_shapes=[("data", data_shape)],
             label_shapes=[("softmax_label", label_shape)])
    mod.init_params(J.init.Xavier())
    rng = np.random.RandomState(seed)
    args = {k: J.nd.array(rng.uniform(-0.5, 0.5, v.shape).astype(np.float32))
            for k, v in mod.get_params()[0].items()}
    mod.set_params(args, {})
    prefix = str(tmp / name)
    mod.save_checkpoint(prefix, 1)
    with open(prefix + "-symbol.json") as f, \
            open(prefix + "-0001.params", "rb") as g:
        return f.read(), g.read()


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("predict")
    tl = importlib.import_module("mxnet_tpu.models.transformer_lm")
    T_ = LM["seq_len"]
    rng = np.random.RandomState(0)
    return {
        "lm": dict(
            ckpt=_save(tmp, "lm", tl.get_symbol(**LM), (BATCH, T_),
                       (BATCH, T_), 1),
            # the label goes through a Reshape: its shape is given
            shapes={"data": (BATCH, T_), "softmax_label": (BATCH, T_)},
            x=rng.randint(0, LM["vocab_size"], (BATCH, T_)).astype(np.float32),
            internal="lm_head_output", batch2=5),
        "mlp": dict(
            ckpt=_save(tmp, "mlp", _mlp_symbol(), (BATCH, 8), (BATCH,), 2),
            shapes={"data": (BATCH, 8)},
            x=rng.randn(BATCH, 8).astype(np.float32),
            internal="fc1_output", batch2=7),
    }


def _pair(m, **kw):
    sym_json, params = m["ckpt"]
    shapes = kw.pop("shapes", m["shapes"])
    return (jpred.Predictor(sym_json, params, input_shapes=shapes, **kw),
            tpred.Predictor(sym_json, params, ctx=T.cpu(), input_shapes=shapes,
                            **kw))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["lm", "mlp"])
def test_predictor_matches_jax(models, name):
    m = models[name]
    jp, tp = _pair(m)
    assert tp.num_outputs == jp.num_outputs == 1
    want = jp.forward(data=m["x"]).get_output(0)
    got = tp.forward(data=m["x"]).get_output(0)
    assert got.shape == want.shape
    _close(got, want)
    # a second input through set_input replaces the first
    x2 = m["x"][::-1].copy()
    jp.set_input("data", x2)
    tp.set_input("data", x2)
    _close(tp.forward().get_output(0), jp.forward().get_output(0))


@pytest.mark.parametrize("name", ["lm", "mlp"])
def test_partial_out_and_reshape_match_jax(models, name):
    m = models[name]
    jp, tp = _pair(m, output_names=[m["internal"]])
    assert tp.symbol.list_outputs() == jp.symbol.list_outputs() == [
        m["internal"]]
    _close(tp.forward(data=m["x"]).get_output(0),
           jp.forward(data=m["x"]).get_output(0))
    # reshape rebinds at a new batch and keeps the parameters
    jp, tp = _pair(m)
    b2 = m["batch2"]
    new = {k: (b2,) + tuple(v[1:]) for k, v in m["shapes"].items()}
    x = np.concatenate([m["x"]] * 3)[:b2]
    want = jp.reshape(new).forward(data=x).get_output(0)
    got = tp.reshape(new).forward(data=x).get_output(0)
    assert got.shape == want.shape and got.shape[0] != m["x"].shape[0]
    _close(got, want)


@pytest.mark.parametrize("name", ["lm", "mlp"])
def test_c_helpers_match_jax(models, name):
    """The byte-oriented helpers of the C shim: create, output shape before
    the first forward, flat input, forward, output bytes."""
    m = models[name]
    sym_json, params = m["ckpt"]
    names = list(m["shapes"])
    shapes = [list(s) for s in m["shapes"].values()]
    jp = jpred._c_create(sym_json, params, names, shapes)
    with T.cpu():
        tp = tpred._c_create(sym_json, params, names, shapes)
    assert tp.ctx == T.cpu()
    # MXPredGetOutputShape works before the first forward
    assert tpred._c_output_shape(tp, 0) == jpred._c_output_shape(jp, 0)
    blob = m["x"].tobytes()
    for mod, p in ((jpred, jp), (tpred, tp)):
        mod._c_set_input_flat(p, "data", blob)
        mod._c_forward(p)
    assert tpred._c_output_shape(tp, 0) == list(tp.get_output(0).shape)
    got = np.frombuffer(tpred._c_get_output(tp, 0), np.float32)
    want = np.frombuffer(jpred._c_get_output(jp, 0), np.float32)
    _close(got, want)
    with pytest.raises(MXNetError, match="unknown input"):
        tpred._c_set_input_flat(tp, "no_such_input", blob)
    # what the shim calls: the caller's buffers read and written in place
    x = np.ascontiguousarray(m["x"][::-1])
    tpred._c_set_input_ptr(tp, "data", x.ctypes.data, x.size)
    tpred._c_forward(tp)
    into = np.full(got.size, np.nan, np.float32)
    tpred._c_get_output_into(tp, 0, into.ctypes.data, into.size)
    tpred._c_set_input_flat(tp, "data", x.tobytes())
    tpred._c_forward(tp)
    np.testing.assert_array_equal(
        into, np.frombuffer(tpred._c_get_output(tp, 0), np.float32))
    with pytest.raises(MXNetError, match="got %d floats" % (x.size - 1)):
        tpred._c_set_input_ptr(tp, "data", x.ctypes.data, x.size - 1)
    with pytest.raises(MXNetError, match="output size mismatch"):
        tpred._c_get_output_into(tp, 0, into.ctypes.data, into.size - 1)


def test_ndlist_matches_jax(models):
    """MXNDListCreate's helper: the same names, shapes and float32 bytes."""
    params = models["lm"]["ckpt"][1]
    jn, jb, js = jpred._c_ndlist(params)
    tn, tb, ts = tpred._c_ndlist(params)
    assert tn == jn and ts == js and tb == jb


def test_unprefixed_params_match_prefixed(models, tmp_path):
    """A dict saved without ``arg:``/``aux:`` (Module-style params load)
    predicts as the prefixed checkpoint does, in both packages."""
    m = models["mlp"]
    sym_json, params = m["ckpt"]
    loaded = J.nd.load(io.BytesIO(params))
    path = str(tmp_path / "plain.params")
    J.nd.save(path, {k.split(":", 1)[1]: v for k, v in loaded.items()})
    with open(path, "rb") as f:
        plain = f.read()
    want = jpred.Predictor(sym_json, params, input_shapes=m["shapes"]).forward(
        data=m["x"]).get_output(0)
    for blob in (plain, params):
        got = tpred.Predictor(sym_json, blob, ctx=T.cpu(),
                              input_shapes=m["shapes"]).forward(
            data=m["x"]).get_output(0)
        _close(got, want)
    jgot = jpred.Predictor(sym_json, plain, input_shapes=m["shapes"]).forward(
        data=m["x"]).get_output(0)
    _close(jgot, want)


@pytest.mark.parametrize("name", ["lm", "mlp"])
def test_params_read_by_the_port_write_back_byte_for_byte(models, name,
                                                          tmp_path):
    """``load_ndarray_file`` (MXNDListCreate's reader) and the port's
    ``nd.save`` give back the JAX package's checkpoint bytes."""
    params = models[name]["ckpt"][1]
    d = tpred.load_ndarray_file(params)
    assert sorted(d) == sorted(jpred.load_ndarray_file(params))
    path = str(tmp_path / "again.params")
    T.nd.save(path, d)
    with open(path, "rb") as f:
        assert f.read() == params


def test_default_context_is_the_card(models, monkeypatch):
    """C14: with no context the Predictor binds on the current context: the
    card, which raises without CUDA; ``with mx.cpu():`` and
    ``MXNET_DEFAULT_CONTEXT=cpu`` put it on the CPU."""
    m = models["mlp"]
    sym_json, params = m["ckpt"]
    monkeypatch.delenv("MXNET_DEFAULT_CONTEXT", raising=False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        tpred.Predictor(sym_json, params, input_shapes=m["shapes"])
    with T.cpu():
        p = tpred.Predictor(sym_json, params, input_shapes=m["shapes"])
    assert p.ctx == T.cpu()
    assert p._exe.arg_dict["data"].context.type == "cpu"
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    assert tpred.Predictor(sym_json, params,
                           input_shapes=m["shapes"]).ctx == T.cpu()


def test_missing_shapes_raise_as_jax(models):
    m = models["lm"]
    sym_json, params = m["ckpt"]
    shapes = {"data": m["shapes"]["data"]}
    for mod, kw in ((jpred, {}), (tpred, {"ctx": T.cpu()})):
        with pytest.raises(Exception, match="missing input shapes"):
            mod.Predictor(sym_json, params, input_shapes=shapes, **kw)
        with pytest.raises(Exception, match="input_shapes required"):
            mod.Predictor(sym_json, params, **kw)
