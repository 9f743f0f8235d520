"""Optimizer-state files, checkpoint callbacks and ``fit(auto_resume=...)``
of the port, on the CPU, held against the JAX package where files cross
between the packages and against the uninterrupted run where a job is cut
and resumed.

Pinned: a ``.states`` file written by either package, from either path
(classic Updater or fused step), loads into the other and the next update
is the same (1e-6 absolute: one float32 step from identical inputs);
states that do not fit raise; ``Module.load(load_optimizer_states=True)``;
``load_latest_valid_checkpoint`` skipping torn and corrupt files; the
``.resume`` sidecar bound to its params file by CRC and retired by an
epoch-boundary save; ``fit(auto_resume=...)`` under Adam at an epoch
boundary and mid-epoch equal to the uninterrupted run bit for bit (the
same float32 arithmetic in the same order on one device), on the fused
and the classic path; a warm start when the states are missing or
corrupt. The iterators do not shuffle, so the batch order does not depend
on the process's history.
"""
import logging
import os
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import model as tmodel
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.utils.atomic_file import read_verified

BATCH, DIM, CLASSES = 8, 6, 3


def _net(mx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=10, name="fc1")
    act = mx.sym.Activation(fc1, act_type="tanh")
    fc2 = mx.sym.FullyConnected(act, num_hidden=CLASSES, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def _xy(n=32, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, DIM).astype(np.float32),
            rng.randint(0, CLASSES, (n,)).astype(np.float32))


def _params(seed=3):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(10, DIM) * 0.4, "fc1_bias": rng.randn(10) * 0.1,
            "fc2_weight": rng.randn(CLASSES, 10) * 0.4,
            "fc2_bias": rng.randn(CLASSES) * 0.1}


OPTS = {"sgd": {"learning_rate": 0.1, "momentum": 0.9},
        "adam": {"learning_rate": 0.01}}


def _module(mx, params, opt, kvstore):
    ctx = mx.cpu()
    mod = mx.mod.Module(_net(mx), context=ctx)
    mod.bind([("data", (BATCH, DIM))], [("softmax_label", (BATCH,))])
    mod.init_params(arg_params={n: mx.nd.array(v.astype(np.float32), ctx=ctx)
                                for n, v in params.items()}, aux_params={})
    mod.init_optimizer(kvstore=kvstore, optimizer=opt,
                       optimizer_params=dict(OPTS[opt]))
    return mod


def _steps(mx, mod, n, seed=0):
    X, y = _xy(seed=seed)
    it = mx.io.NDArrayIter(X, y, batch_size=BATCH)
    for _, batch in zip(range(n), it):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
    return {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}


# (package, kvstore): 'local' on the CPU is the classic path, 'device'
# the fused one (eager here, a CUDA graph on the card)
PATHS = [("jax", "local"), ("jax", "device"), ("torch", "local"),
         ("torch", "device")]
PKG = {"jax": jmx, "torch": tmx}


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("writer", PATHS, ids=lambda p: "%s-%s" % p)
def test_states_file_crosses_packages_and_paths(tmp_path, opt, writer):
    """A .states file written after 3 steps on ``writer``'s path loads into
    each package's classic and fused paths, and one more step from it
    lands on the same parameters everywhere (1e-6)."""
    wmx = PKG[writer[0]]
    wmod = _module(wmx, _params(), opt, writer[1])
    assert (wmod._fused is not None) == (writer[1] == "device")
    trained = _steps(wmx, wmod, 3)
    fname = str(tmp_path / "w.states")
    wmod.save_optimizer_states(fname)
    raw = pickle.loads(read_verified(fname))
    assert sorted(raw) == [0, 1, 2, 3]      # enumerate(param_names)
    after = {}
    for pkg, kv in PATHS:
        mx = PKG[pkg]
        mod = _module(mx, trained, opt, kv)
        mod.load_optimizer_states(fname)
        after[(pkg, kv)] = _steps(mx, mod, 1, seed=1)
    fresh = _steps(tmx, _module(tmx, trained, opt, "local"), 1, seed=1)
    ref = after[writer]
    for path, got in after.items():
        for n in ref:
            np.testing.assert_allclose(got[n], ref[n], rtol=0, atol=1e-6,
                                       err_msg="%s %s" % (path, n))
    # the states mattered: fresh states land elsewhere
    assert any(np.abs(fresh[n] - ref[n]).max() > 1e-4 for n in ref)


def test_fused_and_classic_write_the_same_states():
    """The fused path's file is the classic Updater's, array for array."""
    files = {}
    for kv in ("device", "local"):
        mod = _module(tmx, _params(), "adam", kv)
        _steps(tmx, mod, 4)
        files[kv] = pickle.loads(mod._fused.get_states_bytes() if kv == "device"
                                 else mod._updater.get_states())
    assert sorted(files["device"]) == sorted(files["local"])
    for i, st in files["device"].items():
        for a, b in zip(st, files["local"][i]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kv", ["local", "device"])
def test_mismatched_states_raise(tmp_path, kv):
    other = tmx.mod.Module(tmx.models.transformer_lm(
        vocab_size=11, num_layers=1, model_dim=8, num_heads=2, ffn_dim=8,
        seq_len=4), context=tmx.cpu())
    other.bind([("data", (2, 4))], [("softmax_label", (2, 4))])
    other.init_params(tmx.init.One())
    other.init_optimizer(optimizer="sgd", optimizer_params={"momentum": 0.9})
    other.forward_backward(tmx.io.DataBatch([tmx.nd.ones((2, 4), ctx=tmx.cpu())],
                                            [tmx.nd.ones((2, 4), ctx=tmx.cpu())]))
    other.update()        # the classic Updater makes its states lazily
    fname = str(tmp_path / "other.states")
    other.save_optimizer_states(fname)
    mod = _module(tmx, _params(), "sgd", kv)
    with pytest.raises(MXNetError, match="do not match"):
        mod.load_optimizer_states(fname)
    with pytest.raises(MXNetError):
        tmx.mod.Module(_net(tmx), context=tmx.cpu()).save_optimizer_states(fname)


def test_module_load_with_optimizer_states(tmp_path):
    prefix = str(tmp_path / "ck")
    mod = _module(tmx, _params(), "adam", "local")
    _steps(tmx, mod, 2)
    mod.save_checkpoint(prefix, 3, save_optimizer_states=True)
    assert os.path.exists(prefix + "-0003.states")
    loaded = tmx.mod.Module.load(prefix, 3, load_optimizer_states=True,
                                 context=tmx.cpu())
    loaded.bind([("data", (BATCH, DIM))], [("softmax_label", (BATCH,))])
    loaded.init_optimizer(optimizer="adam", optimizer_params=OPTS["adam"])
    a = pickle.loads(loaded._updater.get_states())
    b = pickle.loads(mod._updater.get_states())
    for i in b:
        for x, y in zip(a[i], b[i]):
            np.testing.assert_array_equal(x, y)
    # the JAX package's Module.load reads the port's checkpoint and states
    jl = jmx.mod.Module.load(prefix, 3, load_optimizer_states=True,
                             context=jmx.cpu())
    jl.bind([("data", (BATCH, DIM))], [("softmax_label", (BATCH,))])
    jl.init_optimizer(optimizer="adam", optimizer_params=OPTS["adam"])


# ------------------------------------------------------- checkpoint scan
def _ck(prefix, epoch, value):
    tmodel.save_checkpoint(prefix, epoch, _net(tmx),
                           {"fc1_weight": tmx.nd.array(np.full((2, 2), value,
                                                               np.float32),
                                                       ctx=tmx.cpu())}, {})


def test_load_latest_valid_checkpoint_skips_torn_files(tmp_path):
    prefix = str(tmp_path / "ck")
    for epoch in (1, 2, 3, 4):
        _ck(prefix, epoch, float(epoch))
    p4 = "%s-0004.params" % prefix
    raw = bytearray(open(p4, "rb").read())
    raw[50] ^= 0xFF                               # the CRC catches it
    open(p4, "wb").write(bytes(raw))
    p3 = "%s-0003.params" % prefix
    raw3 = open(p3, "rb").read()
    open(p3, "wb").write(raw3[:len(raw3) // 3])   # a torn write
    sym, arg, aux, epoch = tmodel.load_latest_valid_checkpoint(prefix)
    assert epoch == 2 and sym is not None
    assert np.allclose(arg["fc1_weight"].asnumpy(), 2.0)
    # the JAX package picks the same epoch from the same files
    assert jmx.model.load_latest_valid_checkpoint(prefix)[3] == 2
    assert tmodel.load_latest_valid_checkpoint(str(tmp_path / "none")) is None
    tmx.nd.save("%s-0009.params" % prefix, {"w": tmx.nd.ones((2,), ctx=tmx.cpu())})
    os.rename("%s-0001.params" % prefix, "%s-7.params" % prefix)
    os.remove("%s-symbol.json" % prefix)
    sym, arg, _, epoch = tmodel.load_latest_valid_checkpoint(prefix)
    assert sym is None and epoch == 7 and np.allclose(arg["fc1_weight"].asnumpy(), 1.0)


def test_resume_sidecar_format_crc_and_retirement(tmp_path):
    prefix = str(tmp_path / "ck")
    _ck(prefix, 1, 1.0)
    rng_state = np.random.RandomState(5).get_state()
    tmodel.save_resume_state(prefix, 1, 3, iter_state={"cursor": 8},
                             numpy_rng=rng_state,
                             optimizer_counts={"num_update": 7, "begin_num_update": 0,
                                               "index_update_count": {0: 7, "w": 7}})
    rec = tmodel.load_resume_state(prefix, 1)
    assert rec["nbatch"] == 3 and rec["iter_state"] == {"cursor": 8}
    assert rec == jmx.model.load_resume_state(prefix, 1)   # the JAX package reads it
    dec = tmodel.decode_rng(rec["numpy_rng"])
    np.testing.assert_array_equal(dec[1], rng_state[1])
    mod = _module(tmx, _params(), "adam", "local")
    tmodel.restore_optimizer_counts(mod, rec["optimizer_counts"])
    assert mod._optimizer.num_update == 7
    assert mod._optimizer._index_update_count == {0: 7, "w": 7}
    _ck(prefix, 1, 2.0)                       # an epoch-boundary save retires it
    assert tmodel.load_resume_state(prefix, 1) is None
    _ck(prefix, 2, 2.0)
    tmodel.save_resume_state(prefix, 2, 1)
    raw = bytearray(open("%s-0002.params" % prefix, "rb").read())
    jmx.nd.save("%s-0002.params" % prefix,     # another write of the file
                {"arg:fc1_weight": jmx.nd.zeros((2, 2))})
    assert tmodel.load_resume_state(prefix, 2) is None
    assert raw != open("%s-0002.params" % prefix, "rb").read()
    with open("%s-0002.resume" % prefix, "w") as f:
        f.write("{not json")
    assert tmodel.load_resume_state(prefix, 2) is None


def test_checkpoint_callbacks(tmp_path):
    prefix = str(tmp_path / "cb")
    mod = _module(tmx, _params(), "sgd", "local")
    _steps(tmx, mod, 1)
    arg, aux = mod.get_params()
    tmx.callback.do_checkpoint(prefix, period=2)(0, mod.symbol, arg, aux)
    assert not os.path.exists(prefix + "-0001.params")
    tmx.callback.do_checkpoint(prefix, period=2)(1, mod.symbol, arg, aux)
    assert os.path.exists(prefix + "-0002.params")
    tmx.callback.module_checkpoint(mod, prefix, save_optimizer_states=True)(2)
    assert os.path.exists(prefix + "-0003.params") and os.path.exists(prefix + "-0003.states")
    rec = tmodel.load_resume_state(prefix, 3)
    assert rec["nbatch"] == 0 and rec["optimizer_counts"]["num_update"] == 1
    _, jarg, _ = jmx.model.load_checkpoint(prefix, 3)
    np.testing.assert_array_equal(jarg["fc1_weight"].asnumpy(),
                                  arg["fc1_weight"].asnumpy())


# ------------------------------------------------------------- resume
TLM = dict(vocab_size=23, num_layers=2, model_dim=32, num_heads=2, ffn_dim=48,
           seq_len=16)


def _lm_iter():
    rng = np.random.RandomState(1)
    X = (rng.randint(0, 23, (16, 1)) + np.arange(16)) % 23
    return tmx.io.NDArrayIter(X.astype(np.float32), ((X + 1) % 23).astype(np.float32),
                              batch_size=4, shuffle=False)


class _Cut(Exception):
    pass


def _lm_fit(kvstore, num_epoch, mod=None, **kw):
    mod = mod or tmx.mod.Module(tmx.models.transformer_lm(**TLM), context=tmx.cpu())
    mod.fit(_lm_iter(), num_epoch=num_epoch, kvstore=kvstore, optimizer="adam",
            optimizer_params={"learning_rate": 3e-3},
            initializer=tmx.init.Xavier(rng=torch.Generator().manual_seed(0)),
            eval_metric="ce", **kw)
    return mod


def _lm_args(mod):
    return {n: a.asnumpy() for n, a in mod.get_params()[0].items()}


@pytest.mark.parametrize("kvstore", ["device", "local"], ids=["fused", "classic"])
def test_auto_resume_matches_uninterrupted_run(tmp_path, kvstore):
    """The Transformer-LM under Adam, 4 epochs of 4 batches: uninterrupted;
    cut after 2 epochs (module_checkpoint with optimizer states) and
    resumed with auto_resume; cut mid-epoch 2 after 2 batches (a
    checkpoint and a .resume sidecar written by a batch-end callback, then
    the job dies) and resumed. Both resumed runs equal the uninterrupted
    one bit for bit, the Adam update count included."""
    full = _lm_fit(kvstore, 4)
    ref = _lm_args(full)
    assert full._optimizer.num_update == 16

    prefix = str(tmp_path / "lm")
    cut = tmx.mod.Module(tmx.models.transformer_lm(**TLM), context=tmx.cpu())
    _lm_fit(kvstore, 2, mod=cut, epoch_end_callback=tmx.callback.module_checkpoint(
        cut, prefix, save_optimizer_states=True))
    assert os.path.exists(prefix + "-0002.states")
    seen = []
    resumed = tmx.mod.Module(tmx.models.transformer_lm(**TLM), context=tmx.cpu())
    resumed.fit(_lm_iter(), num_epoch=4, kvstore=kvstore, optimizer="adam",
                optimizer_params={"learning_rate": 3e-3}, eval_metric="ce",
                auto_resume=prefix,
                batch_end_callback=lambda p: seen.append((p.epoch, p.nbatch)))
    assert seen[0] == (2, 0) and len(seen) == 8
    assert resumed._optimizer.num_update == 16
    got = _lm_args(resumed)
    for n in ref:
        np.testing.assert_array_equal(got[n], ref[n], err_msg=n)

    prefix2 = str(tmp_path / "mid")
    holder = {}

    def cut_mid(param):
        if (param.epoch, param.nbatch) == (2, 1):
            mod = holder["mod"]
            mod.save_checkpoint(prefix2, 2, save_optimizer_states=True)
            tmodel.save_resume_state(prefix2, 2, param.nbatch + 1,
                                     numpy_rng=np.random.get_state(),
                                     optimizer_counts=tmodel.optimizer_counts(mod))
            raise _Cut()

    holder["mod"] = tmx.mod.Module(tmx.models.transformer_lm(**TLM), context=tmx.cpu())
    with pytest.raises(_Cut):
        _lm_fit(kvstore, 4, mod=holder["mod"], batch_end_callback=cut_mid)
    seen = []
    mid = tmx.mod.Module(tmx.models.transformer_lm(**TLM), context=tmx.cpu())
    mid.fit(_lm_iter(), num_epoch=4, kvstore=kvstore, optimizer="adam",
            optimizer_params={"learning_rate": 3e-3}, eval_metric="ce",
            auto_resume=prefix2,
            batch_end_callback=lambda p: seen.append((p.epoch, p.nbatch)))
    assert seen[0] == (2, 2) and len(seen) == 6
    got = _lm_args(mid)
    for n in ref:
        np.testing.assert_array_equal(got[n], ref[n], err_msg=n)


def test_auto_resume_warm_start_and_fresh_start(tmp_path, caplog):
    """No checkpoint: trains from scratch. A checkpoint without .states, or
    with a corrupt one: the parameters resume, the optimizer starts fresh,
    with a warning."""
    X, y = _xy()
    prefix = str(tmp_path / "ws")
    seen = []
    mod = tmx.mod.Module(_net(tmx), context=tmx.cpu())
    mod.fit(tmx.io.NDArrayIter(X, y, batch_size=BATCH), num_epoch=1,
            optimizer="sgd", optimizer_params=OPTS["sgd"], auto_resume=prefix,
            epoch_end_callback=tmx.callback.do_checkpoint(prefix),
            batch_end_callback=lambda p: seen.append(p.epoch))
    assert set(seen) == {0} and os.path.exists(prefix + "-0001.params")
    ck = _lm_args(mod)
    mod2 = tmx.mod.Module(_net(tmx), context=tmx.cpu())
    with caplog.at_level(logging.WARNING):
        mod2.fit(tmx.io.NDArrayIter(X, y, batch_size=BATCH), num_epoch=1,
                 optimizer="sgd", optimizer_params=OPTS["sgd"], auto_resume=prefix)
    assert "warm start" in caplog.text
    for n, v in _lm_args(mod2).items():
        np.testing.assert_array_equal(v, ck[n])    # zero epochs ran
    mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    states = prefix + "-0001.states"
    raw = bytearray(open(states, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    open(states, "wb").write(bytes(raw))
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        tmx.mod.Module(_net(tmx), context=tmx.cpu()).fit(
            tmx.io.NDArrayIter(X, y, batch_size=BATCH), num_epoch=2,
            optimizer="sgd", optimizer_params=OPTS["sgd"], auto_resume=prefix)
    assert "unloadable optimizer states" in caplog.text


def test_jax_resumes_from_port_checkpoint(tmp_path):
    """The JAX package's fit(auto_resume=...) continues from the port's
    checkpoint and states (classic path, SGD-momentum)."""
    X, y = _xy()
    prefix = str(tmp_path / "x")
    mod = tmx.mod.Module(_net(tmx), context=tmx.cpu())
    mod.fit(tmx.io.NDArrayIter(X, y, batch_size=BATCH), num_epoch=1,
            optimizer="sgd", optimizer_params=OPTS["sgd"],
            epoch_end_callback=tmx.callback.module_checkpoint(
                mod, prefix, save_optimizer_states=True))
    seen = []
    jm = jmx.mod.Module(_net(jmx), context=jmx.cpu())
    jm.fit(jmx.io.NDArrayIter(X, y, batch_size=BATCH), num_epoch=2,
           optimizer="sgd", optimizer_params=OPTS["sgd"], auto_resume=prefix,
           batch_end_callback=lambda p: seen.append(p.epoch))
    assert set(seen) == {1}
