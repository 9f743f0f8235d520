"""The port's BucketingModule and shared binding on one CPU context,
mirroring the JAX package's ``tests/test_module_fused.py`` bucketing tests
(one context here) and held against the JAX package.

``kvstore='device'`` on ``cpu()`` runs the fused step (eagerly; on a card
each bucket's step is a CUDA graph over the same shared tensors). Pinned:
every bucket fused over one shared state whose tensors are never
replaced; fused equal to classic within 1e-4 for SGD-momentum and Adam
(one update count across buckets); ``save_params`` seeing the fused
updates; ``bind(shared_module=...)`` binding the lender's arrays;
``reshape`` keeping the parameters; the bucketed fit against the JAX
package's from identical parameters (toy net and the LSTM LM, fused and
unfused). Tolerances are stated per test.
"""
import importlib
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

BATCH, DIM, CLASSES = 8, 5, 4


def _bucket_sym_gen(mx):
    def sym_gen(bucket_key):
        data = mx.sym.Variable("data")              # (B, seq_len, DIM)
        pooled = mx.sym.sum(data, axis=1)           # params identical per bucket
        fc1 = mx.sym.FullyConnected(pooled, num_hidden=16, name="bfc1")
        act = mx.sym.Activation(fc1, act_type="relu")
        fc2 = mx.sym.FullyConnected(act, num_hidden=CLASSES, name="bfc2")
        return (mx.sym.SoftmaxOutput(fc2, name="softmax"), ("data",),
                ("softmax_label",))
    return sym_gen


def _bucket_batches(mx, n_batches=6, seed=0):
    rng = np.random.RandomState(seed)
    ctx = mx.cpu()
    batches = []
    for i in range(n_batches):
        seq = 3 if i % 2 else 5
        X = rng.rand(BATCH, seq, DIM).astype(np.float32)
        y = rng.randint(0, CLASSES, (BATCH,)).astype(np.float32)
        batches.append(mx.io.DataBatch(
            [mx.nd.array(X, ctx=ctx)], [mx.nd.array(y, ctx=ctx)], pad=0,
            bucket_key=seq,
            provide_data=[mx.io.DataDesc("data", (BATCH, seq, DIM))],
            provide_label=[mx.io.DataDesc("softmax_label", (BATCH,))]))
    return batches


SGD = ("sgd", {"learning_rate": 0.2, "momentum": 0.9})
ADAM = ("adam", {"learning_rate": 0.05})


def _run_bucketed(mx=tmx, n_epochs=2, opt=SGD, kvstore="device"):
    bmod = mx.mod.BucketingModule(_bucket_sym_gen(mx), default_bucket_key=5,
                                  context=mx.cpu())
    bmod.bind([("data", (BATCH, 5, DIM))], [("softmax_label", (BATCH,))])
    bmod.init_params(mx.init.One())
    bmod.init_optimizer(kvstore=kvstore, optimizer=opt[0],
                        optimizer_params=dict(opt[1]))
    for _ in range(n_epochs):
        for batch in _bucket_batches(mx):
            bmod.forward(batch, is_train=True)
            bmod.backward()
            bmod.update()
    dirty = any(m._fused is not None and m._fused.state.device_dirty
                for m in bmod._buckets.values())
    args, _ = bmod.get_params()
    return bmod, {k: v.asnumpy().copy() for k, v in args.items()}, dirty


def test_bucketing_every_bucket_runs_fused():
    bmod, _, was_dirty = _run_bucketed()
    mods = list(bmod._buckets.values())
    assert len(mods) == 2, "two bucket keys -> two bucket modules"
    assert all(m._fused is not None for m in mods)
    assert len({id(m._fused.state) for m in mods}) == 1, "one shared state"
    assert len({id(m._fused.trainer) for m in mods}) == 2, "a trainer per bucket"
    assert was_dirty
    st = mods[0]._fused.state
    n_params = len(mods[0]._param_names)
    assert len({t.data_ptr() for t in st.params.values()}) == n_params
    # one optimizer, one updater, shared by every bucket
    assert len({id(m._optimizer) for m in mods}) == 1
    assert len({id(m._updater) for m in mods}) == 1
    # fit's epoch-end get_params -> set_params of the same dicts keeps the
    # shared state on the device (no re-upload before the next step)
    bmod.set_params(*bmod.get_params())
    assert st.fresh
    # each bucket's parameter NDArrays are the default bucket's
    default = bmod._buckets[5]._exec_group.execs[0].arg_dict
    other = bmod._buckets[3]._exec_group.execs[0].arg_dict
    assert all(other[n] is default[n] for n in mods[0]._param_names)


@pytest.mark.parametrize("opt", [SGD, ADAM], ids=["sgd", "adam"])
def test_bucketing_fused_matches_classic(opt, monkeypatch):
    """Same arithmetic in the same order on the same device, Adam's bias
    correction from the one shared update count: within 1e-4 (it is bit
    for bit here)."""
    _, args_fused, _ = _run_bucketed(opt=opt)
    monkeypatch.setenv("MXNET_MODULE_NO_FUSED", "1")
    bmod, args_classic, _ = _run_bucketed(opt=opt)
    assert all(m._fused is None for m in bmod._buckets.values())
    assert set(args_fused) == set(args_classic)
    for k in args_fused:
        np.testing.assert_allclose(args_fused[k], args_classic[k], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    if opt is ADAM:
        # 12 steps, each counted once per parameter
        assert bmod._buckets[5]._optimizer.num_update == 12


def test_bucketing_fused_save_params_roundtrip(tmp_path):
    """save_params through the wrapper sees the fused updates."""
    bmod, args_before, _ = _run_bucketed(n_epochs=1)
    fname = str(tmp_path / "bucket.params")
    bmod.save_params(fname)
    loaded = tmx.nd.load(fname)
    for k, v in args_before.items():
        np.testing.assert_array_equal(loaded["arg:" + k].asnumpy(), v, err_msg=k)
    # and the JAX package reads the file
    jl = jmx.nd.load(fname)
    for k, v in args_before.items():
        np.testing.assert_array_equal(jl["arg:" + k].asnumpy(), v, err_msg=k)


def test_shared_state_is_written_in_place():
    """A captured graph replays on the addresses it captured: set_params
    and optimizer states from a file must copy into the shared tensors,
    never replace them."""
    bmod, args, _ = _run_bucketed(n_epochs=1)
    st = bmod._buckets[5]._fused.state
    ptrs = {n: t.data_ptr() for n, t in st.params.items()}
    slot_ptrs = {n: [s.data_ptr() for s in slots] for n, slots in st.states.items()}
    new = {k: tmx.nd.array(v * 0 + 0.5, ctx=tmx.cpu()) for k, v in args.items()}
    bmod.set_params(new, {})
    states = bmod._buckets[3]._fused.get_states_bytes()
    for batch in _bucket_batches(tmx, 2):
        bmod.forward(batch, is_train=True)
        bmod.update()
    bmod._buckets[3]._fused.set_states_bytes(states)
    assert {n: t.data_ptr() for n, t in st.params.items()} == ptrs
    assert {n: [s.data_ptr() for s in slots]
            for n, slots in st.states.items()} == slot_ptrs
    got = bmod.get_params()[0]
    assert not np.allclose(got["bfc1_weight"].asnumpy(), 0.5)   # trained from 0.5


def test_set_params_reaches_every_bucket():
    """set_params through the current bucket: the next fused step of
    another bucket starts from the new values (every bucket reads the
    same host dicts when it refreshes the shared state)."""
    bmod, args, _ = _run_bucketed(n_epochs=1)
    assert bmod._curr_bucket_key == 3
    bmod.set_params({k: tmx.nd.array(v * 0 + 0.5, ctx=tmx.cpu())
                     for k, v in args.items()}, {})
    b5 = next(b for b in _bucket_batches(tmx) if b.bucket_key == 5)
    bmod.forward(b5, is_train=True)
    st = bmod._buckets[5]._fused.state
    assert bmod._buckets[5]._arg_params is bmod._buckets[3]._arg_params
    assert (st.params["bfc1_weight"].numpy() == 0.5).all()


def test_bucketing_fit_matches_jax():
    """The toy net bucketed in both packages from the same parameters
    (One), SGD-momentum, fused: 1e-5 absolute (float32 summation order)."""
    _, t_args, _ = _run_bucketed(tmx)
    _, j_args, _ = _run_bucketed(jmx)
    for k in t_args:
        np.testing.assert_allclose(t_args[k], j_args[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_module_bind_shared_module_and_reshape():
    """A module bound with shared_module uses the lender's NDArrays, host
    dicts and optimizer; reshape rebinds over the same arrays (the JAX
    package's reshape leaves the new executor's parameters at zero,
    ROADMAP C)."""
    sym_gen = _bucket_sym_gen(tmx)
    lender = tmx.mod.Module(sym_gen(5)[0], context=tmx.cpu())
    lender.bind([("data", (BATCH, 5, DIM))], [("softmax_label", (BATCH,))])
    lender.init_params(tmx.init.One())
    lender.init_optimizer(optimizer="sgd")
    mod = tmx.mod.Module(sym_gen(3)[0], context=tmx.cpu())
    mod.bind([("data", (BATCH, 3, DIM))], [("softmax_label", (BATCH,))],
             shared_module=lender)
    assert mod.params_initialized and mod.optimizer_initialized
    assert mod._arg_params is lender._arg_params
    assert mod._optimizer is lender._optimizer and mod._updater is lender._updater
    la = lender._exec_group.execs[0].arg_dict
    ma = mod._exec_group.execs[0].arg_dict
    assert ma["bfc1_weight"] is la["bfc1_weight"]
    assert ma["data"] is not la["data"]
    lender.reshape([("data", (2, 5, DIM))], [("softmax_label", (2,))])
    exe = lender._exec_group.execs[0]
    assert exe.arg_dict["data"].shape == (2, 5, DIM)
    assert (exe.arg_dict["bfc1_weight"].asnumpy() == 1).all()
    assert exe.arg_dict["bfc1_weight"] is la["bfc1_weight"]
    with pytest.raises(MXNetError):
        tmx.mod.Module(sym_gen(5)[0], context=tmx.cpu()).bind(
            [("data", (BATCH, 5, DIM))], shared_module=tmx.mod.Module(
                sym_gen(5)[0], context=tmx.cpu()))
    with pytest.raises(MXNetError, match="A7"):
        lender.install_monitor(object())


def test_reshape_on_fused_path_keeps_training():
    """reshape on the fused path: a trainer for the new shapes over the
    same device state."""
    sym = _bucket_sym_gen(tmx)(5)[0]
    mod = tmx.mod.Module(sym, context=tmx.cpu())
    mod.bind([("data", (BATCH, 5, DIM))], [("softmax_label", (BATCH,))])
    mod.init_params(tmx.init.One())
    mod.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    b = _bucket_batches(tmx, 1)[0]
    mod.forward(b, is_train=True)
    mod.update()
    state = mod._fused.state
    mod.reshape([("data", (BATCH, 3, DIM))], [("softmax_label", (BATCH,))])
    assert mod._fused is not None and mod._fused.state is state
    b3 = _bucket_batches(tmx, 2)[1]
    mod.forward(b3, is_train=True)
    assert mod._fused.pending
    mod.update()
    assert np.isfinite(mod.get_params()[0]["bfc2_weight"].asnumpy()).all()


# ------------------------------------------------------- the LSTM LM
JLSTM = importlib.import_module("mxnet_tpu.models.lstm_lm")
LSTM = dict(num_embed=8, num_hidden=6, num_layers=2, vocab_size=20)
BUCKETS = [5, 10]


def _sentences(n=48, seed=0, V=LSTM["vocab_size"]):
    """examples/train_lm.py's structure: each token the previous + 1, ids
    2..V-1 so that 0 stays the pad."""
    rng = np.random.RandomState(seed)
    return [list(2 + (rng.randint(0, V - 2) + np.arange(rng.randint(3, 11)))
                 % (V - 2)) for _ in range(n)]


def _lstm_params(fused):
    with tmx.name.NameManager():
        sym = tmx.models.lstm_lm(fused=fused, **LSTM)(max(BUCKETS))[0]
    shapes = sym.infer_shape(data=(4, max(BUCKETS)),
                             softmax_label=(4, max(BUCKETS)))[0]
    rng = np.random.RandomState(4)
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _fit_lstm(mx, sym_gen, params, kvstore, num_epoch=2):
    np.random.seed(21)
    it = mx.rnn.BucketSentenceIter(_sentences(), 4, buckets=BUCKETS, invalid_label=0)
    mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=it.default_bucket_key,
                                 context=mx.cpu())
    metric = mx.metric.Perplexity(ignore_label=0)
    mod.fit(it, num_epoch=num_epoch, kvstore=kvstore, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
            arg_params={n: mx.nd.array(v, ctx=mx.cpu()) for n, v in params.items()},
            eval_metric=metric)
    args = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
    return mod, args, metric.get()[1]


@pytest.mark.parametrize("fused_rnn", [False, True], ids=["cells", "rnn_op"])
def test_bucketed_lstm_lm_fit_matches_jax(fused_rnn):
    """The LSTM LM (unrolled LSTMCells, or the fused RNN op) through
    BucketingModule.fit, 2 epochs of BucketSentenceIter batches in two
    buckets, from the same parameters in both packages, the port's fused
    step against the JAX package's: parameters within 1e-4 absolute
    (float32 summation order through the recurrence, 20 steps), the
    perplexity within 1e-4 relative. The port's classic path lands on its
    fused one within 1e-4 too."""
    with jmx.name.NameManager():
        jgen = JLSTM.get_symbol(fused=fused_rnn, **LSTM)
    with tmx.name.NameManager():
        tgen = tmx.models.lstm_lm(fused=fused_rnn, **LSTM)
    params = _lstm_params(fused_rnn)
    tmod, targs, tppl = _fit_lstm(tmx, tgen, params, "device")
    assert all(m._fused is not None for m in tmod._buckets.values())
    assert sorted(tmod._buckets) == BUCKETS
    _, jargs, jppl = _fit_lstm(jmx, jgen, params, "device")
    assert np.isfinite(tppl) and abs(tppl - jppl) <= 1e-4 * jppl, (tppl, jppl)
    for n in params:
        np.testing.assert_allclose(targs[n], jargs[n], rtol=0, atol=1e-4, err_msg=n)
        assert not np.array_equal(targs[n], params[n]), n
    os.environ["MXNET_MODULE_NO_FUSED"] = "1"
    try:
        cmod, cargs, _ = _fit_lstm(tmx, tgen, params, "device")
    finally:
        del os.environ["MXNET_MODULE_NO_FUSED"]
    assert all(m._fused is None for m in cmod._buckets.values())
    for n in params:
        np.testing.assert_allclose(cargs[n], targs[n], rtol=0, atol=1e-4, err_msg=n)


def test_bucketing_module_surface():
    bmod = tmx.mod.BucketingModule(_bucket_sym_gen(tmx), default_bucket_key=5,
                                   context=tmx.cpu())
    assert bmod.data_names == ("data",)
    assert bmod.output_names == ["softmax_output"]
    with pytest.raises(MXNetError):
        bmod.init_params()
    with pytest.raises(MXNetError):
        tmx.mod.BucketingModule(_bucket_sym_gen(tmx))
    bmod.bind([("data", (BATCH, 5, DIM))], [("softmax_label", (BATCH,))])
    assert bmod.data_shapes[0].shape == (BATCH, 5, DIM)
    with pytest.raises(MXNetError):
        bmod.bind([("data", (BATCH, 5, DIM))], shared_module=bmod)
    bmod.init_params(tmx.init.One())
    with pytest.raises(MXNetError, match="A7"):
        bmod.install_monitor(object())
    batch = _bucket_batches(tmx, 2)[1]
    bmod.prepare(batch)                       # binds bucket 3, stays on 5
    assert sorted(bmod._buckets) == [3, 5] and bmod._curr_bucket_key == 5
    bmod.forward(batch, is_train=False)
    assert bmod.get_outputs()[0].shape == (BATCH, CLASSES)
    assert bmod.output_shapes[0][1] == (BATCH, CLASSES)
