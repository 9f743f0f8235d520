"""The port's fused fit path (``module/fused_path.py``, ``parallel/``) on
one CPU context, mirroring the JAX package's ``tests/test_module_fused.py``
where it applies to one context.

``Module.fit(kvstore='device')`` on ``cpu()`` runs the fused step (on a
card it is a captured CUDA graph; here it runs eagerly, the same code).
Pinned: engagement, numerical equality with the classic path (SGD with
momentum and weight decay, Adam), the kill switch, each demotion and its
warning, outputs before the update, coherent ``get_params`` mid-training,
the checkpoint round trip, an optimizer without a fused rule, a classic
update mid-fused-training that keeps the momentum, a rebind to another
batch shape, the LM's fused fit against the JAX package's fused fit, and
``compute_dtype='bfloat16'`` against the JAX package's bf16 fit.
Tolerances are stated per test.
"""
import importlib
import logging

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.parallel import fused_opt
from mxnet_tpu_torch.io import DataBatch, DataDesc

BATCH, DIM, CLASSES = 16, 12, 6
FUSED_WARNING = "fused SPMD fast path"


def _net(mx=tmx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu")
    fc2 = mx.sym.FullyConnected(act, num_hidden=CLASSES, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def _xy(n=64, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, DIM).astype(np.float32),
            rng.randint(0, CLASSES, (n,)).astype(np.float32))


def _iter(n=64, seed=0, mx=tmx):
    X, y = _xy(n, seed)
    return mx.io.NDArrayIter(X, y, batch_size=BATCH)


def _init():
    return tmx.init.Xavier(rng=torch.Generator().manual_seed(11))


def _fit(kvstore, num_epoch=3, opt="sgd",
         opt_params=(("learning_rate", 0.5), ("momentum", 0.9)), **kwargs):
    mod = tmx.mod.Module(_net(), context=tmx.cpu())
    mod.fit(_iter(), num_epoch=num_epoch, optimizer=opt,
            optimizer_params=dict(opt_params), kvstore=kvstore,
            initializer=_init(), **kwargs)
    return mod


def _bound(kvstore="device", opt_params=None, **bind):
    mod = tmx.mod.Module(_net(), context=tmx.cpu())
    it = _iter()
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             **bind)
    mod.init_params(_init())
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params=opt_params or {"learning_rate": 0.1,
                                                       "momentum": 0.9})
    return mod, next(iter(it))


def _params(mod):
    return {n: a.asnumpy().copy() for n, a in mod.get_params()[0].items()}


def test_fit_device_kvstore_engages_fused_path():
    mod = _fit("device", num_epoch=10)
    assert mod._fused is not None, "kvstore='device' must engage the fused path"
    # SGD momentum: one float32 slot per parameter
    n = sum(a.size for a in mod.get_params()[0].values())
    assert mod._fused.state_bytes() == 4 * n
    score = mod.score(_iter(), tmx.metric.Accuracy())
    # 64 random samples memorized by an MLP: well above the 1/6 chance floor
    assert score[0][1] > 0.4, score


@pytest.mark.parametrize("opt,opt_params", [
    ("sgd", {"learning_rate": 0.3, "momentum": 0.9, "wd": 0.001}),
    ("adam", {"learning_rate": 0.05, "wd": 0.001}),
])
def test_fused_matches_classic_numerically(opt, opt_params):
    """The same rule arithmetic, in the same order, on the same device
    (Adam's bias correction computed on the host in double precision on
    both paths): equal bit for bit."""
    mods = {}
    for kv in ("device", "local"):
        mods[kv] = tmx.mod.Module(_net(), context=tmx.cpu())
        mods[kv].fit(_iter(), num_epoch=2, optimizer=opt,
                     optimizer_params=dict(opt_params), kvstore=kv,
                     initializer=tmx.init.One())
    assert mods["device"]._fused is not None
    assert mods["local"]._fused is None, "CPU + local kvstore stays classic"
    a, b = _params(mods["device"]), _params(mods["local"])
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def test_fused_adam_trains():
    mod = _fit("device", opt="adam", opt_params=(("learning_rate", 0.05),),
               num_epoch=10)
    assert mod._fused is not None
    assert mod.score(_iter(), tmx.metric.Accuracy())[0][1] > 0.3


def test_fused_unsupported_optimizer_falls_back():
    """An optimizer without a fused rule (a subclass may change the math)
    keeps the classic path, and trains."""
    @topt.register
    class ScaledSGD(topt.SGD):
        pass

    try:
        mod = _fit("device", opt="scaledsgd", num_epoch=2)
    finally:
        del topt.Optimizer.opt_registry["scaledsgd"]
    assert mod._fused is None, "an optimizer without a fused rule must demote"
    assert not fused_opt.supported(mod._optimizer)
    assert fused_opt.supported(topt.SGD()) and fused_opt.supported(topt.Adam())
    assert mod.score(_iter(), tmx.metric.Accuracy())[0][1] > 0.2


def test_fused_checkpoint_roundtrip(tmp_path):
    prefix = str(tmp_path / "fused")
    mod = _fit("device", num_epoch=2)
    assert mod._fused is not None
    mod.forward_backward(next(iter(_iter())))
    mod.update()            # the device holds newer params than the host
    want = _params(mod)
    mod.save_checkpoint(prefix, 2)
    mod2 = tmx.mod.Module.load(prefix, 2, context=tmx.cpu())
    mod2.bind(data_shapes=[("data", (BATCH, DIM))],
              label_shapes=[("softmax_label", (BATCH,))])
    got = _params(mod2)
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    mod2.fit(_iter(), num_epoch=1, optimizer="sgd",
             optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
             kvstore="device")
    assert mod2._fused is not None
    assert mod2.score(_iter(), tmx.metric.Accuracy())[0][1] > 0.15


def test_fused_get_params_midtraining_coherent():
    mod, batch = _bound()
    assert mod._fused is not None
    before = _params(mod)
    mod.forward_backward(batch)
    mod.update()
    after = _params(mod)
    assert any(np.abs(after[n] - before[n]).max() > 0 for n in before), \
        "get_params must observe fused updates"
    # the executor group sees them too (a classic consumer after sync)
    exe = mod._exec_group.execs[0]
    for n in after:
        np.testing.assert_array_equal(exe.arg_dict[n].asnumpy(), after[n])


def test_fused_forward_outputs_before_update():
    """forward(train) then get_outputs without update: the outputs are
    visible, computed with the current parameters; after update they are
    the step's (pre-update) outputs."""
    mod, batch = _bound()
    mod.forward(batch, is_train=True)
    outs = mod.get_outputs()
    assert outs[0].shape == (BATCH, CLASSES)
    np.testing.assert_allclose(outs[0].asnumpy().sum(axis=1), 1.0, rtol=1e-5)
    before = outs[0].asnumpy().copy()
    mod.backward()
    mod.update()
    np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(), before,
                               rtol=1e-6, atol=1e-7)


def test_env_kill_switch(monkeypatch, caplog):
    monkeypatch.setenv("MXNET_MODULE_NO_FUSED", "1")
    with caplog.at_level(logging.WARNING):
        mod = _fit("device", num_epoch=1)
    assert mod._fused is None
    assert not [r for r in caplog.records if FUSED_WARNING in r.message]


def test_eval_after_fused_train_uses_eval_batches():
    """A classic-path eval forward must not see the stale fused outputs."""
    mod, batch = _bound(opt_params={"learning_rate": 0.1})
    mod.forward_backward(batch)
    mod.update()
    train_outs = mod.get_outputs()[0].asnumpy().copy()
    eval_batch = next(iter(_iter(seed=9)))
    mod.forward(eval_batch, is_train=False)
    eval_outs = mod.get_outputs()[0].asnumpy()
    assert np.abs(eval_outs - train_outs).max() > 1e-6, (
        "eval forward returned the stale fused train outputs")


def test_epoch_end_self_sync_keeps_device_state():
    """fit's epoch-end get_params/set_params must not make the next step
    re-upload the parameters."""
    mod = _fit("device", num_epoch=2)
    assert mod._fused is not None
    assert mod._fused.state.params is not None
    assert mod._fused.state.fresh, "epoch-end self-sync invalidated the state"


def _warns(caplog, fragment, fn):
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        out = fn()
    msgs = [r.message for r in caplog.records if FUSED_WARNING in r.message]
    assert msgs, "expected a demotion warning, got none"
    assert any(fragment in m for m in msgs), (fragment, msgs)
    assert any("MXNET_MODULE_NO_FUSED" in m for m in msgs)
    return out


def _feature_module():
    feat = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=4,
                                  name="feat")
    mod = tmx.mod.Module(feat, context=tmx.cpu(), label_names=[])
    mod.bind(data_shapes=[("data", (BATCH, DIM))], label_shapes=None)
    return mod


@pytest.mark.parametrize("reason,fragment", [
    ("grad_req", "grad_req"),
    ("inputs_need_grad", "inputs_need_grad"),
    ("fixed_params", "fixed_param_names"),
    ("no_loss_output", "no loss output"),
    ("batch_axis", "batch axis"),
    ("dist_kvstore", "distributed kvstore"),
])
def test_demotion_warns(caplog, reason, fragment):
    """Each veto that applies to one context demotes to the classic path
    with the JAX package's warning."""
    if reason == "no_loss_output":
        mod = _feature_module()
        mod.init_params(_init())
        assert _warns(caplog, fragment,
                      lambda: mod._build_fused_path("device")) is None
        return
    if reason == "batch_axis":
        mod = tmx.mod.Module(_net(), context=tmx.cpu())
        mod.bind(data_shapes=[DataDesc("data", (DIM, BATCH), layout="TN")],
                 label_shapes=[DataDesc("softmax_label", (BATCH,))])
        mod.init_params(_init())
        assert _warns(caplog, fragment,
                      lambda: mod._build_fused_path("device")) is None
        return
    if reason == "dist_kvstore":
        mod, _ = _bound(kvstore="local")
        assert _warns(caplog, fragment,
                      lambda: mod._build_fused_path("dist_sync")) is None
        return
    if reason == "fixed_params":
        mod = tmx.mod.Module(_net(), context=tmx.cpu(),
                             fixed_param_names=["fc1_bias"])
        it = _iter()
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(_init())
    else:
        bind = ({"grad_req": "add"} if reason == "grad_req"
                else {"inputs_need_grad": True})
        mod = tmx.mod.Module(_net(), context=tmx.cpu())
        it = _iter()
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
                 **bind)
        mod.init_params(_init())
    _warns(caplog, fragment, lambda: mod.init_optimizer(
        kvstore="device", optimizer="sgd",
        optimizer_params={"learning_rate": 0.1}))
    assert mod._fused is None


def test_demotion_quiet_on_cpu_local(caplog):
    """CPU + the default kvstore: classic is the expected path, quietly."""
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        mod = _fit("local", num_epoch=1)
    assert mod._fused is None
    assert not [r for r in caplog.records if FUSED_WARNING in r.message]


def test_fallback_update_carries_momentum():
    """A classic update mid-fused-training (``backward(out_grads)`` replays
    the staged batch on the classic path) runs with the fused path's
    momentum, not a fresh zero state, keeps the update count going, and
    hands its state back to the fused path, which then resumes."""
    mod, batch = _bound()
    for _ in range(3):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
    fused_mom = {n: s[0].clone() for n, s in mod._fused.state.states.items()}
    assert any(m.abs().max() > 0 for m in fused_mom.values())
    n_before = mod._optimizer.num_update
    mod.forward(batch, is_train=True)
    mod.backward(out_grads=[tmx.nd.ones((BATCH, CLASSES), ctx=tmx.cpu())])
    mod.update()
    ust = mod._updater.states
    assert ust and all(s is not None and s.asnumpy().any()
                       for s in ust.values()), \
        "the fallback update ran from a fresh zero momentum state"
    assert mod._optimizer.num_update > n_before
    assert mod._fused.state.host_states is not None
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()
    assert mod._fused.state.device_dirty
    assert mod._fused.state.host_states is None
    # the slots came back from the classic step, not from before it
    names = mod._exec_group.param_names
    assert any(not torch.equal(mod._fused.state.states[n][0], fused_mom[n])
               for n in names)


def test_rebind_to_new_shape_builds_new_fused_path():
    mod, batch = _bound()
    mod.forward_backward(batch)
    mod.update()
    first = mod._fused
    mom = {n: s[0].clone() for n, s in first.state.states.items()}
    want = _params(mod)
    half = BATCH // 2
    mod.bind(data_shapes=[("data", (half, DIM))],
             label_shapes=[("softmax_label", (half,))], force_rebind=True)
    assert mod._fused is not None and mod._fused is not first
    for n, v in _params(mod).items():
        np.testing.assert_array_equal(v, want[n], err_msg=n)
    X, y = _xy(half, seed=3)
    small = DataBatch([tmx.nd.array(X, ctx=tmx.cpu())],
                      [tmx.nd.array(y, ctx=tmx.cpu())])
    mod.forward(small, is_train=True)
    assert mod._fused.pending, "the new shape's batch must stage for fusion"
    mod.backward()
    mod.update()
    for n, s in mod._fused.state.states.items():
        assert not torch.equal(s[0], torch.zeros_like(s[0])), n
        assert not torch.equal(s[0], mom[n]), n


# ----------------------------------------------- against the JAX package
JLM = importlib.import_module("mxnet_tpu.models.transformer_lm")
TLM = importlib.import_module("mxnet_tpu_torch.models.transformer_lm")
LM = dict(vocab_size=23, num_layers=2, model_dim=32, num_heads=2, ffn_dim=48,
          seq_len=16)


def _lm():
    with jmx.name.NameManager():
        js = JLM.get_symbol(**LM)
    with tmx.name.NameManager():
        ts = TLM.get_symbol(**LM)
    return js, ts


def _fit_both(js, ts, X, Y, batch, params, aux=None, kvstore="device",
              compute_dtype=None, **fit):
    def run(mx, sym):
        ctx = mx.cpu()
        mod = mx.mod.Module(sym, context=ctx, compute_dtype=compute_dtype)
        mod.fit(mx.io.NDArrayIter(X, Y, batch_size=batch), kvstore=kvstore,
                arg_params={n: mx.nd.array(v, ctx=ctx)
                            for n, v in params.items()},
                aux_params={n: mx.nd.array(v, ctx=ctx)
                            for n, v in (aux or {}).items()}, **fit)
        args, auxs = mod.get_params()
        return mod, {n: a.asnumpy() for n, a in args.items()}, \
            {n: a.asnumpy() for n, a in auxs.items()}

    with jax.default_device(jax.devices("cpu")[0]):
        jm, ja, jx = run(jmx, js)
    tm, ta, tx = run(tmx, ts)
    return jm, tm, (ja, jx), (ta, tx)


def test_lm_fused_fit_matches_jax_fused_fit():
    """The Transformer-LM (plain flash attention here) on both packages'
    fused steps, SGD with momentum, 2 epochs x 4 batches: 5e-5 absolute,
    as the classic-path parity test (float32 summation order over 8
    steps)."""
    js, ts = _lm()
    shapes = dict(zip(ts.list_arguments(),
                      ts.infer_shape(data=(4, 16), softmax_label=(4, 16))[0]))
    rng = np.random.RandomState(0)
    params = {n: (rng.randn(*s) * 0.1).astype(np.float32)
              for n, s in shapes.items() if n not in ("data", "softmax_label")}
    rng = np.random.RandomState(1)
    X = (rng.randint(0, 23, (16, 1)) + np.arange(16)) % 23
    Y = ((X + 1) % 23).astype(np.float32)
    jm, tm, (ja, _), (ta, _) = _fit_both(
        js, ts, X.astype(np.float32), Y, 4, params, num_epoch=2,
        optimizer="sgd", optimizer_params={"learning_rate": 0.1,
                                           "momentum": 0.9},
        eval_metric="ce")
    assert jm._fused is not None and tm._fused is not None
    for n in params:
        np.testing.assert_allclose(ta[n], ja[n], rtol=0, atol=5e-5, err_msg=n)
        assert not np.array_equal(ta[n], params[n]), n


def _bn_net(mx):
    x = mx.sym.Variable("data")
    x = mx.sym.Convolution(x, num_filter=8, kernel=(3, 3), pad=(1, 1),
                           no_bias=True, name="conv0")
    x = mx.sym.BatchNorm(x, fix_gamma=False, eps=2e-5, name="bn0")
    x = mx.sym.Activation(x, act_type="relu", name="relu0")
    x = mx.sym.Pooling(x, kernel=(2, 2), global_pool=True, pool_type="avg",
                       name="pool")
    x = mx.sym.FullyConnected(mx.sym.Flatten(x), num_hidden=CLASSES,
                              name="fc")
    return mx.sym.SoftmaxOutput(x, name="softmax")


@pytest.mark.parametrize("kvstore", ["device", "local"])
def test_bf16_compute_dtype_matches_jax(kvstore):
    """``compute_dtype='bfloat16'`` over float32 masters, a conv/BN/pool/FC
    net, 3 SGD-momentum steps, on the fused path (``'device'``) and the
    classic one (``'local'``) in both packages; parameters and BN's moving
    statistics stay float32. Against the JAX package's bf16 fit: 1e-2
    absolute, because the JAX package accumulates the gamma/beta/weight
    gradient sums in bfloat16 (its bf16 fit lands 6.6e-3 from its own
    float32 fit on bn0_beta, which moves by 6.9e-2). Against the JAX
    package's float32 fit: 5e-4 absolute, the port's bf16 rounding of
    activations (1.8e-4 at most on this input; gradient sums accumulate in
    float32)."""
    with jmx.name.NameManager():
        js = _bn_net(jmx)
    with tmx.name.NameManager():
        ts = _bn_net(tmx)
    args, _, auxs = ts.infer_shape(data=(8, 3, 8, 8))
    rng = np.random.RandomState(4)
    params = {n: (rng.randn(*s) * 0.3).astype(np.float32)
              for n, s in zip(ts.list_arguments(), args)
              if n not in ("data", "softmax_label")}
    aux = {n: (np.ones(s) if n.endswith("var") else np.zeros(s))
           .astype(np.float32)
           for n, s in zip(ts.list_auxiliary_states(), auxs)}
    X = rng.rand(24, 3, 8, 8).astype(np.float32)
    Y = rng.randint(0, CLASSES, (24,)).astype(np.float32)
    fit = dict(kvstore=kvstore, num_epoch=1, optimizer="sgd",
               optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
               eval_metric="acc")
    jm, tm, (ja, jx), (ta, tx) = _fit_both(js, ts, X, Y, 8, params, aux,
                                           compute_dtype="bfloat16", **fit)
    assert (jm._fused is None) == (tm._fused is None) == (kvstore == "local")
    _, _, (fa, fx), _ = _fit_both(js, ts, X, Y, 8, params, aux, **fit)
    moved = max(np.abs(ta[n] - params[n]).max() for n in params)
    assert moved > 1e-2
    for got, jbf, jf32 in ((ta, ja, fa), (tx, jx, fx)):
        for n in got:
            assert got[n].dtype == np.float32
            np.testing.assert_allclose(got[n], jbf[n], rtol=0, atol=1e-2,
                                       err_msg=n)
            np.testing.assert_allclose(got[n], jf32[n], rtol=0, atol=5e-4,
                                       err_msg=n)


def test_capture_refuses_a_graph_that_draws_random_numbers(monkeypatch):
    """A step with a stochastic op registers the device's generator with
    the CUDA graph before capturing; a torch whose CUDAGraph cannot
    register one refuses the capture (no fallback to another generator).
    The CUDA graph API is stubbed: the test runs on the CPU."""
    import contextlib

    from mxnet_tpu_torch.base import MXNetError

    mod, _ = _bound()
    tr = mod._fused.trainer
    assert not tr._stochastic
    tr._stochastic = True
    st = mod._fused.state

    class OldGraph:
        pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", OldGraph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    with pytest.raises(MXNetError, match="random numbers"):
        tr._capture(st.params, st.auxs, st.states, tr.input_buffers())
    assert tr.captures == 0

    registered = []

    class Graph:
        def register_generator_state(self, gen):
            registered.append(gen)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    mod._fused._ensure_device_state()
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, **k: contextlib.nullcontext())
    tr._capture(st.params, st.auxs, st.states, tr.input_buffers())
    assert registered == [tmx.random.generator(tr.device)]
    assert tr.captures == 1
