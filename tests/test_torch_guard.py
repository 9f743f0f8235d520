"""The port's training health guard (``mxnet_tpu_torch/guard.py``) held
against the JAX package's on the CPU.

A small MLP (8 → 16 → 4, SGD-momentum, 8 batches of 4) fits in both
packages from the same seeded parameters, with the same fault specs: the
sentinel's classifier, the policy ladder (skip, rollback, abort), the
stall watchdog through the device feed's ``stall`` point, and the
mid-epoch checkpoint with its ``.resume`` sidecar, written by either
package and resumed by the other. Parameters compare within 1e-5 of the
largest JAX value (float32; only summation order differs); the port's
own rollback against its uninterrupted run is bitwise.
"""
import contextlib
import math

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

B, N, DIN, HID, CLS = 4, 32, 8, 16, 4
SGD = {"learning_rate": 0.1, "momentum": 0.9}


def _net(pkg, dropout=0.0):
    x = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=HID,
                               name="fc1")
    x = pkg.sym.Activation(x, act_type="relu", name="relu1")
    if dropout:
        x = pkg.sym.Dropout(x, p=dropout, name="drop1")
    x = pkg.sym.FullyConnected(x, num_hidden=CLS, name="fc2")
    return pkg.sym.SoftmaxOutput(x, name="softmax")


def _params(seed=0):
    shapes = dict(zip(*[_net(tmx).list_arguments(),
                        _net(tmx).infer_shape(data=(B, DIN))[0]]))
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in shapes.items() if n not in ("data", "softmax_label")}


def _data(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, DIN).astype(np.float32),
            rng.randint(0, CLS, N).astype(np.float32))


def _fit(pkg, guard=None, spec=None, kvstore="local", dropout=0.0,
         num_epoch=1, batch_end=None, **fit_kw):
    """Fit the MLP; returns (module, final params as numpy)."""
    X, Y = _data()
    ctx = pkg.fault.inject(spec) if spec else contextlib.nullcontext()
    with ctx:
        mod = pkg.mod.Module(_net(pkg, dropout), context=pkg.cpu())
        mod.fit(pkg.io.NDArrayIter(X, Y, batch_size=B), num_epoch=num_epoch,
                kvstore=kvstore, optimizer="sgd", optimizer_params=SGD,
                arg_params={n: pkg.nd.array(v, ctx=pkg.cpu())
                            for n, v in _params().items()},
                guard=guard, batch_end_callback=batch_end, **fit_kw)
    return mod, {n: a.asnumpy().copy() for n, a in mod.get_params()[0].items()}


def _recording_guard(pkg, **policy):
    """A TrainingGuard whose ladder decisions and rollbacks are logged."""
    guard = pkg.guard.TrainingGuard(pkg.guard.GuardPolicy(**policy))
    log = {"bad": [], "rollback": []}
    bad_step, rollback = guard.bad_step, guard.rollback

    def rec_bad(reason, epoch, nbatch, applied=False):
        action = bad_step(reason, epoch, nbatch, applied=applied)
        log["bad"].append((reason, epoch, nbatch, action))
        return action

    def rec_rollback(module, train_data):
        res = rollback(module, train_data)
        log["rollback"].append(res)
        return res

    guard.bad_step, guard.rollback = rec_bad, rec_rollback
    return guard, log


def _close(got, want):
    scale = max(float(np.abs(v).max()) for v in want.values())
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=1e-5 * scale,
                                   err_msg=n)


def test_sentinel_classifies_as_jax():
    seq = [(1.0, 1.0), (1.1, 0.9), (0.9, 1.2), (float("nan"), 1.0),
           (1.0, float("inf")), (10.0, 1.0), (1.0, 10.0), (1.05, 1.0),
           (float("-inf"), float("nan")), (-12.0, 1.0), (1.0, None),
           (None, 50.0)]
    got, want = [], []
    for pkg, out in ((tmx, got), (jmx, want)):
        s = pkg.guard.Sentinel(spike_factor=3.0, warmup_steps=2)
        out.extend(s.classify(loss, g) for loss, g in seq)
        out.append((s._loss_ewma, s._gnorm_ewma, s._good_steps))
    assert got == want
    assert {"non_finite_loss", "non_finite_grad", "loss_spike",
            "grad_spike", None} <= set(got[:-1])


def test_sentinel_measures_outputs_and_gradient_norm():
    import torch

    rng = np.random.RandomState(0)
    outs = [rng.randn(3, 4).astype(np.float32), rng.rand(5).astype(np.float32)]
    grads = [rng.randn(4, 4).astype(np.float32)]
    loss, gnorm = tmx.guard.Sentinel().measure(
        [([torch.from_numpy(o) for o in outs], [torch.from_numpy(grads[0])])])
    assert math.isclose(loss, sum(float(o.sum()) for o in outs), rel_tol=1e-5)
    assert math.isclose(gnorm, float(np.linalg.norm(grads[0])), rel_tol=1e-5)


def test_rollback_ladder_matches_jax():
    """``nan:after=3,times=1`` under ``rollback`` with max_bad_steps=1 and
    snapshot_every=2 on the classic path: one bad step at batch 3, one
    rollback to batch 2, the same final parameters."""
    runs = {}
    for pkg in (tmx, jmx):
        guard, log = _recording_guard(pkg, policy="rollback", max_bad_steps=1,
                                      snapshot_every=2)
        _, params = _fit(pkg, guard, spec="nan:after=3,times=1")
        runs[pkg] = (log, guard.bad_steps, guard.rollbacks, params)
    (tlog, tbad, troll, tparams), (jlog, jbad, jroll, jparams) = \
        runs[tmx], runs[jmx]
    assert tlog == jlog
    assert tlog["bad"] == [("non_finite_grad", 0, 3, "rollback")]
    assert tlog["rollback"] == [(0, 2, True)]
    assert (tbad, troll) == (jbad, jroll) == (1, 1)
    _close(tparams, jparams)
    # healed: the same parameters as a fit that never saw the fault
    _, clean = _fit(tmx)
    for n in clean:
        np.testing.assert_array_equal(tparams[n], clean[n], err_msg=n)


def test_skip_on_classic_path_leaves_params_bitwise_unchanged():
    """``skip``: the poisoned step's update is dropped, so the parameters
    after it are bitwise those before it, in both packages."""
    for pkg in (tmx, jmx):
        seen = []

        def snap(p, mod_box=[]):
            seen.append({n: a.asnumpy().copy() for n, a in
                         p.locals["self"].get_params()[0].items()})

        guard, log = _recording_guard(pkg, policy="skip")
        _, params = _fit(pkg, guard, spec="nan:after=2,times=1",
                         batch_end=snap)
        assert log["bad"] == [("non_finite_grad", 0, 2, "skip")], pkg
        for n in params:
            np.testing.assert_array_equal(seen[2][n], seen[1][n], err_msg=n)
            assert not np.array_equal(seen[3][n], seen[2][n]), n
            assert np.isfinite(params[n]).all()


def test_abort_raises_bad_step_error():
    for pkg in (tmx, jmx):
        guard, log = _recording_guard(pkg, policy="abort")
        with pytest.raises(pkg.guard.BadStepError, match="batch 1"):
            _fit(pkg, guard, spec="nan:after=1,times=1,target=loss")
        assert log["bad"] == [("non_finite_loss", 0, 1, "abort")]


def test_stall_in_the_device_feed_raises_stall_error(monkeypatch):
    """The ``stall`` point sleeps the feed's transfer stage past a 0.5 s
    watchdog: a StallError, in both packages, and the feed thread ends.
    The stall is the feed's sixth batch, staged once the loop took its
    fourth: after the first steps' compiles and the watchdog's arming, so
    it cannot pass unseen behind a slow first step."""
    import threading

    monkeypatch.setenv("MXNET_FEED_DEPTH", "1")
    for pkg in (tmx, jmx):
        guard = pkg.guard.TrainingGuard(pkg.guard.GuardPolicy(
            policy="off", stall_timeout_s=0.5))
        with pytest.raises(pkg.guard.StallError):
            _fit(pkg, guard, spec="stall:after=5,times=1,delay_ms=2500")
        assert guard.stall_fired
    assert not [t for t in threading.enumerate()
                if t.name == "DeviceFeedIter" and t.is_alive()]


@pytest.mark.parametrize("writer,reader", [(jmx, tmx), (tmx, jmx)],
                         ids=["jax_writes", "port_writes"])
def test_mid_epoch_checkpoint_resumes_in_the_other_package(tmp_path, writer,
                                                           reader):
    """A guard with checkpoint_every=3 leaves a checkpoint after batch 6
    with its ``.resume`` sidecar; the other package resumes it at batch 6
    and ends where the writer's uninterrupted fit ended."""
    prefix = str(tmp_path / "mlp")
    guard = writer.guard.GuardPolicy(policy="skip", checkpoint_every=3,
                                     checkpoint_prefix=prefix)
    _, full = _fit(writer, guard)
    resume = writer.model.load_resume_state(prefix, 0)
    assert resume["nbatch"] == 6
    first = []
    _, resumed = _fit(reader, auto_resume=prefix,
                      batch_end=lambda p: first.append(p.nbatch))
    assert first[0] == 6 and first[-1] == N // B - 1
    _close(resumed, full)


@pytest.mark.parametrize("kvstore", ["local", "device"])
def test_rollback_over_dropout_equals_uninterrupted_run_bitwise(kvstore):
    """The snapshot keeps the generators: after the rollback the replayed
    batches draw the masks they drew before, on the classic path and on
    the fused one (where the bad update already reached the parameters)."""
    import torch

    torch.manual_seed(7)
    _, clean = _fit(tmx, kvstore=kvstore, dropout=0.5)
    torch.manual_seed(7)
    guard, log = _recording_guard(tmx, policy="rollback", max_bad_steps=1,
                                  snapshot_every=2)
    _, healed = _fit(tmx, guard, spec="nan:after=3,times=1", kvstore=kvstore,
                     dropout=0.5)
    assert log["rollback"] == [(0, 2, True)]
    assert log["bad"][0][3] == "rollback"
    for n in clean:
        np.testing.assert_array_equal(healed[n], clean[n], err_msg=n)


def test_guard_metrics_and_resolve():
    tmx.telemetry.reset()
    guard, _ = _recording_guard(tmx, policy="rollback", max_bad_steps=1,
                                snapshot_every=2)
    _fit(tmx, guard, spec="nan:after=3,times=1")
    counters = tmx.telemetry.dump()["counters"]
    assert counters["guard.bad_steps{reason=non_finite_grad}"] == 1
    assert counters["guard.rollbacks"] == 1
    assert tmx.guard.resolve(None) is None          # off unless asked
    assert isinstance(tmx.guard.resolve("skip"), tmx.guard.TrainingGuard)
    with pytest.raises(tmx.base.MXNetError):
        tmx.guard.GuardPolicy(policy="sometimes")
