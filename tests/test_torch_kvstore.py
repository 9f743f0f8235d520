"""``mx.kv`` in one process against the JAX package: the store types,
``init``/``push``/``pull``/``set_optimizer`` sequences from the same numpy
values (within 1e-6), ``Module`` with a store object, the host engine's
error contract, what the distributed store and its server refuse, and a
working store under each HA variable."""
import os
import pickle
import threading

import numpy as np
import pytest

import mxnet_tpu as J
import mxnet_tpu_torch as T
from mxnet_tpu_torch.base import MXNetError

TOL = 1e-6


def _nd(mx, x):
    return mx.nd.array(x, ctx=mx.cpu())


def _optimizer(mx, kind):
    if kind is None:
        return None
    if kind == "sgd":
        return mx.optimizer.SGD(learning_rate=0.1, momentum=0.9, wd=1e-3,
                                rescale_grad=0.5)
    return mx.optimizer.Adam(learning_rate=0.01, rescale_grad=0.5)


def _sequence(mx, kind, name, seed=0):
    """A seeded init/push/pull sequence (int and str keys, single and list
    forms, two values per key as two devices would give); the pulled
    values in order."""
    r = np.random.RandomState(seed)
    shapes = {3: (4, 5), 7: (6,), "w": (2, 3)}
    kv = mx.kv.create(name)
    init = {k: r.randn(*s).astype(np.float32) for k, s in shapes.items()}
    kv.init(3, _nd(mx, init[3]))
    kv.init([7, "w"], [_nd(mx, init[7]), _nd(mx, init["w"])])
    opt = _optimizer(mx, kind)
    if opt is not None:
        kv.set_optimizer(opt)
    pulled = []
    for _ in range(3):
        for k, s in shapes.items():
            vals = [_nd(mx, r.randn(*s).astype(np.float32)) for _ in range(2)]
            kv.push(k, vals)
        outs = [mx.nd.zeros(shapes[k], ctx=mx.cpu()) for k in (3, 7, "w")]
        kv.pull([3, 7, "w"], out=outs)
        pulled += [o.asnumpy() for o in outs]
        two = [mx.nd.zeros(shapes[3], ctx=mx.cpu()) for _ in range(2)]
        kv.pull(3, out=two)
        np.testing.assert_array_equal(two[0].asnumpy(), two[1].asnumpy())
    return kv, pulled


@pytest.mark.parametrize("kind", [None, "sgd", "adam"])
@pytest.mark.parametrize("name", ["local", "device", "dist_sync"])
def test_single_process_store_matches_jax(monkeypatch, name, kind):
    monkeypatch.delenv("DMLC_PS_ROOT_URI", raising=False)
    tkv, got = _sequence(T, kind, name)
    jkv, want = _sequence(J, kind, name)
    assert type(tkv) is T.kv.KVStore and tkv.type == name
    assert (tkv.rank, tkv.num_workers) == (jkv.rank, jkv.num_workers) == (0, 1)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL * max(1.0, np.abs(b).max()))


def test_create_names_and_rules(monkeypatch):
    monkeypatch.delenv("DMLC_PS_ROOT_URI", raising=False)
    names = ("local", "local_allreduce_cpu", "local_update_cpu", "device",
             "local_allreduce_device", "dist_sync", "dist_async",
             "dist_sync_device", "dist_async_device", "dist")
    for n in names:
        kv = T.kv.create(n)
        assert kv.type == n and J.kv.create(n).type == n
        assert isinstance(kv._comm, T.kv.CommDevice if "device" in n else T.kv.CommHost)
        kv.barrier()
        assert kv.get_num_dead_node() == 0 and not kv.is_recovery
    for bad in ("nccl", "local_sync"):
        with pytest.raises(MXNetError, match="Unknown KVStore"):
            T.kv.create(bad)
    with pytest.raises(TypeError):
        T.kv.create(3)
    kv = T.kv.create("local")
    kv.init(0, _nd(T, np.ones(3)))
    with pytest.raises(MXNetError, match="already initialized"):
        kv.init(0, _nd(T, np.ones(3)))
    with pytest.raises(MXNetError, match="not initialized"):
        kv.push(1, _nd(T, np.ones(3)))


def test_plan_buckets_matches_jax():
    sizes = [4, 100, 3, 3, 50, 1, 7, 20]
    for limit in (1, 10, 30, 1000):
        assert T.kv.plan_buckets(sizes, limit) == J.kvstore.plan_buckets(sizes, limit)


def test_optimizer_states_through_the_store(tmp_path):
    kv, _ = _sequence(T, "adam", "local")
    kv.save_optimizer_states(str(tmp_path / "s"))
    jkv, _ = _sequence(J, "adam", "local")
    jkv.save_optimizer_states(str(tmp_path / "j"))
    fresh = T.kv.create("local")
    with pytest.raises(MXNetError, match="set_optimizer"):
        fresh.load_optimizer_states(str(tmp_path / "j"))
    fresh.set_optimizer(_optimizer(T, "adam"))
    fresh.load_optimizer_states(str(tmp_path / "j"))   # the JAX package's file
    assert sorted(fresh._updater.states, key=str) == sorted(kv._updater.states, key=str)
    for k, st in kv._updater.states.items():
        for a, b in zip(st, fresh._updater.states[k]):
            np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), atol=TOL)


def _net(mx):
    h = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=8, name="fc1")
    h = mx.sym.Activation(h, act_type="relu")
    h = mx.sym.FullyConnected(h, num_hidden=3, name="fc2")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _fit(mx, kvstore, epochs=3):
    r = np.random.RandomState(0)
    X = r.randn(48, 5).astype(np.float32)
    Y = (np.abs(X[:, 0]) * 2).astype(int).clip(0, 2).astype(np.float32)
    init = {"fc1_weight": r.randn(8, 5) * 0.3, "fc1_bias": np.zeros(8),
            "fc2_weight": r.randn(3, 8) * 0.3, "fc2_bias": np.zeros(3)}
    init = {k: _nd(mx, v.astype(np.float32)) for k, v in init.items()}
    mod = mx.mod.Module(_net(mx), context=mx.cpu())
    metric = mx.metric.create("ce")
    losses = []
    mod.fit(mx.io.NDArrayIter(X, Y, batch_size=8), num_epoch=epochs,
            arg_params=init, kvstore=kvstore, optimizer="sgd",
            optimizer_params={"learning_rate": 0.2, "momentum": 0.9},
            eval_metric=metric,
            epoch_end_callback=lambda *a: losses.append(metric.get()[1]))
    return mod, losses, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_module_fit_with_a_store_object_matches_jax():
    """``fit(kvstore=mx.kv.create('local'))``: the store runs the optimizer
    (``update_on_kvstore``), as in the JAX package, and the fit trains."""
    mod, losses, got = _fit(T, T.kv.create("local"))
    assert mod._update_on_kvstore and mod._updater is None
    assert mod._kvstore.type == "local" and mod._fused is None
    assert losses[-1] < losses[0]
    _, _, want = _fit(J, J.kv.create("local"))
    _, _, plain = _fit(T, "local")
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=1e-5)
        np.testing.assert_allclose(got[n], plain[n], atol=1e-6)


def test_dist_type_without_a_launcher_fits_on_the_hybrid_step(monkeypatch):
    """``dist_sync_device`` without ``DMLC_PS_ROOT_URI`` is a one-worker
    store: the fused path's distributed step runs over it (push, server
    update on the store, pull into the masters), the classic path's too,
    and both match the plain fit."""
    monkeypatch.delenv("DMLC_PS_ROOT_URI", raising=False)
    fused, _, f = _fit(T, "dist_sync_device")
    assert fused._fused is not None and fused._fused._dist_kv() is not None
    classic, _, c = _fit(T, "dist_sync")
    assert classic._fused is None
    _, _, plain = _fit(T, "local")
    for n in plain:
        np.testing.assert_allclose(f[n], plain[n], atol=1e-6)
        np.testing.assert_allclose(c[n], plain[n], atol=1e-6)


def test_worker_side_update_runs_the_apply_program(monkeypatch):
    """With the update on the worker (``update_on_kvstore`` False) the
    pulled sums go through :meth:`SPMDTrainer.apply_grads`, the second
    program of the distributed step; it equals the one-program step."""
    monkeypatch.delenv("DMLC_PS_ROOT_URI", raising=False)
    from mxnet_tpu_torch.model import _create_kvstore

    def worker_update(kvstore, n, arg_params):
        kv, _ = _create_kvstore(kvstore, n, arg_params)
        return kv, False

    from mxnet_tpu_torch.parallel.spmd import SPMDTrainer

    calls = []
    apply_grads = SPMDTrainer.apply_grads

    def counted(self, params, states):
        calls.append(1)
        return apply_grads(self, params, states)

    monkeypatch.setattr(T.model, "_create_kvstore", worker_update)
    monkeypatch.setattr(SPMDTrainer, "apply_grads", counted)
    mod, _, got = _fit(T, "dist_sync_device")
    assert not mod._update_on_kvstore and mod._fused._dist_kv() is not None
    assert len(calls) == 18     # 3 epochs of 6 batches
    monkeypatch.undo()
    _, _, want = _fit(T, "device")
    for n in want:
        np.testing.assert_allclose(got[n], want[n], atol=1e-6)


# ---- the engine ---------------------------------------------------------
@pytest.mark.parametrize("kind", ["NaiveEngine", "ThreadedEngine"])
def test_engine_orders_per_var_and_raises_at_the_next_wait(kind):
    from mxnet_tpu_torch import engine

    eng = engine.NaiveEngine() if kind == "NaiveEngine" else engine.ThreadedEngine(2)
    v, w = eng.new_variable(), eng.new_variable()
    seen = []
    lock = threading.Lock()

    def op(i):
        def run():
            with lock:
                seen.append(i)
        return run

    for i in range(20):
        eng.push(op(i), mutable_vars=[v])
    eng.wait_for_var(v)
    assert seen == list(range(20))

    def boom():
        raise ValueError("pushed op failed")

    eng.push(boom, mutable_vars=[w])
    eng.push(op(99), mutable_vars=[v])
    with pytest.raises(ValueError, match="pushed op failed"):
        eng.wait_for_var(w)
    eng.wait_all()          # the error was raised once, then cleared
    assert seen[-1] == 99
    eng.push(boom, mutable_vars=[w])
    with pytest.raises(ValueError):
        eng.wait_all()
    eng.delete_variable(v)
    assert v.deleted


# ---- what the distributed store refuses ----------------------------------
def _launcher_env(monkeypatch, **extra):
    monkeypatch.setenv("DMLC_PS_ROOT_URI", "127.0.0.1")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", "1")
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    for k, v in extra.items():
        monkeypatch.setenv(k, v)


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("env", [{"MXNET_KV_REPLICAS": "1"},
                                 {"MXNET_ELASTIC": "1"},
                                 {"DMLC_PS_RECOVERY": "1"}],
                         ids=["replicas", "elastic", "recovery"])
def test_dist_store_works_under_the_ha_variables(monkeypatch, tmp_path, env):
    """Under a launcher's environment of two servers (in this process) and
    one worker, each HA variable gives a working store: init, an optimizer,
    a push and a pull; elastic, the worker joins the registry first."""
    from mxnet_tpu_torch import elastic, kvstore_server

    port = _free_port()
    while _free_port() == port + 1:
        port = _free_port()
    _launcher_env(monkeypatch, DMLC_PS_ROOT_PORT=str(port), DMLC_NUM_SERVER="2",
                  MXNET_ELASTIC_HEARTBEAT_S="0.2",
                  MXNET_ELASTIC_HEARTBEAT_TIMEOUT_S="5",
                  MXNET_KV_SERVER_CKPT_DIR=str(tmp_path), **env)
    threads = []
    for sid in (0, 1):
        monkeypatch.setenv("DMLC_SERVER_ID", str(sid))
        server = kvstore_server.KVStoreServer(port=port + sid, num_workers=1)
        threads.append(threading.Thread(target=server.run, daemon=True))
        threads[-1].start()
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    kv = T.kv.create("dist_sync")
    assert type(kv) is T.kv.KVStoreDist
    session = None
    if "MXNET_ELASTIC" in env:
        kv, session = elastic.prepare(kv)
        table = session.sync()
        assert table["workers"] == [0] and table["formed"]
    with T.cpu():
        for k in (0, 1):               # one key on each server
            kv.init(k, T.nd.ones((3,)) * (k + 1))
        kv.set_optimizer(T.optimizer.SGD(learning_rate=0.5, rescale_grad=1.0))
        out = T.nd.zeros((3,))
        for k in (0, 1):
            kv.push(k, T.nd.ones((3,)))
            kv.pull(k, out=out)
            np.testing.assert_allclose(out.asnumpy(), k + 0.5)
        assert kv._smap == ([0] if "MXNET_KV_REPLICAS" in env else [0, 1])
        assert kv.is_recovery == ("DMLC_PS_RECOVERY" in env)
    if session is not None:
        session.close(done=True)
    kv._stop_servers()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()


def test_dist_store_and_server_raise_without_the_native_library(monkeypatch):
    from mxnet_tpu_torch import _native, kvstore_server

    def no_library():
        raise MXNetError("g++ not found: the port's native host stage is "
                         "built from source at first use")

    monkeypatch.setattr(_native, "load", no_library)
    _launcher_env(monkeypatch)
    with pytest.raises(MXNetError, match="g\\+\\+ not found"):
        T.kv.create("dist_sync")
    with pytest.raises(MXNetError, match="g\\+\\+ not found"):
        kvstore_server.KVStoreServer(port=1)


def test_a_server_has_no_cuda_and_stops_on_request(tmp_path):
    """A server of a free port: it installs the optimizer a client sends,
    writes and reads its optimizer states, is stopped by a client, and
    never touches CUDA."""
    import socket

    import torch

    from mxnet_tpu_torch import _native, kvstore_server

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    server = kvstore_server.KVStoreServer(port=port, num_workers=1)
    t = threading.Thread(target=server.run)
    t.start()
    import base64
    import ctypes

    lib = _native.load()
    c = lib.mxt_ps_client_create(b"127.0.0.1", port)
    assert c
    with pytest.raises(RuntimeError, match="no optimizer"):
        server.save_states(str(tmp_path / "none"))
    opt = T.optimizer.SGD(learning_rate=0.5, momentum=0.9, rescale_grad=1.0)
    assert lib.mxt_ps_client_command(
        c, b"optim:" + base64.b64encode(pickle.dumps(opt))) == 0
    w = np.ones(6, np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))  # noqa: E731
    assert lib.mxt_ps_client_push(c, 4, ptr(w), 6) == 0      # the init
    assert lib.mxt_ps_client_push(c, 4, ptr(w), 6) == 0      # an update
    out = np.zeros(6, np.float32)
    assert lib.mxt_ps_client_pull(c, 4, ptr(out), 6) == 6
    np.testing.assert_allclose(out, 0.5)                      # 1 - 0.5 * 1
    server.save_states(str(tmp_path / "s"))
    momentum = server._updater.states[4].asnumpy()
    server._updater.states = {}
    server.load_states(str(tmp_path / "s"))
    np.testing.assert_array_equal(server._updater.states[4].asnumpy(), momentum)
    assert lib.mxt_ps_client_command(c, b"stats") == 0
    assert lib.mxt_ps_client_stop(c) == 0
    t.join(timeout=30)
    lib.mxt_ps_client_destroy(c)
    assert not t.is_alive()
    assert server.stats() == dict(
        {"updates_applied": 1, "update_failures": 0,
         "last_update_error": None, "has_optimizer": True},
        **dict.fromkeys(kvstore_server._STATS_COUNTER_FIELDS_HA, 0))
    assert not torch.cuda.is_initialized()
    assert os.environ.get("DMLC_ROLE") is None


class _FailingSGD(T.optimizer.SGD):
    def update(self, index, weight, grad, state):
        raise ValueError("update %d failed" % index)


def test_a_server_stops_past_its_update_failure_threshold(monkeypatch):
    """A failed update keeps the weight and is counted; past
    ``MXNET_KV_SERVER_MAX_UPDATE_FAILURES`` the server's run raises."""
    import base64
    import ctypes
    import socket

    from mxnet_tpu_torch import _native, kvstore_server

    monkeypatch.setenv("MXNET_KV_SERVER_MAX_UPDATE_FAILURES", "0")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    server = kvstore_server.KVStoreServer(port=port, num_workers=1)
    raised = []

    def run():
        try:
            server.run()
        except RuntimeError as e:
            raised.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    lib = _native.load()
    c = lib.mxt_ps_client_create(b"127.0.0.1", port)
    lib.mxt_ps_client_command(
        c, b"optim:" + base64.b64encode(pickle.dumps(_FailingSGD())))
    w = np.full(3, 2.0, np.float32)
    ptr = w.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    assert lib.mxt_ps_client_push(c, 1, ptr, 3) == 0
    assert lib.mxt_ps_client_push(c, 1, ptr, 3) == 0   # the update fails
    out = np.zeros(3, np.float32)
    assert lib.mxt_ps_client_pull(c, 1, out.ctypes.data_as(
        ctypes.POINTER(ctypes.c_float)), 3) == 3
    np.testing.assert_array_equal(out, 2.0)            # the weight was kept
    t.join(timeout=30)
    assert not t.is_alive()
    assert raised and "refusing to keep serving stale weights" in str(raised[0])
    stats = server.stats()
    assert stats["update_failures"] == 1 and "update 1 failed" in stats["last_update_error"]
    lib.mxt_ps_client_destroy(c)
