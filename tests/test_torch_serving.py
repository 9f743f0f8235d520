"""Parity of the PyTorch port's serving path with the JAX package, on CPU.

Weights come from the JAX package's ``random_params`` and cross into the
port through ``as_device_params(..., device="cpu")``. ``prefill`` and
``decode`` are held against the JAX ``serving.model`` functions (logits,
pages, tokens, the overflow contract), and ``ServingEngine.generate``
against the JAX engine's token lists — with preemption forced and with
the prefix cache sharing blocks. The port must never import JAX or the
JAX package: a subprocess import and an AST scan check that.
"""
import ast
import glob
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.serving import ServingConfig as JConfig
from mxnet_tpu.serving import ServingEngine as JEngine
from mxnet_tpu.serving import model as jmodel
from mxnet_tpu_torch import context, fault, telemetry
from mxnet_tpu_torch.analysis import witness
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import (FINISHED, EngineSupervisor, KVBlockPool,
                                     ServingConfig, ServingEngine, model)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=23, num_layers=2, model_dim=32, num_heads=2,
           ffn_dim=48, max_len=32)
SEED = 3
LOGIT_ATOL, LOGIT_RTOL = 1e-5, 1e-4
PAGE_TOL = 1e-5


def _config(cls=ServingConfig, **over):
    kw = dict(CFG, block_size=8, num_blocks=64, max_batch=8,
              prefills_per_step=4, prefix_cache=False, spec_k=0,
              max_queue=0, default_timeout_ms=0)
    kw.update(over)
    return cls(**kw)


def _params():
    cfg = _config()
    np_params = jmodel.random_params(cfg, seed=SEED)
    return (cfg, jmodel.as_device_params(np_params, cfg),
            model.as_device_params(np_params, cfg, device="cpu"))


# the JAX step functions jitted as the JAX engine runs them (cfg static)
_jprefill = jax.jit(jmodel.prefill, static_argnums=(6,))
_jdecode = jax.jit(jmodel.decode, static_argnums=(7,))


def _pages(cfg):
    shape = (cfg.num_layers, cfg.num_blocks, cfg.block_size, cfg.num_heads,
             cfg.model_dim // cfg.num_heads)
    return jnp.zeros(shape, jnp.float32), torch.zeros(shape)


def _close(t, j, atol, rtol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


# ------------------------------------------------------------- weights
def test_random_params_byte_identical_and_carried_across():
    cfg = _config()
    ours = model.random_params(cfg, seed=SEED)
    theirs = jmodel.random_params(cfg, seed=SEED)
    assert sorted(ours) == sorted(theirs)
    for name in ours:
        assert ours[name].tobytes() == theirs[name].tobytes(), name
    dev = model.as_device_params(theirs, cfg, device="cpu")
    assert sorted(dev) == sorted(model.param_shapes(cfg))
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in dev.values())
    bad = dict(theirs, lm_head_bias=np.zeros(5, np.float32))
    with pytest.raises(ValueError, match="lm_head_bias"):
        model.as_device_params(bad, cfg, device="cpu")
    missing = {k: v for k, v in theirs.items() if k != "embed_weight"}
    with pytest.raises(ValueError, match="embed_weight"):
        model.as_device_params(missing, cfg, device="cpu")


# ------------------------------------------------------- prefill / decode
@pytest.mark.parametrize("length", [1, 8, 13, 32])
def test_prefill_matches_jax(length):
    cfg, jp, tp = _params()
    bs = cfg.block_size
    S = min(b for b in cfg.prefill_buckets() if b >= length)
    rng = np.random.RandomState(length)
    toks = np.zeros((1, S), np.int32)
    toks[0, :length] = rng.randint(0, cfg.vocab_size, length)
    table = np.zeros(S // bs, np.int32)
    used = -(-length // bs)
    table[:used] = 1 + rng.permutation(cfg.num_blocks - 1)[:used]
    jk, tk = _pages(cfg)
    jv, tv = _pages(cfg)
    jt, jl, jk, jv = _jprefill(jp, jnp.asarray(toks), np.int32(length),
                               jnp.asarray(table), jk, jv, cfg)
    tt, tl, tk2, tv2 = model.prefill(tp, torch.from_numpy(toks), length,
                                     torch.from_numpy(table), tk, tv, cfg)
    assert tk2 is tk and tv2 is tv, "prefill writes the pool in place"
    assert tt.dtype == torch.int32 and int(tt[0]) == int(np.asarray(jt)[0])
    _close(tl, jl, LOGIT_ATOL, LOGIT_RTOL)
    # live blocks hold the same K/V (trash block 0 takes the padded tail)
    live = table[:used]
    _close(tk[:, live], np.asarray(jk)[:, live], PAGE_TOL)
    _close(tv[:, live], np.asarray(jv)[:, live], PAGE_TOL)


def test_decode_matches_jax_over_steps():
    """Three streams (one padded lane) decode 6 steps on both sides: the
    same tokens, logits and pages at every step."""
    cfg, jp, tp = _params()
    nb = cfg.max_len // cfg.block_size
    B = 4
    tables = np.zeros((B, nb), np.int32)
    tables[:3] = (1 + np.arange(3 * nb)).reshape(3, nb)
    jk, tk = _pages(cfg)
    jv, tv = _pages(cfg)
    rng = np.random.RandomState(1)
    toks = np.zeros(B, np.int32)
    toks[:3] = rng.randint(0, cfg.vocab_size, 3)
    start = np.array([0, 5, 17, 0], np.int32)
    for t in range(6):
        pos = np.where(np.arange(B) < 3, start + t, 0).astype(np.int32)
        ctx = np.where(np.arange(B) < 3, pos + 1, 1).astype(np.int32)
        jn, jl, jk, jv = _jdecode(
            jp, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(tables),
            jnp.asarray(ctx), jk, jv, cfg)
        tn, tl, _k, _v = model.decode(
            tp, *(torch.from_numpy(a) for a in (toks, pos, tables, ctx)),
            tk, tv, cfg)
        assert tn.dtype == torch.int32
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        _close(tl, jl, LOGIT_ATOL, LOGIT_RTOL)
        _close(tk[:, 1:], np.asarray(jk)[:, 1:], PAGE_TOL)
        _close(tv[:, 1:], np.asarray(jv)[:, 1:], PAGE_TOL)
        toks = tn.numpy().copy()
        toks[3] = 0


def test_decode_overflow_contract_matches_jax():
    """position >= max_len: token -1, NaN logits, the write lands in trash
    block 0 and every real block is bit-identical — as in the JAX package."""
    cfg, jp, tp = _params()
    nb = cfg.max_len // cfg.block_size
    tables = (1 + np.arange(nb, dtype=np.int32))[None]
    jk, tk = _pages(cfg)
    jv, tv = _pages(cfg)
    one = np.array([4], np.int32)
    for pos, ctx in ((0, 1), (cfg.max_len, cfg.max_len + 1)):
        args = (one, np.array([pos], np.int32), tables,
                np.array([ctx], np.int32))
        before_k, before_v = tk.clone(), tv.clone()
        jn, jl, jk, jv = _jdecode(jp, *map(jnp.asarray, args), jk, jv, cfg)
        tn, tl, _k, _v = model.decode(tp, *map(torch.from_numpy, args), tk,
                                      tv, cfg)
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert int(tn[0]) == -1 and torch.isnan(tl).all()
    assert np.isnan(np.asarray(jl)).all()
    assert torch.equal(tk[:, 1:], before_k[:, 1:])
    assert torch.equal(tv[:, 1:], before_v[:, 1:])
    assert not torch.equal(tk[:, 0], before_k[:, 0]), "write went to trash"


# ------------------------------------------------------------- the engine
def _mixed_workload(n, seed, prompt_max=12, new_max=12):
    rng = np.random.RandomState(seed)
    prompts = [[int(x) for x in rng.randint(0, CFG["vocab_size"],
                                            rng.randint(1, prompt_max))]
               for _ in range(n)]
    return prompts, [int(rng.randint(1, new_max)) for _ in range(n)]


def _both_generate(prompts, n_new, **over):
    jeng = JEngine(_config(JConfig, **over), seed=SEED)
    teng = ServingEngine(_config(**over), seed=SEED, device="cpu")
    want = jeng.generate(prompts, n_new)
    got = teng.generate(prompts, n_new)
    return teng, got, want


@pytest.mark.parametrize("case", ["mixed", "preemption", "prefix_cache"])
def test_generate_matches_jax_engine(case):
    if case == "mixed":
        prompts, n_new = _mixed_workload(12, seed=5)
        over = {}
    elif case == "preemption":
        # 12 usable blocks for 4 streams of 28 slots (4 blocks) each
        rng = np.random.RandomState(13)
        prompts = [[int(x) for x in rng.randint(0, CFG["vocab_size"], 8)]
                   for _ in range(4)]
        n_new = [20] * 4
        over = dict(num_blocks=13, max_batch=4)
    else:
        shared = list(range(1, 17))           # two full 8-token blocks
        prompts = [shared + t for t in ([], [17], [18, 19], [20, 21, 22])]
        n_new = [10] * 4
        over = dict(prefix_cache=True, prefills_per_step=1)
    pre0 = telemetry.counter("serving.preemptions").value
    teng, got, want = _both_generate(prompts, n_new, **over)
    assert got == want
    assert [len(g) for g in got] == n_new
    if case == "preemption":
        assert telemetry.counter("serving.preemptions").value > pre0, \
            "workload sized to force eviction saw none"
    if case == "prefix_cache":
        st = teng.pool.prefix_stats()
        assert st["hits"] >= 3 and st["hit_blocks"] >= 5, st
    assert teng.pool.used() == 0
    st = teng.stats()
    assert st["completed"] == len(prompts) and st["failed"] == 0
    assert st["tokens_total"] == sum(n_new)
    assert st["device"] == "cpu"


def test_engine_step_loop_and_warmup():
    eng = ServingEngine(_config(), seed=SEED, device="cpu")
    eng.warmup()
    assert eng.pool.used() == 0
    prompts, n_new = _mixed_workload(5, seed=9)
    reqs = [eng.submit(p, n) for p, n in zip(prompts, n_new)]
    done = []
    while eng.has_work():
        done += eng.step()
    assert sorted(r.rid for r in done) == sorted(r.rid for r in reqs)
    assert [r.generated for r in reqs] == eng.generate(prompts, n_new)
    assert {r.rid for r in eng.pop_finished()} >= {r.rid for r in reqs}


def test_engine_abort_fails_pending_requests():
    eng = ServingEngine(_config(), seed=SEED, device="cpu")
    req = eng.submit([1, 2, 3], 4)
    eng.abort(RuntimeError("boom"))
    assert req.state == "failed" and req.done_event.is_set()
    with pytest.raises(RuntimeError, match="boom"):
        eng.submit([1], 1)


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA"):
        context.default_device()
    with pytest.raises(MXNetError, match="CUDA"):
        ServingEngine(_config(), seed=SEED)
    with pytest.raises(MXNetError, match="CUDA"):
        KVBlockPool(1, 4, 8, 2, 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert context.default_device() == torch.device("cuda", 0)
    assert context.gpu(1) == torch.device("cuda", 1)
    assert context.cpu() == torch.device("cpu")


def test_pool_cow_copies_pages_in_place():
    pool = KVBlockPool(2, 6, 4, 2, 8, device="cpu")
    a = pool.alloc(1)[0]
    pool.k_pages[:, a] = torch.randn(2, 4, 2, 8)
    pool.v_pages[:, a] = torch.randn(2, 4, 2, 8)
    pool.incref([a])
    k_ref = pool.k_pages
    b = pool.cow(a)
    assert b != a and pool.refcount(a) == 1 and pool.refcount(b) == 1
    assert pool.k_pages is k_ref, "copy-on-write updates the pages in place"
    assert torch.equal(pool.k_pages[:, b], pool.k_pages[:, a])
    assert torch.equal(pool.v_pages[:, b], pool.v_pages[:, a])
    assert pool.cow(b) == b
    pool.free([a, b])
    assert pool.used() == 0
    with pytest.raises(ValueError, match="double free"):
        pool.free([a])


# ------------------------------------------------- resilience and locks
def test_supervisor_replays_bit_identical_after_injected_fault():
    """A dispatch fault mid-decode aborts the engine; the supervisor
    rebuilds it and replays the survivors, whose tokens equal the JAX
    engine's fault-free run."""
    prompts = [[1, 2, 3, 4], [5, 6, 7], [8, 9]]
    want = JEngine(_config(JConfig), seed=SEED).generate(prompts, 6)
    sup = EngineSupervisor(
        lambda: ServingEngine(_config(), seed=SEED, device="cpu"),
        max_restarts=3, backoff_s=0.01)
    stop = threading.Event()
    with fault.inject("dispatch_error:raise=1,after=2,times=1"):
        reqs = [sup.submit(p, 6) for p in prompts]
        stepper = threading.Thread(target=sup.run_loop, args=(stop, 0.01),
                                  daemon=True)
        stepper.start()
        try:
            for r in reqs:
                assert r.done_event.wait(60), (r.rid, r.state)
        finally:
            stop.set()
            stepper.join(timeout=60)
    assert not stepper.is_alive()
    assert sup.restarts == 1 and sup.failed is None
    assert "InjectedFault" in sup.last_error
    assert [r.state for r in reqs] == [FINISHED] * 3
    assert [list(r.generated) for r in reqs] == want
    assert sup.engine.pool.used() == 0


def test_histogram_percentiles_match_jax_telemetry():
    from mxnet_tpu import telemetry as jtel

    rng = np.random.RandomState(0)
    obs = np.concatenate([rng.exponential(0.02, 200), [0.0, 40.0]])
    ours = telemetry.Histogram("t")
    theirs = jtel.Histogram("t")
    for v in obs:
        ours.observe(v)
        theirs.observe(v)
    assert ours.count == theirs.count and ours.sum == theirs.sum
    for p in (0, 1, 50, 90, 99, 100):
        assert ours.percentile(p) == theirs.percentile(p), p
    assert telemetry.Histogram("empty").percentile(50) is None


def test_lifecycle_events_reach_the_telemetry_buffer():
    eng = ServingEngine(_config(), seed=SEED, device="cpu")
    req = eng.submit([1, 2, 3], 2, request_id="evt-check")
    eng.generate([[4]], 1)
    states = [e["state"] for e in telemetry.events("serving.request")
              if e.get("request_id") == "evt-check"]
    assert req.state == FINISHED and "finished" in states, states


def test_lock_witness_strict_clean_engine_and_catches_inversion():
    witness.configure("strict")
    try:
        witness.reset_observations()
        eng = ServingEngine(_config(), seed=SEED, device="cpu")
        assert eng.generate([[1, 2], [3]], 3)
        assert any(inner.endswith("KVBlockPool._lock")
                   for _outer, inner in witness.observed_edges())
        a = witness.declare("test.A", threading.Lock())
        b = witness.declare("test.B", threading.Lock())
        with a, b:
            pass
        with pytest.raises(witness.LockWitnessError):
            with b, a:
                pass
    finally:
        witness.configure(None)
        witness.reset_observations()


# ------------------------------------------------------- import hygiene
def test_port_import_leaves_jax_out():
    code = ("import sys, mxnet_tpu_torch.serving, mxnet_tpu_torch.ops._build,"
            " mxnet_tpu_torch.module.fused_path, mxnet_tpu_torch.parallel.spmd,"
            " mxnet_tpu_torch.parallel.fused_opt, mxnet_tpu_torch.ops.nn,"
            " mxnet_tpu_torch.models.resnet, mxnet_tpu_torch.models.lstm_lm,"
            " mxnet_tpu_torch.rnn.rnn_cell, mxnet_tpu_torch.rnn.io,"
            " mxnet_tpu_torch.rnn.rnn, mxnet_tpu_torch.ops.rnn_ops,"
            " mxnet_tpu_torch.ops.init_ops,"
            " mxnet_tpu_torch.module.bucketing_module,"
            " mxnet_tpu_torch.random, mxnet_tpu_torch.lr_scheduler,"
            " mxnet_tpu_torch.ops.sample, mxnet_tpu_torch.model,"
            " mxnet_tpu_torch.models, mxnet_tpu_torch.tools.train_imagenet,"
            " mxnet_tpu_torch.ops.ordering, mxnet_tpu_torch.ops.spatial,"
            " mxnet_tpu_torch.ops.optimizer_ops, mxnet_tpu_torch.models.dcgan,"
            " mxnet_tpu_torch.tools.dcgan, mxnet_tpu_torch.test_utils,"
            " mxnet_tpu_torch.ops.contrib_ops, mxnet_tpu_torch.operator,"
            " mxnet_tpu_torch.models.ssd, mxnet_tpu_torch.tools.train_ssd,"
            " mxnet_tpu_torch.module.python_module,"
            " mxnet_tpu_torch.module.sequential_module,"
            " mxnet_tpu_torch.visualization, mxnet_tpu_torch.log,"
            " mxnet_tpu_torch.contrib, mxnet_tpu_torch.contrib.autograd,"
            " mxnet_tpu_torch.contrib.caffe, mxnet_tpu_torch.contrib.ndarray,"
            " mxnet_tpu_torch.contrib.symbol,"
            " mxnet_tpu_torch.tools.caffe_converter,"
            " mxnet_tpu_torch.torch_bridge, mxnet_tpu_torch.notebook,"
            " mxnet_tpu_torch.notebook.callback, mxnet_tpu_torch.op_doc,"
            " mxnet_tpu_torch.symbol_doc, mxnet_tpu_torch.ndarray_doc,"
            " mxnet_tpu_torch.recordio, mxnet_tpu_torch._native,"
            " mxnet_tpu_torch.image, mxnet_tpu_torch.image_det,"
            " mxnet_tpu_torch.io_image, mxnet_tpu_torch.io,"
            " mxnet_tpu_torch.tools.im2rec;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.')];"
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax():
    files = glob.glob(os.path.join(ROOT, "mxnet_tpu_torch", "**", "*.py"),
                      recursive=True) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 10
    rel = {os.path.relpath(f, ROOT) for f in files}
    assert {os.path.join("mxnet_tpu_torch", p) for p in (
        "module/fused_path.py", "parallel/spmd.py", "parallel/fused_opt.py",
        "models/resnet.py", "ops/nn.py", "models/lstm_lm.py", "rnn/__init__.py",
        "rnn/rnn_cell.py", "rnn/io.py", "rnn/rnn.py", "ops/rnn_ops.py",
        "ops/init_ops.py", "module/bucketing_module.py", "random.py",
        "lr_scheduler.py", "ops/sample.py", "tools/train_imagenet.py",
        "models/alexnet.py", "models/vgg.py", "models/googlenet.py",
        "models/inception_bn.py", "models/inception_v3.py",
        "models/inception_resnet_v2.py", "models/resnext.py",
        "models/lenet.py", "models/mlp.py", "ops/ordering.py",
        "ops/spatial.py", "ops/optimizer_ops.py", "ops/elemwise.py",
        "ops/matrix.py", "ops/reduce.py", "ops/indexing.py", "ops/loss.py",
        "models/dcgan.py", "tools/dcgan.py", "test_utils.py",
        "ops/contrib_ops.py", "operator.py", "models/ssd.py", "tools/train_ssd.py",
        "module/python_module.py", "module/sequential_module.py",
        "visualization.py", "log.py")} <= rel
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "mxnet_tpu"}, (f, roots)
