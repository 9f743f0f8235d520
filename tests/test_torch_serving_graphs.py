"""The serving engine through its bucket graphs (``serving/graphs.py``),
against the JAX engine, on the CPU.

On the CPU a :class:`BucketGraph` runs its step eagerly on its static
buffers (the CUDA graph exists only on the card, where ``chip_smoke.py``
phases 4, 7 and 16 hold every replay against eager steps): the engine's
tokens must equal the JAX engine's with ``spec_k`` 0 and 3, under
preemption and with a prefix-cache hit; ``stats()["compiles"]`` counts
one build per bucket per program after ``warmup()`` (the JAX programs'
names) and none after; a cold bucket's first call is debited to
``compile_stall``; ``prefill`` takes the prompt length as a device tensor
(one graph per length bucket) and agrees with the host-int call.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu.serving import ServingConfig as JConfig
from mxnet_tpu.serving import ServingEngine as JEngine
from mxnet_tpu.serving import model as jmodel
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.serving import ServingConfig, ServingEngine, model
from mxnet_tpu_torch.serving.graphs import BucketGraph

CFG = dict(vocab_size=23, num_layers=2, model_dim=32, num_heads=2,
           ffn_dim=48, max_len=32)
SEED = 3


def _config(cls=ServingConfig, **over):
    kw = dict(CFG, block_size=8, num_blocks=64, max_batch=8,
              prefills_per_step=4, prefix_cache=False, spec_k=0,
              draft="self", max_queue=0, default_timeout_ms=0)
    kw.update(over)
    return cls(**kw)


def _buckets(cfg):
    n_pre, n_dec = len(cfg.prefill_buckets()), len(cfg.decode_buckets())
    want = {"serving.prefill": n_pre, "serving.decode": n_dec}
    if cfg.spec_k:
        want.update({"serving.draft": n_pre + n_dec, "serving.verify": n_dec})
    return want


def _workload(case):
    if case == "preemption":
        # 12 usable blocks for 4 streams of 28 slots (4 blocks) each
        rng = np.random.RandomState(13)
        prompts = [[int(x) for x in rng.randint(0, CFG["vocab_size"], 8)]
                   for _ in range(4)]
        return prompts, [20] * 4, dict(num_blocks=13, max_batch=4)
    shared = list(range(1, 17))               # two full 8-token blocks
    prompts = [shared + t for t in ([], [17], [18, 19], [20, 21, 22])]
    return prompts, [10] * 4, dict(prefix_cache=True, prefills_per_step=1)


@pytest.mark.parametrize("spec_k", [0, 3])
@pytest.mark.parametrize("case", ["preemption", "prefix_cache"])
def test_graph_engine_matches_jax_engine(case, spec_k):
    prompts, n_new, over = _workload(case)
    want = JEngine(_config(JConfig, **over), seed=SEED).generate(prompts,
                                                                 n_new)
    cfg = _config(spec_k=spec_k, **over)
    eng = ServingEngine(cfg, seed=SEED, device="cpu")
    pre0 = telemetry.counter("serving.preemptions").value
    eng.warmup()
    assert {p: c["count"] for p, c in eng.stats()["compiles"].items()} \
        == _buckets(cfg)
    got = eng.generate(prompts, n_new)
    assert got == want
    st = eng.stats()
    # no bucket built twice: every call after warmup was a replay
    assert {p: c["count"] for p, c in st["compiles"].items()} \
        == _buckets(cfg)
    assert all(c["runs"] >= 0 and c["seconds"] >= 0
               for c in st["compiles"].values())
    assert st["compiles"]["serving.prefill"]["runs"] >= len(prompts)
    assert st["phases"]["compile_stall"]["total_s"] == 0.0
    if case == "preemption":
        assert telemetry.counter("serving.preemptions").value > pre0
    else:
        assert eng.pool.prefix_stats()["hits"] >= 3
    if spec_k:
        assert st["compiles"]["serving.verify"]["runs"] > 0
        assert st["spec"]["proposed_tokens"] > 0


def test_compiles_keys_are_the_jax_programs():
    cfg = _config(spec_k=2)
    eng = ServingEngine(cfg, seed=SEED, device="cpu")
    eng.warmup()
    assert set(eng.stats()["compiles"]) == {
        "serving.prefill", "serving.decode", "serving.draft",
        "serving.verify"}
    assert telemetry.counter("compile.count",
                             program="serving.verify").value >= 4


def test_cold_bucket_is_debited_to_compile_stall():
    """Without warmup(), the first call of each bucket builds it inside a
    request's step: that wall lands in compile_stall, as a cold bucket's
    compile does in the JAX engine."""
    eng = ServingEngine(_config(), seed=SEED, device="cpu")
    assert eng.stats()["compiles"]["serving.prefill"]["count"] == 0
    eng.generate([[1, 2, 3], [4, 5]], 4)
    st = eng.stats()
    assert st["phases"]["compile_stall"]["total_s"] > 0.0
    assert st["compiles"]["serving.prefill"]["count"] == 1
    assert st["compiles"]["serving.decode"]["count"] == 1


def test_bucket_graph_stages_static_inputs_and_counts():
    def fn(a, b):
        return (a * 2, b.sum())

    g = BucketGraph("serving.test", fn, [(2, 3), (1,)], "cpu")
    buf = g.inputs[0]
    out = g(np.arange(6).reshape(2, 3), np.array([7]))
    assert g.captures == 1 and g.replays == 0 and g.capture_s > 0
    assert out[0].tolist() == [[0, 2, 4], [6, 8, 10]]
    out = g(np.ones((2, 3), np.int32), np.array([6]))
    assert g.captures == 1 and g.replays == 1
    assert g.inputs[0] is buf and g.inputs[0].dtype == torch.int32
    assert out[0].tolist() == [[2, 2, 2], [2, 2, 2]] and int(out[1]) == 6
    with pytest.raises(ValueError, match="shape"):
        g(np.zeros((3, 2), np.int32), np.array([1]))
    with pytest.raises(ValueError, match="inputs"):
        g(np.zeros((2, 3), np.int32))


def test_prefill_takes_the_length_as_a_device_tensor():
    cfg = _config()
    np_params = jmodel.random_params(cfg, seed=SEED)
    tp = model.as_device_params(np_params, cfg, device="cpu")
    shape = (cfg.num_layers, cfg.num_blocks, cfg.block_size, cfg.num_heads,
             cfg.model_dim // cfg.num_heads)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (1, 16)).astype(np.int32))
    table = torch.tensor([1, 2], dtype=torch.int32)
    for length in (1, 9, 16):
        outs = []
        for L in (length, torch.tensor([length], dtype=torch.int32)):
            kp, vp = torch.zeros(shape), torch.zeros(shape)
            outs.append(model.prefill(tp, toks, L, table, kp, vp, cfg))
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1], outs[1][1])
        assert torch.equal(outs[0][2], outs[1][2])


def test_new_port_modules_import_no_jax():
    code = ("import sys, mxnet_tpu_torch.serving.graphs,"
            " mxnet_tpu_torch.tools.serve, mxnet_tpu_torch.tools.bench_serving,"
            " mxnet_tpu_torch.models.transformer_lm, mxnet_tpu_torch.telemetry;"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'mxnet_tpu' or "
            "m.startswith('mxnet_tpu.')];"
            "print(bad); sys.exit(1 if bad else 0)")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
