"""Parity of the port's speculative decoding with the JAX package, on CPU.

The same numpy inputs (made from a seed) go through the JAX function and
its counterpart in the port: the multi-query paged attention against
``paged_attention_multi_reference`` and the Pallas kernel
``_paged_pallas_multi`` in interpret mode (dead lanes, a dead row, T = 1,
bf16 pages, poisoned unreferenced slots); ``extend`` against the JAX
``extend`` (logits, pages, the per-lane overflow contract) and against T
sequential ``decode`` steps; and the speculative engine (drafts ``self``
and ``tiny``, k in {1, 2, 4}, under preemption and prefix sharing) against
the JAX engine's target-only tokens, which it must equal. The tiny config
is ``tests_tpu/test_serving_spec.py``'s (vocab 23, 2 layers, d 32, bs 8,
64 blocks, max_len 64). The CUDA kernel runs only on the card
(``chip_smoke.py`` holds it against the plain version and, bit for bit,
against the single-query kernel).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as JA
from mxnet_tpu.serving import ServingConfig as JConfig
from mxnet_tpu.serving import ServingEngine as JEngine
from mxnet_tpu.serving import model as jmodel
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as TA
from mxnet_tpu_torch.serving import ServingConfig, ServingEngine, model

CFG = dict(vocab_size=23, num_layers=2, model_dim=32, num_heads=2,
           ffn_dim=48, max_len=64)
SEED = 3
PAGED_TOL = 1e-5    # float32: the two sides sum in another order
BF16_TOL = 2e-2     # bf16 pages, rounded at other places
LOGIT_ATOL, LOGIT_RTOL = 1e-5, 1e-4
PAGE_TOL = 1e-5


def _config(cls=ServingConfig, **over):
    kw = dict(CFG, block_size=8, num_blocks=64, max_batch=8,
              prefills_per_step=4, prefix_cache=False, spec_k=0,
              max_queue=0, default_timeout_ms=0)
    kw.update(over)
    return cls(**kw)


# ------------------------------------------------ multi-query attention
def _multi_case(b=3, t=3, h=2, d=8, bs=4, nb_pool=16, nb_table=4, seed=0):
    """``tests_tpu/test_serving_spec.py``'s generator: per-lane contexts
    with a context-0 lane and a full-window lane."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, t, h, d).astype(np.float32)
    k_pages = rng.randn(nb_pool, bs, h, d).astype(np.float32)
    v_pages = rng.randn(nb_pool, bs, h, d).astype(np.float32)
    tables = rng.randint(1, nb_pool, size=(b, nb_table)).astype(np.int32)
    ctx = rng.randint(1, bs * nb_table + 1, size=(b, t)).astype(np.int32)
    ctx[0, 0] = 0
    ctx[-1, -1] = bs * nb_table
    return q, k_pages, v_pages, tables, ctx


def _case(name):
    if name == "mixed":
        return _multi_case(seed=1)
    if name == "dead_lanes":
        q, kp, vp, tables, ctx = _multi_case(seed=2)
        ctx[1, :] = 0           # a whole row of dead lanes
        ctx[2, 0] = 0           # a dead lane in a live row
        return q, kp, vp, tables, ctx
    if name == "t1":
        return _multi_case(t=1, seed=3)
    return _multi_case(b=4, t=5, d=16, bs=8, nb_pool=24, seed=4)   # "wide"


def _jax_multi(oracle, q, kp, vp, tables, ctx):
    with jax.default_device(jax.devices("cpu")[0]):
        args = [jnp.asarray(x) for x in (q, kp, vp, tables, ctx)]
        if oracle == "reference":
            return np.asarray(JA.paged_attention_multi_reference(*args))
        return np.asarray(JA._paged_pallas_multi(
            *args, sm_scale=q.shape[-1] ** -0.5, interpret=True))


def _port_multi(q, kp, vp, tables, ctx):
    return TA.paged_attention_multi(*(torch.from_numpy(x) for x in
                                      (q, kp, vp, tables, ctx)))


@pytest.mark.parametrize("case", ["mixed", "dead_lanes", "t1", "wide"])
@pytest.mark.parametrize("oracle", ["reference", "pallas_interpret"])
def test_multi_query_matches_jax(oracle, case):
    q, kp, vp, tables, ctx = _case(case)
    want = _jax_multi(oracle, q, kp, vp, tables, ctx)
    got = _port_multi(q, kp, vp, tables, ctx)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=PAGED_TOL,
                               atol=PAGED_TOL)
    dead = ctx == 0
    assert np.all(got.numpy()[dead] == 0.0) and np.all(want[dead] == 0.0)


def test_multi_query_bf16_pages_match_jax_bf16():
    q, kp, vp, tables, ctx = _case("mixed")
    with jax.default_device(jax.devices("cpu")[0]):
        want = np.asarray(JA.paged_attention_multi_reference(
            jnp.asarray(q), jnp.asarray(kp, jnp.bfloat16),
            jnp.asarray(vp, jnp.bfloat16), jnp.asarray(tables),
            jnp.asarray(ctx)))
    got = TA.paged_attention_multi(
        torch.from_numpy(q), torch.from_numpy(kp).bfloat16(),
        torch.from_numpy(vp).bfloat16(), torch.from_numpy(tables),
        torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_multi_lanes_equal_single_query_and_t1_path():
    """Lane t equals the single-query paged attention at that lane's
    context (the verify pass is k+1 decode-step attentions in one call),
    with T lanes and with T = 1."""
    for name in ("mixed", "t1"):
        q, kp, vp, tables, ctx = _case(name)
        got = _port_multi(q, kp, vp, tables, ctx).numpy()
        for t in range(q.shape[1]):
            one = TA.paged_attention(*(
                torch.from_numpy(np.ascontiguousarray(x))
                for x in (q[:, t], kp, vp, tables, ctx[:, t])))
            np.testing.assert_allclose(got[:, t], one.numpy(), rtol=1e-6,
                                       atol=1e-6)


def test_multi_unreferenced_slots_contribute_exactly_zero():
    q, kp, vp, tables, ctx = _case("dead_lanes")
    bs = kp.shape[1]
    live = np.zeros(kp.shape[:2], bool)
    for b in range(tables.shape[0]):
        n = int(ctx[b].max())
        for j in range(-(-n // bs)):
            live[tables[b, j], :min(bs, n - j * bs)] = True
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[~live] = 1e30
    vp2[~live] = -1e30
    np.testing.assert_array_equal(_port_multi(q, kp2, vp2, tables, ctx),
                                  _port_multi(q, kp, vp, tables, ctx))


def _gate_args(case):
    q = torch.zeros(2, 3, 2, 16)
    kp = torch.zeros(6, 4, 2, 16)
    bt = torch.zeros(2, 3, dtype=torch.int32)
    cl = torch.ones(2, 3, dtype=torch.int32)
    if case == "q_3d":
        q = q[:, 0]
    elif case == "too_many_lanes":   # past 65535 groups of 16 (grid z)
        q = torch.zeros(2, 16 * 65535 + 1, 2, 16, device="meta")
        cl = torch.ones(2, 16 * 65535 + 1, dtype=torch.int32, device="meta")
    elif case == "lens_shape":
        cl = torch.ones(2, dtype=torch.int32)
    elif case == "tables_i64":
        bt = bt.long()
    elif case == "head_dim":
        q = torch.zeros(2, 3, 2, 12)
        kp = torch.zeros(6, 4, 2, 12)
    elif case == "strided_q":
        q = torch.zeros(2, 2, 3, 16).transpose(1, 2)
    elif case == "page_dtypes":
        return q, kp, kp.bfloat16(), bt, cl
    elif case == "table_empty":
        bt = torch.zeros(2, 0, dtype=torch.int32)
    return q, kp, kp.clone(), bt, cl


@pytest.mark.parametrize("case", ["q_3d", "too_many_lanes", "lens_shape",
                                  "tables_i64", "head_dim", "strided_q",
                                  "page_dtypes", "table_empty"])
def test_multi_kernel_gate_rejects(case):
    with pytest.raises(MXNetError):
        TA._check_paged_multi(*_gate_args(case))


def test_multi_kernel_gate_accepts_verify_shapes_and_other_devices_raise():
    # T past 16 lanes and tables past 8192 slots reach the kernel (lane
    # groups on the grid's z axis; table slots read per chunk)
    TA._check_paged_multi(torch.zeros(2, 33, 2, 16), torch.zeros(6, 4, 2, 16),
                          torch.zeros(6, 4, 2, 16),
                          torch.zeros(2, 8193, dtype=torch.int32),
                          torch.ones(2, 33, dtype=torch.int32))
    for t in (1, 4, 16):
        TA._check_paged_multi(torch.zeros(32, t, 4, 64),
                              torch.zeros(257, 16, 4, 64),
                              torch.zeros(257, 16, 4, 64),
                              torch.zeros(32, 8, dtype=torch.int32),
                              torch.ones(32, t, dtype=torch.int32))
    with pytest.raises(MXNetError):
        TA.paged_attention_multi(torch.zeros(1, 2, 1, 8, device="meta"),
                                 torch.zeros(2, 4, 1, 8, device="meta"),
                                 torch.zeros(2, 4, 1, 8, device="meta"),
                                 torch.zeros(1, 1, dtype=torch.int32),
                                 torch.zeros(1, 2, dtype=torch.int32))


# --------------------------------------------------------------- extend
def _params():
    cfg = _config()
    np_params = jmodel.random_params(cfg, seed=SEED)
    return (cfg, jmodel.as_device_params(np_params, cfg),
            model.as_device_params(np_params, cfg, device="cpu"))


_jprefill = jax.jit(jmodel.prefill, static_argnums=(6,))
_jextend = jax.jit(jmodel.extend, static_argnums=(7,))


def _pages(cfg):
    shape = (cfg.num_layers, cfg.num_blocks, cfg.block_size, cfg.num_heads,
             cfg.model_dim // cfg.num_heads)
    return jnp.zeros(shape, jnp.float32), torch.zeros(shape)


def _prefilled(cfg, jp, tp, prompts, tables):
    """Prefill each prompt on both sides into blocks of its table row."""
    jk, tk = _pages(cfg)
    jv, tv = _pages(cfg)
    S = cfg.max_len
    for i, pr in enumerate(prompts):
        toks = np.zeros((1, S), np.int32)
        toks[0, :len(pr)] = pr
        table = tables[i]
        _t, _l, jk, jv = _jprefill(jp, jnp.asarray(toks), np.int32(len(pr)),
                                   jnp.asarray(table), jk, jv, cfg)
        model.prefill(tp, torch.from_numpy(toks), len(pr),
                      torch.from_numpy(table), tk, tv, cfg)
    return jk, jv, tk, tv


@pytest.mark.parametrize("T", [1, 3, 5])
def test_extend_matches_jax(T):
    """Three streams (one padded row) verify a T-lane window on both
    sides: the same tokens, logits and pages."""
    cfg, jp, tp = _params()
    nb = cfg.max_len // cfg.block_size
    rng = np.random.RandomState(T)
    prompts = [list(rng.randint(0, cfg.vocab_size, n)) for n in (5, 16, 30)]
    tables = np.zeros((4, nb), np.int32)
    tables[:3] = (1 + np.arange(3 * nb)).reshape(3, nb)
    jk, jv, tk, tv = _prefilled(cfg, jp, tp, prompts, tables)
    toks = rng.randint(0, cfg.vocab_size, (4, T)).astype(np.int32)
    base = np.array([5, 16, 30, 0], np.int32)
    poss = (base[:, None] + np.arange(T)[None, :]).astype(np.int32)
    poss[3] = 0
    ctx = poss + 1
    ctx[3] = 1
    jn, jl, jk, jv = _jextend(jp, *map(jnp.asarray, (toks, poss, tables, ctx)),
                              jk, jv, cfg)
    tn, tl, tk2, tv2 = model.extend(tp, *map(torch.from_numpy,
                                             (toks, poss, tables, ctx)),
                                    tk, tv, cfg)
    assert tk2 is tk and tv2 is tv, "extend writes the pool in place"
    assert tn.dtype == torch.int32 and tn.shape == (4, T)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGIT_RTOL,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(tk[:, 1:].numpy(), np.asarray(jk)[:, 1:],
                               atol=PAGE_TOL)
    np.testing.assert_allclose(tv[:, 1:].numpy(), np.asarray(jv)[:, 1:],
                               atol=PAGE_TOL)


def test_extend_overflow_lanes_poisoned_like_jax():
    """Lanes at or past max_len: token -1, NaN logits, their writes land in
    trash block 0 and every real block holds only the in-range lane's
    write — as in the JAX package."""
    cfg, jp, tp = _params()
    nb = cfg.max_len // cfg.block_size
    tables = (1 + np.arange(nb, dtype=np.int32))[None]
    jk, tk = _pages(cfg)
    jv, tv = _pages(cfg)
    poss = np.array([[cfg.max_len - 1, cfg.max_len, cfg.max_len + 1]],
                    np.int32)
    toks = np.array([[1, 2, 3]], np.int32)
    ctx = poss + 1
    jn, jl, jk, jv = _jextend(jp, *map(jnp.asarray, (toks, poss, tables, ctx)),
                              jk, jv, cfg)
    tn, tl, _k, _v = model.extend(tp, *map(torch.from_numpy,
                                           (toks, poss, tables, ctx)),
                                  tk, tv, cfg)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert int(tn[0, 0]) >= 0 and tn[0, 1:].tolist() == [-1, -1]
    assert torch.isnan(tl[0, 1:]).all() and not torch.isnan(tl[0, 0]).any()
    np.testing.assert_allclose(tl[0, 0].numpy(), np.asarray(jl)[0, 0],
                               rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    last = tables[0, -1]
    written = (tk[:, 1:] != 0).flatten(2).any(dim=2)
    assert written[:, last - 1].all() and written.sum() == cfg.num_layers
    assert (tk[:, 0] != 0).any(), "the overflow writes went to trash"


def test_extend_matches_sequential_decode():
    """extend over a T-token window == T sequential decode calls: the same
    greedy tokens and the same K/V writes."""
    cfg, _jp, tp = _params()
    nb = cfg.max_len // cfg.block_size
    rng = np.random.RandomState(5)
    prompt = [int(x) for x in rng.randint(0, cfg.vocab_size, 10)]
    table = np.zeros((1, nb), np.int32)
    table[0, :3] = [1, 2, 3]
    window = [int(x) for x in rng.randint(0, cfg.vocab_size, 4)]

    def prefilled():
        _j, tk = _pages(cfg)
        _j, tv = _pages(cfg)
        toks = np.zeros((1, cfg.max_len), np.int32)
        toks[0, :len(prompt)] = prompt
        model.prefill(tp, torch.from_numpy(toks), len(prompt),
                      torch.from_numpy(table[0]), tk, tv, cfg)
        return tk, tv

    tk, tv = prefilled()
    seq = []
    for j, w in enumerate(window):
        pos = np.array([len(prompt) + j], np.int32)
        nxt, _l, _k, _v = model.decode(
            tp, *map(torch.from_numpy, (np.array([w], np.int32), pos, table,
                                        pos + 1)), tk, tv, cfg)
        seq.append(int(nxt[0]))
    k_seq, v_seq = tk, tv
    tk, tv = prefilled()
    poss = np.array([[len(prompt) + j for j in range(len(window))]], np.int32)
    nxt, _l, _k, _v = model.extend(
        tp, *map(torch.from_numpy, (np.array([window], np.int32), poss, table,
                                    poss + 1)), tk, tv, cfg)
    assert nxt[0].tolist() == seq
    np.testing.assert_allclose(tk.numpy(), k_seq.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), v_seq.numpy(), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------- engine
def _workload(name):
    if name == "mixed":
        rng = np.random.RandomState(17)
        prompts = [[int(x) for x in rng.randint(0, CFG["vocab_size"],
                                                rng.randint(1, 20))]
                   for _ in range(6)] + [[1] * 8]    # a block-boundary prompt
        return prompts, [int(x) for x in rng.randint(1, 14, len(prompts))], {}
    if name == "preemption":
        # 12 usable blocks for 4 streams of 26 positions (4 blocks) each
        rng = np.random.RandomState(13)
        prompts = [[int(x) for x in rng.randint(0, CFG["vocab_size"], 8)]
                   for _ in range(4)]
        return prompts, [18] * 4, dict(num_blocks=13, max_batch=4)
    prefix = list(range(1, 17))                       # two full blocks
    prompts = [prefix + t for t in ([], [17], [18, 19], [20, 21, 22])]
    return prompts, [10] * 4, dict(prefix_cache=True, prefills_per_step=1)


@functools.lru_cache(maxsize=None)
def _jax_target_only(name):
    prompts, n_new, over = _workload(name)
    return JEngine(_config(JConfig, **over), seed=SEED).generate(prompts,
                                                                  n_new)


@pytest.mark.parametrize("draft", ["self", "tiny"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_spec_tokens_equal_jax_target_only(k, draft):
    prompts, n_new, over = _workload("mixed")
    eng = ServingEngine(_config(spec_k=k, draft=draft), seed=SEED,
                        device="cpu")
    assert eng.generate(prompts, n_new) == _jax_target_only("mixed")
    spec = eng.stats()["spec"]
    assert spec["enabled"] and spec["k"] == k and spec["draft"] == draft
    assert 0 <= spec["accepted_tokens"] <= spec["proposed_tokens"] > 0
    if draft == "self":
        assert spec["accepted_tokens"] > 0
    assert eng.pool.used() == 0


@pytest.mark.parametrize("draft", ["self", "tiny"])
@pytest.mark.parametrize("name", ["preemption", "prefix_sharing"])
def test_spec_tokens_equal_jax_under_preemption_and_sharing(name, draft):
    prompts, n_new, over = _workload(name)
    pre0 = telemetry.counter("serving.preemptions").value
    eng = ServingEngine(_config(spec_k=2, draft=draft, **over), seed=SEED,
                        device="cpu")
    assert eng.generate(prompts, n_new) == _jax_target_only(name)
    if name == "preemption":
        assert telemetry.counter("serving.preemptions").value > pre0, \
            "workload sized to force eviction saw none"
    else:
        assert eng.pool.prefix_stats()["hits"] >= 2
    assert eng.pool.used() == 0


def test_spec_acceptance_accounting_matches_jax_spec_engine():
    """The same workload through both packages' speculative engines: the
    same proposed and accepted counts; warmup runs every draft and verify
    bucket and leaves the pool empty."""
    prompts, n_new, _ = _workload("mixed")
    jeng = JEngine(_config(JConfig, spec_k=2, draft="self"), seed=SEED)
    jeng.generate(prompts, n_new)
    eng = ServingEngine(_config(spec_k=2, draft="self"), seed=SEED,
                        device="cpu")
    eng.warmup()
    assert eng.pool.used() == 0
    eng.generate(prompts, n_new)
    ours, theirs = eng.stats()["spec"], jeng.stats()["spec"]
    for key in ("enabled", "k", "draft", "proposed_tokens",
                "accepted_tokens", "acceptance_rate"):
        assert ours[key] == theirs[key], key
    assert ours["draft_seconds"] > 0 and ours["verify_seconds"] > 0
    off = ServingEngine(_config(), seed=SEED, device="cpu")
    assert off.stats()["spec"]["enabled"] is False
    assert off._draft_params is None and off._draft_kp is None


@pytest.mark.parametrize("spec", ["self", "tiny", "small"])
def test_draft_config_matches_jax(spec):
    cfg = _config()
    ours = model.draft_config(cfg, spec)
    theirs = jmodel.draft_config(_config(JConfig), spec)
    assert ours.key() == theirs.key()
    eng = ServingEngine(_config(spec_k=1, draft=spec), seed=SEED,
                        device="cpu")
    assert (eng._draft_params is eng.params) == (spec == "self")
    assert eng._draft_kp.shape[0] == ours.num_layers


@pytest.mark.parametrize("over,match", [(dict(spec_k=-1), "spec_k"),
                                        (dict(spec_k=1, draft="nope"),
                                         "draft")])
def test_spec_config_rejections(over, match):
    with pytest.raises(ValueError, match=match):
        ServingEngine(_config(**over), seed=SEED, device="cpu")
