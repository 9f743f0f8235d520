"""The paged-attention kernels' envelope and their order of operations,
checked on the CPU against the JAX package.

The port's paged kernels (``csrc/paged_decode.cu``, one query per
sequence, and ``csrc/paged_decode_multi.cu``, T lanes per sequence) take
every shape the JAX package's ``_paged_shapes_ok`` accepts: any head
dimension that is a multiple of 8, any pool block size, table width and
lane count, float32, bfloat16 or float16 pages. Here, where there is no
card:

* the port's plain versions (what CPU tensors take) are held against the
  JAX package's ``paged_attention_reference`` and
  ``paged_attention_multi_reference`` at those shapes, and against the
  Pallas kernels in interpret mode at one of them;
* a numpy float32 emulation of the two kernels' arithmetic, operation for
  operation (``paged_common.cuh``: the score's 32 partial fma chains and
  their tree, each pool block's max, m_new, the correction, the weights,
  psum's add chain and each dimension's fma chain, the folds, the
  finish), is run in K3's arrangement (segments of pool blocks, TPP
  threads per score, a warp's max) and in K4's (per lane, a warp per
  score, a serial max) from one shared pool-block step: the two agree bit
  for bit, which is the contract speculative decoding's token equality
  rests on, and both agree with the JAX reference within the port's
  float32 paged tolerance;
* the speculative engine with ``spec_k`` 16 (17 verify lanes, past the
  16 a kernel block holds) gives the JAX engine's target-only tokens.
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
from mxnet_tpu_torch.ops import attention as TA
from mxnet_tpu_torch.serving import ServingConfig, ServingEngine

PAGED_TOL = 1e-5    # float32 paged attention: another summation order
F32 = np.float32
NEG_INF = F32(-1e30)


def _inputs(seed, B, T, H, D, bs, nb, page_dtype=np.float32):
    """q (B, T, H, D), pages (N, bs, H, D) with distinct blocks per
    sequence, tables (B, nb), per-lane contexts (B, T) with a context 0
    and a full table among them."""
    rng = np.random.default_rng(seed)
    N = B * nb + 1
    q = rng.standard_normal((B, T, H, D)).astype(F32)
    kp = rng.standard_normal((N, bs, H, D)).astype(F32).astype(page_dtype)
    vp = rng.standard_normal((N, bs, H, D)).astype(F32).astype(page_dtype)
    tables = rng.permutation(np.arange(1, N))[:B * nb].reshape(B, nb)
    ctx = rng.integers(1, nb * bs + 1, (B, T))
    ctx[0, 0] = 0
    ctx[-1, -1] = nb * bs
    return q, kp, vp, tables.astype(np.int32), ctx.astype(np.int32)


def _jax(fn, *arrays, **kw):
    with jax.default_device(jax.devices("cpu")[0]):
        out = fn(*(jnp.asarray(x) for x in arrays), **kw)
        return np.asarray(out.astype(jnp.float32))


def _torch(fn, *arrays):
    return fn(*(torch.from_numpy(np.ascontiguousarray(x))
                for x in arrays)).float().numpy()


# (B, T, H, D, bs, nb, page dtype)
SINGLE = {
    "d8": (3, 1, 2, 8, 16, 4, np.float32),
    "d136": (3, 1, 2, 136, 16, 3, np.float32),
    "d256": (2, 1, 1, 256, 8, 3, np.float32),
    "bs32": (2, 1, 2, 16, 32, 10, np.float32),     # contexts past 256
    "bs512": (2, 1, 1, 16, 512, 2, np.float32),
    "f16_pages": (3, 1, 2, 32, 16, 4, np.float16),
}
MULTI = {
    "t17": (3, 17, 2, 16, 8, 4, np.float32),
    "t20": (2, 20, 1, 16, 8, 4, np.float32),
    "table8200": (2, 3, 1, 8, 1, 8200, np.float32),
    "d256_bs512": (2, 4, 1, 256, 512, 2, np.float32),
    "f16_pages": (2, 4, 2, 32, 16, 4, np.float16),
}


@pytest.mark.parametrize("case", sorted(SINGLE))
def test_paged_plain_matches_jax_reference(case):
    q, kp, vp, bt, ctx = _inputs(len(case), *SINGLE[case])
    q, ctx = q[:, 0], ctx[:, 0]
    want = _jax(JA.paged_attention_reference, q, kp, vp, bt, ctx)
    got = _torch(TA.paged_attention, q, kp, vp, bt, ctx)
    np.testing.assert_allclose(got, want, rtol=PAGED_TOL, atol=PAGED_TOL)
    assert np.all(got[ctx == 0] == 0.0) and np.abs(got).sum() > 0


@pytest.mark.parametrize("case", sorted(MULTI))
def test_paged_multi_plain_matches_jax_reference(case):
    q, kp, vp, bt, ctx = _inputs(len(case), *MULTI[case])
    if case == "table8200":    # contexts near the table's end
        ctx = np.maximum(ctx, 8000).astype(np.int32)
    want = _jax(JA.paged_attention_multi_reference, q, kp, vp, bt, ctx)
    got = _torch(TA.paged_attention_multi, q, kp, vp, bt, ctx)
    np.testing.assert_allclose(got, want, rtol=PAGED_TOL, atol=PAGED_TOL)
    assert np.all(got[ctx == 0] == 0.0)


@pytest.mark.parametrize("lanes", [1, 5])
def test_paged_plain_matches_pallas_interpret_at_d136_bs32(lanes):
    """D 136 in pool blocks of 32 against the Pallas kernels themselves
    (interpret mode): ``_paged_pallas`` for one lane, the multi-query
    ``_paged_pallas_multi`` for five."""
    q, kp, vp, bt, ctx = _inputs(7, 2, lanes, 2, 136, 32, 3)
    scale = 136 ** -0.5
    if lanes == 1:
        q, ctx = q[:, 0], ctx[:, 0]
        want = _jax(JA._paged_pallas, q, kp, vp, bt, ctx, sm_scale=scale,
                    interpret=True)
        got = _torch(TA.paged_attention, q, kp, vp, bt, ctx)
    else:
        want = _jax(JA._paged_pallas_multi, q, kp, vp, bt, ctx,
                    sm_scale=scale, interpret=True)
        got = _torch(TA.paged_attention_multi, q, kp, vp, bt, ctx)
    np.testing.assert_allclose(got, want, rtol=PAGED_TOL, atol=PAGED_TOL)


# ------------------------------------- the kernels' order, emulated
def _fma(a, b, c):
    """float32 fma: the product is exact in float64, the sum rounded."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(F32)


def _partials(q, k):
    """The score's 32 partial sums: partial l the fma chain over
    dimensions l, l + 32, ... in order from 0. q (..., D), k (..., D)."""
    d = q.shape[-1]
    shape = np.broadcast_shapes(q.shape, k.shape)[:-1]
    part = np.zeros(shape + (32,), F32)
    for c0 in range(0, d, 32):
        n = min(32, d - c0)
        part[..., :n] = _fma(q[..., c0:c0 + n], k[..., c0:c0 + n],
                             part[..., :n])
    return part


def score_warp(q, k, scale):
    """paged_decode_multi.cu: lane l holds partial l; the xor-shuffle
    butterfly adds each lane's value to its xor-16, 8, 4, 2, 1 partner's;
    every lane ends with the same bits."""
    part = _partials(q, k)
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        part = (part + part[..., lanes ^ off]).astype(F32)
    assert np.array_equal(part, np.broadcast_to(part[..., :1], part.shape))
    return (part[..., 0] * F32(scale)).astype(F32)


def score_tpp(q, k, scale, tpp):
    """paged_decode.cu: thread r of TPP holds the partials l = r + TPP i,
    folds the tree's levels 16 .. TPP in registers, then TPP/2 .. 1 by
    shuffles with its group."""
    part = _partials(q, k)
    regs = [part[..., r::tpp].copy() for r in range(tpp)]   # [r][..., i]
    s = 32 // tpp // 2
    while s >= 1:
        for r in range(tpp):
            regs[r][..., :s] = (regs[r][..., :s] + regs[r][..., s:2 * s]
                                ).astype(F32)
        s //= 2
    vals = [x[..., 0] for x in regs]
    off = tpp // 2
    while off >= 1:
        vals = [(vals[r] + vals[r ^ off]).astype(F32) for r in range(tpp)]
        off //= 2
    assert all(np.array_equal(v, vals[0]) for v in vals)
    return (vals[0] * F32(scale)).astype(F32)


def max_serial(s):
    mb = NEG_INF
    for x in s:
        mb = np.fmax(mb, x)
    return mb


def max_warp(s):
    """A warp's max: lane l takes positions l, l + 32, ..., then the
    xor-shuffle butterfly (fmaxf is exact in any order)."""
    lanes = np.full(32, NEG_INF)
    for t, x in enumerate(s):
        lanes[t % 32] = np.fmax(lanes[t % 32], x)
    for off in (16, 8, 4, 2, 1):
        lanes = np.fmax(lanes, lanes[np.arange(32) ^ off])
    return lanes[0]


def block_step(state, s, v, block_max):
    """One pool block of paged_common.cuh over its n live positions in
    order: s (n,) scores, v (n, D)."""
    m, l, acc = state
    mn = np.fmax(m, block_max(s))
    corr = np.exp(F32(m - mn))
    p = np.exp((s - mn).astype(F32))
    psum, a = F32(0), np.zeros(v.shape[1], F32)
    for t in range(len(s)):
        psum = F32(psum + p[t])
        a = _fma(p[t], v[t], a)
    return mn, _fma(l, corr, psum), _fma(acc, corr, a)


def _finish(state):
    _, l, acc = state
    return (acc / np.fmax(l, F32(1e-30))).astype(F32)


def _rows(pages, table, bs, h, p0, p1):
    """K or V rows of positions [p0, p1) of one sequence and head."""
    pos = np.arange(p0, p1)
    return pages[table[pos // bs], pos % bs, h].astype(F32)


def emulate_k3(q, kp, vp, bt, ctx, scale, tpp=4):
    """paged_decode.cu's order: per (sequence, head), segments of whole
    pool blocks (SEG_POS 256 positions, or one block when bs is larger),
    all of a segment's scores at once with TPP threads each, each block's
    max by a warp, then the blocks' steps in order."""
    B, H, D = q.shape
    bs, nb = kp.shape[1], bt.shape[1]
    nbw = max(1, min(256 // bs, 64, 8192 // D))
    out = np.zeros((B, H, D), F32)
    for b in range(B):
        npos = min(int(ctx[b]), nb * bs) if ctx[b] > 0 else 0
        for h in range(H):
            state = (NEG_INF, F32(0), np.zeros(D, F32))
            for w0 in range(0, npos, nbw * bs):
                w1 = min(npos, w0 + nbw * bs)
                s = score_tpp(q[b, h], _rows(kp, bt[b], bs, h, w0, w1),
                              scale, tpp)
                v = _rows(vp, bt[b], bs, h, w0, w1)
                for j0 in range(0, w1 - w0, bs):
                    j1 = min(w1 - w0, j0 + bs)
                    state = block_step(state, s[j0:j1], v[j0:j1], max_warp)
            out[b, h] = _finish(state)
    return out


def emulate_k4(q, kp, vp, bt, ctx, scale):
    """paged_decode_multi.cu's order for each lane: windows of whole pool
    blocks, a warp per score, each (lane, block) max serially, the steps
    of the blocks the lane's context reaches, in order."""
    B, T, H, D = q.shape
    bs, nb = kp.shape[1], bt.shape[1]
    out = np.zeros((B, T, H, D), F32)
    for b in range(B):
        cmax = min(int(ctx[b].max()), nb * bs)
        for h in range(H):
            k = _rows(kp, bt[b], bs, h, 0, cmax)
            v = _rows(vp, bt[b], bs, h, 0, cmax)
            s_all = score_warp(q[b, :, h][:, None, :], k[None], scale)
            for t in range(T):
                c = min(int(ctx[b, t]), nb * bs)
                state = (NEG_INF, F32(0), np.zeros(D, F32))
                for j0 in range(0, max(c, 0), bs):
                    j1 = min(c, j0 + bs)
                    state = block_step(state, s_all[t, j0:j1], v[j0:j1],
                                       max_serial)
                out[b, t, h] = _finish(state)
    return out


# (B, T, H, D, bs, nb, page dtype)
EMULATED = {
    "d8": (2, 3, 2, 8, 16, 4, np.float32),
    "d136": (2, 3, 1, 136, 8, 3, np.float32),
    "bs32_segments": (2, 3, 1, 16, 32, 10, np.float32),
    "bs512": (1, 3, 1, 8, 512, 2, np.float32),
    "t17_f16": (1, 17, 1, 16, 8, 3, np.float16),
}


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_emulated_k3_and_k4_orders_agree_bitwise_and_match_jax(case):
    q, kp, vp, bt, ctx = _inputs(len(case) + 40, *EMULATED[case])
    scale = q.shape[-1] ** -0.5
    k4 = emulate_k4(q, kp, vp, bt, ctx, scale)
    for t in range(q.shape[1]):
        np.testing.assert_array_equal(
            emulate_k3(q[:, t], kp, vp, bt, ctx[:, t], scale), k4[:, t])
    want = _jax(JA.paged_attention_multi_reference, q, kp, vp, bt, ctx)
    np.testing.assert_allclose(k4, want, rtol=PAGED_TOL, atol=PAGED_TOL)
    assert np.all(k4[ctx == 0] == 0.0)


@pytest.mark.parametrize("tpp", [1, 2, 4, 8, 16, 32])
def test_score_trees_agree_bitwise(tpp):
    """K3's TPP-thread score folds the same 32 partials in the same pairs
    as K4's warp butterfly, whatever TPP is, at D 8 through 512."""
    rng = np.random.default_rng(tpp)
    for d in (8, 40, 136, 256, 512):
        q = rng.standard_normal(d).astype(F32)
        k = (rng.standard_normal((64, d)) * 10.0 ** rng.integers(
            -3, 4, (64, 1))).astype(F32)
        np.testing.assert_array_equal(score_tpp(q, k, 0.1, tpp),
                                      score_warp(q, k, 0.1))


# ---------------------------------------- speculative serving, spec_k 16
CFG = dict(vocab_size=23, num_layers=2, model_dim=32, num_heads=2,
           ffn_dim=48, max_len=64, block_size=8, num_blocks=64, max_batch=4,
           prefills_per_step=4, prefix_cache=False, max_queue=0,
           default_timeout_ms=0)


@functools.lru_cache(maxsize=None)
def _jax_target_only(prompts, n_new):
    return JEngine(JConfig(**CFG, spec_k=0), seed=3).generate(
        [list(p) for p in prompts], list(n_new))


def test_spec_k16_serves_the_jax_target_only_tokens():
    """spec_k 16 verifies 17 lanes per step, one more than a block of the
    multi-query kernel holds (a second lane group on the card)."""
    rng = np.random.RandomState(5)
    prompts = tuple(tuple(int(x) for x in rng.randint(0, 23, n))
                    for n in (3, 9, 1))
    n_new = (20, 12, 26)
    eng = ServingEngine(ServingConfig(**CFG, spec_k=16, draft="self"),
                        seed=3, device="cpu")
    assert eng.generate([list(p) for p in prompts], list(n_new)) \
        == _jax_target_only(prompts, n_new)
    spec = eng.stats()["spec"]
    assert spec["k"] == 16 and spec["accepted_tokens"] > 0
    assert eng.pool.used() == 0
