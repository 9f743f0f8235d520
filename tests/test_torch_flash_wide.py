"""Flash attention past head_dim 256 (``csrc/flash_wide.cu``), on the CPU.

The wrapper's shape gate takes every D % 8 == 0, as the JAX package
computes it, and picks the wide kernels from D > 256 alone; the plain
forward and backward at D 264 (not a multiple of 16) and 512 match the JAX
package's ``flash_attention`` (its scan path here) and its gradient. The
kernels cannot run here, so their tiling is emulated in numpy float32 and
held against the JAX package. The forward and dQ: 16 owned rows, key
tiles of 64, the output's D whole up to 512 columns and in equal slices
past it, S chains carried across staged chunks of dimensions, the online
softmax, the output product one key at a time. dK/dV: 16 owned keys in the
same slices, query tiles of 16 from the block's first key on when causal,
S^T and dP^T chains over the whole D up to 512 (chunks of 128 past it),
P^T and dS^T from the forward's lse, dV and dK one query at a time; keys
that no query sees stay exactly zero. The three kernels' scores agree bit
for bit. Float32 throughout: 2e-5 absolute and relative (the summation
order differs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as JA
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import attention as TA

TOL = 2e-5
# csrc/flash_wide.cu's tiles. The forward and dQ: rows, key tile, output
# columns per block, dimensions per staged S chunk
RB, KB, WMAX, FWD_DC, DQ_DC = 16, 64, 512, 128, 64
# dK/dV: keys per block, query rows per tile, dimensions per S chunk with
# K/V resident (D <= WMAX) and streamed
KR, QT, DKV_DC, DKV_SDC = 16, 16, 512, 128


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, d)).astype(np.float32)
            for s in (sq, sk, sk)]


def _jax_fwd_and_grads(q, k, v, g, causal):
    with jax.default_device(jax.devices("cpu")[0]):
        jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
        out, vjp = jax.vjp(lambda a, b, c: JA.flash_attention(a, b, c, causal),
                           jq, jk, jv)
        grads = vjp(jnp.asarray(g))
    return np.asarray(out), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("d", [264, 384, 512])
def test_gate_takes_wide_heads_and_picks_the_wide_kernels(d, monkeypatch):
    x = torch.zeros(1, 2, 8, d)
    TA._check_flash(x, x, x)
    launched = []

    class Fake:
        def __init__(self, name):
            self.name = name

        def launch(self, *args):
            launched.append(self.name)

    for name in ("FLASH_FWD", "FLASH_BWD_DKV", "FLASH_BWD_DQ",
                 "FLASH_WIDE_FWD", "FLASH_WIDE_BWD_DKV", "FLASH_WIDE_BWD_DQ"):
        monkeypatch.setattr(_build, name, Fake(name))
    # the CUDA wrappers' kernel choice, with the launches stubbed: the
    # tensors only need the attributes the wrappers read
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    TA._flash_forward_cuda(x, x, x, True, 0.1)
    lse = torch.zeros(1, 2, 8)
    TA._flash_backward_cuda(x, x, x, x, lse, x, True, 0.1)
    assert launched == ["FLASH_WIDE_FWD", "FLASH_WIDE_BWD_DKV",
                        "FLASH_WIDE_BWD_DQ"]
    launched.clear()
    y = torch.zeros(1, 2, 8, 256)
    TA._flash_forward_cuda(y, y, y, True, 0.1)
    assert launched == ["FLASH_FWD"]


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _Stream:
    cuda_stream = 0


@pytest.mark.parametrize("d", [12, 268, 516])
def test_gate_still_rejects_heads_that_are_not_multiples_of_8(d):
    x = torch.zeros(1, 2, 8, d)
    with pytest.raises(MXNetError, match="multiple of 8"):
        TA._check_flash(x, x, x)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [264, 512])
def test_plain_wide_forward_and_backward_match_jax(d, causal):
    q, k, v = _qkv(d + causal, 1, 2, 40, 40, d)
    g = np.random.default_rng(d).standard_normal(q.shape).astype(np.float32)
    ref_out, ref_grads = _jax_fwd_and_grads(q, k, v, g, causal)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = TA.flash_attention(tq, tk, tv, causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), ref_out, rtol=TOL,
                               atol=TOL)
    for a, r in zip(grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), r, rtol=TOL, atol=TOL)


# ------------------------------------- the wide kernels' tiling, emulated
def _chain_chunked(a, b, dc):
    """S tile = a . b^T as the three kernels form it: one float32 chain per
    entry over d in order, carried across the staged chunks of dc
    dimensions."""
    acc = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for c0 in range(0, a.shape[1], dc):
        for j in range(c0, min(c0 + dc, a.shape[1])):
            acc = (acc + np.outer(a[:, j], b[:, j])).astype(np.float32)
    return acc


def _slices(d):
    """The three kernels' output columns per block: all of D up to WMAX,
    else ceil(D / WMAX) equal slices, a multiple of 8 wide."""
    n = -(-d // WMAX)
    w = (-(-d // n) + 7) // 8 * 8
    return [(c0, min(c0 + w, d)) for c0 in range(0, d, w)]


def _by_key(acc, w, y):
    """acc + w . y, one term (row of y: a key; a query in dK/dV) at a time
    in order, as the kernels' output products add it."""
    for i in range(y.shape[0]):
        acc = (acc + w[:, i:i + 1] * y[i]).astype(np.float32)
    return acc


def _emulate_fwd(q, k, v, causal, scale, scores=None):
    """The forward kernel's tiling; ``scores`` (sq, sk), if given, gets
    every score chain it forms, before the scale."""
    sq, d = q.shape
    sk = k.shape[0]
    out = np.zeros((sq, d), np.float32)
    lse = np.zeros(sq, np.float32)
    for q0 in range(0, sq, RB):
        rows = np.arange(q0, min(q0 + RB, sq))
        kv_end = min(sk, q0 + RB) if causal else sk
        for c0, c1 in _slices(d):
            out[rows, c0:c1], lse[rows] = _softmax_pass(
                q, k, v, rows, range(0, kv_end, KB), c0, c1, causal, scale,
                scores)
    return out, lse


def _softmax_pass(q, k, v, rows, tiles, c0, c1, causal, scale, scores):
    """One forward block's online softmax over the key tiles starting at
    ``tiles``: its normalised output columns [c0, c1) and lse."""
    sk = k.shape[0]
    m = np.full(len(rows), -1e30, np.float32)
    l = np.zeros(len(rows), np.float32)
    o = np.zeros((len(rows), c1 - c0), np.float32)
    for t0 in tiles:
        keys = np.arange(t0, min(t0 + KB, sk))
        chain = _chain_chunked(q[rows], k[keys], FWD_DC)
        if scores is not None:
            scores[np.ix_(rows, keys)] = chain
        s = chain * np.float32(scale)
        if causal:
            s = np.where(rows[:, None] >= keys[None, :], s, -1e30)
        m_new = np.maximum(m, s.max(axis=1))
        p = np.exp(s - m_new[:, None]).astype(np.float32)
        corr = np.exp(m - m_new).astype(np.float32)
        l = l * corr + p.sum(axis=1)
        o = _by_key(o * corr[:, None], p, v[keys, c0:c1])
        m = m_new
    lc = np.maximum(l, 1e-30)
    return o / lc[:, None], (m + np.log(lc)).astype(np.float32)


def _emulate_bwd(q, k, v, g, lse, delta, causal, scale, scores=None):
    """The dK/dV and dQ kernels' tilings; ``scores``, if given, a dict of
    (sq, sk) arrays "dkv" and "dq" that get every score chain each forms,
    before the scale."""
    sq, d = q.shape
    sk = k.shape[0]
    dq, dk, dv = (np.zeros_like(x) for x in (q, k, v))

    def p_ds(qrows, keys, dc, kernel):
        raw = _chain_chunked(q[qrows], k[keys], dc)
        if scores is not None:
            scores[kernel][np.ix_(qrows, keys)] = raw
        s = raw * np.float32(scale)
        ok = np.ones(s.shape, bool)
        if causal:
            ok = qrows[:, None] >= keys[None, :]
        p = np.where(ok, np.exp(s - lse[qrows, None]), 0).astype(np.float32)
        dp = _chain_chunked(g[qrows], v[keys], dc)
        ds = np.where(ok, p * (dp - delta[qrows, None]) * scale, 0)
        return p, ds.astype(np.float32)

    dc = DKV_DC if d <= WMAX else DKV_SDC
    for k0 in range(0, sk, KR):           # the dK/dV kernel's blocks
        keys = np.arange(k0, min(k0 + KR, sk))
        for c0, c1 in _slices(d):
            acc_k = np.zeros((len(keys), c1 - c0), np.float32)
            acc_v = np.zeros((len(keys), c1 - c0), np.float32)
            # causal: query tiles that end before the first key are skipped
            for t0 in range(k0 // QT * QT if causal else 0, sq, QT):
                qrows = np.arange(t0, min(t0 + QT, sq))
                p, ds = p_ds(qrows, keys, dc, "dkv")
                acc_v = _by_key(acc_v, p.T, g[qrows, c0:c1])
                acc_k = _by_key(acc_k, ds.T, q[qrows, c0:c1])
            dk[keys, c0:c1], dv[keys, c0:c1] = acc_k, acc_v
    for q0 in range(0, sq, RB):           # the dQ kernel's blocks
        qrows = np.arange(q0, min(q0 + RB, sq))
        for c0, c1 in _slices(d):
            acc = np.zeros((len(qrows), c1 - c0), np.float32)
            for t0 in range(0, min(sk, q0 + RB) if causal else sk, KB):
                keys = np.arange(t0, min(t0 + KB, sk))
                _, ds = p_ds(qrows, keys, DQ_DC, "dq")
                acc = _by_key(acc, ds, k[keys, c0:c1])
            dq[qrows, c0:c1] = acc
    return dq, dk, dv


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,d", [(40, 40, 264), (37, 70, 384),
                                     (33, 50, 512), (70, 70, 264),
                                     (50, 130, 384), (20, 40, 1032),
                                     (16, 45, 512), (24, 37, 1032)])
def test_wide_kernel_tiling_emulated_matches_jax(sq, sk, d, causal):
    """Ragged rows, key blocks and query tiles (sk not a multiple of 16),
    sq != sk, rows over several 16-row blocks and keys over several 64-key
    tiles, causal key blocks past the last query, the three kernels' three
    slices of 344 columns at D 1032 (dK/dV's S^T and dP^T over 128-dimension
    chunks there): the emulated kernels against the JAX package."""
    q, k, v = (x[0, 0] for x in _qkv(d + sq, 1, 1, sq, sk, d))
    g = np.random.default_rng(sq).standard_normal(q.shape).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    out, lse = _emulate_fwd(q, k, v, causal, scale)
    with jax.default_device(jax.devices("cpu")[0]):
        jq, jk, jv = (jnp.asarray(x[None, None]) for x in (q, k, v))
        ref_out, ref_lse = JA._scan_forward(jq, jk, jv, causal, scale, 32)
        ref_grads = JA._scan_backward(jq, jk, jv, ref_out, ref_lse,
                                      jnp.asarray(g[None, None]), causal,
                                      scale, 32)
    np.testing.assert_allclose(out, np.asarray(ref_out)[0, 0], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lse, np.asarray(ref_lse)[0, 0], rtol=TOL,
                               atol=TOL)
    delta = (out * g).sum(axis=1).astype(np.float32)
    for a, r in zip(_emulate_bwd(q, k, v, g, lse, delta, causal, scale),
                    ref_grads):
        np.testing.assert_allclose(a, np.asarray(r)[0, 0], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,d", [(70, 70, 264), (33, 50, 512),
                                     (20, 40, 1032)])
def test_wide_kernels_form_the_same_score_bits(sq, sk, d, causal):
    """The forward's S (chains carried over 128-dimension chunks), dQ's
    (64-dimension chunks) and dK/dV's S^T (the whole D in one chunk up to
    512, 128-dimension chunks past it, the key's row times the query's)
    agree bit for bit on every score the output needs, so the backward's
    exp(s * scale - lse) sees the forward's s."""
    q, k, v = (x[0, 0] for x in _qkv(d + sq, 1, 1, sq, sk, d))
    g = np.random.default_rng(sq).standard_normal(q.shape).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    formed = {name: np.full((sq, sk), np.nan, np.float32)
              for name in ("fwd", "dkv", "dq")}
    out, lse = _emulate_fwd(q, k, v, causal, scale, formed["fwd"])
    delta = (out * g).sum(axis=1).astype(np.float32)
    _emulate_bwd(q, k, v, g, lse, delta, causal, scale, formed)
    need = np.ones((sq, sk), bool)
    if causal:
        need = np.arange(sq)[:, None] >= np.arange(sk)[None, :]
    for name, s in formed.items():
        assert not np.isnan(s[need]).any(), name
    assert np.array_equal(formed["fwd"][need], formed["dkv"][need])
    assert np.array_equal(formed["dq"][need], formed["dkv"][need])


@pytest.mark.parametrize("sq,sk,d", [(20, 50, 264), (16, 45, 512),
                                     (9, 40, 1032)])
def test_wide_dkv_keys_no_query_sees_stay_exactly_zero(sq, sk, d):
    """Causal with sk > sq: the keys from sq on are seen by no query. The
    key blocks past the last query get no tile, and a block that straddles
    it adds only p = 0 and dS = 0 for them, so their dK and dV rows are
    exactly 0 (the wrapper allocates dk and dv with torch.empty: the kernel
    writes every row); the others match the JAX package."""
    q, k, v = (x[0, 0] for x in _qkv(d + sk, 1, 1, sq, sk, d))
    g = np.random.default_rng(sk).standard_normal(q.shape).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    out, lse = _emulate_fwd(q, k, v, True, scale)
    delta = (out * g).sum(axis=1).astype(np.float32)
    _, dk, dv = _emulate_bwd(q, k, v, g, lse, delta, True, scale)
    assert (dk[sq:] == 0).all() and (dv[sq:] == 0).all()
    assert (dk[:sq] != 0).any() and (dv[:sq] != 0).any()
    _, ref = _jax_fwd_and_grads(q[None, None], k[None, None], v[None, None],
                                g[None, None], True)
    np.testing.assert_allclose(dk, ref[1][0, 0], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(dv, ref[2][0, 0], rtol=TOL, atol=TOL)


def test_wide_backward_passes_16_byte_aligned_inputs(monkeypatch):
    """dK/dV and dQ stage Q, K, V and dO with 16-byte copies: inputs whose
    data start off a 16-byte boundary reach both kernels as aligned
    copies."""
    x = torch.zeros(2 * 8 * 264 + 1)[1:].view(1, 2, 8, 264)
    assert x.data_ptr() % 16 and x.is_contiguous()
    seen = {}

    class Fake:
        def __init__(self, name):
            self.name = name

        def launch(self, *args):
            seen[self.name] = args[:4]

    for name in ("FLASH_WIDE_BWD_DKV", "FLASH_WIDE_BWD_DQ"):
        monkeypatch.setattr(_build, name, Fake(name))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    TA._flash_backward_cuda(x, x, x, x, torch.zeros(1, 2, 8), x, True, 0.1)
    assert sorted(seen) == ["FLASH_WIDE_BWD_DKV", "FLASH_WIDE_BWD_DQ"]
    assert all(p % 16 == 0 for ptrs in seen.values() for p in ptrs)


def test_wide_forward_passes_16_byte_aligned_q_k_v(monkeypatch):
    """The wide forward stages Q's rows with 16-byte copies too: a q, k or
    v whose data starts off a 16-byte boundary reaches the kernel as an
    aligned copy."""
    x = torch.zeros(2 * 8 * 264 + 1)[1:].view(1, 2, 8, 264)
    assert x.data_ptr() % 16 and x.is_contiguous()
    seen = []

    class Fake:
        def launch(self, *args):
            seen.extend(args[:3])

    monkeypatch.setattr(_build, "FLASH_WIDE_FWD", Fake())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: _Stream())
    TA._flash_forward_cuda(x, x, x, True, 0.1)
    assert len(seen) == 3 and all(p % 16 == 0 for p in seen)
