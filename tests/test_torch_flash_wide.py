"""Flash attention past head_dim 256 (``csrc/flash_wide.cu``), on the CPU.

The wrapper's shape gate takes every D % 8 == 0, as the JAX package
computes it, and picks the wide kernels from D > 256 alone; the plain
forward and backward at D 264 (not a multiple of 16) and 512 match the JAX
package's ``flash_attention`` (its scan path here) and its gradient. The
kernels cannot run here, so their tiling is emulated in numpy float32 —
16 owned rows, key or query tiles of 32, output slices of 128 columns, the
online softmax of the forward, and the backward recomputing P from the
forward's lse — and held against the JAX package. Float32 throughout:
2e-5 absolute and relative (the summation order differs).
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
BR, BC, DS = 16, 32, 128   # csrc/flash_wide.cu's tile sizes


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
def _dot_chain(a, b):
    """S tile = a . b^T as the kernels' tile_dot forms it: each entry one
    float32 chain over d in order."""
    acc = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for j in range(a.shape[1]):
        acc = (acc + np.outer(a[:, j], b[:, j])).astype(np.float32)
    return acc


def _emulate_fwd(q, k, v, causal, scale):
    sq, d = q.shape
    sk = k.shape[0]
    out = np.zeros((sq, d), np.float32)
    lse = np.zeros(sq, np.float32)
    for q0 in range(0, sq, BR):
        rows = np.arange(q0, min(q0 + BR, sq))
        kv_end = min(sk, q0 + BR) if causal else sk
        for c0 in range(0, d, DS):
            cols = slice(c0, min(c0 + DS, d))
            m = np.full(len(rows), -1e30, np.float32)
            l = np.zeros(len(rows), np.float32)
            o = np.zeros((len(rows), cols.stop - c0), np.float32)
            for t0 in range(0, kv_end, BC):
                keys = np.arange(t0, min(t0 + BC, sk))
                s = _dot_chain(q[rows], k[keys]) * np.float32(scale)
                if causal:
                    s = np.where(rows[:, None] >= keys[None, :], s, -1e30)
                m_new = np.maximum(m, s.max(axis=1))
                p = np.exp(s - m_new[:, None]).astype(np.float32)
                corr = np.exp(m - m_new).astype(np.float32)
                l = l * corr + p.sum(axis=1)
                o = o * corr[:, None] + p @ v[keys, cols]
                m = m_new
            lc = np.maximum(l, 1e-30)
            out[rows, cols] = o / lc[:, None]
            lse[rows] = m + np.log(lc)
    return out, lse


def _emulate_bwd(q, k, v, g, lse, delta, causal, scale):
    sq, d = q.shape
    sk = k.shape[0]
    dq, dk, dv = (np.zeros_like(x) for x in (q, k, v))

    def p_ds(qrows, keys):
        s = _dot_chain(q[qrows], k[keys]) * np.float32(scale)
        ok = np.ones(s.shape, bool)
        if causal:
            ok = qrows[:, None] >= keys[None, :]
        p = np.where(ok, np.exp(s - lse[qrows, None]), 0).astype(np.float32)
        dp = _dot_chain(g[qrows], v[keys])
        ds = np.where(ok, p * (dp - delta[qrows, None]) * scale, 0)
        return p, ds.astype(np.float32)

    for k0 in range(0, sk, BR):           # the dK/dV kernel's blocks
        keys = np.arange(k0, min(k0 + BR, sk))
        for t0 in range((k0 // BC) * BC if causal else 0, sq, BC):
            qrows = np.arange(t0, min(t0 + BC, sq))
            p, ds = p_ds(qrows, keys)
            dv[keys] += p.T @ g[qrows]
            dk[keys] += ds.T @ q[qrows]
    for q0 in range(0, sq, BR):           # the dQ kernel's blocks
        qrows = np.arange(q0, min(q0 + BR, sq))
        for t0 in range(0, min(sk, q0 + BR) if causal else sk, BC):
            keys = np.arange(t0, min(t0 + BC, sk))
            _, ds = p_ds(qrows, keys)
            dq[qrows] += ds @ k[keys]
    return dq, dk, dv


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,d", [(40, 40, 264), (37, 70, 384),
                                     (33, 50, 512)])
def test_wide_kernel_tiling_emulated_matches_jax(sq, sk, d, causal):
    """Ragged rows and key tiles, sq != sk, a last slice of 8 columns at
    D 264: the emulated kernels against the JAX package."""
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
