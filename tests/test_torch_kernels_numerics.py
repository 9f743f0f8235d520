"""The precision design of the flash kernels (``csrc/flash_fwd.cu``, and
``csrc/flash_bwd_dkv.cu`` and ``csrc/flash_bwd_dq.cu`` for the backward),
checked on the CPU.

The kernel computes both products of the flash forward on the tensor
cores in TF32, with split operands: P.V in three products ("3xTF32":
x = big + small with big = tf32(x) and small = tf32(x - big), summed as
a_small.b_big + a_big.b_small + a_big.b_big), Q.K^T from an exact
three-way split x = x1 + x2 + x3 in six products. The card cannot be
reached from these tests, so a test-only emulation of that arithmetic
(the kernel's key tiles, online softmax and rounding, in numpy) is held
against the JAX package's ``_scan_forward`` and ``_pallas_forward``
(interpret mode) within the port's flash tolerance, and the same
emulation with one TF32 product is shown to miss it by a wide margin:
that is why the kernel splits. bf16 inputs are exact in TF32, which is
why the kernel takes fewer products for them. The backward kernels
recompute S = Q.K^T as the forward does (six products), take dP = dO.V^T
and the three gradient products in 3xTF32, and are emulated and held to
the JAX package's ``_scan_backward`` and ``_pallas_backward`` the same
way.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as JA
from mxnet_tpu_torch.ops import attention as TA

TOL = 2e-5   # the port's float32 flash tolerance (tests/test_torch_attention.py)
NEG_INF = np.float32(-1e30)


def _tf32(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: the kernel's rounding."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    x = np.asarray(x, np.float32)
    big = _tf32(x)
    return big, _tf32(x - big)


def _split3(x):
    """x = x1 + x2 + x3 exactly, each TF32 (11 + 11 + at most 3 bits)."""
    x = np.asarray(x, np.float32)
    x1 = _tf32(x)
    r = x - x1
    x2 = _tf32(r)
    return x1, x2, r - x2


def _mm(a, b, products):
    """a @ b as the kernel's tensor cores compute it: TF32 operands, exact
    products, float32 result; ``products`` 6 (the exact three-way split,
    the six products above 2^-33), 3 (3xTF32), 2 (a split, b exact in
    TF32: bfloat16 values) or 1 (plain TF32)."""
    f = np.float64
    if products == 6:
        (a1, a2, a3), (b1, b2, b3) = _split3(a), _split3(b)
        out = sum(x.astype(f) @ y.astype(f) for x, y in
                  ((a3, b1), (a2, b2), (a1, b3), (a2, b1), (a1, b2), (a1, b1)))
        return out.astype(np.float32)
    if products == 2:
        np.testing.assert_array_equal(_tf32(b), b)
        ab, as_ = _split(a)
        return (as_.astype(f) @ b.astype(f)
                + ab.astype(f) @ b.astype(f)).astype(np.float32)
    (ab, as_), (bb, bs) = _split(a), _split(b)
    out = ab.astype(f) @ bb.astype(f)
    if products == 3:
        out += as_.astype(f) @ bb.astype(f) + ab.astype(f) @ bs.astype(f)
    return out.astype(np.float32)


def emulated_flash_forward(q, k, v, causal, scale, exact=True):
    """The kernel's forward on (B, H, S, D) float32 arrays: key tiles of 64
    (32 at D > 64), scores (six products) and P.V (three) through
    :func:`_mm` — or both in one TF32 product with ``exact=False`` — and
    the online softmax in float32 with masked scores pinned to -1e30 and
    l clamped at 1e-30. Returns (out, lse)."""
    qk_products, pv_products = (6, 3) if exact else (1, 1)
    b, h, sq, d = q.shape
    sk = k.shape[2]
    bk = 64 if d <= 64 else 32
    m = np.full((b, h, sq), NEG_INF, np.float32)
    l = np.zeros((b, h, sq), np.float32)
    acc = np.zeros((b, h, sq, d), np.float32)
    qi = np.arange(sq)[:, None]
    for t0 in range(0, sk, bk):
        kt, vt = k[:, :, t0:t0 + bk], v[:, :, t0:t0 + bk]
        s = _mm(q, np.swapaxes(kt, -1, -2), qk_products) * np.float32(scale)
        ki = t0 + np.arange(kt.shape[2])[None, :]
        ok = (qi >= ki) if causal else np.ones_like(qi >= ki)
        s = np.where(ok, s, NEG_INF).astype(np.float32)
        m_new = np.maximum(m, s.max(axis=-1))
        corr = np.exp(m - m_new)
        p = np.exp(s - m_new[..., None]).astype(np.float32)
        l = (l * corr + p.sum(axis=-1)).astype(np.float32)
        acc = (acc * corr[..., None] + _mm(p, vt, pv_products)).astype(
            np.float32)
        m = m_new
    lc = np.maximum(l, np.float32(1e-30))
    return acc / lc[..., None], m + np.log(lc)


def emulated_flash_backward(q, k, v, out, lse, g, causal, scale,
                            products=(6, 3, 3)):
    """The two backward kernels on (B, H, S, D) float32 arrays, from the
    forward's ``out`` and ``lse``: dQ over key tiles of 64 (32 at D > 64),
    as ``csrc/flash_bwd_dq.cu`` walks them, dK and dV over query tiles of
    the same size, as ``csrc/flash_bwd_dkv.cu`` does. S = Q.K^T, dP =
    dO.V^T and the three gradient products go through :func:`_mm` with
    ``products`` = (S's, dP's, the gradients') split degrees: (6, 3, 3) for
    float32, (1, 1, 2) for bfloat16 values, (1, 1, 1) for plain TF32.
    delta = rowsum(dO * out) in float32; masked pairs give p = 0 exactly.
    Returns (dq, dk, dv)."""
    s_p, dp_p, g_p = products
    sq, sk, d = q.shape[2], k.shape[2], q.shape[3]
    tile = 64 if d <= 64 else 32
    delta = (out * g).sum(axis=-1, dtype=np.float32)
    f32 = np.float32
    tr = functools.partial(np.swapaxes, axis1=-1, axis2=-2)

    def p_ds(q0, qt, gt, lt, dt, k0, kt, vt):
        s = _mm(qt, tr(kt), s_p) * f32(scale)
        ok = (q0 + np.arange(qt.shape[2])[:, None]
              >= k0 + np.arange(kt.shape[2])[None, :])
        if not causal:
            ok = np.ones_like(ok)
        p = np.where(ok, np.exp(s - lt[..., None]), f32(0)).astype(f32)
        dp = _mm(gt, tr(vt), dp_p)
        return p, (p * (dp - dt[..., None]) * f32(scale)).astype(f32)

    dq = np.zeros(q.shape, f32)
    for k0 in range(0, sk, tile):
        kt, vt = k[:, :, k0:k0 + tile], v[:, :, k0:k0 + tile]
        _, ds = p_ds(0, q, g, lse, delta, k0, kt, vt)
        dq = (dq + _mm(ds, kt, g_p)).astype(f32)
    dk = np.zeros(k.shape, f32)
    dv = np.zeros(v.shape, f32)
    for q0 in range(0, sq, tile):
        qt, gt = q[:, :, q0:q0 + tile], g[:, :, q0:q0 + tile]
        p, ds = p_ds(q0, qt, gt, lse[:, :, q0:q0 + tile],
                     delta[:, :, q0:q0 + tile], 0, k, v)
        dv = (dv + _mm(tr(p), gt, g_p)).astype(f32)
        dk = (dk + _mm(tr(ds), qt, g_p)).astype(f32)
    return dq, dk, dv


def _inputs(seed, b, h, sq, sk, d, dtype):
    """Seeded q, k, v: float32, or float32 holding bf16-rounded values."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((b, h, s, d)).astype(np.float32)
          for s in (sq, sk, sk)]
    if dtype == "bf16":
        xs = [torch.from_numpy(x).bfloat16().float().numpy() for x in xs]
    return xs


def _jax(q, k, v, causal, scale, oracle, dtype):
    jt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    with jax.default_device(jax.devices("cpu")[0]):
        jq, jk, jv = (jnp.asarray(x, jt) for x in (q, k, v))
        if oracle == "scan":
            out, lse = JA._scan_forward(jq, jk, jv, causal, scale, 32)
        else:
            out, lse = JA._pallas_forward(jq, jk, jv, causal, scale,
                                          block_q=32, block_k=32,
                                          interpret=True)
    return np.asarray(out), np.asarray(lse)


# (b, h, sq, sk, d): the serving and training rows of the kernel table
# cut to small B, a ragged sq < sk, and sq > sk at the widest head
SHAPES = [(1, 4, 128, 128, 64), (2, 2, 48, 80, 64), (1, 2, 100, 37, 128)]
CASES = [(o, dt, s, c) for s in SHAPES for c in (False, True)
         for dt in ("f32", "bf16") for o in ("scan", "pallas_interpret")
         if not (o == "pallas_interpret" and dt == "bf16")]


@pytest.mark.parametrize("oracle,dtype,shape,causal", CASES)
def test_split_tf32_flash_forward_matches_jax(oracle, dtype, shape, causal):
    b, h, sq, sk, d = shape
    q, k, v = _inputs(sum(shape) + causal, b, h, sq, sk, d, dtype)
    scale = 1.0 / np.sqrt(d)
    out, lse = emulated_flash_forward(q, k, v, causal, scale)
    ref_out, ref_lse = _jax(q, k, v, causal, scale, oracle, dtype)
    np.testing.assert_allclose(out, ref_out, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse, ref_lse, rtol=TOL, atol=TOL)
    # and the port's plain version, which the kernel is held to on the card
    p_out, p_lse = TA._flash_forward_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal, scale)
    np.testing.assert_allclose(out, p_out.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse, p_lse.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_one_tf32_product_misses_the_tolerance(causal):
    """Plain TF32 keeps about three decimal digits: at the serving shape it
    misses the flash tolerance by far more than 10x, where the split
    products meet it."""
    q, k, v = _inputs(5 + causal, 1, 4, 128, 128, 64, "f32")
    scale = 0.125
    ref_out, _ = _jax(q, k, v, causal, scale, "scan", "f32")
    err_split = np.abs(emulated_flash_forward(q, k, v, causal, scale)[0]
                  - ref_out).max()
    err1 = np.abs(emulated_flash_forward(q, k, v, causal, scale, False)[0]
                  - ref_out).max()
    assert err_split <= TOL
    assert err1 > 10 * TOL, err1


def test_bf16_operands_are_exact_in_tf32():
    """bf16 keeps 8 mantissa bits and TF32 10: a bf16 value's big part is
    the value itself and its small part is 0, so the kernel skips the
    small products for bf16 K and V (and Q)."""
    x = torch.randn(4096, generator=torch.Generator().manual_seed(3))
    x = torch.cat([x, x * 1e-20, x * 1e20]).bfloat16().float().numpy()
    big, small = _split(x)
    np.testing.assert_array_equal(big, x)
    np.testing.assert_array_equal(small, np.zeros_like(x))


def test_f16_operands_are_exact_in_tf32():
    """float16 keeps 10 explicit mantissa bits, as TF32 does, and its
    exponents (subnormals included) lie inside float32's normal range:
    every finite float16 value's big part is the value itself and its
    small part 0, so the flash kernels take bf16's one-product route for
    float16 inputs too."""
    x = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(np.float16)
    x = x[np.isfinite(x)].astype(np.float32)
    assert x.size == 63488      # 2^16 less 2 infinities and 2046 NaNs
    big, small = _split(x)
    np.testing.assert_array_equal(big, x)
    np.testing.assert_array_equal(small, np.zeros_like(x))
    np.testing.assert_array_equal(_tf32(x), x)


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),     # a tie rounds away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -12, 1.0),                  # below half a TF32 step
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),
])
def test_tf32_rounding_is_nearest_ties_away(x, want):
    assert _tf32(np.float32(x)) == np.float32(want)


def test_three_way_split_is_exact():
    """x1 + x2 + x3 is x itself: the scores' products miss nothing above
    2^-33 of q.k."""
    x = np.random.default_rng(5).standard_normal(100000).astype(np.float32)
    x1, x2, x3 = _split3(x)
    np.testing.assert_array_equal(_tf32(x3), x3)
    np.testing.assert_array_equal(
        (x1.astype(np.float64) + x2 + x3).astype(np.float32), x)
    np.testing.assert_array_equal(x1.astype(np.float64) + x2 + x3, x)


def test_split_keeps_float32_accuracy():
    """big + small carries x to within 2^-21 of its size (the dropped
    small.small product is of that order), where big alone errs by up
    to 2^-11."""
    x = np.random.default_rng(4).standard_normal(100000).astype(np.float32)
    big, small = _split(x)
    rel = np.abs((big.astype(np.float64) + small) - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -21
    assert (np.abs(big - x) / np.abs(x)).max() > 2.0 ** -13


def _jax_backward(q, k, v, g, causal, scale, oracle):
    """The JAX package's forward residuals (``_scan_forward``) and its
    backward, ``_scan_backward`` or ``_pallas_backward`` in interpret mode,
    in float32 on the given values."""
    with jax.default_device(jax.devices("cpu")[0]):
        jq, jk, jv, jg = (jnp.asarray(x, jnp.float32) for x in (q, k, v, g))
        out, lse = JA._scan_forward(jq, jk, jv, causal, scale, 32)
        if oracle == "scan":
            ref = JA._scan_backward(jq, jk, jv, out, lse, jg, causal, scale,
                                    32)
        else:
            ref = JA._pallas_backward(jq, jk, jv, out, lse, jg, causal, scale,
                                      block_q=32, block_k=32, interpret=True)
    return (np.array(out), np.array(lse),
            [np.array(r, np.float32) for r in ref])


# the training shape cut to B*H = 2, a ragged sq < sk, and sq > sk at the
# widest head (32-row tiles)
BWD_SHAPES = [(1, 2, 128, 128, 64), (1, 2, 48, 80, 64), (1, 2, 100, 37, 128)]
BWD_CASES = [(o, dt, s, c) for s in BWD_SHAPES for c in (False, True)
             for dt in ("f32", "bf16") for o in ("scan", "pallas_interpret")
             if not (o == "pallas_interpret" and dt == "bf16")]


@pytest.mark.parametrize("oracle,dtype,shape,causal", BWD_CASES)
def test_split_tf32_flash_backward_matches_jax(oracle, dtype, shape, causal):
    """The backward kernels' split degrees keep float32 accuracy: dq, dk and
    dv within the flash tolerance of the JAX package's backward (and of
    the port's plain version) on the same residuals. bf16 values take the
    kernels' bf16 degrees: one product for S and dP, two for the
    gradients."""
    b, h, sq, sk, d = shape
    q, k, v = _inputs(sum(shape) + 3 * causal, b, h, sq, sk, d, dtype)
    g = _inputs(sum(shape) + 1, b, h, sq, sq, d, dtype)[0]
    scale = 1.0 / np.sqrt(d)
    out, lse, ref = _jax_backward(q, k, v, g, causal, scale, oracle)
    products = (6, 3, 3) if dtype == "f32" else (1, 1, 2)
    got = emulated_flash_backward(q, k, v, out, lse, g, causal, scale,
                                  products)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a, r, rtol=TOL, atol=TOL)
    plain = TA._flash_backward_plain(
        *(torch.from_numpy(x) for x in (q, k, v, out, lse, g)), causal, scale)
    for a, r in zip(got, plain):
        np.testing.assert_allclose(a, r.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_one_tf32_product_misses_the_backward_tolerance(causal):
    """Plain TF32 in all five backward products misses the flash tolerance
    by more than 10x at the training shape cut to B*H = 2, where the
    kernels' split degrees meet it."""
    q, k, v = _inputs(11 + causal, 1, 2, 128, 128, 64, "f32")
    g = _inputs(12, 1, 2, 128, 128, 64, "f32")[0]
    scale = 0.125
    out, lse, ref = _jax_backward(q, k, v, g, causal, scale, "scan")
    split = emulated_flash_backward(q, k, v, out, lse, g, causal, scale)
    one = emulated_flash_backward(q, k, v, out, lse, g, causal, scale,
                                  (1, 1, 1))
    err_split = max(np.abs(a - r).max() for a, r in zip(split, ref))
    err1 = max(np.abs(a - r).max() for a, r in zip(one, ref))
    assert err_split <= TOL
    assert err1 > 10 * TOL, err1
