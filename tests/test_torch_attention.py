"""Parity of the PyTorch port's attention ops with the JAX package, on CPU.

The same numpy inputs (made from a seed) go through the JAX function and
through the port's plain PyTorch version, which is what the port runs for
CPU tensors: the flash forward against ``_scan_forward`` and against the
Pallas kernel ``_pallas_forward`` in interpret mode, the flash backward
against ``_scan_backward`` and the Pallas kernels of ``_pallas_backward``
in interpret mode, the differentiable ``flash_attention`` against
``jax.vjp`` of the JAX one, the paged decode against
``paged_attention_reference`` and the Pallas kernel ``_paged_pallas`` in
interpret mode. The CUDA kernels themselves run only on the card
(``chip_smoke.py`` holds them against these plain versions).
"""
import os
import stat
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as JA
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import attention as TA

TOL = 2e-5          # float32 flash: the two sides sum in another order
PAGED_TOL = 1e-5    # float32 paged decode
BF16_TOL = 2e-2     # bf16 pages / inputs, rounded at other places


def _cpu():
    return jax.devices("cpu")[0]


def _qkv(seed, b, h, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32),
            rng.standard_normal((b, h, sk, d)).astype(np.float32))


# (b, h, sq, sk, d): S=80 with blocks of 32 leaves ragged q and kv tails;
# sq != sk in both directions
FLASH_SHAPES = [(1, 2, 80, 80, 16), (2, 2, 48, 80, 16), (1, 2, 80, 40, 16)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("oracle", ["scan", "pallas_interpret"])
def test_flash_forward_matches_jax(oracle, shape, causal):
    b, h, sq, sk, d = shape
    q, k, v = _qkv(sum(shape) + causal, b, h, sq, sk, d)
    scale = 1.0 / np.sqrt(d)
    with jax.default_device(_cpu()):
        jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
        if oracle == "scan":
            ref_out, ref_lse = JA._scan_forward(jq, jk, jv, causal, scale, 32)
        else:
            ref_out, ref_lse = JA._pallas_forward(
                jq, jk, jv, causal, scale, block_q=32, block_k=32,
                interpret=True)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for block_k in (32, 256):
        out, lse = TA._flash_forward_plain(tq, tk, tv, causal, scale, block_k)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                                   rtol=TOL, atol=TOL)
    # the public entry point takes the plain version for CPU tensors
    out, lse = TA.flash_attention_forward(tq, tk, tv, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax_and_oracle(causal):
    """``flash_attention`` (output cast to the input dtype) against the
    JAX package's ``flash_attention`` and both packages' naive oracle,
    in float32 and with bf16 inputs."""
    q, k, v = _qkv(11, 2, 2, 70, 70, 16)
    with jax.default_device(_cpu()):
        ref = np.asarray(JA.flash_attention(*map(jnp.asarray, (q, k, v)),
                                            causal, None, 32))
        ref_bf = np.asarray(JA.flash_attention(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
            causal, None, 32).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out = TA.flash_attention(tq, tk, tv, causal)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        TA.attention_reference(tq, tk, tv, causal).numpy(), ref,
        rtol=TOL, atol=TOL)
    out_bf = TA.flash_attention(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(),
                                causal)
    assert out_bf.dtype == torch.bfloat16
    np.testing.assert_allclose(out_bf.float().numpy(), ref_bf,
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("oracle", ["scan", "pallas_interpret"])
def test_flash_backward_matches_jax(oracle, shape, causal):
    """``_flash_backward_plain`` (the twin of ``_scan_backward``) on the
    JAX forward's residuals: dq, dk, dv within 2e-5 (float32, another
    summation order). S = 80 with blocks of 32 leaves ragged tails."""
    b, h, sq, sk, d = shape
    q, k, v = _qkv(sum(shape) + 7 * causal, b, h, sq, sk, d)
    g = np.random.default_rng(sum(shape)).standard_normal(
        (b, h, sq, d)).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    with jax.default_device(_cpu()):
        jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
        out, lse = JA._scan_forward(jq, jk, jv, causal, scale, 32)
        if oracle == "scan":
            ref = JA._scan_backward(jq, jk, jv, out, lse, jg, causal, scale, 32)
        else:
            ref = JA._pallas_backward(jq, jk, jv, out, lse, jg, causal, scale,
                                      block_q=32, block_k=32, interpret=True)
    args = [torch.from_numpy(np.array(x)) for x in (q, k, v, out, lse, g)]
    for block_k in (32, 256):
        got = TA._flash_backward_plain(*args[:6], causal, scale, block_k)
        for a, r in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=TOL,
                                       atol=TOL)
    # the public entry point takes the plain version for CPU tensors
    got = TA.flash_attention_backward(*args, causal)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_gradient_matches_jax_vjp(causal):
    """Autograd through the port's ``flash_attention`` Function against
    ``jax.vjp`` of the JAX custom_vjp, with a strided head gradient (the
    Function makes it contiguous), float32 within 2e-5; bf16 inputs give
    bf16 gradients."""
    q, k, v = _qkv(21 + causal, 2, 2, 48, 80, 16)
    g = np.random.default_rng(5).standard_normal((2, 48, 2, 16)).astype(
        np.float32)
    with jax.default_device(_cpu()):
        _, vjp = jax.vjp(lambda a, b, c: JA.flash_attention(a, b, c, causal),
                         *map(jnp.asarray, (q, k, v)))
        ref = vjp(jnp.asarray(g.transpose(0, 2, 1, 3)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = TA.flash_attention(tq, tk, tv, causal)
    tg = torch.from_numpy(g).transpose(1, 2)           # not contiguous
    assert not tg.is_contiguous()
    got = torch.autograd.grad(out, (tq, tk, tv), tg)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=TOL, atol=TOL)
    bq, bk, bv = (torch.from_numpy(x).bfloat16().requires_grad_(True)
                  for x in (q, k, v))
    bgrads = torch.autograd.grad(TA.flash_attention(bq, bk, bv, causal).float().sum(),
                                 (bq, bk, bv))
    assert all(x.dtype == torch.bfloat16 for x in bgrads)


# (d, dtype): past D 128 (the kernels' 32-k-step instances) and float16
WIDE_CASES = [(136, np.float32), (256, np.float32), (64, np.float16),
              (136, np.float16)]


def _f16_tol(ref):
    """float16 results are rounded to float16 on both sides: one may land
    a float16 step (2^-10 relative) from the other."""
    return 2e-3 * max(1.0, float(np.abs(np.asarray(ref, np.float32)).max()))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,dtype", WIDE_CASES)
def test_flash_forward_matches_jax_scan_past_d128_and_in_f16(d, dtype, causal):
    """The plain forward against ``_scan_forward`` on the same float16 or
    float32 values (both compute in float32 and return float32)."""
    q, k, v = (x.astype(dtype) for x in _qkv(d + causal, 1, 2, 40, 56, d))
    scale = 1.0 / np.sqrt(d)
    with jax.default_device(_cpu()):
        ref_out, ref_lse = JA._scan_forward(
            *(jnp.asarray(x) for x in (q, k, v)), causal, scale, 32)
    out, lse = TA.flash_attention_forward(
        *(torch.from_numpy(x) for x in (q, k, v)), causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("d,dtype", WIDE_CASES)
def test_flash_backward_matches_jax_scan_past_d128_and_in_f16(d, dtype):
    """The plain backward against ``_scan_backward`` on the JAX forward's
    residuals, causal; gradients in the inputs' dtype on both sides."""
    q, k, v = (x.astype(dtype) for x in _qkv(d + 3, 1, 2, 40, 40, d))
    g = np.random.default_rng(d).standard_normal(q.shape).astype(dtype)
    scale = 1.0 / np.sqrt(d)
    with jax.default_device(_cpu()):
        jq, jk, jv, jg = (jnp.asarray(x) for x in (q, k, v, g))
        out, lse = JA._scan_forward(jq, jk, jv, True, scale, 32)
        out = out.astype(jq.dtype)
        ref = JA._scan_backward(jq, jk, jv, out, lse, jg, True, scale, 32)
    args = [torch.from_numpy(np.array(x)) for x in (q, k, v, out, lse, g)]
    got = TA.flash_attention_backward(*args, True)
    for a, r in zip(got, ref):
        assert a.dtype == torch.from_numpy(q).dtype
        tol = TOL if dtype == np.float32 else _f16_tol(r)
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(r, np.float32), rtol=tol,
                                   atol=tol)


def test_flash_backward_kernel_gate_rejects():
    """What the backward kernels refuse raises before any launch."""
    q = _t(1, 2, 8, 16)
    lse = _t(1, 2, 8)
    with pytest.raises(MXNetError, match="contiguous output gradient"):
        TA._flash_backward_cuda(q, q, q, q, lse, _t(1, 8, 2, 16).transpose(1, 2),
                                True, 0.25)
    with pytest.raises(MXNetError, match="lse"):
        TA._flash_backward_cuda(q, q, q, q, lse.double(), q, True, 0.25)
    with pytest.raises(MXNetError, match="out"):
        TA._flash_backward_cuda(q, q, q, _t(1, 2, 9, 16), lse, q, True, 0.25)
    with pytest.raises(MXNetError, match="different devices"):
        TA._flash_backward_cuda(q, q, q, q, torch.zeros(1, 2, 8, device="meta"),
                                q, True, 0.25)
    with pytest.raises(MXNetError):
        TA._flash_backward_cuda(_t(1, 2, 8, 12), _t(1, 2, 8, 12),
                                _t(1, 2, 8, 12), _t(1, 2, 8, 12), lse,
                                _t(1, 2, 8, 12), True, 0.25)
    with pytest.raises(MXNetError):
        TA.flash_attention_backward(*(torch.zeros(1, 1, 4, 8, device="meta"),) * 4,
                                    torch.zeros(1, 1, 4, device="meta"),
                                    torch.zeros(1, 1, 4, 8, device="meta"))


def _paged(seed, B=4, H=2, D=16, bs=8, N=12, nb=4, lens=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, D).astype(np.float32)
    kp = rng.randn(N, bs, H, D).astype(np.float32)
    vp = rng.randn(N, bs, H, D).astype(np.float32)
    bt = rng.randint(1, N, (B, nb)).astype(np.int32)
    if lens is None:
        # ragged: empty, one token, partial block, exactly full
        lens = [0, 1, nb * bs // 2 + 1, nb * bs][:B]
    return q, kp, vp, bt, np.asarray(lens, np.int32)


def _jax_paged(oracle, q, kp, vp, bt, cl):
    with jax.default_device(_cpu()):
        args = [jnp.asarray(x) for x in (q, kp, vp, bt, cl)]
        if oracle == "reference":
            return np.asarray(JA.paged_attention_reference(*args)
                              .astype(jnp.float32))
        return np.asarray(JA._paged_pallas(
            *args, 1.0 / np.sqrt(q.shape[-1]), interpret=True)
            .astype(jnp.float32))


def _torch_paged(q, kp, vp, bt, cl):
    return TA.paged_attention(*(torch.from_numpy(x) for x in
                                (q, kp, vp, bt, cl)))


@pytest.mark.parametrize("oracle", ["reference", "pallas_interpret"])
@pytest.mark.parametrize("shape", [dict(), dict(B=3, D=32, bs=16, N=9, nb=3)])
def test_paged_decode_matches_jax(oracle, shape):
    q, kp, vp, bt, cl = _paged(2, **shape)
    ref = _jax_paged(oracle, q, kp, vp, bt, cl)
    out = _torch_paged(q, kp, vp, bt, cl).numpy()
    np.testing.assert_allclose(out, ref, rtol=PAGED_TOL, atol=PAGED_TOL)
    # a context_len == 0 row is exactly zero on both sides
    empty = cl == 0
    assert np.all(out[empty] == 0.0) and np.all(ref[empty] == 0.0)
    assert np.abs(out[~empty]).sum() > 0


def test_paged_decode_bf16_pages_match_jax_bf16():
    q, kp, vp, bt, cl = _paged(4)
    bf = jnp.bfloat16
    with jax.default_device(_cpu()):
        ref = np.asarray(JA.paged_attention_reference(
            jnp.asarray(q, bf), jnp.asarray(kp, bf), jnp.asarray(vp, bf),
            jnp.asarray(bt), jnp.asarray(cl)).astype(jnp.float32))
    out = TA.paged_attention(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(kp).bfloat16(),
        torch.from_numpy(vp).bfloat16(), torch.from_numpy(bt),
        torch.from_numpy(cl))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_paged_garbage_slots_contribute_exactly_zero():
    """+-1e30 in every slot no live position reads changes nothing, on
    the port and on the JAX reference alike."""
    q, kp, vp, bt, cl = _paged(3)
    out = _torch_paged(q, kp, vp, bt, cl).numpy()
    bs = kp.shape[1]
    live = np.zeros(kp.shape[:2], bool)
    for b in range(q.shape[0]):
        for pos in range(int(cl[b])):
            live[bt[b, pos // bs], pos % bs] = True
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[~live] = 1e30
    vp2[~live] = -1e30
    np.testing.assert_array_equal(_torch_paged(q, kp2, vp2, bt, cl).numpy(),
                                  out)
    np.testing.assert_allclose(_jax_paged("reference", q, kp2, vp2, bt, cl),
                               out, rtol=PAGED_TOL, atol=PAGED_TOL)


# ------------------------------------------------- the kernels' shape gates
def _t(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("q,k,v", [
    (_t(1, 2, 8, 16), _t(1, 2, 8, 16), _t(1, 2, 8, 16, dtype=torch.float16)),
    (_t(1, 2, 8, 12), _t(1, 2, 8, 12), _t(1, 2, 8, 12)),        # D % 8
    (_t(1, 2, 8, 268), _t(1, 2, 8, 268), _t(1, 2, 8, 268)),     # D % 8 past 256
    (_t(1, 2, 8, 16), _t(1, 3, 8, 16), _t(1, 3, 8, 16)),        # heads
    (_t(2, 8, 16), _t(2, 8, 16), _t(2, 8, 16)),                 # rank
])
def test_flash_kernel_gate_rejects(q, k, v):
    with pytest.raises(MXNetError):
        TA._check_flash(q, k, v)


def test_flash_kernel_gate_accepts_serving_shapes():
    for s in (16, 32, 64, 128):
        TA._check_flash(_t(1, 4, s, 64), _t(1, 4, s, 64), _t(1, 4, s, 64))


@pytest.mark.parametrize("shape,dtype", [
    ((1, 2, 8, 64), torch.float16),
    ((1, 2, 8, 136), torch.float32),
    ((1, 2, 8, 256), torch.bfloat16),
    ((1, 2, 8, 8), torch.float16),
    ((70000, 1, 4, 8), torch.float32),   # b*h past the old 65535
])
def test_flash_kernel_gate_accepts_the_widened_envelope(shape, dtype):
    """float16, head_dim up to 256 and any b*h reach the kernels, as the
    JAX package computes them (its Pallas path asks only D % 8 == 0)."""
    x = _t(*shape, dtype=dtype)
    TA._check_flash(x, x, x)
    assert TA.FLASH_MAX_D == 256


@pytest.mark.parametrize("case", ["tables_i64", "lens_shape", "page_f16",
                                  "head_dim", "noncontig_q"])
def test_paged_kernel_gate_rejects(case):
    q, kp, vp = _t(2, 4, 64), _t(9, 16, 4, 64), _t(9, 16, 4, 64)
    bt, cl = _t(2, 8, dtype=torch.int32), _t(2, dtype=torch.int32)
    if case == "tables_i64":
        bt = bt.long()
    elif case == "lens_shape":
        cl = _t(3, dtype=torch.int32)
    elif case == "page_f16":   # f16 K beside f32 V: the pages share a dtype
        kp = kp.half()
    elif case == "head_dim":
        q, kp, vp = _t(2, 4, 60), _t(9, 16, 4, 60), _t(9, 16, 4, 60)
    else:
        q = _t(4, 2, 64).transpose(0, 1)
    with pytest.raises(MXNetError):
        TA._check_paged(q, kp, vp, bt, cl)
    if case == "tables_i64":
        TA._check_paged(q, kp, vp, bt.int(), cl)   # the int32 twin passes
    if case == "page_f16":
        TA._check_paged(q, kp, vp.half(), bt, cl)  # f16 pages pass


@pytest.mark.parametrize("d,bs,nb,dtype", [
    (8, 16, 8, torch.float32), (136, 16, 8, torch.float32),
    (512, 16, 8, torch.bfloat16), (4096, 16, 2, torch.float32),
    (64, 512, 3, torch.float32), (64, 16384, 1, torch.float16),
    (64, 1, 8200, torch.float32)])
def test_paged_kernel_gate_accepts_the_jax_envelope(d, bs, nb, dtype):
    """Every D % 8 == 0 (the JAX package's ``_paged_shapes_ok``), pool
    blocks past 256 and tables past 8192 slots, in f32/bf16/f16, reach
    both paged kernels (meta tensors: only the shapes are read)."""
    def z(*s, dt=dtype):
        return torch.zeros(s, dtype=dt, device="meta")
    TA._check_paged(z(2, 4, d), z(9, bs, 4, d), z(9, bs, 4, d),
                    z(2, nb, dt=torch.int32), z(2, dt=torch.int32))
    TA._check_paged_multi(z(2, 17, 4, d), z(9, bs, 4, d), z(9, bs, 4, d),
                          z(2, nb, dt=torch.int32), z(2, 17, dt=torch.int32))


@pytest.mark.parametrize("d,bs", [(4104, 16), (64, 16385), (60, 16)])
def test_paged_kernel_gate_rejects_past_shared_memory(d, bs):
    """Past what the kernels' shared memory holds (D 4104, pool blocks of
    16385), and off the JAX envelope (D 60), both gates raise."""
    def z(*s, dt=torch.float32):
        return torch.zeros(s, dtype=dt, device="meta")
    with pytest.raises(MXNetError, match="head_dim"):
        TA._check_paged(z(2, 4, d), z(9, bs, 4, d), z(9, bs, 4, d),
                        z(2, 8, dt=torch.int32), z(2, dt=torch.int32))
    with pytest.raises(MXNetError, match="head_dim"):
        TA._check_paged_multi(z(2, 3, 4, d), z(9, bs, 4, d), z(9, bs, 4, d),
                              z(2, 8, dt=torch.int32), z(2, 3, dt=torch.int32))


def test_non_cpu_non_cuda_device_raises():
    q = torch.zeros(1, 1, 4, 8, device="meta")
    with pytest.raises(MXNetError):
        TA.flash_attention_forward(q, q, q)
    with pytest.raises(MXNetError):
        TA.paged_attention(torch.zeros(1, 1, 8, device="meta"),
                           torch.zeros(2, 4, 1, 8, device="meta"),
                           torch.zeros(2, 4, 1, 8, device="meta"),
                           torch.zeros(1, 1, dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("offset", [0, 1, 3, 4])
def test_misaligned_kv_reach_the_kernels_as_aligned_copies(offset):
    """The kernels stage K/V with 16-byte copies: a tensor whose data does
    not start on 16 bytes is handed over as an equal, aligned copy."""
    base = torch.arange(80, dtype=torch.float32)
    x = base[offset:offset + 64].view(1, 1, 8, 8)
    y = TA._aligned16(x)
    assert y.data_ptr() % 16 == 0 and torch.equal(x, y)
    assert (y is x) == (x.data_ptr() % 16 == 0)


# ------------------------------------------------------- the kernel build
def _fake_nvcc(tmp_path, ok):
    """A stand-in compiler: writes the ``-o`` file (or fails loudly)."""
    path = tmp_path / "nvcc"
    body = ("import sys\nargs = sys.argv[1:]\n"
            + ("open(args[args.index('-o') + 1], 'w').write('lib')\n" if ok
               else "print('error: fake compile failure'); sys.exit(3)\n"))
    path.write_text("#!%s\n%s" % (sys.executable, body))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_compiles_each_source_for_sm90a(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(_build, "_nvcc",
                        lambda: _fake_nvcc(tmp_path, ok=True))
    kernels = list(_build.KERNELS.values())
    assert [k.name for k in kernels] == ["flash_fwd", "flash_bwd_dkv",
                                         "flash_bwd_dq", "flash_wide_fwd",
                                         "flash_wide_bwd_dkv",
                                         "flash_wide_bwd_dq", "paged_decode",
                                         "paged_decode_multi"]
    for k in kernels:
        assert os.path.exists(k.source)
        cmd = _build.nvcc_command(k.source, "x.so")
        assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
        assert not os.path.exists(k.library())
    _build.build()
    for k in kernels:
        assert os.path.exists(k.library())
        assert os.path.dirname(k.library()) == str(tmp_path / "out")
    _build.build()   # nothing missing: no compiler run, no error


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(_build, "_nvcc",
                        lambda: _fake_nvcc(tmp_path, ok=False))
    with pytest.raises(MXNetError, match="fake compile failure"):
        _build.build([_build.FLASH_FWD])
    assert _build.FLASH_FWD.launches == 0


def test_library_digest_covers_the_shared_header(tmp_path, monkeypatch):
    """An edit of ``csrc/paged_common.cuh`` rebuilds both paged kernels."""
    import shutil

    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    monkeypatch.setattr(_build, "CSRC", str(src))
    kernels = [_build.Kernel(n, []) for n in ("paged_decode",
                                              "paged_decode_multi")]
    before = [k.library() for k in kernels]
    header = src / "paged_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert all(k.library() != b for k, b in zip(kernels, before))
