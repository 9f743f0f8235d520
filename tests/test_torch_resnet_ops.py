"""Parity of the port's ResNet ops with the JAX package, on the CPU.

``Convolution``, ``Pooling``, ``BatchNorm``, ``Flatten`` and ``identity``:
the same numpy inputs (made from a seed) through the JAX op under
``jax.vjp`` and through the port's op under ``torch.autograd``, with one
seeded output gradient; forward outputs, input and parameter gradients,
BatchNorm's updated auxiliary states, and the ops' shape inference are
compared. Float32 on both sides, where only the summation order differs:
1e-5 absolute and relative unless a case says otherwise. bfloat16
BatchNorm: 2e-2 relative to the largest value against the float32 op on
the same bfloat16-rounded input (the outputs round to bfloat16, 8 bits,
at other places), and 5e-2 against the JAX package, whose gamma and beta
gradients are sums of 120 bfloat16 terms accumulated in bfloat16 (3.8e-2
from the float32 sum on this input, where the port's float32 accumulation
is 2.8e-3 from it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import registry as JR
from mxnet_tpu_torch.ops import registry as TR

TOL = 1e-5
BF16_REL = 2e-2
JAX_BF16_SUM_REL = 5e-2


def _cpu():
    return jax.devices("cpu")[0]


def _jax_run(op_name, raw, args, auxs, is_train, cot, dtype=np.float32):
    """(outputs, input/param grads, new auxs) of the JAX op as numpy."""
    op = JR.get_op(op_name)
    attrs, _ = op.canonicalize_attrs(raw)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else dtype
    with jax.default_device(_cpu()):
        jargs = [jnp.asarray(a).astype(jdt) if i == 0 else jnp.asarray(a)
                 for i, a in enumerate(args)]
        jauxs = [jnp.asarray(a) for a in auxs]

        def f(*a):
            outs, new_aux = op.forward(JR.OpContext(is_train=is_train), attrs,
                                       list(a), jauxs)
            return outs[0], (outs, new_aux)

        out, vjp, (outs, new_aux) = jax.vjp(f, *jargs, has_aux=True)
        grads = vjp(jnp.asarray(cot).astype(out.dtype))
    f32 = lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32))  # noqa: E731
    return ([f32(o) for o in outs], [f32(g) for g in grads],
            [f32(a) for a in new_aux])


def _torch_run(op_name, raw, args, auxs, is_train, cot, dtype=np.float32):
    op = TR.get_op(op_name)
    attrs, _ = op.canonicalize_attrs(raw)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    targs = [torch.from_numpy(np.array(a)).to(tdt if i == 0 else torch.float32)
             .requires_grad_(True) for i, a in enumerate(args)]
    tauxs = [torch.from_numpy(np.array(a)) for a in auxs]
    outs, new_aux = op.forward(TR.OpContext(is_train=is_train), attrs, targs,
                               tauxs)
    grads = torch.autograd.grad(outs[0], targs,
                                torch.from_numpy(cot).to(outs[0].dtype),
                                allow_unused=True)
    grads = [torch.zeros_like(a) if g is None else g
             for a, g in zip(targs, grads)]
    f32 = lambda x: x.detach().float().numpy()  # noqa: E731
    return ([f32(o) for o in outs], [f32(g) for g in grads],
            [f32(a) for a in new_aux])


def _close(got, want, tol=TOL, rel_to_max=False, what=""):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (what, i, a.shape, b.shape)
        if rel_to_max:
            err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
            assert err <= tol, (what, i, err)
        else:
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                       err_msg="%s %d" % (what, i))


def _infer_both(op_name, raw, in_shapes, aux_shapes=()):
    res = []
    for reg in (JR, TR):
        op = reg.get_op(op_name)
        attrs, _ = op.canonicalize_attrs(raw)
        a, o, x = op.infer_shape(attrs, list(in_shapes), list(aux_shapes))
        res.append(([tuple(s) for s in a], [tuple(s) for s in o],
                    [tuple(s) for s in x]))
    return res


# ---------------------------------------------------------------- Convolution
CONV_CASES = {
    "3x3_stride2_pad1_bias": ((2, 3, 9, 9), dict(kernel=(3, 3), stride=(2, 2),
                                                pad=(1, 1), num_filter=4)),
    "dilate2_nobias": ((2, 3, 11, 10), dict(kernel=(3, 3), dilate=(2, 2),
                                            pad=(2, 1), num_filter=5,
                                            no_bias=True)),
    "groups2": ((2, 4, 8, 8), dict(kernel=(3, 3), pad=(1, 1), num_filter=6,
                                   num_group=2)),
    "1x1_stride2_nobias": ((3, 8, 7, 7), dict(kernel=(1, 1), stride=(2, 2),
                                              num_filter=16, no_bias=True)),
    "7x7_stem": ((1, 3, 20, 20), dict(kernel=(7, 7), stride=(2, 2),
                                      pad=(3, 3), num_filter=8,
                                      no_bias=True)),
    "nhwc": ((2, 9, 9, 3), dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                num_filter=4, layout="NHWC")),
    "nhwc_groups": ((2, 8, 8, 4), dict(kernel=(3, 3), pad=(1, 1),
                                       num_filter=4, num_group=2,
                                       layout="NHWC", no_bias=True)),
    "1d": ((2, 3, 17), dict(kernel=(5,), stride=(2,), pad=(2,),
                            num_filter=4)),
    "3d": ((1, 2, 5, 6, 6), dict(kernel=(3, 3, 3), pad=(1, 1, 1),
                                 dilate=(1, 2, 1), num_filter=3)),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution_matches_jax(case):
    """Forward, data/weight/bias gradients and shape inference."""
    dshape, raw = CONV_CASES[case]
    (in_shapes, out_shapes, _), t_inf = _infer_both("Convolution", raw,
                                                    [dshape, None, None])
    assert t_inf[:2] == (in_shapes, out_shapes)
    rng = np.random.RandomState(len(case))
    args = [rng.randn(*s).astype(np.float32) for s in in_shapes]
    cot = rng.randn(*out_shapes[0]).astype(np.float32)
    j = _jax_run("Convolution", raw, args, [], True, cot)
    t = _torch_run("Convolution", raw, args, [], True, cot)
    _close(t[0], j[0], what="out")
    _close(t[1], j[1], tol=1e-4, what="grads")


# ---------------------------------------------------------------- Pooling
POOL_CASES = {
    "max_valid": ((2, 3, 9, 9), dict(kernel=(3, 3), stride=(2, 2),
                                     pool_type="max")),
    "max_valid_pad": ((2, 3, 8, 8), dict(kernel=(3, 3), stride=(2, 2),
                                         pad=(1, 1), pool_type="max")),
    "max_full_pad": ((2, 3, 8, 8), dict(kernel=(3, 3), stride=(2, 2),
                                        pad=(1, 1), pool_type="max",
                                        pooling_convention="full")),
    "avg_valid_pad": ((2, 3, 8, 8), dict(kernel=(3, 3), stride=(2, 2),
                                         pad=(1, 1), pool_type="avg")),
    "avg_full": ((2, 3, 8, 8), dict(kernel=(3, 3), stride=(2, 2),
                                    pool_type="avg",
                                    pooling_convention="full")),
    "avg_full_pad": ((1, 2, 10, 9), dict(kernel=(4, 3), stride=(3, 2),
                                         pad=(1, 1), pool_type="avg",
                                         pooling_convention="full")),
    "sum_valid_pad": ((2, 3, 8, 8), dict(kernel=(2, 2), stride=(2, 2),
                                         pad=(1, 1), pool_type="sum")),
    "sum_full": ((2, 3, 7, 7), dict(kernel=(2, 2), stride=(2, 2),
                                    pool_type="sum",
                                    pooling_convention="full")),
    "global_avg": ((2, 4, 7, 7), dict(kernel=(3, 3), global_pool=True,
                                      pool_type="avg")),
    "global_max": ((2, 4, 5, 6), dict(kernel=(1, 1), global_pool=True,
                                      pool_type="max")),
    "global_sum": ((2, 4, 5, 6), dict(kernel=(1, 1), global_pool=True,
                                      pool_type="sum")),
    "nhwc_avg_pad": ((2, 8, 8, 3), dict(kernel=(3, 3), stride=(2, 2),
                                        pad=(1, 1), pool_type="avg",
                                        layout="NHWC")),
    "nhwc_global_avg": ((2, 7, 7, 3), dict(kernel=(7, 7), global_pool=True,
                                           pool_type="avg", layout="NHWC")),
    "1d_avg_pad": ((2, 3, 11), dict(kernel=(3,), stride=(2,), pad=(1,),
                                    pool_type="avg")),
    "3d_max": ((1, 2, 5, 6, 6), dict(kernel=(2, 2, 2), stride=(2, 2, 2),
                                     pool_type="max",
                                     pooling_convention="full")),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling_matches_jax(case):
    """Forward, input gradient and shape inference. The input has distinct
    values, so max pooling has no ties to route a gradient differently."""
    dshape, raw = POOL_CASES[case]
    (in_shapes, out_shapes, _), t_inf = _infer_both("Pooling", raw, [dshape])
    assert t_inf[:2] == (in_shapes, out_shapes)
    rng = np.random.RandomState(len(case) + 7)
    x = rng.permutation(np.prod(dshape)).reshape(dshape).astype(np.float32)
    x = x / x.size - 0.5
    cot = rng.randn(*out_shapes[0]).astype(np.float32)
    j = _jax_run("Pooling", raw, [x], [], True, cot)
    t = _torch_run("Pooling", raw, [x], [], True, cot)
    assert t[0][0].shape == out_shapes[0]
    _close(t[0], j[0], what="out")
    _close(t[1], j[1], what="grad")


# ---------------------------------------------------------------- BatchNorm
BN_CASES = {
    "train_resnet_unit": (dict(fix_gamma=False, eps=2e-5, momentum=0.9),
                          True, 1),
    "train_fix_gamma": (dict(), True, 1),
    "train_output_mean_var": (dict(fix_gamma=False, output_mean_var=True),
                              True, 1),
    "use_global_stats": (dict(fix_gamma=False, use_global_stats=True),
                         True, 1),
    "eval": (dict(fix_gamma=False), False, 1),
    "axis3_nhwc": (dict(fix_gamma=False, axis=3, eps=2e-5), True, 3),
    "momentum_0.5": (dict(fix_gamma=False, momentum=0.5), True, 1),
}


def _bn_inputs(axis, seed, shape=(4, 3, 5, 6)):
    rng = np.random.RandomState(seed)
    if axis == 3:
        shape = (shape[0], shape[2], shape[3], shape[1])
    c = shape[axis]
    x = (rng.randn(*shape) * 2 + 1.5).astype(np.float32)
    gamma = (rng.rand(c) + 0.5).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    mmean = rng.randn(c).astype(np.float32)
    mvar = (rng.rand(c) + 0.5).astype(np.float32)
    return x, gamma, beta, mmean, mvar


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batchnorm_matches_jax(case):
    """Outputs (with the batch mean and variance), data/gamma/beta
    gradients (gamma's is 0 under fix_gamma on both sides) and the two
    updated auxiliary states."""
    raw, is_train, axis = BN_CASES[case]
    x, gamma, beta, mmean, mvar = _bn_inputs(axis, len(case))
    cot = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    j = _jax_run("BatchNorm", raw, [x, gamma, beta], [mmean, mvar], is_train,
                 cot)
    t = _torch_run("BatchNorm", raw, [x, gamma, beta], [mmean, mvar],
                   is_train, cot)
    _close(t[0], j[0], what="outputs")
    _close(t[1], j[1], tol=1e-4, what="grads")
    _close(t[2], j[2], what="aux")
    if raw.get("fix_gamma", True):
        assert not np.abs(t[1][1]).any()
    if not is_train or raw.get("use_global_stats"):
        _close(t[2], [mmean, mvar], tol=0, what="aux unchanged")
    (in_shapes, out_shapes, aux_shapes), t_inf = _infer_both(
        "BatchNorm", raw, [x.shape, None, None], [None, None])
    assert t_inf == (in_shapes, out_shapes, aux_shapes)


@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batchnorm_bf16_input_matches_jax(fix_gamma):
    """bfloat16 data, float32 gamma/beta/aux: output in bfloat16 and
    float32 aux states on both sides."""
    raw = dict(fix_gamma=fix_gamma, eps=2e-5)
    x, gamma, beta, mmean, mvar = _bn_inputs(1, 3)
    cot = np.random.RandomState(6).randn(*x.shape).astype(np.float32)
    j = _jax_run("BatchNorm", raw, [x, gamma, beta], [mmean, mvar], True, cot,
                 dtype="bfloat16")
    t = _torch_run("BatchNorm", raw, [x, gamma, beta], [mmean, mvar], True,
                   cot, dtype="bfloat16")
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    r = _torch_run("BatchNorm", raw, [xb, gamma, beta], [mmean, mvar], True,
                   cot)
    _close(t[0][:1], r[0][:1], tol=BF16_REL, rel_to_max=True, what="out")
    _close(t[1], r[1], tol=BF16_REL, rel_to_max=True, what="grads")
    _close(t[0][:1], j[0][:1], tol=BF16_REL, rel_to_max=True, what="out")
    _close(t[1], j[1], tol=JAX_BF16_SUM_REL, rel_to_max=True, what="grads")
    # statistics are float32 on both sides: the same bf16 values in
    _close(t[2], j[2], tol=TOL, what="aux")
    _close(t[2], r[2], tol=TOL, what="aux")
    op = TR.get_op("BatchNorm")
    attrs, _ = op.canonicalize_attrs(raw)
    outs, auxs = op.forward(TR.OpContext(is_train=True), attrs,
                            [torch.from_numpy(x).bfloat16(),
                             torch.from_numpy(gamma), torch.from_numpy(beta)],
                            [torch.from_numpy(mmean), torch.from_numpy(mvar)])
    assert outs[0].dtype == torch.bfloat16
    assert all(a.dtype == torch.float32 for a in auxs)


# ------------------------------------------------------- Flatten, identity
@pytest.mark.parametrize("op_name", ["Flatten", "flatten", "_copy",
                                     "identity"])
def test_flatten_and_identity_match_jax(op_name):
    x = np.random.RandomState(2).randn(3, 4, 2, 5).astype(np.float32)
    out_shape = (3, 40) if op_name.lower() == "flatten" else x.shape
    cot = np.random.RandomState(3).randn(*out_shape).astype(np.float32)
    j = _jax_run(op_name, {}, [x], [], True, cot)
    t = _torch_run(op_name, {}, [x], [], True, cot)
    assert t[0][0].shape == out_shape
    _close(t[0], j[0], tol=0, what="out")
    _close(t[1], j[1], tol=0, what="grad")
