"""Test utilities of the port: the operator sweep.

:func:`op_cases` gives one seeded case for every registered op name
(aliases run their op's case under their own name) and a few variants
(``"Pad[constant]"``); :func:`run_case` builds ``mx.sym.<name>`` of a
case, ``simple_bind``\\ s it on a context, feeds the case's inputs,
runs ``forward(is_train=...)`` and ``backward`` with the case's seeded
head gradient, and returns numpy outputs, input gradients and aux
states. It takes the package as an argument and reaches it only
through ``mx.sym``/``mx.nd``, so the same case runs through the JAX
package and the port (the CPU tests) or through the port on the card and
on the CPU (``chip_smoke.py``).

Inputs keep each op in its domain (``arccosh`` above 1, ``log`` above 0,
no ``gamma`` pole), away from a rounding op's .5 boundaries, and integer
valued where ties and indices matter; ``scatter_nd`` gets unique
indices. ``kind`` says how a case is held: ``"smooth"`` to a relative
tolerance, ``"exact"`` bit for bit (comparisons, rounding, indexing,
ordering and integer-valued results), ``"random"`` by shape and
finiteness only (samplers draw from each device's own generator).
"""
from __future__ import annotations

import zlib

import numpy as np

__all__ = ["Case", "op_cases", "run_case"]


class Case:
    """One sweep case: the op ``name``, its ``attrs``, its input arrays
    (arguments then aux states, in the op's order), how it is held
    (``kind``), whether its forward runs in training mode (``train``) and
    whether it has a gradient to compare (``grad``)."""

    __slots__ = ("name", "attrs", "inputs", "kind", "train", "grad")

    def __init__(self, name, attrs, inputs, kind="smooth", train=True, grad=True):
        self.name, self.attrs, self.inputs = name, attrs, inputs
        self.kind, self.train, self.grad = kind, train, grad


def _rng(key):
    return np.random.RandomState(zlib.crc32(key.encode()) & 0x7FFFFFFF)


def _f(a):
    return np.asarray(a, dtype=np.float32)


def _off_half(r, shape, lo=-3, hi=3):
    """Values at least 0.1 from any multiple of 0.5 (rounding inputs)."""
    k = r.randint(lo, hi, shape)
    frac = r.choice([0.15, 0.3, 0.65, 0.85], shape) + r.uniform(-0.04, 0.04, shape)
    return _f(k + frac)


def _ints(r, shape, lo=-2, hi=3):
    return _f(r.randint(lo, hi, shape))


def _specs():
    """name -> (attrs, inputs(rng), kind, train, grad)."""
    N = lambda r, *s: _f(r.standard_normal(s))            # noqa: E731
    U = lambda r, lo, hi, *s: _f(r.uniform(lo, hi, s))     # noqa: E731
    S = {}

    def add(name, attrs, inputs, kind="smooth", train=True, grad=True):
        S[name] = (attrs, inputs, kind, train, grad)

    sh = (3, 4)
    # ---- unary maths
    for name in ("exp", "expm1", "sin", "cos", "arctan", "sinh", "cosh",
                 "tanh", "sigmoid", "softsign", "erf", "negative", "square",
                 "degrees", "radians", "arcsinh", "relu", "_copy",
                 "_CrossDeviceCopy", "BlockGrad"):
        add(name, {}, lambda r: [N(r, *sh)])
    add("tan", {}, lambda r: [U(r, -1.2, 1.2, *sh)])
    add("abs", {}, lambda r: [_f(N(r, *sh) + np.sign(N(r, *sh)) * 0.1)])
    for name in ("cbrt", "rcbrt"):
        add(name, {}, lambda r: [_f(U(r, 0.3, 2.0, *sh) * np.sign(N(r, *sh)))])
    for name in ("log", "log10", "log2", "sqrt", "rsqrt", "reciprocal",
                 "gammaln", "gamma"):
        add(name, {}, lambda r: [U(r, 0.5, 3.0, *sh)])
    add("log1p", {}, lambda r: [U(r, -0.5, 2.0, *sh)])
    for name in ("arcsin", "arccos", "arctanh"):
        add(name, {}, lambda r: [U(r, -0.9, 0.9, *sh)])
    add("arccosh", {}, lambda r: [U(r, 1.1, 3.0, *sh)])
    for name in ("round", "rint", "ceil", "floor", "trunc", "fix", "sign"):
        add(name, {}, lambda r: [_off_half(r, sh)], kind="exact")
    add("logical_not", {}, lambda r: [_ints(r, sh, -1, 2)], kind="exact")
    add("smooth_l1", {"scalar": 2.0},
        lambda r: [_f(U(r, 0.05, 0.2, *sh) * np.sign(N(r, *sh)) * r.choice([1, 3], sh))])
    add("clip", {"a_min": -0.5, "a_max": 0.5}, lambda r: [N(r, *sh)])
    add("Cast", {"dtype": "float16"}, lambda r: [N(r, *sh)], kind="exact")

    # ---- binary, broadcast and scalar families
    two = lambda r: [N(r, *sh), N(r, *sh)]                  # noqa: E731
    for name in ("elemwise_add", "elemwise_sub", "elemwise_mul", "_maximum",
                 "_minimum", "_hypot", "_grad_add",
                 "_identity_with_attr_like_rhs"):
        add(name, {}, two)
    add("elemwise_div", {}, lambda r: [N(r, *sh), U(r, 0.5, 2.0, *sh)])
    add("_power", {}, lambda r: [U(r, 0.5, 2.0, *sh), U(r, -1.0, 2.0, *sh)])
    add("_mod", {}, lambda r: [_f(3 * N(r, *sh)),
                               _f(U(r, 0.5, 2.0, *sh) * np.sign(N(r, *sh)))])
    for name in ("equal", "not_equal", "greater", "greater_equal", "lesser",
                 "lesser_equal"):
        add("_" + name, {}, lambda r: [_ints(r, sh), _ints(r, sh)], kind="exact")
        add("broadcast_" + name, {},
            lambda r: [_ints(r, (2, 3, 4)), _ints(r, (1, 3, 1))], kind="exact")
        add("_%s_scalar" % name, {"scalar": 0.0}, lambda r: [_ints(r, sh)],
            kind="exact")
    bc = lambda r: [N(r, 2, 3, 4), N(r, 1, 3, 1)]            # noqa: E731
    for name in ("broadcast_add", "broadcast_sub", "broadcast_minus",
                 "broadcast_plus", "broadcast_mul", "broadcast_maximum",
                 "broadcast_minimum", "broadcast_hypot"):
        add(name, {}, bc)
    add("broadcast_div", {}, lambda r: [N(r, 2, 3, 4), U(r, 0.5, 2.0, 1, 3, 1)])
    add("broadcast_power", {},
        lambda r: [U(r, 0.5, 2.0, 2, 3, 4), U(r, -1.0, 2.0, 1, 3, 1)])
    add("broadcast_mod", {}, lambda r: [_f(3 * N(r, 2, 3, 4)),
                                        _f(-U(r, 0.5, 2.0, 1, 3, 1))])
    for name, s in (("_plus_scalar", 1.5), ("_minus_scalar", 1.5),
                    ("_rminus_scalar", 1.5), ("_mul_scalar", -2.5),
                    ("_div_scalar", 4.0), ("_maximum_scalar", 0.3),
                    ("_minimum_scalar", 0.3), ("_hypot_scalar", 1.5),
                    ("_rpower_scalar", 2.0)):
        add(name, {"scalar": s}, lambda r: [N(r, *sh)])
    add("_rdiv_scalar", {"scalar": 3.0}, lambda r: [U(r, 0.5, 2.0, *sh)])
    add("_power_scalar", {"scalar": 2.5}, lambda r: [U(r, 0.5, 2.0, *sh)])
    add("_mod_scalar", {"scalar": 1.5}, lambda r: [_f(3 * N(r, *sh))])
    add("_rmod_scalar", {"scalar": 2.5},
        lambda r: [_f(U(r, 0.7, 2.0, *sh) * np.sign(N(r, *sh)))])
    add("add_n", {"num_args": 3}, lambda r: [N(r, *sh), N(r, *sh), N(r, *sh)])
    add("_NoGradient", {}, lambda r: [], grad=False)

    # ---- matrix
    add("transpose", {"axes": (1, 0, 2)}, lambda r: [N(r, 2, 3, 4)])
    add("dot", {}, lambda r: [N(r, 2, 3, 4), N(r, 4, 5)])
    add("batch_dot", {"transpose_b": True}, lambda r: [N(r, 2, 3, 4), N(r, 2, 5, 4)])
    add("slice", {"begin": (0, None, 1), "end": (2, None, 3)},
        lambda r: [N(r, 3, 4, 5)])
    add("slice_axis", {"axis": 1, "begin": 1, "end": None}, lambda r: [N(r, 3, 4, 5)])
    add("_slice_assign", {"begin": (1, 1), "end": (3, 3)},
        lambda r: [N(r, 3, 4), N(r, 2, 2)])
    add("_crop_assign_scalar", {"begin": (0, 1), "end": (2, 3), "scalar": 5.0},
        lambda r: [N(r, 3, 4)])
    add("Crop", {"num_args": 1, "h_w": (2, 3), "offset": (1, 1)},
        lambda r: [N(r, 1, 2, 4, 5)])
    add("Pad", {"mode": "reflect", "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)},
        lambda r: [N(r, 1, 2, 4, 5)])
    add("pad", {"mode": "edge", "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)},
        lambda r: [N(r, 1, 2, 4, 5)])
    add("reverse", {"axis": (0, 2)}, lambda r: [N(r, 2, 3, 4)])
    add("repeat", {"repeats": 2, "axis": 1}, lambda r: [N(r, 2, 3)])
    add("tile", {"reps": (2, 1, 2)}, lambda r: [N(r, 2, 3)])
    add("stack", {"num_args": 3, "axis": 1}, lambda r: [N(r, 2, 3)] * 1
        + [N(r, 2, 3), N(r, 2, 3)])
    add("squeeze", {}, lambda r: [N(r, 2, 1, 3, 1)])
    add("where", {}, lambda r: [_ints(r, sh, 0, 2), N(r, *sh), N(r, *sh)])
    add("Reshape", {"shape": (0, -1)}, lambda r: [N(r, 2, 3, 4)])
    add("Flatten", {}, lambda r: [N(r, 2, 3, 4)])
    add("expand_dims", {"axis": 1}, lambda r: [N(r, 2, 3)])
    add("SwapAxis", {"dim1": 0, "dim2": 2}, lambda r: [N(r, 2, 3, 4)])
    add("Concat", {"num_args": 2, "dim": 1}, lambda r: [N(r, 2, 3), N(r, 2, 4)])
    add("SliceChannel", {"num_outputs": 2, "axis": 1}, lambda r: [N(r, 2, 4, 3)])

    # ---- reductions
    add("sum", {"axis": (1,), "keepdims": True}, lambda r: [N(r, 2, 3, 4)])
    add("mean", {"axis": (0, 2)}, lambda r: [N(r, 2, 3, 4)])
    add("prod", {"axis": (0, 2)}, lambda r: [U(r, 0.5, 1.5, 2, 3, 4)])
    add("max", {"axis": (1,)}, lambda r: [N(r, 2, 3, 4)])
    add("min", {"axis": (0, 2), "keepdims": True}, lambda r: [N(r, 2, 3, 4)])

    def _nan(r):
        x = N(r, 2, 3, 4)
        x[0, 1, 2] = x[1, 2, 0] = np.nan
        return [x]

    add("nansum", {"axis": (1,)}, _nan)
    add("nanprod", {"axis": (2,)}, lambda r: [_f(np.where(
        np.isnan(_nan(r)[0]), np.nan, U(r, 0.5, 1.5, 2, 3, 4)))])
    add("norm", {"axis": (1,), "keepdims": True}, lambda r: [N(r, 2, 3, 4)])
    add("argmax", {"axis": (1,)}, lambda r: [_ints(r, (2, 5, 3))], kind="exact")
    add("argmin", {"axis": (2,), "keepdims": True}, lambda r: [_ints(r, (2, 3, 5))],
        kind="exact")
    add("argmax_channel", {}, lambda r: [_ints(r, (4, 5))], kind="exact")
    add("broadcast_to", {"shape": (2, 0, 4)}, lambda r: [N(r, 1, 3, 1)])
    add("broadcast_axis", {"axis": (0, 2), "size": (2, 4)}, lambda r: [N(r, 1, 3, 1)])

    # ---- indexing
    add("batch_take", {}, lambda r: [N(r, 4, 5), _f(r.randint(0, 5, 4))])
    add("one_hot", {"depth": 5}, lambda r: [_f([[0, 4, -1], [5, 2, 2]])],
        kind="exact", grad=False)
    add("pick", {"axis": 1}, lambda r: [N(r, 3, 4, 5), _f(r.randint(0, 4, (3, 5)))])
    add("fill_element_0index", {},
        lambda r: [N(r, 3, 4), N(r, 3), _f(r.randint(0, 4, 3))])
    add("gather_nd", {}, lambda r: [N(r, 3, 4, 5),
                                    _f([r.randint(0, 3, 6), r.randint(0, 4, 6)])])

    def _scatter(r):
        flat = r.choice(12, 6, replace=False)
        return [N(r, 6), _f([flat // 4, flat % 4])]

    add("scatter_nd", {"shape": (3, 4)}, _scatter)
    add("Embedding", {"input_dim": 10, "output_dim": 4},
        lambda r: [_f(r.randint(0, 10, (2, 3))), N(r, 10, 4)])
    add("take", {}, lambda r: [N(r, 5, 3), _f(r.randint(-1, 7, (2, 2)))])

    # ---- ordering (ties from integer values)
    add("topk", {"k": 3, "ret_typ": "both"}, lambda r: [_ints(r, (3, 6))], kind="exact")
    add("sort", {"axis": 1, "is_ascend": False}, lambda r: [_ints(r, (3, 6))],
        kind="exact")
    add("argsort", {"is_ascend": False}, lambda r: [_ints(r, (3, 6))], kind="exact")

    # ---- layers
    add("Deconvolution", {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                          "adj": (1, 1), "num_filter": 4},
        lambda r: [N(r, 2, 3, 4, 4), N(r, 3, 4, 3, 3), N(r, 4)])
    add("InstanceNorm", {}, lambda r: [N(r, 2, 3, 4, 5), N(r, 3), N(r, 3)])
    add("L2Normalization", {}, lambda r: [N(r, 2, 3, 4)])
    add("SoftmaxActivation", {}, lambda r: [N(r, 2, 3, 4)])
    add("UpSampling", {"scale": 2, "sample_type": "nearest", "num_args": 1},
        lambda r: [N(r, 2, 3, 3, 4)])
    seq = lambda r: [N(r, 5, 3, 4), _f([2, 5, 1])]           # noqa: E731
    add("SequenceMask", {"use_sequence_length": True, "value": -1.0}, seq)
    add("SequenceLast", {"use_sequence_length": True}, seq)
    add("SequenceReverse", {"use_sequence_length": True}, seq)
    add("Activation", {"act_type": "tanh"}, lambda r: [N(r, *sh)])
    add("FullyConnected", {"num_hidden": 5},
        lambda r: [N(r, 3, 4), N(r, 5, 4), N(r, 5)])
    add("Convolution", {"kernel": (3, 3), "pad": (1, 1), "num_filter": 4},
        lambda r: [N(r, 2, 3, 5, 5), N(r, 4, 3, 3, 3), N(r, 4)])
    add("Pooling", {"kernel": (2, 2), "stride": (2, 2), "pool_type": "max"},
        lambda r: [N(r, 2, 3, 4, 4)])
    add("BatchNorm", {"fix_gamma": False},
        lambda r: [N(r, 4, 3, 2, 2), U(r, 0.5, 1.5, 3), N(r, 3),
                   N(r, 3), U(r, 0.5, 1.5, 3)])
    add("LeakyReLU", {"act_type": "leaky", "slope": 0.2}, lambda r: [N(r, *sh)])
    add("LRN", {"nsize": 3}, lambda r: [N(r, 2, 5, 3, 3)])
    add("softmax", {"axis": 1}, lambda r: [N(r, 3, 5)])
    add("log_softmax", {"axis": -1}, lambda r: [N(r, 3, 5)])
    add("ones_like", {}, lambda r: [N(r, *sh)])
    add("zeros_like", {}, lambda r: [N(r, *sh)])
    add("Dropout", {"p": 0.5}, lambda r: [N(r, 4, 6)], kind="random")
    add("RNN", {"state_size": 4, "num_layers": 1, "mode": "lstm"},
        lambda r: [N(r, 5, 2, 3), _f(0.3 * r.standard_normal(4 * 4 * (3 + 4) + 2 * 4 * 4)),
                   N(r, 1, 2, 4), N(r, 1, 2, 4)])

    # ---- loss heads
    add("LinearRegressionOutput", {}, lambda r: [N(r, 4, 3), N(r, 4, 3)])
    add("MAERegressionOutput", {}, lambda r: [N(r, 4, 3), N(r, 4, 3)])
    add("LogisticRegressionOutput", {"grad_scale": 2.0},
        lambda r: [N(r, 4, 1), _f(r.randint(0, 2, 4))])
    add("SVMOutput", {"margin": 1.0}, lambda r: [N(r, 4, 5), _f(r.randint(0, 5, 4))])
    add("MakeLoss", {"normalization": "valid", "valid_thresh": 0.1},
        lambda r: [N(r, 4, 3)])
    add("softmax_cross_entropy", {}, lambda r: [N(r, 4, 5), _f(r.randint(0, 5, 4))])
    add("SoftmaxOutput", {}, lambda r: [N(r, 4, 5), _f(r.randint(0, 5, 4))])

    # ---- creation
    add("_arange", {"start": 1.0, "stop": 7.0, "step": 1.5, "repeat": 2},
        lambda r: [], kind="exact", grad=False)
    add("_zeros", {"shape": (2, 3)}, lambda r: [], kind="exact", grad=False)
    add("_ones", {"shape": (2, 3)}, lambda r: [], kind="exact", grad=False)
    add("_full", {"shape": (2, 3), "value": 2.5}, lambda r: [], kind="exact",
        grad=False)

    # ---- optimizer updates (the visible output: the new weight)
    upd = {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 1.0}
    add("sgd_update", dict(upd), lambda r: [N(r, *sh), N(r, *sh)])
    add("sgd_mom_update", dict(upd, momentum=0.9),
        lambda r: [N(r, *sh), N(r, *sh), N(r, *sh)])
    add("adam_update", dict(upd), lambda r: [N(r, *sh), N(r, *sh), N(r, *sh),
                                             U(r, 0.1, 1.0, *sh)])
    add("rmsprop_update", dict(upd), lambda r: [N(r, *sh), N(r, *sh),
                                                U(r, 0.1, 1.0, *sh)])
    add("rmspropalex_update", dict(upd),
        lambda r: [N(r, *sh), N(r, *sh), U(r, 1.0, 2.0, *sh),
                   _f(0.1 * N(r, *sh)), N(r, *sh)])

    # ---- spatial
    add("ROIPooling", {"pooled_size": (2, 2), "spatial_scale": 0.5},
        lambda r: [N(r, 2, 3, 8, 8),
                   _f([[0, 1, 2, 9, 11], [1, 0, 0, 15, 15], [1, 4, 6, 7, 13]])])
    add("BilinearSampler", {}, lambda r: [N(r, 2, 3, 5, 6), U(r, -1.15, 1.15, 2, 2, 4, 4)])
    add("GridGenerator", {"transform_type": "affine", "target_shape": (4, 5)},
        lambda r: [_f([1, 0, 0, 0, 1, 0] + 0.2 * r.standard_normal((2, 6)))])
    add("SpatialTransformer", {"target_shape": (4, 4)},
        lambda r: [N(r, 2, 3, 5, 6),
                   _f([1, 0, 0, 0, 1, 0] + 0.2 * r.standard_normal((2, 6)))])
    add("Correlation", {"kernel_size": 3, "max_displacement": 1, "pad_size": 1},
        lambda r: [N(r, 2, 3, 6, 6), N(r, 2, 3, 6, 6)])
    add("IdentityAttachKLSparseReg", {},
        lambda r: [U(r, 0.1, 0.9, 4, 3), _f([0.5, 0.4, 0.6])])

    # ---- attention (the port's kernels on the card)
    add("_contrib_FlashAttention", {"causal": True},
        lambda r: [N(r, 2, 2, 16, 8), N(r, 2, 2, 16, 8), N(r, 2, 2, 16, 8)])
    add("_contrib_MultiHeadAttention", {"num_heads": 2},
        lambda r: [N(r, 2, 16, 16), _f(0.2 * r.standard_normal((48, 16))),
                   _f(0.2 * r.standard_normal((16, 16)))])
    add("_contrib_CachedMultiHeadAttention", {"num_heads": 2, "max_len": 8},
        lambda r: [N(r, 2, 1, 16), _f(0.2 * r.standard_normal((48, 16))),
                   _f(0.2 * r.standard_normal((16, 16))), _f([3]),
                   N(r, 2, 2, 8, 8), N(r, 2, 2, 8, 8)], train=False)
    add("_contrib_PagedAttention", {},
        lambda r: [N(r, 2, 2, 8), N(r, 6, 16, 2, 8), N(r, 6, 16, 2, 8),
                   _f([[0, 3, 5], [1, 2, 4]]), _f([40, 17])], grad=False)

    # ---- samplers (each device's own generator: shapes only)
    for name in ("_random_uniform", "_random_normal", "_random_gamma",
                 "_random_exponential", "_random_poisson",
                 "_random_negative_binomial", "_random_randint"):
        attrs = {"shape": (3, 4)}
        if name == "_random_randint":
            attrs.update(low=0, high=10)
        add(name, attrs, lambda r: [], kind="random", grad=False)
    add("_sample_uniform", {"shape": (2,)}, lambda r: [_f([0, 1]), _f([1, 3])],
        kind="random", grad=False)
    add("_sample_normal", {"shape": (2,)}, lambda r: [_f([0, 1]), _f([1, 3])],
        kind="random", grad=False)
    add("_sample_gamma", {"shape": (2,)}, lambda r: [_f([1, 2]), _f([1, 3])],
        kind="random", grad=False)
    add("_sample_negative_binomial", {"shape": (2,)},
        lambda r: [_f([1, 2]), _f([0.3, 0.6])], kind="random", grad=False)
    for name in ("_sample_exponential", "_sample_poisson"):
        add(name, {"shape": (2,)}, lambda r: [_f([1, 3])], kind="random", grad=False)
    add("_sample_multinomial", {"shape": (3,)},
        lambda r: [_f([[0.2, 0.3, 0.5], [0.6, 0.2, 0.2]])], kind="random", grad=False)
    return S


#: extra cases beside the one per name: other modes of the same ops
#: (a third element False: no gradient to compare)
_VARIANTS = {
    "Pad[constant]": ("Pad", {"mode": "constant", "constant_value": 1.5,
                              "pad_width": (0, 0, 1, 0, 2, 1, 1, 3)}),
    "Deconvolution[groups,dilate]": ("Deconvolution", {
        "kernel": (3, 3), "stride": (2, 2), "dilate": (2, 2), "pad": (2, 1),
        "num_group": 3, "num_filter": 6, "no_bias": True}),
    "Deconvolution[adj>=stride]": ("Deconvolution", {
        "kernel": (3, 3), "adj": (1, 1), "pad": (1, 1), "num_filter": 4,
        "no_bias": True}),
    "L2Normalization[channel]": ("L2Normalization", {"mode": "channel"}),
    "L2Normalization[spatial]": ("L2Normalization", {"mode": "spatial"}),
    "SoftmaxActivation[channel]": ("SoftmaxActivation", {"mode": "channel"}),
    "UpSampling[bilinear]": ("UpSampling", {"scale": 2, "sample_type": "bilinear",
                                            "num_filter": 3}),
    "UpSampling[nearest,sum]": ("UpSampling", {"scale": 2, "num_args": 2,
                                               "multi_input_mode": "sum"}),
    "topk[mask]": ("topk", {"k": 2, "ret_typ": "mask"}),
    "topk[value,ascend]": ("topk", {"k": 4, "ret_typ": "value", "is_ascend": True}),
    "topk[axis=None]": ("topk", {"k": 5, "axis": None}),
    "GridGenerator[warp]": ("GridGenerator", {"transform_type": "warp"}),
    "MakeLoss[batch]": ("MakeLoss", {"normalization": "batch", "grad_scale": 3.0}),
    "SVMOutput[linear]": ("SVMOutput", {"use_linear": True, "margin": 0.5}),
    "SequenceMask[axis=1]": ("SequenceMask", {"use_sequence_length": True,
                                              "axis": 1}),
    # numpy's dot past a 2-d rhs: its second-to-last axis (ROADMAP.md C8)
    "dot[3-d rhs]": ("dot", {}),
    "dot[transpose_a,b]": ("dot", {"transpose_a": True, "transpose_b": True}),
    "Crop[like,center]": ("Crop", {"num_args": 2, "center_crop": True}),
    "argmax[axis=None]": ("argmax", {}),
    "SequenceReverse[no length]": ("SequenceReverse", {}),
    "SequenceLast[axis=1]": ("SequenceLast", {"use_sequence_length": True,
                                              "axis": 1}),
    "Cast[int32]": ("Cast", {"dtype": "int32"}, False),
    "norm[ord=1]": ("norm", {"ord": 1}),
    "repeat[axis=None]": ("repeat", {"repeats": 3}),
    "one_hot[on,off,dtype]": ("one_hot", {"depth": 4, "on_value": 2.5,
                                          "off_value": -1.0, "dtype": "float16"}),
}


def _variant_inputs(key, r, base):
    """Inputs of a variant whose inputs differ from its op's case."""
    N = lambda *s: _f(r.standard_normal(s))                # noqa: E731
    if key == "Deconvolution[groups,dilate]":
        return [N(2, 3, 4, 4), N(3, 2, 3, 3)]
    if key == "Deconvolution[adj>=stride]":
        return [N(2, 3, 4, 4), N(3, 4, 3, 3)]
    if key == "UpSampling[bilinear]":
        return [N(2, 3, 3, 4), N(3, 1, 4, 4)]
    if key == "UpSampling[nearest,sum]":
        return [N(2, 3, 2, 4), N(2, 3, 1, 2)]
    if key == "GridGenerator[warp]":
        return [N(2, 2, 4, 5)]
    if key == "SequenceMask[axis=1]":
        return [N(3, 5, 4), _f([2, 5, 1])]
    if key == "dot[3-d rhs]":
        return [N(2, 3, 4), N(5, 4, 6)]
    if key == "dot[transpose_a,b]":
        return [N(4, 3), N(5, 4)]
    if key == "Crop[like,center]":
        return [N(2, 3, 7, 6), N(2, 1, 4, 3)]
    if key == "SequenceLast[axis=1]":
        return [N(3, 5, 4), _f([2, 5, 1])]
    return base(r)


def op_cases(names):
    """{case id: Case} for every name of ``names`` (registered op names;
    an alias without a case of its own runs its op's) and every variant
    whose op is among them."""
    from .ops.registry import get_op

    specs = _specs()
    cases = {}
    for name in names:
        key = name if name in specs else get_op(name).name
        if key not in specs:
            raise KeyError("no sweep case for op %r" % name)
        attrs, inputs, kind, train, grad = specs[key]
        cases[name] = Case(name, dict(attrs), inputs(_rng(name)), kind, train, grad)
    for vid, (op, attrs, *no_grad) in _VARIANTS.items():
        if op in names:
            _, inputs, kind, train, grad = specs[op]
            cases[vid] = Case(op, dict(attrs),
                              _variant_inputs(vid, _rng(vid), inputs),
                              kind, train, grad and not no_grad)
    return cases


def run_case(mx, case, ctx, devices=None):
    """Bind ``mx.sym.<case.name>`` on ``ctx`` through package ``mx``, feed
    the case's inputs, run forward (``case.train``) and, when the case
    has a gradient, backward with a seeded head gradient per output.
    Returns (outputs, {argument: gradient}, aux states) as numpy; with a
    list ``devices``, appends the device of every output, gradient and
    aux array to it."""
    op = getattr(mx.sym, case.name)
    probe = op(name="probe", **case.attrs)
    n_args = len(probe.list_arguments())
    args = [mx.sym.Variable("in%d" % i) for i in range(n_args)]
    n_aux = len(probe.list_auxiliary_states())
    auxs = [mx.sym.Variable("aux%d" % i) for i in range(n_aux)]
    sym = op(*(args + auxs), name="op", **case.attrs) if args or auxs \
        else op(name="op", **case.attrs)
    arg_names = sym.list_arguments()
    shapes = {n: a.shape for n, a in zip(arg_names, case.inputs)}
    exe = sym.simple_bind(ctx=ctx, grad_req="write" if case.grad else "null",
                          **shapes)
    for n, a in zip(arg_names, case.inputs):
        exe.arg_dict[n][:] = a
    for n, a in zip(sym.list_auxiliary_states(), case.inputs[n_args:]):
        exe.aux_dict[n][:] = a
    held = list(exe.forward(is_train=case.train))
    outs = [o.asnumpy() for o in held]
    grads = {}
    if case.grad:
        r = _rng("head:" + case.name)
        heads = [mx.nd.array(r.standard_normal(o.shape).astype(o.dtype), ctx=ctx)
                 for o in outs]
        exe.backward(out_grads=heads)
        grads = {n: exe.grad_dict[n].asnumpy() for n in arg_names}
        held += [exe.grad_dict[n] for n in arg_names]
    if devices is not None:
        devices.extend(str(a.context) for a in held + list(exe.aux_arrays))
    return outs, grads, [a.asnumpy() for a in exe.aux_arrays]
