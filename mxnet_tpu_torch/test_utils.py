"""Test utilities of the port: the operator sweep, and the discrete
choices of a deep network held fixed across two runs.

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
finiteness only (samplers draw from each device's own generator). A
case's ``setup(mx)`` runs first (``Custom`` registers its operator in
the package at hand); inputs that are not float32 (``dequantize``'s
uint8) are bound in their own dtype.

Two correct runs of a deep ReLU network in float32 (two packages, or the
card and the CPU) disagree wherever a ReLU input or the gap between the
two largest values of a max-pooling window lies within their rounding of
zero: the gradient jumps there. SSD-300 at batch 2 has about 50 million
ReLU inputs and several such places at any point. :func:`decision_names`
names the values that fix those choices and :class:`installed_decisions`
makes the port take them from a reference run (as ``chip_smoke`` installs
the card's dropout masks on both sides), so the rest of the step is held
to its tolerances.
"""
from __future__ import annotations

import importlib
import math
import zlib

import numpy as np

__all__ = ["Case", "op_cases", "run_case", "decision_names",
           "installed_decisions", "detections_match"]


class Case:
    """One sweep case: the op ``name``, its ``attrs``, its input arrays
    (arguments then aux states, in the op's order), how it is held
    (``kind``), whether its forward runs in training mode (``train``) and
    whether it has a gradient to compare (``grad``), and what runs
    before it is built (``setup(mx)``, or None)."""

    __slots__ = ("name", "attrs", "inputs", "kind", "train", "grad", "setup")

    def __init__(self, name, attrs, inputs, kind="smooth", train=True, grad=True,
                 setup=None):
        self.name, self.attrs, self.inputs = name, attrs, inputs
        self.kind, self.train, self.grad = kind, train, grad
        self.setup = setup


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


def _boxes(r, *lead):
    """Corner boxes (..., 4) in [0, 1]: corners in [0, 0.7), sides 0.1-0.3."""
    xy = r.uniform(0, 0.7, lead + (2,))
    return _f(np.concatenate([xy, xy + r.uniform(0.1, 0.3, lead + (2,))], -1))


def _det_target_inputs(r):
    """MultiBoxTarget's case: 16 anchors (1, 16, 4); labels (2, 3, 5)
    [class, x0, y0, x1, y1], image 0 with two objects and a padded row
    (class -1), image 1 with one object and two padded rows; class
    predictions (2, 3, 16). Each object is an anchor other than anchor 0
    moved by up to 0.02, so it is that anchor's best match: where a valid
    row's best anchor is anchor 0 and padded rows follow it, the JAX
    package drops the match (``ROADMAP.md`` C9; held by
    ``tests/test_torch_contrib.py``)."""
    anchors = _boxes(r, 16)
    lab = -np.ones((2, 3, 5))
    for (i, j), k in zip(((0, 0), (0, 1), (1, 0)), (3, 7, 11)):
        lab[i, j] = [r.randint(0, 2)] + list(anchors[k] + r.uniform(-0.02, 0.02, 4))
    return [anchors[None], _f(lab), _f(r.standard_normal((2, 3, 16)))]


def _softmax(x, axis):
    e = np.exp(x - x.max(axis, keepdims=True))
    return _f(e / e.sum(axis, keepdims=True))


def _register_sweep_custom(mx):
    """Register the Custom case's operator ``sweep_mul_add`` in package
    ``mx``: ``a * b + a`` on the host, in numpy, with its gradient."""
    op_mod = importlib.import_module(mx.__name__ + ".operator")

    class _MulAdd(op_mod.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            a, b = (x.asnumpy() for x in in_data)
            self.assign(out_data[0], req[0], a * b + a)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            a, b = (x.asnumpy() for x in in_data)
            g = out_grad[0].asnumpy()
            self.assign(in_grad[0], req[0], g * (b + 1))
            self.assign(in_grad[1], req[1], g * a)

    @op_mod.register("sweep_mul_add")
    class _MulAddProp(op_mod.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return _MulAdd()


def _specs():
    """name -> (attrs, inputs(rng), kind, train, grad, setup)."""
    N = lambda r, *s: _f(r.standard_normal(s))            # noqa: E731
    U = lambda r, lo, hi, *s: _f(r.uniform(lo, hi, s))     # noqa: E731
    S = {}

    def add(name, attrs, inputs, kind="smooth", train=True, grad=True, setup=None):
        S[name] = (attrs, inputs, kind, train, grad, setup)

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

    # ---- contrib: detection (no gradient: zeros on both sides)
    add("_contrib_MultiBoxPrior", {"sizes": (0.2, 0.35), "ratios": (1, 2, 0.5),
                                   "clip": True}, lambda r: [N(r, 1, 3, 4, 5)],
        kind="exact")
    add("_contrib_MultiBoxTarget", {"negative_mining_ratio": 3.0},
        _det_target_inputs)
    add("_contrib_MultiBoxDetection", {"nms_threshold": 0.3, "threshold": 0.1},
        lambda r: [_softmax(N(r, 2, 3, 16), 1), _f(0.1 * N(r, 2, 64)),
                   _boxes(r, 1, 16)])
    add("_contrib_Proposal", {"scales": (2, 4), "feature_stride": 4,
                              "rpn_pre_nms_top_n": 30, "rpn_post_nms_top_n": 12,
                              "threshold": 0.5, "rpn_min_size": 4,
                              "output_score": True},
        lambda r: [U(r, 0, 1, 1, 12, 4, 4), _f(0.2 * N(r, 1, 24, 4, 4)),
                   _f([[16, 16, 1]])])
    # ---- contrib: the rest
    add("_contrib_CTCLoss", {}, lambda r: [N(r, 6, 2, 4), _f([[1, 2, 0], [3, 3, 1]])])
    add("_contrib_fft", {}, lambda r: [N(r, 2, 8)])
    add("_contrib_ifft", {}, lambda r: [N(r, 2, 8)])
    add("_contrib_count_sketch", {"out_dim": 4},
        lambda r: [N(r, 3, 6), _f([[0, 2, 1, 2, 0, 3]]), _f([[1, -1, 1, 1, -1, 1]])])
    add("_contrib_quantize", {}, lambda r: [U(r, 0, 1, 3, 4), _f([0.1]), _f([0.9])],
        kind="exact")
    add("_contrib_dequantize", {}, lambda r: [_ints(r, (3, 4), -127, 128),
                                              _f([-0.5]), _f([2.0])])
    add("Custom", {"op_type": "sweep_mul_add"}, lambda r: [N(r, *sh), N(r, *sh)],
        setup=_register_sweep_custom)
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
    "_contrib_MultiBoxPrior[steps,offsets]": ("_contrib_MultiBoxPrior", {
        "sizes": (0.3,), "ratios": (1, 3), "steps": (0.2, 0.25),
        "offsets": (0.4, 0.6)}),
    "_contrib_MultiBoxTarget[no mining]": ("_contrib_MultiBoxTarget", {
        "overlap_threshold": 0.3}),
    "_contrib_MultiBoxDetection[force,topk]": ("_contrib_MultiBoxDetection", {
        "nms_threshold": 0.3, "force_suppress": True, "nms_topk": 5,
        "clip": False}),
    "_contrib_Proposal[one output]": ("_contrib_Proposal", {
        "scales": (2, 4), "feature_stride": 4, "rpn_pre_nms_top_n": 100,
        "rpn_post_nms_top_n": 30, "rpn_min_size": 4}),
    "_contrib_quantize[int8]": ("_contrib_quantize", {"out_type": "int8"}),
    "_contrib_dequantize[uint8]": ("_contrib_dequantize", {}, False),
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
    if key == "_contrib_dequantize[uint8]":
        return [r.randint(0, 256, (3, 4)).astype(np.uint8), _f([-0.5]), _f([2.0])]
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
        attrs, inputs, kind, train, grad, setup = specs[key]
        cases[name] = Case(name, dict(attrs), inputs(_rng(name)), kind, train,
                           grad, setup)
    for vid, (op, attrs, *no_grad) in _VARIANTS.items():
        if op in names:
            _, inputs, kind, train, grad, setup = specs[op]
            cases[vid] = Case(op, dict(attrs),
                              _variant_inputs(vid, _rng(vid), inputs),
                              kind, train, grad and not no_grad, setup)
    return cases


def run_case(mx, case, ctx, devices=None):
    """Bind ``mx.sym.<case.name>`` on ``ctx`` through package ``mx``, feed
    the case's inputs, run forward (``case.train``) and, when the case
    has a gradient, backward with a seeded head gradient per output.
    Returns (outputs, {argument: gradient}, aux states) as numpy; with a
    list ``devices``, appends the device of every output, gradient and
    aux array to it."""
    if case.setup is not None:
        case.setup(mx)
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
    types = ({n: a.dtype for n, a in zip(arg_names, case.inputs)}
             if any(a.dtype != np.float32 for a in case.inputs) else None)
    exe = sym.simple_bind(ctx=ctx, grad_req="write" if case.grad else "null",
                          type_dict=types, **shapes)
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


def _decision_nodes(symbol):
    """(node, reference output name) of each ReLU (its output) and each
    2-d max pooling (its input) of the port's ``symbol``."""
    from .symbol import Symbol, _topo_order

    out = []
    for node in _topo_order(symbol._entries):
        if node.op == "Activation" and node.attrs["act_type"] == "relu":
            out.append((node, node.name + "_output"))
        elif (node.op == "Pooling" and node.attrs["pool_type"] == "max"
              and not node.attrs["global_pool"] and len(node.attrs["kernel"]) == 2):
            out.append((node, Symbol([node.inputs[0]]).list_outputs()[0]))
    return out


def decision_names(symbol):
    """The internal outputs (``symbol.get_internals()`` names) whose values
    fix the discrete choices of ``symbol``: each ReLU's output and each
    2-d max pooling's input. The same names exist in the JAX package's
    symbol."""
    return list(dict.fromkeys(name for _, name in _decision_nodes(symbol)))


class installed_decisions:
    """Within the block, the port's ReLUs and 2-d max poolings in
    ``symbol`` (the port's, as bound) take their choices from
    ``reference`` ({name: numpy array}, :func:`decision_names`' values of
    a reference run): a ReLU passes the units whose reference output is
    positive, a max pooling takes, in each window, the element where the
    reference input is largest. The values passed are this run's own, so
    only the choices come from the reference."""

    def __init__(self, symbol, reference):
        self._ref = {id(node.attrs): reference[name]
                     for node, name in _decision_nodes(symbol)}
        self._saved = None

    def _lookup(self, attrs, x):
        import torch

        ref = self._ref.get(id(attrs))
        if ref is None or x.device.type == "meta":
            return None
        return torch.as_tensor(np.array(ref), device=x.device)

    def __enter__(self):
        import torch.nn.functional as F

        from .ops import nn
        from .ops.registry import get_op

        act, pool = get_op("Activation"), get_op("Pooling")
        self._saved = (act.forward, pool.forward)
        act_fwd, pool_fwd = self._saved

        def relu(octx, attrs, args, auxs):
            ref = self._lookup(attrs, args[0])
            if ref is None:
                return act_fwd(octx, attrs, args, auxs)
            return [args[0] * (ref > 0).to(args[0].dtype)], []

        def max_pool(octx, attrs, args, auxs):
            x = args[0]
            ref = self._lookup(attrs, x)
            if ref is None:
                return pool_fwd(octx, attrs, args, auxs)
            kernel, stride, pads = nn._pool_window(attrs, tuple(x.shape[2:]))
            xp = nn._pad_spatial(x, pads, -math.inf)
            _, idx = F.max_pool2d(nn._pad_spatial(ref, pads, -math.inf), kernel,
                                  stride, return_indices=True)
            return [xp.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)], []

        act.forward, pool.forward = relu, max_pool
        return self

    def __exit__(self, *exc):
        from .ops.registry import get_op

        get_op("Activation").forward, get_op("Pooling").forward = self._saved
        return False


def detections_match(got, want, tol):
    """Whether two runs' ``MultiBoxDetection`` outputs (N, A, 6) agree: per
    image the same kept rows ([class, score, x0, y0, x1, y1], class >= 0)
    in score order, classes exact and the rest within ``tol``, a row
    trading places only with one of the four rows either side whose
    score is within ``tol`` of its own (two runs' rounding may order
    equal scores either way). Returns the number of places traded, or
    None where the rows differ."""
    traded = 0
    for g, w in zip(got, want):
        g, w = g[g[:, 0] >= 0], w[w[:, 0] >= 0]
        if g.shape != w.shape:
            return None
        used = np.zeros(len(w), bool)
        for i, row in enumerate(g):
            hits = [j for j in range(max(0, i - 4), min(len(w), i + 5))
                    if not used[j] and row[0] == w[j, 0]
                    and np.abs(row[1:] - w[j, 1:]).max() <= tol]
            if not hits:
                return None
            j = i if i in hits else hits[0]
            traded += j != i
            used[j] = True
    return traded
