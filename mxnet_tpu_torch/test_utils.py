"""Test utilities of the port: the operator sweep, the discrete choices
of a deep network held fixed across two runs, and the reference's test
helpers (counterpart of ``mxnet_tpu/test_utils.py``: tolerance checks,
``numeric_grad``/``check_numeric_gradient``, ``check_symbolic_forward``/
``check_symbolic_backward``, ``simple_forward`` and ``check_consistency``,
the reference's GPU-vs-CPU harness, here the card against the host,
forward and backward).

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
           "installed_decisions", "detections_match", "default_context",
           "rand_shape_2d", "rand_shape_3d", "rand_ndarray",
           "assert_almost_equal", "almost_equal", "same", "reldiff",
           "find_max_violation", "numeric_grad", "check_numeric_gradient",
           "check_symbolic_forward", "check_symbolic_backward",
           "check_consistency", "simple_forward"]


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
    # the uint8 wire's decode: a uint8 NHWC batch (no gradient); its float
    # NCHW variant below has one
    add("_image_wire_normalize", {"mean": (120.0, 110.0, 100.0),
                                  "std": (58.0, 57.0, 57.5)},
        lambda r: [r.randint(0, 256, (2, 5, 4, 3)).astype(np.uint8)], grad=False)
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
    "_image_wire_normalize[float,NCHW]": ("_image_wire_normalize", {
        "mean": (0.5,), "layout": "NCHW"}),
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
    if key == "_image_wire_normalize[float,NCHW]":
        return [N(2, 3, 4, 5)]
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


# ---- the reference's test helpers (mxnet_tpu/test_utils.py) ---------------
# reference: python/mxnet/test_utils.py — assert_almost_equal :129,
# find_max_violation :101, check_numeric_gradient :420 (central finite
# differences against the symbolic backward), check_symbolic_forward :533,
# check_symbolic_backward :598 and check_consistency :765, the GPU-vs-CPU
# harness (here the card against the host)

_hrng = np.random.RandomState(1234)


def default_context():
    """Where the helpers bind without a ``ctx``: the card
    (``context.default_device``; raises without CUDA)."""
    from .context import default_device

    return default_device()


def default_dtype():
    return np.float32


def rand_shape_2d(dim0=10, dim1=10):
    return tuple(_hrng.randint(1, (dim0, dim1)[i] + 1) for i in range(2))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return tuple(_hrng.randint(1, (dim0, dim1, dim2)[i] + 1) for i in range(3))


def rand_ndarray(shape, ctx=None, dtype=np.float32):
    from . import ndarray as nd

    return nd.array(_hrng.standard_normal(shape).astype(dtype),
                    ctx=ctx if ctx is not None else default_context())


def same(a, b):
    return np.array_equal(a, b)


def reldiff(a, b):
    """Sum of absolute differences over the sum of absolute values."""
    diff = np.sum(np.abs(a - b))
    norm = np.sum(np.abs(a)) + np.sum(np.abs(b))
    if diff == 0:
        return 0
    return diff / norm


def almost_equal(a, b, rtol=None, atol=None):
    return np.allclose(a, b, rtol=rtol or 1e-5, atol=atol or 1e-20)


def find_max_violation(a, b, rtol=None, atol=None):
    """The index of the worst violation of ``|a - b| <= atol + rtol*|b|``
    and its ratio to the tolerance."""
    rtol = rtol or 1e-5
    atol = atol or 1e-20
    diff = np.abs(a - b)
    tol = atol + rtol * np.abs(b)
    violation = diff / (tol + 1e-20)
    loc = np.argmax(violation)
    idx = np.unravel_index(loc, violation.shape)
    return idx, np.max(violation)


def _host(x):
    from .ndarray import NDArray

    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b")):
    """Raise ``AssertionError`` naming the worst element unless ``a`` and
    ``b`` (NDArrays or array-likes) agree within ``rtol``/``atol``."""
    a, b = _host(a), _host(b)
    rtol = rtol or 1e-5
    atol = atol or 1e-20
    if almost_equal(a, b, rtol, atol):
        return
    index, rel = find_max_violation(a, b, rtol, atol)
    raise AssertionError(
        "Items are not equal:\nError %f exceeds tolerance rtol=%f, atol=%f. "
        " Location of maximum error:%s, %s=%f, %s=%f"
        % (rel, rtol, atol, str(index), names[0], a[index], names[1], b[index]))


def simple_forward(symbol, ctx=None, is_train=False, **inputs):
    """Bind ``symbol`` to numpy ``inputs`` on ``ctx``, run forward and
    return its outputs as numpy (one array when there is one)."""
    from . import ndarray as nd

    ctx = ctx if ctx is not None else default_context()
    inputs = {k: nd.array(v, ctx=ctx) if isinstance(v, np.ndarray) else v
              for k, v in inputs.items()}
    exe = symbol.bind(ctx, args=inputs)
    exe.forward(is_train=is_train)
    outputs = [x.asnumpy() for x in exe.outputs]
    return outputs[0] if len(outputs) == 1 else outputs


def _parse_location(symbol, location, ctx):
    from . import ndarray as nd

    if isinstance(location, dict):
        if set(location) != set(symbol.list_arguments()):
            raise ValueError(
                "Symbol arguments and keys of the given location do not "
                "match. symbol args:%s, location.keys():%s"
                % (set(symbol.list_arguments()), set(location)))
    else:
        location = dict(zip(symbol.list_arguments(), location))
    return {k: nd.array(v, ctx=ctx) if isinstance(v, np.ndarray) else v
            for k, v in location.items()}


def _parse_aux_states(symbol, aux_states, ctx):
    from . import ndarray as nd

    if aux_states is None:
        return None
    if isinstance(aux_states, dict):
        if set(aux_states) != set(symbol.list_auxiliary_states()):
            raise ValueError("Symbol aux_states names and given aux_states "
                             "do not match.")
    else:
        aux_states = dict(zip(symbol.list_auxiliary_states(), aux_states))
    return {k: nd.array(v, ctx=ctx) for k, v in aux_states.items()}


def numeric_grad(executor, location, aux_states=None, eps=1e-4,
                 use_forward_train=True):
    """Central finite differences of the sum of ``executor``'s outputs
    with respect to each array of ``location`` (numpy, by argument)."""
    del aux_states
    approx = {k: np.zeros(v.shape, dtype=np.float32) for k, v in location.items()}
    for k, v in location.items():
        executor.arg_dict[k][:] = v
    for k in location:
        old = location[k].copy()
        for i in range(int(np.prod(old.shape))):
            loc = np.unravel_index(i, old.shape) if old.shape else ()
            values = []
            for step in (eps / 2.0, -eps / 2.0):
                tmp = old.copy()
                tmp[loc] += step
                executor.arg_dict[k][:] = tmp
                executor.forward(is_train=use_forward_train)
                values.append(sum(np.sum(o.asnumpy()) for o in executor.outputs))
            approx[k][loc] = (values[0] - values[1]) / eps
        executor.arg_dict[k][:] = old
    return approx


def check_numeric_gradient(sym_, location, aux_states=None, numeric_eps=1e-3,
                           rtol=1e-2, atol=None, grad_nodes=None,
                           use_forward_train=True, ctx=None):
    """Hold ``sym_``'s backward against central finite differences of
    ``sum(sym_ * P)`` for a seeded random projection ``P``."""
    from . import ndarray as nd
    from . import symbol as sym

    ctx = ctx if ctx is not None else default_context()
    location = _parse_location(sym_, location, ctx)
    location_npy = {k: v.asnumpy() for k, v in location.items()}
    aux_states = _parse_aux_states(sym_, aux_states, ctx)
    if grad_nodes is None:
        grad_nodes = sym_.list_arguments()
        grad_req = {k: "write" for k in grad_nodes}
    elif isinstance(grad_nodes, (list, tuple)):
        grad_nodes = list(grad_nodes)
        grad_req = {k: "write" for k in grad_nodes}
    elif isinstance(grad_nodes, dict):
        grad_req = grad_nodes.copy()
        grad_nodes = list(grad_nodes)
    else:
        raise ValueError("grad_nodes: a list or a dict of grad_req")
    if len(sym_.list_outputs()) != 1:
        raise NotImplementedError("multi-output check_numeric_gradient")
    proj = sym.Variable("__random_proj")
    out = sym.MakeLoss(sym.sum(sym_ * proj))
    location = dict(location)
    _, out_shapes, _ = sym_.infer_shape(**{k: v.shape for k, v in location.items()})
    proj_arr = _hrng.standard_normal(out_shapes[0]).astype(np.float32)
    location["__random_proj"] = nd.array(proj_arr, ctx=ctx)
    args_grad = {k: nd.zeros(location[k].shape, ctx=ctx)
                 for k in list(grad_nodes) + ["__random_proj"]}
    grad_req = dict(grad_req, __random_proj="write")
    executor = out.bind(ctx, args=location, args_grad=args_grad,
                        grad_req=grad_req, aux_states=aux_states)
    executor.forward(is_train=True)
    executor.backward()
    symbolic = {k: executor.grad_dict[k].asnumpy() for k in grad_nodes}
    numeric = numeric_grad(executor, dict(location_npy, __random_proj=proj_arr),
                           eps=numeric_eps, use_forward_train=use_forward_train)
    for name in grad_nodes:
        want = numeric[name] if grad_req[name] == "write" else \
            np.zeros_like(symbolic[name])
        if grad_req[name] in ("write", "null"):
            assert_almost_equal(want, symbolic[name], rtol, atol,
                                ("NUMERICAL_%s" % name, "BACKWARD_%s" % name))


def check_symbolic_forward(sym_, location, expected, rtol=1e-5, atol=None,
                           aux_states=None, ctx=None):
    """Hold ``sym_``'s inference forward at ``location`` against the
    ``expected`` numpy outputs; returns the outputs."""
    ctx = ctx if ctx is not None else default_context()
    location = _parse_location(sym_, location, ctx)
    aux_states = _parse_aux_states(sym_, aux_states, ctx)
    executor = sym_.bind(ctx, args=location, aux_states=aux_states)
    executor.forward(is_train=False)
    for name, expect, output in zip(sym_.list_outputs(), expected,
                                    executor.outputs):
        assert_almost_equal(expect, output.asnumpy(), rtol, atol,
                            ("EXPECTED_%s" % name, name))
    return executor.outputs


def check_symbolic_backward(sym_, location, out_grads, expected, rtol=1e-5,
                            atol=None, aux_states=None, grad_req="write",
                            ctx=None):
    """Hold ``sym_``'s gradients at ``location`` under head gradients
    ``out_grads`` against ``expected`` (by argument), for each argument's
    ``grad_req`` (``add`` onto a seeded start, ``null`` leaves it);
    returns the gradient arrays."""
    from . import ndarray as nd

    ctx = ctx if ctx is not None else default_context()
    location = _parse_location(sym_, location, ctx)
    aux_states = _parse_aux_states(sym_, aux_states, ctx)
    if isinstance(expected, (list, tuple)):
        expected = dict(zip(sym_.list_arguments(), expected))
    start = {k: _hrng.normal(size=v.shape).astype(np.float32)
             for k, v in expected.items()}
    args_grad = {k: nd.array(v, ctx=ctx) for k, v in start.items()}
    if isinstance(grad_req, str):
        grad_req = {k: grad_req for k in sym_.list_arguments()}
    elif isinstance(grad_req, (list, tuple)):
        grad_req = dict(zip(sym_.list_arguments(), grad_req))
    executor = sym_.bind(ctx, args=location, args_grad=args_grad,
                         aux_states=aux_states, grad_req=grad_req)
    executor.forward(is_train=True)
    if isinstance(out_grads, np.ndarray):
        out_grads = [out_grads]
    out_grads = [nd.array(v, ctx=ctx) if isinstance(v, np.ndarray) else v
                 for v in out_grads]
    executor.backward(out_grads)
    grads = {k: v.asnumpy() for k, v in executor.grad_dict.items()
             if v is not None}
    for name in expected:
        got = {"write": grads[name], "add": grads[name] - start[name],
               "null": grads[name]}[grad_req[name]]
        want = start[name] if grad_req[name] == "null" else expected[name]
        assert_almost_equal(want, got, rtol, atol,
                            ("EXPECTED_%s" % name, "BACKWARD_%s" % name))
    return executor.grad_arrays


#: check_consistency's default tolerance by dtype (the reference's: a card
#: in float32 is held to 1e-3 of the host)
CONSISTENCY_TOL = {np.dtype(np.float16): 1e-1, np.dtype(np.float32): 1e-3,
                   np.dtype(np.float64): 1e-5, np.dtype(np.uint8): 0,
                   np.dtype(np.int32): 0}


def check_consistency(sym_, ctx_list, scale=1.0, grad_req="write",
                      arg_params=None, aux_params=None, tol=None,
                      raise_on_err=True, ground_truth=None, seed=0):
    """Run one symbol on each entry of ``ctx_list`` (dicts of ``ctx``,
    ``shapes`` and optional ``type_dict``) from the same seeded
    parameters and hold every run's outputs and, unless ``grad_req`` is
    ``null``, its gradients under the same seeded head gradients against
    the first run's (or ``ground_truth``'s outputs), to the tolerance of
    the dtype (:data:`CONSISTENCY_TOL`, or ``tol``). Returns the
    executors; with ``raise_on_err`` False, the worst violation ratio
    instead of raising."""
    from . import ndarray as nd
    from . import symbol as sym

    if tol is None:
        tol = dict(CONSISTENCY_TOL)
    elif isinstance(tol, float):
        tol = dict.fromkeys(CONSISTENCY_TOL, tol)
    if len(ctx_list) < 2:
        raise ValueError("check_consistency needs two or more contexts")
    syms = [sym_] * len(ctx_list) if isinstance(sym_, sym.Symbol) else list(sym_)
    output_names = syms[0].list_outputs()
    arg_names = syms[0].list_arguments()
    rng = np.random.RandomState(seed)
    exe_list = []
    for s, c in zip(syms, ctx_list):
        if s.list_arguments() != arg_names or s.list_outputs() != output_names:
            raise ValueError("check_consistency: the symbols differ")
        exe_list.append(s.simple_bind(ctx=c["ctx"], grad_req=grad_req,
                                      type_dict=c.get("type_dict") or None,
                                      **c["shapes"]))
    arg_params = dict(arg_params or {})
    aux_params = dict(aux_params or {})
    for n, arr in exe_list[0].arg_dict.items():
        if n not in arg_params:
            arg_params[n] = rng.normal(size=arr.shape, scale=scale)
    for n in exe_list[0].aux_dict:
        aux_params.setdefault(n, 0)
    for exe in exe_list:
        for name, arr in exe.arg_dict.items():
            arr[:] = np.asarray(arg_params[name]).astype(np.float32)
        for name, arr in exe.aux_dict.items():
            arr[:] = aux_params[name]
    train = grad_req != "null"
    outputs = []
    grads = []
    for exe in exe_list:
        exe.forward(is_train=train)
        outs = [o.asnumpy() for o in exe.outputs]
        outputs.append(outs)
        if train:
            heads = [np.random.RandomState(seed + 1 + i).normal(
                size=o.shape).astype(np.float32) for i, o in enumerate(outs)]
            exe.backward([nd.array(h, ctx=exe.outputs[0].context)
                          for h in heads])
            grads.append({n: g.asnumpy() for n, g in exe.grad_dict.items()
                          if g is not None})
    worst = 0.0
    ref_out = ground_truth or outputs[0]
    for i in range(1, len(exe_list)):
        pairs = [("out_" + n, g, o) for n, g, o in
                 zip(output_names, ref_out, outputs[i])]
        if train:
            pairs += [("grad_" + n, grads[0][n], grads[i][n]) for n in grads[0]]
        for name, want, got in pairs:
            rt = tol[np.dtype(got.dtype)] if np.dtype(got.dtype) in tol else \
                tol[np.dtype(np.float32)]
            if raise_on_err:
                assert_almost_equal(want, got, rtol=rt, atol=rt,
                                    names=("ctx0_" + name, "ctx%d_%s" % (i, name)))
            elif want.size:
                worst = max(worst, float(find_max_violation(
                    got, want, rt or 1e-20, rt or 1e-20)[1]))
    return exe_list if raise_on_err else worst
