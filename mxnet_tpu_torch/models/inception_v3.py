"""Inception-v3, 299x299 input (Szegedy et al., "Rethinking the Inception
Architecture for Computer Vision"), table-driven.

Layer names ({block}_tower_conv_1_conv2d, ch_concat_{block}_chconcat, ...)
and filter counts match the reference zoo (example/image-classification/
symbols/inception-v3.py) so checkpoints and arg names interchange — pinned
by tests/test_model_golden_names.py. The five classic block topologies
(35x35 "A", grid reductions "B"/"D", 17x17 factorized-7 "C", 8x8
fan-out "E") are encoded as branch templates below; the network is one
walk over _STAGES consuming each row's filter counts in branch order.

The port's copy of ``mxnet_tpu/models/inception_v3.py``: the same graph,
layer names and attrs, so the symbol's JSON is the JAX package's byte
for byte.
"""
from .. import symbol as sym

# conv steps: (kernel, pad, stride); "same" spatial unless noted
_S11 = ((1, 1), (0, 0), (1, 1))          # pointwise
_S33 = ((3, 3), (1, 1), (1, 1))          # 3x3 same
_S55 = ((5, 5), (2, 2), (1, 1))          # 5x5 same
_S17 = ((1, 7), (0, 3), (1, 1))          # asymmetric factorized 7
_S71 = ((7, 1), (3, 0), (1, 1))
_S13 = ((1, 3), (0, 1), (1, 1))          # asymmetric factorized 3
_S31 = ((3, 1), (1, 0), (1, 1))
_RED = ((3, 3), (0, 0), (2, 2))          # grid-reduction 3x3/2, valid

# a branch is (tower base name, steps); steps may end in a 2-way fork
# ("fork", step_a, step_b) whose outputs both join the concat. A "pool"
# branch is (pool stride, pool pad, projection?) — projection convs live
# under the _tower_2 base.
_TEMPLATES = {
    # 35x35: 1x1 / 5x5 / double-3x3 / pooled projection
    "A": (("", (_S11,)), ("_tower", (_S11, _S55)),
          ("_tower_1", (_S11, _S33, _S33)), ("pool", 1, 1, True)),
    # first grid reduction: strided 3x3 / 3x3-then-strided / bare max pool
    "B": (("", (_RED,)), ("_tower", (_S11, _S33, _RED)),
          ("pool", 2, 0, False)),
    # 17x17 factorized-7: 1x1 / double-7 / quadruple-7 / pooled projection
    "C": (("", (_S11,)), ("_tower", (_S11, _S17, _S71)),
          ("_tower_1", (_S11, _S71, _S17, _S71, _S17)), ("pool", 1, 1, True)),
    # second grid reduction: two strided towers / bare pool (pad omitted,
    # as the reference spells it — serializes as pad '()' not '(0, 0)')
    "D": (("_tower", (_S11, _RED)),
          ("_tower_1", (_S11, _S17, _S71, _RED)), ("pool", 2, None, False)),
    # 8x8 fan-out: both 3-factorized towers fork into 1x3 + 3x1 halves
    "E": (("", (_S11,)), ("_tower", (_S11, ("fork", _S13, _S31))),
          ("_tower_1", (_S11, _S33, ("fork", _S13, _S31))),
          ("pool", 1, 1, True)),
}

# the block sequence: (template, pool type, filter counts in branch order)
_STAGES = (
    ("A", "avg", "mixed", (64, 48, 64, 64, 96, 96, 32)),
    ("A", "avg", "mixed_1", (64, 48, 64, 64, 96, 96, 64)),
    ("A", "avg", "mixed_2", (64, 48, 64, 64, 96, 96, 64)),
    ("B", "max", "mixed_3", (384, 64, 96, 96)),
    ("C", "avg", "mixed_4", (192, 128, 128, 192,
                             128, 128, 128, 128, 192, 192)),
    ("C", "avg", "mixed_5", (192, 160, 160, 192,
                             160, 160, 160, 160, 192, 192)),
    ("C", "avg", "mixed_6", (192, 160, 160, 192,
                             160, 160, 160, 160, 192, 192)),
    ("C", "avg", "mixed_7", (192,) * 10),
    ("D", "max", "mixed_8", (192, 320, 192, 192, 192, 192)),
    ("E", "avg", "mixed_9", (320, 384, 384, 384, 448, 384, 384, 384, 192)),
    ("E", "max", "mixed_10", (320, 384, 384, 384, 448, 384, 384, 384, 192)),
)


def _unit(x, filters, name, kernel=(1, 1), pad=(0, 0), stride=(1, 1)):
    """conv (no bias) + BN + relu with the zoo's naming convention."""
    x = sym.Convolution(data=x, num_filter=filters, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True,
                        name=name + "_conv2d")
    x = sym.BatchNorm(data=x, eps=0.001, fix_gamma=True,
                      name=name + "_batchnorm")
    return sym.Activation(data=x, act_type="relu", name=name + "_relu")


def _block(x, template, pool, filters, name):
    """Build one inception block: walk each branch template, consuming
    `filters` in order; concat every branch output (forks contribute two)."""
    feed = iter(filters)
    joined = []
    for branch in _TEMPLATES[template]:
        if branch[0] == "pool":
            _tag, stride, pad, projected = branch
            pad_kw = {} if pad is None else {"pad": (pad, pad)}
            y = sym.Pooling(data=x, kernel=(3, 3), stride=(stride, stride),
                            pool_type=pool,
                            name="%s_pool_%s_pool" % (pool, name), **pad_kw)
            if projected:
                y = _unit(y, next(feed), name + "_tower_2_conv")
            joined.append(y)
            continue
        base, steps = branch
        y = x
        for i, step in enumerate(steps):
            suffix = "_conv" if i == 0 else "_conv_%d" % i
            if step[0] == "fork":  # both halves of the fork join the concat
                for half, spec in enumerate(step[1:]):
                    k, p, s = spec
                    tail = "_mixed_conv" + ("" if half == 0 else "_1")
                    joined.append(_unit(y, next(feed), name + base + tail,
                                        kernel=k, pad=p, stride=s))
                y = None
                break
            k, p, s = step
            y = _unit(y, next(feed), name + base + suffix,
                      kernel=k, pad=p, stride=s)
        if y is not None:
            joined.append(y)
    return sym.Concat(*joined, name="ch_concat_%s_chconcat" % name)


def get_symbol(num_classes=1000, **kwargs):
    x = sym.Variable(name="data")
    # stem: three 3x3 convs + pool, then 1x1/3x3 + pool down to 35x35x192
    x = _unit(x, 32, "conv", kernel=(3, 3), stride=(2, 2))
    x = _unit(x, 32, "conv_1", kernel=(3, 3))
    x = _unit(x, 64, "conv_2", kernel=(3, 3), pad=(1, 1))
    x = sym.Pooling(data=x, kernel=(3, 3), stride=(2, 2), pool_type="max",
                    name="pool")
    x = _unit(x, 80, "conv_3")
    x = _unit(x, 192, "conv_4", kernel=(3, 3))
    x = sym.Pooling(data=x, kernel=(3, 3), stride=(2, 2), pool_type="max",
                    name="pool1")
    for template, pool, name, filters in _STAGES:
        x = _block(x, template, pool, filters, name)
    x = sym.Pooling(data=x, kernel=(8, 8), stride=(1, 1), pool_type="avg",
                    name="global_pool")
    x = sym.FullyConnected(data=sym.Flatten(data=x, name="flatten"),
                           num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=x, name="softmax")
