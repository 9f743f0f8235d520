"""Inception-BN, 224x224 input (Ioffe & Szegedy, "Batch Normalization:
Accelerating Deep Network Training by Reducing Internal Covariate Shift"),
table-driven.

Layer names (conv_{block}_1x1, bn_{block}_double_3x3_reduce,
ch_concat_{block}_chconcat, ...) and the filter counts match the reference
zoo (example/image-classification/symbols/inception-bn.py) so checkpoints
and arg names interchange — pinned by tests/test_model_golden_names.py.
The network is one walk over _STAGES: each "A" row is the classic
four-tower inception module (1x1 / reduced 3x3 / reduced double-3x3 /
pooled projection), each "B" row the three-tower stride-2 grid reduction
(no 1x1 or projection tower — pooling passes through unprojected).

The port's copy of ``mxnet_tpu/models/inception_bn.py``: the same graph,
layer names and attrs, so the symbol's JSON is the JAX package's byte
for byte.
"""
from .. import symbol as sym

# tower templates: each step is (kernel edge, pad, stride multiplier);
# stride 2 lands on the LAST step of a reduction tower
_TOWERS_A = (
    ("_1x1", ((1, 0),)),                       # pointwise
    ("_3x3", ((1, 0), (3, 1))),                # reduce -> 3x3
    ("_double_3x3", ((1, 0), (3, 1), (3, 1))),  # reduce -> 3x3 -> 3x3
)
_TOWERS_B = (
    ("_3x3", ((1, 0), (3, 1))),
    ("_double_3x3", ((1, 0), (3, 1), (3, 1))),
)

# the block sequence. "A" counts: (1x1, 3x3_reduce, 3x3, double_3x3_reduce,
# double_3x3, projection) + the pool type of the projection tower;
# "B" counts: (3x3_reduce, 3x3, double_3x3_reduce, double_3x3).
_STAGES = (
    ("A", "3a", "avg", (64, 64, 64, 64, 96, 32)),
    ("A", "3b", "avg", (64, 64, 96, 64, 96, 64)),
    ("B", "3c", None, (128, 160, 64, 96)),
    ("A", "4a", "avg", (224, 64, 96, 96, 128, 128)),
    ("A", "4b", "avg", (192, 96, 128, 96, 128, 128)),
    ("A", "4c", "avg", (160, 128, 160, 128, 160, 128)),
    ("A", "4d", "avg", (96, 128, 192, 160, 192, 128)),
    ("B", "4e", None, (128, 192, 192, 256)),
    ("A", "5a", "avg", (352, 192, 320, 160, 224, 128)),
    ("A", "5b", "max", (352, 192, 320, 192, 224, 128)),
)

# stem: (name, filters, kernel edge, pad, stride), pool after each pair
_STEM = (
    (("conv1", 64, 7, 3, 2),), ("pool1",),
    (("conv2red", 64, 1, 0, 1), ("conv2", 192, 3, 1, 1)), ("pool2",),
)


def _unit(x, filters, name, suffix="", edge=1, pad=0, stride=1):
    """conv + BN + relu with the zoo's conv_/bn_/relu_ naming convention."""
    x = sym.Convolution(
        data=x, num_filter=filters, kernel=(edge, edge),
        stride=(stride, stride), pad=(pad, pad),
        name="conv_%s%s" % (name, suffix))
    x = sym.BatchNorm(data=x, fix_gamma=False, momentum=0.9,
                      name="bn_%s%s" % (name, suffix))
    return sym.Activation(data=x, act_type="relu",
                          name="relu_%s%s" % (name, suffix))


def _tower(x, name, base, steps, counts, strided):
    """Run one template tower; multi-step towers name their reduce step
    ``_reduce`` and number the double-3x3 convs ``_0``/``_1``."""
    for k, (edge, pad) in enumerate(steps):
        if len(steps) > 1 and k == 0:
            suffix = "_reduce"
        elif len(steps) == 3 and k > 0:
            suffix = "_%d" % (k - 1)
        else:
            suffix = ""
        stride = 2 if strided and k == len(steps) - 1 else 1
        x = _unit(x, counts[k], "%s%s" % (name, base), suffix,
                  edge=edge, pad=pad, stride=stride)
    return x


def _block(x, kind, name, pool, counts):
    """One inception module: template towers + the pooling tower + concat."""
    outs = []
    if kind == "A":
        towers, it = _TOWERS_A, iter(counts)
        widths = [(next(it),), (next(it), next(it)), (next(it), next(it))]
        widths[2] = (widths[2][0], widths[2][1], widths[2][1])
        proj = counts[-1]
    else:
        towers, it = _TOWERS_B, iter(counts)
        widths = [(next(it), next(it)), (next(it), next(it))]
        widths[1] = (widths[1][0], widths[1][1], widths[1][1])
        proj = None
    if kind == "A":
        # the 1x1 tower leads the concat order
        outs.append(_tower(x, name, towers[0][0], towers[0][1],
                           widths[0], strided=False))
        towers, widths = towers[1:], widths[1:]
    for (base, steps), w in zip(towers, widths):
        outs.append(_tower(x, name, base, steps, w, strided=kind == "B"))
    if kind == "A":
        pooled = sym.Pooling(
            data=x, kernel=(3, 3), stride=(1, 1), pad=(1, 1), pool_type=pool,
            name="%s_pool_%s_pool" % (pool, name))
        outs.append(_unit(pooled, proj, "%s_proj" % name))
    else:
        outs.append(sym.Pooling(
            data=x, kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max",
            name="max_pool_%s_pool" % name))
    return sym.Concat(*outs, name="ch_concat_%s_chconcat" % name)


def get_symbol(num_classes=1000, **kwargs):
    x = sym.Variable(name="data")
    for row in _STEM:
        if row[0].__class__ is str:
            x = sym.Pooling(data=x, kernel=(3, 3), stride=(2, 2),
                            name=row[0], pool_type="max")
            continue
        for name, filters, edge, pad, stride in row:
            x = _unit(x, filters, name, edge=edge, pad=pad, stride=stride)
    for kind, name, pool, counts in _STAGES:
        x = _block(x, kind, name, pool, counts)
    x = sym.Pooling(data=x, kernel=(7, 7), stride=(1, 1), name="global_pool",
                    pool_type="avg")
    x = sym.Flatten(data=x, name="flatten")
    x = sym.FullyConnected(data=x, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=x, name="softmax")
