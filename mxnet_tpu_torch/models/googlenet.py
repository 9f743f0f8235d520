"""GoogLeNet / Inception-v1 (Szegedy et al., "Going Deeper with
Convolutions"), table-driven.

Layer names (conv_<unit>, ch_concat_<unit>_chconcat, ...) and filter counts
match the reference zoo (example/image-classification/symbols/googlenet.py)
so checkpoints interchange; the network itself is one walk over the plan
below: a stem of plain conv units, then inception blocks with max-pools at
the stage transitions.

The port's copy of ``mxnet_tpu/models/googlenet.py``: the same graph,
layer names and attrs, so the symbol's JSON is the JAX package's byte
for byte.
"""
from .. import symbol as sym


def _conv_unit(x, filters, kernel, name, stride=(1, 1), pad=(0, 0), suffix=""):
    """conv + relu with the zoo's naming convention."""
    x = sym.Convolution(x, num_filter=filters, kernel=kernel, stride=stride,
                        pad=pad, name="conv_%s%s" % (name, suffix))
    return sym.Activation(x, act_type="relu", name="relu_%s%s" % (name, suffix))


def _inception(x, name, b1, b3_reduce, b3, b5_reduce, b5, proj, pool="max"):
    """Four parallel branches concatenated on channels: 1x1 / reduced 3x3 /
    reduced 5x5 / pooled projection."""
    branches = [
        _conv_unit(x, b1, (1, 1), "%s_1x1" % name),
    ]
    reduced3 = _conv_unit(x, b3_reduce, (1, 1), "%s_3x3" % name,
                          suffix="_reduce")
    branches.append(
        _conv_unit(reduced3, b3, (3, 3), "%s_3x3" % name, pad=(1, 1)))
    reduced5 = _conv_unit(x, b5_reduce, (1, 1), "%s_5x5" % name,
                          suffix="_reduce")
    branches.append(
        _conv_unit(reduced5, b5, (5, 5), "%s_5x5" % name, pad=(2, 2)))
    pooled = sym.Pooling(x, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                         pool_type=pool,
                         name="%s_pool_%s_pool" % (pool, name))
    branches.append(_conv_unit(pooled, proj, (1, 1), "%s_proj" % name))
    return sym.Concat(*branches, name="ch_concat_%s_chconcat" % name)


# the inception plan: "pool" rows are stage-transition max-pools; tuple rows
# are (unit, #1x1, #3x3reduce, #3x3, #5x5reduce, #5x5, #pool-proj)
_PLAN = (
    "pool",
    ("in3a", 64, 96, 128, 16, 32, 32),
    ("in3b", 128, 128, 192, 32, 96, 64),
    "pool",
    ("in4a", 192, 96, 208, 16, 48, 64),
    ("in4b", 160, 112, 224, 24, 64, 64),
    ("in4c", 128, 128, 256, 24, 64, 64),
    ("in4d", 112, 144, 288, 32, 64, 64),
    ("in4e", 256, 160, 320, 32, 128, 128),
    "pool",
    ("in5a", 256, 160, 320, 32, 128, 128),
    ("in5b", 384, 192, 384, 48, 128, 128),
)


def get_symbol(num_classes=1000, **kwargs):
    x = sym.Variable("data")
    # stem: 7x7/2 conv, pool, 1x1 + 3x3 convs
    x = _conv_unit(x, 64, (7, 7), "conv1", stride=(2, 2), pad=(3, 3))
    x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
    x = _conv_unit(x, 64, (1, 1), "conv2")
    x = _conv_unit(x, 192, (3, 3), "conv3", pad=(1, 1))
    for row in _PLAN:
        if row == "pool":
            x = sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pool_type="max")
        else:
            x = _inception(x, row[0], *row[1:])
    x = sym.Pooling(x, kernel=(7, 7), stride=(1, 1), global_pool=True,
                    pool_type="avg")
    x = sym.FullyConnected(sym.Flatten(x), num_hidden=num_classes)
    return sym.SoftmaxOutput(x, name="softmax")
