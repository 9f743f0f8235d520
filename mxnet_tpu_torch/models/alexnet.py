"""AlexNet (Krizhevsky et al. 2012), table-driven.

Layer names and hyperparameters match the reference zoo
(example/image-classification/symbols/alexnet.py) so checkpoints
interchange; the builder itself walks the stage tables below.

The port's copy of ``mxnet_tpu/models/alexnet.py``: the same graph,
layer names and attrs, so the symbol's JSON is the JAX package's byte
for byte.
"""
from .. import symbol as sym

# (name, kernel, stride, pad, filters, LRN after?, max-pool after?)
# pad None means "not set" — serialized as the empty tuple, byte-matching
# the reference zoo's graph JSON (conv1 omits pad there)
_CONV_STAGES = (
    ("conv1", (11, 11), (4, 4), None, 96, True, True),
    ("conv2", (5, 5), (1, 1), (2, 2), 256, True, True),
    ("conv3", (3, 3), (1, 1), (1, 1), 384, False, False),
    ("conv4", (3, 3), (1, 1), (1, 1), 384, False, False),
    ("conv5", (3, 3), (1, 1), (1, 1), 256, False, True),
)

# (name, width) — each followed by relu + dropout(0.5)
_HIDDEN_FC = (("fc1", 4096), ("fc2", 4096))

_LRN = dict(alpha=0.0001, beta=0.75, knorm=2, nsize=5)
_POOL = dict(pool_type="max", kernel=(3, 3), stride=(2, 2))


def get_symbol(num_classes=1000, **kwargs):
    x = sym.Variable("data")
    for name, kernel, stride, pad, filters, lrn, pool in _CONV_STAGES:
        kw = {} if pad is None else {"pad": pad}
        x = sym.Convolution(x, name=name, kernel=kernel, stride=stride,
                            num_filter=filters, **kw)
        x = sym.Activation(x, act_type="relu")
        if lrn:
            x = sym.LRN(x, **_LRN)
        if pool:
            x = sym.Pooling(x, **_POOL)
    x = sym.Flatten(x)
    for name, width in _HIDDEN_FC:
        x = sym.FullyConnected(x, name=name, num_hidden=width)
        x = sym.Activation(x, act_type="relu")
        x = sym.Dropout(x, p=0.5)
    x = sym.FullyConnected(x, name="fc3", num_hidden=num_classes)
    return sym.SoftmaxOutput(x, name="softmax")
