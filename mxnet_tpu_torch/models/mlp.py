"""Two-hidden-layer MLP, table-driven. Layer names (fc1/fc2/fc3, relu1/relu2)
match the reference zoo (example/image-classification/symbols/mlp.py) for
checkpoint interchange.

The port's copy of ``mxnet_tpu/models/mlp.py``: the same graph,
layer names and attrs, so the symbol's JSON is the JAX package's byte
for byte.
"""
from .. import symbol as sym

_HIDDEN = (128, 64)


def get_symbol(num_classes=10, **kwargs):
    x = sym.Flatten(sym.Variable("data"))
    for i, width in enumerate(_HIDDEN, start=1):
        x = sym.FullyConnected(x, name="fc%d" % i, num_hidden=width)
        x = sym.Activation(x, name="relu%d" % i, act_type="relu")
    x = sym.FullyConnected(x, name="fc%d" % (len(_HIDDEN) + 1),
                           num_hidden=num_classes)
    return sym.SoftmaxOutput(x, name="softmax")
