"""LeNet-5 (LeCun et al.), table-driven. Hyperparameters match the reference
zoo (example/image-classification/symbols/lenet.py) for checkpoint
interchange; all layers are unnamed there, so only structure matters.

The port's copy of ``mxnet_tpu/models/lenet.py``: the same graph,
layer names and attrs, so the symbol's JSON is the JAX package's byte
for byte.
"""
from .. import symbol as sym

# (filters, kernel) per conv stage; each is conv -> tanh -> 2x2/2 max-pool
_CONV_STAGES = ((20, (5, 5)), (50, (5, 5)))
_FC_HIDDEN = 500


def get_symbol(num_classes=10, **kwargs):
    x = sym.Variable("data")
    for filters, kernel in _CONV_STAGES:
        x = sym.Convolution(x, kernel=kernel, num_filter=filters)
        x = sym.Activation(x, act_type="tanh")
        x = sym.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2))
    x = sym.FullyConnected(sym.Flatten(x), num_hidden=_FC_HIDDEN)
    x = sym.Activation(x, act_type="tanh")
    x = sym.FullyConnected(x, num_hidden=num_classes)
    return sym.SoftmaxOutput(x, name="softmax")
