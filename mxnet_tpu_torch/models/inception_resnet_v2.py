"""Inception-ResNet-v2, 299x299 input (reference: example/image-classification/
symbols/inception-resnet-v2.py; architecture per Szegedy et al., "Inception-v4,
Inception-ResNet and the Impact of Residual Connections on Learning",
arXiv:1602.07261).

The three residual block families (35x35 "A", 17x17 "B", 8x8 "C") differ only
in their tower specs, so one builder covers all of them; each block is
`x + scale * linear_projection(concat(towers))` followed by ReLU.

The port's copy of ``mxnet_tpu/models/inception_resnet_v2.py``: the same graph,
layer names and attrs, so the symbol's JSON is the JAX package's byte
for byte.
"""
from .. import symbol as sym


def _conv(data, num_filter, kernel=(1, 1), stride=(1, 1), pad=(0, 0),
          name=None, with_act=True):
    out = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                          stride=stride, pad=pad, name="%s_conv" % name)
    out = sym.BatchNorm(data=out, name="%s_bn" % name)
    if with_act:
        out = sym.Activation(data=out, act_type="relu", name="%s_relu" % name)
    return out


def _tower(data, specs, name):
    """Chain of convs; each spec is (num_filter, kernel, pad, stride)."""
    out = data
    for i, (nf, kernel, pad, stride) in enumerate(specs):
        out = _conv(out, nf, kernel=kernel, pad=pad, stride=stride,
                    name="%s_%d" % (name, i))
    return out


# Tower specs for the three residual block families (paper fig. 16-19).
# block17's 129-filter reduce and (1,2)/(2,1) asymmetric pads follow the
# reference symbol file (inception-resnet-v2.py:43-57) rather than the paper.
_RESIDUAL_TOWERS = {
    "a": [  # 35x35, input 320ch
        [(32, (1, 1), (0, 0), (1, 1))],
        [(32, (1, 1), (0, 0), (1, 1)), (32, (3, 3), (1, 1), (1, 1))],
        [(32, (1, 1), (0, 0), (1, 1)), (48, (3, 3), (1, 1), (1, 1)),
         (64, (3, 3), (1, 1), (1, 1))],
    ],
    "b": [  # 17x17, input 1088ch
        [(192, (1, 1), (0, 0), (1, 1))],
        [(129, (1, 1), (0, 0), (1, 1)), (160, (1, 7), (1, 2), (1, 1)),
         (192, (7, 1), (2, 1), (1, 1))],
    ],
    "c": [  # 8x8, input 2080ch
        [(192, (1, 1), (0, 0), (1, 1))],
        [(192, (1, 1), (0, 0), (1, 1)), (224, (1, 3), (0, 1), (1, 1)),
         (256, (3, 1), (1, 0), (1, 1))],
    ],
}


def residual_block(data, family, num_channels, scale, name, with_act=True):
    towers = [_tower(data, spec, "%s_t%d" % (name, i))
              for i, spec in enumerate(_RESIDUAL_TOWERS[family])]
    mixed = sym.Concat(*towers, name="%s_mixed" % name)
    up = _conv(mixed, num_channels, name="%s_up" % name, with_act=False)
    out = data + scale * up
    if with_act:
        out = sym.Activation(data=out, act_type="relu", name="%s_relu" % name)
    return out


def get_symbol(num_classes=1000, blocks=(10, 20, 9), **kwargs):
    """blocks = repetitions of the (A, B, C) residual stages; (10, 20, 9) is
    the paper/reference configuration."""
    data = sym.Variable(name="data")

    # Stem: 299x299x3 -> 35x35 (reference :86-109).
    net = _conv(data, 32, kernel=(3, 3), stride=(2, 2), name="stem1a")
    net = _conv(net, 32, kernel=(3, 3), name="stem2a")
    net = _conv(net, 64, kernel=(3, 3), pad=(1, 1), name="stem2b")
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                      name="stem_pool3a")
    net = _conv(net, 80, name="stem3b")
    net = _conv(net, 192, kernel=(3, 3), name="stem4a")
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                      name="stem_pool5a")

    # Mixed 5b: four-branch inception -> 320 channels.
    b0 = _conv(net, 96, name="m5b_b0")
    b1 = _tower(net, [(48, (1, 1), (0, 0), (1, 1)),
                      (64, (5, 5), (2, 2), (1, 1))], "m5b_b1")
    b2 = _tower(net, [(64, (1, 1), (0, 0), (1, 1)),
                      (96, (3, 3), (1, 1), (1, 1)),
                      (96, (3, 3), (1, 1), (1, 1))], "m5b_b2")
    b3 = sym.Pooling(data=net, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg", name="m5b_pool")
    b3 = _conv(b3, 64, name="m5b_b3")
    net = sym.Concat(b0, b1, b2, b3, name="mixed_5b")

    for i in range(blocks[0]):
        net = residual_block(net, "a", 320, 0.17, "block35_%d" % i)

    # Reduction A: 35x35x320 -> 17x17x1088.
    r0 = _conv(net, 384, kernel=(3, 3), stride=(2, 2), name="redA_b0")
    r1 = _tower(net, [(256, (1, 1), (0, 0), (1, 1)),
                      (256, (3, 3), (1, 1), (1, 1)),
                      (384, (3, 3), (0, 0), (2, 2))], "redA_b1")
    rp = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                     name="redA_pool")
    net = sym.Concat(r0, r1, rp, name="mixed_6a")

    for i in range(blocks[1]):
        net = residual_block(net, "b", 1088, 0.10, "block17_%d" % i)

    # Reduction B: 17x17x1088 -> 8x8x2080.
    r0 = _tower(net, [(256, (1, 1), (0, 0), (1, 1)),
                      (384, (3, 3), (0, 0), (2, 2))], "redB_b0")
    r1 = _tower(net, [(256, (1, 1), (0, 0), (1, 1)),
                      (288, (3, 3), (0, 0), (2, 2))], "redB_b1")
    r2 = _tower(net, [(256, (1, 1), (0, 0), (1, 1)),
                      (288, (3, 3), (1, 1), (1, 1)),
                      (320, (3, 3), (0, 0), (2, 2))], "redB_b2")
    rp = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2), pool_type="max",
                     name="redB_pool")
    net = sym.Concat(r0, r1, r2, rp, name="mixed_7a")

    for i in range(blocks[2]):
        net = residual_block(net, "c", 2080, 0.20, "block8_%d" % i)
    net = residual_block(net, "c", 2080, 1.0, "block8_final", with_act=False)

    net = _conv(net, 1536, name="conv_final")
    net = sym.Pooling(data=net, kernel=(1, 1), global_pool=True,
                      pool_type="avg", name="global_pool")
    net = sym.Flatten(data=net, name="flatten")
    net = sym.Dropout(data=net, p=0.2, name="dropout")
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=net, name="softmax")
