"""Pre-activation ResNet (He et al., "Identity Mappings in Deep Residual
Networks"), table-driven — the port's copy of ``mxnet_tpu/models/resnet.py``.

Layer names (stage<i>_unit<j>_{bn,relu,conv}<k>, conv0/bn0/relu0, bn1/relu1,
pool1, fc1) and the depth/filter tables are the JAX package's (and the
reference zoo's, example/image-classification/symbols/resnet.py), so the
symbol JSON and the checkpoints of either package interchange. The network
is one walk over the unit plans below: every residual unit is a run of
BN -> relu -> conv steps plus a projection shortcut taken off the first
activation. Mixed precision is the Module's ``compute_dtype``.
"""
import functools

from .. import symbol as sym

# a residual unit is BN->relu->conv repeated per row: (channel fraction of
# the unit's output width, kernel edge, which row carries the unit's stride)
_BOTTLENECK_PLAN = ((0.25, 1, False), (0.25, 3, True), (1.0, 1, False))
_BASIC_PLAN = ((1.0, 3, True), (1.0, 3, False))

# imagenet depth table: depth -> units per stage (4 stages)
_IMAGENET_UNITS = {
    18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
    152: (3, 8, 36, 3), 200: (3, 24, 36, 3), 269: (3, 30, 48, 8),
}


def _layer_fns(layout):
    """Layout-aware layer constructors: channel-first (reference default) or
    NHWC (channel-last; the conv/pool ops take the same layout parameter the
    reference exposes, convolution-inl.h)."""
    bn_axis = 3 if layout == "NHWC" else 1
    conv = functools.partial(sym.Convolution, layout=layout)
    pool = functools.partial(sym.Pooling, layout=layout)
    bn = functools.partial(sym.BatchNorm, axis=bn_axis, fix_gamma=False,
                           eps=2e-5)
    return conv, pool, bn


def residual_unit(data, num_filter, stride, dim_match, name, bottle_neck=True,
                  bn_mom=0.9, workspace=256, memonger=False, layout="NCHW"):
    """One pre-activation unit; `stride` lands on the plan's strided row and
    `dim_match` selects identity vs 1x1-projection shortcut."""
    Conv, _pool, BN = _layer_fns(layout)
    plan = _BOTTLENECK_PLAN if bottle_neck else _BASIC_PLAN
    x, shortcut_src = data, None
    for k, (frac, edge, strided) in enumerate(plan, start=1):
        x = BN(data=x, momentum=bn_mom, name="%s_bn%d" % (name, k))
        x = sym.Activation(data=x, act_type="relu",
                           name="%s_relu%d" % (name, k))
        if shortcut_src is None:
            shortcut_src = x  # projection taps the first activation
        x = Conv(data=x, num_filter=int(num_filter * frac),
                 kernel=(edge, edge), stride=stride if strided else (1, 1),
                 pad=(edge // 2, edge // 2), no_bias=True,
                 workspace=workspace, name="%s_conv%d" % (name, k))
    if dim_match:
        shortcut = data
    else:
        shortcut = Conv(data=shortcut_src, num_filter=num_filter,
                        kernel=(1, 1), stride=stride, no_bias=True,
                        workspace=workspace, name=name + "_sc")
    return x + shortcut


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True, bn_mom=0.9, workspace=256, memonger=False,
           layout="NCHW"):
    """Stem + `units[i]` residual units per stage + BN/relu/avg-pool/FC head.
    ``layout="NHWC"`` builds the whole graph channel-last — image_shape is
    then (H, W, C) and so is the data input."""
    assert len(units) == num_stages
    Conv, Pool, BN = _layer_fns(layout)
    height = image_shape[0 if layout == "NHWC" else 1]
    x = sym.Variable(name="data")
    x = sym.identity(data=x, name="id")
    if height <= 32:  # cifar-scale stem: a bare 3x3
        x = Conv(data=x, num_filter=filter_list[0], kernel=(3, 3),
                 stride=(1, 1), pad=(1, 1), no_bias=True, name="conv0",
                 workspace=workspace)
    else:  # imagenet stem: 7x7/2 + BN/relu + 3x3/2 max-pool
        x = Conv(data=x, num_filter=filter_list[0], kernel=(7, 7),
                 stride=(2, 2), pad=(3, 3), no_bias=True, name="conv0",
                 workspace=workspace)
        x = BN(data=x, momentum=bn_mom, name="bn0")
        x = sym.Activation(data=x, act_type="relu", name="relu0")
        x = Pool(data=x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                 pool_type="max")
    for i, n_unit in enumerate(units):
        for j in range(n_unit):
            # stage transitions (except into stage 1) downsample at unit 1
            s = 2 if i > 0 and j == 0 else 1
            x = residual_unit(x, filter_list[i + 1], (s, s), dim_match=j > 0,
                              name="stage%d_unit%d" % (i + 1, j + 1),
                              bottle_neck=bottle_neck, bn_mom=bn_mom,
                              workspace=workspace, memonger=memonger,
                              layout=layout)
    x = BN(data=x, momentum=bn_mom, name="bn1")
    x = sym.Activation(data=x, act_type="relu", name="relu1")
    x = Pool(data=x, global_pool=True, kernel=(7, 7), pool_type="avg",
             name="pool1")
    x = sym.FullyConnected(data=sym.Flatten(data=x), num_hidden=num_classes,
                           name="fc1")
    return sym.SoftmaxOutput(data=x, name="softmax")


def depth_config(num_layers, height):
    """Map a depth to (units, num_stages, filter_list, bottle_neck)
    (reference: resnet.py get_symbol; resnext.py shares the same tables).
    Heights <= cifar scale (the reference crops cifar to 28; native 32 is
    accepted too) use the 3-stage rule: (n-2) % 6 == 0 basic below 164,
    (n-2) % 9 == 0 bottleneck at 164+."""
    if height <= 32:
        num_stages = 3
        bottle_neck = num_layers >= 164
        step = 9 if bottle_neck else 6
        if (num_layers - 2) % step != 0:
            raise ValueError(
                "no experiments done on num_layers {}".format(num_layers))
        units = ((num_layers - 2) // step,) * num_stages
        filter_list = (16, 64, 128, 256) if bottle_neck else (16, 16, 32, 64)
    else:
        num_stages = 4
        bottle_neck = num_layers >= 50
        units = _IMAGENET_UNITS.get(num_layers)
        if units is None:
            raise ValueError(
                "no experiments done on num_layers {}".format(num_layers))
        filter_list = ((64, 256, 512, 1024, 2048) if bottle_neck
                       else (64, 64, 128, 256, 512))
    return units, num_stages, filter_list, bottle_neck


def get_symbol(num_classes=1000, num_layers=50, image_shape="3,224,224",
               conv_workspace=256, layout="NCHW", **kwargs):
    if isinstance(image_shape, str):
        image_shape = [int(d) for d in image_shape.split(",")]
    height = image_shape[0 if layout == "NHWC" else 1]
    units, num_stages, filter_list, bottle_neck = depth_config(num_layers,
                                                              height)
    return resnet(units=units, num_stages=num_stages,
                  filter_list=filter_list, num_classes=num_classes,
                  image_shape=tuple(image_shape), bottle_neck=bottle_neck,
                  workspace=conv_workspace, layout=layout)
