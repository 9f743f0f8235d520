"""ResNeXt (Xie et al., "Aggregated Residual Transformations for Deep
Neural Networks"), table-driven.

Layer names and the depth/filter tables match the reference zoo
(example/image-classification/symbols/resnext.py) so checkpoints and arg
names interchange — pinned by tests/test_model_golden_names.py; the depth
tables themselves are shared with :mod:`.resnet` (`depth_config`). Unlike
pre-activation ResNet, every unit here is a run of conv -> BN [-> relu]
rows with the relu of the LAST row deferred until after the shortcut add,
and the projection shortcut is conv + BN off the unit input.

The port's copy of ``mxnet_tpu/models/resnext.py``: the same graph,
layer names and attrs, so the symbol's JSON is the JAX package's byte
for byte.
"""
from .. import symbol as sym
from .resnet import depth_config

# unit rows: (channel fraction of the unit output, kernel edge,
# grouped?, carries the unit stride?); the last row's relu happens after
# the residual add
_BOTTLENECK_PLAN = ((0.5, 1, False, False), (0.5, 3, True, True),
                    (1.0, 1, False, False))
_BASIC_PLAN = ((1.0, 3, False, True), (1.0, 3, False, False))


def _conv_bn(x, filters, edge, stride, name, conv_suffix, bn_suffix,
             bn_mom, workspace, groups=None):
    """conv (no bias) + BN with the zoo's naming convention. `groups=None`
    (the projection shortcut) omits pad/num_group, matching the reference's
    node attrs (pad serializes as '()' there, not '(0, 0)')."""
    extra = ({} if groups is None
             else {"pad": (edge // 2, edge // 2), "num_group": groups})
    x = sym.Convolution(data=x, num_filter=filters, kernel=(edge, edge),
                        stride=stride, no_bias=True, workspace=workspace,
                        name=name + conv_suffix, **extra)
    return sym.BatchNorm(data=x, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                         name=name + bn_suffix)


def residual_unit(data, num_filter, stride, dim_match, name, num_group=32,
                  bottle_neck=True, bn_mom=0.9, workspace=256):
    """One post-activation aggregated unit; `stride` lands on the plan's
    strided row (the grouped 3x3 in the bottleneck form)."""
    plan = _BOTTLENECK_PLAN if bottle_neck else _BASIC_PLAN
    x = data
    for k, (frac, edge, grouped, strided) in enumerate(plan, start=1):
        x = _conv_bn(x, int(num_filter * frac), edge,
                     stride if strided else (1, 1), name,
                     "_conv%d" % k, "_bn%d" % k, bn_mom, workspace,
                     groups=num_group if grouped else 1)
        if k < len(plan):  # the last row's relu is applied after the add
            x = sym.Activation(data=x, act_type="relu",
                               name="%s_relu%d" % (name, k))
    if dim_match:
        shortcut = data
    else:
        shortcut = _conv_bn(data, num_filter, 1, stride, name, "_sc",
                            "_sc_bn", bn_mom, workspace)
    return sym.Activation(data=x + shortcut, act_type="relu",
                          name=name + "_relu")


def resnext(units, num_stages, filter_list, num_classes, num_group,
            image_shape, bottle_neck=True, bn_mom=0.9, workspace=256):
    """Stem + `units[i]` aggregated units per stage + avg-pool/FC head."""
    assert len(units) == num_stages
    x = sym.Variable(name="data")
    x = sym.identity(data=x, name="id")
    x = sym.BatchNorm(data=x, fix_gamma=True, eps=2e-5, momentum=bn_mom,
                      name="bn_data")
    height = image_shape[1]
    if height <= 32:  # cifar-scale stem: a bare 3x3
        x = sym.Convolution(data=x, num_filter=filter_list[0], kernel=(3, 3),
                            stride=(1, 1), pad=(1, 1), no_bias=True,
                            name="conv0", workspace=workspace)
    else:  # imagenet stem: 7x7/2 + BN/relu + 3x3/2 max-pool
        x = sym.Convolution(data=x, num_filter=filter_list[0], kernel=(7, 7),
                            stride=(2, 2), pad=(3, 3), no_bias=True,
                            name="conv0", workspace=workspace)
        x = sym.BatchNorm(data=x, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                          name="bn0")
        x = sym.Activation(data=x, act_type="relu", name="relu0")
        x = sym.Pooling(data=x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                        pool_type="max")
    for i, n_unit in enumerate(units):
        for j in range(n_unit):
            # stage transitions (except into stage 1) downsample at unit 1
            s = 2 if i > 0 and j == 0 else 1
            x = residual_unit(x, filter_list[i + 1], (s, s), dim_match=j > 0,
                              name="stage%d_unit%d" % (i + 1, j + 1),
                              num_group=num_group, bottle_neck=bottle_neck,
                              bn_mom=bn_mom, workspace=workspace)
    x = sym.Pooling(data=x, global_pool=True, kernel=(7, 7), pool_type="avg",
                    name="pool1")
    x = sym.FullyConnected(data=sym.Flatten(data=x), num_hidden=num_classes,
                           name="fc1")
    return sym.SoftmaxOutput(data=x, name="softmax")


def get_symbol(num_classes=1000, num_layers=101, image_shape="3,224,224",
               num_group=32, conv_workspace=256, **kwargs):
    if isinstance(image_shape, str):
        image_shape = [int(d) for d in image_shape.split(",")]
    units, num_stages, filter_list, bottle_neck = depth_config(
        num_layers, image_shape[1])
    return resnext(units=units, num_stages=num_stages,
                   filter_list=filter_list, num_classes=num_classes,
                   num_group=num_group, image_shape=tuple(image_shape),
                   bottle_neck=bottle_neck, workspace=conv_workspace)
