"""SSD-300 with the reduced-VGG16 backbone (counterpart of
``mxnet_tpu/models/ssd.py``; reference: example/ssd/symbol/
symbol_vgg16_reduced.py; Liu et al., "SSD: Single Shot MultiBox
Detector"). The symbols' JSON is the JAX zoo's.

Training graph = backbone → per-scale loc/cls heads → MultiBoxTarget →
(SmoothL1 loc loss via MakeLoss) + (SoftmaxOutput cls loss with
hard-negative ignore), with the detections (MultiBoxDetection: decode and
NMS, no gradient) as a fourth output. Inference graph =
MultiBoxDetection over the softmax. The multibox ops are the port's
torch ops (``ops/contrib_ops.py``), captured with the rest of the step
into one CUDA graph on the fused path.
"""
from .. import symbol as sym
from ..initializer import Constant


def conv_act_layer(from_layer, name, num_filter, kernel=(1, 1), pad=(0, 0),
                   stride=(1, 1), act_type="relu"):
    conv = sym.Convolution(
        data=from_layer, kernel=kernel, pad=pad, stride=stride,
        num_filter=num_filter, name="conv{}".format(name),
    )
    return sym.Activation(data=conv, act_type=act_type, name="{}{}".format(act_type, name))


def vgg16_reduced(data):
    """VGG16 through conv5_3, with pool5 3x3/s1 and dilated fc6/fc7 convs
    (the 'reduced' trick: fc layers become convs so the net stays fully conv)."""
    layers = []
    cfg = [(2, 64, "1"), (2, 128, "2"), (3, 256, "3"), (3, 512, "4"), (3, 512, "5")]
    x = data
    for nconvs, nf, stage in cfg:
        for i in range(nconvs):
            x = sym.Convolution(
                data=x, kernel=(3, 3), pad=(1, 1), num_filter=nf,
                name="conv%s_%d" % (stage, i + 1),
            )
            x = sym.Activation(data=x, act_type="relu", name="relu%s_%d" % (stage, i + 1))
        layers.append(x)
        if stage == "5":
            x = sym.Pooling(data=x, pool_type="max", kernel=(3, 3), stride=(1, 1),
                            pad=(1, 1), name="pool5")
        else:
            # "full" (Caffe ceil) convention keeps conv4_3 at 38x38 for the
            # canonical 8732-anchor SSD-300 (reference: example/ssd symbol uses
            # pooling_convention="full")
            x = sym.Pooling(data=x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                            pooling_convention="full", name="pool%s" % stage)
    fc6 = sym.Convolution(data=x, kernel=(3, 3), pad=(6, 6), dilate=(6, 6),
                          num_filter=1024, name="fc6")
    relu6 = sym.Activation(data=fc6, act_type="relu", name="relu6")
    fc7 = sym.Convolution(data=relu6, kernel=(1, 1), num_filter=1024, name="fc7")
    relu7 = sym.Activation(data=fc7, act_type="relu", name="relu7")
    return layers[3], relu7  # relu4_3, relu7


def multi_layer_feature(data):
    """The six SSD-300 feature scales: relu4_3, relu7, + 4 extra conv stages."""
    relu4_3, relu7 = vgg16_reduced(data)
    specs = [  # (inter_filters, out_filters, stride, pad)
        (256, 512, (2, 2), (1, 1)),  # conv8_2: 10x10
        (128, 256, (2, 2), (1, 1)),  # conv9_2: 5x5
        (128, 256, (1, 1), (0, 0)),  # conv10_2: 3x3
        (128, 256, (1, 1), (0, 0)),  # conv11_2: 1x1
    ]
    layers = [relu4_3, relu7]
    x = relu7
    for k, (nf1, nf2, stride, pad) in enumerate(specs, start=8):
        x = conv_act_layer(x, "%d_1" % k, nf1, kernel=(1, 1))
        x = conv_act_layer(x, "%d_2" % k, nf2, kernel=(3, 3), pad=pad, stride=stride)
        layers.append(x)
    return layers


# SSD-300 anchor configuration (reference: example/ssd/symbol/symbol_vgg16_reduced.py)
SIZES = [[0.1, 0.141], [0.2, 0.272], [0.37, 0.447], [0.54, 0.619], [0.71, 0.79], [0.88, 0.961]]
RATIOS = [[1, 2, 0.5], [1, 2, 0.5, 3, 1.0 / 3], [1, 2, 0.5, 3, 1.0 / 3],
          [1, 2, 0.5, 3, 1.0 / 3], [1, 2, 0.5], [1, 2, 0.5]]
NORMALIZATIONS = [20, -1, -1, -1, -1, -1]


def multibox_layer(layers, num_classes, sizes=SIZES, ratios=RATIOS,
                   normalizations=NORMALIZATIONS, clip=False):
    """Per-scale loc/cls heads + anchor generation, concatenated across scales
    (reference: example/ssd/symbol/common.py multibox_layer)."""
    loc_preds, cls_preds, anchors = [], [], []
    num_classes += 1  # background
    for k, from_layer in enumerate(layers):
        if normalizations[k] > 0:
            from_layer = sym.L2Normalization(data=from_layer, mode="channel",
                                             name="%d_norm" % k)
            scale = sym.Variable(
                name="%d_scale" % k, shape=(1, 512, 1, 1),
                init=Constant(float(normalizations[k])),
            )
            from_layer = sym.broadcast_mul(scale, from_layer)
        num_anchors = len(sizes[k]) + len(ratios[k]) - 1
        loc = sym.Convolution(data=from_layer, kernel=(3, 3), pad=(1, 1),
                              num_filter=num_anchors * 4, name="loc_pred_conv%d" % k)
        loc = sym.transpose(loc, axes=(0, 2, 3, 1))
        loc_preds.append(sym.Flatten(data=loc))
        cls = sym.Convolution(data=from_layer, kernel=(3, 3), pad=(1, 1),
                              num_filter=num_anchors * num_classes,
                              name="cls_pred_conv%d" % k)
        cls = sym.transpose(cls, axes=(0, 2, 3, 1))
        cls_preds.append(sym.Flatten(data=cls))
        anchors.append(sym.Flatten(data=sym.contrib.MultiBoxPrior(
            from_layer, sizes=tuple(sizes[k]), ratios=tuple(ratios[k]),
            clip=clip, name="anchors%d" % k,
        )))
    loc_preds = sym.Concat(*loc_preds, dim=1, name="multibox_loc_pred")
    cls_preds = sym.Concat(*cls_preds, dim=1)
    cls_preds = sym.Reshape(data=cls_preds, shape=(0, -1, num_classes))
    cls_preds = sym.transpose(cls_preds, axes=(0, 2, 1), name="multibox_cls_pred")
    anchor_boxes = sym.Reshape(data=sym.Concat(*anchors, dim=1), shape=(0, -1, 4),
                               name="multibox_anchors")
    return loc_preds, cls_preds, anchor_boxes


def get_symbol_train(num_classes=20, nms_thresh=0.5, force_suppress=False,
                     nms_topk=400, **kwargs):
    """Training graph (reference: example/ssd/symbol/symbol_vgg16_reduced.py
    get_symbol_train): MultiBoxTarget + SmoothL1 loc loss + softmax cls loss."""
    data = sym.Variable(name="data")
    label = sym.Variable(name="label")
    layers = multi_layer_feature(data)
    loc_preds, cls_preds, anchor_boxes = multibox_layer(layers, num_classes, clip=False)
    tmp = sym.contrib.MultiBoxTarget(
        anchor_boxes, label, cls_preds, overlap_threshold=0.5,
        ignore_label=-1, negative_mining_ratio=3, minimum_negative_samples=0,
        negative_mining_thresh=0.5, variances=(0.1, 0.1, 0.2, 0.2),
        name="multibox_target",
    )
    loc_target, loc_target_mask, cls_target = tmp[0], tmp[1], tmp[2]
    cls_prob = sym.SoftmaxOutput(
        data=cls_preds, label=cls_target, ignore_label=-1, use_ignore=True,
        grad_scale=1.0, multi_output=True, normalization="valid", name="cls_prob",
    )
    loc_loss_ = sym.smooth_l1(data=loc_target_mask * (loc_preds - loc_target),
                              scalar=1.0, name="loc_loss_")
    loc_loss = sym.MakeLoss(loc_loss_, grad_scale=1.0, normalization="valid",
                            name="loc_loss")
    cls_label = sym.MakeLoss(data=cls_target, grad_scale=0, name="cls_label")
    det = sym.contrib.MultiBoxDetection(
        cls_prob, loc_preds, anchor_boxes, name="detection",
        nms_threshold=nms_thresh, force_suppress=force_suppress,
        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=nms_topk,
    )
    det = sym.MakeLoss(data=det, grad_scale=0, name="det_out")
    return sym.Group([cls_prob, loc_loss, cls_label, det])


def get_symbol(num_classes=20, nms_thresh=0.5, force_suppress=False,
               nms_topk=400, **kwargs):
    """Inference graph: decode + NMS via MultiBoxDetection."""
    data = sym.Variable(name="data")
    layers = multi_layer_feature(data)
    loc_preds, cls_preds, anchor_boxes = multibox_layer(layers, num_classes, clip=False)
    cls_prob = sym.softmax(data=cls_preds, axis=1, name="cls_prob")
    return sym.contrib.MultiBoxDetection(
        cls_prob, loc_preds, anchor_boxes, name="detection",
        nms_threshold=nms_thresh, force_suppress=force_suppress,
        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=nms_topk,
    )
