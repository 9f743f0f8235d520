"""Caffe layers inside a network (counterpart of
``mxnet_tpu/contrib/caffe.py``; reference: plugin/caffe/caffe_op-inl.h,
caffe_loss-inl.h).

The reference plugin links the caffe library and calls its layers. As in
the JAX package, a prototxt snippet here expands, when the symbol is
built, into the equivalent native subgraph through the converter's
layer mapping (the port's copy, :mod:`..tools.caffe_converter`): its
weights become ordinary named arguments, initialized, updated and saved
like any other, and its backward comes from autograd. Anything the
mapping rejects, ``CaffeOp`` rejects.

    conv = mx.contrib.caffe.CaffeOp(
        data,
        prototxt='layer { type: "Convolution" '
                 'convolution_param { num_output: 8 kernel_size: 3 } }',
        name="c1")

``prototxt`` may hold several layers; they chain in order (bottoms
default to the previous layer's output). ``CaffeLoss`` is ``CaffeOp``
whose last layer is a loss head.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["CaffeOp", "CaffeLoss"]


def CaffeOp(*data, prototxt="layer{}", name=None):
    """Expand a caffe prototxt snippet into the equivalent subgraph.

    ``data``: the input symbols, bound to the first layer's bottoms in
    order. ``prototxt``: one or more deploy-style ``layer { ... }``
    blocks (no data layers: inputs come from ``data``). ``name``: prefix
    of the expanded layers' parameter names (two CaffeOps with one
    prototxt do not collide); the prototxt's layer names without it.
    """
    import mxnet_tpu_torch as mx

    from ..tools import caffe_converter

    if not data:
        raise MXNetError("CaffeOp needs at least one input symbol")
    try:
        return caffe_converter.expand_layers(mx, prototxt, list(data),
                                             name_prefix=name)
    except ValueError as e:
        raise MXNetError("CaffeOp: %s" % (e,))


def CaffeLoss(*data, prototxt="layer{}", name=None, grad_scale=1.0):
    """``CaffeOp`` whose snippet ends in a loss head. ``grad_scale`` other
    than 1 raises, as in the JAX package: scale the mapped loss op
    instead."""
    if grad_scale != 1.0:
        raise MXNetError(
            "CaffeLoss grad_scale: set grad_scale on the mapped loss op "
            "via the prototxt's loss_weight instead (converter mapping)")
    return CaffeOp(*data, prototxt=prototxt, name=name)
