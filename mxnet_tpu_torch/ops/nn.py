"""Layer ops of the port (counterpart of ``mxnet_tpu/ops/nn.py``).

Only ``FullyConnected`` and ``Activation``. The matrix product is
``torch.matmul`` in full float32 (TF32 is off in the port), as the JAX
package leaves it to XLA at HIGHEST precision. The rest of the file
(convolution, pooling, BatchNorm, ...) waits for ROADMAP A3/A4.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from .registry import Param, get_op, register


@register(
    "FullyConnected",
    arg_names=lambda attrs: ["data", "weight"] + ([] if attrs.get("no_bias") else ["bias"]),
    params={
        "num_hidden": Param.int(),
        "no_bias": Param.bool(False),
        "flatten": Param.bool(True),
    },
)
def _fully_connected(octx, attrs, args, auxs):
    data, weight = args[0], args[1]
    x = data.reshape(data.shape[0], -1) if attrs["flatten"] else data
    out = torch.matmul(x, weight.t())
    if not attrs["no_bias"]:
        out = out + args[2]
    return [out], []


def _fc_infer_shape(attrs, in_shapes, aux_shapes):
    data = in_shapes[0]
    if data is None:
        raise MXNetError("FullyConnected: data shape required")
    nh = attrs["num_hidden"]
    if attrs["flatten"]:
        in_dim = int(np.prod(data[1:]))
        out = (data[0], nh)
    else:
        in_dim = data[-1]
        out = tuple(data[:-1]) + (nh,)
    shapes = [tuple(data), (nh, in_dim)]
    if not attrs["no_bias"]:
        shapes.append((nh,))
    return shapes, [out], []


get_op("FullyConnected")._infer_shape = _fc_infer_shape

_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": torch.nn.functional.softplus,
    "softsign": torch.nn.functional.softsign,
}


@register("Activation", arg_names=("data",), params={"act_type": Param.str()})
def _activation(octx, attrs, args, auxs):
    fn = _ACTIVATIONS.get(attrs["act_type"])
    if fn is None:
        raise MXNetError("Activation: unknown act_type %s" % attrs["act_type"])
    return [fn(args[0])], []
