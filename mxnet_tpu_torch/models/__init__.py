"""Model zoo of the port (counterpart of ``mxnet_tpu/models``): the
decoder-only Transformer LM and the pre-activation ResNet, exposed as the
JAX package exposes them (``models.transformer_lm(...)`` and
``models.resnet(num_classes, num_layers, image_shape, layout)`` build the
training symbols). The other zoo models wait for ``ROADMAP.md`` A4."""
from .resnet import get_symbol as resnet
from .transformer_lm import get_symbol as transformer_lm

__all__ = ["resnet", "transformer_lm"]
