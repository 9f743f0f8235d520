"""Model zoo of the port (counterpart of ``mxnet_tpu/models``): the
decoder-only Transformer LM, the pre-activation ResNet and the bucketed
LSTM LM, exposed as the JAX package exposes them
(``models.transformer_lm(...)`` and ``models.resnet(num_classes,
num_layers, image_shape, layout)`` build the training symbols,
``models.lstm_lm(...)`` a ``BucketingModule``'s ``sym_gen``). The other
zoo models wait for ``ROADMAP.md`` A4."""
from .lstm_lm import get_symbol as lstm_lm
from .resnet import get_symbol as resnet
from .transformer_lm import get_symbol as transformer_lm

__all__ = ["lstm_lm", "resnet", "transformer_lm"]
