"""Model zoo of the port (counterpart of ``mxnet_tpu/models``), exposed as
the JAX package exposes it: ``models.transformer_lm(...)``,
``models.resnet(num_classes, num_layers, image_shape, layout)``, and
the image-classification zoo (``mlp``, ``lenet``, ``alexnet``,
``vgg``, ``googlenet``, ``inception_bn``, ``inception_v3``,
``inception_resnet_v2``, ``resnext``) build the training symbols;
``models.lstm_lm(...)`` a ``BucketingModule``'s ``sym_gen``;
``make_generator``/``make_discriminator`` DCGAN's two symbols;
``ssd.get_symbol_train``/``ssd.get_symbol`` SSD-300's training and
inference symbols."""
from .alexnet import get_symbol as alexnet
from .dcgan import make_discriminator, make_generator
from .googlenet import get_symbol as googlenet
from .inception_bn import get_symbol as inception_bn
from .inception_resnet_v2 import get_symbol as inception_resnet_v2
from .inception_v3 import get_symbol as inception_v3
from .lenet import get_symbol as lenet
from .lstm_lm import get_symbol as lstm_lm
from .mlp import get_symbol as mlp
from .resnet import get_symbol as resnet
from .resnext import get_symbol as resnext
from . import ssd
from .transformer_lm import get_symbol as transformer_lm
from .vgg import get_symbol as vgg

__all__ = ["alexnet", "make_discriminator", "make_generator", "googlenet", "inception_bn", "inception_resnet_v2",
           "inception_v3", "lenet", "lstm_lm", "mlp", "resnet", "resnext",
           "ssd", "transformer_lm", "vgg"]
