"""Model zoo of the port (counterpart of ``mxnet_tpu/models``): the
decoder-only Transformer LM, exposed as the JAX package exposes it
(``models.transformer_lm(...)`` builds the training symbol). The other
zoo models wait for ``ROADMAP.md`` A3/A4."""
from .transformer_lm import get_symbol as transformer_lm

__all__ = ["transformer_lm"]
