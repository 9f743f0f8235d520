"""The RNN API of the port (counterpart of ``mxnet_tpu/rnn``): cells,
bucketed sentence IO and checkpoint helpers."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
