"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

A second package beside the JAX one, with the same module layout so each
counterpart is found by path. It imports ``torch`` and numpy, never JAX
and nothing of ``mxnet_tpu``. Every TPU (Pallas) kernel on a ported path
is a hand-written CUDA kernel for Hopper (``csrc/``), built at first use
by :mod:`.ops._build`; each has a plain PyTorch version beside it that
runs for tensors on the CPU.

Ported so far: the serving engine (:mod:`.serving`) with the flash
prefill and paged decode kernels, and symbolic training through
``Module.fit`` (:mod:`.symbol`, :mod:`.executor`, :mod:`.module`, the
Transformer-LM's ops, initializers, SGD and Adam, ``NDArrayIter``,
metrics) with the flash-attention backward kernels; speculative decoding
with the multi-query paged kernel, and checkpoints (``nd.save``/``load``,
``model.save_checkpoint``/``load_checkpoint``, ``Module.load``) in the JAX
package's file format; ResNet-50 on the fused step (one CUDA graph per
input shape); the bucketed LSTM LM (``mx.rnn``, the ``RNN`` op,
``BucketingModule`` over one shared fused state), optimizer-state files
and ``fit(auto_resume=...)``; the image-classification zoo through
``tools/train_imagenet.py`` with ``mx.random`` (one generator per
device, registered with every CUDA graph that draws), the sampling ops,
``Dropout``/``LRN``/``LeakyReLU``, ``mx.lr_scheduler``, the rest of the
optimizers, initializers and metrics, and ``model.FeedForward``; the
operator surface and DCGAN; SSD-300 with the contrib ops (``MultiBox*``,
``Proposal``, ``CTCLoss``, ``fft``, ``count_sketch``, ``quantize``),
``metric.MApMetric`` and ``tools/train_ssd.py``; ``Custom`` operators
(:mod:`.operator`) and ``SequentialModule``/``PythonModule``; imperative
autograd (``contrib.autograd``, over the flash kernels too), the Caffe
layers, the torch bridge, the notebook callbacks, the op docs and the
reference's test helpers; the data pipeline: RecordIO (``recordio``),
``image``/``image_det`` augmenters, ``ImageRecordIter`` and
``ImageDetRecordIter`` (``io_image``) on the Python pipeline or the
native host stage (``csrc/native``, built with ``g++`` at first use), and
the uint8 wire decoded inside the fused step's CUDA graph; the script
surface (``mx.Context`` and its ``with`` scope, ``mx.tpu``,
``mx.current_context``, ``mx.context.auto``, ``mx.utils``, the rest of
``mx.io``) and ``mx.kv``: the single-process store and the
parameter-server cluster of ``tools/launch.py`` (``dist_sync``,
``dist_async``; :mod:`.kvstore_server`, the engine and the transport in
``csrc/native``), whose fused step runs its gradient and its update as
two CUDA graphs with the exchange on the host between them, with its
HA and elastic half (replicated server groups with failover and
checkpoints, the membership registry, :mod:`.elastic`, the cluster-stats
publisher); model
parallelism: meshes of positions over the cards (``parallel``), ring and
Ulysses attention over the flash kernels, the GPipe pipeline, the Switch
MoE, the dense, sp, pp and ep LM trainers behind
``mod.ParallelLMModule``, ``group2ctx`` placement (:mod:`.placed`) and
several contexts per module (``executor_manager``). The
namespaces are the JAX package's, so a training script needs only its
import line changed: ``import mxnet_tpu_torch as mx``.

A process started with ``DMLC_ROLE=server`` serves its key shard inside
this import and exits when the cluster stops (a ``scheduler`` exits at
once), as ``import mxnet_tpu`` does.
"""
import sys as _sys


def _lint_only():
    """True while ``python -m mxnet_tpu_torch.tools.fwlint`` is being
    located: the linter needs the standard library alone, so the package
    imports nothing (torch included) for it."""
    argv = getattr(_sys, "orig_argv", ())
    if _sys.argv[:1] != ["-m"]:
        return False
    for i, a in enumerate(argv):
        if a == "-m":
            return list(argv[i + 1:i + 2]) == ["mxnet_tpu_torch.tools.fwlint"]
        if a.startswith("-m"):
            return a[2:] == "mxnet_tpu_torch.tools.fwlint"
    return False


if not _lint_only():
    from ._package import *  # noqa: E402,F401,F403
    from ._package import __all__, __version__  # noqa: E402,F401
