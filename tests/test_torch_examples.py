"""Every script in ``examples/`` on the port, from its own source with only
its import lines rewritten (``mxnet_tpu`` -> ``mxnet_tpu_torch``, and
``tools.<name>`` -> ``mxnet_tpu_torch.tools.<name>`` where the port has
that tool), at small flags, inside ``with mx.cpu():`` (and with
``MXNET_DEFAULT_CONTEXT=cpu`` for the processes a script starts). A
script still blocked by a later ``ROADMAP.md`` item must fail with an
error that names that item; none is skipped."""
import os
import re
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")

# small flags: a few steps each (scripts that assert their own accuracy
# keep what they need to reach it)
FLAGS = {
    "adversary_fgsm": ["--num-epochs", "1"],
    "autoencoder": ["--batch-size", "512", "--num-epoch", "1"],
    "bayesian_sgld": [],
    "bi_lstm_sort": ["--batch-size", "1024", "--seq-len", "4",
                     "--vocab-size", "8", "--num-epoch", "1"],
    "caffe_import": ["--batch-size", "256", "--num-epoch", "1"],
    "cnn_text_classification": ["--batch-size", "256", "--seq-len", "8",
                                "--vocab-size", "50", "--num-epoch", "1"],
    "dcgan": ["--batch-size", "4", "--num-epochs", "1",
              "--steps-per-epoch", "2"],
    "dec_clustering": ["--pretrain-epochs", "1", "--refine-iters", "2",
                       "--batch-size", "64"],
    "fcn_segmentation": ["--batch-size", "256", "--num-epoch", "1"],
    "generate_text": ["--vocab", "16", "--seq-len", "8", "--num-layers", "1",
                      "--model-dim", "16", "--num-heads", "2",
                      "--num-epochs", "1", "--prompt-len", "3",
                      "--gen-len", "4"],
    "kaggle_ndsb": ["--size", "16", "--batch-size", "64", "--num-epochs", "1"],
    "lstm_bucketing": ["--num-hidden", "16", "--num-embed", "16",
                       "--num-layers", "1", "--batch-size", "16",
                       "--num-epochs", "1", "--max-sentences", "64"],
    "matrix_factorization": ["--num-users", "20", "--num-items", "30",
                             "--factor-size", "4", "--batch-size", "32",
                             "--num-epoch", "1"],
    "memcost": ["--depth", "2", "--batch", "8", "--hidden", "16"],
    "model_parallel_lstm": ["--seq-len", "4", "--num-hidden", "8",
                            "--num-layers", "2", "--vocab", "16",
                            "--batch-size", "4"],
    "multi_task": ["--batch-size", "32", "--num-epoch", "1"],
    "nce_loss": ["--batch-size", "32", "--vocab-size", "50",
                 "--embed-dim", "8", "--num-epoch", "1"],
    "neural_style": ["--size", "16", "--steps", "2"],
    "numpy_ops": ["--batch-size", "32", "--num-epoch", "1"],
    "ocr_ctc": ["--batch-size", "256", "--seq-len", "8",
                "--max-label-len", "2", "--num-epoch", "1"],
    "profiler_example": ["--iters", "1"],
    "rcnn_proposal": [],
    "reinforcement_learning": ["--episodes", "2", "--max-steps", "10"],
    "speech_demo": ["--feat-dim", "8", "--senones", "4", "--hidden", "8",
                    "--batch-size", "4", "--seq-len", "8",
                    "--num-epochs", "1"],
    "stochastic_depth": ["--batch-size", "256", "--num-epoch", "1"],
    "svm_mnist": ["--batch-size", "32", "--num-epoch", "1"],
    "torch_interop": [],
    "train_cifar10": ["--batch-size", "64", "--num-layers", "8",
                      "--num-epochs", "1", "--digits-proxy"],
    "train_imagenet": ["--network", "mlp", "--num-classes", "10",
                       "--image-shape", "1,28,28", "--batch-size", "8",
                       "--num-examples", "32"],
    "train_lm": ["--vocab", "16", "--seq-len", "8", "--batch-size", "8",
                 "--num-layers", "1", "--model-dim", "16", "--num-heads", "2",
                 "--num-epochs", "1"],
    "train_lm_parallel": ["--devices", "2", "--vocab", "16",
                          "--num-layers", "1", "--model-dim", "16",
                          "--num-heads", "2", "--ffn-dim", "16",
                          "--seq-len", "8", "--batch", "4", "--steps", "1"],
    "train_mnist": ["--batch-size", "32", "--num-epochs", "1",
                    "--data-dir", "{mnist}"],
    "train_ssd": ["--batch-size", "2", "--num-examples", "4",
                  "--num-epochs", "1"],
}

# the scripts a later ROADMAP.md item blocks, and that item (none since
# A7's training half brought mx.profiler and Executor.memory_analysis)
BLOCKED = {}


def rewrite(src):
    """The script's source with its import lines pointed at the port."""
    out = []
    for line in src.splitlines(True):
        if (re.match(r"\s*(import|from)\s+mxnet_tpu\b", line)
                or 'import_module("mxnet_tpu' in line):
            line = re.sub(r"\bmxnet_tpu\b", "mxnet_tpu_torch", line)
        m = re.match(r"\s*from tools\.(\w+) import", line)
        if m and os.path.exists(os.path.join(ROOT, "mxnet_tpu_torch", "tools",
                                             m.group(1) + ".py")):
            line = line.replace("from tools.", "from mxnet_tpu_torch.tools.", 1)
        out.append(line)
    return "".join(out)


def _mnist_files(d):
    """A small MNIST in idx format (the script reads it with MNISTIter)."""
    import struct

    r = np.random.RandomState(0)
    templates = r.rand(10, 28, 28)
    for split, n in (("train", 256), ("t10k", 64)):
        y = r.randint(0, 10, n)
        x = (255 * (0.7 * templates[y] + 0.3 * r.rand(n, 28, 28))).astype(np.uint8)
        with open(os.path.join(d, "%s-images-idx3-ubyte" % split), "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28) + x.tobytes())
        with open(os.path.join(d, "%s-labels-idx1-ubyte" % split), "wb") as f:
            f.write(struct.pack(">II", 2049, n) + y.astype(np.uint8).tobytes())
    return d


def test_every_example_has_flags_and_the_rewrite_leaves_no_jax_package_import():
    names = sorted(f[:-3] for f in os.listdir(EXAMPLES) if f.endswith(".py"))
    assert names == sorted(FLAGS)
    assert len(names) - len(BLOCKED) >= 33
    for name in names:
        with open(os.path.join(EXAMPLES, name + ".py")) as f:
            src = rewrite(f.read())
        for line in src.splitlines():
            if re.match(r"\s*(import|from)\s+", line):
                assert not re.search(r"\bmxnet_tpu\b(?!_torch)", line), (name, line)


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_example_runs_on_the_port(name, tmp_path, monkeypatch):
    path = os.path.join(EXAMPLES, name + ".py")
    with open(path) as f:
        src = rewrite(f.read())
    mnist = tmp_path / "mnist"
    mnist.mkdir()
    _mnist_files(str(mnist))
    argv = [a.format(mnist=str(mnist)) for a in FLAGS[name]]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [path] + argv)
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", "cpu")
    monkeypatch.setenv("PYTHONPATH", ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    np.random.seed(0)
    # torch's generator too (the port's CPU initializers and samplers draw
    # from it): a script's outcome must not depend on the tests run before
    # it in the same process
    torch.manual_seed(0)
    # two threads: the test runs beside other test processes, and torch's
    # default of one thread per core oversubscribes the host
    threads = torch.get_num_threads()
    torch.set_num_threads(2)

    def run():
        with mx.cpu():
            try:
                exec(compile(src, path, "exec"), {"__name__": "__main__",
                                                  "__file__": path})
            except SystemExit as e:
                assert not e.code, "%s exited with %s" % (name, e.code)

    try:
        if name in BLOCKED:
            with pytest.raises(Exception) as info:
                run()
            assert "ROADMAP.md %s" % BLOCKED[name] in str(info.value), info.value
        else:
            run()
    finally:
        torch.set_num_threads(threads)
