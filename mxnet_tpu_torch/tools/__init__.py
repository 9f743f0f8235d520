"""Command-line front ends of the port's serving engine (the counterparts
of the JAX package's ``tools/serve.py`` and ``tools/bench_serving.py``),
run as modules: ``python -m mxnet_tpu_torch.tools.serve`` and ``python
-m mxnet_tpu_torch.tools.bench_serving``."""
