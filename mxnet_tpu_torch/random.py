"""Random state of the port (counterpart of ``mxnet_tpu/random.py``;
reference: python/mxnet/random.py, src/resource.cc ResourceRandom).

The reference seeds one RNG resource per device; the JAX package keeps
one threefry key chain. The port keeps one ``torch.Generator`` per
device, and every draw names its generator:

* the CPU's is PyTorch's default CPU generator, so a run seeded with
  ``torch.manual_seed`` draws what it drew before this module existed
  (the initializers draw from it);
* each CUDA card's is a private ``torch.Generator``, made at first use
  and seeded from the last :func:`seed`. A CUDA graph that captures a
  draw registers it (``CUDAGraph.register_generator_state``), so every
  replay draws fresh numbers, the ones an eager step from the same
  generator state would draw.

:func:`seed` reseeds every generator, those made later included. Values
differ from the JAX package's threefry draws; distributions, shapes,
dtypes and the seed-once reproducibility contract are the same.
"""
from __future__ import annotations

import torch

__all__ = ["seed", "generator", "uniform", "normal", "randint"]

_DEFAULT_SEED = 0
_seed = [_DEFAULT_SEED]
_cuda_generators = {}


def seed(seed_state):
    """Seed the random number generators of every device
    (reference: python/mxnet/random.py:45 mx.random.seed)."""
    if not isinstance(seed_state, int):
        raise ValueError("sd must be int")
    _seed[0] = seed_state
    torch.default_generator.manual_seed(seed_state)
    for gen in _cuda_generators.values():
        gen.manual_seed(seed_state)


def generator(device):
    """The generator that draws on ``device`` (a ``torch.device`` or its
    name)."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.default_generator
    if device.type != "cuda":
        raise ValueError("no generator for device %s" % device)
    index = torch.cuda.current_device() if device.index is None else device.index
    gen = _cuda_generators.get(index)
    if gen is None:
        gen = torch.Generator(device=torch.device("cuda", index))
        gen.manual_seed(_seed[0])
        _cuda_generators[index] = gen
    return gen


# Imperative samplers (mx.random.uniform / normal / randint); also
# nd.random_*.
def uniform(low=0, high=1, shape=None, dtype=None, ctx=None, out=None):
    from . import ndarray as nd

    return nd.random_uniform(low=low, high=high, shape=shape, dtype=dtype,
                             ctx=ctx, out=out)


def normal(loc=0, scale=1, shape=None, dtype=None, ctx=None, out=None):
    from . import ndarray as nd

    return nd.random_normal(loc=loc, scale=scale, shape=shape, dtype=dtype,
                            ctx=ctx, out=out)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None):
    from . import ndarray as nd

    return nd.random_randint(low=low, high=high, shape=shape, dtype=dtype,
                             ctx=ctx, out=out)
