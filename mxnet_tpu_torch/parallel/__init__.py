"""The port's counterpart of ``mxnet_tpu/parallel``: the fused one-program
training step on one device (:mod:`.spmd`) and its optimizer rules
(:mod:`.fused_opt`). Meshes, collectives and sharded parameters wait for
``ROADMAP.md`` A6b."""
from ..base import not_ported as _not_ported
from .spmd import SPMDTrainer

__all__ = ["SPMDTrainer"]

__getattr__ = _not_ported(__name__, dict.fromkeys(
    ("build_mesh", "local_mesh", "mesh", "moe", "moe_ffn", "pipeline",
     "pipeline_apply", "ring", "ring_attention", "ulysses_attention", "lm"),
    "A6b"))
