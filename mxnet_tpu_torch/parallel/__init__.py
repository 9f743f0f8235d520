"""The port's counterpart of ``mxnet_tpu/parallel``.

* :mod:`.mesh` — meshes of positions over devices (one controller; on one
  card every position names ``cuda:0``);
* :mod:`.collectives` — sharding, ``run_sharded`` and the collectives as
  explicit copies between positions (the JAX package's ``shard_map`` and
  ``lax`` collectives);
* :mod:`.ring` — ring attention over the flash kernels, and Ulysses;
* :mod:`.pipeline` — the GPipe schedule; :mod:`.moe` — the Switch MoE;
* :mod:`.lm` — the dense, sp, pp and ep LM trainers;
* :mod:`.spmd` and :mod:`.fused_opt` — the fused one-program training
  step on one device and its optimizer rules.
"""
from .mesh import Mesh, build_mesh, local_mesh  # noqa: F401
from .moe import moe_ffn  # noqa: F401
from .pipeline import pipeline_apply  # noqa: F401
from .ring import ring_attention, ulysses_attention  # noqa: F401
from .spmd import SPMDTrainer

__all__ = ["Mesh", "build_mesh", "local_mesh", "moe_ffn", "pipeline_apply",
           "ring_attention", "ulysses_attention", "SPMDTrainer"]
