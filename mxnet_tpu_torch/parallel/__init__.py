"""The port's counterpart of ``mxnet_tpu/parallel``: the fused one-program
training step on one device (:mod:`.spmd`) and its optimizer rules
(:mod:`.fused_opt`). Meshes, collectives and sharded parameters wait for
``ROADMAP.md`` A6."""
