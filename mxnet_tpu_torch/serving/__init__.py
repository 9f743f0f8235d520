"""LLM serving engine — paged KV-cache attention + continuous batching (the
port of ``mxnet_tpu/serving``).

A standing inference engine over the Transformer-LM zoo model. Sequences
share one device's KV memory through a block-paged ragged cache and a
continuous-batching scheduler mixes prefill and decode into padded shape
buckets.

Layers:

* :mod:`.kv_cache`  — the device block pool (torch pages) + host allocator.
* :mod:`.model`     — the functional Transformer-LM forward: full-sequence
  prefill (flash attention, ``csrc/flash_fwd.cu`` on the card) and the
  fused one-token paged decode step (``csrc/paged_decode.cu``).
* :mod:`.scheduler` — admission queue, per-request state machine, FCFS
  continuous batching, block-exhaustion preemption (host-only).
* :mod:`.graphs`    — :class:`~.graphs.BucketGraph`: one program per
  shape bucket, a CUDA graph captured once and replayed on the card.
* :mod:`.engine`    — :class:`ServingEngine`: ``submit``/``step``/``generate``.
* :mod:`.obs`       — per-request lifecycle events, phase attribution, SLOs.
* :mod:`.resilience` — load shedding, deadlines/cancellation and
  :class:`EngineSupervisor`.

Front ends: ``python -m mxnet_tpu_torch.tools.serve`` (HTTP/JSON standing
server with live stat columns) and ``python -m
mxnet_tpu_torch.tools.bench_serving`` (offline benchmark, one JSON
record).
"""
from .engine import ServingConfig, ServingEngine
from .kv_cache import KVBlockPool, KVCacheOOM
from .obs import PHASES, RequestTrace, ServingObs
from .resilience import EngineSupervisor, ServingOverloadError, retry_after_s
from .scheduler import (CANCELLED, FAILED, FINISHED, TIMED_OUT, Request,
                        Scheduler)

__all__ = ["ServingConfig", "ServingEngine", "KVBlockPool", "KVCacheOOM",
           "Request", "Scheduler", "ServingObs", "RequestTrace", "PHASES",
           "EngineSupervisor", "ServingOverloadError", "retry_after_s",
           "FINISHED", "FAILED", "TIMED_OUT", "CANCELLED"]
