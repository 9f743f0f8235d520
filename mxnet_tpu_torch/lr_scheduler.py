"""Learning-rate schedules of the port (counterpart of
``mxnet_tpu/lr_scheduler.py``, its copy; reference:
python/mxnet/lr_scheduler.py: LRScheduler, FactorScheduler :28,
MultiFactorScheduler :66; PolyScheduler appears in its examples).

Closed form, as in the JAX package: each call maps ``num_update``
directly to a rate instead of replaying a mutable decay loop, so a
schedule can be evaluated from the fused step's host hook
(:func:`.parallel.fused_opt.host_step_values`, which writes the rate into
the step's device scalar before every CUDA graph replay), from resumed
counters and from out-of-order probes alike. Boundaries are crossed when
``num_update`` exceeds them (strict ``>``), ``stop_factor_lr`` floors a
factor decay, and each newly crossed boundary is logged once.
``self.base_lr`` mirrors the last value returned (``Optimizer`` assigns
``base_lr`` after construction, so the pristine rate is captured at the
first call). CosineScheduler (warmup + cosine decay) is the JAX
package's extension; the reference has none.
"""
from __future__ import annotations

import logging
import math
from bisect import bisect_left

__all__ = [
    "LRScheduler", "FactorScheduler", "MultiFactorScheduler", "PolyScheduler",
    "CosineScheduler",
]


class LRScheduler:
    """Base: ``scheduler(num_update) -> lr``."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr
        self._lr0 = None  # pristine rate, captured at first call

    def _origin(self):
        if self._lr0 is None:
            self._lr0 = self.base_lr
        return self._lr0

    def __call__(self, num_update):
        raise NotImplementedError("must override this")


class _DecayBySteps(LRScheduler):
    """Shared machinery: lr = pristine * factor^(number of boundaries passed),
    with an optional floor, logging once per newly-crossed boundary."""

    def __init__(self, factor, stop_factor_lr=0.0):
        super().__init__()
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so the rate never grows")
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self._seen_decays = 0

    def _num_decays(self, num_update):
        raise NotImplementedError

    def __call__(self, num_update):
        decays = self._num_decays(num_update)
        lr = self._origin() * self.factor ** decays
        floored = self.stop_factor_lr and lr < self.stop_factor_lr
        if floored:
            lr = self.stop_factor_lr
        if decays > self._seen_decays:
            self._seen_decays = decays
            if floored:
                logging.info(
                    "Update[%d]: learning rate floored at %0.5e; no further decay",
                    num_update, lr,
                )
            else:
                logging.info("Update[%d]: learning rate is now %0.5e", num_update, lr)
        self.base_lr = lr
        return lr


class FactorScheduler(_DecayBySteps):
    """Multiply by ``factor`` once per ``step`` updates (reference contract:
    lr_scheduler.py:28-63, including the strict ``>`` boundary)."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        if step < 1:
            raise ValueError("step must be >= 1 update")
        super().__init__(factor, stop_factor_lr)
        self.step = step

    def _num_decays(self, num_update):
        return max(0, num_update - 1) // self.step


class MultiFactorScheduler(_DecayBySteps):
    """Multiply by ``factor`` when crossing each boundary in ``step``
    (reference contract: lr_scheduler.py:66-98)."""

    def __init__(self, step, factor=1):
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty list of update counts")
        if any(s < 1 for s in step) or any(
            b <= a for a, b in zip(step, step[1:])
        ):
            raise ValueError("step must be a strictly increasing list of "
                             "updates >= 1")
        super().__init__(factor)
        self.step = step

    def _num_decays(self, num_update):
        # boundaries are passed once num_update EXCEEDS them (strict >)
        return bisect_left(self.step, num_update)


class PolyScheduler(LRScheduler):
    """Polynomial decay to zero across ``max_update`` updates."""

    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        if max_update < 1:
            raise ValueError("max_update must be >= 1")
        self.max_update = max_update
        self.power = pwr

    def __call__(self, num_update):
        frac = min(num_update, self.max_update) / float(self.max_update)
        self.base_lr = self._origin() * (1.0 - frac) ** self.power
        return self.base_lr


class CosineScheduler(LRScheduler):
    """Linear warmup to the base rate, then cosine decay to ``final_lr``
    across ``max_update`` updates (extension; no reference counterpart)."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0.0, warmup_steps=0):
        super().__init__(base_lr)
        if max_update < 1:
            raise ValueError("max_update must be >= 1")
        if not 0 <= warmup_steps < max_update:
            raise ValueError("need 0 <= warmup_steps < max_update")
        self.max_update = max_update
        self.final_lr = final_lr
        self.warmup_steps = warmup_steps

    def __call__(self, num_update):
        peak = self._origin()
        if num_update < self.warmup_steps:
            lr = peak * (num_update + 1) / max(1, self.warmup_steps)
        elif num_update >= self.max_update:
            lr = self.final_lr
        else:
            span = self.max_update - self.warmup_steps
            done = (num_update - self.warmup_steps) / span
            lr = self.final_lr + 0.5 * (peak - self.final_lr) * (
                1 + math.cos(math.pi * done)
            )
        self.base_lr = lr
        return lr
