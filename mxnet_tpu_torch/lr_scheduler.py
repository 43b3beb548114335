"""Learning-rate schedules: ``FactorScheduler`` and ``MultiFactorScheduler``.

The JAX package's closed forms: each schedule maps the optimizer's global
update count to a learning rate, the same answer for any query order.
``base_lr`` is set by the optimizer.
"""
from __future__ import annotations

import bisect

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler"]


class LRScheduler:
    """Maps the global update count to a learning rate."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError("subclass must implement __call__()")


class FactorScheduler(LRScheduler):
    """``base_lr * factor ** floor((u - 1) / step)``, not below
    ``stop_factor_lr``."""

    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError(f"step must be >= 1, got {step}")
        if factor > 1.0:
            raise ValueError(f"a decay factor > 1 would grow the lr: {factor}")
        self.step = int(step)
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def __call__(self, num_update):
        n_decays = max(0, (int(num_update) - 1) // self.step)
        return max(self.base_lr * self.factor ** n_decays,
                   self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """``base_lr * factor ** k`` with k the number of milestones in
    ``step`` strictly below the update count."""

    def __init__(self, step, factor=1.0):
        super().__init__()
        if not step or any(s < 1 for s in step):
            raise ValueError(f"milestones must be positive ints: {step}")
        if any(b <= a for a, b in zip(step, step[1:])):
            raise ValueError(f"milestones must be strictly increasing: {step}")
        if factor > 1.0:
            raise ValueError(f"a decay factor > 1 would grow the lr: {factor}")
        self.step = list(step)
        self.factor = factor

    def __call__(self, num_update):
        return self.base_lr * self.factor ** bisect.bisect_left(
            self.step, int(num_update))
