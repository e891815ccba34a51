"""Learning-rate schedulers (counterpart of
``incubator_mxnet_tpu/lr_scheduler.py``, kept as the port's own copy;
reference python/mxnet/lr_scheduler.py): a scheduler maps the
optimizer's update count to a learning rate, starting from the
optimizer's ``learning_rate`` (``Optimizer`` sets ``base_lr``)."""
from __future__ import annotations

import logging
import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler", "WarmupScheduler"]


class LRScheduler:
    """Base: maps num_update -> lr (reference lr_scheduler.py:LRScheduler)."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every `step` updates (reference FactorScheduler)."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01):
        super().__init__(base_lr)
        if step < 1:
            raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info(
                    "Update[%d]: now learning rate arrived at %0.5e, will not "
                    "change in the future", num_update, self.base_lr)
            else:
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at given steps (reference MultiFactorScheduler)."""

    def __init__(self, step, factor=1, base_lr=0.01):
        super().__init__(base_lr)
        if not (isinstance(step, list) and len(step) >= 1):
            raise ValueError('expected isinstance(step, list) and len(step) >= 1')
        for i, _step in enumerate(step):
            if i != 0 and step[i] <= step[i - 1]:
                raise ValueError("Schedule step must be an increasing integer list")
            if _step < 1:
                raise ValueError("Schedule step must be greater or equal than 1")
        if factor > 1.0:
            raise ValueError("Factor must be no more than 1 to make lr reduce")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
                logging.info("Update[%d]: Change learning rate to %0.5e",
                             num_update, self.base_lr)
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay to zero at max_update (reference PolyScheduler)."""

    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        if not (isinstance(max_update, int)):
            raise ValueError('expected isinstance(max_update, int)')
        if max_update < 1:
            raise ValueError("maximum number of updates must be strictly positive")
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.power = pwr

    def __call__(self, num_update):
        if num_update <= self.max_update:
            self.base_lr = self.base_lr_orig * \
                pow(1.0 - float(num_update) / float(self.max_update), self.power)
        return self.base_lr


class CosineScheduler(LRScheduler):
    """Cosine decay with floor (extension; standard for TPU training runs)."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0.0):
        super().__init__(base_lr)
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr

    def __call__(self, num_update):
        if num_update <= self.max_update:
            self.base_lr = self.final_lr + (self.base_lr_orig - self.final_lr) * \
                (1 + math.cos(math.pi * num_update / self.max_update)) / 2
        return self.base_lr


class WarmupScheduler(LRScheduler):
    """Linear warmup wrapping another scheduler (extension; the reference's
    LBSGD warmup generalized)."""

    def __init__(self, warmup_steps, scheduler, begin_lr=0.0):
        super().__init__(scheduler.base_lr)
        self.warmup_steps = warmup_steps
        self.scheduler = scheduler
        self.begin_lr = begin_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.begin_lr + (self.scheduler.base_lr - self.begin_lr) * \
                num_update / self.warmup_steps
        return self.scheduler(num_update)
