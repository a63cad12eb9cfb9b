"""Learning-rate schedulers (the port of ``mxnet_tpu/lr_scheduler.py``;
ref: python/mxnet/lr_scheduler.py): plain Python over the update
count, the same arithmetic in the same order."""
from __future__ import annotations

import math


class LRScheduler:
    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        if warmup_mode not in ("linear", "constant"):
            # the reference validates the same two modes (ref:
            # python/mxnet/lr_scheduler.py:44); anything else silently
            # becoming a quadratic ramp drifted every warmup
            raise ValueError(
                f"warmup_mode must be 'linear' or 'constant', got "
                f"{warmup_mode!r}")
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) * \
                num_update / self.warmup_steps
            return self.warmup_begin_lr + inc
        # constant: hold the warmup LR flat until warmup ends (ref:
        # lr_scheduler.py:59 — returns warmup_begin_lr)
        return self.warmup_begin_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        if step < 1:
            raise ValueError("step must be >= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while num_update > self.count + self.step:
            self.count += self.step
            self.base_lr *= self.factor
            if self.base_lr < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    def __init__(self, step, factor=1.0, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.step = list(step)
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        while self.cur_step_ind <= len(self.step) - 1:
            if num_update > self.step[self.cur_step_ind]:
                self.count = self.step[self.cur_step_ind]
                self.cur_step_ind += 1
                self.base_lr *= self.factor
            else:
                return self.base_lr
        return self.base_lr


class PolyScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.power = pwr
        self.base_lr_orig = self.base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = self.final_lr + (self.base_lr_orig - self.final_lr) * \
                (1 - (num_update - self.warmup_steps) / self.max_steps) ** self.power
        return self.base_lr


class CosineScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, final_lr=0, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = self.max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update <= self.max_update:
            self.base_lr = self.final_lr + (self.base_lr_orig - self.final_lr) * \
                (1 + math.cos(math.pi * (num_update - self.warmup_steps)
                              / self.max_steps)) / 2
        return self.base_lr
