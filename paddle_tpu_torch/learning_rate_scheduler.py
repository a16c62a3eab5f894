"""Dygraph learning-rate schedulers.

A copy of `paddle_tpu/fluid/dygraph/learning_rate_scheduler.py`, which
is pure Python: the ``LearningRateDecay`` base (``step()`` advances,
``__call__`` advances and reads), NoamDecay, PiecewiseDecay,
NaturalExpDecay, ExponentialDecay, InverseTimeDecay, PolynomialDecay,
CosineDecay, LinearLrWarmup and ReduceLROnPlateau.  An optimizer of
`paddle_tpu_torch.optimizer` takes an instance as ``learning_rate`` and
advances and reads it once per ``minimize``.
"""

from __future__ import annotations

import math


class LearningRateDecay:
    def __init__(self, begin=0, step=1):
        self.step_num = begin
        self.step_size = step

    def step(self):
        """Advance (cf. reference: called once per optimizer step/epoch)."""
        self.step_num += self.step_size

    def __call__(self):
        """Advance-and-read (reference __call__ semantics: the optimizer
        invokes this once per minimize)."""
        self.step_num += self.step_size
        return float(self.get_lr())

    def get_lr(self):
        raise NotImplementedError


class NoamDecay(LearningRateDecay):
    """cf. reference NoamDecay: lr = d^-0.5 * min(n^-0.5, n * warmup^-1.5)."""

    def __init__(self, d_model, warmup_steps, learning_rate=1.0, begin=1, step=1):
        super().__init__(begin=max(begin, 1), step=step)
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        self.base = learning_rate

    def get_lr(self):
        n = max(self.step_num, 1)
        return (self.base * self.d_model ** -0.5
                * min(n ** -0.5, n * self.warmup_steps ** -1.5))


class PiecewiseDecay(LearningRateDecay):
    def __init__(self, boundaries, values, begin=0, step=1):
        super().__init__(begin, step)
        self.boundaries = list(boundaries)
        self.values = list(values)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.step_num < b:
                return v
        return self.values[len(self.boundaries)]


class ExponentialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr0, self.decay_steps = learning_rate, decay_steps
        self.decay_rate, self.staircase = decay_rate, staircase

    def get_lr(self):
        p = self.step_num / self.decay_steps
        if self.staircase:
            p = math.floor(p)
        return self.lr0 * self.decay_rate ** p


class NaturalExpDecay(ExponentialDecay):
    def get_lr(self):
        p = self.step_num / self.decay_steps
        if self.staircase:
            p = math.floor(p)
        return self.lr0 * math.exp(-self.decay_rate * p)


class InverseTimeDecay(ExponentialDecay):
    def get_lr(self):
        p = self.step_num / self.decay_steps
        if self.staircase:
            p = math.floor(p)
        return self.lr0 / (1 + self.decay_rate * p)


class PolynomialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, end_learning_rate=1e-4,
                 power=1.0, cycle=False, begin=0, step=1):
        super().__init__(begin, step)
        self.lr0, self.decay_steps = learning_rate, decay_steps
        self.end_lr, self.power, self.cycle = end_learning_rate, power, cycle

    def get_lr(self):
        n = self.step_num
        steps = self.decay_steps
        if self.cycle:
            div = max(1.0, math.ceil(n / steps))
            steps = steps * div
        else:
            n = min(n, steps)
        return ((self.lr0 - self.end_lr)
                * (1 - n / steps) ** self.power + self.end_lr)


class CosineDecay(LearningRateDecay):
    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0, step=1):
        super().__init__(begin, step)
        self.lr0 = learning_rate
        self.step_each_epoch = step_each_epoch
        self.epochs = epochs

    def get_lr(self):
        epoch = self.step_num // self.step_each_epoch
        return self.lr0 / 2 * (math.cos(epoch * math.pi / self.epochs) + 1)


class LinearLrWarmup(LearningRateDecay):
    def __init__(self, learning_rate, warmup_steps, start_lr, end_lr,
                 begin=0, step=1):
        super().__init__(begin, step)
        self.wrapped = learning_rate  # float or LearningRateDecay
        self.warmup_steps = warmup_steps
        self.start_lr, self.end_lr = start_lr, end_lr

    def get_lr(self):
        if self.step_num < self.warmup_steps:
            return (self.start_lr
                    + (self.end_lr - self.start_lr)
                    * self.step_num / self.warmup_steps)
        if isinstance(self.wrapped, LearningRateDecay):
            return self.wrapped.get_lr()
        return float(self.wrapped)


class ReduceLROnPlateau(LearningRateDecay):
    """cf. reference ReduceLROnPlateau: shrink lr when a metric stalls."""

    def __init__(self, learning_rate, mode="min", decay_rate=0.1, patience=10,
                 threshold=1e-4, cooldown=0, min_lr=0.0):
        super().__init__()
        self.lr = float(learning_rate)
        self.mode = mode
        self.decay_rate = decay_rate
        self.patience = patience
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0

    def get_lr(self):
        return self.lr

    def __call__(self):
        return self.lr  # advances only via step(metric)

    def step(self, metric=None):
        if metric is None:
            return
        metric = float(metric)
        better = (
            self.best is None
            or (self.mode == "min" and metric < self.best - self.threshold)
            or (self.mode == "max" and metric > self.best + self.threshold)
        )
        if better:
            self.best = metric
            self.num_bad = 0
        elif self.cooldown_counter > 0:
            self.cooldown_counter -= 1
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.decay_rate, self.min_lr)
                self.cooldown_counter = self.cooldown
                self.num_bad = 0
