"""Per-iteration LR schedules as step -> lr functions (counterpart of
``orienmask_tpu/optim/lr_scheduler.py``).  The trainer evaluates
``scheduler(step)`` on the host once per optimizer iteration; milestones
count iterations, not epochs."""

import bisect
import math


class WarmupLR:
    def __init__(self, warmup_type, warmup_iter, warmup_ratio):
        assert warmup_type in ("const", "linear", "power")
        self.type = warmup_type
        self.iter = warmup_iter
        self.ratio = warmup_ratio

    def get_warmup_lr(self, iters, base_lr):
        if self.type == "const":
            return base_lr * self.ratio
        if self.type == "linear":
            return base_lr * (self.ratio + (1 - self.ratio) * iters / self.iter)
        return base_lr * ((iters / self.iter) ** self.ratio)


class StepWarmUpLR:
    """Warmup up to ``warmup_iter``, multi-step gamma decay after."""

    def __init__(self, warmup_type, warmup_iter, warmup_ratio, milestones,
                 gamma=0.1, base_lr=None):
        self.warmup = WarmupLR(warmup_type, warmup_iter, warmup_ratio)
        self.milestones = sorted(milestones)
        self.gamma = gamma
        self.base_lr = base_lr

    def __call__(self, step, base_lr=None):
        base_lr = base_lr if base_lr is not None else self.base_lr
        if step <= self.warmup.iter:
            return self.warmup.get_warmup_lr(step, base_lr)
        # The reference's stateful MultiStepLR never resets the lr after
        # warmup: the base after it is what the last warmup step set, which
        # is base_lr * ratio for ever under 'const'.
        eff_base = self.warmup.get_warmup_lr(self.warmup.iter, base_lr)
        return eff_base * self.gamma ** bisect.bisect_right(self.milestones, step)


class PolyLR:
    def __init__(self, max_iter, power=0.9, base_lr=None):
        self.max_iter = max_iter
        self.power = power
        self.base_lr = base_lr

    def __call__(self, step, base_lr=None):
        base_lr = base_lr if base_lr is not None else self.base_lr
        # 0 past max_iter, where the reference's math.pow would raise
        return base_lr * math.pow(max(0.0, 1 - step / self.max_iter), self.power)
