from .lr_scheduler import PolyLR, StepWarmUpLR, WarmupLR
from .sgd import SGD

__all__ = ["SGD", "PolyLR", "StepWarmUpLR", "WarmupLR"]
