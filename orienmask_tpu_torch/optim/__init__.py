from .lr_scheduler import PolyLR, StepWarmUpLR, WarmupLR
from .param_groups import param_group_factors
from .sgd import SGD

__all__ = ["SGD", "PolyLR", "StepWarmUpLR", "WarmupLR", "param_group_factors"]
