from .checkpoint import load_checkpoint
from .tester import Tester
from .train_state import make_eval_step, make_train_step

__all__ = ["Tester", "load_checkpoint", "make_eval_step", "make_train_step"]
