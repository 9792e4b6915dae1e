from .builder import build_tester, build_trainer
from .checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from .tester import Tester
from .train_state import make_eval_step, make_train_step
from .trainer import Trainer

__all__ = ["CheckpointManager", "Tester", "Trainer", "build_tester", "build_trainer",
           "load_checkpoint", "make_eval_step", "make_train_step", "save_checkpoint"]
