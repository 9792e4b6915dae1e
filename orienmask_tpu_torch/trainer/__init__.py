from .train_state import make_eval_step, make_train_step

__all__ = ["make_eval_step", "make_train_step"]
