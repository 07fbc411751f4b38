"""Training on one card: the BPTT train step and its optimizer."""
from .train_step import make_optimizer, make_train_step, set_lr, step_lr

__all__ = ["make_optimizer", "make_train_step", "set_lr", "step_lr"]
