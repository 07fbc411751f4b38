"""Training on one card or data-parallel over cards: the BPTT train step,
its optimizer, and the mesh (``mesh.py``); serving one stream's rows over
cards (``spatial.py``)."""
from .train_step import make_optimizer, make_train_step, set_lr, step_lr

__all__ = ["make_optimizer", "make_train_step", "set_lr", "step_lr"]
