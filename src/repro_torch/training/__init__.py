"""Training: the counterpart of ``repro.training`` (the ``PilotTrainer``
CU needs the Session runtime and comes with it)."""

from .train_step import make_eval_step, make_train_step

__all__ = ["make_eval_step", "make_train_step"]
