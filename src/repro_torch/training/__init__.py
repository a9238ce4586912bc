"""Training: the counterpart of ``repro.training``.  ``PilotTrainer``, the
chunk-CU driver on the port's Session runtime, lives in
:mod:`repro_torch.training.trainer`."""

from .train_step import make_eval_step, make_train_step

__all__ = ["make_eval_step", "make_train_step"]
