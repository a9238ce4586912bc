"""Optimizer, schedules and gradient compression: the counterpart of
``repro.optim`` (the int8 compressed all-reduce is
:mod:`.compression`)."""

from .adamw import (
    AdamWConfig,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_adamw,
)
from .schedules import warmup_cosine

__all__ = [
    "AdamWConfig",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "init_adamw",
    "warmup_cosine",
]
