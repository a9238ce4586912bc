"""Learning-rate schedules (functions of the step): the counterpart of
``repro.optim.schedules`` (its ``constant`` and ``linear_decay`` have no
caller in either package and are not copied).  ``step`` is a tensor; the result is an fp32
tensor on its device."""

from __future__ import annotations

import math

import torch


def warmup_cosine(
    step: torch.Tensor,
    peak_lr: float,
    warmup_steps: int,
    total_steps: int,
    final_frac: float = 0.1,
) -> torch.Tensor:
    """Linear warmup from 0 (so the lr at step 0 is 0), then cosine decay to
    ``final_frac * peak_lr`` at ``total_steps``."""
    step = step.float()
    warm = peak_lr * step / max(1.0, warmup_steps)
    progress = torch.clamp((step - warmup_steps) / max(1.0, total_steps - warmup_steps), 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * progress)))
    return torch.where(step < warmup_steps, warm, cos)
