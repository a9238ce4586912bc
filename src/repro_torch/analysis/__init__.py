"""Static + runtime analysis for the coordination plane.

``pdlint`` (:mod:`repro_torch.analysis.pdlint`) statically enforces the
concurrency contracts of the port's sharded store (``src/repro_torch/core``);
the lock-order witness (:mod:`repro_torch.analysis.witness`) validates the
static lock graph against real executions when ``REPRO_LOCK_WITNESS=1``.
"""

from .model import Finding, build_project

__all__ = ["Finding", "build_project"]
