"""Runtime analysis for the port's copy of the coordination plane.

Only the lock-order witness (:mod:`repro_torch.analysis.witness`, a copy of
``repro.analysis.witness``) is here: with ``REPRO_LOCK_WITNESS=1``
``repro_torch.core.coordination`` creates every store lock through it.  The
JAX package's static linters of the runtime's source (``model``, ``rules``,
``pdlint``, ``lockgraph``) have no copy yet.
"""
