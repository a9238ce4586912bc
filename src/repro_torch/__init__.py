"""PyTorch/CUDA port of the ``repro`` ML workload, for NVIDIA Hopper GPUs.

The package mirrors the layout and names of the JAX package ``repro`` so that
each module has an obvious counterpart, but it imports nothing from it (and
never imports ``jax``): the few framework-free pieces it needs, the config
dataclasses and the checkpoint array codec, are copies kept here.

The parameter tree keeps the JAX key paths, shapes and the stacked leading
``groups`` dimension, so a checkpoint written by either package loads in the
other (see :mod:`repro_torch.bridge`).

Entry points (:func:`repro_torch.models.build_model`,
:class:`repro_torch.serving.DecodeEngine`) run on ``device="cuda"`` unless the
caller asks for the CPU, and raise when CUDA is absent.  On a CUDA tensor each
kernel wrapper launches its hand-written kernel; on a CPU tensor it runs the
kernel's plain PyTorch version.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
