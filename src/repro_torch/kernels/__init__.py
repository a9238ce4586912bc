"""Hand-written Hopper kernels for the port's hot spots.

Each kernel package ships three layers, as the JAX package's do:
  * the kernel: CUDA C++ under ``csrc/`` (built by :mod:`.build` with nvcc
    for sm_90a and bound with ctypes) or a Triton module;
  * ``ops.py``  -- the wrapper: checks device, dtype, shape and strides,
                   launches the kernel on CUDA tensors, runs the plain
                   version on CPU tensors, and counts launches;
  * ``ref.py``  -- the plain PyTorch version of the same function.

Nothing here builds or imports a kernel when the package is imported.
The wrappers are ``decode_attention.ops.decode_attention``,
``flash_attention.ops.flash_attention`` (an autograd Function with a
backward kernel), ``rmsnorm.ops.rmsnorm`` (likewise) and
``ssd_scan.ops.ssd`` (likewise: on CUDA tensors its backward launches the
port's own backward kernel, on CPU tensors it runs ``ssd_bwd_ref``).  Each
counts its launches in integer attributes (``launches``, and
``backward_launches`` / ``residual_launches`` where it has them) through
:func:`count_launch`, which takes a lock: serve and train CUs call the
wrappers from several agent threads at once.
"""

import threading

_count_lock = threading.Lock()


def count_launch(wrapper, attr: str = "launches") -> None:
    """Add one to ``wrapper.<attr>`` (read-modify-write under a lock)."""
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
