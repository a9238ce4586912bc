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
port's own backward kernel, on CPU tensors it runs ``ssd_bwd_ref``) and
``causal_conv.ops.causal_conv_silu`` (C1, the Mamba2 mixer's causal conv,
bias and SiLU, an autograd Function both ways; it replaces no Pallas
call).  Each
counts its launches in integer attributes (``launches``, and
``backward_launches`` / ``residual_launches`` where it has them) through
:func:`count_launch`, which takes a lock: serve and train CUs call the
wrappers from several agent threads at once.

Each package's ``cost(...)`` gives one launch's :class:`KernelCost`.  On
``meta`` tensors (the dry run, :mod:`repro_torch.launch.dryrun`) a wrapper
runs the CUDA path's instance checks, returns empty tensors of the kernel's
outputs and builds nothing.  On meta and on CUDA tensors each launch is
reported with its cost to the active observers (:func:`launch`;
``repro_torch.launch.op_analysis.OpAnalysis`` is one), which then count
the kernel in place of the tensor ops its wrapper runs.  The observers
are a module-level list, as the counters are attributes: the kernels are
called deep inside model code, on any thread.  The launch counters count
CUDA launches only.
"""

import contextlib
import threading
from typing import NamedTuple

_count_lock = threading.Lock()
#: objects with ``begin_kernel()`` and ``end_kernel(name, cost)`` that want
#: each launch (every thread's: the backward pass runs on autograd's)
_observers: list = []


class KernelCost(NamedTuple):
    """One launch's work: the bytes it must move (each input read once,
    each output written once), the operations it needs (``flops``), and
    the operations it executes (``ops``: 3 x ``flops`` for 3xTF32) at the
    peak rate ``peak`` (operations per second) of the units that run them."""

    bytes: int
    flops: int
    ops: int
    peak: float

    @property
    def compute_s(self) -> float:
        return self.ops / self.peak


def observe(observer) -> None:
    with _count_lock:
        _observers.append(observer)


def unobserve(observer) -> None:
    with _count_lock:
        _observers.remove(observer)


@contextlib.contextmanager
def launch(name: str, cost_fn):
    """The scope of one launch of kernel ``name`` (a meta branch or a CUDA
    launch): the observers count ``cost_fn()`` for it in place of the tensor
    ops inside the scope."""
    observers = list(_observers)
    if not observers:
        yield
        return
    for o in observers:
        o.begin_kernel()
    ok = False
    try:
        yield
        ok = True
    finally:
        cost = cost_fn() if ok else None
        for o in observers:
            o.end_kernel(name, cost)


def count_launch(wrapper, attr: str = "launches") -> None:
    """Add one to ``wrapper.<attr>`` (read-modify-write under a lock)."""
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
