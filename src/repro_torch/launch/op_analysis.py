"""Per-device op analysis of a step: FLOPs, HBM traffic, collective bytes
per mesh dim, kernel launches and the peak of live memory; the counterpart
of ``repro.launch.hlo_analysis``.

There is no HLO to parse.  :class:`OpAnalysis` is a ``TorchDispatchMode``
that sees every aten op a step runs, eagerly, on CUDA, meta or DTensor
inputs (ops on host tensors alone do no device work and are not counted):

  * ops on ``DTensor`` s are handed back to DTensor (the mode returns
    ``NotImplemented``), which redistributes and runs them on the local
    tensors, ops that the mode then sees; the sharding propagator's own
    shape inference runs on ``FakeTensor`` s and is skipped.  Every count
    is therefore **per device**, from the local shards, as the JAX
    analyser's are from the post-partitioning module;
  * **flops**: 2·|result|·K over the products (``mm``, ``addmm``,
    ``bmm``, ``baddbmm``: what ``linear``, ``matmul`` and ``einsum``
    decompose into), each also timed at its own dtype's peak (bf16 and
    fp16 on the tensor cores; fp32 on the CUDA cores, or in TF32 when
    ``torch.backends.cuda.matmul.allow_tf32`` is set).  Elementwise
    operations count no FLOPs, as in the JAX analyser;
  * **hbm_bytes**: each op's tensor operands plus its results, once per op
    (an op that overwrites its first operand, ``copy_``, ``fill_``,
    ``zero_``, does not read it).  Views, ``detach`` and the other ops
    whose results alias their inputs, and allocations (``empty``), are
    free.  Eager PyTorch on the card fuses nothing, so the JAX analyser's
    simulation of the TPU's elementwise fusion is left out on purpose: each
    op here is a kernel that reads and writes device memory;
  * **collective_bytes** / **collective_per_axis**: the operand bytes of
    each collective (``_c10d_functional``'s ``all_gather_into_tensor``,
    ``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single`` and
    the ``c10d`` ops that ``torch.distributed`` calls), attributed to the
    mesh dim of its process group (by the group's name, else its size);
  * **kernels**: ``{name: {launches, bytes, flops, seconds_at_peak}}``
    from the kernel wrappers' reports (:func:`repro_torch.kernels.launch`):
    the ops a wrapper runs inside a launch count as the kernel's
    ``cost(...)`` and not one by one, on meta and on CUDA tensors alike;
  * **memory**: the bytes of live storages, each counted once however many
    views share it (a DTensor wrapper has no storage of its own: its local
    tensor does), from the storages that :meth:`OpAnalysis.track` is given
    and those the ops make, freed when the storage is; autograd's saved
    tensors are live for as long as autograd holds them.  ``peak_bytes`` is
    the most that was live at once.

The mode is thread-safe enough for the backward pass, which runs on
autograd's thread while the caller waits.
"""

from __future__ import annotations

import collections
import threading
import weakref
from typing import Any, Dict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .. import kernels
from . import roofline

_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm"}
#: the operand that holds the product's left factor
_LHS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}
_ALLOC = {"empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided"}
_FREE = {"detach", "alias", "lift_fresh", "_local_scalar_dense", "wait_tensor",
         "_wrap_tensor_autograd", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset"}
#: ops that overwrite their first operand without reading it
_OVERWRITE = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_", "bernoulli_"}
#: collective op name -> (kind, index of the operand it sends)
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 1),
    "allgather_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "all_reduce": ("all-reduce", 0),
    "all_reduce_": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "all_to_all_single": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 1),
    "alltoall_": ("all-to-all", 1),
    "broadcast": ("broadcast", 0),
    "broadcast_": ("broadcast", 0),
}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _aliases(func) -> bool:
    """The op's results are views of its inputs (not writes into them)."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def product_peak(dtype: torch.dtype) -> float:
    """The peak rate of a product in ``dtype`` on the card."""
    if dtype in (torch.bfloat16, torch.float16):
        return roofline.BF16_FLOPS
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return roofline.TF32_FLOPS
    return roofline.FP32_FLOPS


def group_axes(mesh) -> Dict[str, str]:
    """Process-group name -> the mesh dim whose group it is."""
    if mesh is None:
        return {}
    return {mesh.get_group(n).group_name: n for n in mesh.mesh_dim_names}


class OpAnalysis(TorchDispatchMode):
    """Counts a step per device; enter it around the step (see the module's
    docstring), then read :meth:`result`."""

    def __init__(self, mesh=None):
        super().__init__()
        self._groups = group_axes(mesh)
        self.flops = 0
        self.hbm_bytes = 0
        self.compute_seconds = 0.0
        self.coll_op: Dict[str, int] = collections.Counter()
        self.coll_axis: Dict[str, int] = collections.Counter()
        self.coll_count: Dict[str, int] = collections.Counter()
        self.op_hist: Dict[str, int] = collections.Counter()
        self.kernels: Dict[str, Dict[str, Any]] = {}
        self._in_kernel = 0
        self._lock = threading.RLock()
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    # ------------------------------------------------------------- memory
    def track(self, *trees) -> int:
        """Counts the storages of the tensors in ``trees`` (the local tensors
        of DTensors) as live; returns the bytes newly counted."""
        from ..distributed.context import is_dtensor

        before = self.live_bytes
        for t in _tensors(list(trees)):
            self._track(t._local_tensor if is_dtensor(t) else t)
        return self.live_bytes - before

    def _track(self, t: torch.Tensor) -> None:
        if type(t) is not torch.Tensor and not isinstance(t, torch.nn.Parameter):
            return
        st = t.untyped_storage()
        key = id(st)
        with self._lock:
            if key in self._live:
                return
            n = st.nbytes()
            self._live[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        with self._lock:
            self.live_bytes -= self._live.pop(key, 0)

    # ------------------------------------------------------------ kernels
    def begin_kernel(self) -> None:
        with self._lock:
            self._in_kernel += 1

    def end_kernel(self, name: str, cost) -> None:
        with self._lock:
            self._in_kernel -= 1
            if cost is None:
                return
            k = self.kernels.setdefault(
                name, {"launches": 0, "bytes": 0, "flops": 0, "seconds_at_peak": 0.0})
            k["launches"] += 1
            k["bytes"] += cost.bytes
            k["flops"] += cost.flops
            k["seconds_at_peak"] += cost.compute_s
            self.flops += cost.flops
            self.hbm_bytes += cost.bytes
            self.compute_seconds += cost.compute_s

    def __enter__(self):
        kernels.observe(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            kernels.unobserve(self)

    # --------------------------------------------------------------- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on the local tensors, which we see
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out  # the sharding propagator's shape inference
        if all(t.device.type == "cpu" for t in ins + outs):
            return out  # a host op (an RNG state, a Python scalar): no device work
        for t in outs:
            self._track(t)
        if self._in_kernel:
            return out
        self._count(func, args, ins, outs)
        return out

    def _count(self, func, args, ins, outs) -> None:
        name = func._overloadpacket.__name__
        ns = func.namespace
        with self._lock:
            self.op_hist[name] += 1
            if ns in ("_c10d_functional", "c10d") and name in _COLLECTIVES:
                self._collective(name, args)
            if name in _ALLOC or name in _FREE or _aliases(func):
                return
            if name in _PRODUCTS:
                lhs = args[_LHS[name]]
                flops = 2 * outs[0].numel() * lhs.shape[-1]
                self.flops += flops
                self.compute_seconds += flops / product_peak(lhs.dtype)
            skip = ins[0] if name in _OVERWRITE and ins else None
            self.hbm_bytes += (sum(_nbytes(t) for t in ins if t is not skip)
                               + sum(_nbytes(t) for t in outs))

    def _collective(self, name: str, args) -> None:
        kind, index = _COLLECTIVES[name]
        sent = _tensors(args[index]) if index < len(args) else []
        n = sum(_nbytes(t) for t in sent)
        axis = self._axis(args)
        self.coll_op[kind] += n
        self.coll_axis[axis] += n
        self.coll_count[kind] += 1

    def _axis(self, args) -> str:
        """The mesh dim of a collective's group, by the group's name: a
        ``_c10d_functional`` op's string argument, a ``c10d`` op's process
        group."""
        import torch.distributed as dist

        for a in args:
            if isinstance(a, str) and a in self._groups:
                return self._groups[a]
            if type(a).__name__ == "ScriptObject":
                try:
                    name = dist.ProcessGroup.unbox(a).group_name
                except RuntimeError:  # another script object (a ReduceOp)
                    continue
                return self._groups.get(name, "unknown")
        return "unknown"

    # ------------------------------------------------------------ result
    def result(self) -> Dict[str, Any]:
        """The JAX analyser's keys (``flops``, ``hbm_bytes``,
        ``collective_bytes``, ``collective_per_op``, ``collective_per_axis``,
        ``collective_count``, ``op_hist``) and the port's: ``compute_seconds``
        (each product and kernel at its own peak), ``kernels`` and
        ``peak_bytes``."""
        return {
            "flops": float(self.flops),
            "hbm_bytes": float(self.hbm_bytes),
            "compute_seconds": self.compute_seconds,
            "collective_bytes": float(sum(self.coll_op.values())),
            "collective_per_op": dict(self.coll_op),
            "collective_per_axis": dict(self.coll_axis),
            "collective_count": dict(self.coll_count),
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
            "op_hist": dict(collections.Counter(self.op_hist).most_common(40)),
            "peak_bytes": self.peak_bytes,
        }

