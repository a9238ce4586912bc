"""Distribution context: how model code learns about the mesh; the
counterpart of ``repro.distributed.context``.

Model code stays mesh-agnostic.  A trainer activates a :class:`DistContext`
(mesh + axis roles) around its step, and the model's parameters and batch
are ``DTensor`` s whose placements come from :mod:`.sharding_rules`.
Inside model code:

  * ``constrain(x, "residual")`` redistributes a ``DTensor`` activation to
    the named sharding (a no-op on a plain tensor or without a context,
    so single-device runs are untouched);
  * ``current()`` lets the MoE layer pick the expert-parallel path and the
    attention, MLP and norm layers run their kernels on local shards
    (:mod:`.tensor_parallel`).

Specs are tuples with one entry per tensor dim: ``None``, a mesh dim name,
or a tuple of names (the dim split over several mesh dims, major first), as
a JAX ``PartitionSpec`` reads.  ``DistContext.placements`` turns one into
the ``DTensor`` placements of its mesh.

The context is a ``ContextVar``.  A thread that did not set it does not see
it, and neither does the autograd engine's device thread that runs a
checkpointed region again in the backward pass: :func:`bind` wraps such a
region so that it runs under the context it was recorded in.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import sys
from typing import Any, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class DistContext:
    #: a ``DeviceMesh`` with named dims, or a ``launch.mesh.AbstractMesh``
    #: (enough to derive specs, not to run)
    mesh: Any
    batch_axes: Tuple[str, ...]  # e.g. ("data",) or ("pod", "data")
    model_axis: str = "model"
    #: use the explicit expert-parallel path for MoE layers
    ep: bool = True
    #: shard the residual stream's sequence dim over the model axis (SP)
    sequence_parallel: bool = True

    def axis_size(self, name: str) -> int:
        return int(self.mesh.shape[self.all_axes.index(name)])

    @property
    def model_size(self) -> int:
        return self.axis_size(self.model_axis)

    @property
    def batch_size_total(self) -> int:
        n = 1
        for a in self.batch_axes:
            n *= self.axis_size(a)
        return n

    @property
    def all_axes(self) -> Tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names)

    def placements(self, spec: Sequence) -> list:
        """``DTensor`` placements, one per mesh dim, of a spec: ``Shard(i)``
        on each mesh dim that tensor dim ``i`` names, ``Replicate()``
        elsewhere."""
        from torch.distributed.tensor import Replicate, Shard

        axes = self.all_axes
        out = [Replicate() for _ in axes]
        for i, entry in enumerate(spec):
            for a in (entry,) if isinstance(entry, str) else (entry or ()):
                out[axes.index(a)] = Shard(i)
        return out


_CTX: contextvars.ContextVar[Optional[DistContext]] = contextvars.ContextVar(
    "repro_torch_dist_ctx", default=None
)


def current() -> Optional[DistContext]:
    return _CTX.get()


@contextlib.contextmanager
def distribution(ctx: Optional[DistContext]):
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


def bind(fn):
    """``fn`` run under the context current now, from whatever thread calls
    it (``fn`` itself when there is none)."""
    ctx = current()
    if ctx is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with distribution(ctx):
            return fn(*args, **kwargs)

    return run


def is_dtensor(x) -> bool:
    # no DTensor exists before its module is imported
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _divides(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def constrain(x, name: str):
    """Redistribute a ``DTensor`` activation to its named sharding (a no-op
    on a plain tensor or without a context)."""
    ctx = current()
    if ctx is None or not is_dtensor(x):
        return x
    spec = _activation_spec(name, x.shape, ctx)
    if spec is None:
        return x
    return x.redistribute(placements=ctx.placements(spec))


def _activation_spec(name: str, shape, ctx: DistContext):
    bt = ctx.batch_size_total
    ms = ctx.model_size
    batch = ctx.batch_axes if _divides(shape[0], bt) else None
    if name == "residual":
        # [B, S, d]: batch over DP axes; seq over model (SP) when it divides
        seq = (
            ctx.model_axis
            if ctx.sequence_parallel and len(shape) >= 2 and _divides(shape[1], ms)
            else None
        )
        return (batch, seq, None)
    if name == "logits":
        # [B, S, V]: vocab over model
        v = ctx.model_axis if _divides(shape[-1], ms) else None
        return (batch,) + (None,) * (len(shape) - 2) + (v,)
    if name == "batch":
        return (batch,) + (None,) * (len(shape) - 1)
    return None

