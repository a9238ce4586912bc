"""Mesh construction: the counterpart of ``repro.launch.mesh``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims, made by
``init_device_mesh`` over the default process group, which the caller
starts (``torch.distributed.init_process_group``, NCCL on the card, gloo on
the CPU).  Functions, not module constants: importing this module touches
no device and no process group.  Meshes are on CUDA unless the caller asks
for ``device_type="cpu"``, as the tests do.

:class:`AbstractMesh` carries only the dims' names and sizes, as JAX's
abstract meshes do: the sharding rules derive specs from it for a mesh
larger than the machine, with no process group at all.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Named mesh dims and their sizes, with ``DeviceMesh``'s ``shape`` and
    ``mesh_dim_names`` (spec derivation needs nothing more)."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.mesh_dim_names):
            raise ValueError(f"mesh shape {self.shape} vs names {self.mesh_dim_names}")


def make_mesh(shape: Sequence[int], axes: Sequence[str], device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the default
    process group, whose world size must be the product of ``shape``.  On
    CUDA each rank takes the card of its local rank (``LOCAL_RANK``, else
    the rank modulo the cards present)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: start the process group first (init_process_group)")
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    n = 1
    for s in shape:
        n *= s
    if n != dist.get_world_size():
        raise ValueError(f"make_mesh: mesh {shape} needs {n} ranks, the group has "
                         f"{dist.get_world_size()}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: device_type 'cuda' requested but CUDA is not "
                               "available; pass device_type='cpu'")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def production_layout(world: int, per_host: int, multi_pod: bool = False):
    """(shape, dim names) of the production mesh over ``world`` ranks with
    ``per_host`` cards a host: ``model`` over the cards of one host (at most
    the world), ``data`` over the hosts; with ``multi_pod`` the hosts split
    into two ``pod``s.  256 ranks of 16 a host give the JAX package's
    (16, 16) pod mesh, 512 with ``multi_pod`` its (2, 16, 16)."""
    model = min(per_host, world)
    if world % model:
        raise ValueError(f"world size {world} is not a multiple of {model} ranks a host")
    data = world // model
    if multi_pod:
        if data % 2:
            raise ValueError(f"multi_pod needs an even number of hosts, got {data}")
        return (2, data // 2, model), ("pod", "data", "model")
    return (data, model), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The H100 counterpart of the JAX package's 16 x 16 (or 2 x 16 x 16)
    pod mesh, shaped by :func:`production_layout` from the world size and
    the cards a host (``LOCAL_WORLD_SIZE``, else the cards present; on the
    CPU, else the world)."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", 0)) or (
        torch.cuda.device_count() if device_type == "cuda" else world)
    return make_mesh(*production_layout(world, per_host, multi_pod), device_type)


def mesh_batch_axes(mesh) -> Tuple[str, ...]:
    """DP axes of a mesh: every dim but ``model`` ('pod' takes part in DP)."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def make_debug_mesh(data: int = 2, model: int = 2, device_type: str = "cuda"):
    """A small (data, model) mesh for tests; the world size must be
    ``data * model``."""
    return make_mesh((data, model), ("data", "model"), device_type)
