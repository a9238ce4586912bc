"""Launch helpers: the counterpart of ``repro.launch``: mesh construction
(:mod:`.mesh`), the per-device op analyser (:mod:`.op_analysis`), the H100
roofline (:mod:`.roofline`), the kernel-site model
(:mod:`.kernel_substitution`) and the multi-host dry run on meta tensors
(:mod:`.dryrun`).  The dry run and the roofline are entry points
(``python -m repro_torch.launch.dryrun``, ``... .roofline``), so every
module but the mesh loads on first use of one of its names."""

import importlib

from .mesh import (
    AbstractMesh,
    make_debug_mesh,
    make_mesh,
    make_production_mesh,
    mesh_batch_axes,
    production_layout,
)

_LAZY = {
    "MICROBATCHES": "dryrun", "production_mesh": "dryrun", "run_cell": "dryrun",
    "train_step_analysis": "dryrun",
    "OpAnalysis": "op_analysis",
    "substitution_for_cell": "kernel_substitution",
    "derive_terms": "roofline", "levers_table": "roofline", "load_cells": "roofline",
    "roofline_table": "roofline",
}

__all__ = ["AbstractMesh", "make_debug_mesh", "make_mesh", "make_production_mesh",
           "mesh_batch_axes", "production_layout", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
