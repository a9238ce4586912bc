"""Roofline of the dry run's cells on H100s: the counterpart of
``repro.launch.roofline``, and the one home of the card's figures
(``chip_smoke.py`` and the kernels' ``cost(...)`` read them here).

Three terms per (arch × shape), all **seconds per step, per device**,
*modelled* from the data-sheet peaks of an H100 SXM 80GB at 700 W, not
measured:

  compute    = Σ each product's FLOPs over its own dtype's peak + Σ each
               kernel launch's operations over its ``cost`` peak (the op
               analyser's ``compute_seconds``)
  memory     = HBM bytes / 3.35 TB/s
  collective = ``model``-dim bytes / NVLink (within a host) +
               ``data``- and ``pod``-dim bytes / InfiniBand (across hosts)

where the FLOPs, bytes and collective bytes come from
:mod:`.op_analysis` (per device).  The kernels' work is already counted at
their ``cost(...)`` by the dry run, so the cell's ``kernel_substitution``
record (what the plain versions would move instead) is a comparison and is
NOT subtracted here, as the JAX function subtracts its own.

Reported per cell: the three terms and the dominant one, MODEL_FLOPS per
device (6·N·D train / 2·N·D prefill / 2·N_active·B decode) over the
counted FLOPs (the useful ratio), and the roofline fraction (MODEL_FLOPS at
the bf16 peak over the modelled step time), with one H100 lever for the
dominant term.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

#: H100 SXM 80GB data sheet (NVIDIA, dense, no sparsity): bf16 tensor cores
BF16_FLOPS = 989e12
#: TF32 tensor cores (B4's 3xTF32 products run here)
TF32_FLOPS = 495e12
#: fp32 on the CUDA cores (no tensor cores)
FP32_FLOPS = 67e12
#: HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
#: HBM3 capacity, bytes (80 GB)
HBM_BYTES = 80e9
#: NVLink 4, 900 GB/s a card in both directions: 450 GB/s each way
NVLINK_BW = 450e9
#: one 400 Gb/s NDR InfiniBand port a card (DGX H100 user guide): 50 GB/s
IB_BW = 50e9
#: collective bandwidth by mesh dim: ``model`` within a host, the DP dims
#: across hosts
AXIS_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}

DRYRUN_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_torch"
)


def derive_terms(cell: Dict) -> Optional[Dict]:
    """The roofline terms of one OK cell (None for SKIP and FAIL).  The
    kernel sites are counted at their kernels' cost already: the cell's
    ``kernel_substitution`` record is not subtracted."""
    if cell.get("status") != "OK":
        return None
    h = cell.get("op_analysis") or {}
    n_dev = cell["n_devices"]
    flops_dev = h.get("flops", 0.0)
    bytes_dev = h.get("hbm_bytes", 0.0)
    per_axis = h.get("collective_per_axis", {})
    compute_t = h.get("compute_seconds", flops_dev / BF16_FLOPS)
    memory_t = bytes_dev / HBM_BW
    coll_t = sum(v / AXIS_BW.get(k, IB_BW) for k, v in per_axis.items())
    terms = {"compute": compute_t, "memory": memory_t, "collective": coll_t}
    dominant = max(terms, key=terms.get)
    model_flops_dev = cell["model_flops_global"] / n_dev
    useful_ratio = model_flops_dev / flops_dev if flops_dev else 0.0
    step_t = max(terms.values()) if any(terms.values()) else float("inf")
    roofline_frac = (model_flops_dev / BF16_FLOPS) / step_t if step_t else 0.0
    return {
        "arch": cell["arch"],
        "shape": cell["shape"],
        "kind": cell["kind"],
        "microbatches": cell.get("microbatches", 1),
        "compute_s": compute_t,
        "memory_s": memory_t,
        "collective_s": coll_t,
        "step_s": step_t,
        "dominant": dominant,
        "model_flops_dev": model_flops_dev,
        "flops_dev": flops_dev,
        "bytes_dev": bytes_dev,
        "useful_ratio": useful_ratio,
        "roofline_frac": roofline_frac,
        "mem_gib": cell["memory"]["peak_per_device"] / 2**30,
        "fits": cell["memory"]["fits_80GB"],
        "lever": _lever(dominant, cell, useful_ratio),
    }


def _lever(dominant: str, cell: Dict, useful_ratio: float) -> str:
    kind = cell["kind"]
    if dominant == "compute":
        if useful_ratio < 0.6:
            return ("compute-bound with low useful ratio: cut recompute (a remat "
                    "policy that saves the attention outputs) or skip masked key tiles")
        return "compute-bound near useful peak: only better kernels help (wgmma, FP8)"
    if dominant == "memory":
        if kind == "decode":
            return ("decode streams the KV cache: int8 KV cache, a larger batch to "
                    "amortize the weights, or CUDA graphs for the launch gaps")
        return ("memory-bound eager ops: fuse the elementwise chains (torch.compile "
                "regions or hand-written kernels), drop fp32 intermediates")
    return ("collective-bound: keep TP inside the NVLink domain, overlap the DP "
            "reduce-scatter with the backward, int8-compress the InfiniBand "
            "gradients, or trade TP degree for DP")


def load_cells(mesh_name: str = "pod_32x8") -> List[Dict]:
    out = []
    for path in sorted(
        glob.glob(os.path.join(os.path.abspath(DRYRUN_DIR), mesh_name, "*.json"))
    ):
        with open(path) as fh:
            out.append(json.load(fh))
    return out


_SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def roofline_table(mesh_name: str = "pod_32x8") -> str:
    """Markdown roofline table over the cells of a mesh."""
    rows, skips, fails = [], [], []
    for cell in load_cells(mesh_name):
        if cell["status"] == "SKIP":
            skips.append(cell)
        elif cell["status"] != "OK":
            fails.append(cell)
        else:
            rows.append(derive_terms(cell))
    rows.sort(key=lambda r: (r["arch"], _SHAPE_ORDER.get(r["shape"], 9)))
    lines = [
        "| arch | shape | mb | compute s | memory s | collective s | "
        "dominant | useful | roofline | mem GiB | fits |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['microbatches']} "
            f"| {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['collective_s']:.3e} | {r['dominant']} "
            f"| {r['useful_ratio']:.2f} | {r['roofline_frac']:.2f} "
            f"| {r['mem_gib']:.1f} | {'Y' if r['fits'] else 'N'} |"
        )
    for s in sorted(skips, key=lambda c: (c["arch"], c["shape"])):
        lines.append(f"| {s['arch']} | {s['shape']} | — | SKIP | | | | | | | |")
    for f in sorted(fails, key=lambda c: (c["arch"], c["shape"])):
        lines.append(f"| {f['arch']} | {f['shape']} | — | FAIL: {f.get('error', '?')[:90]} "
                     "| | | | | | | |")
    return "\n".join(lines)


def levers_table(mesh_name: str = "pod_32x8") -> str:
    rows = [derive_terms(c) for c in load_cells(mesh_name)]
    rows = [r for r in rows if r]
    rows.sort(key=lambda r: (r["arch"], _SHAPE_ORDER.get(r["shape"], 9)))
    return "\n".join(
        f"- **{r['arch']} × {r['shape']}** ({r['dominant']}-bound): {r['lever']}"
        for r in rows
    )


if __name__ == "__main__":
    import sys

    mesh = sys.argv[1] if len(sys.argv) > 1 else "pod_32x8"
    print(roofline_table(mesh))
    print()
    print(levers_table(mesh))
