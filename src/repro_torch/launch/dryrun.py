"""Multi-host dry run: every (arch × shape) cell's step on meta tensors over
a fake production mesh of H100s, with its roofline inputs; the counterpart
of ``repro.launch.dryrun``.

Per cell:
  * a fake process group of 256 ranks (512 with ``--multi-pod``; torch's
    ``fake`` backend: collectives do nothing, nothing is sent) and the
    production mesh of :func:`.mesh.production_layout` at 8 cards a host:
    (32, 8) ``data × model``, or (2, 32, 8) ``pod × data × model``;
  * params, optimizer state, batch and cache are ``DTensor`` s whose local
    tensors are **meta** tensors of each rank's shard, placed by
    :mod:`repro_torch.distributed.sharding_rules` -- nothing is allocated
    and no card is needed (the mesh's device type is a label);
  * train_4k runs ``make_train_step(api, microbatches=..., ctx=ctx)``,
    prefill_32k ``forward(last_only=True)`` in sequential chunks of the
    batch, decode_32k / long_500k ``make_serve_step`` on a sharded
    full-length cache, each once under :class:`.op_analysis.OpAnalysis`,
    whose per-device counts and peak of live memory the roofline reads.
    The kernel wrappers' meta branches check each instance as the card
    would, so a cell the card cannot run FAILs with the card's reason;
  * results land in ``experiments/dryrun_torch/<mesh>/<arch>__<shape>.json``.

Usage (any host; the fake group needs no card and no network):
  python -m repro_torch.launch.dryrun --arch granite-moe-3b-a800m --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]

The JAX flags but ``--impl``: the port's kernels pick by device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..checkpoint import flatten_tree
from ..configs import SHAPES, cell_is_applicable, get_config, get_shape, list_archs
from ..configs.base import ModelConfig, ShapeConfig
from ..distributed.context import DistContext, distribution, is_dtensor
from ..distributed.sharding_rules import (
    batch_specs,
    cache_specs,
    distribute_tree,
    opt_specs,
    param_specs,
    tree_map_with_path,
)
from ..models import build_model
from ..optim import init_adamw
from ..serving import make_serve_step
from ..training import make_train_step
from . import roofline
from .kernel_substitution import substitution_for_cell
from .mesh import mesh_batch_axes, production_layout
from .op_analysis import OpAnalysis

#: per-(arch, shape) gradient-accumulation / prefill-chunking overrides, the
#: JAX package's table: train cells take this many microbatches, prefill
#: cells process the batch in this many sequential chunks
MICROBATCHES: Dict[Tuple[str, str], int] = {
    ("gemma3-12b", "train_4k"): 2,
    ("granite-34b", "train_4k"): 4,
    ("whisper-large-v3", "train_4k"): 2,
    ("mamba2-370m", "train_4k"): 4,
    ("granite-moe-3b-a800m", "train_4k"): 2,
    ("zamba2-1.2b", "train_4k"): 2,
    ("llava-next-mistral-7b", "train_4k"): 2,
    ("granite-34b", "prefill_32k"): 2,
    ("gemma3-12b", "prefill_32k"): 2,
    ("llava-next-mistral-7b", "prefill_32k"): 2,
    ("qwen3-moe-30b-a3b", "prefill_32k"): 2,
}

#: cards a host: the ``model`` dim of the production mesh (one NVLink domain)
PER_HOST = 8
WORLD = 256

OUT_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                        "dryrun_torch")


# ------------------------------------------------------------ process group
def fake_group(world: int) -> None:
    """Starts the default process group on torch's ``fake`` backend with
    ``world`` ranks, as rank 0 (a process has one default group: a started
    fake group of that size is kept, any other group is refused)."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as exc:  # a torch build without its testing package
        raise RuntimeError("the dry run needs torch's fake process group "
                           "(torch.testing._internal.distributed.fake_pg)") from exc
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == world:
            return
        raise RuntimeError(f"the dry run needs a fake process group of {world} ranks; this "
                           f"process already has a {dist.get_backend()} group of "
                           f"{dist.get_world_size()}")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def mesh_name(shape: Tuple[int, ...], multi_pod: bool) -> str:
    return ("multipod_" if multi_pod else "pod_") + "x".join(str(n) for n in shape)


def production_mesh(multi_pod: bool = False, world: Optional[int] = None,
                    per_host: int = PER_HOST):
    """The fake production mesh: ``world`` ranks (256, 512 with
    ``multi_pod``) of ``per_host`` cards a host, over the fake group."""
    from torch.distributed.device_mesh import init_device_mesh

    world = world or (2 * WORLD if multi_pod else WORLD)
    fake_group(world)
    shape, axes = production_layout(world, per_host, multi_pod)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


# ------------------------------------------------------------- meta shards
def local_shape(shape, placements, mesh) -> Tuple[int, ...]:
    """Each rank's shard of ``shape`` under ``placements`` (the rules shard
    only dims that divide)."""
    out = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(i)
            if out[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not divide over {n}")
            out[p.dim] //= n
    return tuple(out)


def shard_meta(tree: Any, specs: Any, ctx: DistContext) -> Any:
    """A tree of ``DTensor`` s with the placements of ``specs`` whose local
    tensors are meta tensors of each rank's shard (``from_local`` without
    its check: nothing is sent or allocated)."""
    from torch.distributed.tensor import DTensor

    def leaf(path, t):
        spec = specs
        for k in path:
            spec = spec[k]
        pl = ctx.placements(spec)
        local = torch.empty(local_shape(t.shape, pl, ctx.mesh), dtype=t.dtype, device="meta")
        return DTensor.from_local(local, ctx.mesh, pl, run_check=False, shape=t.shape,
                                  stride=t.stride())

    return tree_map_with_path(leaf, tree)


def local_bytes(*trees) -> int:
    """Bytes of the local tensors of the trees (a DTensor's shard)."""
    n = 0
    for tree in trees:
        for _, t in flatten_tree(tree):
            t = t._local_tensor if is_dtensor(t) else t
            n += t.numel() * t.element_size()
    return n


def meta_batch(api, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The model's inputs for ``shape``, whole, on meta."""
    return {name: torch.empty(shp, dtype=dtype, device="meta")
            for name, (shp, dtype) in api.batch_spec(shape).items()}


def _model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS: 6·N·D (train), 2·N·D (prefill), 2·N_active·B (decode)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch  # one token per sequence


def prefill_chunks(mb: int, global_batch: int, dp: int) -> int:
    """The sequential chunks of a prefill batch: ``mb`` halved until each
    chunk's batch still divides over the DP ranks (a chunk that does not
    would replicate its activations over them)."""
    mb_eff = mb
    while mb_eff > 1 and (global_batch // mb_eff) % dp != 0:
        mb_eff //= 2
    return mb_eff


# ------------------------------------------------------------------ steps
def cell_inputs(api, cfg: ModelConfig, shape: ShapeConfig, ctx: DistContext) -> Dict[str, Any]:
    """A cell's step inputs on meta: the params (and for train the AdamW
    state, for decode the cache) as sharded ``DTensor`` s, the batch whole
    (as the sharded step and the prefill take it: each rank splits it by
    ``batch_specs``), and ``argument_bytes``: the local shards of all of
    them, the batch's included."""
    params_full = api.init()
    p_spec = param_specs(params_full, cfg, ctx)
    out: Dict[str, Any] = {"params": shard_meta(params_full, p_spec, ctx)}
    batch = meta_batch(api, shape)
    spec = batch_specs({k: (tuple(x.shape), x.dtype) for k, x in batch.items()}, ctx)
    shards = shard_meta(batch, spec, ctx)
    if shape.kind == "train":
        opt_full = init_adamw(params_full)
        out["opt"] = shard_meta(opt_full, opt_specs(opt_full, p_spec, cfg, ctx), ctx)
    if shape.kind == "decode":
        cache = api.init_cache(shape.global_batch, shape.seq_len)
        out["cache"] = shard_meta(cache, cache_specs(cache, cfg, ctx), ctx)
        out["tokens"] = shards["tokens"]
    else:
        out["batch"] = batch
    trees = [v for k, v in out.items() if k in ("params", "opt", "cache")]
    out["argument_bytes"] = local_bytes(*trees, shards)
    return out


def _step(api, cfg, shape: ShapeConfig, ctx: DistContext, mb: int, inputs: Dict,
          analysis: OpAnalysis) -> None:
    """The cell's step, once, under ``analysis`` with its inputs live."""
    params = inputs["params"]
    if shape.kind == "train":
        step = make_train_step(api, microbatches=mb, ctx=ctx)
        with analysis:
            analysis.track(params, inputs["opt"], inputs["batch"])
            step(params, inputs["opt"], inputs["batch"])
        return
    with analysis, torch.no_grad(), distribution(ctx):
        if shape.kind == "decode":
            analysis.track(params, inputs["cache"], inputs["tokens"])
            make_serve_step(api)(params, inputs["cache"], inputs["tokens"], shape.seq_len - 1)
            return
        batch = inputs["batch"]
        analysis.track(params, batch)
        for i in range(mb):
            chunk = {k: x.chunk(mb, dim=0)[i] for k, x in batch.items()}
            spec = batch_specs({k: (tuple(x.shape), x.dtype) for k, x in chunk.items()}, ctx)
            c = distribute_tree(chunk, spec, ctx)
            if cfg.family == "encdec":
                api.forward(params, c["frames"], c["tokens"], last_only=True)
            else:
                api.forward(params, c["tokens"], prefix_embeds=c.get("prefix_embeds"),
                            last_only=True)


# ------------------------------------------------------------------- cells
def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    microbatches: Optional[int] = None,
    save: bool = True,
    hlo_analysis: bool = True,
    variant: str = "",
    kv_dtype: str = "bfloat16",
    cfg: Optional[ModelConfig] = None,
    shape: Optional[ShapeConfig] = None,
    mesh=None,
    out_root: str = OUT_ROOT,
) -> Dict[str, Any]:
    """One cell's record (OK or SKIP; raises where the step raises), saved
    under ``out_root``.  ``cfg``, ``shape`` and ``mesh`` stand in for the
    named config, shape and the production mesh (tests run smoke configs on
    small meshes)."""
    cfg = cfg or get_config(arch)
    if kv_dtype != "bfloat16":
        cfg = dataclasses.replace(cfg, kv_cache_dtype=kv_dtype)
    shape = shape or get_shape(shape_name)
    mesh = mesh if mesh is not None else production_mesh(multi_pod)
    name = mesh_name(tuple(mesh.shape), multi_pod) + (f"__{variant}" if variant else "")
    if not cell_is_applicable(cfg, shape):
        result = {
            "arch": arch, "shape": shape_name, "mesh": name, "status": "SKIP",
            "reason": "long_500k requires sub-quadratic attention "
                      "(pure full-attention arch; see DESIGN.md §5)",
        }
        if save:
            _save(result, out_root, name, arch, shape_name)
        return result

    t0 = time.time()
    ctx = DistContext(mesh=mesh, batch_axes=mesh_batch_axes(mesh))
    api = build_model(cfg, device="meta", ep=ctx.model_size)
    mb = microbatches or MICROBATCHES.get((arch, shape_name), 1)
    if shape.kind == "prefill":
        mb = prefill_chunks(mb, shape.global_batch, ctx.batch_size_total)
    elif shape.kind == "decode":
        mb = 1
    inputs = cell_inputs(api, cfg, shape, ctx)
    args = inputs["argument_bytes"]
    analysis = OpAnalysis(mesh)
    _step(api, cfg, shape, ctx, mb, inputs, analysis)
    del inputs
    run_s = time.time() - t0
    a = analysis.result()
    peak = a.pop("peak_bytes")
    sub = {}
    if hlo_analysis:
        # the plain versions' and the JAX analytic model's kernel-site
        # totals, beside the launches' own cost totals
        sub = substitution_for_cell(cfg, shape, ctx.batch_size_total, ctx.model_size,
                                    mb if shape.kind == "train" else 1)
        sub["kernel_cost_bytes"] = sum(k["bytes"] for k in a["kernels"].values())
        sub["kernel_cost_flops"] = sum(k["flops"] for k in a["kernels"].values())
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": name,
        "status": "OK",
        "kind": shape.kind,
        "variant": variant,
        "microbatches": mb,
        "n_devices": mesh.size(),
        "mesh_shape": dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape))),
        "run_s": round(run_s, 1),
        "memory": {
            "argument_bytes": args,
            "temp_bytes": max(0, peak - args),
            "peak_per_device": peak,
            "fits_80GB": bool(peak <= roofline.HBM_BYTES),
        },
        "op_analysis": a if hlo_analysis else {},
        "kernel_substitution": sub,
        "model_flops_global": _model_flops(cfg, shape),
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
    }
    if save:
        _save(result, out_root, name, arch, shape_name)
    return result


def cell_record(arch: str, shape_name: str, **kwargs) -> Dict[str, Any]:
    """:func:`run_cell`'s record, or a FAIL record with the reason where the
    step raises (saved too, unless ``save=False``), as a card would fail."""
    if kwargs.get("mesh") is None:
        kwargs["mesh"] = production_mesh(kwargs.get("multi_pod", False))
    try:
        return run_cell(arch, shape_name, **kwargs)
    except Exception as exc:  # noqa: BLE001 - a cell the card could not run either
        mesh = kwargs["mesh"]
        name = mesh_name(tuple(mesh.shape), kwargs.get("multi_pod", False)) + (
            f"__{kwargs['variant']}" if kwargs.get("variant") else "")
        result = {"arch": arch, "shape": shape_name, "mesh": name, "status": "FAIL",
                  "error": f"{type(exc).__name__}: {exc}"}
        if kwargs.get("save", True):
            _save(result, kwargs.get("out_root", OUT_ROOT), name, arch, shape_name)
        return result


def _save(result: Dict, out_root: str, name: str, arch: str, shape_name: str) -> None:
    out_dir = os.path.join(os.path.abspath(out_root), name)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape_name}.json"), "w") as fh:
        json.dump(result, fh, indent=1)


# --------------------------------------------------- one card, no sharding
def train_step_analysis(api, batch_shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
                        params=None, **step_kwargs) -> Dict[str, Any]:
    """One unsharded train step of ``api`` (built on ``meta``, or on a card)
    under the op analyser: its :meth:`~.op_analysis.OpAnalysis.result`, with
    ``peak_bytes`` counting the params, AdamW state and batch as live.  On
    meta the params, state and batch are made here; on a card ``params``
    (and the state made from them) are the caller's.  ``step_kwargs`` go to
    ``make_train_step``."""
    params = params if params is not None else api.init()
    opt = init_adamw(params)
    batch = {k: torch.zeros(shp, dtype=dtype, device=api.device)
             for k, (shp, dtype) in batch_shapes.items()}
    step = make_train_step(api, **step_kwargs)
    with OpAnalysis() as a:
        a.track(params, opt, batch)
        step(params, opt, batch)
    return a.result()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-hlo", action="store_true",
                    help="skip the op analysis and the kernel-substitution record")
    ap.add_argument("--variant", default="", help="artifact subdir suffix")
    ap.add_argument("--kv-dtype", default="bfloat16", help="bfloat16|int8")
    ap.add_argument("--out", default=OUT_ROOT, help="where the records go")
    args = ap.parse_args()
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    mesh = production_mesh(args.multi_pod)  # the fake group first, before any cell
    name = mesh_name(tuple(mesh.shape), args.multi_pod) + (
        f"__{args.variant}" if args.variant else "")
    cells = ([(a, s) for a in list_archs() for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    failures = 0
    for arch, shape_name in cells:
        path = os.path.join(os.path.abspath(args.out), name, f"{arch}__{shape_name}.json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as fh:
                if json.load(fh).get("status") in ("OK", "SKIP"):
                    print(f"[skip] {arch} × {shape_name} ({name})")
                    continue
        print(f"[cell] {arch} × {shape_name} ({name}) ...", flush=True)
        r = cell_record(arch, shape_name, multi_pod=args.multi_pod,
                        microbatches=args.microbatches, hlo_analysis=not args.no_hlo,
                        variant=args.variant, kv_dtype=args.kv_dtype, mesh=mesh,
                        out_root=args.out)
        if r["status"] == "OK":
            m = r["memory"]
            print(f"   OK run={r['run_s']}s mem/dev={m['peak_per_device'] / 2**30:.2f}GiB "
                  f"fits={m['fits_80GB']} "
                  f"flops/dev={r['op_analysis'].get('flops', 0):.3e} "
                  f"coll/dev={r['op_analysis'].get('collective_bytes', 0):.3e}B", flush=True)
        elif r["status"] == "SKIP":
            print(f"   SKIP: {r['reason']}", flush=True)
        else:
            failures += 1
            print(f"   FAIL: {r['error']}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
