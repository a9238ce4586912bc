#!/usr/bin/env python3
"""Device memory of one train step of phase 14 of ``chip_smoke.py``
(granite-moe-3b-a800m at every width, cut to its ``DIST_LAYERS`` layers,
on ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens) stage by stage, unsharded and
through the distributed layer on a (data 1, model 1) mesh over a one-rank
NCCL group, as that phase runs it.

    python3 tools/dist_step_memory.py

For each variant (``unsharded``; ``sharded``: EP on; ``sharded-no-ep``:
the MoE layers on the local path under the mesh) it prints one JSON
object: the GiB allocated by the params and the AdamW state, the peak of
the forward (``loss_fn``, remat), the peak of the backward
(``torch.autograd.grad`` over every leaf), what is allocated after it,
and, sharded, the peak while the gradients are redistributed to the
optimizer state's placements (ZeRO-1) and how many of them were copied;
then the peak of one whole ``make_train_step`` step on a fresh state.
Peaks from ``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import socket
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import flatten_tree, tree_map
    from repro_torch.configs import get_config
    from repro_torch.distributed import (DistContext, batch_specs, distribute_tree, distribution,
                                         opt_specs, param_specs)
    from repro_torch.launch import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import init_adamw
    from repro_torch.training import make_train_step

    from chip_smoke import DIST_LAYERS, DIST_MODEL, TRAIN_BATCH, TRAIN_SEQ

    if not torch.cuda.is_available():
        raise SystemExit("dist_step_memory: CUDA is not available; this script needs a GPU")
    gib = 2.0**30
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        cfg = dataclasses.replace(get_config(DIST_MODEL), n_layers=DIST_LAYERS)
        api = build_model(cfg)
        params = api.init(seed=0)
        tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1), device="cuda",
                               dtype=torch.int32, generator=torch.Generator("cuda").manual_seed(0))
        batch = {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}
        card = f"{torch.cuda.get_device_name(0)}"
        for variant in ("unsharded", "sharded", "sharded-no-ep"):
            ctx = None if variant == "unsharded" else DistContext(
                mesh, ("data",), ep=variant == "sharded")
            p = tree_map(lambda t: t.detach().clone(), params)
            opt = init_adamw(p)
            b = batch
            if ctx is not None:
                specs = param_specs(p, cfg, ctx)
                opt = distribute_tree(opt, opt_specs(opt, specs, cfg, ctx), ctx)
                p = distribute_tree(p, specs, ctx)
                b = distribute_tree(batch, batch_specs(
                    {k: (tuple(x.shape), x.dtype) for k, x in batch.items()}, ctx), ctx)
            torch.cuda.synchronize()
            out = dict(variant=variant, layers=DIST_LAYERS, tokens=TRAIN_BATCH * TRAIN_SEQ, card=card,
                       state_gib=torch.cuda.memory_allocated() / gib)
            leaves = flatten_tree(p)
            tensors = [t.requires_grad_(True) for _, t in leaves]
            torch.cuda.reset_peak_memory_stats()
            with distribution(ctx):
                loss, _ = api.loss_fn(p, b, remat=True)
                torch.cuda.synchronize()
                out["forward_peak_gib"] = torch.cuda.max_memory_allocated() / gib
                torch.cuda.reset_peak_memory_stats()
                grads = torch.autograd.grad(loss, tensors)
                torch.cuda.synchronize()
            out["backward_peak_gib"] = torch.cuda.max_memory_allocated() / gib
            out["after_backward_gib"] = torch.cuda.memory_allocated() / gib
            if ctx is not None:
                torch.cuda.reset_peak_memory_stats()
                placed = {path: m.placements for path, m in flatten_tree(opt["m"])}
                moved = [g.redistribute(placements=placed[path])
                         for (path, _), g in zip(leaves, grads)]
                torch.cuda.synchronize()
                out["redistribute_peak_gib"] = torch.cuda.max_memory_allocated() / gib
                out["grads_copied"] = sum(
                    a.to_local().data_ptr() != g.to_local().data_ptr()
                    for a, g in zip(moved, grads))
                out["grad_placements"] = sorted({str(g.placements) for g in grads})
                del moved
            del grads, loss, tensors, leaves, p, opt, b
            torch.cuda.empty_cache()
            # one whole step on a fresh state
            p = tree_map(lambda t: t.detach().clone(), params)
            opt = init_adamw(p)
            if ctx is not None:
                specs = param_specs(p, cfg, ctx)
                opt = distribute_tree(opt, opt_specs(opt, specs, cfg, ctx), ctx)
                p = distribute_tree(p, specs, ctx)
            step = make_train_step(api, warmup_steps=1, ctx=ctx)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            p, opt, _ = step(p, opt, batch)
            torch.cuda.synchronize()
            out["step_peak_gib"] = torch.cuda.max_memory_allocated() / gib
            print(json.dumps(out), flush=True)
            del p, opt, step
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
