#!/usr/bin/env python3
"""Trace one benchmark cell's training steps on a GPU and break a step down
by the program's own spans (``repro_torch.tracing``), from the root of a
checkout:

    python3 tools/trace_cell.py --workload granite-moe.train-4k --seed 3000000501 \\
        [--window 15] [--out FILE]

Set-up, checked steps and the traced steps are the benchmark's own
(``portbench.harness``).  Prints one JSON object: every reader under
``portbench/metrics`` (those ``BENCHMARK.json`` lists and those it does
not), the MoE counters, each span's device ms a step by
``Trace.span_device_s`` and with every kernel counted once
(``portbench.program_spans``), the backward's device time that no layer's
``.bwd`` span or ``recompute`` covers, by kernel group and by the autograd
node that launched it, and the trace's ``breakdown``: the longest device
operations and idle gaps, each gap named by the host op running when it
began.  ``--window`` then runs that many seconds of untraced steps and adds
their s/step and the garbage collector's pauses among them.  On a checkout
without the program's spans (an older commit) the readers of them read
null.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from portbench import harness, program_spans  # noqa: E402
from portbench.trace import kernel_group  # noqa: E402

#: spans inside which the backward's device time belongs to a layer
COVERED = ("moe.bwd", "ce.bwd", "mamba.bwd", "shared.bwd", "pb.attn.bwd", "pb.ssd.bwd",
           "recompute")
NODE = "autograd::engine::evaluate_function: "
SPANS = ("step.forward", "step.backward", "optimizer", "recompute", "moe", "moe.bwd", "ce",
         "ce.bwd", "mamba", "mamba.bwd", "shared", "shared.bwd", "pb.moe_layer", "pb.attn",
         "pb.attn.bwd", "pb.ssd", "pb.ssd.bwd")


def uncovered(tr):
    """The backward's device ms a step outside every span of ``COVERED``,
    by kernel group and by autograd node (each kernel counted once)."""
    groups, nodes, seen = {}, {}, set()
    total = 0.0
    todo = [(e, "(no autograd node)") for e in program_spans.outermost(tr, "step.backward")]
    while todo:
        e, node = todo.pop()
        if e.kernels and e.id not in seen:
            seen.add(e.id)
            for k in e.kernels:
                d = float(k.duration) / 1e3 / tr.steps
                total += d
                g = kernel_group(k.name)
                groups[g] = groups.get(g, 0.0) + d
                key = f"{node}: {k.name[:70]}"
                nodes[key] = nodes.get(key, 0.0) + d
        for c in e.cpu_children:
            if c.name not in COVERED:
                todo.append((c, c.name[len(NODE):] if c.name.startswith(NODE) else node))
    top = sorted(nodes.items(), key=lambda kv: -kv[1])[:15]
    return {"ms": total, "by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "by_node_and_kernel": dict(top)}


def untraced_window(prog, cell, seconds: float):
    """Untraced steps for ``seconds``: s/step and the collector's pauses."""
    pauses, start = [], {}

    def watch(phase, info):
        if phase == "start":
            start["t"] = time.perf_counter()
        else:
            pauses.append((info["generation"], 1e3 * (time.perf_counter() - start["t"])))

    gc.callbacks.append(watch)
    try:
        w = harness.window(prog, seconds, cell.mix["checked_steps"], "cuda")
    finally:
        gc.callbacks.remove(watch)
    return {"steps": w["steps"], "s_per_step": w["wall_s"] / w["steps"],
            "gc_pauses": [sum(g == i for g, _ in pauses) for i in range(3)],
            "gc_ms": [sum(d for g, d in pauses if g == i) for i in range(3)]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--window", type=float, default=0.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    try:
        from repro_torch import tracing
    except ImportError:  # a checkout without the program's spans
        tracing = None
    cell = harness.load_cell(args.workload)
    prog = harness.build_program(cell, args.seed, "cuda")
    harness.checked_steps(cell, prog, args.seed)
    if tracing is not None:
        tracing.reset_counters()
    tr = harness.traced(cell, prog, cell.mix["checked_steps"], "cuda")
    readers = sorted(p.stem for p in (ROOT / "portbench" / "metrics").glob("*.py"))
    out = {"workload": args.workload, "seed": args.seed, "device": torch.cuda.get_device_name(0),
           "busy_ms": 1e3 * tr.busy_s / tr.steps, "wall_ms": 1e3 * tr.wall_s / tr.steps,
           "metrics": {m: harness.read_metric(m, tr) for m in readers},
           "counters": tracing.counters() if tracing is not None else None,
           "spans_ms": {s: (None if tr.span_device_s(s) is None else
                            1e3 * tr.span_device_s(s) / tr.steps) for s in SPANS},
           "spans_once_ms": {s: program_spans.device_ms(tr, s) for s in SPANS},
           "backward_uncovered": uncovered(tr), "breakdown": tr.breakdown()}
    if args.window:
        out["untraced"] = untraced_window(prog, cell, args.window)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
