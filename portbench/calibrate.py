"""Readings that the cells' limits are set from; not run by the
benchmark's own runs.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--out FILE]

For each seed, in one process: the program's checked steps against the
reference (the sound readings, whose largest sets a limit's lower end);
for a control seed, the reference with its products in fp8 against the
fp32 reference (the control); for a fault seed, the program with each
fault of ``faults.py`` planted against the sound reference.  A state left
unchanged reads 1 on every number by construction and needs no run.  One
JSON line a reading, to standard output and to ``--out``; a sound line
also gives the share of the MoE layers' (token, expert) pairs that the
reference dropped.
"""

import argparse
import contextlib
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args()
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".cache" / "triton")
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import torch

    from portbench import faults, harness

    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    fault = {int(s) for s in args.fault_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, numbers, t0, mine, ref):
        counts = {"moe_dropped_share": ref.counts["moe_dropped"] / ref.counts["moe_pairs"]
                  } if kind == "sound" and ref.counts.get("moe_pairs") else {}
        line = json.dumps({"cell": cell.name, "kind": kind, "seed": seed,
                           "seconds": time.perf_counter() - t0,
                           **{k: v["value"] for k, v in numbers.items()},
                           "at": {k: v["at"] for k, v in numbers.items()},
                           "losses": mine.losses, "reference_losses": ref.losses, **counts})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def program(seed, fault=None):
        with faults.planted(fault) if fault else contextlib.nullcontext():
            prog = harness.build_program(cell, seed, "cuda")
            mine = harness.checked_steps(cell, prog, seed)
        batches = prog.batches
        del prog
        gc.collect()
        torch.cuda.empty_cache()
        return mine, batches

    for seed in seeds:
        t0 = time.perf_counter()
        mine, batches = program(seed)
        ref = harness.reference_readings(cell, seed, batches)
        gc.collect()
        torch.cuda.empty_cache()
        emit("sound", seed, harness.compare(mine, ref), t0, mine, ref)
        if seed in control:
            t0 = time.perf_counter()
            ctl = harness.reference_readings(cell, seed, batches, fp8=True)
            emit("control_fp8", seed, harness.compare(ctl, ref), t0, ctl, ref)
        for name in faults.FAULTS if seed in fault else ():
            t0 = time.perf_counter()
            broken, _ = program(seed, name)
            emit(f"fault_{name}", seed, harness.compare(broken, ref), t0, broken, ref)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
