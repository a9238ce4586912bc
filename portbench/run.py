"""Runs one cell of the port's benchmark once and prints its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``.  The last
line of standard output is the result (JSON); the numbers that decided
``correct`` are the last lines of standard error.  It exits 2 without a
result when the checkout has no program or the machine too few CUDA
devices, and 3 when the process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (REPO / "src" / "repro_torch").is_dir():
        print(f"portbench: no program at {REPO / 'src' / 'repro_torch'}", file=sys.stderr)
        return 2
    # Triton's kernel cache at a fixed place inside the checkout, set before
    # anything loads Triton
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".cache" / "triton")
    sys.path[:0] = [str(REPO / "src"), str(REPO)]
    import torch

    from portbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"portbench: the process loaded {loaded}; no result", file=sys.stderr)
        return 3
    lines = harness.check_lines(result)
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
