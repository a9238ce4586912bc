#!/usr/bin/env python3
"""Time the port's B2 (decode attention) and B3a (RMSNorm) kernels on one
GPU at ``chip_smoke.py``'s phase 3 shapes, from any checkout of the port.

    python3 tools/time_port_kernels.py [--src DIR] [--sweep b2,fwd,bwd] [--out FILE]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default; a parent commit unpacked elsewhere to compare two
versions in one call).  Each case is timed through the public wrappers as
phase 3 times it (CUDA events, median of 30 launches, the L2 cache flushed
before each), beside SDPA or ``F.rms_norm``.  ``--sweep`` also times the
kernels of this checkout under other launch shapes: B2 with the cache cut
for 1-4 blocks an SM (``b2``), B3a's forward over rows per program and
warps (``fwd``), its backward also over pipeline stages and programs per SM
(``bwd``).  Prints one JSON object per line; ``--out`` writes them to a
file too.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (shapes, timer and bounds; imports no kernel)

RMSNORM_FWD = sorted(set(cs.RMSNORM_CASES) | {(16384, 2560)})


def decode_inputs(torch, gen, case):
    _, b, sk, hq, hkv, d, window, pos = case
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = rnd(b, 1, hq, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d)
    slots = torch.arange(sk, device="cuda", dtype=torch.int32)
    pos_k = (pos - torch.remainder(pos - slots, sk))[None].expand(b, sk)
    pos_q = torch.full((b,), pos, device="cuda", dtype=torch.int32)
    return q, k, v, pos_q, pos_k, window


def time_decode(torch, timer, gen, emit):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops

    for case in cs.DECODE_CASES:
        q, k, v, pos_q, pos_k, window = decode_inputs(torch, gen, case)
        dpos = pos_q[:, None] - pos_k
        mask = (pos_k >= 0) & (dpos >= 0)
        if window is not None:
            mask &= dpos < window
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        ms = timer(lambda: ops.decode_attention(q, k, v, pos_q, pos_k, window=window))
        sdpa = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None, None, :], enable_gqa=True))
        # the same launch with every slot masked: what a call costs before
        # it reads any K or V
        none_q = torch.full_like(pos_q, -1)
        empty = timer(lambda: ops.decode_attention(q, k, v, none_q, pos_k, window=window))
        emit(kernel="B2", case=case[0], B=case[1], Sk=case[2], ms=ms, sdpa_ms=sdpa,
             all_masked_ms=empty)
    one = torch.zeros(1, device="cuda")
    emit(kernel="launch floor (one-element add_)", ms=timer(lambda: one.add_(1)))


def time_rmsnorm(torch, timer, gen, emit):
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd

    for rows, d in RMSNORM_FWD:
        x, w, _ = norm_inputs(torch, gen, rows, d)
        w1 = 1.0 + w
        emit(kernel="B3a", rows=rows, D=d, ms=timer(lambda: rmsnorm(x, w)),
             library_ms=timer(lambda: F.rms_norm(x, (d,), w1, 1e-6)))
    for rows, d in cs.RMSNORM_BWD_CASES:
        x, w, dy = norm_inputs(torch, gen, rows, d)
        emit(kernel="B3a bwd", rows=rows, D=d, ms=timer(lambda: rmsnorm_bwd(dy, x, w)))


def norm_inputs(torch, gen, rows, d):
    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)
    return rnd(rows, d, scale=3.0), rnd(d, scale=0.1), rnd(rows, d)


def sweep_decode(torch, timer, gen, emit):
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    default = ops.BLOCKS_PER_SM
    try:
        for case, per_sm in itertools.product(cs.DECODE_CASES, (1, 2, 3, 4)):
            ops.BLOCKS_PER_SM = per_sm
            q, k, v, pos_q, pos_k, window = decode_inputs(torch, gen, case)
            plan = ops.split_plan(case[1], case[4], case[2], ops.device_sms(q.device))
            out = ops.decode_attention(q, k, v, pos_q, pos_k, window=window)
            ref = decode_attention_ref(q[:, 0], k, v, pos_q, pos_k, window=window)[:, None]
            err = (out.float() - ref.float()).abs().max().item()
            ms = timer(lambda: ops.decode_attention(q, k, v, pos_q, pos_k, window=window))
            emit(sweep="B2", case=case[0], B=case[1], blocks_per_sm=per_sm, plan=plan,
                 clusters=ops.occupancy(q.dtype, case[5], case[3] // case[4], plan[0])[0],
                 ms=ms, max_abs_err=err)
    finally:
        ops.BLOCKS_PER_SM = default


def sweep_rmsnorm(torch, timer, gen, emit, which):
    from repro_torch.kernels.rmsnorm import ops
    from repro_torch.kernels.rmsnorm import rmsnorm as kernel
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for rows, d in RMSNORM_FWD if "fwd" in which else []:
        if rows < 2044:
            continue
        x, w, _ = norm_inputs(torch, gen, rows, d)
        out = torch.empty_like(x)
        ref = rmsnorm_ref(x, w)
        a, bb = ops._blocks(d)
        for tile, warps in itertools.product((1, 2, 4, 8), (2, 4, 8)):
            def run():
                kernel.rmsnorm_kernel[(-(-rows // tile),)](
                    x, x, w, out, out, x.stride(0), x.stride(0), out.stride(0), out.stride(0),
                    rows, d, 1e-6, HAS_RESIDUAL=False, ROWS=tile, BLOCK_A=a, BLOCK_B=bb,
                    num_warps=warps)
            try:
                run()
            except Exception as e:  # a launch shape Triton refuses: record it, go on
                emit(sweep="B3a", rows=rows, D=d, ROWS=tile, warps=warps, error=str(e)[:200])
                continue
            err = (out.float() - ref.float()).abs().max().item()
            emit(sweep="B3a", rows=rows, D=d, ROWS=tile, warps=warps, ms=timer(run),
                 max_abs_err=err)
    for rows, d in cs.RMSNORM_BWD_CASES if "bwd" in which else []:
        if rows < 2044:
            continue
        x, w, dy = norm_inputs(torch, gen, rows, d)
        dx = torch.empty_like(x)
        dw = torch.empty_like(w)
        rdx, _ = rmsnorm_bwd_ref(dy, x, w)
        a, bb = ops._blocks(d)
        for tile, warps, stages, per_sm in itertools.product(
                (1, 2), (1, 2, 4), (2, 3, 4, 6), (1, 2, 3, 4)):
            n_prog = max(1, min(-(-rows // tile), per_sm * sms))
            per_prog = tile * -(-rows // (tile * n_prog))
            n_prog = -(-rows // per_prog)
            part = torch.empty((n_prog, d), dtype=torch.float32, device="cuda")

            def run():
                kernel.rmsnorm_bwd_kernel[(n_prog,)](
                    x, w, dy, dx, part, x.stride(0), dy.stride(0), dx.stride(0),
                    rows, per_prog, d, 1e-6, ROWS=tile, BLOCK_A=a, BLOCK_B=bb, STAGES=stages,
                    num_warps=warps)
                kernel.rmsnorm_dw_kernel[(-(-d // 128),)](
                    part, dw, n_prog, d, BLOCK_P=32, BLOCK_C=128, num_warps=4)
            try:
                run()
            except Exception as e:
                emit(sweep="B3a bwd", rows=rows, D=d, ROWS=tile, warps=warps, stages=stages,
                     per_sm=per_sm, error=str(e)[:200])
                continue
            err = (dx.float() - rdx.float()).abs().max().item()
            emit(sweep="B3a bwd", rows=rows, D=d, ROWS=tile, warps=warps, stages=stages,
                 per_sm=per_sm, ms=timer(run), max_abs_err=err)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--sweep", default="", help="comma-separated: b2, fwd, bwd")
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_port_kernels: CUDA is not available")
    import repro_torch

    card = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    sink = open(args.out, "a") if args.out else None

    def emit(**row):
        row.update(src=str(Path(repro_torch.__file__).parents[1]), card=card)
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")

    timer = cs.Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    time_decode(torch, timer, gen, emit)
    time_rmsnorm(torch, timer, gen, emit)
    sweeps = set(filter(None, args.sweep.split(",")))
    if "b2" in sweeps:
        sweep_decode(torch, timer, gen, emit)
    if sweeps & {"fwd", "bwd"}:
        sweep_rmsnorm(torch, timer, gen, emit, sweeps)
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
