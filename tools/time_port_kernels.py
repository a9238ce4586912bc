#!/usr/bin/env python3
"""Time the port's B1-backward (flash attention VJP), B2 (decode attention),
B3a (RMSNorm) and B4-backward (SSD chunk scan VJP) kernels on one GPU at
``chip_smoke.py``'s phase 3 shapes, from any checkout of the port.

    python3 tools/time_port_kernels.py [--src DIR] [--kernels b1bwd,b2,b3a,b4bwd]
                                       [--sweep b1bwd,b2,fwd,bwd] [--out FILE]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default; a parent commit unpacked elsewhere to compare two
versions in one call).  Each case is timed through the public wrappers as
phase 3 times it (CUDA events, median of 30 launches, the L2 cache flushed
before each), beside SDPA or ``F.rms_norm``.  ``--kernels`` picks what
is timed (B2 and B3a by default); ``b1bwd`` times B1's backward (bf16) at
every phase 3 case that runs it (a case whose group the checkout's
backward refuses logs the refusal); ``b4bwd`` times B4's backward whole and
pass by pass at ``SSD_BWD_CASES`` (phase 11's training shapes) on the
forward kernel's own scratch, with the max |error| of its dx and dC
passes against their plain versions and the checkout's design constants
(threads a block, positions a ring stage, stages, blocks an SM by shared
memory; null where the checkout has none).  ``--sweep`` also times the
kernels of this checkout under other launch shapes: B1's backward at
every group taken in head parts (``ops.HEAD_PARTS``: G 6, 12 and 48)
over the parts, whole included (``b1bwd``), B2 with the cache cut for 1-4
blocks an SM (``b2``), B3a's forward over rows per program and
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
    if pos is None:  # cross-attention: the query and every slot at position 0
        pos_k = torch.zeros((1, sk), device="cuda", dtype=torch.int32).expand(b, sk)
        pos_q = torch.zeros((b,), device="cuda", dtype=torch.int32)
        return q, k, v, pos_q, pos_k, window
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


def time_b4bwd(torch, timer, gen, emit):
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ops

    design = dict(
        threads=getattr(ops, "BWD_THREADS", None),
        stage_positions=getattr(ops, "BWD_STEP", None),
        stages=getattr(ops, "BWD_STAGES", None),
        blocks_per_sm={f"{pn} N={n}": ops.bwd_blocks_per_sm(pn, n)
                       for pn in ops.BWD_TENSOR_PASSES for n in ops.D_STATES}
        if hasattr(ops, "bwd_blocks_per_sm") else None)
    for label, b, s, h, p, n, g, chunk, init, dfin, _ in cs.SSD_BWD_CASES:
        def rnd(*shape, scale=1.0):
            return torch.randn(*shape, generator=gen, device="cuda") * scale
        x, dy, dA = rnd(b, s, h, p), rnd(b, s, h, p), -F.softplus(rnd(b, s, h))
        bc = rnd(b, s, 2 * g * n, scale=0.5)
        B_, C_ = bc[..., : g * n].view(b, s, g, n), bc[..., g * n:].view(b, s, g, n)
        state = rnd(b, h, p, n) if init else None
        dfinal = rnd(b, h, p, n) if dfin else None
        ws = ops.workspace(x, dA, B_, C_, chunk, state)
        for pn in ops.PASSES:
            ops.run_pass(ws, pn)
        bw = ops.bwd_workspace(ws, dy, dfinal)
        err = {}
        for pn in ops.BWD_PASSES:
            ops.run_pass(bw, pn)
            if pn in ("dx", "dc"):
                for field, ref in ops.plain_pass(bw, pn).items():
                    err[f"{pn}.{field}"] = (getattr(bw, field) - ref).abs().max().item()
        ms = timer(lambda: [ops.run_pass(bw, pn) for pn in ops.BWD_PASSES])
        passes = {pn: timer(lambda pn=pn: ops.run_pass(bw, pn)) for pn in ops.BWD_PASSES}
        emit(kernel="B4 bwd", case=label, B=b, S=s, H=h, N=n, chunk=chunk, ms=ms,
             passes_ms=passes, max_abs_err=err, design=design)
        del ws, bw, x, dy, dA, bc, B_, C_
        torch.cuda.empty_cache()


def flash_inputs(torch, gen, case):
    """q, k, v, dout (bf16) of a phase 3 B1 case, the mask, and the forward's
    out and lse."""
    from repro_torch.kernels.flash_attention import ops

    _, b, s, hq, hkv, d, causal, window = case
    sq, sk = s if isinstance(s, tuple) else (s, s)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    q, k, v, dout = rnd(b, sq, hq, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d), rnd(b, sq, hq, d)
    out, lse = ops.flash_attention_fwd(q, k, v, causal, window)
    return (q, k, v, out, lse, dout, causal, window)


def time_b1bwd(torch, timer, gen, emit):
    from repro_torch.kernels.flash_attention import ops

    for case in cs.FLASH_CASES:
        if case[0] in cs.FLASH_FORWARD_ONLY:
            continue
        args = flash_inputs(torch, gen, case)
        row = dict(kernel="B1 bwd", case=case[0], B=case[1], S=case[2], Hq=case[3], Hkv=case[4],
                   D=case[5], head_parts=getattr(ops, "HEAD_PARTS", {}).get(case[3] // case[4], 1))
        try:
            ops.flash_attention_bwd(*args)
        except NotImplementedError as e:
            emit(**row, error=str(e)[:200])
            continue
        emit(**row, ms=timer(lambda: ops.flash_attention_bwd(*args)))
        del args
        torch.cuda.empty_cache()


def sweep_b1bwd(torch, timer, gen, emit):
    """Every head-part count P (G / P heads a part, at most the 32 rows of a
    dK/dV tile; P 1 where the group fits a tile whole) at each case whose
    group is taken in parts; each one's gradients against the first one's."""
    from repro_torch.kernels.flash_attention import ops

    saved = dict(ops.HEAD_PARTS)
    for case in cs.FLASH_CASES:
        g = case[3] // case[4]
        if g not in ops.HEAD_PARTS or case[0] in cs.FLASH_FORWARD_ONLY:
            continue
        args = flash_inputs(torch, gen, case)
        first = None
        for parts in [p for p in range(1, g + 1) if g % p == 0 and g // p <= 32]:
            ops.HEAD_PARTS[g] = parts
            grads = ops.flash_attention_bwd(*args)
            first = first or grads
            diff = max((x.float() - y.float()).abs().max().item() for x, y in zip(grads, first))
            emit(sweep="B1 bwd", case=case[0], head_parts=parts,
                 ms=timer(lambda: ops.flash_attention_bwd(*args)), max_diff_vs_first=diff)
        del args, first
        torch.cuda.empty_cache()
    ops.HEAD_PARTS.clear()
    ops.HEAD_PARTS.update(saved)


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
                    x, x, w, out, out, x, x.stride(0), x.stride(0), out.stride(0),
                    out.stride(0), rows, d, d, 1e-6, HAS_RESIDUAL=False, EXT_STAT=False,
                    ROWS=tile, BLOCK_A=a, BLOCK_B=bb,
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
                    x, w, dy, dx, part, x, x, x.stride(0), dy.stride(0), dx.stride(0),
                    rows, per_prog, d, d, 1e-6, EXT_STAT=False, ROWS=tile, BLOCK_A=a,
                    BLOCK_B=bb, STAGES=stages,
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
    ap.add_argument("--kernels", default="b2,b3a",
                    help="comma-separated: b1bwd, b2, b3a, b4bwd")
    ap.add_argument("--sweep", default="", help="comma-separated: b1bwd, b2, fwd, bwd")
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
    kernels = set(filter(None, args.kernels.split(",")))
    if "b1bwd" in kernels:
        time_b1bwd(torch, timer, gen, emit)
    if "b2" in kernels:
        time_decode(torch, timer, gen, emit)
    if "b3a" in kernels:
        time_rmsnorm(torch, timer, gen, emit)
    if "b4bwd" in kernels:
        time_b4bwd(torch, timer, gen, emit)
    sweeps = set(filter(None, args.sweep.split(",")))
    if "b1bwd" in sweeps:
        sweep_b1bwd(torch, timer, gen, emit)
    if "b2" in sweeps:
        sweep_decode(torch, timer, gen, emit)
    if sweeps & {"fwd", "bwd"}:
        sweep_rmsnorm(torch, timer, gen, emit, sweeps)
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
