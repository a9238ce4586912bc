#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, each of which must pass (any failure exits non-zero):
  1. device  -- CUDA present; the card's name and power limit from nvidia-smi;
  2. build   -- nvcc builds the CUDA kernels from the sources in this checkout
                (into src/repro_torch/kernels/_build/, one nvcc per source, all
                started together), Triton JITs its kernels; cuobjdump's SASS of
                the flash-attention library must show tensor-core instructions
                (HMMA) in every instance of the bf16 B1 kernels;
  3. kernels -- each kernel of the serving and training paths, at the paths'
                shapes, held against its plain PyTorch version on the card,
                and timed beside the plain version, a PyTorch library call and
                its bound (B1 also in TFLOP/s; B1 in bf16 rounds P and dS to
                bf16, so it is held, row by row and in the mean, to twice the
                error of the plain version that rounds at the same points).
                B4 runs as five passes: each is also held against its own
                plain version on the kernel's own inputs, and timed.  B2
                logs its split plan (blocks a cluster, slots a block) and
                torch.profiler must see one call run exactly one kernel;
  4. serve   -- gemma3-1b at full width (26 layers, vocab 262144, bf16, random
                weights from --seed) written to checkpoint DU files and served
                from them by DecodeEngine: 4 prompts of 520 tokens plus 24 new
                tokens, max_len 1024, so the 512-slot sliding-window ring wraps.
                Launch counters prove that every attention layer and every norm
                of every step went through the kernels; decode logits are held
                against the teacher-forced forward, which runs flash attention;
  5. train   -- h2o-danube-1.8b at full width (24 layers, d_model 2560, bf16,
                random weights from --seed) restored from checkpoint DU files:
                one eval, 4 AdamW steps with remat on one batch of 2 x 8192
                tokens, one more eval.  Launch counters prove that every
                attention and every norm, forward, recompute and backward, went
                through the kernels; the loss must fall;
  6. ssm     -- mamba2-370m and zamba2-1.2b at full width (random weights from
                --seed) served from checkpoint DU files by DecodeEngine: 4
                prompts of 489 tokens plus 24 new tokens (512 fed tokens, two
                SSD chunks of 256).  Decode logits are held against the
                teacher-forced forward, which runs the SSD chunk-scan kernel in
                every mamba layer, at positions either side of the chunk
                boundary; layer 0's final SSM state against the engine's; then
                a 32768-token prefill of mamba2-370m (``forward(last_only=
                True)``).  Launch counters prove every path's kernels ran;
  7. report  -- one ``{"kernels": [...]}`` JSON line, then as the last line
                ``{"ok": true, "device": {...}}``.
``--profile`` adds torch.profiler breakdowns of eight decode steps (of each
served model), of one train step and of one mamba2-370m prefill.

It imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core peak
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_ULP = 2.0**-7  # one bf16 ulp relative to the value (8 significant bits)

DEVICE = "cuda"
MODEL = "gemma3-1b"
PROMPT_LEN, NEW_TOKENS, MAX_LEN, BATCH = 520, 24, 1024, 4
CHECK_POSITIONS = (0, 511, 512, 543)
LOGIT_TOL = 5e-2  # max |decode - forward| over max(1, max |forward|)
LOGIT_MEAN_TOL = 1e-2  # mean |decode - forward| over the same scale

TRAIN_MODEL = "h2o-danube-1.8b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 8192, 4
TRAIN_LR, TRAIN_WARMUP = 1e-4, 2

SSM_MODELS = ("mamba2-370m", "zamba2-1.2b")
SSM_PROMPT_LEN, SSM_NEW_TOKENS, SSM_MAX_LEN, SSM_BATCH = 489, 24, 512, 4
SSM_CHECK_POSITIONS = (0, 255, 256, 511)  # position 0 first; either side of the chunk boundary
STATE_TOL = 2e-2  # max |engine state - forward state| over max(1, max |forward state|)
# the bf16 engine against the bf16 forward once a state is carried (positions
# past 0): about twice the largest reading on the H100 (0.152 mamba2-370m,
# 0.180 zamba2-1.2b; means 1.44e-2 and 9.78e-3), so a gross fault still fails
SSM_BF16_LOGIT_TOL, SSM_BF16_LOGIT_MEAN_TOL = 0.3, 3e-2
PREFILL_MODEL, PREFILL_LEN = "mamba2-370m", 32768  # prefill_32k's length at batch 1

# phase 3 shapes.  Flash attention: (label, B, S, Hq, Hkv, D, causal, window);
# the first is the training path's, the others gemma3-1b's teacher-forced
# forward of phase 4 (5 sliding-window layers : 1 global)
FLASH_CASES = [
    ("h2o-danube train", 2, 8192, 32, 8, 80, True, 4096),
    ("gemma3-1b forward, window", 4, 544, 4, 1, 256, True, 512),
    ("gemma3-1b forward, global", 4, 544, 4, 1, 256, True, None),
    ("zamba2-1.2b forward, shared attention", 4, 512, 32, 32, 64, True, None),
]
FLASH_FP32_CASES = [
    ("fp32 ragged", 2, 300, 8, 2, 80, True, 128),
    ("fp32 non-causal", 1, 200, 4, 1, 256, False, None),
]
# RMSNorm forward: (rows, D).  gemma3-1b's width (4 rows: a decode step at
# batch 4), then phase 6's: mamba2-370m's d_model 1024 and gate norm 2048,
# zamba2-1.2b's d_model 2048 and gate norm 4096, at a decode step (4 rows), a
# forward of 4 x 511 tokens (2044) and the mamba2 prefill (32768); last,
# h2o-danube-1.8b's training batch (2 x 8192 rows of 2560).  Triton builds
# one program for each width.  The residual variant runs on no path: it is
# held at gemma3-1b's width only
RMSNORM_CASES = [(4, 1152), (8, 1152), (4096, 1152),
                 (4, 1024), (2044, 1024), (32768, 1024),
                 (4, 2048), (2044, 2048), (32768, 2048),
                 (4, 4096), (2044, 4096), (16384, 2560)]
RMSNORM_RESIDUAL_CASES = [(4, 1152), (8, 1152), (4096, 1152)]
# RMSNorm backward: (rows, D); 16384 rows is the training batch, 4 a decode
# step's, 2176 x 1152 gemma3-1b's forward
RMSNORM_BWD_CASES = [(16384, 2560), (4, 2560), (2176, 1152)]
# decode attention: (label, B, slots, Hq, Hkv, D, window, position); the first
# is gemma3-1b's SWA ring wrapped at the last position of the serve phase
DECODE_CASES = [
    ("gemma3-1b ring", 4, 512, 4, 1, 256, 512, 543),
    ("gemma3-1b ring", 8, 512, 4, 1, 256, 512, 543),
    ("gemma3-1b global", 4, 1024, 4, 1, 256, None, 543),
    ("gemma3-1b global", 8, 1024, 4, 1, 256, None, 543),
    ("zamba2-1.2b shared attention", 4, 512, 32, 32, 64, None, 511),
]
# SSD chunk scan: (label, B, S, H, P, N, G, dtype, initial state); the timed
# cases are the mamba2 prefill and the phase 6 forwards, the edge cases are
# only held against the plain version (the last one seeds the state pass and
# walks the prefill's 128 chunks)
SSD_CASES = [
    ("mamba2-370m prefill", 1, 32768, 32, 64, 128, 1, "float32", False),
    ("mamba2-370m forward", 4, 512, 32, 64, 128, 1, "float32", False),
    ("zamba2-1.2b forward", 4, 512, 64, 64, 64, 1, "float32", False),
]
SSD_EDGE_CASES = [
    ("S < chunk", 2, 100, 8, 64, 128, 1, "float32", False),
    ("G 2", 2, 512, 8, 64, 64, 2, "float32", False),
    ("initial state", 2, 512, 8, 64, 128, 1, "float32", True),
    ("bf16 inputs", 2, 512, 8, 64, 128, 1, "bfloat16", False),
    ("initial state, 128 chunks", 1, 32768, 4, 64, 128, 1, "float32", True),
]
SSD_CHUNK = 256

DECODE_SRC = "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"
FLASH_SRC = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
RMSNORM_SRC = "src/repro_torch/kernels/rmsnorm/rmsnorm.py"
SSD_SRC = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"


def sync(torch) -> None:
    torch.cuda.synchronize()


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """Per-launch device time with CUDA events; a 512 MiB buffer is
    rewritten before every launch so that each finds the L2 cache cold, as
    the serving path does (its weights stream through L2 between layers)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 * 2**20, dtype=torch.int32, device=DEVICE)

    def __call__(self, fn, iters: int = 30, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        sync(torch)
        ev = [
            (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            for _ in range(iters)
        ]
        for start, end in ev:
            self.flush.zero_()
            start.record()
            fn()
            end.record()
        sync(torch)
        return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound_ms(n_bytes: float, flops: float, peak_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, out, ref, rtol, atol):
    """Max |out - ref|; raises unless |out - ref| <= atol + rtol * |ref|
    everywhere."""
    o, r = out.float(), ref.float()
    if o.shape != r.shape or not bool(o.isfinite().all()):
        raise AssertionError(f"{name}: shape {tuple(o.shape)} vs {tuple(r.shape)} or non-finite")
    diff = (o - r).abs()
    bad = diff > atol + rtol * r.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements beyond rtol={rtol} atol={atol}; "
            f"max |diff| {diff.max().item():.3e}"
        )
    return diff.max().item()


def check_rounded(name, out, ref, ref_p):
    """The gate of a kernel that rounds inside (B1 bf16 rounds P and dS to
    bf16 as tensor-core operands), against ``ref``, the fp32 plain version,
    and ``ref_p``, the fp32 plain version rounding at the kernel's points:
    ``rounding_ratios`` (per row, the error beyond the output's own rounding
    within 2 x the row's error of ``ref_p`` + 1e-5 x max(1, max|row|); and
    the mean error within 2 x ``ref_p``'s) at most 1.  Returns
    (max |out - ref|, row ratio, mean ratio)."""
    from repro_torch.kernels.flash_attention.ref import rounding_ratios

    o, r = out.float(), ref.float()
    if o.shape != r.shape or not bool(o.isfinite().all()):
        raise AssertionError(f"{name}: shape {tuple(o.shape)} vs {tuple(r.shape)} or non-finite")
    row, mean = rounding_ratios(out, ref, ref_p)
    if row > 1 or mean > 1:
        raise AssertionError(f"{name}: row ratio {row:.3f}, mean ratio {mean:.3f} beyond 1 (the "
                             "error of the plain version that rounds P and dS where it does)")
    return (o - r).abs().max().item(), row, mean


# ------------------------------------------------------------ phase 1
def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# ------------------------------------------------------------ phase 2
def phase_build(torch):
    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_bwd

    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.load(name)
    nvcc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = torch.randn(4, 1152, device=DEVICE, dtype=torch.bfloat16)
    w = torch.zeros(1152, device=DEVICE, dtype=torch.bfloat16)
    for dtype in (torch.bfloat16, torch.float32):
        rmsnorm(x.to(dtype), w)
        rmsnorm(x.to(dtype), w, residual=x.to(dtype))
        rmsnorm_bwd(x.to(dtype), x.to(dtype), w.to(dtype))
    sync(torch)
    triton_s = time.perf_counter() - t0
    log(f"build: nvcc {nvcc_s:.2f} s for {sorted(build.SOURCES)} (ptxas register and "
        f"spill report in {build.BUILD_DIR.relative_to(ROOT)}/*.log), "
        f"triton JIT {triton_s:.2f} s")
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.library_path("flash_attention"))],
                          check=True, capture_output=True, text=True, timeout=300).stdout
    check_tensor_cores(mma_counts(sass))


# the bf16 B1 kernels, which must run on the tensor cores
TENSOR_CORE_KERNELS = ("flash_fwd_mma_kernel", "flash_bwd_dq_mma_kernel", "flash_bwd_dkv_mma_kernel")


def mma_counts(sass: str) -> dict:
    """Tensor-core instructions (HMMA, HGMMA) per function of a
    ``cuobjdump -sass`` listing, by the function's (mangled) name."""
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return counts


def check_tensor_cores(counts: dict) -> None:
    """Raises unless every instance of every bf16 B1 kernel has tensor-core
    instructions; logs the count of each."""
    for base in TENSOR_CORE_KERNELS:
        found = {fn: n for fn, n in counts.items() if base in fn}
        if not found:
            raise AssertionError(f"SASS: no instance of {base} in the flash_attention library")
        for fn, n in sorted(found.items()):
            log(f"build: SASS {n} HMMA/HGMMA in {fn}")
            if n == 0:
                raise AssertionError(f"SASS: {fn} has no tensor-core instruction")


def counters():
    """(kernel name, wrapper, attribute) of every launch counter."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    return [
        ("decode_attention", dec_ops.decode_attention, "launches"),
        ("rmsnorm", norm_ops.rmsnorm, "launches"),
        ("rmsnorm_residual", norm_ops.rmsnorm, "residual_launches"),
        ("flash_attention", fa_ops.flash_attention, "launches"),
        ("flash_attention_bwd", fa_ops.flash_attention, "backward_launches"),
        ("rmsnorm_bwd", norm_ops.rmsnorm, "backward_launches"),
        ("ssd_scan", ssd_ops.ssd, "launches"),
    ]


def reset_counts() -> None:
    for _, fn, attr in counters():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, fn, attr in counters()}


# ------------------------------------------------------------ phase 3
def device_kernels(torch, fn) -> list:
    """The names of the device kernels that one call of ``fn`` runs, as
    torch.profiler records them (memory copies and fills count too)."""
    from torch.profiler import ProfilerActivity, profile

    sync(torch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync(torch)
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


def decode_plan(torch, ops, b, hkv, sk, d, g) -> dict:
    """B2's launch for a call: its split plan, and how many clusters of it
    the card holds at once with each block's shared memory (bf16)."""
    n_split, split_len = ops.split_plan(b, hkv, sk, ops.device_sms(torch.device(DEVICE)))
    clusters, smem = ops.occupancy(torch.bfloat16, d, g, n_split)
    return dict(n_split=n_split, split_len=split_len, max_active_clusters=clusters,
                smem_bytes=smem)


def decode_cases(torch, timer, gen):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    cases = []
    for label, b, sk, hq, hkv, d, window, pos in DECODE_CASES:
        plan = decode_plan(torch, ops, b, hkv, sk, d, hq // hkv)
        log(f"kernels: decode_attention {label} B={b} Sk={sk} {hq}/{hkv}x{d}: split plan "
            f"n_split {plan['n_split']} (a cluster of {plan['n_split']} blocks) x split_len "
            f"{plan['split_len']}; {plan['max_active_clusters']} such clusters fit at once, "
            f"{plan['smem_bytes']} bytes of shared memory a block (bf16)")
        for dtype in (torch.bfloat16, torch.float32):
            def rnd(*shape):
                return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

            q, k, v = rnd(b, 1, hq, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d)
            slots = torch.arange(sk, device=DEVICE, dtype=torch.int32)
            pos_k = (pos - torch.remainder(pos - slots, sk))[None].expand(b, sk)
            pos_q = torch.full((b,), pos, device=DEVICE, dtype=torch.int32)
            out = ops.decode_attention(q, k, v, pos_q, pos_k, window=window)
            ref = decode_attention_ref(q[:, 0], k, v, pos_q, pos_k, window=window)[:, None]
            sync(torch)
            rtol = BF16_ULP if dtype == torch.bfloat16 else 1e-4
            name = f"decode_attention {label} B={b} Sk={sk} {hq}/{hkv}x{d}"
            err = check_close(f"{name} {dtype}", out, ref, rtol, 1e-5)
            if dtype != torch.bfloat16:
                log(f"kernels: {name} fp32 max|err| {err:.2e} (rtol 1e-4, atol 1e-5)")
                continue
            dpos = pos_q[:, None] - pos_k
            valid = (pos_k >= 0) & (dpos >= 0)
            if window is not None:
                valid &= dpos < window
            n_valid = int(valid.sum())
            mask = valid[:, None, None, :]
            names = device_kernels(torch, lambda: ops.decode_attention(
                q, k, v, pos_q, pos_k, window=window))
            if len(names) != 1 or "decode_attention_kernel" not in names[0]:
                raise AssertionError(f"{name}: one call ran the device kernels {names}, "
                                     "not the one decode_attention_kernel")
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            ms = timer(lambda: ops.decode_attention(q, k, v, pos_q, pos_k, window=window))
            plain = timer(lambda: decode_attention_ref(q[:, 0], k, v, pos_q, pos_k, window=window))
            lib = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
            n_bytes = (2 * n_valid * hkv * d * 2  # K and V rows that the mask keeps
                       + 2 * b * hq * d * 2  # q in, out
                       + sk * 4 + b * 4)  # slot positions (one row, broadcast), pos
            flops = 4 * n_valid * hq * d
            bound, by = bound_ms(n_bytes, flops, BF16_FLOPS)
            cases.append(dict(case=label, B=b, Sk=sk, Hq=hq, Hkv=hkv, D=d, window=window,
                              pos=pos, dtype="bfloat16", plan=plan, device_kernels=names,
                              ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                              bound_by=by, max_abs_err=err))
            log(f"kernels: {name} bf16 window={window} pos={pos}: "
                f"{ms:.4f} ms (plain {plain:.4f}, sdpa {lib:.4f}, bound {bound:.4f} by {by}), "
                f"max|err| {err:.2e} (rtol 2^-7, atol 1e-5)")
    return cases


def rmsnorm_cases(torch, timer, gen, residual: bool):
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref, rmsnorm_residual_ref

    eps = 1e-6
    cases = []
    for rows, d in RMSNORM_RESIDUAL_CASES if residual else RMSNORM_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(rows, d, generator=gen, device=DEVICE) * 3).to(dtype)
            r = torch.randn(rows, d, generator=gen, device=DEVICE).to(dtype)
            w = (torch.randn(d, generator=gen, device=DEVICE) * 0.1).to(dtype)
            rtol = BF16_ULP if dtype == torch.bfloat16 else 1e-5
            name = f"rmsnorm{'_residual' if residual else ''} rows={rows} D={d} {dtype}"
            if residual:
                out, s = rmsnorm(x, w, eps, residual=r)
                ref, ref_s = rmsnorm_residual_ref(x, r, w, eps)
                sync(torch)
                err = max(check_close(name, out, ref, rtol, 1e-5),
                          check_close(name + " sum", s, ref_s, rtol, 1e-5))
            else:
                out = rmsnorm(x, w, eps)
                ref = rmsnorm_ref(x, w, eps)
                sync(torch)
                err = check_close(name, out, ref, rtol, 1e-5)
            if dtype != torch.bfloat16:
                log(f"kernels: {name} max|err| {err:.2e} (rtol 1e-5, atol 1e-5)")
                continue
            if residual:
                ms = timer(lambda: rmsnorm(x, w, eps, residual=r))
                plain = timer(lambda: rmsnorm_residual_ref(x, r, w, eps))
                lib = None  # no single PyTorch call adds the residual and normalizes
                n_bytes = 4 * rows * d * 2 + d * 2  # x, r in; normed, sum out; w
            else:
                ms = timer(lambda: rmsnorm(x, w, eps))
                plain = timer(lambda: rmsnorm_ref(x, w, eps))
                w1 = (1.0 + w.float()).to(dtype)  # F.rms_norm scales by w, not 1 + w
                lib = timer(lambda: F.rms_norm(x, (d,), w1, eps))
                n_bytes = 2 * rows * d * 2 + d * 2  # x in, out; w
            bound, by = bound_ms(n_bytes, 5 * rows * d, FP32_FLOPS)
            cases.append(dict(rows=rows, D=d, dtype="bfloat16", ms=ms, plain_ms=plain,
                              library_ms=lib, bound_ms=bound, bound_by=by, max_abs_err=err))
            log(f"kernels: {name}: {ms:.4f} ms (plain {plain:.4f}, F.rms_norm {lib}, "
                f"bound {bound:.4f} by {by}), max|err| {err:.2e} (rtol 2^-7, atol 1e-5)")
    return cases


def kept_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs that the mask keeps in one (batch, head) of a
    self-attention of length s: the work a kernel that skips the rest does."""
    import numpy as np

    q = np.arange(s, dtype=np.int64)
    hi = q if causal else np.full(s, s - 1)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(s, dtype=np.int64)
    return int((hi - lo + 1).sum())


def flash_cases(torch, timer, gen):
    """B1 forward and backward against their plain versions; returns
    (forward cases, backward cases)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref,
        flash_attention_ref,
        kernel_key_tile,
    )

    fwd_cases, bwd_cases = [], []
    for label, b, s, hq, hkv, d, causal, window in FLASH_CASES + FLASH_FP32_CASES:
        dtype = torch.float32 if label.startswith("fp32") else torch.bfloat16

        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

        q, k, v, dout = rnd(b, s, hq, d), rnd(b, s, hkv, d), rnd(b, s, hkv, d), rnd(b, s, hq, d)
        name = f"flash_attention {label} [{b},{s},{hq}/{hkv},{d}] window={window}"
        out, lse = ops.flash_attention_fwd(q, k, v, causal, window)
        grads = ops.flash_attention_bwd(q, k, v, out, lse, dout, causal, window)
        f32 = [t.float() for t in (q, k, v, out, dout)]  # the same values in fp32
        kw = dict(causal=causal, window=window)
        ref, ref_lse = flash_attention_ref(*f32[:3], **kw)
        ref_grads = flash_attention_bwd_ref(*f32[:3], f32[3], lse, f32[4], **kw)
        sync(torch)
        lerr = check_close(name + " lse", lse, ref_lse, 1e-4, 1e-5)
        if dtype != torch.bfloat16:
            err = max(check_close(name, out, ref, 1e-4, 1e-5), lerr)
            # gradients sum over up to S keys (dq) or S x G query rows (dk, dv)
            # in another order than the plain version: absolute term scaled by
            # the tensor's largest value
            gerr = max(check_close(f"{name} d{n}", g, r, 1e-4,
                                   1e-5 * max(1.0, r.float().abs().max().item()))
                       for n, g, r in zip("qkv", grads, ref_grads))
            del ref, ref_lse, ref_grads, grads, f32
            log(f"kernels: {name} fp32 max|err| out {err:.2e}, grads {gerr:.2e} (rtol 1e-4)")
            continue
        # bf16 runs on the tensor cores, which round P (and dS) to bf16: held
        # against the fp32 plain version, with the error of the fp32 plain
        # version that rounds where the kernel does (and folds keys in its
        # tiles) as the yardstick
        kw_p = dict(kw, p_dtype=torch.bfloat16, block_k=kernel_key_tile(d))
        err, row, mean = check_rounded(name, out, ref, flash_attention_ref(*f32[:3], **kw_p)[0])
        err = max(err, lerr)
        ratios = [f"out {row:.3f}/{mean:.3f}"]
        gerr = 0.0
        grads_p = flash_attention_bwd_ref(*f32[:3], f32[3], lse, f32[4], **kw_p)
        for n, g, r, rp in zip("qkv", grads, ref_grads, grads_p):
            e, row, mean = check_rounded(f"{name} d{n}", g, r, rp)
            gerr = max(gerr, e)
            ratios.append(f"d{n} {row:.3f}/{mean:.3f}")
        del f32, ref, ref_lse, ref_grads, grads_p, grads
        log(f"kernels: {name}: gate row/mean ratios (pass <= 1) {', '.join(ratios)}")
        pairs = b * hq * kept_pairs(s, causal, window)
        io = (2 * b * s * hq * d + 2 * b * s * hkv * d) * 2  # q, k, v in; out
        lse_bytes = b * hq * s * 4
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        i = torch.arange(s, device=DEVICE)
        mask = (i[None] <= i[:, None]) if causal else torch.ones(s, s, dtype=torch.bool, device=DEVICE)
        if window:
            mask &= i[:, None] - i[None] < window
        with torch.no_grad():
            ms = timer(lambda: ops.flash_attention_fwd(q, k, v, causal, window))
            plain = timer(lambda: flash_attention_ref(q, k, v, causal=causal, window=window))
            lib = timer(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True))
        bound, by = bound_ms(io + lse_bytes, 4 * pairs * d, BF16_FLOPS)
        fwd_cases.append(dict(case=label, B=b, S=s, Hq=hq, Hkv=hkv, D=d, causal=causal,
                              window=window, dtype="bfloat16", pairs=pairs, ms=ms,
                              plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by,
                              max_abs_err=err, tflops=4 * pairs * d / ms / 1e9))
        log(f"kernels: {name}: {ms:.4f} ms (plain {plain:.4f}, sdpa {lib:.4f}, bound "
            f"{bound:.4f} by {by}; {pairs:.4g} pairs), max|err| {err:.2e} (gate: the bf16-P plain "
            f"version's error, per row and in the mean)")
        log(f"kernels: {name}: {4 * pairs * d / ms / 1e9:.1f} TFLOP/s forward "
            f"(4 x pairs x D / ms; sdpa {4 * pairs * d / lib / 1e9:.1f})")

        bms = timer(lambda: ops.flash_attention_bwd(q, k, v, out, lse, dout, causal, window))
        bplain = timer(lambda: flash_attention_bwd_ref(
            q, k, v, out, lse, dout, causal=causal, window=window))
        qg, kg, vg = (t.detach().requires_grad_() for t in (qt, kt, vt))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask, enable_gqa=True)
        dout_t = dout.transpose(1, 2)
        blib = timer(lambda: torch.autograd.grad(lib_out, (qg, kg, vg), dout_t, retain_graph=True))
        del lib_out, qg, kg, vg
        # q, k, v, out, dout, lse in; dq, dk, dv out
        bbound, bby = bound_ms(2 * io + lse_bytes, 10 * pairs * d, BF16_FLOPS)
        bwd_cases.append(dict(case=label, B=b, S=s, Hq=hq, Hkv=hkv, D=d, causal=causal,
                              window=window, dtype="bfloat16", pairs=pairs, ms=bms,
                              plain_ms=bplain, library_ms=blib, bound_ms=bbound, bound_by=bby,
                              max_abs_err=gerr, tflops=10 * pairs * d / bms / 1e9))
        log(f"kernels: {name} backward: {bms:.4f} ms (plain {bplain:.4f}, sdpa backward "
            f"{blib:.4f}, bound {bbound:.4f} by {bby}), max|err| {gerr:.2e} (gate: the bf16-P "
            f"plain version's error, per row and in the mean)")
        log(f"kernels: {name} backward: {10 * pairs * d / bms / 1e9:.1f} TFLOP/s (10 x pairs x D "
            f"/ ms; the kernels execute 14 x pairs x D; sdpa {10 * pairs * d / blib / 1e9:.1f})")
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return fwd_cases, bwd_cases


def rmsnorm_bwd_cases(torch, timer, gen):
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ops import rmsnorm_bwd
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_ref

    eps = 1e-6
    cases = []
    for rows, d in RMSNORM_BWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(rows, d, generator=gen, device=DEVICE) * 3).to(dtype)
            dy = torch.randn(rows, d, generator=gen, device=DEVICE).to(dtype)
            w = (torch.randn(d, generator=gen, device=DEVICE) * 0.1).to(dtype)
            name = f"rmsnorm_bwd rows={rows} D={d} {dtype}"
            dx, dw = rmsnorm_bwd(dy, x, w, eps)
            rdx, rdw = rmsnorm_bwd_ref(dy, x, w, eps)
            sync(torch)
            rtol = BF16_ULP if dtype == torch.bfloat16 else 1e-4
            # d(scale) sums over the rows in another order: absolute term
            # scaled by its largest value
            err = max(check_close(name + " dx", dx, rdx, rtol, 1e-5),
                      check_close(name + " dscale", dw, rdw, rtol,
                                  1e-5 * max(1.0, rdw.float().abs().max().item())))
            if dtype != torch.bfloat16:
                log(f"kernels: {name} max|err| {err:.2e} (rtol 1e-4)")
                continue
            ms = timer(lambda: rmsnorm_bwd(dy, x, w, eps))
            plain = timer(lambda: rmsnorm_bwd_ref(dy, x, w, eps))
            xg = x.detach().requires_grad_()
            w1 = (1.0 + w.float()).to(dtype).requires_grad_()  # F.rms_norm scales by w
            y = F.rms_norm(xg, (d,), w1, eps)
            lib = timer(lambda: torch.autograd.grad(y, (xg, w1), dy, retain_graph=True))
            del y
            n_bytes = 3 * rows * d * 2 + 2 * d * 2  # x, dy in, dx out; w in, dscale out
            bound, by = bound_ms(n_bytes, 10 * rows * d, FP32_FLOPS)
            cases.append(dict(rows=rows, D=d, dtype="bfloat16", ms=ms, plain_ms=plain,
                              library_ms=lib, bound_ms=bound, bound_by=by, max_abs_err=err))
            log(f"kernels: {name}: {ms:.4f} ms (plain {plain:.4f}, F.rms_norm backward "
                f"{lib:.4f}, bound {bound:.4f} by {by}), max|err| {err:.2e} (rtol 2^-7)")
    return cases


def ssd_pass_checks(torch, ops, name, args, rtol):
    """B4's passes one by one, each held against its plain version computed
    from the kernel's own scratch as the pass found it, so that a fault
    shows in the pass that makes it; returns (the workspace, the largest
    error of each pass).  C B^T is compared on and below the diagonal, the
    part the kernel computes."""
    ws = ops.workspace(*args)
    errs = {}
    for p in ops.PASSES:
        ops.run_pass(ws, p)
        for field, ref in ops.plain_pass(ws, p).items():
            out = getattr(ws, field)
            if field == "cb":
                out, ref = torch.tril(out), torch.tril(ref)
            scale = max(1.0, ref.float().abs().max().item())
            errs[f"{p}.{field}"] = check_close(f"{name} pass {p} ({field})", out, ref,
                                               rtol if field == "y" else 1e-4, 1e-5 * scale)
            del ref
    sync(torch)
    return ws, errs


def ssd_cases(torch, timer, gen):
    """B4 against its plain version at the paths' shapes and the edge cases,
    pass by pass and whole; returns the timed cases."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_ref

    cases = []
    timed = {c[0] for c in SSD_CASES}
    for label, b, s, h, p, n, g, dtype_name, init in SSD_CASES + SSD_EDGE_CASES:
        dtype = getattr(torch, dtype_name)

        def rnd(*shape, scale=1.0):
            return torch.randn(*shape, generator=gen, device=DEVICE) * scale

        x = rnd(b, s, h, p).to(dtype)
        # dA < 0 as the model makes it; cum reaches about -200 over a chunk,
        # so exp(cum) underflows to 0 and exp(cum_i - cum_j) above the
        # diagonal would overflow if it were not selected away
        dA = -F.softplus(rnd(b, s, h))
        B_, C_ = rnd(b, s, g, n, scale=0.5).to(dtype), rnd(b, s, g, n, scale=0.5).to(dtype)
        state = rnd(b, h, p, n) if init else None
        q = min(SSD_CHUNK, s)
        name = f"ssd_scan {label} [{b},{s},{h},{p}] N={n} G={g} {dtype_name}"
        # y sums up to Q terms and the state Q per chunk, in another order
        # than the plain version: absolute term 1e-5 x the largest value
        rtol = BF16_ULP if dtype == torch.bfloat16 else 1e-4
        ws, pass_errs = ssd_pass_checks(torch, ops, name, (x, dA, B_, C_, SSD_CHUNK, state), rtol)
        log(f"kernels: {name} passes max|err| "
            + ", ".join(f"{k} {v:.2e}" for k, v in pass_errs.items()))
        y, final = ops.ssd(x, dA, B_, C_, SSD_CHUNK, state)
        ref_y, ref_final = ssd_ref(x, dA, B_, C_, q, state)
        sync(torch)
        err = max(
            check_close(name, y, ref_y, rtol, 1e-5 * max(1.0, ref_y.float().abs().max().item())),
            check_close(name + " state", final, ref_final, 1e-4,
                        1e-5 * max(1.0, ref_final.abs().max().item())))
        del y, final, ref_y, ref_final
        if label not in timed:
            log(f"kernels: {name} max|err| {err:.2e} (rtol {rtol:.3g}, atol 1e-5 x max|ref|)")
            del ws
            continue
        ms = timer(lambda: ops.ssd(x, dA, B_, C_, SSD_CHUNK, state))
        plain = timer(lambda: ssd_ref(x, dA, B_, C_, q, state))
        passes_ms = {pn: timer(lambda pn=pn: ops.run_pass(ws, pn)) for pn in ops.PASSES}
        del ws
        # the work the function needs: C B^T once per (b, chunk, group) and
        # (L o S) X per (b, h, chunk), both on the lower triangle only (Q(Q+1)/2
        # pairs); per (b, h, chunk) the state term C state^T (none in the first
        # chunk without an initial state) and the state update, 2QPN each
        chunks, tri = s // q, q * (q + 1) // 2
        flops = (b * chunks * g * 2 * n * tri + b * h * chunks * 2 * p * tri
                 + b * h * (2 * chunks - (0 if init else 1)) * 2 * q * p * n)
        # the TPU kernel's work, for comparison: full Q x Q squares, C B^T per head
        tpu_flops = b * h * chunks * (2 * q * q * n + 2 * q * q * p + 4 * q * p * n)
        item = x.element_size()
        n_bytes = (2 * b * s * h * p * item  # x in, y out
                   + b * s * h * 4  # dA
                   + 2 * b * s * g * n * item  # B, C in their group layout
                   + b * h * p * n * 4 * (2 if init else 1))  # final (and initial) state
        # the kernel's products run in 3xTF32, three TF32 products for each
        # fp32 one: its bound is that work at the TF32 peak; the same work
        # on the fp32 CUDA cores is logged beside it
        bound, by = bound_ms(n_bytes, 3 * flops, TF32_FLOPS)
        fp32_bound = max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
        cases.append(dict(case=label, B=b, S=s, H=h, P=p, N=n, G=g, dtype=dtype_name,
                          flops=flops, tpu_flops=tpu_flops, bytes=n_bytes, ms=ms, plain_ms=plain,
                          library_ms=None, bound_ms=bound, bound_by=by,
                          fp32_bound_ms=fp32_bound, passes_ms=passes_ms,
                          pass_max_abs_err=pass_errs, max_abs_err=err))
        log(f"kernels: {name}: {ms:.4f} ms (plain {plain:.4f}, no library call, bound "
            f"{bound:.4f} by {by} in 3xTF32, {fp32_bound:.4f} on the fp32 CUDA cores; "
            f"{flops / 1e9:.4g} GFLOP ({tpu_flops / 1e9:.4g} as the TPU kernel counts), "
            f"{n_bytes / 1e6:.4g} MB), max|err| {err:.2e} "
            f"(rtol {rtol:.3g}, atol 1e-5 x max|ref|); passes "
            + ", ".join(f"{k} {v:.4f}" for k, v in passes_ms.items()) + " ms")
        del x, dA, B_, C_, state
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    return cases


def phase_kernels(torch, seed):
    timer = Timer(torch)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    fwd, bwd = flash_cases(torch, timer, gen)
    results = {
        "decode_attention": decode_cases(torch, timer, gen),
        "rmsnorm": rmsnorm_cases(torch, timer, gen, residual=False),
        "rmsnorm_residual": rmsnorm_cases(torch, timer, gen, residual=True),
        "flash_attention": fwd,
        "flash_attention_bwd": bwd,
        "rmsnorm_bwd": rmsnorm_bwd_cases(torch, timer, gen),
        "ssd_scan": ssd_cases(torch, timer, gen),
    }
    del timer
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    log(f"kernels: {time.perf_counter() - t0:.1f} s")
    return results


# ------------------------------------------------------------ phase 4
def phase_serve(torch, seed, smi):
    import numpy as np

    from repro_torch.checkpoint import checkpoint_files
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.models import build_model
    from repro_torch.models.layers import unembed
    from repro_torch.serving import DecodeEngine

    cfg = get_config(MODEL)
    api = build_model(cfg, device=DEVICE)
    t0 = time.perf_counter()
    files = checkpoint_files(0, "gemma3-1b-chip-smoke", api.init(seed=seed))
    engine = DecodeEngine.from_files(api, files, batch=BATCH, max_len=MAX_LEN)
    n_bytes = sum(len(b) for b in files.values())
    del files
    sync(torch)
    log(f"serve: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}) through {n_bytes / 2**30:.2f} GiB of checkpoint files "
        f"in {time.perf_counter() - t0:.1f} s")

    prompts = torch.from_numpy(
        np.random.default_rng(seed).integers(0, cfg.vocab_size, (BATCH, PROMPT_LEN))
    )
    reset_counts()
    sync(torch)
    t0 = time.perf_counter()
    new = engine.generate(prompts, NEW_TOKENS)
    sync(torch)
    elapsed = time.perf_counter() - t0
    launches = read_counts()
    steps = PROMPT_LEN + NEW_TOKENS - 1
    n_attn = cfg.n_layers
    n_norm = 2 * cfg.n_layers + 1
    # the model adds its residuals itself, as the JAX model does, so the
    # residual variant is held against its plain version in phase 3 only
    expected = {"decode_attention": n_attn * steps, "rmsnorm": n_norm * steps,
                "rmsnorm_residual": 0, "flash_attention": 0, "flash_attention_bwd": 0,
                "rmsnorm_bwd": 0, "ssd_scan": 0}
    if launches != expected:
        raise AssertionError(f"launches {launches} != {expected} ({steps} steps)")
    if new.shape != (BATCH, NEW_TOKENS) or not bool(((new >= 0) & (new < cfg.vocab_size)).all()):
        raise AssertionError(f"bad generated tokens {new.shape}")
    log(f"serve: {steps} decode steps (prompt token by token, then greedy) at batch "
        f"{BATCH}: {elapsed:.3f} s, {elapsed / steps * 1e3:.3f} ms/step, "
        f"{BATCH * steps / elapsed:.1f} tokens/s on {smi}")
    log(f"serve: launches decode_attention {launches['decode_attention']} = {n_attn} x "
        f"{steps}, rmsnorm {launches['rmsnorm']} = {n_norm} x {steps}, rmsnorm_residual "
        f"{launches['rmsnorm_residual']}")

    # teacher-forced decode of the served sequence, against the engine and
    # against the multi-token forward
    seq = torch.cat([prompts.to(new.device), new], dim=1)  # [B, 544]
    cache = api.init_cache(BATCH, MAX_LEN)
    dec_logits = {}
    with torch.no_grad():
        for i in range(seq.shape[1]):
            lg, cache = api.decode_step(engine.params, cache, seq[:, i : i + 1], i)
            if i in CHECK_POSITIONS:
                dec_logits[i] = lg[:, 0].float()
            if PROMPT_LEN - 1 <= i < seq.shape[1] - 1:
                if not torch.equal(lg[:, 0].argmax(-1), seq[:, i + 1]):
                    raise AssertionError(f"engine token at position {i + 1} differs from decode")
        before = fa_ops.flash_attention.launches
        hidden = api.forward(engine.params, seq, return_hidden=True)
        ref = unembed(hidden[:, list(CHECK_POSITIONS)], engine.params["embed"], cfg).float()
        if fa_ops.flash_attention.launches != before + cfg.n_layers:
            raise AssertionError(f"the forward launched flash attention "
                                 f"{fa_ops.flash_attention.launches - before} times, not {cfg.n_layers}")
    dec = torch.stack([dec_logits[p] for p in CHECK_POSITIONS], dim=1)
    if not bool(dec.isfinite().all()) or dec.shape != (BATCH, len(CHECK_POSITIONS), cfg.vocab_size):
        raise AssertionError(f"decode logits {tuple(dec.shape)} not finite")
    scale = max(1.0, ref.abs().max().item())
    err = (dec - ref).abs()
    per_pos = {p: err[:, j].max().item() / scale for j, p in enumerate(CHECK_POSITIONS)}
    mean = err.mean().item() / scale
    log(f"serve: decode vs forward logits at positions {CHECK_POSITIONS}: max |err| / "
        f"{scale:.3f} = {per_pos} (tol {LOGIT_TOL}), mean {mean:.2e} (tol {LOGIT_MEAN_TOL})")
    if max(per_pos.values()) > LOGIT_TOL or mean > LOGIT_MEAN_TOL:
        raise AssertionError("decode logits disagree with the teacher-forced forward")
    return engine, cache, seq, launches


def phase_profile(torch, engine, cache, seq):
    """Device time by kernel over eight decode steps after the served ones."""
    from torch.profiler import ProfilerActivity, profile

    api = engine.api
    tok = seq[:, -1:]
    steps = 8
    with torch.no_grad():
        api.decode_step(engine.params, cache, tok, seq.shape[1])  # warm
        sync(torch)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                api.decode_step(engine.params, cache, tok, seq.shape[1] + 1 + i)
            sync(torch)
            wall = time.perf_counter() - t0
    groups = {}
    total = 0.0
    launches = 0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops; their kernels are listed on their own
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        total += t
        launches += ev.count
        name = ev.key
        if "decode_attention_kernel" in name:
            g = "decode_attention kernel"
        elif "rmsnorm_kernel" in name:
            g = "rmsnorm kernel"
        elif any(s in name.lower() for s in ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitk")):
            g = "matmul (cuBLAS)"
        elif "elementwise" in name or "reduce" in name or "copy" in name.lower():
            g = "PyTorch elementwise/reduce/copy"
        else:
            g = "other: " + name[:60]
        groups[g] = groups.get(g, 0.0) + t
    log(f"profile: {launches / steps:.0f} device kernels per step")
    log(f"profile: {steps} steps, wall {wall / steps * 1e3:.3f} ms/step, device busy "
        f"{total / 1e3 / steps:.3f} ms/step ({100 * total / 1e6 / wall:.1f} %)")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1])[:14]:
        log(f"profile:   {t / 1e3 / steps:8.4f} ms/step  {g}")


# ------------------------------------------------------------ phase 5
def train_launch_schedule(cfg) -> dict:
    """Launches per train step that the remat schedule implies: every layer's
    attention and two norms, plus the final norm, run once forward and once
    backward; the layers of the checkpointed groups run forward again in the
    backward pass (the tail and the final norm are not checkpointed)."""
    n = cfg.n_layers
    remat_layers = (n // len(cfg.pattern)) * len(cfg.pattern)
    return {"flash_attention": n + remat_layers, "flash_attention_bwd": n,
            "rmsnorm": (2 * n + 1) + 2 * remat_layers, "rmsnorm_bwd": 2 * n + 1,
            "decode_attention": 0, "rmsnorm_residual": 0, "ssd_scan": 0}


def phase_train(torch, seed, smi):
    import numpy as np

    from repro_torch.bridge import params_from_files
    from repro_torch.checkpoint import checkpoint_files, flatten_tree
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import init_adamw
    from repro_torch.training import make_eval_step, make_train_step

    cfg = get_config(TRAIN_MODEL)
    api = build_model(cfg, device=DEVICE)
    t0 = time.perf_counter()
    files = checkpoint_files(0, "h2o-danube-chip-smoke", api.init(seed=seed))
    params = params_from_files(files, device=DEVICE)
    n_bytes = sum(len(b) for b in files.values())
    del files
    opt = init_adamw(params)
    n_params = sum(p.numel() for _, p in flatten_tree(params))
    sync(torch)
    log(f"train: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads of {cfg.head_dim_}, window {cfg.sliding_window}, vocab "
        f"{cfg.vocab_size}, {n_params / 1e9:.3f} B params) restored from {n_bytes / 2**30:.2f} "
        f"GiB of checkpoint files, AdamW state on the device, in {time.perf_counter() - t0:.1f} s")

    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))
    tokens = torch.from_numpy(tokens.astype(np.int32)).to(DEVICE)
    batch = {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}
    eval_step = make_eval_step(api)
    train_step = make_train_step(api, peak_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                                 total_steps=TRAIN_STEPS, microbatches=1, remat=True)
    per_step = train_launch_schedule(cfg)
    n = cfg.n_layers
    per_eval = {name: 0 for name in per_step}
    per_eval.update(flash_attention=n, rmsnorm=2 * n + 1)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    sync(torch)
    t0 = time.perf_counter()
    ev0 = float(eval_step(params, batch)["loss"])
    sync(torch)
    eval_s = time.perf_counter() - t0
    if read_counts() != per_eval:
        raise AssertionError(f"eval launches {read_counts()} != {per_eval}")
    history, step_s = [], []
    for i in range(TRAIN_STEPS):
        before = read_counts()
        sync(torch)
        t0 = time.perf_counter()
        params, opt, metrics = train_step(params, opt, batch)
        sync(torch)
        step_s.append(time.perf_counter() - t0)
        got = {k: v - before[k] for k, v in read_counts().items()}
        if got != per_step:
            raise AssertionError(f"step {i} launches {got} != {per_step}")
        history.append({k: float(v) for k, v in metrics.items()})
        log(f"train: step {i}: loss {history[-1]['loss']:.6f}, grad_norm "
            f"{history[-1]['grad_norm']:.6f}, lr {history[-1]['lr']:.3e}, {step_s[-1]:.3f} s")
    ev1 = float(eval_step(params, batch)["loss"])
    sync(torch)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30

    expected = {k: TRAIN_STEPS * per_step[k] + 2 * per_eval[k] for k in per_step}
    if launches != expected:
        raise AssertionError(f"train launches {launches} != {expected}")
    values = [ev0, ev1] + [h[k] for h in history for k in ("loss", "grad_norm", "lr")]
    if not all(math.isfinite(x) for x in values):
        raise AssertionError(f"non-finite train metrics: {history}, evals {ev0}, {ev1}")
    loss0 = history[0]["loss"]
    if history[0]["lr"] != 0.0 or abs(loss0 - ev0) > BF16_ULP * abs(ev0) + 1e-5:
        raise AssertionError(f"step 0 loss {loss0} (lr {history[0]['lr']}) != eval loss {ev0}")
    if not ev1 < loss0:
        raise AssertionError(f"loss did not fall: step 0 {loss0}, after {TRAIN_STEPS} steps {ev1}")
    steady = statistics.median(step_s[1:]) if len(step_s) > 1 else step_s[0]
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    log(f"train: eval loss {ev0:.6f} ({eval_s:.3f} s) -> {ev1:.6f} after {TRAIN_STEPS} steps; "
        f"step 0 loss {loss0:.6f} (lr 0) equals the eval loss within 2^-7")
    log(f"train: {tokens_per_step} tokens/step (batch {TRAIN_BATCH} x seq {TRAIN_SEQ}): "
        f"{steady:.3f} s/step (median of steps 1-{TRAIN_STEPS - 1}; step 0 {step_s[0]:.3f} s), "
        f"{tokens_per_step / steady:.1f} tokens/s, peak device memory {peak:.2f} GiB on {smi}")
    log(f"train: launches per step {per_step}; in all (2 evals + {TRAIN_STEPS} steps) {launches}")
    return api, params, opt, batch, train_step, launches, dict(
        s_per_step=steady, step_s=step_s, tokens_per_s=tokens_per_step / steady,
        peak_gib=peak, eval_loss=[ev0, ev1], history=history)


def phase_profile_train(torch, params, opt, batch, train_step):
    """Device time of one more train step by kernel group."""
    from torch.profiler import ProfilerActivity, profile

    sync(torch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(params, opt, batch)
        sync(torch)
        wall = time.perf_counter() - t0
    groups, total, optimizer = {}, 0.0, None
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        if ev.key == "optimizer":  # the span, not a kernel: its kernels' time
            optimizer = getattr(ev, "device_time_total", None)
            if optimizer is None:
                optimizer = ev.cuda_time_total
            continue
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        total += t
        name = ev.key
        low = name.lower()
        if "flash_fwd" in name:
            g = "B1 flash_attention forward (CUDA)"
        elif "flash_bwd" in name:
            part = ("dK/dV" if "dkv" in name else "dQ" if "_dq_" in name
                    else "delta" if "delta" in name else "other")
            g = f"B1 flash_attention backward, {part} (CUDA)"
        elif "rmsnorm_bwd" in name or "rmsnorm_dw" in name:
            g = "B3a rmsnorm backward (Triton)"
        elif "rmsnorm_kernel" in name:
            g = "B3a rmsnorm forward (Triton)"
        elif any(x in low for x in ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitk")):
            g = "matmul (cuBLAS)"
        elif any(x in low for x in ("elementwise", "reduce", "copy", "vectorized", "index",
                                    "softmax", "scatter", "gather", "fill", "cat")):
            g = "PyTorch elementwise/reduce/copy/index"
        else:
            g = "other: " + name[:60]
        groups[g] = groups.get(g, 0.0) + t
    log(f"profile train: one step, wall {wall:.3f} s, device busy {total / 1e6:.3f} s "
        f"({100 * total / 1e6 / wall:.1f} %)")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1])[:14]:
        log(f"profile train:   {t / 1e6:8.4f} s  {g}")
    if optimizer is not None:
        log(f"profile train:   of which clip + AdamW (all groups): {optimizer / 1e6:.4f} s")


# ------------------------------------------------------------ phase 6
def ssm_launches(cfg, path: str) -> dict:
    """Launches that one decode step (``path="step"``) or one teacher-forced
    forward (``"forward"``) implies: every layer's norms (two each) and the
    final norm; a decode step's attention layers run B2, a forward's run B1
    and its mamba layers B4."""
    kinds = cfg.layer_kinds()
    n_mamba = kinds.count("mamba")
    out = {name: 0 for name, _, _ in counters()}
    out["rmsnorm"] = 2 * len(kinds) + 1
    if path == "step":
        out["decode_attention"] = len(kinds) - n_mamba
    else:
        out.update(flash_attention=len(kinds) - n_mamba, ssd_scan=n_mamba)
    return out


def check_launches(before: dict, expected: dict, what: str) -> None:
    got = {k: v - before[k] for k, v in read_counts().items()}
    if got != expected:
        raise AssertionError(f"{what}: launches {got} != {expected}")


def phase_ssm(torch, seed, smi, model: str, prefill_len: int, profile: bool = False):
    """Serve one SSM-family model from checkpoint files, hold its decode
    against its forward, and (with ``prefill_len``) time a prefill; with
    ``profile``, break eight more decode steps and one more prefill down by
    kernel group.

    In bf16 a deep SSM with random weights amplifies the one-ulp roundings in
    which decode and forward differ (GEMV against GEMM, the recurrence
    against the chunked form) once a state is carried, past what
    LOGIT_TOL allows; in fp32 the two agree closely.  So the bf16 engine is
    held to the forward to LOGIT_TOL at position 0 (no carried state), to
    SSM_BF16_LOGIT_TOL / SSM_BF16_LOGIT_MEAN_TOL at the other positions and
    on its layer-0 SSM state, and the same weights in fp32 are held to
    LOGIT_TOL / LOGIT_MEAN_TOL at every check position."""
    import dataclasses

    import numpy as np

    from repro_torch.checkpoint import checkpoint_files, tree_map
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.layers import embed, rms_norm, unembed
    from repro_torch.models.mamba2 import mamba_block
    from repro_torch.models.transformer import _group_slice
    from repro_torch.serving import DecodeEngine

    cfg = get_config(model)
    api = build_model(cfg, device=DEVICE)
    recorded = {}

    def recording_step(params, cache, tokens, pos_index):
        """The model's decode step, keeping the logits at the check positions."""
        logits, cache = api.decode_step(params, cache, tokens, pos_index)
        if pos_index in SSM_CHECK_POSITIONS:
            recorded[pos_index] = logits[:, 0].float()
        return logits, cache

    t0 = time.perf_counter()
    files = checkpoint_files(0, f"{model}-chip-smoke", api.init(seed=seed))
    engine = DecodeEngine.from_files(dataclasses.replace(api, decode_step=recording_step), files,
                                     batch=SSM_BATCH, max_len=SSM_MAX_LEN)
    n_bytes = sum(len(b) for b in files.values())
    del files
    sync(torch)
    kinds = cfg.layer_kinds()
    log(f"ssm: {cfg.name} ({kinds.count('mamba')} mamba + {len(kinds) - kinds.count('mamba')} "
        f"attention layers, d_model {cfg.d_model}, {cfg.ssm.n_heads(cfg.d_model)} SSD heads of "
        f"{cfg.ssm.head_dim}, d_state {cfg.ssm.d_state}, vocab {cfg.vocab_size}) through "
        f"{n_bytes / 2**30:.2f} GiB of checkpoint files in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SSM_BATCH, SSM_PROMPT_LEN)))
    steps = SSM_PROMPT_LEN + SSM_NEW_TOKENS - 1
    before = read_counts()
    sync(torch)
    t0 = time.perf_counter()
    new = engine.generate(prompts, SSM_NEW_TOKENS)
    sync(torch)
    elapsed = time.perf_counter() - t0
    per_step = ssm_launches(cfg, "step")
    check_launches(before, {k: v * steps for k, v in per_step.items()}, f"{model} decode")
    if new.shape != (SSM_BATCH, SSM_NEW_TOKENS) or not bool(
            ((new >= 0) & (new < cfg.vocab_size)).all()):
        raise AssertionError(f"bad generated tokens {new.shape}")
    out = dict(decode_ms_per_step=elapsed / steps * 1e3, decode_tokens_per_s=SSM_BATCH * steps / elapsed)
    log(f"ssm: {model}: {steps} decode steps at batch {SSM_BATCH}: {elapsed:.3f} s, "
        f"{out['decode_ms_per_step']:.3f} ms/step, {out['decode_tokens_per_s']:.1f} tokens/s on "
        f"{smi}; launches per step {per_step}")

    def logit_errors(dec, ref):
        scale = max(1.0, ref.abs().max().item())
        err = (torch.stack([dec[p] for p in SSM_CHECK_POSITIONS], dim=1) - ref).abs()
        if not bool(err.isfinite().all()):
            raise AssertionError(f"{model}: non-finite decode or forward logits")
        return {p: err[:, j].max().item() / scale for j, p in enumerate(SSM_CHECK_POSITIONS)}, (
            err.mean().item() / scale)

    fed = torch.cat([prompts.to(new.device), new], dim=1)[:, :steps]  # the tokens decoded
    with torch.no_grad():
        before = read_counts()
        hidden = api.forward(engine.params, fed, return_hidden=True)
        check_launches(before, ssm_launches(cfg, "forward"), f"{model} forward")
        ref = unembed(hidden[:, list(SSM_CHECK_POSITIONS)], engine.params["embed"], cfg).float()
        del hidden
        bf16_pos, bf16_mean = logit_errors(recorded, ref)
        # layer 0's chunked final state against the engine's after the same tokens
        bp = _group_slice(engine.params["groups"]["pos0"], 0)
        h0 = rms_norm(embed(fed, engine.params["embed"], cfg), bp["ln1"], cfg.norm_eps)
        _, state = mamba_block(bp["mamba"], h0, cfg)
        eng_state = engine.cache["groups"]["pos0"]["ssm"][0]
        state_err = (state - eng_state).abs().max().item() / max(1.0, state.abs().max().item())
        del ref, state, eng_state, h0

        # the same weights in fp32: decode against forward at every position
        cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
        api32 = build_model(cfg32, device=DEVICE)
        params32 = tree_map(lambda t: t.float() if t.is_floating_point() else t, engine.params)
        cache = api32.init_cache(SSM_BATCH, SSM_MAX_LEN)
        dec32 = {}
        for i in range(steps):
            lg, cache = api32.decode_step(params32, cache, fed[:, i : i + 1], i)
            if i in SSM_CHECK_POSITIONS:
                dec32[i] = lg[:, 0].float()
        del cache
        hidden = api32.forward(params32, fed, return_hidden=True)
        ref32 = unembed(hidden[:, list(SSM_CHECK_POSITIONS)], params32["embed"], cfg32)
        del hidden, params32
        fp32_pos, fp32_mean = logit_errors(dec32, ref32)
    log(f"ssm: {model}: bf16 engine vs bf16 forward logits at positions {SSM_CHECK_POSITIONS}: "
        f"max |err| / max(1, max |logit|) = {bf16_pos}, mean {bf16_mean:.2e} (position 0 tol "
        f"{LOGIT_TOL}, the others {SSM_BF16_LOGIT_TOL}, mean {SSM_BF16_LOGIT_MEAN_TOL}); fp32 decode vs fp32 forward: {fp32_pos}, mean {fp32_mean:.2e} (tol "
        f"{LOGIT_TOL}, mean {LOGIT_MEAN_TOL}); layer 0 state, engine vs chunk scan: max |err| / "
        f"max(1, max |state|) {state_err:.2e} (tol {STATE_TOL})")
    if bf16_pos[SSM_CHECK_POSITIONS[0]] > LOGIT_TOL:
        raise AssertionError(f"{model}: bf16 decode logits at position 0 disagree with the forward")
    if max(bf16_pos.values()) > SSM_BF16_LOGIT_TOL or bf16_mean > SSM_BF16_LOGIT_MEAN_TOL:
        raise AssertionError(f"{model}: bf16 decode logits disagree with the forward past position 0")
    if max(fp32_pos.values()) > LOGIT_TOL or fp32_mean > LOGIT_MEAN_TOL:
        raise AssertionError(f"{model}: fp32 decode logits disagree with the teacher-forced forward")
    if not state_err <= STATE_TOL:
        raise AssertionError(f"{model}: the engine's SSM state disagrees with the chunk scan")
    out.update(bf16_logit_err=bf16_pos, bf16_logit_mean_err=bf16_mean, fp32_logit_err=fp32_pos,
               fp32_logit_mean_err=fp32_mean, state_err=state_err)
    if profile:  # decodes on past the checked state
        phase_profile(torch, engine, engine.cache, new)

    if prefill_len:
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, prefill_len))).to(DEVICE)
        runs = []
        with torch.no_grad():
            for _ in range(2):  # the first pays first-use allocations
                before = read_counts()
                sync(torch)
                t0 = time.perf_counter()
                logits = api.forward(engine.params, tokens, last_only=True)
                sync(torch)
                runs.append(time.perf_counter() - t0)
                check_launches(before, ssm_launches(cfg, "forward"), f"{model} prefill")
        if logits.shape != (1, 1, cfg.vocab_size) or not bool(logits.isfinite().all()):
            raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite")
        out.update(prefill_len=prefill_len, prefill_ms=runs[1] * 1e3,
                   prefill_tokens_per_s=prefill_len / runs[1], prefill_first_ms=runs[0] * 1e3)
        log(f"ssm: {model}: prefill of {prefill_len} tokens at batch 1 (forward, last_only): "
            f"{runs[1] * 1e3:.3f} ms, {prefill_len / runs[1]:.1f} tokens/s (first run "
            f"{runs[0] * 1e3:.3f} ms) on {smi}")
        if profile:
            phase_profile_prefill(torch, lambda: api.forward(engine.params, tokens, last_only=True))
    return out


def phase_profile_prefill(torch, run):
    """Device time of one more prefill by kernel group."""
    from torch.profiler import ProfilerActivity, profile

    sync(torch)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        sync(torch)
        wall = time.perf_counter() - t0
    groups, passes, total = {}, {}, 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        total += t
        low = ev.key.lower()
        if "ssd_scan" in low:
            g = "B4 ssd_scan (CUDA)"
            kernel = low.split("ssd_scan_", 1)[1].split("_kernel", 1)[0]
            passes[kernel] = passes.get(kernel, 0.0) + t
        elif "rmsnorm" in low:
            g = "B3a rmsnorm (Triton)"
        elif any(x in low for x in ("gemm", "gemv", "cutlass", "xmma", "nvjet", "splitk")):
            g = "matmul (cuBLAS)"
        elif any(x in low for x in ("elementwise", "reduce", "copy", "vectorized", "index",
                                    "fill", "cat")):
            g = "PyTorch elementwise/reduce/copy/index"
        else:
            g = "other: " + ev.key[:60]
        groups[g] = groups.get(g, 0.0) + t
    log(f"profile prefill: wall {wall * 1e3:.3f} ms, device busy {total / 1e3:.3f} ms "
        f"({100 * total / 1e6 / wall:.1f} %)")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1])[:10]:
        log(f"profile prefill:   {t / 1e3:9.3f} ms  {g}")
    for kernel, t in sorted(passes.items(), key=lambda kv: -kv[1]):
        log(f"profile prefill:     {t / 1e3:9.3f} ms  B4 pass {kernel}")


# ------------------------------------------------------------ main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: src/repro_torch is missing under {ROOT}; "
                         "run it from a checkout of the repo")

    import torch

    smi = phase_device(torch)
    phase_build(torch)
    results = phase_kernels(torch, args.seed)
    t0 = time.perf_counter()
    engine, cache, seq, serve_launches = phase_serve(torch, args.seed, smi)
    if args.profile:
        phase_profile(torch, engine, cache, seq)
    del engine, cache, seq
    torch.cuda.empty_cache()
    log(f"serve: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    api, params, opt, batch, train_step, train_launches, train = phase_train(torch, args.seed, smi)
    if args.profile:
        phase_profile_train(torch, params, opt, batch, train_step)
    del api, params, opt, batch, train_step
    torch.cuda.empty_cache()
    log(f"train: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    reset_counts()
    ssm = {m: phase_ssm(torch, args.seed, smi, m, PREFILL_LEN if m == PREFILL_MODEL else 0,
                        args.profile)
           for m in SSM_MODELS}
    ssm_launches_all = read_counts()
    torch.cuda.empty_cache()
    log(f"ssm: launches in all {ssm_launches_all}; {time.perf_counter() - t0:.1f} s")

    # name: (route, source, what it replaces, the path whose run it counts)
    meta = {
        "decode_attention": ("cuda", DECODE_SRC,
                             "src/repro/kernels/decode_attention/decode_attention.py:125", "serve"),
        "rmsnorm": ("triton", RMSNORM_SRC, "src/repro/kernels/rmsnorm/rmsnorm.py:51", "serve"),
        "rmsnorm_residual": ("triton", RMSNORM_SRC, "src/repro/kernels/rmsnorm/rmsnorm.py:62",
                             "serve"),
        "flash_attention": ("cuda", FLASH_SRC,
                            "src/repro/kernels/flash_attention/flash_attention.py:129", "train"),
        # the JAX package has no backward kernels: these replace its jnp custom
        # VJP of attention and the autodiff of rms_norm
        "flash_attention_bwd": ("cuda", FLASH_SRC, "src/repro/models/blocked_attention.py:137",
                                "train"),
        "rmsnorm_bwd": ("triton", RMSNORM_SRC, "src/repro/models/layers.py:31", "train"),
        "ssd_scan": ("cuda", SSD_SRC, "src/repro/kernels/ssd_scan/ssd_scan.py:105", "ssm"),
    }
    by_path = {"serve": serve_launches, "train": train_launches, "ssm": ssm_launches_all}
    kernels = []
    for name, cases in results.items():
        route, source, replaces, path = meta[name]
        main_case = cases[0]  # the path's own shape
        err = max(c["max_abs_err"] for c in cases)
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": by_path[path][name], "max_abs_err": err,
            **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            # the same two numbers under the names PERF.md's table uses
            "kernel_ms": main_case["ms"], "max_err": err,
            "launches_by_path": {p: counts[name] for p, counts in by_path.items()},
            "card": smi, "cases": cases,
        })
    if any(k["launches"] == 0 for k in kernels if k["name"] != "rmsnorm_residual"):
        raise AssertionError("a kernel of a path was not launched on it")
    if any(not math.isfinite(k["ms"]) for k in kernels):
        raise AssertionError("a kernel time is not finite")
    log("train: " + json.dumps(train))
    log("ssm: " + json.dumps(ssm))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
