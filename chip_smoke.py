#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--profile]

Phases, each of which must pass (any failure exits non-zero):
  1. device  -- CUDA present; the card's name and power limit from nvidia-smi;
  2. build   -- nvcc builds the CUDA kernels from the sources in this checkout
                (into src/repro_torch/kernels/_build/), Triton JITs its kernel;
  3. kernels -- each kernel of the serving path, at the path's shapes, held
                against its plain PyTorch version on the card, and timed beside
                the plain version, a PyTorch library call and its bound;
  4. serve   -- gemma3-1b at full width (26 layers, vocab 262144, bf16, random
                weights from --seed) written to checkpoint DU files and served
                from them by DecodeEngine: 4 prompts of 520 tokens plus 24 new
                tokens, max_len 1024, so the 512-slot sliding-window ring wraps.
                Launch counters prove that every attention layer and every norm
                of every step went through the kernels; decode logits are held
                against the teacher-forced forward.
  5. report  -- one ``{"kernels": [...]}`` JSON line, then as the last line
                ``{"ok": true, "device": {...}}``.
``--profile`` adds a torch.profiler breakdown of eight decode steps.

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
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_ULP = 2.0**-7  # one bf16 ulp relative to the value (8 significant bits)

DEVICE = "cuda"
MODEL = "gemma3-1b"
PROMPT_LEN, NEW_TOKENS, MAX_LEN, BATCH = 520, 24, 1024, 4
CHECK_POSITIONS = (0, 511, 512, 543)
LOGIT_TOL = 5e-2  # max |decode - forward| over max(1, max |forward|)
LOGIT_MEAN_TOL = 1e-2  # mean |decode - forward| over the same scale

DECODE_SRC = "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"
RMSNORM_SRC = "src/repro_torch/kernels/rmsnorm/rmsnorm.py"


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
    from repro_torch.kernels.rmsnorm.ops import rmsnorm

    t0 = time.perf_counter()
    for name in build.SOURCES:
        build.load(name)
    nvcc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x = torch.randn(4, 1152, device=DEVICE, dtype=torch.bfloat16)
    w = torch.zeros(1152, device=DEVICE, dtype=torch.bfloat16)
    for dtype in (torch.bfloat16, torch.float32):
        rmsnorm(x.to(dtype), w)
        rmsnorm(x.to(dtype), w, residual=x.to(dtype))
    sync(torch)
    triton_s = time.perf_counter() - t0
    log(f"build: nvcc {nvcc_s:.2f} s for {sorted(build.SOURCES)} (ptxas register and "
        f"spill report in {build.BUILD_DIR.relative_to(ROOT)}/*.log), "
        f"triton JIT {triton_s:.2f} s")


# ------------------------------------------------------------ phase 3
def decode_cases(torch, timer, gen):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    hq, hkv, d = 4, 1, 256  # gemma3-1b
    cases = []
    # (batch, slots, window, position): the SWA ring wrapped at the last
    # position of the serve phase, and the global cache of max_len slots
    for b, sk, window, pos in ((4, 512, 512, 543), (8, 512, 512, 543),
                               (4, 1024, None, 543), (8, 1024, None, 543)):
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
            err = check_close(f"decode_attention B={b} Sk={sk} {dtype}", out, ref, rtol, 1e-5)
            if dtype != torch.bfloat16:
                log(f"kernels: decode_attention fp32 B={b} Sk={sk} max|err| {err:.2e} "
                    f"(rtol 1e-4, atol 1e-5)")
                continue
            dpos = pos_q[:, None] - pos_k
            valid = (pos_k >= 0) & (dpos >= 0)
            if window is not None:
                valid &= dpos < window
            n_valid = int(valid.sum())
            mask = valid[:, None, None, :]
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
            cases.append(dict(B=b, Sk=sk, window=window, pos=pos, dtype="bfloat16",
                              ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bound,
                              bound_by=by, max_abs_err=err))
            log(f"kernels: decode_attention bf16 B={b} Sk={sk} window={window} pos={pos}: "
                f"{ms:.4f} ms (plain {plain:.4f}, sdpa {lib:.4f}, bound {bound:.4f} by {by}), "
                f"max|err| {err:.2e} (rtol 2^-7, atol 1e-5)")
    return cases


def rmsnorm_cases(torch, timer, gen, residual: bool):
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref, rmsnorm_residual_ref

    d, eps = 1152, 1e-6
    cases = []
    for rows in (4, 8, 4096):  # 4: a decode step at batch 4
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(rows, d, generator=gen, device=DEVICE) * 3).to(dtype)
            r = torch.randn(rows, d, generator=gen, device=DEVICE).to(dtype)
            w = (torch.randn(d, generator=gen, device=DEVICE) * 0.1).to(dtype)
            rtol = BF16_ULP if dtype == torch.bfloat16 else 1e-5
            name = f"rmsnorm{'_residual' if residual else ''} rows={rows} {dtype}"
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


def phase_kernels(torch, seed):
    timer = Timer(torch)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    return {
        "decode_attention": decode_cases(torch, timer, gen),
        "rmsnorm": rmsnorm_cases(torch, timer, gen, residual=False),
        "rmsnorm_residual": rmsnorm_cases(torch, timer, gen, residual=True),
    }


# ------------------------------------------------------------ phase 4
def phase_serve(torch, seed, smi):
    import numpy as np

    from repro_torch.checkpoint import checkpoint_files
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import ops as dec_ops
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
    dec_ops.decode_attention.launches = 0
    norm_ops.rmsnorm.launches = 0
    norm_ops.rmsnorm.residual_launches = 0
    sync(torch)
    t0 = time.perf_counter()
    new = engine.generate(prompts, NEW_TOKENS)
    sync(torch)
    elapsed = time.perf_counter() - t0
    launches = {"decode_attention": dec_ops.decode_attention.launches,
                "rmsnorm": norm_ops.rmsnorm.launches,
                "rmsnorm_residual": norm_ops.rmsnorm.residual_launches}
    steps = PROMPT_LEN + NEW_TOKENS - 1
    n_attn = cfg.n_layers
    n_norm = 2 * cfg.n_layers + 1
    # the model adds its residuals itself, as the JAX model does, so the
    # residual variant is held against its plain version in phase 3 only
    expected = {"decode_attention": n_attn * steps, "rmsnorm": n_norm * steps,
                "rmsnorm_residual": 0}
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
        hidden = api.forward(engine.params, seq, return_hidden=True)
        ref = unembed(hidden[:, list(CHECK_POSITIONS)], engine.params["embed"], cfg).float()
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
        if "decode_partial" in name or "decode_merge" in name:
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
    engine, cache, seq, launches = phase_serve(torch, args.seed, smi)
    if args.profile:
        phase_profile(torch, engine, cache, seq)

    meta = {
        "decode_attention": ("cuda", DECODE_SRC,
                             "src/repro/kernels/decode_attention/decode_attention.py:125"),
        "rmsnorm": ("triton", RMSNORM_SRC, "src/repro/kernels/rmsnorm/rmsnorm.py:51"),
        "rmsnorm_residual": ("triton", RMSNORM_SRC, "src/repro/kernels/rmsnorm/rmsnorm.py:62"),
    }
    kernels = []
    for name, cases in results.items():
        route, source, replaces = meta[name]
        main_case = cases[0]  # the serving path's shape at batch 4
        err = max(c["max_abs_err"] for c in cases)
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err,
            **{k: main_case[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            # the same two numbers under the names PERF.md's table uses
            "kernel_ms": main_case["ms"], "max_err": err,
            "card": smi, "cases": cases,
        })
    if any(not math.isfinite(k["ms"]) for k in kernels):
        raise AssertionError("a kernel time is not finite")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
