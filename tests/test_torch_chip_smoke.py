"""``chip_smoke.py`` refuses to run without a GPU or outside the repo, and
its phases run end to end on the CPU at a tiny size (plain versions standing
in for the kernels, host timers for CUDA events), so the script's own logic
is checked before it reaches a card."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _run(script: Path, cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_exits_nonzero_without_cuda():
    res = _run(ROOT / "chip_smoke.py", ROOT)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert '"ok"' not in res.stdout


def test_exits_nonzero_alone_in_a_directory(tmp_path):
    # refused for the missing checkout before the device is looked at, so
    # this holds on a machine with a card too
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(tmp_path / "chip_smoke.py", tmp_path)
    assert res.returncode != 0
    assert "src/repro_torch is missing" in res.stderr
    assert '"ok"' not in res.stdout


class _HostTimer:
    def __init__(self, torch):
        pass

    def __call__(self, fn, iters=1, warmup=0):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3


def test_phases_run_on_cpu_at_tiny_size(monkeypatch, capsys):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import base, registry
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as norm_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    tiny = dataclasses.replace(
        base.reduced(registry.get_config("gemma3-1b")), name="tiny", n_layers=8,
        sliding_window=8, param_dtype="bfloat16", compute_dtype="bfloat16",
    )
    tiny_train = dataclasses.replace(
        base.reduced(registry.get_config("h2o-danube-1.8b")), name="tiny-train", n_layers=3,
        sliding_window=16, param_dtype="bfloat16", compute_dtype="bfloat16",
    )
    bf16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    tiny_mamba = dataclasses.replace(
        base.reduced(registry.get_config("mamba2-370m")), name="tiny-mamba", n_layers=3, **bf16)
    # one group of the 6-block pattern plus a tail of 2 mamba blocks
    tiny_zamba = dataclasses.replace(
        base.reduced(registry.get_config("zamba2-1.2b")), name="tiny-zamba", n_layers=8, **bf16)
    monkeypatch.setitem(registry.ARCHS, "tiny-mamba", tiny_mamba)
    monkeypatch.setitem(registry.ARCHS, "tiny-zamba", tiny_zamba)
    monkeypatch.setitem(registry.ARCHS, "tiny", tiny)
    monkeypatch.setitem(registry.ARCHS, "tiny-train", tiny_train)
    for name, value in dict(
        DEVICE="cpu", MODEL="tiny", PROMPT_LEN=10, NEW_TOKENS=4, MAX_LEN=16,
        BATCH=2, CHECK_POSITIONS=(0, 7, 8, 13), Timer=_HostTimer,
        TRAIN_MODEL="tiny-train", TRAIN_BATCH=2, TRAIN_SEQ=40, TRAIN_LR=1e-2,
        FLASH_CASES=[("h2o-danube train", 2, 40, 8, 2, 16, True, 16),
                     ("gemma3-1b forward, global", 2, 24, 4, 1, 16, True, None)],
        FLASH_FP32_CASES=[("fp32 non-causal", 1, 20, 4, 1, 16, False, None)],
        RMSNORM_CASES=[(4, 64), (40, 128)], RMSNORM_RESIDUAL_CASES=[(4, 64)],
        RMSNORM_BWD_CASES=[(40, 64), (4, 64)],
        SSD_CASES=[("mamba2-370m prefill", 1, 64, 4, 16, 16, 1, "float32", False),
                   ("zamba2-1.2b forward", 2, 32, 4, 16, 8, 1, "float32", False)],
        SSD_EDGE_CASES=[("S < chunk", 1, 10, 4, 16, 16, 1, "float32", False),
                        ("G 2", 1, 32, 4, 16, 8, 2, "float32", True),
                        ("bf16 inputs", 1, 32, 4, 16, 8, 1, "bfloat16", False),
                        ("initial state, 128 chunks", 1, 64, 4, 16, 16, 1, "float32", True)],
        SSD_CHUNK=16, SSM_MODELS=("tiny-mamba", "tiny-zamba"), SSM_PROMPT_LEN=25,
        SSM_NEW_TOKENS=8, SSM_MAX_LEN=32, SSM_BATCH=2, SSM_CHECK_POSITIONS=(0, 15, 16, 31),
        PREFILL_MODEL="tiny-mamba", PREFILL_LEN=64,
        sync=lambda torch: None, phase_device=lambda torch: "cpu, 0 W",
        phase_build=lambda torch: None,
        # no profiler trace of a card here: run the call and name the kernel
        device_kernels=lambda torch, fn: (fn(), ["decode_attention_kernel"])[1],
        decode_plan=lambda torch, ops, b, hkv, sk, d, g: dict(
            zip(("n_split", "split_len"), ops.split_plan(b, hkv, sk, 132)),
            max_active_clusters=1, smem_bytes=0),
    ).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)

    # on the CPU the wrappers run their plain versions, which do not count:
    # count those calls instead, so the launch assertions are exercised (the
    # residual variant's too, so that its zero on the serve path is checked)
    def counting(fn, wrapper, counter="launches"):
        def call(*a, **k):
            setattr(wrapper, counter, getattr(wrapper, counter) + 1)
            return fn(*a, **k)
        return call

    monkeypatch.setattr(dec_ops, "decode_attention_ref",
                        counting(dec_ops.decode_attention_ref, dec_ops.decode_attention))
    monkeypatch.setattr(norm_ops, "rmsnorm_ref", counting(norm_ops.rmsnorm_ref, norm_ops.rmsnorm))
    monkeypatch.setattr(norm_ops, "rmsnorm_residual_ref", counting(
        norm_ops.rmsnorm_residual_ref, norm_ops.rmsnorm, "residual_launches"))
    monkeypatch.setattr(norm_ops, "rmsnorm_bwd_ref", counting(
        norm_ops.rmsnorm_bwd_ref, norm_ops.rmsnorm, "backward_launches"))
    monkeypatch.setattr(fa_ops, "flash_attention_ref", counting(
        fa_ops.flash_attention_ref, fa_ops.flash_attention))
    monkeypatch.setattr(fa_ops, "flash_attention_bwd_ref", counting(
        fa_ops.flash_attention_bwd_ref, fa_ops.flash_attention, "backward_launches"))
    monkeypatch.setattr(ssd_ops, "ssd_ref", counting(ssd_ops.ssd_ref, ssd_ops.ssd))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])

    assert cs.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "cpu", "count": 1}}
    kernels = {k["name"]: k for k in json.loads(lines[-2])["kernels"]}
    assert sorted(kernels) == ["decode_attention", "flash_attention", "flash_attention_bwd",
                               "rmsnorm", "rmsnorm_bwd", "rmsnorm_residual", "ssd_scan"]
    steps = 10 + 4 - 1
    assert kernels["decode_attention"]["launches"] == 8 * steps
    assert kernels["rmsnorm"]["launches"] == 17 * steps
    assert kernels["rmsnorm_residual"]["launches"] == 0
    # train: 2 evals (3 attention, 7 norms each) and 4 remat steps (3 + 3
    # attention forwards, 3 backwards; 7 + 6 norm forwards, 7 backwards)
    assert kernels["flash_attention"]["launches"] == 2 * 3 + 4 * 6
    assert kernels["flash_attention_bwd"]["launches"] == 4 * 3
    assert kernels["rmsnorm_bwd"]["launches"] == 4 * 7
    assert kernels["rmsnorm"]["launches_by_path"]["train"] == 2 * 7 + 4 * 13
    # ssm: tiny-mamba's bf16 and fp32 forwards, its layer-0 state check and
    # two prefills (3 mamba layers each), tiny-zamba's two forwards (7) and
    # state check; the decode runs no B4
    assert kernels["ssd_scan"]["launches"] == (3 + 3 + 1 + 2 * 3) + (7 + 7 + 1)
    assert kernels["ssd_scan"]["launches_by_path"]["serve"] == 0
    ssm = kernels["decode_attention"]["launches_by_path"]["ssm"]
    assert ssm == 1 * 2 * (25 + 8 - 1)  # tiny-zamba's shared attention, bf16 and fp32 decode
    assert kernels["flash_attention"]["launches_by_path"]["ssm"] == 2
    assert kernels["ssd_scan"]["library_ms"] is None
    # B2's cases: one device kernel a call, and the main path's split plans
    dec = kernels["decode_attention"]["cases"]
    assert all(c["device_kernels"] == ["decode_attention_kernel"] for c in dec)
    assert [(c["plan"]["n_split"], c["plan"]["split_len"]) for c in dec] == [
        (16, 32), (16, 32), (16, 64), (16, 64), (2, 256)]
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "kernel_ms", "max_err",
            "launches_by_path"}
    for k in kernels.values():
        assert keys <= set(k)
        assert (k["kernel_ms"], k["max_err"]) == (k["ms"], k["max_abs_err"])
        assert (ROOT / k["source"]).exists()
        assert (ROOT / k["replaces"].split(":")[0]).exists()


def _sass(fn_counts):
    lines = ["", "Fatbin elf code:", "================", "arch = sm_90a"]
    for fn, n in fn_counts.items():
        lines += [f"\t\tFunction : {fn}", "\t.headerflags\t@\"EF_CUDA_SM90\""]
        lines += ["        /*0000*/                   LDSM.16.M88.4 R4, [R2] ;"]
        lines += [f"        /*{16 * (i + 1):04x}*/                   HMMA.16816.F32.BF16 R8, R4, R12, R8 ;"
                  for i in range(n)]
        lines += ["        /*0ff0*/                   EXIT ;"]
    return "\n".join(lines)


@pytest.mark.parametrize("dkv_hmma,ok", [(3, True), (0, False), (None, False)])
def test_sass_check_needs_tensor_cores_in_every_bf16_flash_kernel(monkeypatch, dkv_hmma, ok):
    """The build phase's SASS check (cuobjdump runs only beside nvcc, on the
    card's machine): every instance of the three bf16 B1 kernels must hold
    HMMA instructions, and each kernel must have an instance."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke as cs

    fns = {"_ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi80ELi128EEEv9FlashArgs": 96,
           "_ZN12_GLOBAL__N_120flash_fwd_mma_kernelILi256ELi64EEEv9FlashArgs": 40,
           "_ZN12_GLOBAL__N_123flash_bwd_dq_mma_kernelILi80ELi128EEEv9FlashArgs": 7,
           "_ZN12_GLOBAL__N_116flash_fwd_kernelILi80ELi64EEEv9FlashArgs": 0}
    if dkv_hmma is not None:
        fns["_ZN12_GLOBAL__N_124flash_bwd_dkv_mma_kernelILi80EEEv9FlashArgs"] = dkv_hmma
    counts = cs.mma_counts(_sass(fns))
    assert counts == fns
    if ok:
        cs.check_tensor_cores(counts)
    else:
        with pytest.raises(AssertionError, match="SASS"):
            cs.check_tensor_cores(counts)
