"""``chip_smoke.py`` refuses to run without a GPU or outside the repo, and
its phases run end to end on the CPU at a tiny size (plain versions standing
in for the kernels, host timers for CUDA events), so the script's own logic
is checked before it reaches a card."""

import contextlib
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
    from repro_torch.kernels import count_launch
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
    # granite's GQA group of 3; every expert chosen (top 4 of 4), so that
    # the int8 cache's noise cannot flip a router choice at this size
    tiny_moe = dataclasses.replace(
        base.reduced(registry.get_config("granite-moe-3b-a800m")), name="tiny-moe", n_heads=6,
        n_kv_heads=2, moe=base.MoEConfig(n_experts=4, top_k=4, d_ff_expert=32), **bf16)
    tiny_whisper = dataclasses.replace(
        base.reduced(registry.get_config("whisper-large-v3")), name="tiny-whisper", **bf16)
    # phase 12: h2o-danube's head dim 80 and granite-34b's 48 heads over one
    # kv head, at 2 layers
    tiny_danube = dataclasses.replace(
        base.reduced(registry.get_config("h2o-danube-1.8b")), name="tiny-danube", head_dim=80,
        **bf16)
    tiny_granite = dataclasses.replace(
        base.reduced(registry.get_config("granite-34b")), name="tiny-granite", n_heads=48,
        n_kv_heads=1, **bf16)
    monkeypatch.setitem(registry.ARCHS, "tiny-danube", tiny_danube)
    monkeypatch.setitem(registry.ARCHS, "tiny-granite", tiny_granite)
    monkeypatch.setitem(registry.ARCHS, "tiny-moe", tiny_moe)
    monkeypatch.setitem(registry.ARCHS, "tiny-whisper", tiny_whisper)
    monkeypatch.setitem(registry.ARCHS, "tiny-mamba", tiny_mamba)
    monkeypatch.setitem(registry.ARCHS, "tiny-zamba", tiny_zamba)
    monkeypatch.setitem(registry.ARCHS, "tiny", tiny)
    monkeypatch.setitem(registry.ARCHS, "tiny-train", tiny_train)
    for name, value in dict(
        DEVICE="cpu", MODEL="tiny", PROMPT_LEN=10, NEW_TOKENS=4, MAX_LEN=16,
        BATCH=2, CHECK_POSITIONS=(0, 7, 8, 13), Timer=_HostTimer,
        TRAIN_MODEL="tiny-train", TRAIN_BATCH=2, TRAIN_SEQ=40, TRAIN_LR=1e-2,
        FLASH_CASES=[("h2o-danube train", 2, 40, 8, 2, 16, True, 16),
                     ("gemma3-1b forward, global", 2, 24, 4, 1, 16, True, None),
                     ("whisper cross", 2, (12, 20), 4, 4, 16, False, None),
                     ("h2o-danube serve forward", 2, 14, 8, 2, 16, True, 8),
                     ("granite-34b forward", 2, 12, 48, 1, 16, True, None),
                     ("granite-34b train", 2, 24, 48, 1, 16, True, None),
                     ("granite-34b train, G 6", 2, 24, 6, 1, 16, True, None),
                     ("granite-34b train, G 12", 2, 24, 12, 1, 16, True, None)],
        FLASH_FP32_CASES=[("fp32 non-causal", 1, 20, 4, 1, 16, False, None),
                          ("fp32 G 48 ragged", 1, 10, 48, 1, 16, True, 4)],
        RMSNORM_CASES=[(4, 64), (40, 128)], RMSNORM_RESIDUAL_CASES=[(4, 64)],
        RMSNORM_BWD_CASES=[(40, 64), (4, 64)],
        SSD_CASES=[("mamba2-370m prefill", 1, 64, 4, 16, 16, 1, "float32", False),
                   ("zamba2-1.2b forward", 2, 32, 4, 16, 8, 1, "float32", False)],
        SSD_EDGE_CASES=[("S < chunk", 1, 10, 4, 16, 16, 1, "float32", False),
                        ("G 2", 1, 32, 4, 16, 8, 2, "float32", True),
                        ("bf16 inputs", 1, 32, 4, 16, 8, 1, "bfloat16", False),
                        ("initial state, 128 chunks", 1, 64, 4, 16, 16, 1, "float32", True)],
        SSD_CHUNK=16,
        SSD_BWD_CASES=[("mamba2-370m train", 2, 32, 4, 16, 16, 1, 16, False, False, False)],
        SSD_BWD_EDGE_CASES=[("initial state, dfinal", 1, 32, 4, 16, 8, 2, 16, True, True, False),
                            ("unaligned rows, chunk 10", 1, 30, 2, 16, 16, 1, 10, True, True,
                             True)],
        SSM_TRAIN_BATCH=2, SSM_TRAIN_SEQ=32, SSM_REMAT_LAYERS=1,
        SSM_MODELS=("tiny-mamba", "tiny-zamba"), SSM_PROMPT_LEN=25,
        SSM_NEW_TOKENS=8, SSM_MAX_LEN=32, SSM_BATCH=2, SSM_CHECK_POSITIONS=(0, 15, 16, 31),
        PREFILL_MODEL="tiny-mamba", PREFILL_LEN=64,
        # phase 6 serves them cut by one layer (tiny-zamba: one group and a
        # tail of one), the prefill at full depth
        SSM_SERVE_LAYERS={"tiny-mamba": 2, "tiny-zamba": 7},
        PILOT_TRAIN_LAYERS=None, PILOT_SERVE_PROMPT_LEN=6, PILOT_SERVE_NEW_TOKENS=3,
        PILOT_SERVE_MAX_LEN=16, PILOT_TIMEOUT_S=120.0,
        MOE_MODEL="tiny-moe", MOE_SERVE_LAYERS=None, MOE_PROMPT_LEN=10, MOE_NEW_TOKENS=4, MOE_MAX_LEN=16, MOE_BATCH=2,
        MOE_CHECK_POSITIONS=(0, 5, 9, 12), MOE_REMAT_LAYERS=1,
        WHISPER_MODEL="tiny-whisper", WHISPER_PROMPT_LEN=4, WHISPER_NEW_TOKENS=6,
        WHISPER_MAX_LEN=12, WHISPER_BATCH=2, WHISPER_CHECK_POSITIONS=(0, 3, 5, 9),
        WHISPER_TRAIN_BATCH=2, WHISPER_TRAIN_SEQ=12,
        # tiny-granite cut to 1 of its 2 layers, as granite-34b is cut
        DENSE_MODELS=[("tiny-danube", None, True, 10, 4, (0, 7, 9, 13)),
                      ("tiny-granite", 1, False, 8, 4, (0, 5, 7, 11))],
        DENSE_BATCH=2, DENSE_MAX_LEN=16,
        # phase 13: tiny-granite trained uncut on phase 5's tiny batch, its
        # remat and plain-version checks at 1 layer
        DENSE_TRAIN_MODEL="tiny-granite", DENSE_TRAIN_LAYERS=2, DENSE_REMAT_LAYERS=1,
        DENSE_PLAIN_SEQ=16,
        # phase 14: tiny-moe uncut through the sharded step over gloo (one
        # rank), tiny-mamba cut to 2 layers (its fp32 gradients at 1 layer on
        # 16 tokens), tiny cut to 6 layers (a group of 5 swa : 1 global)
        # decoding phase 4's tiny prompts past its 8-slot ring's wrap
        DIST_MODEL="tiny-moe", DIST_LAYERS=2, DIST_STEPS=3,
        DIST_SSM_MODEL="tiny-mamba", DIST_SSM_LAYERS=2, DIST_SSM_GRAD_LAYERS=1,
        DIST_SSM_GRAD_SEQ=16, DIST_DECODE_MODEL="tiny", DIST_DECODE_LAYERS=6,
        # phase 3's new modes at small shapes (the partial mode's per-rank
        # shapes are gemma3-1b's, derived from the production mesh)
        DECODE_FOLD_CASE=(2, 64, 4, 1, 16, 50, 8), RMSNORM_EXT_CASES=[(40, 64, 128)],
        # phase 15: the tiny trained cells on meta; the production cells are
        # cheap ones (the script's take ~15-30 s each on a host CPU)
        DRYRUN_CELLS=[("gemma3-1b", "prefill_32k", False), ("gemma3-1b", "decode_32k", True)],
        # the plain versions are the CPU path: phase 7 may not refuse them here
        plain_versions_forbidden=contextlib.nullcontext,
        sync=lambda torch: None, phase_device=lambda torch: "cpu, 0 W",
        phase_build=lambda torch: None,
        # no profiler trace of a card here: run the call and name the kernel
        device_kernels=lambda torch, fn: (fn(), ["decode_attention_kernel"])[1],
        decode_plan=lambda torch, ops, b, hkv, sk, d, g: dict(
            zip(("n_split", "split_len"), ops.split_plan(b, hkv, sk, 132)),
            max_active_clusters=1, smem_bytes=0),
    ).items():
        monkeypatch.setattr(cs, name, value)
    # phase 15's meta runs check the kernels' instances as the card does:
    # admit the tiny configs' head dim and state size
    monkeypatch.setattr(fa_ops, "HEAD_DIMS", fa_ops.HEAD_DIMS + (16,))
    monkeypatch.setattr(ssd_ops, "HEAD_DIMS", ssd_ops.HEAD_DIMS + (16,))
    monkeypatch.setattr(ssd_ops, "D_STATES", ssd_ops.D_STATES + (8, 16))
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)

    # on the CPU the wrappers run their plain versions, which do not count:
    # count those calls instead, so the launch assertions are exercised (the
    # residual variant's too, so that its zero on the serve path is checked)
    # (with the wrappers' own lock: phase 7's serve CUs run on two threads)
    def counting(fn, wrapper, counter="launches"):
        def call(*a, **k):
            count_launch(wrapper, counter)
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
    monkeypatch.setattr(ssd_ops, "ssd_bwd_ref", counting(
        ssd_ops.ssd_bwd_ref, ssd_ops.ssd, "backward_launches"))
    monkeypatch.setattr(dec_ops, "decode_attention_partial_ref", counting(
        dec_ops.decode_attention_partial_ref, dec_ops.decode_attention, "partial_launches"))
    monkeypatch.setattr(norm_ops, "row_stat_ref", counting(
        norm_ops.row_stat_ref, norm_ops.rmsnorm, "stat_launches"))
    monkeypatch.setattr(norm_ops, "rmsnorm_ext_ref", counting(
        norm_ops.rmsnorm_ext_ref, norm_ops.rmsnorm, "ext_launches"))
    monkeypatch.setattr(norm_ops, "rmsnorm_ext_bwd_ref", counting(
        norm_ops.rmsnorm_ext_bwd_ref, norm_ops.rmsnorm, "ext_backward_launches"))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])

    assert cs.main() == 0
    text = capsys.readouterr().out
    lines = text.strip().splitlines()
    # phase 13's rank-local attention at G 6 and G 12, and phase 15's cells
    # on both production meshes
    for heads in ("heads 0-5 of 48 over the kv head (G 6)", "heads 0-11 of 48 over the kv head (G 12)"):
        assert f"dense-train: rank-local attention, {heads}" in text
    assert "dryrun: gemma3-1b x prefill_32k on the fake pod_32x8 mesh" in text
    assert "dryrun: gemma3-1b x decode_32k on the fake multipod_2x32x8 mesh" in text
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu", "kind": "cpu", "count": 1}}
    kernels = {k["name"]: k for k in json.loads(lines[-2])["kernels"]}
    assert sorted(kernels) == ["decode_attention", "decode_attention_partial", "flash_attention",
                               "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd", "rmsnorm_ext",
                               "rmsnorm_ext_bwd", "rmsnorm_residual", "rmsnorm_stat", "ssd_scan",
                               "ssd_scan_bwd"]
    # the sharded paths' modes: 0 on every unsharded path
    new = {"decode_attention_partial": 0, "rmsnorm_stat": 0, "rmsnorm_ext": 0,
           "rmsnorm_ext_bwd": 0}
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
    # ssm: tiny-mamba's bf16 and fp32 forwards at 2 layers, its layer-0 state
    # check and two prefills at full depth (3 mamba layers each), tiny-zamba's
    # two forwards at 7 layers (6 mamba) and state check; the decode runs no B4
    assert kernels["ssd_scan"]["launches"] == (2 + 2 + 1 + 2 * 3) + (6 + 6 + 1)
    assert kernels["ssd_scan"]["launches_by_path"]["serve"] == 0
    ssm = kernels["decode_attention"]["launches_by_path"]["ssm"]
    assert ssm == 1 * 2 * (25 + 8 - 1)  # tiny-zamba's shared attention, bf16 and fp32 decode
    assert kernels["flash_attention"]["launches_by_path"]["ssm"] == 2
    assert kernels["ssd_scan"]["library_ms"] is None
    # pilot: two train_chunk CUs of 2 steps (the train step's launches above,
    # times 4 steps in all), then two serve CUs of 6 + 3 tokens (8 steps each)
    pilot = {name: k["launches_by_path"]["pilot"] for name, k in kernels.items()}
    assert pilot == {"flash_attention": 4 * 6, "flash_attention_bwd": 4 * 3,
                     "rmsnorm": 4 * 13 + 2 * 17 * 8, "rmsnorm_bwd": 4 * 7,
                     "decode_attention": 2 * 8 * 8, "rmsnorm_residual": 0, "ssd_scan": 0,
                     "ssd_scan_bwd": 0, **new}
    # B2's cases: one device kernel a call, and the main path's split plans
    dec = kernels["decode_attention"]["cases"]
    assert all(c["device_kernels"] == ["decode_attention_kernel"] for c in dec)
    assert [(c["plan"]["n_split"], c["plan"]["split_len"]) for c in dec] == [
        (16, 32), (16, 32), (16, 64), (16, 64), (2, 256), (8, 64), (4, 128), (3, 150), (3, 500),
        (8, 128), (8, 512), (16, 64), (16, 64), (16, 64), (16, 64), (16, 64), (16, 64)]
    # moe: two engines (bf16 and int8 caches) of 13 steps over 2 layers, and
    # the drop-free and the published-capacity forwards (a third drop-free
    # one when the int8 engine's tokens differ)
    moe = {name: k["launches_by_path"]["moe"] for name, k in kernels.items()}
    n_fwd = moe["flash_attention"] // 2
    assert n_fwd in (2, 3)
    assert moe == {"decode_attention": 2 * 2 * 13, "rmsnorm": 2 * 5 * 13 + 5 * n_fwd,
                   "flash_attention": 2 * n_fwd, "flash_attention_bwd": 0, "rmsnorm_bwd": 0,
                   "rmsnorm_residual": 0, "ssd_scan": 0, "ssd_scan_bwd": 0, **new}
    # moe-train: 2 evals (2 attention, 5 norms each) and 4 remat steps (2 + 2
    # attention forwards, 2 backwards; 5 + 4 norm forwards, 5 backwards)
    moe_train = {name: k["launches_by_path"]["moe-train"] for name, k in kernels.items()}
    assert moe_train == {"flash_attention": 2 * 2 + 4 * 4, "flash_attention_bwd": 4 * 2,
                         "rmsnorm": 2 * 5 + 4 * 9, "rmsnorm_bwd": 4 * 5, "decode_attention": 0,
                         "rmsnorm_residual": 0, "ssd_scan": 0, "ssd_scan_bwd": 0, **new}
    # whisper (2 encoder + 2 decoder layers): the cross-cache prefill's encoder
    # (2 attentions, 5 norms), 4 + 6 - 1 engine steps and the one after them
    # (two decode attentions and 7 norms each), the forward (2 + 2 x 2
    # attentions, 5 + 7 norms); then training: 2 evals and 4 remat steps
    # (every layer checkpointed: 6 + 6 attentions, 6 backwards; 12 + 10
    # norms, 12 backwards)
    whisper = {name: k["launches_by_path"]["whisper"] for name, k in kernels.items()}
    assert whisper == {"decode_attention": 10 * 4, "flash_attention": 2 + 6 + 2 * 6 + 4 * 12,
                       "flash_attention_bwd": 4 * 6, "rmsnorm": 5 + 10 * 7 + 12 + 2 * 12 + 4 * 22,
                       "rmsnorm_bwd": 4 * 12, "rmsnorm_residual": 0, "ssd_scan": 0,
                       "ssd_scan_bwd": 0, **new}
    # ssm-train: tiny-mamba (3 mamba layers, each its own stacked group) and
    # tiny-zamba (a group of 5 mamba + the shared attention block, a tail of 2
    # mamba), 2 evals and 4 remat steps each; the stacked groups' mamba layers
    # run B4 again in the backward pass, the tail's do not
    ssm_train = {name: k["launches_by_path"]["ssm-train"] for name, k in kernels.items()}
    assert ssm_train == {
        "ssd_scan": (2 * 3 + 4 * (3 + 3)) + (2 * 7 + 4 * (7 + 5)),
        "ssd_scan_bwd": 4 * 3 + 4 * 7,
        "flash_attention": 2 * 1 + 4 * 2, "flash_attention_bwd": 4 * 1,
        "rmsnorm": (2 * 7 + 4 * (7 + 6)) + (2 * 17 + 4 * (17 + 12)),
        "rmsnorm_bwd": 4 * 7 + 4 * 17, "decode_attention": 0, "rmsnorm_residual": 0, **new}
    assert kernels["ssd_scan_bwd"]["launches"] == ssm_train["ssd_scan_bwd"]
    # dense-serve: tiny-danube (2 layers) decodes 10 + 4 - 1 steps and the
    # engine's next one, then runs the forward; tiny-granite (1 layer) 8 + 4 - 1
    # and one more, then its forward
    dense = {name: k["launches_by_path"]["dense-serve"] for name, k in kernels.items()}
    assert dense == {"decode_attention": 14 * 2 + 12 * 1, "rmsnorm": (14 * 5 + 5) + (12 * 3 + 3),
                     "flash_attention": 2 + 1, "flash_attention_bwd": 0, "rmsnorm_bwd": 0,
                     "rmsnorm_residual": 0, "ssd_scan": 0, "ssd_scan_bwd": 0, **new}
    # dense-train: tiny-granite (2 layers, 48/1 heads), 2 evals (2 attention,
    # 5 norms each) and 4 remat steps (2 + 2 attention forwards, 2 backwards;
    # 5 + 4 norm forwards, 5 backwards)
    dense_train = {name: k["launches_by_path"]["dense-train"] for name, k in kernels.items()}
    assert dense_train == {"flash_attention": 2 * 2 + 4 * 4, "flash_attention_bwd": 4 * 2,
                           "rmsnorm": 2 * 5 + 4 * 9, "rmsnorm_bwd": 4 * 5, "decode_attention": 0,
                           "rmsnorm_residual": 0, "ssd_scan": 0, "ssd_scan_bwd": 0, **new}
    # dist-train: tiny-moe (2 layers) through the sharded step, 3 remat steps
    # (2 + 2 attention forwards, 2 backwards; 5 + 4 norm forwards, 5
    # backwards), equal to the unsharded step's
    dist_train = {name: k["launches_by_path"]["dist-train"] for name, k in kernels.items()}
    assert dist_train == {"flash_attention": 3 * 4, "flash_attention_bwd": 3 * 2,
                          "rmsnorm": 3 * 9, "rmsnorm_bwd": 3 * 5, "decode_attention": 0,
                          "rmsnorm_residual": 0, "ssd_scan": 0, "ssd_scan_bwd": 0, **new}
    # dist-ssm: tiny-mamba (2 mamba layers, each a stacked group) through the
    # sharded step, 3 remat steps: its gate norms (2 forward, 2 again in the
    # recompute, 2 backward) on the external-statistic mode, one row
    # statistic each, its ln1s and final norm on B3a (2 + 2 + 1 forward, 3
    # backward), B4 2 + 2 forward and 2 backward
    dist_ssm = {name: k["launches_by_path"]["dist-ssm"] for name, k in kernels.items()}
    assert dist_ssm == {**{name: 0 for name in dist_ssm},
                        "ssd_scan": 3 * 4, "ssd_scan_bwd": 3 * 2, "rmsnorm": 3 * 5,
                        "rmsnorm_bwd": 3 * 3, "rmsnorm_ext": 3 * 4, "rmsnorm_ext_bwd": 3 * 2,
                        "rmsnorm_stat": 3 * 6}
    # dist-decode: tiny cut to 6 layers, 10 + 4 steps sharded: B2's partial
    # mode on every layer, 13 norms a step
    dist_decode = {name: k["launches_by_path"]["dist-decode"] for name, k in kernels.items()}
    assert dist_decode == {**{name: 0 for name in dist_decode},
                           "decode_attention_partial": 14 * 6, "rmsnorm": 14 * 13}
    for name in new:
        assert kernels[name]["launches"] > 0 and kernels[name]["library_ms"] is None
    # the fold case: its last range keeps no slot
    fold = kernels["decode_attention_partial"]["cases"][-1]
    assert fold["case"] == "fold of 8 ranges" and fold["empty_ranges"] == [7]
    # h2o-danube's phase 12 case runs the forward only; granite-34b's G 48
    # runs both ways at its serve and its training shape
    fwd = [c["case"] for c in kernels["flash_attention"]["cases"]]
    bwd = [c["case"] for c in kernels["flash_attention_bwd"]["cases"]]
    assert "h2o-danube serve forward" in fwd and "h2o-danube serve forward" not in bwd
    for case in ("h2o-danube train", "granite-34b forward", "granite-34b train",
                 "granite-34b train, G 6", "granite-34b train, G 12"):
        assert case in fwd and case in bwd
    assert kernels["ssd_scan_bwd"]["library_ms"] is None
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


@pytest.mark.parametrize("spill,ok", [(0, True), (48, False)])
def test_build_check_refuses_a_spilling_backward(monkeypatch, tmp_path, spill, ok):
    """The build phase reads ptxas's report for B4's backward (written beside
    the library, on the card's machine) and fails if a kernel spills."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build

    log = tmp_path / "libssd_scan_bwd.log"
    log.write_text(
        "ptxas info    : Compiling entry function '_Z17ssd_bwd_dx_kernelILi128EEv' for 'sm_90a'\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 1 barriers\n")
    monkeypatch.setattr(build, "library_path", lambda name: tmp_path / f"lib{name}.so")
    monkeypatch.setattr(cs, "log", lambda msg: None)
    if ok:
        cs.check_no_spills(build, "ssd_scan_bwd")
    else:
        with pytest.raises(AssertionError, match="spills"):
            cs.check_no_spills(build, "ssd_scan_bwd")
