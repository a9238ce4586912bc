"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import neither
``jax`` nor the JAX package, and the entry points refuse to run on a CUDA
device that is not there instead of falling back to the CPU."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge
from repro_torch.checkpoint import checkpoint_files
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving import DecodeEngine

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _absolute_imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_repro_import_in_port_sources():
    # the scan covers the runtime copied from the JAX package too
    for sub in ("core", "backends", "data", "analysis", "checkpoint/checkpointer.py",
                "training/trainer.py"):
        assert any(p.is_relative_to(ROOT / "src" / "repro_torch" / sub) for p in PORT_FILES), sub
    bad = []
    for path in PORT_FILES:
        for mod in _absolute_imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro", "ml_dtypes"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
    assert PORT_FILES[-1].exists()
    assert not bad, bad


def test_port_imports_with_jax_and_repro_blocked():
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = []
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    try:
        importlib.import_module(m.name)
    except ModuleNotFoundError as e:
        if e.name != "triton":  # the Triton kernel module loads on the card only
            raise
    names.append(m.name)
assert not [k for k in sys.modules if k.split(".")[0] in ("jax", "repro") and sys.modules[k]]
print(" ".join(names))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    names = set(res.stdout.split())
    # every module of the port, the runtime copy (core, backends, data,
    # analysis) and the distributed layer included
    assert len(names) >= 93
    assert {"repro_torch.distributed.context", "repro_torch.distributed.sharding_rules",
            "repro_torch.distributed.pipeline", "repro_torch.distributed.moe_parallel",
            "repro_torch.distributed.tensor_parallel", "repro_torch.optim.compression",
            "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
            "repro_torch.launch.op_analysis", "repro_torch.launch.roofline",
            "repro_torch.launch.kernel_substitution"} <= names


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_build_model_default_device_raises_without_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(get_config("gemma3-1b-smoke"))


def test_engine_on_cuda_raises_without_cuda(monkeypatch):
    cfg = get_config("gemma3-1b-smoke")
    api = build_model(cfg, device="cpu")
    files = checkpoint_files(0, "iso", api.init(seed=0))
    _no_cuda(monkeypatch)
    cuda_api = dataclasses.replace(api, device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeEngine.from_files(cuda_api, files, batch=1, max_len=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bridge.params_from_files(files)


def test_pilot_trainer_and_serve_cu_on_cuda_raise_without_cuda(monkeypatch):
    from repro_torch.core import FUNCTIONS, Session
    from repro_torch.core.futures import ComputeFailedError
    from repro_torch.serving import params_from_input
    from repro_torch.training.trainer import PilotTrainer

    _no_cuda(monkeypatch)
    with Session() as s:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PilotTrainer(get_config("h2o-danube-1.8b-smoke"), s, run_name="iso-train")
        s.start_pilot(resource_url="sim://iso", slots=1).wait_active()
        du = s.submit_du(name="iso-weights", files=checkpoint_files(
            0, "iso", build_model(get_config("gemma3-1b-smoke"), device="cpu").init(seed=0)))
        FUNCTIONS.register("iso-serve", lambda cu_ctx, du_id: params_from_input(cu_ctx, du_id))
        cu = s.submit_cu(executable="iso-serve", args=(du.id,), input_data=[du], max_retries=0)
        with pytest.raises(ComputeFailedError, match="CUDA is not available"):
            cu.result(timeout=60)


def test_unported_families_raise():
    """Every family of the JAX package is ported: whisper-large-v3-smoke, the
    last one, builds on the CPU with the JAX tree's keys.  A block kind the
    port does not know still raises."""
    cfg = get_config("whisper-large-v3-smoke")
    params = build_model(cfg, device="cpu").init(seed=0)
    assert set(params) == {"embed", "encoder", "enc_norm", "decoder", "final_norm"}
    assert set(params["encoder"]) == {"ln1", "attn", "ln2", "mlp"}
    assert set(params["decoder"]) == {"ln1", "self_attn", "ln_x", "cross_attn", "ln2", "mlp"}
    assert params["encoder"]["attn"]["q"]["w"].shape[0] == cfg.encdec.n_enc_layers
    assert params["decoder"]["mlp"]["up"]["w"].shape[0] == cfg.n_layers
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(dataclasses.replace(cfg, pattern=("mla",)), device="cpu")


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "granite-moe-3b-a800m"])
def test_moe_models_and_the_int8_cache_build_on_the_cpu(name):
    cfg = dataclasses.replace(get_config(name + "-smoke"), kv_cache_dtype="int8")
    api = build_model(cfg, device="cpu")
    params = api.init(seed=0)
    assert set(params["groups"]["pos0"]) == {"ln1", "attn", "ln2", "moe"}
    cache = api.init_cache(2, 8)["groups"]["pos0"]
    assert {k: v.dtype for k, v in cache.items()} == {
        "k": torch.int8, "v": torch.int8, "k_scale": torch.float32, "v_scale": torch.float32}
    logits, _ = api.decode_step(params, api.init_cache(2, 8), torch.ones(2, 1, dtype=torch.long), 0)
    assert logits.shape == (2, 1, cfg.vocab_size) and bool(logits.isfinite().all())
