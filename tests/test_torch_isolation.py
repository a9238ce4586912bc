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
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


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


def test_unported_families_raise():
    for name in ("qwen3-moe-30b-a3b", "whisper-large-v3"):
        with pytest.raises(NotImplementedError):
            build_model(get_config(name + "-smoke"), device="cpu")
    cfg = dataclasses.replace(get_config("gemma3-1b-smoke"), kv_cache_dtype="int8")
    with pytest.raises(NotImplementedError, match="int8"):
        build_model(cfg, device="cpu").init_cache(1, 8)
