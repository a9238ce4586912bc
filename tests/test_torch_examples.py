"""The port's runnable ML examples (``examples/torch_pilot_train.py`` and
``examples/torch_pilot_serve.py``) run end to end on the CPU with
``--device cpu`` (the kernels' plain versions), each in a process where
``jax`` and the JAX package ``repro`` cannot be imported, and print the
lines their JAX counterparts print.  One torch thread a process, so that
each finishes in well under 90 s beside other test workers."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TIME_LIMIT_S = 240

# run a script as __main__ with jax and the JAX package unimportable
RUNNER = (
    "import runpy, sys\n"
    "sys.modules['jax'] = None\n"
    "sys.modules['repro'] = None\n"
    "script = sys.argv[1]\n"
    "sys.argv = sys.argv[1:]\n"
    "runpy.run_path(script, run_name='__main__')\n"
)


def _run(script, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-c", RUNNER, str(ROOT / "examples" / script), *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=TIME_LIMIT_S)
    assert proc.returncode == 0, f"{script}:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}"
    return proc.stdout


def test_torch_pilot_train_demo_on_cpu():
    out = _run("torch_pilot_train.py", "--device", "cpu")
    assert "on cpu" in out
    assert "trained 30 steps" in out and "(3 chunks on pilots" in out
    assert "(improved=True)" in out
    assert out.count("  chunk ") == 3
    assert "restored params from du://" in out


@pytest.mark.parametrize("preset,replicas", [("demo", 2), ("full", 4)])
def test_torch_pilot_serve_on_cpu(preset, replicas):
    out = _run("torch_pilot_serve.py", "--device", "cpu", "--preset", preset)
    assert f"served {replicas} replicas on cpu" in out
    assert "consistent ✓" in out
    assert out.count(": generated [[") == replicas
    # the fleet really promoted the checkpoint into a site cache: one
    # promotion a serving pod (its second load)
    promos = int(out.rsplit("mem-tier promotions: ", 1)[1].split(")")[0])
    assert promos == replicas // 2


def test_torch_examples_default_to_the_card():
    """Without a card the default device raises: no silent CPU run."""
    for script in ("torch_pilot_train.py", "torch_pilot_serve.py"):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                   CUDA_VISIBLE_DEVICES="")
        proc = subprocess.run([sys.executable, str(ROOT / "examples" / script)],
                              capture_output=True, text=True, env=env, cwd=ROOT,
                              timeout=TIME_LIMIT_S)
        assert proc.returncode != 0, script
        assert "CUDA" in proc.stderr or "cuda" in proc.stderr, proc.stderr[-2000:]
