"""The command itself: no result without a program or without a card."""

import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "granite-moe.train-4k", "--seed", "2147483653", "--seconds", "1",
        "--trace", "0"]


def test_no_result_without_the_program(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_no_result_without_a_card():
    if torch.cuda.is_available():
        return  # on a machine with a card the command runs the cell
    out = subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA device" in out.stderr
