"""What a run loads: a whole tiny run of the harness on the CPU, in a
process of its own, loads nothing whose top-level name is jax, jaxlib,
flax or repro; the references load none of those and nothing of the
program either."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

RUN = """
import json, sys
sys.path[:0] = [{src!r}, {repo!r}]
from portbench import harness
from portbench.tests.tiny import MOE_ARCH, HYBRID_ARCH, tiny_cell
for arch in (MOE_ARCH, HYBRID_ARCH):
    cell = tiny_cell(arch, "bfloat16", {{"loss_gap": 1, "grad_gap": 1, "update_gap": 1}})
    harness.run(cell, 1, 0.1, False, device="cpu")
    harness.traced(cell, harness.build_program(cell, 1, "cpu"), 0, "cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys
sys.path[:0] = [{repo!r}]
import torch
from portbench import weights
from portbench.reference import common, mamba2_hybrid, moe_transformer
from portbench.tests.tiny import MOE_ARCH, HYBRID_ARCH
for ref, arch in ((moe_transformer, MOE_ARCH), (mamba2_hybrid, HYBRID_ARCH)):
    params = weights.make_params(ref.param_shapes(arch), 1, "cpu", fp32=True)
    tokens = torch.randint(0, arch["vocab_size"], (2, 32))
    batch = {{"tokens": tokens, "labels": tokens}}
    common.train(lambda p, b: ref.loss_fn(p, b, arch, common.Numerics()), params, [batch],
                 {{"peak_lr": 1e-3, "warmup_steps": 1, "total_steps": 10, "max_grad_norm": 1.0}})
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(script: str) -> set:
    code = script.format(src=str(REPO / "src"), repo=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = loaded(RUN)
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_references_load_no_program():
    mods = loaded(REFERENCE)
    assert not mods & (FORBIDDEN | {"repro_torch"}), mods & (FORBIDDEN | {"repro_torch"})


@pytest.mark.parametrize("names, found", [
    (["jax", "numpy"], ["jax"]),
    (["repro.core.session", "repro_torch.models"], ["repro"]),
    (["jaxlib.xla_client", "flax.linen"], ["flax", "jaxlib"]),
    (["repro_torch", "repro_torch.kernels", "jax_free", "reprox", "portbench"], []),
])
def test_guard_compares_whole_top_level_names(names, found):
    from portbench import harness

    assert harness.forbidden_modules(names) == found
