"""The plain references against the program's CPU path at tiny sizes:
the same loss, the same readings after the checked steps, and a control
in fp8 that the comparison refuses."""

import pytest
import torch

from portbench import harness, weights
from portbench.reference import common

from portbench.tests.tiny import tiny_cell

TIGHT = 1e-4  # fp32 on both sides: only the order of sums differs


def program_readings(cell, seed):
    prog = harness.build_program(cell, seed, "cpu")
    return prog, harness.checked_steps(cell, prog, seed)


def test_loss_matches_program(arch):
    cell = tiny_cell(arch)
    prog = harness.build_program(cell, 5, "cpu")
    ref = harness.reference_module(cell)
    want, _ = prog.api.loss_fn(prog.params, prog.batches[0], remat=False)
    params = weights.make_params(ref.param_shapes(cell.arch), 5, "cpu", fp32=True)
    got = ref.loss_fn(params, prog.batches[0], cell.arch, common.Numerics())
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_steps_match_program(arch, seed):
    cell = tiny_cell(arch)
    prog, mine = program_readings(cell, seed)
    theirs = harness.reference_readings(cell, seed, prog.batches)
    numbers = harness.compare(mine, theirs)
    assert all(n["value"] < TIGHT for n in numbers.values()), numbers


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fp8_control_fails(arch, seed):
    cell = tiny_cell(arch)
    prog, _ = program_readings(cell, seed)
    exact = harness.reference_readings(cell, seed, prog.batches)
    control = harness.reference_readings(cell, seed, prog.batches, fp8=True)
    numbers = harness.compare(control, exact)
    assert max(n["value"] for n in numbers.values()) > 100 * TIGHT, numbers


def test_tree_is_the_programs(arch):
    cell = tiny_cell(arch, "bfloat16")
    prog = harness.build_program(cell, 0, "cpu")  # check_tree raises on a mismatch
    assert prog.params["embed"]["table"].dtype == torch.bfloat16
