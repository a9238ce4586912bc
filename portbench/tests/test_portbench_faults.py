"""A whole run on the CPU at a tiny size, past the look for a card: sound,
it comes out correct; with the timed path broken underneath, not."""

import pytest

import repro_torch.models.transformer as transformer
import repro_torch.training.train_step as train_step
from portbench import faults, harness
from portbench.tests.tiny import tiny_cell

#: set from these cells' own readings on the CPU (bf16 program against
#: the fp32 reference on bf16-rounded masters, seeds 1-3, three steps):
#: loss 8.4e-4, grad 1.25e-2, update 1.02e-2, param 1.08e-2 at most; half
#: the batch reads loss 1.8e-3, grad 6.9e-2, update and param 3.7e-2 at
#: least; params not refreshed read param 1
TINY_LIMITS = {"loss_gap": 1.5e-3, "grad_gap": 4e-2, "update_gap": 3e-2, "param_gap": 3e-2}


def run(arch, seed=1, trace=False):
    cell = tiny_cell(arch, "bfloat16", TINY_LIMITS)
    return harness.run(cell, seed, 0.2, trace, device="cpu")


def test_sound_run_is_correct(arch):
    out = run(arch)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"


def test_state_left_unchanged(arch, monkeypatch):
    monkeypatch.setattr(train_step, "adamw_update", lambda grads, state, params, lr, cfg:
                        (params, state))
    out = run(arch)
    assert not out["correct"]
    assert out["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(arch):
    with faults.planted("half_batch"):
        out = run(arch)
    assert not out["correct"], out["checks"]


def test_params_not_refreshed_from_their_masters(arch):
    with faults.planted("stale_params"):
        out = run(arch)
    assert not out["correct"]
    assert out["checks"]["param_gap"]["value"] == pytest.approx(1.0)


def test_traced_run_records_each_op(arch):
    cell = tiny_cell(arch, "bfloat16", TINY_LIMITS)
    prog = harness.build_program(cell, 3, "cpu")
    tr = harness.traced(cell, prog, 0, "cpu")
    name, kind = ("pb.ssd", "mamba") if "ssm" in cell.arch else ("pb.attn", "moe")
    pattern = cell.arch["pattern"]
    stacked = cell.arch["n_layers"] // len(pattern) * pattern.count(kind)
    tail = pattern[: cell.arch["n_layers"] % len(pattern)].count(kind)
    # a forward, remat's recompute (stacked layers only) and a backward
    assert len(tr.records.costs[name]) == (3 * stacked + 2 * tail) * tr.steps
    spans = {e.name for e in tr.cpu}
    assert {name, name + ".bwd", "optimizer"} <= spans
    assert not tr.records.open.get(name)
    assert tr.failed == 0


def test_loss_altered_where_it_is_produced(arch, monkeypatch):
    loss_fn = transformer.loss_fn

    def off(params, batch, cfg, **kw):
        loss, metrics = loss_fn(params, batch, cfg, **kw)
        return loss * 1.01, dict(metrics, loss=loss * 1.01)

    monkeypatch.setattr(transformer, "loss_fn", off)
    out = run(arch)
    assert not out["correct"]
    assert out["checks"]["loss_gap"]["value"] == pytest.approx(0.01, rel=0.05)
