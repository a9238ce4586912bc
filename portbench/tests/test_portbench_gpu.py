"""On the card: a traced run of tiny cells at widths the kernels are built
for reads every span and keeps each share of a roofline under 100 %."""

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import HYBRID_ARCH, MOE_ARCH, tiny_cell

pytestmark = pytest.mark.gpu

WIDE = {"d_model": 256, "n_heads": 4, "head_dim": 64}
CARD_ARCHS = {
    "moe_transformer": dict(MOE_ARCH, **WIDE, n_kv_heads=2),
    "mamba2_hybrid": dict(HYBRID_ARCH, **WIDE, n_kv_heads=4,
                          ssm=dict(HYBRID_ARCH["ssm"], head_dim=64, d_state=64, chunk=64)),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.parametrize("family", sorted(CARD_ARCHS))
def test_traced_run_on_the_card(card, family):
    cell = tiny_cell(CARD_ARCHS[family], "bfloat16", seq_len=512)
    prog = harness.build_program(cell, 1, card)
    harness.checked_steps(cell, prog, 1)
    tr = harness.traced(cell, prog, 3, card)
    assert tr.kernels and 0 < tr.busy_s <= tr.wall_s
    assert tr.span_device_s("optimizer") > 0
    op = "pb.ssd" if family == "mamba2_hybrid" else "pb.attn"
    assert tr.span_device_s(op) > 0 and tr.span_device_s(op + ".bwd") > 0
    assert 0 < tr.roofline(op) <= 100
    if family == "moe_transformer":
        assert tr.span_device_s("pb.moe_layer") > 0
    breakdown = tr.breakdown()
    assert len(breakdown["device_ops"]) <= 10 and len(breakdown["idle_gaps"]) <= 10
