"""The zamba2 cell's per-layer metrics and its FLOP count, on synthetic
traces: ``mfu.zamba2`` (portbench/zamba2_costs.py), ``ssd_roofline.zamba2``
(the ``pb.ssd`` costs over the device time under ``pb.ssd`` and
``pb.ssd.bwd``, each kernel once), ``mamba_ms.zamba2`` and
``shared_ms.zamba2`` (the program's spans).  The count's matmul weights are
the matrices of ``reference/zamba2.param_shapes`` that a token multiplies
through."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import costs, harness, zamba2_costs
from portbench.reference import common, zamba2
from portbench.tests.test_portbench_program_spans import _Trace, _span

ROOT = Path(__file__).resolve().parents[1]
ARCH = json.loads((ROOT / "configs" / "zamba2-1.2b.json").read_text())["arch"]
#: leaves a token multiplies through: the projections ("w") and the convs' taps
MATRIX = ("/w", "conv_x_w", "conv_bc_w")


def test_matmul_weights_are_the_reference_trees():
    kinds = common.layer_kinds(ARCH)
    total = ARCH["d_model"] * ARCH["vocab_size"]  # the unembedding over the real vocabulary
    for path, (shape, _) in common.flatten(zamba2.param_shapes(ARCH)):
        if path.startswith("embed") or not path.endswith(MATRIX):
            continue
        n = 1
        for dim in shape:
            n *= dim
        # a stacked leaf holds each of its layers once; the shared block runs at each call
        total += n * (kinds.count("hybrid") if path.startswith("shared/") else 1)
    assert zamba2_costs.matmul_params_per_token(ARCH) == total == 1_749_928_960


def test_train_step_flops():
    b, s = 8, 4096
    got = zamba2_costs.train_step_flops(ARCH, b, s)
    ssd = (b, s, 64, 64, 64, 1, 256, False)
    want = (6.0 * b * s * 1_749_928_960
            + 6 * 12.0 * 128 * 32 * b * costs.kept_pairs(s, s, True, None)
            + 38 * (costs.ssd_cost(*ssd).flops + costs.ssd_bwd_cost(*ssd, False).flops))
    assert got == pytest.approx(want, rel=1e-12)
    assert 3.6e14 < got < 3.8e14  # about 370 TFLOP a step


def test_mfu_reader():
    tr = SimpleNamespace(arch=ARCH, batch=8, seq=4096, steps=3, wall_s=9.0,
                         kernels=[("k", 0.0, 1.0)])
    want = 100.0 * 3 * zamba2_costs.train_step_flops(ARCH, 8, 4096) / (costs.BF16_FLOPS * 9.0)
    assert harness.read_metric("mfu.zamba2", tr) == pytest.approx(want)
    tr.kernels = []
    assert harness.read_metric("mfu.zamba2", tr) is None


@pytest.mark.parametrize("metric, names", [("mamba_ms.zamba2", ("mamba", "mamba.bwd")),
                                           ("shared_ms.zamba2", ("shared", "shared.bwd"))])
def test_span_readers(metric, names):
    tops = [_span(n, i, 300.0 * (i + 1)) for i, n in enumerate(names)]
    assert harness.read_metric(metric, _Trace(tops)) == pytest.approx(0.9 / 2)  # 2 steps
    assert harness.read_metric(metric, _Trace(tops, kernels=())) is None
    assert harness.read_metric(metric, _Trace([_span("ce", 0, 10.0)])) is None


def test_ssd_roofline_reader():
    fwd = costs.ssd_cost(8, 4096, 64, 64, 64, 1, 256, False)
    bwd = costs.ssd_bwd_cost(8, 4096, 64, 64, 64, 1, 256, False, False)
    tops = [_span("pb.ssd", 1, 2000.0), _span("pb.ssd.bwd", 2, 6000.0)]  # each kernel once
    tr = _Trace(tops, steps=1)
    tr.records = SimpleNamespace(costs={"pb.ssd": [fwd, bwd]})
    want = 100.0 * (costs.roofline_s(fwd) + costs.roofline_s(bwd)) / 8e-3
    assert harness.read_metric("ssd_roofline.zamba2", tr) == pytest.approx(want)
    tr.records = SimpleNamespace(costs={})
    assert harness.read_metric("ssd_roofline.zamba2", tr) is None
