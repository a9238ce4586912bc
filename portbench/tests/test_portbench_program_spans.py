"""The per-layer metrics that read the program's own spans and counters
(``repro_torch.tracing``): ``forward_ms``, ``backward_ms``, ``recompute_ms``,
``moe_ms``, ``ce_ms``, ``moe_dropped_pct`` and ``moe_rows_useful_pct``.

On the CPU: a traced tiny run holds every span they read, each reader
turns spans and counters into its number, counting a kernel once where the
profiler attaches it to an op and to a record nested in it, and reads
nothing from a trace without kernels or a program without the spans.  On
the card: a traced tiny MoE run reads each as a positive number, and the
step's split adds up to the device's busy time."""

from types import SimpleNamespace

import pytest
import torch

from portbench import harness, program_spans
from portbench.tests.tiny import MOE_ARCH, tiny_cell
from repro_torch import tracing

SPAN_METRICS = {"forward_ms.train": ("step.forward",), "backward_ms.train": ("step.backward",),
                "recompute_ms.train": ("recompute",), "moe_ms.train": ("moe", "moe.bwd"),
                "ce_ms.train": ("ce", "ce.bwd")}
COUNTER_METRICS = ("moe_dropped_pct.train", "moe_rows_useful_pct.train")
WIDE = {"d_model": 256, "n_heads": 4, "n_kv_heads": 2, "head_dim": 64}


def _event(name, eid, kernel_us=(), children=()):
    e = SimpleNamespace(name=name, id=eid, cpu_parent=None, cpu_children=list(children),
                        kernels=[SimpleNamespace(duration=d) for d in kernel_us])
    for c in children:
        c.cpu_parent = e
    return e


def _span(name, eid, us):
    """A span over one op of ``us`` device us, which the profiler also
    attaches to a record nested in the op with the op's id."""
    nested = _event("Command Buffer Full", eid, [us])
    return _event(name, 1000 + eid, children=[_event("aten::mm", eid, [us], [nested])])


def _all(events):
    for e in events:
        yield e
        yield from _all(e.cpu_children)


class _Trace:
    """Stands in for ``portbench.trace.Trace``: the host events of ``tops``."""

    def __init__(self, tops, steps=2, kernels=(("k", 0.0, 1.0),)):
        self.cpu, self.steps, self.kernels = list(_all(tops)), steps, list(kernels)


@pytest.fixture
def counted():
    tracing.reset_counters()
    yield
    tracing.reset_counters()


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_readers(metric):
    names = SPAN_METRICS[metric]
    tops = [_span(n, i, 250.0 * (i + 1)) for i, n in enumerate(names)]
    want = 250.0 * sum(range(1, len(names) + 1)) / 1e3 / 2  # each kernel once, 2 steps
    assert harness.read_metric(metric, _Trace(tops)) == pytest.approx(want)
    assert harness.read_metric(metric, _Trace(tops, kernels=())) is None
    other = [_span("optimizer", 0, 100.0)]
    assert harness.read_metric(metric, _Trace(other)) is None  # no program spans


def test_device_ms_counts_each_kernel_once():
    inner = _span("moe", 1, 300.0)  # a span inside one of its own name counts once
    tops = [_event("moe", 10, children=[_span("aten::add", 2, 100.0), inner]),
            _span("moe.bwd", 3, 40.0)]
    tr = _Trace(tops, steps=1)
    assert [e.id for e in program_spans.outermost(tr, "moe")] == [10]
    assert program_spans.device_ms(tr, "moe") == pytest.approx(0.4)
    assert program_spans.device_ms(tr, "moe", "moe.bwd") == pytest.approx(0.44)
    assert program_spans.device_ms(tr, "moe", "ce") is None


def test_a_traced_run_holds_every_span(counted):
    cell = tiny_cell(MOE_ARCH)
    tr = harness.traced(cell, harness.build_program(cell, 1, "cpu"), 0, "cpu")
    for names in SPAN_METRICS.values():
        for name in names:
            assert tr.span_device_s(name) is not None, name
    assert not tr.kernels  # no device here: every reader reads nothing
    for metric in [*SPAN_METRICS, *COUNTER_METRICS]:
        assert harness.read_metric(metric, tr) is None, metric
    c = tracing.counters()
    tokens = cell.mix["batch"] * cell.mix["seq_len"]
    assert c["moe.routed"] == cell.mix["trace_steps"] * MOE_ARCH["n_layers"] * tokens * 2


def test_counter_readers(counted):
    tr = _Trace({})
    for metric in COUNTER_METRICS:
        assert harness.read_metric(metric, tr) is None  # nothing counted
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tracing.count({"moe.routed": 400, "moe.dropped": torch.tensor(100), "moe.rows": 320,
                       "moe.rows_filled": torch.tensor(300)})
    assert harness.read_metric("moe_dropped_pct.train", tr) == 25.0
    assert harness.read_metric("moe_rows_useful_pct.train", tr) == pytest.approx(93.75)
    assert harness.read_metric("moe_dropped_pct.train", _Trace({}, kernels=())) is None


@pytest.mark.gpu
def test_program_metrics_on_the_card(counted):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = tiny_cell(dict(MOE_ARCH, **WIDE), "bfloat16", seq_len=512)
    prog = harness.build_program(cell, 1, "cuda")
    harness.checked_steps(cell, prog, 1)
    tracing.reset_counters()
    tr = harness.traced(cell, prog, 3, "cuda")
    got = {m: harness.read_metric(m, tr) for m in [*SPAN_METRICS, *COUNTER_METRICS]}
    assert all(v is not None and v > 0 for v in got.values()), got
    assert got["moe_ms.train"] >= harness.read_metric("moe_layer_ms.train", tr)
    assert got["recompute_ms.train"] < got["backward_ms.train"]
    assert got["moe_dropped_pct.train"] < 100 and got["moe_rows_useful_pct.train"] < 100
    split = got["forward_ms.train"] + got["backward_ms.train"]
    split += program_spans.device_ms(tr, "optimizer")  # each kernel once, as the readers
    assert split == pytest.approx(1e3 * tr.busy_s / tr.steps, rel=0.05)
