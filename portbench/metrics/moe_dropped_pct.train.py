"""moe_dropped_pct.train (%): the share of (token, expert) pairs that the
MoE layers' capacity dropped: 100 x the program's counters ``moe.dropped``
/ ``moe.routed`` (``repro_torch.tracing``).  They count each first forward
that ran under the profiler since the process last called
``tracing.reset_counters()``: in a run of ``portbench/run.py``, the traced
window's, the only one it profiles.  None where the program has no such
counters."""


def read(trace):
    if not trace.kernels:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    c = tracing.counters()
    return 100.0 * c["moe.dropped"] / c["moe.routed"] if c.get("moe.routed") else None
