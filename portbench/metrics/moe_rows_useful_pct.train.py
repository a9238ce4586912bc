"""moe_rows_useful_pct.train (%): the share of the expert FFN's capacity
rows that hold a (token, expert) pair: 100 x the program's counters
``moe.rows_filled`` / ``moe.rows`` (``repro_torch.tracing``), counted as
``moe_dropped_pct.train``'s are; an FFN that skipped empty rows would raise
it.  None where the program has no such counters."""


def read(trace):
    if not trace.kernels:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    c = tracing.counters()
    return 100.0 * c["moe.rows_filled"] / c["moe.rows"] if c.get("moe.rows") else None
