"""Device time under the program's own spans (``repro_torch.tracing``),
each kernel counted once.

``Trace.span_device_s`` sums each outermost span's ``device_time_total``.
torch.profiler attaches a kernel both to the op that launched it and to a
CUPTI record nested in that op with the same correlation id ("Command
Buffer Full", "Lazy Function Loading"), and that total then counts it
twice, the more the further the host runs ahead of the device.  Here each
event id's kernels count once."""

from __future__ import annotations

from typing import List, Optional


def _ancestors(e):
    p = e.cpu_parent
    while p is not None:
        yield p
        p = p.cpu_parent


def outermost(trace, name: str) -> List:
    """The host events called ``name`` inside no other event of that name."""
    return [e for e in trace.cpu
            if e.name == name and not any(a.name == name for a in _ancestors(e))]


def device_ms(trace, *names: str) -> Optional[float]:
    """Device ms a step of the kernels launched inside the outermost spans
    called ``names``, each kernel counted once: of the events that share an
    id, the first met from the top.  None on a trace without kernels or
    where the program has no span of one of the names."""
    if not trace.kernels:
        return None
    todo = []
    for name in names:
        tops = outermost(trace, name)
        if not tops:
            return None
        todo.extend(tops)
    seen, total = set(), 0.0
    while todo:
        e = todo.pop()
        if e.kernels and e.id not in seen:
            seen.add(e.id)
            total += sum(float(k.duration) for k in e.kernels)
        todo.extend(e.cpu_children)
    return total / 1e3 / trace.steps
