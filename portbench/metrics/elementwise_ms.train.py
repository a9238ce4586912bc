"""elementwise_ms.train (ms): device ms a step in PyTorch's own
elementwise, reduce, copy, sort and index kernels (portbench/trace.py's
grouping by kernel name)."""

from portbench.trace import ELEMENTWISE_GROUPS


def read(trace):
    if not trace.kernels:
        return None
    return 1e3 * trace.group_s(ELEMENTWISE_GROUPS) / trace.steps
