"""ce_ms.train (ms): device ms a step under the program's ``ce`` and
``ce.bwd`` spans (``models/layers.py`` ``chunked_cross_entropy``): the
chunked loss both ways, its chunks' recompute included, each kernel counted
once; None where the program has no such spans."""

from portbench import program_spans


def read(trace):
    return program_spans.device_ms(trace, "ce", "ce.bwd")
