"""recompute_ms.train (ms): device ms a step under the program's
``recompute`` spans: remat's second forward of each checkpointed group and
CE chunk inside the backward, what remat costs, each kernel counted once;
None where the program has no such span."""

from portbench import program_spans


def read(trace):
    return program_spans.device_ms(trace, "recompute")
