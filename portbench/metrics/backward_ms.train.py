"""backward_ms.train (ms): device ms a step under the program's
``step.backward`` span, opened and closed on the thread that runs the
backward: every kernel the backward launches, remat's recompute included,
each counted once; None where the program has no such span."""

from portbench import program_spans


def read(trace):
    return program_spans.device_ms(trace, "step.backward")
