"""shared_ms.zamba2 (ms): device ms a step under the program's ``shared``
and ``shared.bwd`` spans (``models/transformer.py``): the shared block's
calls with their adapters and linears, forwards, remat's recomputes and
backward, each kernel counted once; None where the program has no such
spans."""

from portbench import program_spans


def read(trace):
    return program_spans.device_ms(trace, "shared", "shared.bwd")
