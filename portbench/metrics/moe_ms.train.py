"""moe_ms.train (ms): device ms a step under the program's ``moe`` and
``moe.bwd`` spans (``distributed/moe_parallel.py``): the whole MoE layer,
its forwards, remat's recomputes and its backward (the weights' gradients
included), each kernel counted once; None where the program has no such
spans."""

from portbench import program_spans


def read(trace):
    return program_spans.device_ms(trace, "moe", "moe.bwd")
