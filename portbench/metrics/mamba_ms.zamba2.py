"""mamba_ms.zamba2 (ms): device ms a step under the program's ``mamba``
and ``mamba.bwd`` spans (``models/mamba2.py`` ``mamba_block``): every
Mamba2 mixer, its forwards, remat's recomputes and its backward (the
weights' gradients included), each kernel counted once; None where the
program has no such spans."""

from portbench import program_spans


def read(trace):
    return program_spans.device_ms(trace, "mamba", "mamba.bwd")
