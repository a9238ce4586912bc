"""forward_ms.train (ms): device ms a step under the program's
``step.forward`` span (``repro_torch.tracing``, around the train step's
``loss_fn``): the forward and the loss, each kernel counted once; None
where the program has no such span."""

from portbench import program_spans


def read(trace):
    return program_spans.device_ms(trace, "step.forward")
