"""optimizer_ms.train (ms): device ms a step under the program's own
``optimizer`` profiler span (training/train_step.py: clip + AdamW)."""


def read(trace):
    t = trace.span_device_s("optimizer") if trace.kernels else None
    return None if not t else 1e3 * t / trace.steps
