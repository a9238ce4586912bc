"""kernels_per_step.train (launches/step): device activities (kernels,
copies, fills) a traced step."""


def read(trace):
    if not trace.kernels:
        return None
    return len(trace.kernels) / trace.steps
