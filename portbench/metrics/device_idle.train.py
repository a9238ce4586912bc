"""device_idle.train (%): the share of the traced steps' wall time in
which no kernel, copy or fill ran on the device."""


def read(trace):
    if not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.wall_s)
