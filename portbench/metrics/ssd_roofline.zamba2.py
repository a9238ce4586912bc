"""ssd_roofline.zamba2 (%): the SSD scan's (B4's) share of its roofline,
both ways: the least time of each call's and each backward's work by the
frozen costs that the benchmark's ``pb.ssd`` spans recorded
(portbench/costs.py), over the device time of the kernels launched under
``pb.ssd`` and ``pb.ssd.bwd``, each kernel counted once
(portbench/program_spans.py)."""

from portbench import costs, program_spans


def read(trace):
    launches = trace.records.costs.get("pb.ssd")
    ms = program_spans.device_ms(trace, "pb.ssd", "pb.ssd.bwd")
    if not launches or not ms:
        return None
    return 100.0 * sum(costs.roofline_s(c) for c in launches) / (ms * trace.steps / 1e3)
