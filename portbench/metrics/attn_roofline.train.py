"""attn_roofline.train (%): attention's share of its roofline: the least
time of each call's and each backward's work by the frozen cost of B1
(portbench/costs.py), over the device time under the ``pb.attn`` and
``pb.attn.bwd`` spans, whatever kernels run there."""


def read(trace):
    return trace.roofline("pb.attn") if trace.kernels else None
