"""mfu.train (%): the model FLOPs of the traced steps (portbench/costs.py's
count: 6 x tokens x active weights, causal attention, the SSD's products;
remat's recompute not counted) over 989 TFLOP/s x their wall time."""

from portbench import costs


def read(trace):
    if not trace.kernels:
        return None
    flops = costs.train_step_flops(trace.arch, trace.batch, trace.seq) * trace.steps
    return 100.0 * flops / (costs.BF16_FLOPS * trace.wall_s)
