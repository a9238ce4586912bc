"""mfu.zamba2 (%): the model FLOPs of the traced steps of the published
Zamba2 (portbench/zamba2_costs.py: 6 x tokens x the matmul weights a token
passes through, the shared block's at each call; causal attention at each
hybrid call; each Mamba2 layer's SSD both ways; remat's recompute not
counted) over 989 TFLOP/s x their wall time."""

from portbench import costs, zamba2_costs


def read(trace):
    if not trace.kernels:
        return None
    flops = zamba2_costs.train_step_flops(trace.arch, trace.batch, trace.seq) * trace.steps
    return 100.0 * flops / (costs.BF16_FLOPS * trace.wall_s)
