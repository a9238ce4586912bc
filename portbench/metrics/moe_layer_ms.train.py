"""moe_layer_ms.train (ms): device ms a step under the benchmark's
``pb.moe_layer`` span around each call of ``moe_mlp_local``: the MoE
layers' forwards and remat's recomputes (not their backward)."""


def read(trace):
    t = trace.span_device_s("pb.moe_layer") if trace.kernels else None
    return None if not t else 1e3 * t / trace.steps
