"""Tiny cells for the CPU tests: the benchmark's own families at widths a
test run holds."""

import copy

from portbench import harness

MOE_ARCH = {
    "family": "moe", "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
    "head_dim": 16, "d_ff": 32, "vocab_size": 250, "pattern": ["moe"], "rope_theta": 10000.0,
    "norm_eps": 1e-06, "tie_embeddings": True, "mlp_type": "swiglu",
    "param_dtype": "float32", "compute_dtype": "float32",
    "moe": {"n_experts": 8, "top_k": 2, "d_ff_expert": 32, "capacity_factor": 1.25,
            "router_aux_coef": 0.01},
}
HYBRID_ARCH = {
    "family": "hybrid", "n_layers": 5, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
    "head_dim": 16, "d_ff": 128, "vocab_size": 256, "pattern": ["mamba", "mamba", "shared_attn"],
    "rope_theta": 10000.0, "norm_eps": 1e-06, "tie_embeddings": True, "mlp_type": "swiglu",
    "param_dtype": "float32", "compute_dtype": "float32",
    "ssm": {"d_state": 16, "head_dim": 16, "expand": 2, "n_groups": 1, "conv_width": 4,
            "chunk": 16},
}
MIX = {"name": "tiny", "kind": "pretrain", "batch": 4, "seq_len": 64, "zipf_exponent": 1.0,
       "distinct_batches": 4, "checked_steps": 3, "trace_steps": 2,
       "schedule": {"peak_lr": 1e-2, "warmup_steps": 2, "total_steps": 100,
                    "max_grad_norm": 1.0}}
REFERENCE = {"moe": "moe_transformer", "hybrid": "mamba2_hybrid"}


def tiny_cell(arch, dtype="float32", limits=None, **mix) -> harness.Cell:
    arch = dict(copy.deepcopy(arch), param_dtype=dtype, compute_dtype=dtype)
    config = {"name": f"tiny-{arch['family']}", "reference": REFERENCE[arch["family"]],
              "arch": arch}
    limit = {k: {"limit": v} for k, v in (limits or {}).items()}
    return harness.Cell(name=config["name"], chips=1, config=config, mix=dict(MIX, **mix),
                        limits=limit, end_to_end=[], per_layer=[])

