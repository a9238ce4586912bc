"""Model FLOPs of a training step of the published Zamba2 (the ``hybrid``
kind, ``reference/zamba2.py``): ``costs.train_step_flops`` counts a
``shared_attn`` block, not the hybrid layer's 2 d-wide attention, adapters
and linear, so the count of this family lives here."""

from __future__ import annotations

from typing import Dict

from . import costs
from .reference.common import layer_kinds


def matmul_params_per_token(arch: Dict) -> int:
    """Weights a token multiplies through in the forward pass: every Mamba2
    layer's projections and depthwise convolutions; at each hybrid call the
    shared block's q, k, v (2 d wide), o, gate-up and down, the call's
    adapters (down and up) and its linear; the unembedding over the real
    vocabulary.  Not the embedding lookup, the norms or the biases."""
    d, f, r = arch["d_model"], arch["d_ff"], arch["adapter_rank"]
    hq, hkv = arch["n_heads"] * arch["head_dim"], arch["n_kv_heads"] * arch["head_dim"]
    s = arch["ssm"]
    d_in = s["expand"] * d
    gn2 = 2 * s["n_groups"] * s["d_state"]
    mamba = (d * (2 * d_in + gn2 + d_in // s["head_dim"]) + d_in * d
             + s["conv_width"] * (d_in + gn2))
    shared = 2 * d * (hq + 2 * hkv) + hq * d + 3 * d * f
    own = r * (2 * d + hq) + 2 * r * (2 * d + hkv) + r * (d + 2 * f) + d * d
    kinds = layer_kinds(arch)
    return len(kinds) * mamba + kinds.count("hybrid") * (shared + own) + d * arch["vocab_size"]


def train_step_flops(arch: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step on ``batch`` packed sequences of
    ``seq`` tokens: 6 x tokens x :func:`matmul_params_per_token`; at each
    hybrid call causal attention's QK^T and PV, 12 x D x query heads x kept
    pairs (forward and backward); each Mamba2 layer's chunked SSD forward
    and backward as ``costs.ssd_cost`` / ``costs.ssd_bwd_cost`` count them.
    Remat's recompute is not counted."""
    flops = 6.0 * batch * seq * matmul_params_per_token(arch)
    pairs = batch * costs.kept_pairs(seq, seq, True, None)
    s = arch["ssm"]
    h = s["expand"] * arch["d_model"] // s["head_dim"]
    ssd = (batch, seq, h, s["head_dim"], s["d_state"], s["n_groups"], min(s["chunk"], seq), False)
    kinds = layer_kinds(arch)
    flops += kinds.count("hybrid") * 12.0 * arch["head_dim"] * arch["n_heads"] * pairs
    flops += len(kinds) * (costs.ssd_cost(*ssd).flops + costs.ssd_bwd_cost(*ssd, False).flops)
    return flops
