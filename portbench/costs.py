"""The yardstick's arithmetic: peaks of the card, the work of one kernel
launch, and the model FLOPs of a training step.

The kernel costs are frozen copies of the port's ``cost`` functions
(``kernels/flash_attention/ops.py`` and ``kernels/ssd_scan/ops.py``) as they
stood when this benchmark was written, so that a later change to the
program cannot change what its kernels are measured against.
``portbench/tests/test_portbench_costs.py`` held them equal to the port's on that day.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np

from .reference.common import layer_kinds

#: NVIDIA H100 SXM 80GB data sheet, dense, no sparsity, at 700 W
BF16_FLOPS = 989e12  # bf16 tensor cores
TF32_FLOPS = 495e12  # TF32 tensor cores
FP32_FLOPS = 67e12  # fp32 on the CUDA cores
HBM_BW = 3.35e12  # bytes/s


class KernelCost(NamedTuple):
    """One launch's work: the bytes it must move (each input read once,
    each output written once), the operations it needs (``flops``), the
    operations it executes (``ops``: 3 x ``flops`` for 3xTF32) and the peak
    rate of the units that run them."""

    bytes: int
    flops: int
    ops: int
    peak: float


def roofline_s(cost: KernelCost) -> float:
    """The least time the card can take for ``cost``: its operations at
    their units' peak or its bytes at the HBM bandwidth, whichever is
    longer."""
    return max(cost.ops / cost.peak, cost.bytes / HBM_BW)


# ------------------------------------------------------------------- B1
def kept_pairs(sq: int, sk: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs that the mask keeps in one (batch, head) of an
    attention of sq queries at positions 0.. over sk keys at 0..."""
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(q, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_cost(b: int, sq: int, sk: int, hq: int, hkv: int, d: int, causal: bool, window,
               item: int = 2, backward: bool = False) -> KernelCost:
    """One attention launch on [b, sq, hq, d] queries over [b, sk, hkv, d]
    keys and values of ``item`` bytes an element.  Forward: q, k, v in, out
    and the fp32 lse out; 4 x pairs x D products.  Backward: q, k, v, out,
    dout and lse in, dq, dk, dv out; 10 x pairs x D products.  bf16
    products at the bf16 tensor-core peak, fp32 ones at the fp32 CUDA-core
    peak."""
    pairs = b * hq * kept_pairs(sq, sk, causal, window)
    io = (2 * b * sq * hq * d + 2 * b * sk * hkv * d) * item
    lse_bytes = b * hq * sq * 4
    flops = (10 if backward else 4) * pairs * d
    peak = BF16_FLOPS if item == 2 else FP32_FLOPS
    return KernelCost((2 * io if backward else io) + lse_bytes, flops, flops, peak)


# ------------------------------------------------------------------- B4
def ssd_cost(b: int, s: int, h: int, p: int, n: int, g: int, q: int, init: bool,
             item: int = 4) -> KernelCost:
    """One chunked-SSD forward: C B^T once per (b, chunk, group) and (L o S)
    X per (b, h, chunk), both on the lower triangle (Q(Q+1)/2 pairs); per
    (b, h, chunk) the state term C state^T (none in the first chunk without
    an initial state) and the state update, 2QPN each.  Bytes: x in and y
    out, dA, B and C in their group layout, the final (and initial) state.
    fp32 products as 3xTF32 at the TF32 tensor-core peak."""
    chunks, tri = s // q, q * (q + 1) // 2
    flops = (b * chunks * g * 2 * n * tri + b * h * chunks * 2 * p * tri
             + b * h * (2 * chunks - (0 if init else 1)) * 2 * q * p * n)
    n_bytes = (2 * b * s * h * p * item
               + b * s * h * 4
               + 2 * b * s * g * n * item
               + b * h * p * n * 4 * (2 if init else 1))
    return KernelCost(n_bytes, flops, 3 * flops, TF32_FLOPS)


def ssd_bwd_cost(b: int, s: int, h: int, p: int, n: int, g: int, q: int, init: bool,
                 dfinal: bool) -> KernelCost:
    """One chunked-SSD backward (fp32), per (b, h, chunk): four products on
    the lower triangle (dy x^T and S^T dy over P, dM^T C and dM B over N) and
    four Q x P x N state products, none in the first chunk without an
    initial state and none in the last without a final-state gradient.
    Bytes: x, dy in, dx out; cum in, d_dA out; B, C in, dB, dC out; C B^T
    and the carried states in; the initial state's and dfinal's."""
    chunks, tri = s // q, q * (q + 1) // 2
    flops = (b * h * chunks * 2 * tri * (2 * p + 2 * n)
             + b * h * 2 * q * p * n * 2 * ((chunks - (0 if init else 1))
                                            + (chunks - (0 if dfinal else 1))))
    n_bytes = 4 * (3 * b * s * h * p
                   + 2 * b * s * h
                   + 4 * b * s * g * n
                   + b * chunks * g * q * q
                   + b * chunks * h * p * n
                   + b * h * p * n * ((1 if init else 0) + (1 if dfinal else 0)))
    return KernelCost(n_bytes, flops, 3 * flops, TF32_FLOPS)


# ---------------------------------------------------------- model FLOPs
def matmul_params_per_token(arch: Dict) -> int:
    """Weights a token multiplies through in the forward pass: every
    projection, the experts it is routed to (top-k of them) and its
    router, the depthwise convolutions, and the unembedding over the real
    vocabulary.  Not the embedding lookup, the norms or the biases."""
    d, hd = arch["d_model"], arch["head_dim"]
    attn = d * arch["n_heads"] * hd * 2 + 2 * d * arch["n_kv_heads"] * hd
    total = d * arch["vocab_size"]
    for kind in layer_kinds(arch):
        if kind == "mamba":
            s = arch["ssm"]
            d_in = s["expand"] * d
            nh = d_in // s["head_dim"]
            gn2 = 2 * s["n_groups"] * s["d_state"]
            total += d * (2 * d_in + gn2 + nh) + d_in * d + s["conv_width"] * (d_in + gn2)
        elif kind in ("moe", "swa_moe"):
            m = arch["moe"]
            total += attn + d * m["n_experts"] + m["top_k"] * 3 * d * m["d_ff_expert"]
        else:
            total += attn + 3 * d * arch["d_ff"]
    return total


def train_step_flops(arch: Dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step on ``batch`` packed sequences of
    ``seq`` tokens: 6 x tokens x the weights of
    :func:`matmul_params_per_token`; causal attention's QK^T and PV, 12 x D
    x query heads x kept pairs a layer (forward and backward); the chunked
    SSD's forward and backward products as the kernel costs count them.
    Remat's recompute is not counted."""
    tokens = batch * seq
    flops = 6.0 * tokens * matmul_params_per_token(arch)
    pairs = batch * kept_pairs(seq, seq, True, None)
    for kind in layer_kinds(arch):
        if kind == "mamba":
            s = arch["ssm"]
            h = s["expand"] * arch["d_model"] // s["head_dim"]
            args = (batch, seq, h, s["head_dim"], s["d_state"], s["n_groups"],
                    min(s["chunk"], seq), False)
            flops += ssd_cost(*args).flops + ssd_bwd_cost(*args, False).flops
        else:
            flops += 12.0 * arch["head_dim"] * arch["n_heads"] * pairs
    return flops
