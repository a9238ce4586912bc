"""Plain fp32 reference of a Mamba2 decoder with one shared attention block
(zamba2-1.2b as the program runs it).

A ``mamba`` layer: x += out_proj(RMSNorm_gate(y * SiLU(z))), where from
u = RMSNorm(x): z, x_in, bc, dt_raw are its four projections; x_in and bc
pass a depthwise causal convolution (width W, with bias) and a SiLU;
dt = softplus(dt_raw + dt_bias); y = SSD(x_in * dt, dt * -exp(A_log), B,
C) + D x_in, the state-space scan computed in chunks (:func:`ssd`).  A
``shared_attn`` layer applies the one ``shared`` parameter set: x +=
attention(RMSNorm(x)); x += SwiGLU(RMSNorm(x)).  Loss: mean next-token
cross-entropy over the tied embedding.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import (Numerics, attention_block, attention_shapes, cross_entropy, embed,
                     lm_shapes, norm_shape, rms_norm, run_layers, swiglu)


def dims(arch: Dict) -> Dict[str, int]:
    s = arch["ssm"]
    d_in = s["expand"] * arch["d_model"]
    return dict(d_in=d_in, heads=d_in // s["head_dim"], p=s["head_dim"], n=s["d_state"],
                g=s["n_groups"], w=s["conv_width"], chunk=s["chunk"])


def param_shapes(arch: Dict) -> Dict:
    """{path: (shape, dtype name)} of the program's parameter tree."""
    d, bf, k = arch["d_model"], arch["param_dtype"], dims(arch)
    gn2 = 2 * k["g"] * k["n"]

    def block(kind: str, lead: Tuple[int, ...]) -> Dict:
        if kind == "shared_attn":
            f = arch["d_ff"]
            return {
                "ln1": norm_shape(arch, lead),
                "attn": attention_shapes(arch, lead),
                "ln2": norm_shape(arch, lead),
                "mlp": {"gate": {"w": ((*lead, d, f), bf)}, "up": {"w": ((*lead, d, f), bf)},
                        "down": {"w": ((*lead, f, d), bf)}},
            }
        if kind != "mamba":
            raise ValueError(f"mamba2_hybrid has no {kind!r} block")
        h, d_in = k["heads"], k["d_in"]
        return {
            "ln1": norm_shape(arch, lead),
            "mamba": {
                "z_proj": {"w": ((*lead, d, d_in), bf)},
                "x_proj": {"w": ((*lead, d, d_in), bf)},
                "bc_proj": {"w": ((*lead, d, gn2), bf)},
                "dt_proj": {"w": ((*lead, d, h), bf)},
                "conv_x_w": ((*lead, k["w"], d_in), bf),
                "conv_x_b": ((*lead, d_in), bf),
                "conv_bc_w": ((*lead, k["w"], gn2), bf),
                "conv_bc_b": ((*lead, gn2), bf),
                "A_log": ((*lead, h), "float32"),
                "D": ((*lead, h), "float32"),
                "dt_bias": ((*lead, h), "float32"),
                "gate_norm": {"scale": ((*lead, d_in), bf)},
                "out_proj": {"w": ((*lead, d_in, d), bf)},
            },
        }

    return lm_shapes(arch, block)


def ssd(x: torch.Tensor, dA: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
        chunk: int) -> torch.Tensor:
    """y of the scan h_t = exp(dA_t) h_{t-1} + x_t B_t^T, y_t = h_t C_t from
    h = 0, for x [b, s, H, P], dA [b, s, H], B and C [b, s, G, N] (head h
    reads group h // (H / G)), in chunks of ``chunk``: within a chunk the
    quadratic form (C B^T o L) x with L_ij = exp(cum_i - cum_j) for i >= j,
    across chunks the carried state."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    c, q = s // chunk, chunk
    xc = x.reshape(b, c, q, h, p)
    Bh = B.repeat_interleave(h // g, dim=2).reshape(b, c, q, h, n)
    Ch = C.repeat_interleave(h // g, dim=2).reshape(b, c, q, h, n)
    cum = torch.cumsum(dA.reshape(b, c, q, h), dim=2).permute(0, 1, 3, 2)  # [b, c, H, Q]
    diff = cum[..., :, None] - cum[..., None, :]
    low = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp(diff.masked_fill(~low, float("-inf")))  # [b, c, H, Q, Q]
    scores = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh) * L
    y = torch.einsum("bchqk,bckhp->bcqhp", scores, xc)
    decay = torch.exp(cum[..., -1:] - cum)  # [b, c, H, Q]
    own = torch.einsum("bcqhn,bchq,bcqhp->bchpn", Bh, decay, xc)
    state = x.new_zeros(b, h, p, n)
    carried = []
    for i in range(c):
        carried.append(state)
        state = state * torch.exp(cum[:, i, :, -1])[..., None, None] + own[:, i]
    carried = torch.stack(carried, dim=1)  # [b, c, H, P, N]
    y = y + torch.einsum("bcqhn,bchpn,bchq->bcqhp", Ch, carried, torch.exp(cum))
    return y.reshape(b, s, h, p)


def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution over the sequence of x [b, s, ch] with
    taps w [W, ch]: out_t = sum_i x_{t - W + 1 + i} w_i + bias."""
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    return sum(pad[:, i:i + s] * w[i] for i in range(width)) + bias


def mamba(p: Dict, u: torch.Tensor, arch: Dict, num: Numerics) -> torch.Tensor:
    k = dims(arch)
    b, s, _ = u.shape
    z = num.mm(u, p["z_proj"]["w"])
    x = F.silu(causal_conv(num.mm(u, p["x_proj"]["w"]), p["conv_x_w"], p["conv_x_b"]))
    bc = F.silu(causal_conv(num.mm(u, p["bc_proj"]["w"]), p["conv_bc_w"], p["conv_bc_b"]))
    x = x.reshape(b, s, k["heads"], k["p"])
    B = bc[..., : k["g"] * k["n"]].reshape(b, s, k["g"], k["n"])
    C = bc[..., k["g"] * k["n"]:].reshape(b, s, k["g"], k["n"])
    dt = F.softplus(num.mm(u, p["dt_proj"]["w"]) + p["dt_bias"])
    y = ssd(x * dt[..., None], dt * -torch.exp(p["A_log"]), B, C, min(k["chunk"], s))
    y = (y + p["D"][:, None] * x).reshape(b, s, k["d_in"])
    gated = rms_norm(y * F.silu(z), p["gate_norm"]["scale"], arch["norm_eps"])
    return num.mm(gated, p["out_proj"]["w"])


def loss_fn(params: Dict, batch: Dict, arch: Dict, num: Numerics) -> torch.Tensor:
    eps = arch["norm_eps"]

    def block(kind, p, x):
        if kind == "mamba":
            return x + mamba(p["mamba"], rms_norm(x, p["ln1"]["scale"], eps), arch, num), \
                x.new_zeros(())
        x = x + attention_block(p["attn"], rms_norm(x, p["ln1"]["scale"], eps), arch, num)
        return x + swiglu(rms_norm(x, p["ln2"]["scale"], eps), p["mlp"], num), x.new_zeros(())

    table = num.leaf(params, "embed/table")
    x = embed(batch["tokens"], table, arch["d_model"])
    x, _ = run_layers(params, x, arch, block, num)
    x = rms_norm(x, num.leaf(params, "final_norm/scale"), eps)
    return cross_entropy(x, table, batch["labels"], arch["vocab_size"], num)
