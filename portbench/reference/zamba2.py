"""Plain fp32 reference of the published Zamba2-1.2B (Zyphra; transformers'
``Zamba2ForCausalLM`` with ``use_mem_rope`` and
``use_shared_attention_adapter``, one memory block).

e is the embedding output, x the residual stream.  A ``mamba`` layer: x +=
Mamba2(RMSNorm(x)), the mixer of :mod:`.mamba2_hybrid`.  A ``hybrid``
layer, call i of the one ``shared`` block: h = RMSNorm([x ; e]) (2 d
wide); q, k, v = W h + B_i A_i h each, with call i's rank-r adapters;
RoPE over the whole head on q and k; causal softmax attention with scores
scaled by (D/2)^-0.5; o back to d; g = RMSNorm(o), no residual inside the
block; [a ; b] = W_gu g + B_i A_i g; T = down(GELU(a) * b), GELU exact;
then x += Mamba2(RMSNorm(x + L_i T)), L_i call i's own d x d linear.  Loss:
mean next-token cross-entropy over the tied embedding.

Departures from the published model, as the program has them: the
embedding is scaled by sqrt(d) (e included), RMSNorm multiplies by (1 +
scale), and dt is not clamped below at ``time_step_min``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import (Numerics, causal_attention, cross_entropy, embed, lm_shapes, norm_shape,
                     rms_norm, rope, run_layers)
from .mamba2_hybrid import dims, mamba as mixer


def _lora(d_in: int, d_out: int, r: int, bf: str, lead: Tuple[int, ...]) -> Dict:
    return {"down": {"w": ((*lead, d_in, r), bf)}, "up": {"w": ((*lead, r, d_out), bf)}}


def param_shapes(arch: Dict) -> Dict:
    """{path: (shape, dtype name)} of the program's parameter tree."""
    d, bf, k = arch["d_model"], arch["param_dtype"], dims(arch)
    hq, hkv = arch["n_heads"] * arch["head_dim"], arch["n_kv_heads"] * arch["head_dim"]
    f, r = arch["d_ff"], arch["adapter_rank"]
    gn2, h, d_in = 2 * k["g"] * k["n"], k["heads"], k["d_in"]

    def block(kind: str, lead: Tuple[int, ...]) -> Dict:
        out = {
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
        if kind == "hybrid":
            out["linear"] = {"w": ((*lead, d, d), bf)}
            out["lora"] = {"q": _lora(2 * d, hq, r, bf, lead), "k": _lora(2 * d, hkv, r, bf, lead),
                           "v": _lora(2 * d, hkv, r, bf, lead),
                           "gate_up": _lora(d, 2 * f, r, bf, lead)}
        elif kind != "mamba":
            raise ValueError(f"zamba2 has no {kind!r} block")
        return out

    tree = lm_shapes(arch, block)
    tree["shared"] = {
        "ln1": {"scale": ((2 * d,), bf)},
        "attn": {"q": {"w": ((2 * d, hq), bf)}, "k": {"w": ((2 * d, hkv), bf)},
                 "v": {"w": ((2 * d, hkv), bf)}, "o": {"w": ((hq, d), bf)}},
        "ln2": norm_shape(arch),
        "mlp": {"gate_up": {"w": ((d, 2 * f), bf)}, "down": {"w": ((f, d), bf)}},
    }
    return tree


def lora_mm(h: torch.Tensor, w: torch.Tensor, lora: Dict, num: Numerics) -> torch.Tensor:
    return num.mm(h, w) + num.mm(num.mm(h, lora["down"]["w"]), lora["up"]["w"])


def shared_block(p: Dict, lora: Dict, x: torch.Tensor, e: torch.Tensor, arch: Dict,
                 num: Numerics) -> torch.Tensor:
    """T of one call: the shared block over [x ; e] with its adapters."""
    b, s, _ = x.shape
    hd, eps = arch["head_dim"], arch["norm_eps"]
    h = rms_norm(torch.cat([x, e], dim=-1), p["ln1"]["scale"], eps)
    a = p["attn"]
    q = rope(lora_mm(h, a["q"]["w"], lora["q"], num).reshape(b, s, -1, hd), arch["rope_theta"])
    k = rope(lora_mm(h, a["k"]["w"], lora["k"], num).reshape(b, s, -1, hd), arch["rope_theta"])
    v = lora_mm(h, a["v"]["w"], lora["v"], num).reshape(b, s, -1, hd)
    # causal_attention scales by D^-0.5: q x sqrt(2) gives (D/2)^-0.5
    o = num.mm(causal_attention(q * math.sqrt(2.0), k, v, num).reshape(b, s, -1), a["o"]["w"])
    g = rms_norm(o, p["ln2"]["scale"], eps)
    gate, up = lora_mm(g, p["mlp"]["gate_up"]["w"], lora["gate_up"], num).chunk(2, dim=-1)
    return num.mm(F.gelu(gate) * up, p["mlp"]["down"]["w"])


def hidden(params: Dict, tokens: torch.Tensor, arch: Dict, num: Numerics) -> torch.Tensor:
    """The final-norm hidden states [B, S, d] of ``tokens``."""
    eps = arch["norm_eps"]
    e = embed(tokens, num.leaf(params, "embed/table"), arch["d_model"])
    shared = num.leaf(params, "shared")

    def block(kind, p, x):
        u = x
        if kind == "hybrid":
            t = shared_block(shared, p["lora"], x, e, arch, num)
            u = x + num.mm(t, p["linear"]["w"])
        return x + mixer(p["mamba"], rms_norm(u, p["ln1"]["scale"], eps), arch, num), \
            x.new_zeros(())

    x, _ = run_layers(params, e, arch, block, num)
    return rms_norm(x, num.leaf(params, "final_norm/scale"), eps)


def loss_fn(params: Dict, batch: Dict, arch: Dict, num: Numerics) -> torch.Tensor:
    x = hidden(params, batch["tokens"], arch, num)
    table = num.leaf(params, "embed/table")
    return cross_entropy(x, table, batch["labels"], arch["vocab_size"], num)
