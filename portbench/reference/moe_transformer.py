"""Plain fp32 reference of a decoder of attention + MoE blocks
(granite-moe-3b-a800m as the program runs it).

Each layer: x += attention(RMSNorm(x)); x += MoE(RMSNorm(x)).  The MoE
layer routes each token to its top-k experts by an fp32 softmax router,
renormalises the k gates, and takes each expert's pairs in token order up
to its capacity ceil8(capacity_factor x tokens x k / experts) (at least
8); the pairs past it are dropped.  Each kept pair adds gate x
SwiGLU_e(x).  The Switch aux loss, E x sum_e(top-1 share_e x mean prob_e),
is summed over the layers and weighed by ``router_aux_coef``.  Loss: mean
next-token cross-entropy over the tied embedding, plus that.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import (Numerics, attention_shapes, attention_block, cross_entropy, embed,
                     lm_shapes, norm_shape, rms_norm, run_layers)


def param_shapes(arch: Dict) -> Dict:
    """{path: (shape, dtype name)} of the program's parameter tree."""
    m, d, bf = arch["moe"], arch["d_model"], arch["param_dtype"]
    e, f = m["n_experts"], m["d_ff_expert"]

    def block(kind: str, lead: Tuple[int, ...]) -> Dict:
        if kind != "moe":
            raise ValueError(f"moe_transformer has no {kind!r} block")
        return {
            "ln1": norm_shape(arch, lead),
            "attn": attention_shapes(arch, lead),
            "ln2": norm_shape(arch, lead),
            "moe": {
                "router": {"w": ((*lead, d, e), "float32")},
                "gate": ((*lead, e, d, f), bf),
                "up": ((*lead, e, d, f), bf),
                "down": ((*lead, e, f, d), bf),
            },
        }

    return lm_shapes(arch, block)


def capacity(n_tokens: int, m: Dict) -> int:
    c = int(m["capacity_factor"] * n_tokens * m["top_k"] / m["n_experts"])
    return max(8, -(-c // 8) * 8)


def moe(p: Dict, x: torch.Tensor, m: Dict, num: Numerics) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, d] -> (y [T, d], aux)."""
    t = x.shape[0]
    e, k, cap = m["n_experts"], m["top_k"], capacity(x.shape[0], m)
    probs = torch.softmax(num.mm(x, p["router"]["w"]), dim=-1)
    gates, experts = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    share = F.one_hot(experts[:, 0], e).to(x.dtype).mean(0)
    aux = e * (share * probs.mean(0)).sum()
    flat = experts.reshape(-1)  # pair t * k + j
    order = torch.argsort(flat, stable=True)  # by expert, each expert's pairs in token order
    counts = torch.bincount(flat, minlength=e)
    num.count("moe_pairs", flat.numel())
    num.count("moe_dropped", (counts - cap).clamp_min(0).sum())
    token = torch.arange(t, device=x.device).repeat_interleave(k)
    gate = gates.reshape(-1)
    rows, outs, start = [], [], 0
    for w_gate, w_up, w_down, n in zip(p["gate"].unbind(0), p["up"].unbind(0),
                                       p["down"].unbind(0), counts.tolist()):
        sel = order[start:start + min(n, cap)]  # the first ``cap`` pairs kept, the rest dropped
        start += n
        h = x[token[sel]]
        out = num.mm(F.silu(num.mm(h, w_gate)) * num.mm(h, w_up), w_down)
        rows.append(token[sel])
        outs.append(out * gate[sel, None])
    return torch.zeros_like(x).index_add(0, torch.cat(rows), torch.cat(outs)), aux


def loss_fn(params: Dict, batch: Dict, arch: Dict, num: Numerics) -> torch.Tensor:
    eps, m = arch["norm_eps"], arch["moe"]

    def block(kind, p, x):
        x = x + attention_block(p["attn"], rms_norm(x, p["ln1"]["scale"], eps), arch, num)
        b, s, d = x.shape
        y, aux = moe(p["moe"], rms_norm(x, p["ln2"]["scale"], eps).reshape(b * s, d), m, num)
        return x + y.reshape(b, s, d), aux

    table = num.leaf(params, "embed/table")
    x = embed(batch["tokens"], table, arch["d_model"])
    x, aux = run_layers(params, x, arch, block, num)
    x = rms_norm(x, num.leaf(params, "final_norm/scale"), eps)
    ce = cross_entropy(x, table, batch["labels"], arch["vocab_size"], num)
    return ce + m["router_aux_coef"] * aux
