"""Mixture-of-Experts MLP with top-k routing, capacity-based token dropping
and sort-based dispatch: the counterpart of ``repro.models.moe``'s local
path.

The routing math is the JAX package's: the router in fp32, softmax, top-k,
the gates renormalised, a Switch-style aux loss from the top-1 choice; each
expert takes at most ``_capacity`` tokens, in token order, and the rest of
its (token, expert) pairs are dropped.  Dispatch sorts the flattened expert
ids (a stable sort, so tokens keep their priority within an expert) and
gathers tokens into per-expert capacity buffers; no [T, E, C] one-hot is
built.  The expert FFN is three batched products over [E, C, d], which the
JAX package leaves to XLA's einsums, here to ``torch.bmm``.  ``T`` and the
capacity are Python ints taken from shapes, so nothing here waits on the
device.  In a training step the two gathers backpropagate as gathers too
(``_GatherRows``): deterministic, with no atomic or serial scatter-add.

The parameter tree is the JAX package's (``router/w`` fp32 [d, E],
``gate``/``up`` [E_pad, d, f], ``down`` [E_pad, f, d]), so checkpoints cross
over unchanged; at expert-parallel width ``ep`` the experts are padded to a
multiple of it with never-routed dummies, as there.

``moe_mlp_ep`` is the expert-parallel body (the JAX ``shard_map`` body): it
runs on one rank's tokens with that rank's experts and exchanges the
capacity buffers with ``all_to_all_single`` over the model dim's process
group; :mod:`repro_torch.distributed.moe_parallel` wraps it in
``local_map``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import _normal, dt, init_dense


def _moe(cfg: ModelConfig):
    if cfg.moe is None:
        raise ValueError(f"{cfg.name} has no MoE config")
    return cfg.moe


def padded_experts(cfg: ModelConfig, ep: int) -> int:
    """Experts rounded up to a multiple of the expert-parallel width ``ep``
    (the padding experts are never routed to)."""
    e = _moe(cfg).n_experts
    return e if e % ep == 0 else e + (ep - e % ep)


# ----------------------------------------------------------------- params
def init_moe(
    gen: torch.Generator, cfg: ModelConfig, lead: Tuple[int, ...] = (), ep: int = 1
) -> Dict:
    """One MoE layer's params (``lead`` stacks them), the experts padded to
    a multiple of the expert-parallel width ``ep``: the JAX tree at ``ep``."""
    m = _moe(cfg)
    d, f = cfg.d_model, m.d_ff_expert
    e_pad = padded_experts(cfg, ep)
    pdt = dt(cfg.param_dtype)

    def expert_mat(d_in, d_out):
        return _normal(gen, (*lead, e_pad, d_in, d_out), d_in**-0.5, pdt)

    return {
        "router": init_dense(gen, d, m.n_experts, torch.float32, lead=lead),
        "gate": expert_mat(d, f),
        "up": expert_mat(d, f),
        "down": expert_mat(f, d),
    }


# ---------------------------------------------------------- local dispatch
def _route(
    x_flat: torch.Tensor, params: Dict, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: (top-k gates renormalised [T, k], expert ids [T, k], aux)."""
    m = _moe(cfg)
    logits = x_flat.float() @ params["router"]["w"].float()  # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, m.top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style aux loss: E * sum_e (token_frac_e * prob_mass_e)
    token_frac = F.one_hot(expert_idx[:, 0], m.n_experts).float().mean(0)
    prob_mass = probs.mean(0)
    aux = m.n_experts * (token_frac * prob_mass).sum()
    return gate_vals, expert_idx, aux


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    m = _moe(cfg)
    c = int(m.capacity_factor * n_tokens * m.top_k / m.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8


def _dispatch_tables(
    expert_idx: torch.Tensor,  # [T, k]
    n_tokens: int,
    e_pad: int,
    cap: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based slot assignment.

    Returns (slot_table [e_pad*cap] int32 of token ids (n_tokens == empty),
             token_slots [T, k] int32 of slot ids (e_pad*cap == dropped))."""
    t, k = expert_idx.shape
    dev = expert_idx.device
    eflat = expert_idx.reshape(-1)  # [T*k]
    order = torch.argsort(eflat, stable=True)  # token priority within an expert
    sorted_e = eflat[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e_pad, device=dev, dtype=sorted_e.dtype))
    pos = torch.arange(t * k, device=dev) - starts[sorted_e]
    slot_sorted = torch.where(pos < cap, sorted_e * cap + pos, e_pad * cap)
    token_sorted = order // k
    # every dropped pair writes the extra last slot, which is sliced off
    slot_table = torch.full((e_pad * cap + 1,), n_tokens, dtype=torch.int32, device=dev)
    slot_table[slot_sorted] = token_sorted.to(torch.int32)
    token_slots = torch.empty(t * k, dtype=torch.int32, device=dev)
    token_slots[order] = slot_sorted.to(torch.int32)
    return slot_table[:-1], token_slots.reshape(t, k)


def _expert_ffn(expert_in: torch.Tensor, params: Dict, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU of each expert over its capacity buffer: [E, C, d] -> [E, C, d]."""
    cdt = dt(cfg.compute_dtype)
    g = torch.bmm(expert_in, params["gate"].to(cdt))
    u = torch.bmm(expert_in, params["up"].to(cdt))
    h = F.silu(g.float()).to(cdt) * u
    return torch.bmm(h, params["down"].to(cdt))


class _GatherRows(torch.autograd.Function):
    """``cat([src, zero row])[index]`` whose backward gathers too.

    ``inverse`` [R, m] lists for each of the R rows of ``src`` the positions
    of the flat output that read it, padded with ``index.numel()`` (a zero
    gradient); a row's gradient is the sum of theirs (in fp32, rounded
    once).  With ``inverse`` None, ``index`` reads each row at most once
    (the zero row aside) and the backward inverts it.  Autograd's own
    backward of the gather would scatter-add into ``src``, serially per
    distinct index, and in a dispatch the empty-slot and dropped-pair rows
    are read by thousands of positions each."""

    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.rows = src.shape[0]
        ctx.save_for_backward(index if inverse is None else inverse)
        ctx.invert = inverse is None
        return torch.cat([src, src.new_zeros((1, src.shape[1]))])[index]

    @staticmethod
    def backward(ctx, grad):
        (inverse,) = ctx.saved_tensors
        if ctx.invert:  # row -> the one position that reads it; the zero row's are dropped
            n = inverse.numel()
            inv = torch.full((ctx.rows + 1,), n, dtype=torch.int64, device=grad.device)
            inv[inverse.reshape(-1)] = torch.arange(n, device=grad.device)
            inverse = inv[:-1]
        g = grad.reshape(-1, grad.shape[-1])
        g = torch.cat([g, g.new_zeros((1, g.shape[1]))])[inverse]
        return (g.sum(dim=1) if g.dim() == 3 else g), None, None


def moe_mlp_local(
    params: Dict, x: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device MoE.  x: [B, S, d] -> ([B, S, d], aux loss scalar).

    The dispatch and the combine are gathers whose backward gathers back:
    a token's gradient from its k slots (by ``token_slots``), a slot's from
    the one (token, expert) pair that fills it."""
    b, s, d = x.shape
    t = b * s
    e_pad = params["gate"].shape[0]
    x_flat = x.reshape(t, d)
    gates, expert_idx, aux = _route(x_flat, params, cfg)
    cap = _capacity(t, cfg)
    slot_table, token_slots = _dispatch_tables(expert_idx, t, e_pad, cap)
    expert_in = _GatherRows.apply(x_flat, slot_table, token_slots).reshape(e_pad, cap, d)
    expert_out = _expert_ffn(expert_in, params, cfg)
    picked = _GatherRows.apply(expert_out.reshape(e_pad * cap, d), token_slots, None)
    y = (picked * gates[..., None].to(x.dtype)).sum(dim=1)
    return y.reshape(b, s, d), aux


# ------------------------------------------------------- expert parallelism
class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` of equal chunks along dim 0 over ``group``.
    Chunk j goes to rank j and rank j's chunk i comes back as chunk j, so
    the backward is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    moe_mlp_ep.exchanges += 1
    return out


def moe_mlp_ep(
    params: Dict, x: torch.Tensor, cfg: ModelConfig, group: Optional[dist.ProcessGroup] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel body: x is this rank's token shard [b_l, s_l, d] and
    ``params`` its experts' slice (the router whole); the experts are split
    over the ranks of ``group`` (the model dim) in rank order.  Routes and
    dispatches locally over all ``e_pad * ep`` experts, sends each rank its
    experts' capacity buffers, runs the FFN on the local experts and sends
    the results back.  Returns (y [b_l, s_l, d], this rank's aux loss); the
    caller averages aux over the ranks (the JAX body's ``pmean``)."""
    b, s, d = x.shape
    t = b * s
    ep = dist.get_world_size(group)
    e_loc = params["gate"].shape[0]
    e_glob = e_loc * ep
    x_flat = x.reshape(t, d)
    # the router is replicated: routing happens where the tokens live
    gates, expert_idx, aux = _route(x_flat, params, cfg)
    cap = _capacity(t, cfg)
    slot_table, token_slots = _dispatch_tables(expert_idx, t, e_glob, cap)
    send = _GatherRows.apply(x_flat, slot_table, token_slots).reshape(e_glob, cap, d)
    # [E_glob, C, d] -> rank j's [E_loc, C, d] from every rank: [E_loc, ep*C, d]
    recv = _AllToAll.apply(send, group).reshape(ep, e_loc, cap, d)
    recv = recv.transpose(0, 1).reshape(e_loc, ep * cap, d).contiguous()
    expert_out = _expert_ffn(recv, params, cfg)
    # the reverse exchange: [E_loc, ep*C, d] -> [E_glob, C, d]
    back = expert_out.reshape(e_loc, ep, cap, d).transpose(0, 1).contiguous()
    back = _AllToAll.apply(back, group).reshape(e_glob * cap, d)
    picked = _GatherRows.apply(back, token_slots, None)
    y = (picked * gates[..., None].to(x.dtype)).sum(dim=1)
    return y.reshape(b, s, d), aux


moe_mlp_ep.exchanges = 0  # all_to_all_single calls, forward and backward
