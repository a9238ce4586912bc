"""AdamW: the counterpart of ``repro.optim.adamw`` (the repo's own, not
``torch.optim.AdamW``).

bf16 model params with fp32 master copies and fp32 (m, v) moments in the
optimizer state, b2 = 0.95, bias correction, and weight decay applied to the
fp32 master.  The state is a dict ``{"step", "m", "v", "master"}`` whose
trees keep the params' key paths, as the JAX package's does, so it crosses
between the packages through the checkpoint DU's ``opt/`` files.

Unlike the JAX functions, which return new trees, :func:`adamw_update` and
:func:`clip_by_global_norm` update their tensors in place (the params are
re-formed from the masters in place too), so a 1.8 B-parameter model's
state is never held twice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch

from ..checkpoint import flatten_tree, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    #: keep fp32 master copies when params are lower precision
    mixed_precision: bool = True


def tree_get(tree: Any, path: str) -> Any:
    for key in path.split("/"):
        tree = tree[key]
    return tree


def tree_leaves(tree: Any):
    return [leaf for _, leaf in flatten_tree(tree)]


def init_adamw(params: Any, cfg: AdamWConfig = AdamWConfig()) -> Dict:
    """Zero moments and fp32 masters on the params' device."""
    device = tree_leaves(params)[0].device

    def zeros_f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    state = {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": tree_map(zeros_f32, params),
        "v": tree_map(zeros_f32, params),
    }
    if cfg.mixed_precision:
        state["master"] = tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


@torch.no_grad()
def adamw_update(
    grads: Any,
    state: Dict,
    params: Any,
    lr: Union[float, torch.Tensor],
    cfg: AdamWConfig = AdamWConfig(),
) -> Tuple[Any, Dict]:
    """One AdamW step, in place on ``state`` and ``params``; returns them."""
    bc1, bc2 = bias_corrections(state, cfg)
    masters = state.get("master", params)
    for path, g in flatten_tree(grads):
        master, p = tree_get(masters, path), tree_get(params, path)
        adamw_leaf(g, tree_get(state["m"], path), tree_get(state["v"], path), master, lr, bc1,
                   bc2, cfg)
        if p is not master:
            p.copy_(master)
    return params, state


def bias_corrections(state: Dict, cfg: AdamWConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counts the step in ``state`` and returns its (1 - b1^t, 1 - b2^t)."""
    state["step"].add_(1)
    step = state["step"].float()
    return 1.0 - cfg.b1**step, 1.0 - cfg.b2**step


def adamw_leaf(g, m, v, master, lr, bc1, bc2, cfg: AdamWConfig) -> None:
    """One leaf's AdamW update: ``m``, ``v`` and ``master`` (the fp32
    master, or the param itself without one) in place."""
    g = g.float()
    m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
    upd = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
    upd.add_(master.float(), alpha=cfg.weight_decay).mul_(lr)
    if master.dtype == torch.float32:
        master.sub_(upd)
    else:  # no fp32 master: the param itself, updated in fp32
        master.copy_(master.float() - upd)


def global_norm(tree: Any) -> torch.Tensor:
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x in leaves:
        total = total + x.float().square().sum()
    return total.sqrt()


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """Scales ``grads`` in place to a global norm of at most ``max_norm``;
    returns (grads, the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale.to(g.dtype))
    return grads, norm
