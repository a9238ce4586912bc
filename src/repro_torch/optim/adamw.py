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

The leaves may be ``DTensor`` s, as the sharded train step's are (ZeRO-1):
each gradient then has its optimizer state's placement, the norm sums the
shards' partial sums, AdamW updates each rank's slice, and each param is
gathered back from its master in its own dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

import torch

from ..checkpoint import flatten_tree, tree_map
from ..distributed.context import full_tensor, is_dtensor, to_local


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


def tree_get(tree: Any, path: str) -> Any:
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _aligned(*trees: Any):
    """The leaves of trees with the same key paths, a tuple a path."""
    flat = [flatten_tree(t) for t in trees]
    paths = [p for p, _ in flat[0]]
    if any([p for p, _ in f] != paths for f in flat[1:]):
        raise ValueError("the trees' key paths differ")
    return zip(*([x for _, x in f] for f in flat))


def init_adamw(params: Any) -> Dict:
    """Zero moments and fp32 masters on the params' device."""

    def zeros_f32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {
        "step": torch.zeros((), dtype=torch.int32, device=flatten_tree(params)[0][1].device),
        "m": tree_map(zeros_f32, params),
        "v": tree_map(zeros_f32, params),
        "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
    }


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
    for g, m, v, master, p in _aligned(grads, state["m"], state["v"], state["master"], params):
        adamw_leaf(to_local(g), to_local(m), to_local(v), to_local(master), lr, bc1, bc2, cfg)
        _refresh(p, master)
    return params, state


def _refresh(p, master) -> None:
    """``p`` re-formed from its master in its own dtype; a ``DTensor`` is
    cast on each rank's slice, then gathered to its own placements."""
    if not is_dtensor(p):
        p.copy_(master)
        return
    from torch.distributed.tensor import DTensor

    new = DTensor.from_local(master.to_local().to(p.dtype), master.device_mesh,
                             master.placements, shape=p.shape, stride=p.stride())
    p.copy_(new.redistribute(placements=p.placements))


def bias_corrections(state: Dict, cfg: AdamWConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counts the step in ``state`` and returns its (1 - b1^t, 1 - b2^t)."""
    step = to_local(state["step"])
    step.add_(1)
    step = step.float()
    return 1.0 - cfg.b1**step, 1.0 - cfg.b2**step


def adamw_leaf(g, m, v, master, lr, bc1, bc2, cfg: AdamWConfig) -> None:
    """One leaf's AdamW update: ``m``, ``v`` and the fp32 ``master`` in
    place."""
    g = g.float()
    m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    v.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
    upd = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
    upd.add_(master, alpha=cfg.weight_decay).mul_(lr)
    master.sub_(upd)


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """Scales ``grads`` in place to a global norm of at most ``max_norm``;
    returns (grads, the norm before clipping)."""
    leaves = [g for _, g in flatten_tree(grads)]
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for g in leaves:
        total = total + full_tensor(g.float().square().sum())
    norm = total.sqrt()
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in map(to_local, leaves):
        g.mul_(scale.to(g.dtype))
    return grads, norm
