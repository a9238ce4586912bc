"""Train-step factory: loss -> grads -> clip -> AdamW, with optional
microbatch gradient accumulation; the counterpart of
``repro.training.train_step``.

Gradients come from ``torch.autograd.grad`` over the param leaves (the
leaves are marked ``requires_grad`` on first use).  With ``remat`` the
model checkpoints each stacked group, and the chunked CE each chunk.  The
clip and the AdamW update work in place (see :mod:`repro_torch.optim`).

With a ``DistContext`` (``ctx``) the step is the sharded one, as the JAX
step is under ``distribution(ctx)`` with the trees sharded by
``param_specs`` / ``opt_specs``: the params and the AdamW state are
``DTensor`` s of those specs (:func:`repro_torch.distributed.distribute_tree`)
and the batch, given whole on every rank, is split by ``batch_specs``.  Each
gradient is reduced over the ranks straight to its optimizer state's
placement (ZeRO-1: a reduce-scatter over the DP dims), the clip norm sums
the shards, each rank updates its slice of m / v / master, and the params
are gathered back from the masters in their own dtype.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from ..checkpoint import flatten_tree, unflatten_tree
from ..distributed.context import DistContext, distribution, is_dtensor
from ..models.registry import ModelApi
from ..optim import AdamWConfig, adamw_update, clip_by_global_norm
from ..optim.adamw import adamw_leaf, bias_corrections, tree_get
from ..optim.schedules import warmup_cosine


def make_train_step(
    api: ModelApi,
    opt_cfg: AdamWConfig = AdamWConfig(),
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    max_grad_norm: float = 1.0,
    microbatches: int = 1,
    remat: bool = True,
    accum_dtype: Optional[torch.dtype] = None,
    ctx: Optional[DistContext] = None,
) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), with metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` and
    ``lr`` as 0-dim tensors.  ``batch`` leaves have the global batch leading
    dim; with microbatches > 1 it must divide evenly, each microbatch's
    grads are added into an fp32 (or ``accum_dtype``) buffer and divided by
    the count, and the metrics of the last microbatch are kept.  With
    ``ctx`` the step is the sharded one (see the module's docstring)."""
    if ctx is None:
        grads_of, update = _plain_parts(api, opt_cfg, peak_lr, warmup_steps, total_steps,
                                        max_grad_norm, remat)
    else:
        grads_of, update = _sharded_parts(api, opt_cfg, peak_lr, warmup_steps, total_steps,
                                          max_grad_norm, remat, ctx)

    def accumulate(params, opt_state, batch):
        if microbatches == 1:
            return grads_of(params, opt_state, batch)
        adt = accum_dtype or torch.float32
        acc = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=api.device)
        for mb in _split(batch, microbatches):
            loss, metrics, grads = grads_of(params, opt_state, mb)
            if acc is None:
                acc = {path: torch.zeros_like(g, dtype=adt) for path, g in grads.items()}
            for path, g in grads.items():
                acc[path].add_(g.to(adt))
            loss_sum = loss_sum + loss
            del grads
        for g in acc.values():
            g.div_(microbatches)
        return loss_sum / microbatches, metrics, acc

    def train_step(params, opt_state, batch):
        loss, metrics, grads = accumulate(params, opt_state, batch)
        with record_function("optimizer"):  # a profiler span: clip + AdamW
            params, opt_state, gnorm, lr = update(grads, opt_state, params)
        metrics = dict(metrics)
        metrics.update({"grad_norm": gnorm, "lr": lr, "loss": loss})
        return params, opt_state, metrics

    return train_step


def _split(batch: Dict[str, torch.Tensor], n: int):
    for name, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch {name} of {x.shape[0]} rows over {n} microbatches")
    return [{k: x.chunk(n, dim=0)[i] for k, x in batch.items()} for i in range(n)]


def _full(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if is_dtensor(t) else t


def _plain_parts(api, opt_cfg, peak_lr, warmup_steps, total_steps, max_grad_norm, remat):
    """grads_of(params, opt_state, batch) -> (loss, metrics, {path: grad})
    and update(grads, opt_state, params) -> (params, opt_state, grad_norm,
    lr) of the unsharded step."""

    def grads_of(params, opt_state, mb) -> Tuple[torch.Tensor, Dict, Dict]:
        leaves = flatten_tree(params)
        tensors = [t.requires_grad_(True) for _, t in leaves]
        loss, metrics = api.loss_fn(params, mb, remat=remat)
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        grads = {
            path: g if g is not None else torch.zeros_like(t)
            for (path, t), g in zip(leaves, grads)
        }
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def update(grads, opt_state, params):
        grads, gnorm = clip_by_global_norm(unflatten_tree(grads), max_grad_norm)
        lr = warmup_cosine(opt_state["step"], peak_lr, warmup_steps, total_steps)
        params, opt_state = adamw_update(grads, opt_state, params, lr, opt_cfg)
        return params, opt_state, gnorm, lr

    return grads_of, update


def _sharded_parts(api, opt_cfg, peak_lr, warmup_steps, total_steps, max_grad_norm, remat,
                   ctx: DistContext):
    """The sharded step's grads_of and update: the batch split by
    ``batch_specs``, each gradient reduced to its optimizer state's
    placement, and AdamW on each rank's slice."""
    from torch.distributed.tensor import DTensor

    from ..distributed.sharding_rules import batch_specs, distribute_tree

    def grads_of(params, opt_state, mb):
        """(loss, metrics, {path: the gradient at its optimizer placement})."""
        leaves = flatten_tree(params)
        tensors = [t.requires_grad_(True) for _, t in leaves]
        spec = batch_specs({k: (tuple(x.shape), x.dtype) for k, x in mb.items()}, ctx)
        with distribution(ctx):
            loss, metrics = api.loss_fn(params, distribute_tree(mb, spec, ctx), remat=remat)
            grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        out = {}
        for (path, t), g in zip(leaves, grads):
            g = g if g is not None else torch.zeros_like(t)
            # the reduction over the ranks: to the optimizer state's placement
            out[path] = g.redistribute(placements=tree_get(opt_state["m"], path).placements)
        metrics = {k: _full(v.detach()) for k, v in metrics.items()}
        return _full(loss.detach()), metrics, out

    @torch.no_grad()
    def update(grads, opt_state, params):
        """Clip by the global norm and one AdamW step on each rank's slice
        of the state; the params gathered back from it."""
        lr = warmup_cosine(opt_state["step"].to_local(), peak_lr, warmup_steps, total_steps)
        total = torch.zeros((), dtype=torch.float32, device=api.device)
        for g in grads.values():
            total = total + _full(g.float().square().sum())
        gnorm = total.sqrt()
        scale = torch.clamp(max_grad_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        bc1, bc2 = bias_corrections({"step": opt_state["step"].to_local()}, opt_cfg)
        for path, g in grads.items():
            g_l = g.to_local()
            g_l.mul_(scale.to(g_l.dtype))
            m, v = tree_get(opt_state["m"], path), tree_get(opt_state["v"], path)
            p = tree_get(params, path)
            if "master" in opt_state:
                master = tree_get(opt_state["master"], path)
            else:  # the param's own slice, updated in fp32 and gathered back
                master = p.redistribute(placements=m.placements)
            master_l = master.to_local()
            adamw_leaf(g_l, m.to_local(), v.to_local(), master_l, lr, bc1, bc2, opt_cfg)
            new = DTensor.from_local(master_l.to(p.dtype), ctx.mesh, master.placements,
                                     shape=p.shape, stride=p.stride())
            p.copy_(new.redistribute(placements=p.placements))
        return params, opt_state, gnorm, lr

    return grads_of, update


def make_eval_step(api: ModelApi) -> Callable:
    """Returns eval_step(params, batch) -> metrics of ``loss_fn`` without
    remat and without gradients."""

    def eval_step(params: Any, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            _, metrics = api.loss_fn(params, batch, remat=False)
        return metrics

    return eval_step
