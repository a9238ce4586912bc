"""Train-step factory: loss -> grads -> clip -> AdamW, with optional
microbatch gradient accumulation; the counterpart of
``repro.training.train_step``.

Gradients come from ``torch.autograd.grad`` over the param leaves (the
leaves are marked ``requires_grad`` on first use).  With ``remat`` the
model checkpoints each stacked group, and the chunked CE each chunk.  The
clip and the AdamW update work in place (see :mod:`repro_torch.optim`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from ..checkpoint import flatten_tree, tree_map, unflatten_tree
from ..models.registry import ModelApi
from ..optim import AdamWConfig, adamw_update, clip_by_global_norm
from ..optim.adamw import tree_get
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
) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), with metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` and
    ``lr`` as 0-dim tensors.  ``batch`` leaves have the global batch leading
    dim; with microbatches > 1 it must divide evenly, each microbatch's
    grads are added into an fp32 (or ``accum_dtype``) buffer and divided by
    the count, and the metrics of the last microbatch are kept."""

    def grads_of(params, mb) -> Tuple[torch.Tensor, Dict, Dict]:
        leaves = flatten_tree(params)
        tensors = [t.requires_grad_(True) for _, t in leaves]
        loss, metrics = api.loss_fn(params, mb, remat=remat)
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
        grads = {
            path: g if g is not None else torch.zeros_like(t)
            for (path, t), g in zip(leaves, grads)
        }
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, unflatten_tree(grads)

    def accumulate(params, batch):
        if microbatches == 1:
            return grads_of(params, batch)
        for name, x in batch.items():
            if x.shape[0] % microbatches:
                raise ValueError(f"batch {name} of {x.shape[0]} rows over {microbatches} microbatches")
        adt = accum_dtype or torch.float32
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=adt, device=p.device), params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=api.device)
        for i in range(microbatches):
            mb = {k: x.chunk(microbatches, dim=0)[i] for k, x in batch.items()}
            loss, metrics, grads = grads_of(params, mb)
            for path, g in flatten_tree(grads):
                tree_get(acc, path).add_(g.to(adt))
            loss_sum = loss_sum + loss
            del grads
        for _, g in flatten_tree(acc):
            g.div_(microbatches)
        return loss_sum / microbatches, metrics, acc

    def train_step(params, opt_state, batch):
        loss, metrics, grads = accumulate(params, batch)
        with record_function("optimizer"):  # a profiler span: clip + AdamW
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            lr = warmup_cosine(opt_state["step"], peak_lr, warmup_steps, total_steps)
            params, opt_state = adamw_update(grads, opt_state, params, lr, opt_cfg)
        metrics = dict(metrics)
        metrics.update({"grad_norm": gnorm, "lr": lr, "loss": loss})
        return params, opt_state, metrics

    return train_step


def make_eval_step(api: ModelApi) -> Callable:
    """Returns eval_step(params, batch) -> metrics of ``loss_fn`` without
    remat and without gradients."""

    def eval_step(params: Any, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            _, metrics = api.loss_fn(params, batch, remat=False)
        return metrics

    return eval_step
