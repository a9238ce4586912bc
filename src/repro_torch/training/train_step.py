"""Train-step factory: loss -> grads -> clip -> AdamW, with optional
microbatch gradient accumulation; the counterpart of
``repro.training.train_step``.

Gradients come from ``torch.autograd.grad`` over the param leaves (the
leaves are marked ``requires_grad`` on first use).  With ``remat`` the
model checkpoints each stacked group, and the chunked CE each chunk.  The
clip and the AdamW update work in place (see :mod:`repro_torch.optim`).
While ``torch.profiler`` records, the forward (with the loss), the
backward and clip + AdamW sit in the spans ``step.forward``,
``step.backward`` and ``optimizer`` (:mod:`repro_torch.tracing`).

With a ``DistContext`` (``ctx``) the step is the sharded one, as the JAX
step is under ``distribution(ctx)`` with the trees sharded by
``param_specs`` / ``opt_specs``: the params and the AdamW state are
``DTensor`` s of those specs (:func:`repro_torch.distributed.distribute_tree`)
and the batch, given whole on every rank, is split by ``batch_specs``.  Each
gradient is reduced over the ranks straight to its optimizer state's
placement (ZeRO-1: a reduce-scatter over the DP dims); the clip and AdamW
are the plain step's, on each rank's slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import tracing
from ..checkpoint import flatten_tree, unflatten_tree
from ..distributed import batch_specs, distribute_tree
from ..distributed.context import DistContext, distribution, full_tensor, to_local
from ..models.registry import ModelApi
from ..optim import AdamWConfig, adamw_update, clip_by_global_norm
from ..optim.schedules import warmup_cosine


def make_train_step(
    api: ModelApi,
    peak_lr: float = 3e-4,
    warmup_steps: int = 100,
    total_steps: int = 10_000,
    max_grad_norm: float = 1.0,
    microbatches: int = 1,
    remat: bool = True,
    ctx: Optional[DistContext] = None,
) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), with metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` and
    ``lr`` as 0-dim tensors.  ``batch`` leaves have the global batch leading
    dim; with microbatches > 1 it must divide evenly, each microbatch's
    grads are added into an fp32 buffer and divided by the count, and the
    metrics of the last microbatch are kept.  With ``ctx`` the step is the
    sharded one (see the module's docstring)."""

    def laid_out(mb):
        if ctx is None:
            return mb
        return distribute_tree(mb, batch_specs({k: (tuple(x.shape), x.dtype)
                                                for k, x in mb.items()}, ctx), ctx)

    def grads_of(params, opt_state, mb) -> Tuple[torch.Tensor, Dict, Dict]:
        """(loss, metrics, {path: grad}), each grad at its optimizer
        state's placement."""
        leaves = flatten_tree(params)
        tensors = [t.requires_grad_(True) for _, t in leaves]
        with distribution(ctx):
            loss, metrics, grads = tracing.forward_backward(
                lambda p: api.loss_fn(p, laid_out(mb), remat=remat), params, tensors,
                allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(t) for (_, t), g in zip(leaves, grads)]
        if ctx is not None:  # the reduction over the ranks
            grads = [g.redistribute(placements=m.placements)
                     for g, (_, m) in zip(grads, flatten_tree(opt_state["m"]))]
        metrics = {k: full_tensor(v.detach()) for k, v in metrics.items()}
        return full_tensor(loss.detach()), metrics, {p: g for (p, _), g in zip(leaves, grads)}

    def accumulate(params, opt_state, batch):
        if microbatches == 1:
            return grads_of(params, opt_state, batch)
        acc = None
        loss_sum = torch.zeros((), dtype=torch.float32, device=api.device)
        for mb in _split(batch, microbatches):
            loss, metrics, grads = grads_of(params, opt_state, mb)
            if acc is None:
                acc = {path: torch.zeros_like(g, dtype=torch.float32) for path, g in grads.items()}
            for path, g in grads.items():
                acc[path].add_(g.to(torch.float32))
            loss_sum = loss_sum + loss
            del grads
        for g in acc.values():
            g.div_(microbatches)
        return loss_sum / microbatches, metrics, acc

    def train_step(params, opt_state, batch):
        loss, metrics, grads = accumulate(params, opt_state, batch)
        with tracing.span("optimizer"):  # clip + AdamW
            grads, gnorm = clip_by_global_norm(unflatten_tree(grads), max_grad_norm)
            lr = warmup_cosine(to_local(opt_state["step"]), peak_lr, warmup_steps, total_steps)
            params, opt_state = adamw_update(grads, opt_state, params, lr, AdamWConfig())
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr, loss=loss)

    return train_step


def _split(batch: Dict[str, torch.Tensor], n: int):
    for name, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch {name} of {x.shape[0]} rows over {n} microbatches")
    return [{k: x.chunk(n, dim=0)[i] for k, x in batch.items()} for i in range(n)]


def make_eval_step(api: ModelApi) -> Callable:
    """Returns eval_step(params, batch) -> metrics of ``loss_fn`` without
    remat and without gradients."""

    def eval_step(params: Any, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            _, metrics = api.loss_fn(params, batch, remat=False)
        return metrics

    return eval_step
