"""Faults planted underneath the timed path, for the tests and for
``calibrate.py``'s readings: with any of them a run's ``correct`` has to
come out false.

* ``half_batch``: the loss taken over the first half of each batch only,
  its mean over the rest;
* ``stale_params``: AdamW updates the fp32 masters and moments but never
  copies the masters into the bf16 parameters that the forward reads.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("half_batch", "stale_params")


def half_batch(loss_fn):
    def loss(params, batch, cfg, **kw):
        return loss_fn(params, {k: v[: v.shape[0] // 2] for k, v in batch.items()}, cfg, **kw)
    return loss


@torch.no_grad()
def adamw_without_refresh(grads, state, params, lr, cfg):
    """The program's ``adamw_update`` less its ``p.copy_(master)``."""
    from repro_torch.checkpoint import flatten_tree
    from repro_torch.optim.adamw import adamw_leaf, bias_corrections, tree_get

    bc1, bc2 = bias_corrections(state, cfg)
    for path, g in flatten_tree(grads):
        adamw_leaf(g, tree_get(state["m"], path), tree_get(state["v"], path),
                   tree_get(state["master"], path), lr, bc1, bc2, cfg)
    return params, state


@contextlib.contextmanager
def planted(name: str):
    import repro_torch.models.transformer as transformer
    import repro_torch.training.train_step as train_step

    module, attr = {"half_batch": (transformer, "loss_fn"),
                    "stale_params": (train_step, "adamw_update")}[name]
    saved = getattr(module, attr)
    setattr(module, attr, half_batch(saved) if name == "half_batch" else adamw_without_refresh)
    try:
        yield
    finally:
        setattr(module, attr, saved)
