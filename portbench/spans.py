"""Benchmark-side spans around the program's layers, on only in a traced
run.

``installed()`` replaces, for its duration, three names that the model
code calls through its modules' globals:

* ``distributed.moe_parallel.moe_mlp_local`` (the MoE layer) runs inside a
  ``pb.moe_layer`` profiler span: its forwards and remat's recomputes;
* ``models.attention.flash_attention`` (attention) and ``models.mamba2.ssd``
  (the SSD scan) run inside ``pb.attn`` / ``pb.ssd`` spans, and their
  backward, whatever autograd nodes compute it, inside ``pb.attn.bwd`` /
  ``pb.ssd.bwd``: an identity node on the outputs opens that span when the
  gradient reaches them and one on the inputs closes it when the gradient
  leaves.  Each call and each backward records the shapes it ran at, from
  which the frozen cost functions of :mod:`portbench.costs` count its work.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import torch
from torch.profiler import record_function

from . import costs


class Records:
    """The kernel costs of each instrumented op's calls in a traced window."""

    def __init__(self):
        self.costs: Dict[str, List[costs.KernelCost]] = {}
        self.open: Dict[str, list] = {}

    def add(self, name: str, cost: costs.KernelCost) -> None:
        self.costs.setdefault(name, []).append(cost)


class _OpenBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rec, name, cost, *ts):
        ctx.rec, ctx.name, ctx.cost = rec, name, cost
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        handle = torch.ops.profiler._record_function_enter_new(ctx.name + ".bwd", None)
        ctx.rec.open.setdefault(ctx.name, []).append(handle)
        ctx.rec.add(ctx.name, ctx.cost)
        return (None, None, None, *grads)


class _CloseBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rec, name, *ts):
        ctx.rec, ctx.name = rec, name
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        stack = ctx.rec.open.get(ctx.name)
        if stack:
            torch.ops.profiler._record_function_exit._RecordFunction(stack.pop())
        return (None, None, *grads)


def _op(rec: Records, name: str, fn: Callable, n_in: int, fwd_cost, bwd_cost):
    """``fn`` whose first ``n_in`` arguments are its differentiable inputs
    and whose result's first tensor is the output the backward starts
    from."""

    def call(*args, **kw):
        with record_function(name):
            ins = args[:n_in]
            track = torch.is_grad_enabled() and any(t.requires_grad for t in ins)
            if track:
                ins = _CloseBackward.apply(rec, name, *ins)
            rec.add(name, fwd_cost(*args, **kw))
            out = fn(*ins, *args[n_in:], **kw)
            if not track:
                return out
            first = out[0] if isinstance(out, tuple) else out
            (first,) = _OpenBackward.apply(rec, name, bwd_cost(*args, **kw), first)
            return (first, *out[1:]) if isinstance(out, tuple) else first

    return call


def _attn_cost(backward: bool):
    def cost(q, k, v, causal=True, window=None):
        b, sq, hq, d = q.shape
        return costs.flash_cost(b, sq, k.shape[1], hq, k.shape[2], d, causal, window,
                                q.element_size(), backward)
    return cost


def _ssd_cost(backward: bool):
    def cost(x, dA, B, C, chunk=256, initial_state=None):
        b, s, h, p = x.shape
        q, init = min(chunk, s), initial_state is not None
        if backward:  # the final state is not trained on: no gradient reaches it
            return costs.ssd_bwd_cost(b, s, h, p, B.shape[3], B.shape[2], q, init, False)
        return costs.ssd_cost(b, s, h, p, B.shape[3], B.shape[2], q, init, x.element_size())
    return cost


@contextlib.contextmanager
def installed(rec: Records):
    from repro_torch.distributed import moe_parallel
    from repro_torch.models import attention, mamba2

    saved = (moe_parallel.moe_mlp_local, attention.flash_attention, mamba2.ssd)
    moe_fn = saved[0]

    def moe_layer(*a, **k):
        with record_function("pb.moe_layer"):
            return moe_fn(*a, **k)

    moe_parallel.moe_mlp_local = moe_layer
    attention.flash_attention = _op(rec, "pb.attn", saved[1], 3, _attn_cost(False),
                                    _attn_cost(True))
    mamba2.ssd = _op(rec, "pb.ssd", saved[2], 4, _ssd_cost(False), _ssd_cost(True))
    try:
        yield rec
    finally:
        moe_parallel.moe_mlp_local, attention.flash_attention, mamba2.ssd = saved
