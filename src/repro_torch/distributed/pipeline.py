"""Pipeline parallelism over a mesh dim (GPipe): the counterpart of
``repro.distributed.pipeline``.

At 2+ hosts the link between them is the slow one: instead of extending
data parallelism across it, the dim can carry pipeline stages.  Each rank
of the dim owns one stage, activations flow stage to stage (microbatch
sized, orders of magnitude smaller than gradients), and microbatches keep
every stage busy outside the fill and drain bubbles.

The schedule is the JAX ``shard_map`` body's:
  * stage parameters are stacked on a leading ``n_stages`` dim; a rank
    applies row ``i`` of the stack, ``i`` its index along the dim (a
    ``DTensor`` sharded on dim 0 over the dim gives it just that row);
  * the loop runs ``n_micro + n_stages - 1`` ticks; on each tick a rank
    runs its stage on the activation it holds, then the ring rotates
    (send to the next rank, receive from the previous);
  * stage 0 injects a fresh microbatch each tick (while any remain); the
    last stage's outputs are collected on the final ticks and broadcast;
  * bubble fraction = (n_stages - 1) / (n_micro + n_stages - 1).

It is differentiable, as the JAX scan is: an autograd function whose
backward walks the ticks in reverse and sends each gradient one stage
back; the outputs' gradient is the last stage's (every rank must compute
the same loss from them), and a replicated input (``x``, or a full stack of
stage params) gets its gradient summed over the dim, so that every rank
holds the whole of it.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..checkpoint import flatten_tree, unflatten_tree
from .context import is_dtensor


class _Stages:
    """What the pipeline's autograd function needs to know of the dim."""

    def __init__(self, stage_fn, paths, group, idx: int, n_stages: int, ranks):
        self.stage_fn, self.paths, self.group = stage_fn, paths, group
        self.idx, self.n_stages = idx, n_stages
        self.nxt, self.prv = ranks[(idx + 1) % n_stages], ranks[(idx - 1) % n_stages]
        self.last = ranks[-1]

    def shift(self, t: torch.Tensor, to: int, frm: int) -> torch.Tensor:
        """Send ``t`` to rank ``to`` while receiving its like from ``frm``."""
        if self.n_stages == 1:
            return t.clone()
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t.contiguous(), to, self.group),
               dist.P2POp(dist.irecv, out, frm, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule over the stage rows ``params`` of this rank.

    The forward keeps each tick's graph (its input state, its output); the
    backward walks the ticks in reverse: it sends the gradient of the state
    that tick t + 1 received one stage back and receives the gradient of
    tick t's output from the next stage (plus the outputs' own on the last
    stage), then takes the tick's vector-Jacobian product.  Every rank
    makes one exchange a tick in the same order, so the ring pairs up."""

    @staticmethod
    def forward(ctx, st: _Stages, xs, *params):
        n_micro = xs.shape[0]
        ticks = []
        with torch.enable_grad():
            ps = [p.detach().requires_grad_(p.requires_grad) for p in params]
            # a bare tensor flattens to the one path ""
            tree = ps[0] if st.paths == [""] else unflatten_tree(dict(zip(st.paths, ps)))
            state = torch.zeros_like(xs[0])  # the activation this stage holds
            outs = torch.zeros_like(xs)
            for t in range(n_micro + st.n_stages - 1):
                if st.idx == 0:  # stage 0 injects microbatch t (while any remain)
                    state = xs[min(t, n_micro - 1)]
                s_in = state.detach().requires_grad_(True)
                y = st.stage_fn(tree, s_in)
                ticks.append((s_in, y))
                emit = t - (st.n_stages - 1)
                if st.idx == st.n_stages - 1 and emit >= 0:
                    outs[emit] = y.detach()
                # rotate the ring: stage i -> i + 1 (the last wraps to 0, ignored)
                state = st.shift(y.detach(), to=st.nxt, frm=st.prv)
        # only the last stage holds real outputs; broadcast them
        dist.broadcast(outs, src=st.last, group=st.group)
        ctx.st, ctx.ticks, ctx.ps = st, ticks, ps
        return outs

    @staticmethod
    def backward(ctx, g_out):
        st, ticks, ps = ctx.st, ctx.ticks, ctx.ps
        n_micro = g_out.shape[0]
        g_params = [torch.zeros_like(p) for p in ps]
        g_xs = torch.zeros_like(g_out)
        g_state = torch.zeros_like(g_out[0])  # of the state the next tick received
        for t in reversed(range(len(ticks))):
            s_in, y = ticks[t]
            g_y = st.shift(g_state, to=st.prv, frm=st.nxt)
            emit = t - (st.n_stages - 1)
            if st.idx == st.n_stages - 1 and emit >= 0:
                g_y = g_y + g_out[emit]
            wrt = [s_in] + [p for p in ps if p.requires_grad]
            grads = iter(torch.autograd.grad(y, wrt, g_y, allow_unused=True))
            g_s = next(grads)
            g_s = torch.zeros_like(s_in) if g_s is None else g_s
            for i, p in enumerate(ps):
                if p.requires_grad:
                    g = next(grads)
                    if g is not None:
                        g_params[i] += g
            if st.idx == 0:  # the state was microbatch t, not the ring's
                g_xs[min(t, n_micro - 1)] += g_s
                g_state = torch.zeros_like(g_s)
            else:
                g_state = g_s
        return (None, g_xs, *g_params)


class _Replicated(torch.autograd.Function):
    """Identity on a tensor every rank of the dim holds; its gradient is
    summed over the dim."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,  # leaves stacked [n_stages, ...]
    x: torch.Tensor,  # [n_micro, mb, ...] microbatched input, the same on every rank
    mesh,
    axis: str = "pod",
) -> torch.Tensor:
    """Run ``x``'s microbatches through the stage pipeline over mesh dim
    ``axis``; returns the [n_micro, mb, ...] outputs of the last stage on
    every rank of the dim.  ``stage_fn(params, h)`` maps one microbatch to
    one of the same shape."""
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    if x.shape[0] < n_stages:
        raise ValueError(f"need >= {n_stages} microbatches to fill {n_stages} stages")
    idx = mesh.get_local_rank(axis)

    def own_row(p):
        if is_dtensor(p):  # sharded over the dim: the local row is this stage's
            return p.to_local()[0]
        return _Replicated.apply(p, group)[idx]

    leaves = flatten_tree(stage_params)
    st = _Stages(stage_fn, [path for path, _ in leaves], group, idx, n_stages,
                 dist.get_process_group_ranks(group))
    return _Pipeline.apply(st, _Replicated.apply(x, group), *[own_row(p) for _, p in leaves])


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
