"""Expert-parallel MoE bridge: the counterpart of
``repro.distributed.moe_parallel``, with ``local_map`` where JAX has
``shard_map``.

Train/prefill (S divisible by the model dim) under a context with ``ep``
-> the local region runs :func:`~repro_torch.models.moe.moe_mlp_ep` on
each rank's tokens (batch over DP when it divides, the sequence over
``model``) and experts, the capacity buffers exchanged by
``all_to_all_single`` over the model dim; the aux loss is averaged over
the dims the tokens vary on (the JAX ``pmean``: a partial sum of aux / n,
resolved on the way out).  Decode (S == 1), no context, ``ep`` off, or S
not divisible -> :func:`~repro_torch.models.moe.moe_mlp_local`; under a
mesh it runs on every rank over the whole batch, the experts gathered.
"""

from __future__ import annotations

from typing import Dict

from ..configs.base import ModelConfig
from ..models.moe import moe_mlp_ep, moe_mlp_local
from .context import current, is_dtensor
from .tensor_parallel import model_dim, partial_over, replicated, settled, with_placement, region


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _leaves(moe_params: Dict):
    """(names, tensors) of an MoE layer's params, the router first."""
    names = ["router", "gate", "up", "down"]
    return names, [moe_params["router"]["w"]] + [moe_params[n] for n in names[1:]]


def _tree(names, tensors) -> Dict:
    return {"router": {"w": tensors[0]}, **dict(zip(names[1:], tensors[1:]))}


def moe_maybe_parallel(moe_params: Dict, x, cfg: ModelConfig):
    ctx = current()
    b, s, d = x.shape
    if not is_dtensor(x):
        return moe_mlp_local(moe_params, x, cfg)
    if ctx is None:
        raise RuntimeError("DTensor inputs need an active DistContext (distributed.distribution)")
    from torch.distributed.tensor import Replicate, Shard

    names, ws = _leaves(moe_params)
    md = model_dim(ctx)
    n = len(ctx.all_axes)
    rep = replicated(n)
    if not ctx.ep or not _div(s, ctx.model_size) or s == 1:
        # the local path on every rank, over the whole batch: its capacity
        # and its aux loss are those of all the tokens, as GSPMD's are
        def local(xl, *w):
            return moe_mlp_local(_tree(names, w), xl, cfg)

        y, aux = region(local, [x, *ws], [rep] * (1 + len(ws)), (rep, rep), ctx.mesh)
        return y.redistribute(placements=settled(x.placements)), aux
    if not _div(moe_params["gate"].shape[0], ctx.model_size):
        raise ValueError(f"{moe_params['gate'].shape[0]} experts over a model dim of "
                         f"{ctx.model_size}: build the model with ep={ctx.model_size}")
    batch = Shard(0) if _div(b, ctx.batch_size_total) else Replicate()
    x_pl = [batch if a in ctx.batch_axes else Replicate() for a in ctx.all_axes]
    x_pl[md] = Shard(1)
    # the aux mean runs over the dims the tokens vary on: model always, the
    # DP dims when the batch is split over them
    reduce_dims = [md] + ([ctx.all_axes.index(a) for a in ctx.batch_axes]
                          if batch.is_shard() else [])
    n_reduce = 1
    for k in reduce_dims:
        n_reduce *= int(ctx.mesh.shape[k])
    w_pl = [rep] + [with_placement(rep, md, Shard(0))] * 3
    group = ctx.mesh.get_group(ctx.model_axis)

    def local(xl, *w):
        y, aux = moe_mlp_ep(_tree(names, w), xl, cfg, group)
        return y, aux / n_reduce

    y, aux = region(local, [x, *ws], [x_pl] + w_pl, (x_pl, partial_over(n, reduce_dims)),
                    ctx.mesh)
    return y.redistribute(placements=settled(x.placements)), aux.redistribute(placements=rep)
