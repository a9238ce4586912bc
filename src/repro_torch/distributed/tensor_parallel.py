"""The layers' local regions under a mesh: what GSPMD does for the JAX
package's dense layers, written out with ``local_map``.

Under a :class:`~.context.DistContext` the params and the batch are
``DTensor`` s.  The glue between layers (residual adds, ``constrain``) runs
on ``DTensor`` s; each layer that calls a hand-written kernel, or whose
sharding DTensor would otherwise settle by replicating, runs here as one
``local_map`` region on the local tensors, so the kernels only ever see
plain CUDA tensors:

  * ``rms_norm`` -- on the local rows (batch over DP, the sequence over
    ``model`` with SP);
  * ``attention_block`` -- Megatron TP: the sequence gathered, the local q
    heads (``q`` / ``o`` split by heads) with their kv heads, the output a
    partial sum over ``model``.  When the kv heads do not divide the model
    dim their weights are replicated and each rank slices out the kv heads
    its q heads use (:func:`local_kv_heads`); the kernel then sees the
    local group, and raises where it has no instance for it.  When the q
    heads do not divide, attention is replicated over ``model``;
  * ``mlp`` -- column-split up/gate, row-split down, a partial sum;
  * ``embed`` -- a vocab-split table: each rank looks up the tokens of its
    rows and zeros the rest, a partial sum (exact: one term is nonzero);
  * ``chunked_cross_entropy`` / ``unembed`` -- the vocab gathered, the CE
    over each rank's own tokens (batch over DP, the sequence over
    ``model``), the NLL sum and the token count partial sums.

A partial output is redistributed to the layer input's placements (a
reduce-scatter with SP, an all-reduce without).  The gradient placement of
each input is exact: a sharded input's gradient is sharded alike; a
replicated input's is a partial sum over every mesh dim along which the
region's work is split (some input sharded there), else replicated.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..configs.base import ModelConfig
from .context import DistContext, current, is_dtensor


def _ctx() -> DistContext:
    ctx = current()
    if ctx is None:
        raise RuntimeError("DTensor inputs need an active DistContext (distributed.distribution)")
    return ctx


def _check(*tensors) -> None:
    for t in tensors:
        if not is_dtensor(t):
            raise TypeError(f"expected a DTensor under the distribution context, got {type(t)}")


def replicated(n: int) -> list:
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in range(n)]


def settled(pl: Sequence) -> list:
    """``pl`` with every partial sum resolved (replicated)."""
    from torch.distributed.tensor import Replicate

    return [Replicate() if p.is_partial() else p for p in pl]


def with_placement(pl: Sequence, dim: int, p) -> list:
    out = list(pl)
    out[dim] = p
    return out


def _split_dims(placements: Sequence[Sequence]) -> List[int]:
    return sorted({k for pl in placements for k, p in enumerate(pl) if p.is_shard()})


def partial_over(n: int, dims: Sequence[int]) -> list:
    from torch.distributed.tensor import Partial, Replicate

    return [Partial() if k in dims else Replicate() for k in range(n)]


def region(fn, args: Sequence, in_pl: Sequence[Sequence], out_pl, mesh):
    """``fn`` on the local tensors of the ``DTensor`` s ``args``, each first
    redistributed to its placements in ``in_pl``; the outputs are
    ``DTensor`` s of ``out_pl`` (one list, or a tuple of lists).  Gradient
    placements follow the module's rule."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    args = [a.redistribute(placements=pl) for a, pl in zip(args, in_pl)]
    split = _split_dims(in_pl)
    grad_pl = tuple(
        [p if p.is_shard() else (Partial() if k in split else Replicate())
         for k, p in enumerate(pl)]
        for pl in in_pl
    )
    return local_map(fn, out_placements=out_pl, in_grad_placements=grad_pl,
                     device_mesh=mesh)(*args)


def model_dim(ctx: DistContext) -> int:
    return ctx.all_axes.index(ctx.model_axis)


def _row_placements(x, ctx: DistContext, model):
    """x's settled placements with the model dim set to ``model``."""
    return with_placement(settled(x.placements), model_dim(ctx), model)


# ------------------------------------------------------------------- norms
def rms_norm(x, params: Dict, eps: float):
    from ..models.layers import rms_norm as local_norm

    ctx = _ctx()
    _check(x, params["scale"])
    pl = settled(x.placements)
    return region(lambda xl, sl: local_norm(xl, {"scale": sl}, eps),
                  [x, params["scale"]], [pl, replicated(len(pl))], pl, ctx.mesh)


# --------------------------------------------------------------- attention
def local_kv_heads(rank: int, hq_local: int, group: int) -> Tuple[int, int]:
    """(first, count) of the kv heads that q heads ``[rank * hq_local,
    (rank + 1) * hq_local)`` use at GQA group ``group``; their local group
    is ``hq_local // count``.  Raises when the kv heads of one rank's q
    heads are not an even share."""
    first = rank * hq_local
    if hq_local % group == 0:
        return first // group, hq_local // group
    if group % hq_local == 0:
        return first // group, 1
    raise NotImplementedError(
        f"{hq_local} q heads a rank at GQA group {group} do not share their kv heads evenly")


def attention_block(params: Dict, x, positions: torch.Tensor, cfg: ModelConfig, *,
                    causal: bool, window: Optional[int], rope: Tuple[torch.Tensor, torch.Tensor]):
    """The teacher-forced attention sub-block on ``DTensor`` s; returns
    (out with x's placements, None)."""
    from torch.distributed.tensor import Partial, Replicate

    from ..models.attention import attention_block as local_attention

    ctx = _ctx()
    ws = [params[n]["w"] for n in ("q", "k", "v", "o")]
    _check(x, *ws)
    md = model_dim(ctx)
    hd = cfg.head_dim_
    heads = ws[0].placements[md].is_shard()
    kv_split = ws[1].placements[md].is_shard()
    kv_slice = None
    if heads and not kv_split:
        hq_l = cfg.n_heads // ctx.model_size
        rank = ctx.mesh.get_local_rank(ctx.model_axis)
        first, count = local_kv_heads(rank, hq_l, cfg.n_heads // cfg.n_kv_heads)
        kv_slice = slice(first * hd, (first + count) * hd)
    h_pl = _row_placements(x, ctx, Replicate())
    w_pl = [settled(w.placements) for w in ws]
    out_pl = with_placement(h_pl, md, Partial() if heads else Replicate())

    def local(hl, q, k, v, o):
        if kv_slice is not None:
            k, v = k[:, kv_slice], v[:, kv_slice]
        b = hl.shape[0]
        out, _ = local_attention(
            {"q": {"w": q}, "k": {"w": k}, "v": {"w": v}, "o": {"w": o}}, hl, positions[:b],
            cfg, causal=causal, window=window, rope=(rope[0][:b], rope[1][:b]))
        return out

    out = region(local, [x, *ws], [h_pl, *w_pl], out_pl, ctx.mesh)
    return out.redistribute(placements=settled(x.placements)), None


# --------------------------------------------------------------------- mlp
def mlp(x, params: Dict, cfg: ModelConfig):
    from torch.distributed.tensor import Partial, Replicate

    from ..models.layers import mlp as local_mlp

    ctx = _ctx()
    names = sorted(params)
    ws = [params[n]["w"] for n in names]
    _check(x, *ws)
    md = model_dim(ctx)
    col = params["up"]["w"].placements[md].is_shard()
    h_pl = _row_placements(x, ctx, Replicate())
    out_pl = with_placement(h_pl, md, Partial() if col else Replicate())

    def local(hl, *w):
        return local_mlp(hl, {n: {"w": t} for n, t in zip(names, w)}, cfg)

    out = region(local, [x, *ws], [h_pl, *[settled(w.placements) for w in ws]], out_pl,
                 ctx.mesh)
    return out.redistribute(placements=settled(x.placements))


# -------------------------------------------------------------- embeddings
def embed(tokens, params: Dict, cfg: ModelConfig):
    """The token embedding on ``DTensor`` s; returns [B, S, d] with the
    tokens' batch placements, replicated over ``model``."""
    from torch.distributed.tensor import Partial, Replicate

    from ..models.layers import embed as local_embed

    ctx = _ctx()
    table = params["table"]
    _check(tokens, table)
    md = model_dim(ctx)
    vocab_split = table.placements[md].is_shard()
    t_pl = settled(tokens.placements)
    rank = ctx.mesh.get_local_rank(ctx.model_axis)

    def local(tl, tab):
        if not vocab_split:
            return local_embed(tl, {"table": tab}, cfg)
        # this rank's rows of the vocab; the others' tokens give zeros
        rows = tab.shape[0]
        ids = tl - rank * rows
        ok = (ids >= 0) & (ids < rows)
        x = local_embed(ids.clamp(0, rows - 1), {"table": tab}, cfg)
        return torch.where(ok[..., None], x, x.new_zeros(()))

    out_pl = with_placement(t_pl, md, Partial() if vocab_split else Replicate())
    out = region(local, [tokens, table], [t_pl, settled(table.placements)], out_pl, ctx.mesh)
    return out.redistribute(placements=settled(out_pl))


def _vocab_weights(cfg: ModelConfig) -> List[str]:
    return ["table"] if cfg.tie_embeddings else ["lm_head"]


def unembed(x, params: Dict, cfg: ModelConfig):
    """Logits with x's placements, the vocab gathered."""
    from ..models.layers import unembed as local_unembed

    ctx = _ctx()
    names = _vocab_weights(cfg)
    ws = [params[n] for n in names]
    _check(x, *ws)
    pl = settled(x.placements)

    def local(xl, *w):
        return local_unembed(xl, dict(zip(names, w)), cfg)

    return region(local, [x, *ws], [pl, *[replicated(len(pl)) for _ in ws]], pl, ctx.mesh)


def chunked_cross_entropy(x, params: Dict, cfg: ModelConfig, labels, mask, chunk: int):
    """The mean CE on ``DTensor`` s: each rank's tokens (batch over DP, the
    sequence over ``model`` when it divides) against the whole vocab; the
    NLL sum and the token count reduce over the ranks."""
    from torch.distributed.tensor import Replicate, Shard

    from ..models.layers import nll_sum_and_count

    ctx = _ctx()
    names = _vocab_weights(cfg)
    ws = [params[n] for n in names]
    data = [x, labels] + ([mask] if mask is not None else [])
    _check(*data, *ws)
    seq = Shard(1) if x.shape[1] % ctx.model_size == 0 else Replicate()
    pl = _row_placements(x, ctx, seq)
    n = len(pl)
    red = partial_over(n, _split_dims([pl]))

    def local(xl, ll, *rest):
        ml = rest[0] if mask is not None else None
        w = rest[1:] if mask is not None else rest
        return nll_sum_and_count(xl, dict(zip(names, w)), cfg, ll, ml, chunk)

    nll, count = region(local, data + ws, [pl] * len(data) + [replicated(n)] * len(ws),
                        (red, red), ctx.mesh)
    rep = replicated(n)
    return nll.redistribute(placements=rep) / count.redistribute(placements=rep).clamp_min(1.0)

