"""The layers' local regions under a mesh: what GSPMD does for the JAX
package's dense layers, written out with ``local_map``.

Under a :class:`~.context.DistContext` the params and the batch are
``DTensor`` s.  The glue between layers (residual adds, ``constrain``) runs
on ``DTensor`` s; each layer that calls a hand-written kernel, or whose
sharding DTensor would otherwise settle by replicating, runs here as one
``local_map`` region on the local tensors, so the kernels only ever see
plain CUDA tensors:

  * ``rms_norm`` -- on the local rows (batch over DP, the sequence over
    ``model`` with SP); it refuses rows whose own (last) dim is split, which
    it would normalise by each rank's columns alone;
  * ``mamba_block`` -- the Mamba2 mixer, head-parallel: the z/x/dt
    projections, the x conv, A, D, dt_bias and the gate norm's scale split
    by heads/channels, B/C (``bc_proj``, its conv) replicated, B4 on the
    local heads against the full B/C, ``out_proj`` row-split (a partial
    sum).  The gate norm normalises whole ``d_inner`` rows whose columns are
    split, as GSPMD does: each rank's fp32 row statistics are all-reduced
    over ``model`` forward and backward (``rmsnorm_split``, B3a's
    external-statistic mode);
  * ``cross_kv`` / ``cross_attention_block`` -- whisper's cross-attention:
    K/V of the encoder output on the kv heads' split, q from the decoder
    stream on the q heads', the flash kernel non-causally, a partial sum;
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

Decode (one token, no gradient) runs on the local tensors directly,
without ``local_map``, because it writes the cache's local shards in place:

  * ``decode_attention_block`` -- a KV cache [B, S, Hkv, D] whose S dim is
    split (over ``model``, or over the DP dims and ``model`` where the
    batch does not divide: the fold group is read off the cache's
    placements).  The one-token q and the new k/v are gathered over the
    heads they are split by, the rank that holds slot ``pos % S`` writes
    k/v (and the int8 cache's scales), B2's partial mode runs on each
    rank's slots with that range's slot positions, and the partials are
    all-gathered and folded in rank order in fp32 (``fold_partials``); the
    ``o`` projection is then a partial sum over the heads' split.  Whisper's
    cross cache takes the same path, with no write;
  * ``mamba_decode_step`` -- the SSM state's heads and the x conv window's
    channels split as the mixer's weights; the B/C conv window's channels
    are split too (the cache rules'), so each rank convolves its channels
    with its slice of the replicated conv weights and the 2*G*N outputs are
    all-gathered.
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
    if any(p.is_shard(x.ndim - 1) for p in pl):
        raise ValueError(
            f"rms_norm normalises whole rows, and x's last dim is split ({x.placements}); a "
            "row split over ranks takes split_rms_norm")
    return region(lambda xl, sl: local_norm(xl, {"scale": sl}, eps),
                  [x, params["scale"]], [pl, replicated(len(pl))], pl, ctx.mesh)


def _all_reduce(group):
    """An in-place sum over ``group`` (the split's statistics)."""
    import torch.distributed as dist

    return lambda t: dist.all_reduce(t, group=group)


def split_rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, n: int, group):
    """RMSNorm of local rows whose ``n`` columns are split over ``group``:
    x [..., n / |group|] and ``scale`` this rank's columns (plain tensors,
    inside a region)."""
    from ..kernels.rmsnorm.ops import rmsnorm_split

    return rmsnorm_split(x, scale, eps, n, _all_reduce(group))


def _gather(t: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """[R, *t.shape]: ``t`` from every rank of the product of ``groups``
    (mesh dims' process groups, major first), in rank order."""
    import torch.distributed as dist

    out = t.contiguous()[None]
    for group in reversed(groups):
        n = dist.get_world_size(group)
        buf = out.new_empty((n * out.numel(),))
        dist.all_gather_into_tensor(buf, out.reshape(-1), group=group)
        out = buf.view(n * out.shape[0], *t.shape)
    return out


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



# ------------------------------------------------------------------- mamba
#: the mixer's leaves in the order a region takes them; all but B/C's are
#: split by heads or channels over ``model`` when the heads divide it
_MAMBA_LEAVES = (("z_proj", "w"), ("x_proj", "w"), ("bc_proj", "w"), ("dt_proj", "w"),
                 ("conv_x_w",), ("conv_x_b",), ("conv_bc_w",), ("conv_bc_b",), ("A_log",),
                 ("D",), ("dt_bias",), ("gate_norm", "scale"), ("out_proj", "w"))
_MAMBA_REPLICATED = (("bc_proj", "w"), ("conv_bc_w",), ("conv_bc_b",))


def _leaf(tree: Dict, path: Tuple[str, ...]):
    for k in path:
        tree = tree[k]
    return tree


def _mamba_tree(leaves: Sequence) -> Dict:
    tree: Dict = {}
    for path, t in zip(_MAMBA_LEAVES, leaves):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def _mamba_split(params: Dict, md: int) -> bool:
    """The mixer runs head-parallel: every leaf but B/C's split over model."""
    return all(_leaf(params, path).placements[md].is_shard()
               for path in _MAMBA_LEAVES if path not in _MAMBA_REPLICATED)


def _mamba_groups(ctx: DistContext, h_local: int, cfg: ModelConfig) -> Tuple[int, int]:
    """(first, count) of the B/C groups the rank's local heads use."""
    from ..models.mamba2 import mamba_dims

    dims = mamba_dims(cfg)
    rank = ctx.mesh.get_local_rank(ctx.model_axis)
    return local_kv_heads(rank, h_local, dims["n_heads"] // dims["n_groups"])


def mamba_block(params: Dict, u, cfg: ModelConfig, initial_state=None):
    """The Mamba2 mixer on ``DTensor`` s; returns (out with u's placements,
    the final state [B, H, P, N] with the heads over ``model`` when split)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..models.mamba2 import mamba_block as local_mamba
    from ..models.mamba2 import mamba_dims

    ctx = _ctx()
    ws = [_leaf(params, path) for path in _MAMBA_LEAVES]
    _check(u, *ws)
    md = model_dim(ctx)
    n = len(ctx.all_axes)
    split = _mamba_split(params, md)
    d_inner = mamba_dims(cfg)["d_inner"]
    group = ctx.mesh.get_group(ctx.model_axis)
    u_pl = _row_placements(u, ctx, Replicate())
    w_pl = [settled(w.placements) if split else replicated(n) for w in ws]
    out_pl = with_placement(u_pl, md, Partial() if split else Replicate())
    state_pl = with_placement(u_pl, md, Shard(1) if split else Replicate())
    args, in_pl = [u, *ws], [u_pl, *w_pl]
    if initial_state is not None:
        _check(initial_state)
        args.append(initial_state)
        in_pl.append(state_pl)

    def local(ul, *rest):
        p = _mamba_tree(rest[:len(ws)])
        init = rest[len(ws)] if len(rest) > len(ws) else None
        if not split:
            return local_mamba(p, ul, cfg, init)
        norm = lambda y, scale: split_rms_norm(y, scale, cfg.norm_eps, d_inner, group)  # noqa: E731
        groups = _mamba_groups(ctx, p["dt_bias"].shape[-1], cfg)
        return local_mamba(p, ul, cfg, init, norm=norm, groups=groups)

    out, state = region(local, args, in_pl, (out_pl, state_pl), ctx.mesh)
    return out.redistribute(placements=settled(u.placements)), state


def _local(t) -> torch.Tensor:
    """A ``DTensor`` 's local shard itself (no copy, so that a cache is
    written in place)."""
    with torch.no_grad():
        return t.to_local()


def _shard_offset(t, dim: int, ctx: DistContext) -> Tuple[int, List[int]]:
    """(the global index of this rank's first element along tensor dim
    ``dim`` of ``t``, the mesh dims that split it, major first)."""
    mesh = ctx.mesh
    dims = [k for k, p in enumerate(t.placements) if p.is_shard(dim)]
    index = 0
    for k in dims:
        index = index * int(mesh.shape[k]) + mesh.get_local_rank(k)
    return index * _local(t).shape[dim], dims


def _from_local(local: torch.Tensor, placements, ctx: DistContext, like):
    """A ``DTensor`` of ``local`` shards with ``placements`` and the global
    shape of ``like`` but along its last dim."""
    from torch.distributed.tensor import DTensor

    shape = (*like.shape[:-1], local.shape[-1])
    return DTensor.from_local(local, ctx.mesh, placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _decode_rows(cache_leaf) -> list:
    """The placements of the one-token stream in a decode region: its batch
    split over the DP dims that split the cache's batch, whole over the
    rest."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if p.is_shard(0) else Replicate() for p in cache_leaf.placements]


def mamba_decode_step(params: Dict, u, cache: Dict, cfg: ModelConfig):
    """One token of the Mamba2 mixer on ``DTensor`` s against a cache whose
    SSM heads and conv channels are split as the mixer's weights and the
    cache rules say; the local shards are written in place.  Returns out
    [B, 1, d_model] with u's placements."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Partial, Replicate

    from ..models import mamba2

    ctx = _ctx()
    _check(u, cache["ssm"], cache["conv_x"], cache["conv_bc"])
    md = model_dim(ctx)
    split = _mamba_split(params, md)
    dims = mamba2.mamba_dims(cfg)
    p_dim, n, g = dims["head_dim"], dims["d_state"], dims["n_groups"]
    group = ctx.mesh.get_group(ctx.model_axis)
    rows = _decode_rows(cache["ssm"])
    ul = _local(u.redistribute(placements=rows))[:, 0]
    p = _mamba_tree([_local(w if split else w.redistribute(placements=replicated(len(rows))))
                     for w in (_leaf(params, path) for path in _MAMBA_LEAVES)])
    if any(cache[k].placements[md].is_shard() != split for k in ("ssm", "conv_x")):
        raise NotImplementedError(
            "the SSM state and conv_x cache must be split over model as the mixer's heads are")
    ssm, conv_x, conv_bc = (_local(cache[k]) for k in ("ssm", "conv_x", "conv_bc"))
    b = ul.shape[0]
    z, xr, bc, dt_raw = mamba2.projections(p, ul)
    win_x = mamba2.conv_window(conv_x, xr)
    x = F.silu(mamba2.conv1(win_x, p["conv_x_w"], p["conv_x_b"])).reshape(b, -1, p_dim)
    # B/C: this rank's channels of the window (the cache's shard), convolved
    # with the same slice of the replicated weights, then gathered
    ch0, ch_dims = _shard_offset(cache["conv_bc"], 2, ctx)
    sel = slice(ch0, ch0 + conv_bc.shape[-1])
    win_bc = mamba2.conv_window(conv_bc, bc[:, sel])
    bcc = F.silu(mamba2.conv1(win_bc, p["conv_bc_w"][:, sel], p["conv_bc_b"][sel]))
    if ch_dims:
        bcc = _gather(bcc, [ctx.mesh.get_group(k) for k in ch_dims])
        bcc = bcc.permute(1, 0, 2).reshape(b, -1)
    groups = _mamba_groups(ctx, ssm.shape[1], cfg) if split else None
    B_, C_ = mamba2._split(bcc, g, n, groups)
    state, y = mamba2.ssm_update(p, ssm, x, dt_raw, B_, C_)
    ssm.copy_(state)
    conv_x.copy_(win_x[:, 1:])
    conv_bc.copy_(win_bc[:, 1:])
    y = y.reshape(b, 1, -1).to(ul.dtype)
    norm = None
    if split:
        norm = lambda t, scale: split_rms_norm(  # noqa: E731
            t, scale, cfg.norm_eps, dims["d_inner"], group)
    out = mamba2._gate(y, z[:, None], p, cfg, norm)
    out = _from_local(out, with_placement(rows, md, Partial() if split else Replicate()), ctx, u)
    return out.redistribute(placements=settled(u.placements))


# --------------------------------------------------------- decode attention
def _heads(w, md: int) -> bool:
    return w.placements[md].is_shard()


def decode_attention_block(params: Dict, x, cfg: ModelConfig, cache: Dict, *,
                           cache_index: Optional[int] = None, window: Optional[int] = None,
                           rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """One token of attention on ``DTensor`` s against a cache [B, S, Hkv,
    D] (``cache`` this layer's ``k``/``v``, and the int8 cache's scales)
    whose S dim may be split.  With ``cache_index`` (self-attention) the
    new k/v are written at slot ``cache_index % S`` and the slots are masked
    by the positions they hold; without (whisper's cross cache) q comes
    from x alone and every slot is kept.  Returns out [B, 1, d_model] with
    x's placements."""
    from torch.distributed.tensor import Partial, Replicate

    from ..kernels.decode_attention.ops import (decode_attention, decode_attention_partial,
                                                fold_partials)
    from ..models.attention import dequantize_int8, quantize_int8, ring_positions
    from ..models.layers import apply_rope, dense, dt

    ctx = _ctx()
    _check(x, cache["k"], cache["v"])
    md = model_dim(ctx)
    hd = cfg.head_dim_
    mesh = ctx.mesh
    group = mesh.get_group(ctx.model_axis)
    rows = _decode_rows(cache["k"])
    xl = _local(x.redistribute(placements=rows))
    b = xl.shape[0]
    self_attn = cache_index is not None
    names = ("q", "k", "v", "o") if self_attn else ("q", "o")
    ws = {k: params[k]["w"] for k in names}
    split = {k: _heads(w, md) for k, w in ws.items()}
    wl = {k: _local(w) for k, w in ws.items()}

    def project(name):
        t = dense(xl, {"w": wl[name]}).reshape(b, -1, hd)  # [b, local heads, D]
        if self_attn and name in ("q", "k"):
            t = apply_rope(t[:, None], rope[0][:b], rope[1][:b])[:, 0]
        return t

    # q, k and v of the local heads; those split by heads gathered in one go
    proj = {k: project(k) for k in names if k != "o"}
    parts = [k for k in proj if split[k]]
    if parts:
        g = _gather(torch.cat([proj[k] for k in parts], 1), [group])  # [n, b, heads, D]
        sizes = [proj[k].shape[1] for k in parts]
        for k, t in zip(parts, torch.split(g, sizes, dim=2)):
            proj[k] = t.permute(1, 0, 2, 3).reshape(b, -1, hd)
    q = proj["q"]
    ck, cv = _local(cache["k"]), _local(cache["v"])
    lo, fold_dims = _shard_offset(cache["k"], 1, ctx)
    s_total, s_local = cache["k"].shape[1], ck.shape[1]
    if self_attn:
        k, v = proj["k"], proj["v"]
        slot = cache_index % s_total - lo
        int8 = ck.dtype == torch.int8
        if 0 <= slot < s_local:  # this rank holds the slot
            if int8:
                for name, t in (("k", k), ("v", v)):
                    vals, scale = quantize_int8(t)
                    _local(cache[name])[:, slot] = vals
                    _local(cache[f"{name}_scale"])[:, slot] = scale
            else:
                ck[:, slot] = k.to(ck.dtype)
                cv[:, slot] = v.to(cv.dtype)
        if int8:
            cdt = dt(cfg.compute_dtype)
            ck = dequantize_int8(ck, _local(cache["k_scale"]), cdt)
            cv = dequantize_int8(cv, _local(cache["v_scale"]), cdt)
        pos_q = torch.full((b,), cache_index, dtype=torch.int32, device=xl.device)
        pos_k = ring_positions(cache_index, s_total, b, xl.device, start=lo, count=s_local)
    else:
        pos_q = torch.zeros((b,), dtype=torch.int32, device=xl.device)
        pos_k = torch.zeros((1, s_local), dtype=torch.int32, device=xl.device).expand(b, s_local)
    if fold_dims:
        o, lse = decode_attention_partial(q[:, None], ck, cv, pos_q, pos_k, window=window)
        # every rank's (out, lse) in one gather, [R, b, Hq, D + 1]
        g = _gather(torch.cat([o, lse[..., None]], -1), [mesh.get_group(k) for k in fold_dims])
        attn = fold_partials(g[..., :-1], g[..., -1]).to(q.dtype)
    else:
        attn = decode_attention(q[:, None], ck, cv, pos_q, pos_k, window=window)[:, 0]
    attn = attn.reshape(b, 1, -1)
    if split["o"]:  # the o rows of this rank's heads: a partial sum
        rows_o = wl["o"].shape[0]
        rank = mesh.get_local_rank(ctx.model_axis)
        attn = attn[..., rank * rows_o:(rank + 1) * rows_o]
    out = dense(attn, {"w": wl["o"]})
    out = _from_local(out, with_placement(rows, md, Partial() if split["o"] else Replicate()),
                      ctx, x)
    return out.redistribute(placements=settled(x.placements))


# ---------------------------------------------------------- cross attention
def cross_kv(params: Dict, enc_out, cfg: ModelConfig):
    """A decoder layer's cross-attention K and V [B, F, Hkv, D] of the
    encoder output on ``DTensor`` s: the frames gathered, the kv heads over
    ``model`` where their weights are split (else whole)."""
    from torch.distributed.tensor import Replicate, Shard

    from ..models.attention import precompute_cross_kv

    ctx = _ctx()
    wk, wv = params["k"]["w"], params["v"]["w"]
    _check(enc_out, wk, wv)
    md = model_dim(ctx)
    e_pl = _row_placements(enc_out, ctx, Replicate())
    kv_pl = with_placement(e_pl, md, Shard(2) if _heads(wk, md) else Replicate())

    def local(el, k, v):
        return precompute_cross_kv({"k": {"w": k}, "v": {"w": v}}, el, cfg)

    return region(local, [enc_out, wk, wv], [e_pl, settled(wk.placements),
                                             settled(wv.placements)], (kv_pl, kv_pl), ctx.mesh)


def cross_attention_block(params: Dict, x, kv, cfg: ModelConfig):
    """Teacher-forced cross-attention on ``DTensor`` s: q from x on the q
    heads' split, K/V from :func:`cross_kv`, the flash kernel non-causally
    over the frames, the ``o`` projection a partial sum; returns x's
    placements."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..kernels.flash_attention.ops import flash_attention
    from ..models.layers import dense

    ctx = _ctx()
    wq, wo = params["q"]["w"], params["o"]["w"]
    k, v = kv
    _check(x, wq, wo, k, v)
    md = model_dim(ctx)
    hd = cfg.head_dim_
    heads = _heads(wq, md)
    kv_split = k.placements[md].is_shard()
    kv_slice = None
    if heads and not kv_split:
        hq_l = cfg.n_heads // ctx.model_size
        rank = ctx.mesh.get_local_rank(ctx.model_axis)
        first, count = local_kv_heads(rank, hq_l, cfg.n_heads // cfg.n_kv_heads)
        kv_slice = slice(first, first + count)
    h_pl = _row_placements(x, ctx, Replicate())
    kv_pl = with_placement(settled(k.placements), md, Shard(2) if kv_split else Replicate())
    out_pl = with_placement(h_pl, md, Partial() if heads else Replicate())

    def local(hl, q_w, o_w, kl, vl):
        if kv_slice is not None:
            kl, vl = kl[:, :, kv_slice], vl[:, :, kv_slice]
        b, s, _ = hl.shape
        q = dense(hl, {"w": q_w}).reshape(b, s, -1, hd)
        out = flash_attention(q, kl.contiguous(), vl.contiguous(), causal=False)
        return dense(out.reshape(b, s, -1), {"w": o_w})

    out = region(local, [x, wq, wo, k, v],
                 [h_pl, settled(wq.placements), settled(wo.placements), kv_pl, kv_pl],
                 out_pl, ctx.mesh)
    return out.redistribute(placements=settled(x.placements))
