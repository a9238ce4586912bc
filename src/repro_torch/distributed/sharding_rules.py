"""Parameter / optimizer / batch / cache sharding rules: the counterpart of
``repro.distributed.sharding_rules``, with the same rules over the same
tree (the JAX key paths, per-layer leaves stacked on a leading ``groups`` /
``encoder`` / ``decoder`` dim).

The layout:
  * TP over ``model``: Megatron column/row split of attention + MLP,
    vocab-sharded embeddings, head-sharded Mamba projections, EP for MoE
    experts;
  * DP over ``data`` (and ``pod``): batch dims; ZeRO-1 -- optimizer moments
    and fp32 masters additionally sharded over the DP axes;
  * SP: residual-stream sequence dim over ``model`` between blocks (applied
    via ``distributed.context.constrain``);
  * anything that does not divide evenly is replicated (never errors).

Rules read only the leaves' shapes, so they apply alike to live tensors and
to meta tensors.  A spec is a tuple with one entry per dim (see
:mod:`.context`); :func:`distribute_tree` makes a tree of ``DTensor`` s
from a tree of full tensors and its specs, and :func:`gather_tree` gives
the full tensors back, so checkpoints keep the JAX tree.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from ..configs.base import ModelConfig
from .context import DistContext, full_tensor, is_dtensor

#: tree prefixes that stack per-layer params with one leading dim
_STACKED_KEYS = ("groups", "encoder", "decoder")


def tree_map_with_path(fn: Callable[[Tuple[str, ...], Any], Any], tree: Any, path=()) -> Any:
    """``fn(key path, leaf)`` over a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _dp(axes) -> Any:
    """Spec entry for the DP axes: a single axis stays a bare name."""
    axes = tuple(axes)
    return axes[0] if len(axes) == 1 else axes


def _param_rule(
    names: Tuple[str, ...], shape: Tuple[int, ...], cfg: ModelConfig, ms: int
) -> Tuple[Optional[Any], ...]:
    """Spec for the UNSTACKED shape."""
    m = "model"
    last = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    gparent = names[-3] if len(names) >= 3 else ""

    if parent == "embed" or (last in ("table", "lm_head")):
        if last == "table":
            return (m, None) if _div(shape[0], ms) else (None, None)
        if last == "lm_head":
            return (None, m) if _div(shape[1], ms) else (None, None)

    if gparent in ("attn", "self_attn", "cross_attn") and last == "w":
        if parent == "q":
            ok = _div(cfg.n_heads, ms)
            return (None, m) if ok else (None, None)
        if parent in ("k", "v"):
            ok = _div(cfg.n_kv_heads, ms)
            return (None, m) if ok else (None, None)
        if parent == "o":
            ok = _div(cfg.n_heads, ms)
            return (m, None) if ok else (None, None)

    if gparent == "mlp" and last == "w":
        if parent in ("gate", "up"):
            return (None, m) if _div(shape[1], ms) else (None, None)
        if parent == "down":
            return (m, None) if _div(shape[0], ms) else (None, None)

    if parent == "moe" and last in ("gate", "up", "down"):
        # [E_pad, d_in, d_out] -- expert parallelism (E_pad divides by design)
        return (m, None, None) if _div(shape[0], ms) else (None, None, None)
    if gparent == "moe" and parent == "router":
        return tuple(None for _ in shape)

    if gparent == "mamba" and last == "w":
        if parent in ("z_proj", "x_proj", "dt_proj"):
            return (None, m) if _div(shape[1], ms) else (None, None)
        if parent == "out_proj":
            return (m, None) if _div(shape[0], ms) else (None, None)
        if parent == "bc_proj":
            return (None, None)
    if parent == "mamba":
        if last == "conv_x_w":
            return (None, m) if _div(shape[1], ms) else (None, None)
        if last == "conv_x_b":
            return (m,) if _div(shape[0], ms) else (None,)
        if last in ("conv_bc_w", "conv_bc_b"):
            return tuple(None for _ in shape)
        if last in ("A_log", "D", "dt_bias"):
            return (m,) if _div(shape[0], ms) else (None,)
    if parent == "gate_norm" and last == "scale":
        return (m,) if _div(shape[0], ms) else (None,)

    # norms and anything unmatched: replicated
    return tuple(None for _ in shape)


def param_specs(params: Any, cfg: ModelConfig, ctx: DistContext) -> Any:
    if "hybrid" in cfg.pattern:
        raise NotImplementedError("the hybrid kind has no sharding rules")
    ms = ctx.model_size

    def rule(names, leaf):
        nlead = 1 if any(n in _STACKED_KEYS for n in names) else 0
        base = _param_rule(names, tuple(leaf.shape[nlead:]), cfg, ms)
        return (None,) * nlead + tuple(base)

    return tree_map_with_path(rule, params)


def opt_specs(opt_state: Any, p_specs: Any, cfg: ModelConfig, ctx: DistContext) -> Any:
    """ZeRO-1: moments/masters get the param spec plus DP sharding on the
    first still-unsharded divisible dim."""
    bt = ctx.batch_size_total
    dp = _dp(ctx.batch_axes)

    def zero(path, leaf):
        spec = _get(p_specs, path)
        elems = list(spec) + [None] * (len(leaf.shape) - len(spec))
        for i, (e, dim) in enumerate(zip(elems, leaf.shape)):
            if e is None and _div(dim, bt):
                elems[i] = dp
                break
        return tuple(elems)

    out: Dict[str, Any] = {"step": ()}
    for key in ("m", "v", "master"):
        if key in opt_state:
            out[key] = tree_map_with_path(zero, opt_state[key])
    return out


def _get(tree: Any, path: Tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def batch_specs(
    spec_dict: Dict[str, Tuple[Tuple[int, ...], Any]], ctx: DistContext
) -> Dict[str, Tuple]:
    """Batch inputs ``{name: (shape, dtype)}`` (a model's ``batch_spec``):
    the batch dim over the DP axes when it divides."""
    bt = ctx.batch_size_total
    out = {}
    for name, (shape, _) in spec_dict.items():
        batch = _dp(ctx.batch_axes) if _div(shape[0], bt) else None
        out[name] = (batch, *([None] * (len(shape) - 1)))
    return out


def cache_specs(cache: Any, cfg: ModelConfig, ctx: DistContext) -> Any:
    """KV/SSM cache sharding for decode.

    KV: [(L,)? B, S, Hkv, D] -- batch over DP; the S dim over model (and
    over DP too when the batch doesn't divide, e.g. long_500k's B=1).
    SSM state: [(L,)? B, H, P, N] -- batch over DP, heads over model.
    """
    bt = ctx.batch_size_total
    ms = ctx.model_size
    m = ctx.model_axis

    def kv_seq(b_dim, s_dim):
        batch = _dp(ctx.batch_axes) if _div(b_dim, bt) else None
        if batch is None and _div(s_dim, bt * ms):
            seq = tuple(ctx.batch_axes) + (m,)
        elif _div(s_dim, ms):
            seq = m
        else:
            seq = None
        return batch, seq

    def rule(names, leaf):
        last = names[-1]
        shape = leaf.shape
        if last in ("k_scale", "v_scale"):
            # [(L,)? B, S, Hkv] -- shard like the cache minus the head dim
            return ((None,) * (len(shape) - 3)) + (*kv_seq(shape[-3], shape[-2]), None)
        if last in ("k", "v"):
            return ((None,) * (len(shape) - 4)) + (*kv_seq(shape[-4], shape[-3]), None, None)
        if last == "ssm":
            batch = _dp(ctx.batch_axes) if _div(shape[-4], bt) else None
            heads = m if _div(shape[-3], ms) else None
            return ((None,) * (len(shape) - 4)) + (batch, heads, None, None)
        if last in ("conv_x", "conv_bc"):
            batch = _dp(ctx.batch_axes) if _div(shape[-3], bt) else None
            ch = m if _div(shape[-1], ms) else None
            return ((None,) * (len(shape) - 3)) + (batch, None, ch)
        return tuple(None for _ in shape)

    return tree_map_with_path(rule, cache)


# ------------------------------------------------------------ DTensor trees
def distribute_tree(tree: Any, specs: Any, ctx: DistContext) -> Any:
    """A tree of ``DTensor`` s on ``ctx.mesh`` with the placements of
    ``specs``: a full tensor is split locally (every rank holds the same
    full tensor, as every rank that draws or reads the same weights does;
    nothing is sent), a ``DTensor`` is redistributed."""
    from torch.distributed.tensor import distribute_tensor

    def leaf(path, t):
        pl = ctx.placements(_get(specs, path))
        if is_dtensor(t):
            return t.redistribute(placements=pl)
        return distribute_tensor(t.detach(), ctx.mesh, pl, src_data_rank=None)

    return tree_map_with_path(leaf, tree)


def gather_tree(tree: Any) -> Any:
    """The full tensors of a tree of ``DTensor`` s (plain leaves as they
    are), on every rank."""
    return tree_map_with_path(lambda _, t: full_tensor(t), tree)
