"""Pattern-based LM for the dense, VLM, SSM and hybrid families: the
counterpart of ``repro.models.transformer``.

Depth is ``n_groups`` repetitions of ``cfg.pattern`` plus an unrolled tail
when depth % pattern != 0, with the per-group parameters stacked on a leading
``groups`` dimension exactly as in the JAX package (so checkpoints cross over
unchanged).  Where JAX scans over the stack, the port loops over its slices,
taken by one ``unbind`` of each stacked leaf a call (so that a leaf's
gradient is one stack of the groups' gradients, as JAX's scan returns it);
with ``remat`` each group is a non-reentrant ``torch.utils.checkpoint``
(only its input is kept; the group is recomputed in the backward pass), as
``jax.checkpoint(body, nothing_saveable)`` does.

"mamba" blocks are the Mamba2 mixer of :mod:`.mamba2` (no MLP).  A
"shared_attn" block (zamba2) applies the ONE parameter set ``params["shared"]``
at every occurrence, each occurrence with its own KV cache.  A "hybrid"
layer (the published Zamba2's) is a Mamba2 layer whose mixer input is
RMSNorm(x + L_i T): T is the ONE shared block of ``params["shared"]`` over
[x ; e], e the embedding output, with call i's LoRA adapters, and L_i call
i's own linear; call i's leaves (its Mamba2 layer, ``linear``, ``lora``)
are stacked on the groups like any position's.  The embedding then rides
along through the groups and remat's checkpoints.  Decode and sharding of
the hybrid kind are not ported (``NotImplementedError``).  "moe" and
"swa_moe" blocks replace the dense MLP with the MoE layer
(``distributed.moe_parallel.moe_maybe_parallel``: :func:`.moe.moe_mlp_local`,
or its expert-parallel body under a mesh) and add its router aux loss to
the model's, which ``forward(return_aux=True)`` returns and ``loss_fn``
weighs in.

Under a ``DistContext`` with ``DTensor`` params and batch (see
:mod:`repro_torch.distributed`) the residual stream is constrained where the
JAX package constrains it (``"residual"`` after the embedding and after each
stacked group, ``"logits"`` on the logits).  The encoder-decoder family is
:mod:`.whisper`.

The KV cache is kept in the compute dtype or, with ``cfg.kv_cache_dtype ==
"int8"``, as int8 with per-token, per-head scales (:mod:`.attention`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import tracing
from ..configs.base import ModelConfig
from ..distributed.context import bind, constrain, is_dtensor
from .attention import (
    attention_block,
    init_attention,
    init_attention_lora,
    init_shared_attention,
    ring_positions,
    shared_attention_block,
)
from .layers import (
    chunked_cross_entropy,
    dense,
    dt,
    generator,
    embed,
    geglu_mlp,
    init_dense,
    init_embedding,
    init_geglu,
    init_lora,
    init_mlp,
    init_rmsnorm,
    mlp,
    rms_norm,
    rope_frequencies,
    unembed,
)
from .mamba2 import init_mamba_block, init_mamba_cache, mamba_block, mamba_decode_step
from .moe import init_moe

PORTED_KINDS = ("attn", "global", "swa", "moe", "swa_moe", "mamba", "shared_attn", "hybrid")
MOE_KINDS = ("moe", "swa_moe")
SWA_KINDS = ("swa", "swa_moe")


def _kind_window(kind: str, cfg: ModelConfig) -> Optional[int]:
    return cfg.sliding_window if kind in SWA_KINDS else None


def _kind_theta(kind: str, cfg: ModelConfig) -> float:
    if kind in SWA_KINDS and cfg.rope_theta_local:
        return cfg.rope_theta_local
    return cfg.rope_theta


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot run yet."""
    missing = sorted(set(cfg.pattern) - set(PORTED_KINDS))
    if missing:
        raise NotImplementedError(f"block kinds {missing} of {cfg.name} are not ported yet")


def _group_slice(tree: Dict, i: int) -> Dict:
    """Slice i of a tree stacked on its leading dim (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _group_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _group_unbind(tree: Dict, n: int) -> List[Dict]:
    """The n slices of a tree stacked on its leading dim (views, no copies),
    each leaf split by one ``unbind``.  Under autograd a leaf's backward is
    then one stack of the n slices' gradients, where n index selects
    (:func:`_group_slice`) would each fill a zero tensor of the whole leaf
    and autograd would add the n of them.  Not for a cache written in place:
    autograd refuses in-place writes to ``unbind``'s outputs."""
    if isinstance(tree, dict):
        parts = {k: _group_unbind(v, n) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return tree.unbind(0)


# ------------------------------------------------------------------- init
def init_block(
    gen: torch.Generator, kind: str, cfg: ModelConfig, lead: Tuple[int, ...] = (), ep: int = 1
) -> Dict:
    """One block's params; ``lead`` stacks them (``(n_groups,)``); MoE
    experts are padded to a multiple of ``ep``."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    pdt = dt(cfg.param_dtype)
    if kind == "mamba":
        return {
            "ln1": init_rmsnorm(cfg.d_model, pdt, gen.device, lead),
            "mamba": init_mamba_block(gen, cfg, lead),
        }
    if kind == "hybrid":  # one call's own leaves: its Mamba2 layer, adapters, linear
        d, r = cfg.d_model, cfg.adapter_rank
        return {
            "ln1": init_rmsnorm(d, pdt, gen.device, lead),
            "mamba": init_mamba_block(gen, cfg, lead),
            "linear": init_dense(gen, d, d, pdt, lead=lead),
            "lora": {
                **init_attention_lora(gen, cfg, lead),
                "gate_up": init_lora(gen, d, 2 * cfg.d_ff, r, pdt, lead),
            },
        }
    block = {
        "ln1": init_rmsnorm(cfg.d_model, pdt, gen.device, lead),
        "attn": init_attention(gen, cfg, lead),
        "ln2": init_rmsnorm(cfg.d_model, pdt, gen.device, lead),
    }
    if kind in MOE_KINDS:
        block["moe"] = init_moe(gen, cfg, lead, ep)
    else:
        block["mlp"] = init_mlp(gen, cfg, lead)
    return block


def init_lm(cfg: ModelConfig, device, seed: int = 0, ep: int = 1) -> Dict:
    """Random params drawn from a generator seeded with ``seed`` on ``device``
    (the experts padded for expert-parallel width ``ep``, as the JAX
    ``init_lm(rng, cfg, ep)``)."""
    check_supported(cfg)
    gen = generator(device, seed)
    pat = cfg.pattern
    g = cfg.n_layers // len(pat)
    tail_kinds = cfg.layer_kinds()[g * len(pat) :]
    params: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg),
        "final_norm": init_rmsnorm(cfg.d_model, dt(cfg.param_dtype), device),
    }
    if g > 0:
        # a shared_attn position has no per-group weights: it lives in
        # params["shared"], as in the JAX tree
        params["groups"] = {
            f"pos{i}": init_block(gen, kind, cfg, lead=(g,), ep=ep)
            for i, kind in enumerate(pat)
            if kind != "shared_attn"
        }
    if "shared_attn" in pat:
        params["shared"] = init_block(gen, "shared_attn", cfg, ep=ep)
    if "hybrid" in pat:
        params["shared"] = init_shared_block(gen, cfg)
    if tail_kinds:
        params["tail"] = {
            f"pos{i}": init_block(gen, kind, cfg, ep=ep) for i, kind in enumerate(tail_kinds)
        }
    return params


def init_shared_block(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    """The hybrid layers' one shared block: RMSNorm over [x ; e] (2
    d_model), attention, RMSNorm, the GELU-gated MLP."""
    pdt = dt(cfg.param_dtype)
    return {
        "ln1": init_rmsnorm(2 * cfg.d_model, pdt, gen.device),
        "attn": init_shared_attention(gen, cfg),
        "ln2": init_rmsnorm(cfg.d_model, pdt, gen.device),
        "mlp": init_geglu(gen, cfg),
    }


# ----------------------------------------------------------------- blocks
def _tables(
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    cache: Optional[Dict] = None,
    cache_index: Optional[int] = None,
) -> Dict:
    """What every layer of one call shares: RoPE cos/sin per theta of the
    attention blocks and, when decoding, the slot positions per distinct KV
    cache length (the SWA ring and the full-length cache)."""
    thetas = {_kind_theta(kind, cfg) for kind in cfg.layer_kinds() if kind != "mamba"}
    tables: Dict[str, Dict] = {
        "rope": {th: rope_frequencies(cfg.head_dim_, positions, th) for th in thetas},
        "slots": {},
    }
    if cache is not None:
        lengths = {
            c["k"].shape[-3] for part in cache.values() for c in part.values() if "k" in c
        }
        tables["slots"] = {
            n: ring_positions(cache_index, n, x.shape[0], x.device) for n in lengths
        }
    return tables


def _shared_call(
    shared: Dict, own: Dict, x: torch.Tensor, emb: torch.Tensor, cfg: ModelConfig, rope
) -> torch.Tensor:
    """L_i T: the shared block over [x ; e] with call i's adapters (no
    residual inside it), then call i's linear; ``own`` holds call i's
    ``lora`` and ``linear``."""
    h = rms_norm(torch.cat([x, emb], dim=-1), shared["ln1"], cfg.norm_eps)
    t = shared_attention_block(shared["attn"], own["lora"], h, cfg, rope)
    t = geglu_mlp(rms_norm(t, shared["ln2"], cfg.norm_eps), shared["mlp"], own["lora"]["gate_up"])
    return dense(t, own["linear"])


def apply_block(
    kind: str,
    bp: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    tables: Dict,
    cache: Optional[Dict] = None,
    cache_index: Optional[int] = None,
    shared: Optional[Dict] = None,
    emb: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Any]:
    """One block; returns (the new residual stream, its MoE aux loss: a
    scalar tensor for an MoE block, else 0.0).  A cache is written in place.
    A hybrid layer reads the ``shared`` block and the embedding ``emb``;
    while ``torch.profiler`` records, its shared call sits in the span
    ``shared`` and its backward in ``shared.bwd``."""
    if kind == "hybrid":
        if cache is not None or is_dtensor(x):
            raise NotImplementedError("decode and sharding of the hybrid kind are not ported")
        own = {"lora": bp["lora"], "linear": bp["linear"]}
        t = tracing.layer("shared", _shared_call, shared, own, x, emb, cfg,
                          tables["rope"][_kind_theta(kind, cfg)])
        h = rms_norm(x + t, bp["ln1"], cfg.norm_eps)
        return x + mamba_block(bp["mamba"], h, cfg)[0], 0.0
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    if kind == "mamba":
        if cache is not None:
            return x + mamba_decode_step(bp["mamba"], h, cache, cfg), 0.0
        return x + mamba_block(bp["mamba"], h, cfg)[0], 0.0
    attn_out, _ = attention_block(
        bp["attn"],
        h,
        positions,
        cfg,
        causal=True,
        window=_kind_window(kind, cfg),
        rope=tables["rope"][_kind_theta(kind, cfg)],
        cache=cache,
        cache_index=cache_index,
        positions_k=tables["slots"][cache["k"].shape[-3]] if cache is not None else None,
    )
    x = x + attn_out
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    if kind in MOE_KINDS:
        from ..distributed.moe_parallel import moe_maybe_parallel

        ff, aux = moe_maybe_parallel(bp["moe"], h, cfg)
        return x + ff, aux
    return x + mlp(h, bp["mlp"], cfg), 0.0


def _apply_pattern(
    x: torch.Tensor,
    gp: Dict,
    kinds: Tuple[str, ...],
    positions: torch.Tensor,
    cfg: ModelConfig,
    tables: Dict,
    shared: Optional[Dict] = None,
    caches: Optional[Dict] = None,
    cache_index: Optional[int] = None,
    emb: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Any]:
    aux = 0.0
    for i, kind in enumerate(kinds):
        # a shared_attn block runs the model's one shared parameter set
        bp = shared if kind == "shared_attn" else gp[f"pos{i}"]
        cache_i = caches[f"pos{i}"] if caches is not None else None
        x, a = apply_block(kind, bp, x, positions, cfg, tables, cache_i, cache_index, shared, emb)
        aux = aux + a
    return x, aux


def _apply_stack(
    params: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    cache: Optional[Dict] = None,
    cache_index: Optional[int] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, Any]:
    """All blocks: the stacked groups in order (each checkpointed with
    ``remat``), then the tail; returns (x, the summed MoE aux loss, 0.0
    without MoE blocks).  With hybrid layers, x on entry is the embedding
    output, which each of them reads."""
    tables = _tables(x, positions, cfg, cache, cache_index)
    shared = params.get("shared")
    pat = cfg.pattern
    g = cfg.n_layers // len(pat)
    emb = x if "hybrid" in pat else None  # what a hybrid layer reads beside x
    aux = 0.0
    # one unbind a leaf, outside the checkpoints: its backward stacks once
    gps = _group_unbind(params["groups"], g) if g else []
    for i, gp in enumerate(gps):
        if remat:
            # bind: the backward pass recomputes the group on the autograd
            # engine's thread, which does not see this one's context
            x, a = checkpoint(
                tracing.recomputed(bind(_apply_pattern)), x, gp, pat, positions, cfg, tables,
                shared, use_reentrant=False, emb=emb,
            )
        else:
            x, a = _apply_pattern(
                x,
                gp,
                pat,
                positions,
                cfg,
                tables,
                shared,
                _group_slice(cache["groups"], i) if cache is not None else None,
                cache_index,
                emb,
            )
        x = constrain(x, "residual")
        aux = aux + a
    tail_kinds = cfg.layer_kinds()[g * len(pat) :]
    if tail_kinds:
        x, a = _apply_pattern(
            x,
            params["tail"],
            tuple(tail_kinds),
            positions,
            cfg,
            tables,
            shared,
            cache["tail"] if cache is not None else None,
            cache_index,
            emb,
        )
        aux = aux + a
    return x, aux


# ---------------------------------------------------------------- forward
def forward(
    params: Dict,
    tokens: torch.Tensor,  # [B, S_text]
    cfg: ModelConfig,
    prefix_embeds: Optional[torch.Tensor] = None,  # [B, P, d] (vlm stub)
    last_only: bool = False,
    return_hidden: bool = False,
    remat: bool = False,
    return_aux: bool = False,
):
    """Teacher-forced forward; returns logits [B, S_total, V].

    ``last_only``: unembed only the final position.  ``return_hidden``: skip
    unembedding and return the final-norm hidden states.  ``remat``:
    checkpoint each stacked group.  ``return_aux``: return (logits or
    hidden, the MoE aux loss summed over the layers), as the JAX function
    always does (an fp32 zero without MoE blocks)."""
    check_supported(cfg)
    x = embed(tokens, params["embed"], cfg)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    x = constrain(x, "residual")
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    x, aux = _apply_stack(params, x, positions, cfg, remat=remat)
    if last_only:
        x = x[:, -1:, :].contiguous()
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    out = x if return_hidden else constrain(unembed(x, params["embed"], cfg), "logits")
    if not return_aux:
        return out
    if not isinstance(aux, torch.Tensor):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return out, aux


def loss_fn(
    params: Dict,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    remat: bool = True,
    ce_chunk: int = 512,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE + router_aux_coef x the MoE aux loss; batch:
    tokens/labels [B, S] (+ optional prefix_embeds, loss_mask).  The CE runs
    chunk by chunk over the sequence, so [B, S, V] logits are never
    materialized.  Returns (loss, {"ce", "aux", "loss"})."""
    hidden, aux = forward(
        params,
        batch["tokens"],
        cfg,
        prefix_embeds=batch.get("prefix_embeds"),
        return_hidden=True,
        remat=remat,
        return_aux=True,
    )
    labels = batch["labels"]
    if hidden.shape[1] != labels.shape[1]:  # vlm: loss only on text positions
        hidden = hidden[:, hidden.shape[1] - labels.shape[1] :]
    ce = chunked_cross_entropy(
        hidden, params["embed"], cfg, labels, batch.get("loss_mask"), ce_chunk
    )
    coef = cfg.moe.router_aux_coef if cfg.moe is not None else 0.0
    loss = ce + coef * aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


# ----------------------------------------------------------------- decode
def _init_block_cache(
    kind: str, cfg: ModelConfig, batch: int, max_len: int, device, lead=()
) -> Dict:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    if kind == "hybrid":
        raise NotImplementedError("decode of the hybrid kind is not ported")
    if kind == "mamba":
        return init_mamba_cache(cfg, batch, device, lead)
    # SWA blocks never attend beyond their window -> a ring buffer of window
    # length (5/6 of gemma3's layers); a shared_attn occurrence keeps a
    # full-length cache of its own
    length = max_len
    if kind in SWA_KINDS:
        length = min(max_len, cfg.sliding_window)
    shape = (*lead, batch, length, cfg.n_kv_heads, cfg.head_dim_)
    if cfg.kv_cache_dtype == "int8":
        # per-token, per-head symmetric int8 with fp32 scales beside it
        scales = (*lead, batch, length, cfg.n_kv_heads)
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(scales, dtype=torch.float32, device=device),
            "v_scale": torch.zeros(scales, dtype=torch.float32, device=device),
        }
    cdt = dt(cfg.compute_dtype)
    return {
        "k": torch.zeros(shape, dtype=cdt, device=device),
        "v": torch.zeros(shape, dtype=cdt, device=device),
    }


def init_lm_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict:
    check_supported(cfg)
    pat = cfg.pattern
    g = cfg.n_layers // len(pat)
    cache: Dict[str, Any] = {}
    if g > 0:
        cache["groups"] = {
            f"pos{i}": _init_block_cache(kind, cfg, batch, max_len, device, (g,))
            for i, kind in enumerate(pat)
        }
    tail_kinds = cfg.layer_kinds()[g * len(pat) :]
    if tail_kinds:
        cache["tail"] = {
            f"pos{i}": _init_block_cache(kind, cfg, batch, max_len, device)
            for i, kind in enumerate(tail_kinds)
        }
    return cache


def decode_step(
    params: Dict,
    cache: Dict,
    tokens: torch.Tensor,  # [B, 1]
    pos_index: int,  # write position in the cache
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict]:
    """One-token decode against the KV/SSM cache; returns (logits [B, 1, V],
    cache).  The cache is updated in place and returned for symmetry with
    the JAX function, which returns a new one."""
    x = embed(tokens, params["embed"], cfg)
    b = x.shape[0]
    positions = torch.full((b, 1), pos_index, dtype=torch.int32, device=x.device)
    x, _ = _apply_stack(params, x, positions, cfg, cache, pos_index)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, params["embed"], cfg), cache
