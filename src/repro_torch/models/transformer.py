"""Pattern-based LM for the dense, VLM, SSM and hybrid families: the
counterpart of ``repro.models.transformer``.

Depth is ``n_groups`` repetitions of ``cfg.pattern`` plus an unrolled tail
when depth % pattern != 0, with the per-group parameters stacked on a leading
``groups`` dimension exactly as in the JAX package (so checkpoints cross over
unchanged).  Where JAX scans over the stack, the port loops over its slices;
with ``remat`` each group is a non-reentrant ``torch.utils.checkpoint``
(only its input is kept; the group is recomputed in the backward pass), as
``jax.checkpoint(body, nothing_saveable)`` does.

"mamba" blocks are the Mamba2 mixer of :mod:`.mamba2` (no MLP).  A
"shared_attn" block (zamba2) applies the ONE parameter set ``params["shared"]``
at every occurrence, each occurrence with its own KV cache.  MoE blocks and
the encoder-decoder family are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .attention import attention_block, init_attention, ring_positions
from .layers import (
    chunked_cross_entropy,
    dt,
    embed,
    init_embedding,
    init_mlp,
    init_rmsnorm,
    mlp,
    rms_norm,
    rope_frequencies,
    unembed,
)
from .mamba2 import init_mamba_block, init_mamba_cache, mamba_block, mamba_decode_step

PORTED_KINDS = ("attn", "global", "swa", "mamba", "shared_attn")


def _kind_window(kind: str, cfg: ModelConfig) -> Optional[int]:
    return cfg.sliding_window if kind == "swa" else None


def _kind_theta(kind: str, cfg: ModelConfig) -> float:
    if kind == "swa" and cfg.rope_theta_local:
        return cfg.rope_theta_local
    return cfg.rope_theta


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot run yet."""
    if cfg.family == "encdec":
        raise NotImplementedError("the encoder-decoder family is not ported yet")
    missing = sorted(set(cfg.pattern) - set(PORTED_KINDS))
    if missing:
        raise NotImplementedError(f"block kinds {missing} of {cfg.name} are not ported yet")


def _group_slice(tree: Dict, i: int) -> Dict:
    """Slice i of a tree stacked on its leading dim (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _group_slice(v, i) for k, v in tree.items()}
    return tree[i]


# ------------------------------------------------------------------- init
def init_block(
    gen: torch.Generator, kind: str, cfg: ModelConfig, lead: Tuple[int, ...] = ()
) -> Dict:
    """One block's params; ``lead`` stacks them (``(n_groups,)``)."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    pdt = dt(cfg.param_dtype)
    if kind == "mamba":
        return {
            "ln1": init_rmsnorm(cfg.d_model, pdt, gen.device, lead),
            "mamba": init_mamba_block(gen, cfg, lead),
        }
    return {
        "ln1": init_rmsnorm(cfg.d_model, pdt, gen.device, lead),
        "attn": init_attention(gen, cfg, lead),
        "ln2": init_rmsnorm(cfg.d_model, pdt, gen.device, lead),
        "mlp": init_mlp(gen, cfg, lead),
    }


def init_lm(cfg: ModelConfig, device, seed: int = 0) -> Dict:
    """Random params drawn from a generator seeded with ``seed`` on ``device``."""
    check_supported(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
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
            f"pos{i}": init_block(gen, kind, cfg, lead=(g,))
            for i, kind in enumerate(pat)
            if kind != "shared_attn"
        }
    if "shared_attn" in pat:
        params["shared"] = init_block(gen, "shared_attn", cfg)
    if tail_kinds:
        params["tail"] = {
            f"pos{i}": init_block(gen, kind, cfg) for i, kind in enumerate(tail_kinds)
        }
    return params


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


def apply_block(
    kind: str,
    bp: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    tables: Dict,
    cache: Optional[Dict] = None,
    cache_index: Optional[int] = None,
) -> torch.Tensor:
    """One block; returns the new residual stream (a cache is written in
    place)."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    if kind == "mamba":
        if cache is not None:
            return x + mamba_decode_step(bp["mamba"], h, cache, cfg)
        return x + mamba_block(bp["mamba"], h, cfg)[0]
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
    return x + mlp(h, bp["mlp"], cfg)


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
) -> torch.Tensor:
    for i, kind in enumerate(kinds):
        # a shared_attn block runs the model's one shared parameter set
        bp = shared if kind == "shared_attn" else gp[f"pos{i}"]
        cache_i = caches[f"pos{i}"] if caches is not None else None
        x = apply_block(kind, bp, x, positions, cfg, tables, cache_i, cache_index)
    return x


def _apply_stack(
    params: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    cache: Optional[Dict] = None,
    cache_index: Optional[int] = None,
    remat: bool = False,
) -> torch.Tensor:
    """All blocks: the stacked groups in order (each checkpointed with
    ``remat``), then the tail."""
    tables = _tables(x, positions, cfg, cache, cache_index)
    shared = params.get("shared")
    pat = cfg.pattern
    g = cfg.n_layers // len(pat)
    for i in range(g):
        gp = _group_slice(params["groups"], i)
        if remat:
            x = checkpoint(
                _apply_pattern, x, gp, pat, positions, cfg, tables, shared, use_reentrant=False
            )
            continue
        x = _apply_pattern(
            x,
            gp,
            pat,
            positions,
            cfg,
            tables,
            shared,
            _group_slice(cache["groups"], i) if cache is not None else None,
            cache_index,
        )
    tail_kinds = cfg.layer_kinds()[g * len(pat) :]
    if tail_kinds:
        x = _apply_pattern(
            x,
            params["tail"],
            tuple(tail_kinds),
            positions,
            cfg,
            tables,
            shared,
            cache["tail"] if cache is not None else None,
            cache_index,
        )
    return x


# ---------------------------------------------------------------- forward
def forward(
    params: Dict,
    tokens: torch.Tensor,  # [B, S_text]
    cfg: ModelConfig,
    prefix_embeds: Optional[torch.Tensor] = None,  # [B, P, d] (vlm stub)
    last_only: bool = False,
    return_hidden: bool = False,
    remat: bool = False,
) -> torch.Tensor:
    """Teacher-forced forward; returns logits [B, S_total, V].

    ``last_only``: unembed only the final position.  ``return_hidden``: skip
    unembedding and return the final-norm hidden states.  ``remat``:
    checkpoint each stacked group.  (The JAX function also returns an MoE aux
    loss, which is always 0 for these families.)"""
    check_supported(cfg)
    x = embed(tokens, params["embed"], cfg)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
    x = _apply_stack(params, x, positions, cfg, remat=remat)
    if last_only:
        x = x[:, -1:, :].contiguous()
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x
    return unembed(x, params["embed"], cfg)


def loss_fn(
    params: Dict,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    remat: bool = True,
    ce_chunk: int = 512,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE (+ MoE aux, 0 for these families); batch: tokens/labels
    [B, S] (+ optional prefix_embeds, loss_mask).  The CE runs chunk by
    chunk over the sequence, so [B, S, V] logits are never materialized.
    Returns (loss, {"ce", "aux", "loss"})."""
    hidden = forward(
        params,
        batch["tokens"],
        cfg,
        prefix_embeds=batch.get("prefix_embeds"),
        return_hidden=True,
        remat=remat,
    )
    labels = batch["labels"]
    if hidden.shape[1] != labels.shape[1]:  # vlm: loss only on text positions
        hidden = hidden[:, hidden.shape[1] - labels.shape[1] :]
    ce = chunked_cross_entropy(
        hidden, params["embed"], cfg, labels, batch.get("loss_mask"), ce_chunk
    )
    aux = torch.zeros((), dtype=torch.float32, device=ce.device)
    coef = cfg.moe.router_aux_coef if cfg.moe is not None else 0.0
    loss = ce + coef * aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}


# ----------------------------------------------------------------- decode
def _init_block_cache(
    kind: str, cfg: ModelConfig, batch: int, max_len: int, device, lead=()
) -> Dict:
    if kind not in PORTED_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    if kind == "mamba":
        return init_mamba_cache(cfg, batch, device, lead)
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError("the int8 KV cache is not ported yet")
    # SWA blocks never attend beyond their window -> a ring buffer of window
    # length (5/6 of gemma3's layers); a shared_attn occurrence keeps a
    # full-length cache of its own
    length = max_len
    if kind == "swa":
        length = min(max_len, cfg.sliding_window)
    shape = (*lead, batch, length, cfg.n_kv_heads, cfg.head_dim_)
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
    x = _apply_stack(params, x, positions, cfg, cache, pos_index)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, params["embed"], cfg), cache
