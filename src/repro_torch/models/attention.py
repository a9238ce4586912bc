"""Attention: the counterpart of ``repro.models.attention``.

``gqa_attention`` is the reference semantics (the JAX package's ``impl="ref"``),
kept for the tests.  The multi-token forward (positions ``arange(S)``, so the
kernel's index masks are exact) goes through the hand-written flash-attention
kernels, forward and backward.  A single-token decode step goes through the
hand-written decode-attention kernel, which is given each cache slot's
absolute position, so a sliding-window ring that has wrapped is masked by
position and agrees with ``gqa_attention``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..kernels.decode_attention.ops import decode_attention
from ..kernels.flash_attention.ops import flash_attention
from .layers import apply_rope, dense, dt, init_dense

NEG_INF = -(2.0**30)


# ---------------------------------------------------------------- params
def init_attention(
    gen: torch.Generator, cfg: ModelConfig, lead: Tuple[int, ...] = ()
) -> Dict:
    d, hd = cfg.d_model, cfg.head_dim_
    pdt = dt(cfg.param_dtype)
    return {
        "q": init_dense(gen, d, cfg.n_heads * hd, pdt, lead=lead),
        "k": init_dense(gen, d, cfg.n_kv_heads * hd, pdt, lead=lead),
        "v": init_dense(gen, d, cfg.n_kv_heads * hd, pdt, lead=lead),
        "o": init_dense(gen, cfg.n_heads * hd, d, pdt, lead=lead),
    }


# ------------------------------------------------------------- core math
def gqa_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    positions_q: torch.Tensor,  # [B, Sq]
    positions_k: torch.Tensor,  # [B, Sk]
    causal: bool = True,
    window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,  # [B, Sk] bool
) -> torch.Tensor:
    """Grouped-query attention with fp32 softmax; returns [B, Sq, Hq, D]."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    q = q.reshape(b, sq, hkv, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * d**-0.5
    dpos = positions_q[:, :, None] - positions_k[:, None, :]
    mask = torch.ones((b, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= dpos >= 0
    if window is not None:
        mask &= dpos < window
    if kv_valid is not None:
        mask &= kv_valid[:, None, :]
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, d)


# ------------------------------------------------------------ block apply
def attention_block(
    params: Dict,
    x: torch.Tensor,  # [B, S, d_model]
    positions: torch.Tensor,  # [B, S] int32
    cfg: ModelConfig,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    rope: Tuple[torch.Tensor, torch.Tensor],  # cos, sin [B, S, D//2] for positions
    cache: Optional[Dict] = None,
    cache_index: Optional[int] = None,
    positions_k: Optional[torch.Tensor] = None,  # [B, s_cache]: ring_positions
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full attention sub-block: qkv proj -> rope -> attention -> out proj.

    With ``cache``/``cache_index``/``positions_k``: single-token decode -- x
    is [B, 1, d].  Unlike the JAX package, which returns an updated copy, the
    cache tensors are written in place (at ``cache_index % s_cache``, so
    window-length caches act as ring buffers) and the same dict is returned.
    """
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q = dense(x, params["q"]).reshape(b, s, cfg.n_heads, hd)
    k = dense(x, params["k"]).reshape(b, s, cfg.n_kv_heads, hd)
    v = dense(x, params["v"]).reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, *rope)
    k = apply_rope(k, *rope)

    if cache is None:  # positions are arange(S): the kernel masks by index
        out = flash_attention(q, k, v, causal=causal, window=window)
        return dense(out.reshape(b, s, cfg.n_heads * hd), params["o"]), None

    if cache_index is None or positions_k is None or s != 1:
        raise ValueError(
            "cached attention decodes one token at a given cache_index and positions_k"
        )
    if cache["k"].dtype == torch.int8:
        raise NotImplementedError("the int8 KV cache is not ported yet")
    write_idx = cache_index % cache["k"].shape[1]
    cache["k"][:, write_idx] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, write_idx] = v[:, 0].to(cache["v"].dtype)
    out = decode_attention(
        q, cache["k"], cache["v"], positions[:, 0], positions_k, window=window
    )
    return dense(out.reshape(b, s, cfg.n_heads * hd), params["o"]), cache


def ring_positions(cache_index: int, s_cache: int, batch: int, device) -> torch.Tensor:
    """[B, s_cache] int32: the absolute position each slot of a cache holds
    once position ``cache_index`` is written at ``cache_index % s_cache``.

    Slot j holds pos - ((pos - j) mod s_cache); never-written slots resolve
    to negative positions, which the decode kernel masks."""
    slots = torch.arange(s_cache, device=device, dtype=torch.int32)
    positions_k = cache_index - torch.remainder(cache_index - slots, s_cache)
    return positions_k[None].expand(batch, s_cache)


def init_kv_cache(
    cfg: ModelConfig, batch: int, max_len: int, n_layers: int, device, dtype=None
) -> Dict:
    """Per-layer KV cache: leaves [L, B, max_len, Hkv, D]."""
    dtype = dtype or dt(cfg.compute_dtype)
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }
