"""Attention: the counterpart of ``repro.models.attention``.

``gqa_attention`` is the reference semantics (the JAX package's ``impl="ref"``),
kept for the tests.  The multi-token forward (positions ``arange(S)``, so the
kernel's index masks are exact) goes through the hand-written flash-attention
kernels, forward and backward.  A single-token decode step goes through the
hand-written decode-attention kernel, which is given each cache slot's
absolute position, so a sliding-window ring that has wrapped is masked by
position and agrees with ``gqa_attention``.

An int8 KV cache (``cfg.kv_cache_dtype == "int8"``) holds K and V quantised
per token and per head, with their fp32 scales beside them (``k_scale``,
``v_scale``), as the JAX package's does; each step dequantises the whole
cache to the compute dtype and hands it to the decode kernel, as JAX hands
its dequantised cache to the Pallas kernel.

Cross-attention (the encoder-decoder family) runs the same two kernels:
the flash kernel non-causally over the encoder's keys in a teacher-forced
pass, the decode kernel over the cross cache in a decode step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..distributed.context import is_dtensor
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


# ------------------------------------------------------------ int8 cache
def quantize_int8(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last dim: (int8 values, fp32 scales [...]),
    scale = max |t| / 127 floored at 1e-8, values rounded half to even."""
    tf = t.float()
    scale = (tf.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    return torch.round(tf / scale[..., None]).clamp(-127, 127).to(torch.int8), scale


def dequantize_int8(t: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """int8 values times their scales, in fp32, rounded to ``dtype``."""
    return (t.float() * scale.float()[..., None]).to(dtype)


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
    On ``DTensor`` s it runs on each rank's heads
    (:func:`repro_torch.distributed.tensor_parallel.attention_block`), and a
    decode step on each rank's slots of a cache whose sequence dim is split
    (:func:`repro_torch.distributed.tensor_parallel.decode_attention_block`,
    which builds its own slot positions: ``positions_k`` is not read).

    With ``cache``/``cache_index``/``positions_k``: single-token decode -- x
    is [B, 1, d].  Unlike the JAX package, which returns an updated copy, the
    cache tensors are written in place (at ``cache_index % s_cache``, so
    window-length caches act as ring buffers) and the same dict is returned.
    """
    if is_dtensor(x):
        from ..distributed import tensor_parallel

        if cache is not None:
            if cache_index is None or x.shape[1] != 1:
                raise ValueError("cached attention decodes one token at a given cache_index")
            out = tensor_parallel.decode_attention_block(
                params, x, cfg, cache, cache_index=cache_index, window=window, rope=rope)
            return out, cache
        return tensor_parallel.attention_block(
            params, x, positions, cfg, causal=causal, window=window, rope=rope)
    b, s, _ = x.shape
    hd = cfg.head_dim_
    # heads from the weights: a tensor-parallel region holds a share of them
    q = dense(x, params["q"]).reshape(b, s, -1, hd)
    k = dense(x, params["k"]).reshape(b, s, -1, hd)
    v = dense(x, params["v"]).reshape(b, s, -1, hd)
    q = apply_rope(q, *rope)
    k = apply_rope(k, *rope)

    if cache is None:  # positions are arange(S): the kernel masks by index
        out = flash_attention(q, k, v, causal=causal, window=window)
        return dense(out.reshape(b, s, -1), params["o"]), None

    if cache_index is None or positions_k is None or s != 1:
        raise ValueError(
            "cached attention decodes one token at a given cache_index and positions_k"
        )
    write_idx = cache_index % cache["k"].shape[1]
    if cache["k"].dtype == torch.int8:
        cdt = dt(cfg.compute_dtype)
        for name, t in (("k", k), ("v", v)):
            cache[name][:, write_idx], cache[f"{name}_scale"][:, write_idx] = quantize_int8(t[:, 0])
        ck = dequantize_int8(cache["k"], cache["k_scale"], cdt)
        cv = dequantize_int8(cache["v"], cache["v_scale"], cdt)
    else:
        cache["k"][:, write_idx] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, write_idx] = v[:, 0].to(cache["v"].dtype)
        ck, cv = cache["k"], cache["v"]
    out = decode_attention(q, ck, cv, positions[:, 0], positions_k, window=window)
    return dense(out.reshape(b, s, -1), params["o"]), cache


def cross_attention_block(
    params: Dict,
    x: torch.Tensor,  # [B, Sq, d_model]
    enc_kv: Tuple[torch.Tensor, torch.Tensor],  # K, V precomputed [B, Sk, Hkv, D]
    cfg: ModelConfig,
    positions: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Encoder-decoder cross-attention (whisper), K and V precomputed from the
    encoder output.  No RoPE and no mask: the JAX package puts every query
    and every key at position 0 and attends non-causally.  A teacher-forced
    x goes through the flash kernel (non-causal, Sq != Sk); a decode step
    passes ``positions`` = (positions_q [B], positions_k [B, Sk]), all 0, and
    goes through the decode kernel, which then keeps every slot.  On
    ``DTensor`` s both run on each rank's heads, a decode step on each
    rank's frames of a split cross cache (``positions`` then only marks the
    step)."""
    if is_dtensor(x):
        from ..distributed import tensor_parallel

        if positions is None:
            return tensor_parallel.cross_attention_block(params, x, enc_kv, cfg)
        k, v = enc_kv
        return tensor_parallel.decode_attention_block(params, x, cfg, {"k": k, "v": v})
    b, s, _ = x.shape
    hd = cfg.head_dim_
    q = dense(x, params["q"]).reshape(b, s, cfg.n_heads, hd)
    k, v = enc_kv
    if positions is None:
        out = flash_attention(q, k, v, causal=False)
    else:
        out = decode_attention(q, k, v, *positions)
    return dense(out.reshape(b, s, cfg.n_heads * hd), params["o"])


def precompute_cross_kv(
    params: Dict, enc_out: torch.Tensor, cfg: ModelConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross-attention K and V [B, Sk, Hkv, D] from the
    encoder output [B, Sk, d_model] (on ``DTensor`` s, the kv heads on their
    weights' split: :func:`repro_torch.distributed.tensor_parallel.cross_kv`)."""
    if is_dtensor(enc_out):
        from ..distributed import tensor_parallel

        return tensor_parallel.cross_kv(params, enc_out, cfg)
    b, sk, _ = enc_out.shape
    hd = cfg.head_dim_
    # heads from the weights: a tensor-parallel region holds a share of them
    k = dense(enc_out, params["k"]).reshape(b, sk, -1, hd)
    v = dense(enc_out, params["v"]).reshape(b, sk, -1, hd)
    return k, v


def ring_positions(cache_index: int, s_cache: int, batch: int, device, start: int = 0,
                   count: Optional[int] = None) -> torch.Tensor:
    """[B, count] int32: the absolute position each of the slots [start,
    start + count) of a cache of ``s_cache`` slots holds once position
    ``cache_index`` is written at ``cache_index % s_cache`` (all of them by
    default; a rank of a cache split on its slots asks for its range).

    Slot j holds pos - ((pos - j) mod s_cache); never-written slots resolve
    to negative positions, which the decode kernel masks."""
    count = s_cache - start if count is None else count
    slots = torch.arange(start, start + count, device=device, dtype=torch.int32)
    positions_k = cache_index - torch.remainder(cache_index - slots, s_cache)
    return positions_k[None].expand(batch, count)


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
