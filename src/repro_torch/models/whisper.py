"""Whisper-style encoder-decoder backbone: the counterpart of
``repro.models.whisper``.

As in the JAX package, the audio frontend is a stub: the model takes
precomputed frame embeddings [B, n_frames, d_model].  The encoder is
bidirectional with RoPE on the frame index; each decoder layer runs causal
self-attention, cross-attention over the encoder output and the MLP.  The
parameter tree is the JAX package's (``embed``, ``encoder`` stacked on
``n_enc_layers``, ``enc_norm``, ``decoder`` stacked on ``n_layers``,
``final_norm``), so checkpoint DUs cross over unchanged.  Where JAX scans
over a stack, the port loops over its slices; with ``remat`` each encoder
and each decoder layer is a non-reentrant ``torch.utils.checkpoint``, as
``jax.checkpoint(body, nothing_saveable)`` is, and a decoder layer
recomputes its cross K/V from the encoder output.

Every attention runs the flash kernel in a teacher-forced pass (the
encoder's non-causally, cross-attention non-causally over Sk != Sq) and
the decode kernel in a decode step; every norm runs the rmsnorm kernel.
The decode cache holds a ``max_len`` self-attention cache (global, masked
by slot position) and the cross K/V that :func:`prefill_cross_cache`
fills once per request; both are updated in place.

Under a mesh (``DTensor`` params, batch and cache) the layers run as the
regions of :mod:`repro_torch.distributed.tensor_parallel`: the encoder's
non-causal attention and every MLP on the heads' / columns' split, the
cross-attention on its own region, and a decode step against self and
cross caches whose sequence dim is split as the cache rules say.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed.context import bind, constrain, is_dtensor
from .attention import (
    attention_block,
    cross_attention_block,
    init_attention,
    precompute_cross_kv,
    ring_positions,
)
from .layers import (
    chunked_cross_entropy,
    dt,
    generator,
    embed,
    init_embedding,
    init_mlp,
    init_rmsnorm,
    mlp,
    rms_norm,
    rope_frequencies,
    unembed,
)
from .transformer import _group_slice


def _enc(cfg: ModelConfig):
    if cfg.encdec is None:
        raise ValueError(f"{cfg.name} is not an encoder-decoder model")
    return cfg.encdec


# ------------------------------------------------------------------- init
def init_encdec(cfg: ModelConfig, device, seed: int = 0) -> Dict:
    """Random params drawn from a generator seeded with ``seed`` on ``device``."""
    e = _enc(cfg)
    gen = generator(device, seed)
    pdt = dt(cfg.param_dtype)
    d = cfg.d_model

    def norm(lead=()):
        return init_rmsnorm(d, pdt, device, lead)

    enc, dec = (e.n_enc_layers,), (cfg.n_layers,)
    return {
        "embed": init_embedding(gen, cfg),
        "encoder": {"ln1": norm(enc), "attn": init_attention(gen, cfg, enc), "ln2": norm(enc),
                    "mlp": init_mlp(gen, cfg, enc)},
        "enc_norm": norm(),
        "decoder": {"ln1": norm(dec), "self_attn": init_attention(gen, cfg, dec),
                    "ln_x": norm(dec), "cross_attn": init_attention(gen, cfg, dec),
                    "ln2": norm(dec), "mlp": init_mlp(gen, cfg, dec)},
        "final_norm": norm(),
    }


def _arange_positions(x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    return torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)


# ---------------------------------------------------------------- encoder
def _enc_layer(x, lp, positions, rope, cfg):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    out, _ = attention_block(lp["attn"], h, positions, cfg, causal=False, rope=rope)
    x = x + out
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp(h, lp["mlp"], cfg)


def encode(params: Dict, frames: torch.Tensor, cfg: ModelConfig, remat: bool = False) -> torch.Tensor:
    """frames [B, F, d_model] (the stub frontend's output) -> the encoder's
    final-norm states [B, F, d_model]."""
    x = constrain(frames.to(dt(cfg.compute_dtype)), "batch")
    positions = _arange_positions(x)
    rope = rope_frequencies(cfg.head_dim_, positions, cfg.rope_theta)
    for i in range(_enc(cfg).n_enc_layers):
        lp = _group_slice(params["encoder"], i)
        if remat:
            # bind: the recompute runs on autograd's thread, which does not
            # see this one's distribution context
            x = checkpoint(bind(_enc_layer), x, lp, positions, rope, cfg, use_reentrant=False)
        else:
            x = _enc_layer(x, lp, positions, rope, cfg)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


# ---------------------------------------------------------------- decoder
def _dec_layer(x, lp, enc_out, positions, rope, cfg):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    out, _ = attention_block(lp["self_attn"], h, positions, cfg, causal=True, rope=rope)
    x = x + out
    h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
    kv = precompute_cross_kv(lp["cross_attn"], enc_out, cfg)
    x = x + cross_attention_block(lp["cross_attn"], h, kv, cfg)
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return constrain(x + mlp(h, lp["mlp"], cfg), "residual")


def forward(
    params: Dict,
    frames: torch.Tensor,  # [B, F, d_model]
    tokens: torch.Tensor,  # [B, S]
    cfg: ModelConfig,
    last_only: bool = False,
    return_hidden: bool = False,
    remat: bool = False,
    return_aux: bool = False,
):
    """Teacher-forced encoder-decoder forward; returns logits [B, S, V] (the
    final-norm hidden states with ``return_hidden``; only the last position
    with ``last_only``), and with ``return_aux`` (that, an fp32 zero), as
    the JAX function always returns."""
    enc_out = encode(params, frames, cfg, remat=remat)
    x = constrain(embed(tokens, params["embed"], cfg), "residual")
    positions = _arange_positions(x)
    rope = rope_frequencies(cfg.head_dim_, positions, cfg.rope_theta)
    for i in range(cfg.n_layers):
        lp = _group_slice(params["decoder"], i)
        if remat:
            x = checkpoint(bind(_dec_layer), x, lp, enc_out, positions, rope, cfg,
                           use_reentrant=False)
        else:
            x = _dec_layer(x, lp, enc_out, positions, rope, cfg)
    if last_only:
        x = x[:, -1:, :].contiguous()
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    out = x if return_hidden else constrain(unembed(x, params["embed"], cfg), "logits")
    if not return_aux:
        return out
    return out, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(
    params: Dict,
    batch: Dict[str, torch.Tensor],
    cfg: ModelConfig,
    remat: bool = True,
    ce_chunk: int = 512,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE; batch: frames [B, F, d], tokens/labels [B, S] (+
    optional loss_mask).  Returns (loss, {"ce", "aux" (0), "loss"})."""
    hidden = forward(params, batch["frames"], batch["tokens"], cfg, return_hidden=True, remat=remat)
    ce = chunked_cross_entropy(
        hidden, params["embed"], cfg, batch["labels"], batch.get("loss_mask"), ce_chunk
    )
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32, device=ce.device), "loss": ce}


# ----------------------------------------------------------------- decode
def init_encdec_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> Dict[str, Any]:
    """Zero self caches [L, B, max_len, Hkv, D] and cross caches [L, B,
    n_frames, Hkv, D] in the compute dtype, as the JAX package's."""
    cdt = dt(cfg.compute_dtype)
    shapes = {"self": max_len, "cross": _enc(cfg).n_frames}
    return {
        part: {
            name: torch.zeros((cfg.n_layers, batch, n, cfg.n_kv_heads, cfg.head_dim_),
                              dtype=cdt, device=device)
            for name in ("k", "v")
        }
        for part, n in shapes.items()
    }


def prefill_cross_cache(params: Dict, frames: torch.Tensor, cache: Dict, cfg: ModelConfig) -> Dict:
    """Encode ``frames`` and write every decoder layer's cross K/V into the
    cache (in place, once per request); returns the cache."""
    enc_out = encode(params, frames, cfg)
    for i in range(cfg.n_layers):
        kv = precompute_cross_kv(_group_slice(params["decoder"], i)["cross_attn"], enc_out, cfg)
        for name, t in zip(("k", "v"), kv):
            dst = cache["cross"][name][i]
            if is_dtensor(dst):  # into this rank's shard, laid out as the cache is
                with torch.no_grad():
                    dst.to_local().copy_(t.redistribute(placements=dst.placements).to_local())
            else:
                dst.copy_(t)
    return {"self": cache["self"], "cross": cache["cross"]}


@functools.lru_cache(maxsize=8)
def _cross_positions(batch: int, n_frames: int, device: torch.device):
    """(positions_q [B], positions_k [B, F]) of cross-attention in a decode
    step: all 0, so the decode kernel keeps every frame.  Built once per
    shape and device and only ever read."""
    pos_q = torch.zeros((batch,), dtype=torch.int32, device=device)
    return pos_q, torch.zeros((n_frames,), dtype=torch.int32, device=device)[None].expand(
        batch, n_frames)


def decode_step(
    params: Dict,
    cache: Dict,
    tokens: torch.Tensor,  # [B, 1]
    pos_index: int,  # write position in the self cache
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict]:
    """One-token decode against the self and cross caches; returns (logits
    [B, 1, V], cache), the self cache written in place at ``pos_index``."""
    x = embed(tokens, params["embed"], cfg)
    b = x.shape[0]
    positions = torch.full((b, 1), pos_index, dtype=torch.int32, device=x.device)
    rope = rope_frequencies(cfg.head_dim_, positions, cfg.rope_theta)
    self_k, self_v = cache["self"]["k"], cache["self"]["v"]
    slots = ring_positions(pos_index, self_k.shape[2], b, x.device)
    cross = _cross_positions(b, cache["cross"]["k"].shape[2], x.device)
    for i in range(cfg.n_layers):
        lp = _group_slice(params["decoder"], i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        out, _ = attention_block(
            lp["self_attn"], h, positions, cfg, causal=True, rope=rope,
            cache={"k": self_k[i], "v": self_v[i]}, cache_index=pos_index, positions_k=slots,
        )
        x = x + out
        h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
        kv = (cache["cross"]["k"][i], cache["cross"]["v"][i])
        x = x + cross_attention_block(lp["cross_attn"], h, kv, cfg, positions=cross)
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + mlp(h, lp["mlp"], cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, params["embed"], cfg), cache
