"""Layer primitives: the counterpart of ``repro.models.layers``.

Conventions as in the JAX package: params are nested dicts of tensors;
activations compute in ``cfg.compute_dtype``, norm statistics and RoPE in
fp32.  Each ``init_*`` takes the device and a seeded ``torch.Generator`` on
it and draws with the JAX package's scales (the bits differ from
``jax.random``'s).  On ``DTensor`` s (a sharded run, see
:mod:`repro_torch.distributed`) the norm, the MLP, the embedding and the CE
run as local regions of :mod:`repro_torch.distributed.tensor_parallel`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..distributed.context import is_dtensor
from ..kernels.rmsnorm.ops import rmsnorm


def dt(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("bfloat16", "float32")."""
    return getattr(torch, name)


class _MetaGenerator:
    """Stands in for a generator on the meta device, which torch has not:
    the init functions then make shapes and dtypes only."""

    device = torch.device("meta")


def generator(device, seed: int):
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (a stand-in
    on the meta device)."""
    if torch.device(device).type == "meta":
        return _MetaGenerator()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (w * scale).to(dtype)


# ------------------------------------------------------------------- norms
def init_rmsnorm(d: int, dtype, device, lead: Tuple[int, ...] = ()) -> Dict:
    return {"scale": torch.zeros((*lead, d), dtype=dtype, device=device)}


def rms_norm(x: torch.Tensor, params: Dict, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with (1+scale) parameterization, through the rmsnorm kernel."""
    if is_dtensor(x):
        from ..distributed import tensor_parallel

        return tensor_parallel.rms_norm(x, params, eps)
    return rmsnorm(x, params["scale"], eps)


# -------------------------------------------------------------------- rope
def rope_frequencies(
    head_dim: int, positions: torch.Tensor, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: [...]; returns cos/sin of shape [..., head_dim//2] (fp32)."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freq = 1.0 / (theta**exponent)
    angles = positions.float()[..., None] * freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split RoPE in fp32.  x: [B, S, H, D]; cos/sin: [B, S, D//2] from
    ``rope_frequencies`` (the model builds them once per theta and shares
    them across layers)."""
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- linear
def init_dense(
    gen: torch.Generator,
    d_in: int,
    d_out: int,
    dtype,
    scale: Optional[float] = None,
    lead: Tuple[int, ...] = (),
) -> Dict:
    scale = scale if scale is not None else d_in**-0.5
    return {"w": _normal(gen, (*lead, d_in, d_out), scale, dtype)}


def dense(x: torch.Tensor, params: Dict) -> torch.Tensor:
    return x @ params["w"].to(x.dtype)


# -------------------------------------------------------------------- mlp
def init_mlp(
    gen: torch.Generator, cfg: ModelConfig, lead: Tuple[int, ...] = ()
) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    pdt = dt(cfg.param_dtype)
    if cfg.mlp_type == "swiglu":
        return {
            "gate": init_dense(gen, d, f, pdt, lead=lead),
            "up": init_dense(gen, d, f, pdt, lead=lead),
            "down": init_dense(gen, f, d, pdt, scale=f**-0.5, lead=lead),
        }
    return {
        "up": init_dense(gen, d, f, pdt, lead=lead),
        "down": init_dense(gen, f, d, pdt, scale=f**-0.5, lead=lead),
    }


def mlp(x: torch.Tensor, params: Dict, cfg: ModelConfig) -> torch.Tensor:
    if is_dtensor(x):
        from ..distributed import tensor_parallel

        return tensor_parallel.mlp(x, params, cfg)
    if cfg.mlp_type == "swiglu":
        return dense(
            F.silu(dense(x, params["gate"])) * dense(x, params["up"]), params["down"]
        )
    # jax.nn.gelu defaults to the tanh approximation
    return dense(F.gelu(dense(x, params["up"]), approximate="tanh"), params["down"])


# -------------------------------------------------------------- embeddings
def padded_vocab(vocab_size: int, multiple: int = 256) -> int:
    """Vocab rows padded as in the JAX package (its sharding needs them);
    the padded logit columns are sliced off in ``unembed``."""
    return -(-vocab_size // multiple) * multiple


def init_embedding(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    pdt = dt(cfg.param_dtype)
    v_pad = padded_vocab(cfg.vocab_size)
    out = {"table": _normal(gen, (v_pad, cfg.d_model), 0.02, pdt)}
    if not cfg.tie_embeddings:
        out["lm_head"] = _normal(gen, (cfg.d_model, v_pad), cfg.d_model**-0.5, pdt)
    return out


def embed(tokens: torch.Tensor, params: Dict, cfg: ModelConfig) -> torch.Tensor:
    if is_dtensor(params["table"]):
        from ..distributed import tensor_parallel

        return tensor_parallel.embed(tokens, params, cfg)
    x = params["table"][tokens].to(dt(cfg.compute_dtype))
    # gemma-style sqrt(d) scaling; the factor is rounded to x's dtype first,
    # as jnp.asarray(..., dtype=x.dtype) does in the JAX package (a 0-dim CPU
    # tensor acts as a scalar on any device)
    return x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)


def unembed(x: torch.Tensor, params: Dict, cfg: ModelConfig) -> torch.Tensor:
    if is_dtensor(x):
        from ..distributed import tensor_parallel

        return tensor_parallel.unembed(x, params, cfg)
    if cfg.tie_embeddings:
        logits = x @ params["table"].to(x.dtype).T
    else:
        logits = x @ params["lm_head"].to(x.dtype)
    return logits[..., : cfg.vocab_size]  # drop the padded columns


def chunked_cross_entropy(
    x: torch.Tensor,  # [B, S, d] final-norm hidden states
    params: Dict,
    cfg: ModelConfig,
    labels: torch.Tensor,  # [B, S]
    mask: Optional[torch.Tensor] = None,  # [B, S]
    chunk: int = 512,
) -> torch.Tensor:
    """Mean next-token CE without materializing [B, S, V] logits.

    Walks the sequence chunk by chunk; each chunk unembeds, reduces to its
    NLL sum, and is recomputed in the backward pass (non-reentrant
    ``torch.utils.checkpoint``, as ``jax.checkpoint(step)`` does in the JAX
    package), so at most one chunk's [B, chunk, V] fp32 logits are live."""
    if is_dtensor(x):
        from ..distributed import tensor_parallel

        return tensor_parallel.chunked_cross_entropy(x, params, cfg, labels, mask, chunk)
    nll_sum, count = nll_sum_and_count(x, params, cfg, labels, mask, chunk)
    return nll_sum / count.clamp_min(1.0)


def nll_sum_and_count(
    x: torch.Tensor,
    params: Dict,
    cfg: ModelConfig,
    labels: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    chunk: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the NLL summed over the masked tokens, their count) of
    :func:`chunked_cross_entropy`, both fp32 scalars."""
    b, s, _ = x.shape
    c = min(chunk, s)
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)

    def step(xc, lc, mc):
        logits = unembed(xc, params, cfg).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lc[..., None])[..., 0]
        return ((logz - gold) * mc).sum()

    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        xc, lc, mc = x[:, i : i + c], labels[:, i : i + c].long(), mask[:, i : i + c].float()
        nll_sum = nll_sum + checkpoint(step, xc, lc, mc, use_reentrant=False)
    return nll_sum, mask.float().sum()


# -------------------------------------------------------------------- loss
def softmax_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean next-token CE in fp32; labels [B, S] of token ids."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
