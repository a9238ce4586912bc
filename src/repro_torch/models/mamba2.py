"""Mamba2 (SSD, state-space duality) block: the counterpart of
``repro.models.mamba2``.

The multi-token mixer runs the chunked SSD through the hand-written chunk-scan
kernel (:func:`repro_torch.kernels.ssd_scan.ops.ssd`), which takes B and C in
their group layout, so they are never repeated to the heads.  Decode is O(1)
per token: a [B, H, P, N] fp32 state and two conv windows, updated in place
in the layer's cache slice.  Rounding follows the JAX package: the conv, its
SiLU, ``x * dt`` and ``dA`` in fp32, y cast to the compute dtype before the
SiLU(z) gate, then the gate norm through the RMSNorm kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..distributed.context import is_dtensor
from ..kernels.ssd_scan.ops import ssd
from .layers import _normal, dt, init_dense, rms_norm


def _ssm(cfg: ModelConfig):
    if cfg.ssm is None:
        raise ValueError(f"{cfg.name} has no SSM config")
    return cfg.ssm


def mamba_dims(cfg: ModelConfig) -> Dict[str, int]:
    s = _ssm(cfg)
    return {
        "d_inner": s.d_inner(cfg.d_model),
        "n_heads": s.n_heads(cfg.d_model),
        "head_dim": s.head_dim,
        "d_state": s.d_state,
        "n_groups": s.n_groups,
        "conv_width": s.conv_width,
    }


# ----------------------------------------------------------------- params
def init_mamba_block(
    gen: torch.Generator, cfg: ModelConfig, lead: Tuple[int, ...] = ()
) -> Dict:
    """The JAX package's split z/x/bc/dt projections and key names, so
    checkpoints cross over; ``lead`` stacks them (``(n_groups,)``)."""
    dims = mamba_dims(cfg)
    pdt = dt(cfg.param_dtype)
    dev = gen.device
    d, w, d_in, nh = cfg.d_model, dims["conv_width"], dims["d_inner"], dims["n_heads"]
    gn2 = 2 * dims["n_groups"] * dims["d_state"]

    def zeros(*shape, dtype=pdt):
        return torch.zeros((*lead, *shape), dtype=dtype, device=dev)

    return {
        "z_proj": init_dense(gen, d, d_in, pdt, lead=lead),
        "x_proj": init_dense(gen, d, d_in, pdt, lead=lead),
        "bc_proj": init_dense(gen, d, gn2, pdt, lead=lead),
        "dt_proj": init_dense(gen, d, nh, pdt, lead=lead),
        "conv_x_w": _normal(gen, (*lead, w, d_in), w**-0.5, pdt),
        "conv_x_b": zeros(d_in),
        "conv_bc_w": _normal(gen, (*lead, w, gn2), w**-0.5, pdt),
        "conv_bc_b": zeros(gn2),
        "A_log": zeros(nh, dtype=torch.float32),
        "D": torch.ones((*lead, nh), dtype=torch.float32, device=dev),
        "dt_bias": zeros(nh, dtype=torch.float32),
        "gate_norm": {"scale": zeros(d_in)},
        "out_proj": init_dense(gen, d_in, d, pdt, lead=lead),
    }


# ----------------------------------------------------------- block forward
def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence dim in fp32; xbc [B, S, Ch],
    w [W, Ch].  The taps are added in the JAX package's order."""
    width, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(width):
        out = out + pad[:, i : i + s].float() * w[i].float()
    return out + b.float()


def _split(bcc: torch.Tensor, g: int, n: int):
    """B and C as [..., G, N] views of the conv output [..., 2GN]."""
    lead = bcc.shape[:-1]
    return bcc[..., : g * n].reshape(*lead, g, n), bcc[..., g * n :].reshape(*lead, g, n)


def _gate(y: torch.Tensor, z: torch.Tensor, params: Dict, cfg: ModelConfig) -> torch.Tensor:
    """The gate norm of y * SiLU(z), then the out projection."""
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), params["gate_norm"], cfg.norm_eps)
    return y @ params["out_proj"]["w"].to(y.dtype)


def _unsharded(x) -> None:
    if is_dtensor(x):
        raise NotImplementedError("sharded execution of the Mamba2 mixer is not ported yet")


def mamba_block(
    params: Dict,
    u: torch.Tensor,  # [B, S, d_model]
    cfg: ModelConfig,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, P, N] fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full Mamba2 mixer; returns (out [B, S, d_model], final_state
    [B, H, P, N] fp32)."""
    _unsharded(u)
    dims = mamba_dims(cfg)
    b, s, _ = u.shape
    h, p, n, g = dims["n_heads"], dims["head_dim"], dims["d_state"], dims["n_groups"]
    z = u @ params["z_proj"]["w"].to(u.dtype)
    xr = u @ params["x_proj"]["w"].to(u.dtype)
    bc = u @ params["bc_proj"]["w"].to(u.dtype)
    dt_raw = u @ params["dt_proj"]["w"].to(u.dtype)
    xc = F.silu(_causal_conv(xr, params["conv_x_w"], params["conv_x_b"]))
    bcc = F.silu(_causal_conv(bc, params["conv_bc_w"], params["conv_bc_b"]))
    x = xc.reshape(b, s, h, p)
    B_, C_ = _split(bcc, g, n)
    dt_ = F.softplus(dt_raw.float() + params["dt_bias"])  # [B, S, H]
    dA = dt_ * -torch.exp(params["A_log"])
    y, final_state = ssd(
        x * dt_[..., None], dA, B_, C_, chunk=_ssm(cfg).chunk, initial_state=initial_state
    )
    y = y + params["D"][:, None] * x
    y = y.reshape(b, s, dims["d_inner"]).to(u.dtype)
    return _gate(y, z, params, cfg), final_state


# ------------------------------------------------------------------ decode
def init_mamba_cache(
    cfg: ModelConfig, batch: int, device, lead: Tuple[int, ...] = ()
) -> Dict:
    """One mamba layer's decode cache (``lead`` stacks it): the fp32 SSM
    state and the last W-1 inputs of each conv, as the JAX package's
    ``transformer._init_block_cache`` holds them."""
    dims = mamba_dims(cfg)
    gn2 = 2 * dims["n_groups"] * dims["d_state"]
    w1 = dims["conv_width"] - 1

    def zeros(*shape):
        return torch.zeros((*lead, batch, *shape), dtype=torch.float32, device=device)

    return {
        "ssm": zeros(dims["n_heads"], dims["head_dim"], dims["d_state"]),
        "conv_x": zeros(w1, dims["d_inner"]),
        "conv_bc": zeros(w1, gn2),
    }


def mamba_decode_step(
    params: Dict,
    u: torch.Tensor,  # [B, 1, d_model]
    cache: Dict,  # this layer's {"ssm", "conv_x", "conv_bc"}, updated in place
    cfg: ModelConfig,
) -> torch.Tensor:
    """O(1) decode of one token; returns out [B, 1, d_model].  Unlike the JAX
    function, which returns a new cache, the state and the conv windows are
    written into ``cache`` in place."""
    dims = mamba_dims(cfg)
    b = u.shape[0]
    h, p, n, g = dims["n_heads"], dims["head_dim"], dims["d_state"], dims["n_groups"]
    u0 = u[:, 0]
    z = u0 @ params["z_proj"]["w"].to(u.dtype)
    xr = u0 @ params["x_proj"]["w"].to(u.dtype)
    bc = u0 @ params["bc_proj"]["w"].to(u.dtype)
    dt_raw = u0 @ params["dt_proj"]["w"].to(u.dtype)
    # conv windows: [cache | new], in fp32 as jnp.concatenate promotes them
    win_x = torch.cat([cache["conv_x"], xr[:, None].float()], dim=1)
    win_bc = torch.cat([cache["conv_bc"], bc[:, None].float()], dim=1)

    def conv1(win, w_, b_):
        return (win * w_.float()).sum(dim=1) + b_.float()

    x = F.silu(conv1(win_x, params["conv_x_w"], params["conv_x_b"])).reshape(b, h, p)
    bcc = F.silu(conv1(win_bc, params["conv_bc_w"], params["conv_bc_b"]))
    B_, C_ = _split(bcc, g, n)  # [B, G, N]
    dt_ = F.softplus(dt_raw.float() + params["dt_bias"])  # [B, H]
    decay = torch.exp(dt_ * -torch.exp(params["A_log"]))
    # heads as [G, H/G] so that B and C broadcast over the heads of their
    # group instead of being repeated to them
    rep = h // g
    dtx = (dt_[..., None] * x).view(b, g, rep, p, 1)
    state = (
        cache["ssm"] * decay[:, :, None, None] + (dtx * B_[:, :, None, None, :]).view(b, h, p, n)
    )
    y = torch.matmul(state.view(b, g, rep, p, n), C_[:, :, None, :, None]).view(b, h, p)
    y = y + params["D"][:, None] * x
    cache["ssm"].copy_(state)
    cache["conv_x"].copy_(win_x[:, 1:])
    cache["conv_bc"].copy_(win_bc[:, 1:])
    y = y.reshape(b, 1, dims["d_inner"]).to(u.dtype)
    return _gate(y, z[:, None], params, cfg)
