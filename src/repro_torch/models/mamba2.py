"""Mamba2 (SSD, state-space duality) block: the counterpart of
``repro.models.mamba2``.

The multi-token mixer runs the chunked SSD through the hand-written chunk-scan
kernel (:func:`repro_torch.kernels.ssd_scan.ops.ssd`), which takes B and C in
their group layout, so they are never repeated to the heads.  Decode is O(1)
per token: a [B, H, P, N] fp32 state and two conv windows, updated in place
in the layer's cache slice.  Rounding follows the JAX package: the conv, its
SiLU, ``x * dt`` and ``dA`` in fp32, y cast to the compute dtype before the
SiLU(z) gate, then the gate norm through the RMSNorm kernel.

Head and channel counts are read off the weights, not the config, so the
same functions run a tensor-parallel rank's share of the heads
(:mod:`repro_torch.distributed.tensor_parallel`, which they hand
``DTensor`` inputs to): ``norm`` then normalises the gate's rows over all
ranks' columns, and ``groups`` names the B/C groups the local heads use.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

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


#: a norm of the gate's rows: (y, scale) -> normalised y
GateNorm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _split(bcc: torch.Tensor, g: int, n: int, groups: Optional[Tuple[int, int]] = None):
    """B and C as [..., G, N] views of the conv output [..., 2GN]; with
    ``groups`` = (first, count) only those groups."""
    lead = bcc.shape[:-1]
    B_, C_ = bcc[..., : g * n].reshape(*lead, g, n), bcc[..., g * n :].reshape(*lead, g, n)
    if groups is not None:
        sel = slice(groups[0], groups[0] + groups[1])
        B_, C_ = B_[..., sel, :], C_[..., sel, :]
    return B_, C_


def _gate(y: torch.Tensor, z: torch.Tensor, params: Dict, cfg: ModelConfig,
          norm: Optional[GateNorm] = None) -> torch.Tensor:
    """The gate norm of y * SiLU(z) (``norm``, or the RMSNorm kernel over the
    local row), then the out projection."""
    g = y * F.silu(z.float()).to(y.dtype)
    if norm is None:
        g = rms_norm(g, params["gate_norm"], cfg.norm_eps)
    else:
        g = norm(g, params["gate_norm"]["scale"])
    return g @ params["out_proj"]["w"].to(g.dtype)


def projections(params: Dict, u: torch.Tensor):
    """(z, x, bc, dt_raw): the input projections of u [..., d_model]."""
    return tuple(u @ params[k]["w"].to(u.dtype) for k in ("z_proj", "x_proj", "bc_proj", "dt_proj"))


def mamba_block(
    params: Dict,
    u: torch.Tensor,  # [B, S, d_model]
    cfg: ModelConfig,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, P, N] fp32
    norm: Optional[GateNorm] = None,
    groups: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full Mamba2 mixer; returns (out [B, S, d_model], final_state
    [B, H, P, N] fp32).  On ``DTensor`` s it runs on each rank's heads
    (:func:`repro_torch.distributed.tensor_parallel.mamba_block`)."""
    if is_dtensor(u):
        from ..distributed import tensor_parallel

        return tensor_parallel.mamba_block(params, u, cfg, initial_state)
    dims = mamba_dims(cfg)
    b, s, _ = u.shape
    # heads and channels from the weights: a tensor-parallel rank holds a share
    h, d_inner = params["dt_bias"].shape[-1], params["x_proj"]["w"].shape[-1]
    p, n, g = dims["head_dim"], dims["d_state"], dims["n_groups"]
    z, xr, bc, dt_raw = projections(params, u)
    xc = F.silu(_causal_conv(xr, params["conv_x_w"], params["conv_x_b"]))
    bcc = F.silu(_causal_conv(bc, params["conv_bc_w"], params["conv_bc_b"]))
    x = xc.reshape(b, s, h, p)
    B_, C_ = _split(bcc, g, n, groups)
    dt_ = F.softplus(dt_raw.float() + params["dt_bias"])  # [B, S, H]
    dA = dt_ * -torch.exp(params["A_log"])
    y, final_state = ssd(
        x * dt_[..., None], dA, B_, C_, chunk=_ssm(cfg).chunk, initial_state=initial_state
    )
    y = y + params["D"][:, None] * x
    y = y.reshape(b, s, d_inner).to(u.dtype)
    return _gate(y, z, params, cfg, norm), final_state


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


def conv_window(cache_win: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """A conv's window [B, W, Ch]: its cache [B, W-1, Ch] then the new input
    [B, Ch], in fp32 as jnp.concatenate promotes them."""
    return torch.cat([cache_win, new[:, None].float()], dim=1)


def conv1(win: torch.Tensor, w_: torch.Tensor, b_: torch.Tensor) -> torch.Tensor:
    """The depthwise conv's output at the window's last position, fp32."""
    return (win * w_.float()).sum(dim=1) + b_.float()


def ssm_update(params: Dict, state: torch.Tensor, x: torch.Tensor, dt_raw: torch.Tensor,
               B_: torch.Tensor, C_: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the SSM recurrence on the heads of ``state`` [B, H, P, N]
    (fp32), x [B, H, P], B/C [B, G, N] of the groups those heads use:
    (the new state, y [B, H, P] fp32)."""
    b, h, p, n = state.shape
    g = B_.shape[1]
    dt_ = F.softplus(dt_raw.float() + params["dt_bias"])  # [B, H]
    decay = torch.exp(dt_ * -torch.exp(params["A_log"]))
    # heads as [G, H/G] so that B and C broadcast over the heads of their
    # group instead of being repeated to them
    rep = h // g
    dtx = (dt_[..., None] * x).view(b, g, rep, p, 1)
    new = state * decay[:, :, None, None] + (dtx * B_[:, :, None, None, :]).view(b, h, p, n)
    y = torch.matmul(new.view(b, g, rep, p, n), C_[:, :, None, :, None]).view(b, h, p)
    return new, y + params["D"][:, None] * x


def mamba_decode_step(
    params: Dict,
    u: torch.Tensor,  # [B, 1, d_model]
    cache: Dict,  # this layer's {"ssm", "conv_x", "conv_bc"}, updated in place
    cfg: ModelConfig,
) -> torch.Tensor:
    """O(1) decode of one token; returns out [B, 1, d_model].  Unlike the JAX
    function, which returns a new cache, the state and the conv windows are
    written into ``cache`` in place.  On ``DTensor`` s each rank steps its
    heads (:func:`repro_torch.distributed.tensor_parallel.mamba_decode_step`)."""
    if is_dtensor(u):
        from ..distributed import tensor_parallel

        return tensor_parallel.mamba_decode_step(params, u, cache, cfg)
    dims = mamba_dims(cfg)
    b = u.shape[0]
    p, n, g = dims["head_dim"], dims["d_state"], dims["n_groups"]
    z, xr, bc, dt_raw = projections(params, u[:, 0])
    win_x = conv_window(cache["conv_x"], xr)
    win_bc = conv_window(cache["conv_bc"], bc)
    x = F.silu(conv1(win_x, params["conv_x_w"], params["conv_x_b"])).reshape(b, -1, p)
    bcc = F.silu(conv1(win_bc, params["conv_bc_w"], params["conv_bc_b"]))
    B_, C_ = _split(bcc, g, n)  # [B, G, N]
    state, y = ssm_update(params, cache["ssm"], x, dt_raw, B_, C_)
    cache["ssm"].copy_(state)
    cache["conv_x"].copy_(win_x[:, 1:])
    cache["conv_bc"].copy_(win_bc[:, 1:])
    y = y.reshape(b, 1, -1).to(u.dtype)
    return _gate(y, z[:, None], params, cfg)
