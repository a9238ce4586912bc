"""Plain PyTorch version of the RMSNorm kernel (``rmsnorm.py``).

``x * rsqrt(mean(x^2) + eps) * (1 + w)`` per row with fp32 statistics, cast
to x's dtype.  With a residual, the sum ``x + r`` is taken in fp32 and
normalized as it is, and also returned cast to x's dtype -- the kernel's
behaviour (the JAX package's residual oracle instead normalizes the sum
after rounding it to x's dtype).  ``rmsnorm_bwd_ref`` is the gradient of
``rmsnorm_ref``, the plain version of the backward kernels.

The external-statistic mode normalizes rows whose columns are split over
ranks: ``row_stat_ref`` is a local row's fp32 partial (the sum of squares,
or with dy the sum of dy (1+w) x), and ``rmsnorm_ext_ref`` /
``rmsnorm_ext_bwd_ref`` take each row's all-reduced totals (``ss``, ``c``)
and the whole row's width ``n``; with n the local width and the local
totals they are ``rmsnorm_ref`` and ``rmsnorm_bwd_ref``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _normalize(xf: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = xf.square().mean(dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * (1.0 + w.float())


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return _normalize(x.float(), w, eps).to(x.dtype)


def rmsnorm_residual_ref(
    x: torch.Tensor, residual: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    s = x.float() + residual.float()
    return _normalize(s, w, eps).to(x.dtype), s.to(x.dtype)


def rmsnorm_bwd_ref(
    dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`rmsnorm_ref`: (dx in x's dtype, d(scale) in
    w's dtype), computed in fp32 with r = rsqrt(mean(x^2) + eps):
    dx = (1+w) r dy - x r^3 mean(dy (1+w) x), d(scale) = sum_rows dy x r."""
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    g = dyf * (1.0 + w.float())
    dx = g * r - xf * r.pow(3) * (g * xf).mean(dim=-1, keepdim=True)
    dw = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def row_stat_ref(
    x: torch.Tensor, dy: Optional[torch.Tensor] = None, w: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """fp32 [rows]: sum over the last dim of x^2, or of dy (1+w) x."""
    xf = x.float().reshape(-1, x.shape[-1])
    if dy is None:
        return xf.square().sum(dim=-1)
    g = dy.float().reshape(-1, x.shape[-1]) * (1.0 + w.float())
    return (g * xf).sum(dim=-1)


def rmsnorm_ext_ref(
    x: torch.Tensor, w: torch.Tensor, ss: torch.Tensor, n: int, eps: float = 1e-6
) -> torch.Tensor:
    """x * rsqrt(ss / n + eps) * (1 + w) per row, ss the row's fp32 sum of
    squares over all its ``n`` columns (this rank's and the others')."""
    r = torch.rsqrt(ss.float().reshape(*x.shape[:-1], 1) / n + eps)
    return (x.float() * r * (1.0 + w.float())).to(x.dtype)


def rmsnorm_ext_bwd_ref(
    dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor, ss: torch.Tensor, c: torch.Tensor,
    n: int, eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, d(scale)) of :func:`rmsnorm_ext_ref` for the local columns, c
    the row's sum of dy (1+w) x over all ``n`` columns:
    dx = (1+w) r dy - x r^3 c / n, d(scale) = sum_rows dy x r."""
    lead = (*x.shape[:-1], 1)
    xf, dyf = x.float(), dy.float()
    r = torch.rsqrt(ss.float().reshape(lead) / n + eps)
    dx = dyf * (1.0 + w.float()) * r - xf * r.pow(3) * (c.float().reshape(lead) / n)
    dw = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)
