"""Plain PyTorch version of the RMSNorm kernel (``rmsnorm.py``).

``x * rsqrt(mean(x^2) + eps) * (1 + w)`` per row with fp32 statistics, cast
to x's dtype.  With a residual, the sum ``x + r`` is taken in fp32 and
normalized as it is, and also returned cast to x's dtype -- the kernel's
behaviour (the JAX package's residual oracle instead normalizes the sum
after rounding it to x's dtype).  ``rmsnorm_bwd_ref`` is the gradient of
``rmsnorm_ref``, the plain version of the backward kernels.
"""

from __future__ import annotations

from typing import Tuple

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
