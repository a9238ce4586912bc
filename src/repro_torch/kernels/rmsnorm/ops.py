"""Wrapper of the RMSNorm kernel (``rmsnorm.py``, Triton).

On CPU tensors it runs the plain version in :mod:`.ref`; on CUDA tensors it
launches the kernel or raises.  ``rmsnorm.launches`` counts the launches of
the plain variant and ``rmsnorm.residual_launches`` those of the residual
variant (the plain version does not count).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .ref import rmsnorm_ref, rmsnorm_residual_ref

_DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 16384


def _launch(x, w, eps, residual):
    from . import rmsnorm as kernel  # imports triton: CUDA path only

    d = x.shape[-1]
    dev = x.device
    tensors = [("w", w)] + ([("residual", residual)] if residual is not None else [])
    for name, t in tensors:
        if t.device != dev:
            raise ValueError(f"rmsnorm: {name} on {t.device}, x on {dev}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm: unsupported dtypes x {x.dtype}, w {w.dtype}")
    if residual is not None and residual.dtype != x.dtype:
        raise TypeError("rmsnorm: residual must have x's dtype")
    if d > MAX_D:
        raise NotImplementedError(f"rmsnorm kernel holds rows of at most {MAX_D}")
    if not x.is_contiguous() or not w.is_contiguous() or (
        residual is not None and not residual.is_contiguous()
    ):
        raise ValueError("rmsnorm: x, w and residual must be contiguous")
    x2 = x.view(-1, d)
    rows = x2.shape[0]
    out = torch.empty_like(x2)
    res_out = torch.empty_like(x2) if residual is not None else out
    r2 = residual.view(-1, d) if residual is not None else x2
    block_d = 1 << max(d - 1, 1).bit_length()
    if rows:
        kernel.rmsnorm_kernel[(rows,)](
            x2, r2, w, out, res_out,
            x2.stride(0), r2.stride(0), out.stride(0), res_out.stride(0),
            d, eps,
            HAS_RESIDUAL=residual is not None,
            BLOCK_D=block_d,
            num_warps=min(max(block_d // 256, 1), 16),
        )
        if residual is None:
            rmsnorm.launches += 1
        else:
            rmsnorm.residual_launches += 1
    if residual is None:
        return out.view(x.shape)
    return out.view(x.shape), res_out.view(x.shape)


def rmsnorm(
    x: torch.Tensor,  # [..., D]
    w: torch.Tensor,  # [D]
    eps: float = 1e-6,
    residual: Optional[torch.Tensor] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """(1 + w)-scaled RMSNorm over the last dim; with ``residual`` returns
    (norm(x + residual), x + residual)."""
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rmsnorm: w {tuple(w.shape)} for rows of {d}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"rmsnorm: residual {tuple(residual.shape)} vs x {tuple(x.shape)}")
    if x.device.type == "cpu":
        if residual is None:
            return rmsnorm_ref(x, w, eps)
        return rmsnorm_residual_ref(x, residual, w, eps)
    if x.device.type == "cuda":
        return _launch(x, w, eps, residual)
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")


rmsnorm.launches = 0
rmsnorm.residual_launches = 0
