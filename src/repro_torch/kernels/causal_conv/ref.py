"""Plain PyTorch version of C1 (``csrc/causal_conv.cu``): the Mamba2
mixer's depthwise causal conv, its bias and SiLU, both ways.

:func:`causal_conv_ref` is the arithmetic the port's mixer ran before C1,
and the JAX package's ``_causal_conv`` (``repro/models/mamba2.py``): the
taps added in fp32 from 0 in order, then the bias.
:func:`causal_conv_silu_bwd_ref` computes the gradients as the kernel
does: it recomputes the pre-activation from x, and sums dx over the taps
in order, in fp32, rounded once to x's dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def causal_conv_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence dim in fp32; x [B, S, C],
    w [W, C], b [C]; zeros before position 0.  The taps are added in the
    JAX package's order."""
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + pad[:, i : i + s].float() * w[i].float()
    return out + b.float()


def causal_conv_silu_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SiLU of :func:`causal_conv_ref`, fp32 [B, S, C]."""
    return F.silu(causal_conv_ref(x, w, b))


def causal_conv_silu_bwd_ref(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, dy: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dw, db) of :func:`causal_conv_silu_ref` for the gradient ``dy``
    of its output, in the dtypes of x, w and b: ``da = dy s (1 + a (1 - s))``
    with a recomputed and ``s = sigmoid(a)``; ``dx[t] = sum_i w[i]
    da[t + W - 1 - i]`` (da zero past the row's end); ``dw[i] = sum da[t]
    x[t - W + 1 + i]`` and ``db = sum da`` over rows and positions."""
    width, s = w.shape[0], x.shape[1]
    a = causal_conv_ref(x, w, b)
    sg = torch.sigmoid(a)
    da = dy.float() * (sg * (1 + a * (1 - sg)))
    dpad = F.pad(da, (0, 0, 0, width - 1))
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        dx = dx + w[i].float() * dpad[:, width - 1 - i : width - 1 - i + s]
    xpad = F.pad(x.float(), (0, 0, width - 1, 0))
    dw = torch.stack([(da * xpad[:, i : i + s]).sum(dim=(0, 1)) for i in range(width)])
    return dx.to(x.dtype), dw.to(w.dtype), da.sum(dim=(0, 1)).to(b.dtype)
