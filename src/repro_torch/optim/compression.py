"""Gradient compression for slow (cross-host) links: the counterpart of
``repro.optim.compression``.

Int8 uniform quantization with error feedback: each participant quantizes
its local gradient to int8 with a per-tensor scale, the all-reduce runs on
int32 accumulators (4x fewer bytes than fp32 on the wire at equal
participant count), and the quantization residual is carried into the next
step (error feedback keeps the scheme unbiased over time).

The JAX functions run inside ``shard_map`` over a named axis; these take
the ``torch.distributed`` process group of that axis
(``mesh.get_group("pod")``; None is the default group) and the local
tensors of each rank.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from ..checkpoint import flatten_tree, unflatten_tree


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization; returns (q, scale), the values
    rounded half to even as ``jnp.round`` does."""
    xf = x.float()
    scale = xf.abs().max().clamp_min(1e-12) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(
    x: torch.Tensor,
    group: Optional[dist.ProcessGroup] = None,
    error: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantized mean all-reduce over ``group`` with error feedback.

    Returns (the mean-reduced fp32 tensor, the new error-feedback residual);
    every rank of ``group`` must call it."""
    xf = x.float()
    if error is not None:
        xf = xf + error
    q, scale = quantize_int8(xf)
    new_error = xf - dequantize_int8(q, scale)
    # int32 accumulate avoids overflow up to ~16M participants
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    # scales differ per participant: the sum of q_i * s_i is approximated
    # with the max scale; error feedback absorbs the residual
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    n = float(dist.get_world_size(group))
    out = total.float() * scale_max / n
    return out, new_error


def compress_tree_psum(
    grads: Any, group: Optional[dist.ProcessGroup] = None, errors: Optional[Any] = None
) -> Tuple[Any, Any]:
    """Tree-mapped :func:`compressed_psum` (leaves in sorted key order, the
    same on every rank)."""
    outs, new_errs = {}, {}
    err = dict(flatten_tree(errors)) if errors is not None else {}
    for path, g in flatten_tree(grads):
        outs[path], new_errs[path] = compressed_psum(g, group, err.get(path))
    return unflatten_tree(outs), unflatten_tree(new_errs)
