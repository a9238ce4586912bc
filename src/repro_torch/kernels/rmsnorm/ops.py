"""Wrapper of the RMSNorm kernels (``rmsnorm.py``, Triton).

On CPU tensors it runs the plain versions in :mod:`.ref`; on CUDA tensors it
launches the kernels or raises; on meta tensors it checks the instance and
returns empty outputs (the dry run).  :func:`cost` is one launch's work.
The plain variant is differentiable: its backward is
``rmsnorm_bwd_kernel`` + ``rmsnorm_dw_kernel`` on CUDA and
``rmsnorm_bwd_ref`` on the CPU.  ``rmsnorm.launches`` counts the forward
launches of the plain variant, ``rmsnorm.backward_launches`` its backward
launches and ``rmsnorm.residual_launches`` those of the residual variant
(the plain versions do not count).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .. import KernelCost, count_launch, launch
from .ref import rmsnorm_bwd_ref, rmsnorm_ref, rmsnorm_residual_ref

_DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 16384
#: a forward program's tile: rows holding about FWD_TILE_ELEMS elements, at
#: most FWD_MAX_ROWS, and no more than leave two programs an SM to run; four
#: warps for up to 8192 elements (the widths' best on the H100, measured by
#: tools/time_port_kernels.py --sweep)
FWD_TILE_ELEMS = 8192
FWD_MAX_ROWS = 4
#: the backward's first pass: (rows a tile, warps, pipeline stages of its
#: row loop at most, programs an SM), each program walking a run of whole tiles
BWD_ROWS, BWD_WARPS, BWD_STAGES, BWD_PROGRAMS_PER_SM = 2, 4, 4, 1
#: shared memory a Hopper block may hold (227 KB): the backward's pipeline
#: keeps STAGES - 1 tiles of x and dy there
SMEM_BYTES = 232448


def _bwd_stages(tile: int, d: int, item: int) -> int:
    """Pipeline stages of the backward's row loop: BWD_STAGES where the
    STAGES - 1 staged tiles of x and dy fit a block's shared memory, else as
    many as fit (1: no pipeline); fp32 rows of 6144 take 3."""
    a, bb = _blocks(d)
    per_stage = 2 * tile * (a + bb) * item  # x and dy tiles, padded to the blocks
    return max(1, min(BWD_STAGES, 1 + (SMEM_BYTES - 1024) // per_stage))


def _blocks(d: int) -> Tuple[int, int]:
    """(BLOCK_A, BLOCK_B): a row of D as the largest power of two <= D plus
    the rest rounded up to a power of two (0 when D is a power of two)."""
    a = 1 << (max(d, 1).bit_length() - 1)
    rest = d - a
    return a, (1 << (rest - 1).bit_length()) if rest else 0


def _pow2_floor(n: float) -> int:
    return 1 << max(int(n), 1).bit_length() - 1


def _row_block(d: int) -> Tuple[int, int]:
    """(BLOCK_A, num_warps) of a call of fewer rows than two an SM (a decode
    step), bound by latency: one row a program, as one masked block of the
    next power of two and a warp per 256 columns, so a row reduces once."""
    block = 1 << max(d - 1, 1).bit_length()
    return block, min(max(block // 256, 1), 16)


def _fwd_launch(rows: int, d: int, sms: int) -> Tuple[int, int, int, int]:
    """(ROWS, BLOCK_A, BLOCK_B, num_warps) of a forward program: a tile of
    rows in two column blocks, or one row (``_row_block``) for few rows."""
    if rows < 2 * sms:
        block, warps = _row_block(d)
        return 1, block, 0, warps
    a, bb = _blocks(d)
    tile = min(_pow2_floor(FWD_TILE_ELEMS / (a + bb)), FWD_MAX_ROWS,
               _pow2_floor(rows / (2 * sms)))
    return tile, a, bb, max(4, min(16, _pow2_floor(tile * (a + bb) / 2048)))


def cost(rows: int, d: int, item: int = 2, w_item: int = 2, residual: bool = False,
         backward: bool = False) -> KernelCost:
    """One launch's work on ``rows`` rows of ``d`` elements of ``item``
    bytes and a scale of ``w_item`` bytes an element, at the fp32 CUDA-core
    peak.  Forward: x in, out, the scale; 5 operations an element.  With
    the residual: x and r in, the norm and the sum out.  Backward: x, dy in,
    dx out, the scale in and its gradient out; 10 operations an element."""
    from ...launch.roofline import FP32_FLOPS

    if backward:
        n_bytes, ops = 3 * rows * d * item + 2 * d * w_item, 10 * rows * d
    else:
        n_bytes, ops = (4 if residual else 2) * rows * d * item + d * w_item, 5 * rows * d
    return KernelCost(n_bytes, ops, ops, FP32_FLOPS)


def _cost_of(x, w, residual=False, backward=False) -> KernelCost:
    d = x.shape[-1]
    return cost(x.numel() // max(d, 1), d, x.element_size(), w.element_size(), residual, backward)


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(x, w, residual):
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


def _launch(x, w, eps, residual):
    """The forward kernel on CUDA tensors; on meta tensors its checks and
    outputs only."""
    _check(x, w, residual)
    d = x.shape[-1]
    x2 = x.view(-1, d)
    rows = x2.shape[0]
    name = "rmsnorm" if residual is None else "rmsnorm_residual"
    with launch(name, lambda: _cost_of(x, w, residual is not None)):
        out = torch.empty_like(x2)
        res_out = torch.empty_like(x2) if residual is not None else out
        if rows and x.device.type == "cuda":
            from . import rmsnorm as kernel  # imports triton: CUDA path only

            r2 = residual.view(-1, d) if residual is not None else x2
            tile, block_a, block_b, warps = _fwd_launch(rows, d, _sms(x.device))
            kernel.rmsnorm_kernel[(-(-rows // tile),)](
                x2, r2, w, out, res_out,
                x2.stride(0), r2.stride(0), out.stride(0), res_out.stride(0),
                rows, d, eps,
                HAS_RESIDUAL=residual is not None,
                ROWS=tile, BLOCK_A=block_a, BLOCK_B=block_b,
                num_warps=warps,
            )
            count_launch(rmsnorm, "launches" if residual is None else "residual_launches")
    if residual is None:
        return out.view(x.shape)
    return out.view(x.shape), res_out.view(x.shape)


def _launch_bwd(dy, x, w, eps):
    """The backward kernels on CUDA tensors; on meta tensors their checks
    and outputs only."""
    _check(x, w, None)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("rmsnorm backward: dy must match x in shape, dtype and device")
    with launch("rmsnorm_bwd", lambda: _cost_of(x, w, backward=True)):
        return _bwd_kernels(dy, x, w, eps)


def _bwd_kernels(dy, x, w, eps):
    d = x.shape[-1]
    x2 = x.view(-1, d)
    dy2 = dy.contiguous().view(-1, d)
    rows = x2.shape[0]
    dx = torch.empty_like(x2)
    dw = torch.empty_like(w)
    if x.device.type == "meta":
        return dx.view(x.shape), dw
    from . import rmsnorm as kernel  # imports triton: CUDA path only

    # each program owns a run of whole tiles; fewer rows than two an SM take
    # one row a program (``_row_block``) and no pipeline
    sms = _sms(x.device)
    if rows >= 2 * sms:
        tile, warps = BWD_ROWS, BWD_WARPS
        stages = _bwd_stages(tile, d, x.element_size())
        block_a, block_b = _blocks(d)
    else:
        tile, stages, block_b = 1, 1, 0
        block_a, warps = _row_block(d)
    n_prog = max(1, min(-(-rows // tile), BWD_PROGRAMS_PER_SM * sms))
    per_prog = tile * -(-rows // (tile * n_prog)) if rows else tile
    n_prog = -(-rows // per_prog) if rows else 1
    part = torch.empty((n_prog, d), dtype=torch.float32, device=x.device)
    if rows:
        kernel.rmsnorm_bwd_kernel[(n_prog,)](
            x2, w, dy2, dx, part,
            x2.stride(0), dy2.stride(0), dx.stride(0),
            rows, per_prog, d, eps,
            ROWS=tile, BLOCK_A=block_a, BLOCK_B=block_b, STAGES=stages,
            num_warps=warps,
        )
    else:
        part.zero_()
    block_c = 128
    kernel.rmsnorm_dw_kernel[(-(-d // block_c),)](
        part, dw, n_prog, d, BLOCK_P=32, BLOCK_C=block_c, num_warps=4,
    )
    count_launch(rmsnorm, "backward_launches")
    return dx.view(x.shape), dw


def rmsnorm_bwd(
    dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, d(scale)) of the plain variant: the backward kernels on CUDA
    tensors (empty outputs on meta tensors), the plain version on CPU
    tensors."""
    if x.device.type == "cpu":
        return rmsnorm_bwd_ref(dy, x, w, eps)
    if x.device.type in ("cuda", "meta"):
        return _launch_bwd(dy, x, w, eps)
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")


class RMSNorm(torch.autograd.Function):
    """(1 + w)-scaled RMSNorm whose forward and backward are the Triton
    kernels on CUDA and their plain versions on the CPU; saves (x, w)."""

    @staticmethod
    def forward(ctx, x, w, eps: float):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        if x.device.type == "cpu":
            return rmsnorm_ref(x, w, eps)
        return _launch(x, w, eps, None)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(dy, x, w, ctx.eps)
        return dx, dw, None


def rmsnorm(
    x: torch.Tensor,  # [..., D]
    w: torch.Tensor,  # [D]
    eps: float = 1e-6,
    residual: Optional[torch.Tensor] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """(1 + w)-scaled RMSNorm over the last dim; with ``residual`` returns
    (norm(x + residual), x + residual).  Only the plain variant is
    differentiable on CUDA: the residual variant raises there when a gradient
    is asked for (the model does not call it)."""
    d = x.shape[-1]
    if w.shape != (d,):
        raise ValueError(f"rmsnorm: w {tuple(w.shape)} for rows of {d}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"rmsnorm: residual {tuple(residual.shape)} vs x {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    if residual is None:
        return RMSNorm.apply(x, w, eps)
    if x.device.type == "cpu":
        return rmsnorm_residual_ref(x, residual, w, eps)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, residual)):
        raise NotImplementedError("rmsnorm: the residual variant has no backward kernel")
    return _launch(x, w, eps, residual)


rmsnorm.launches = 0
rmsnorm.backward_launches = 0
rmsnorm.residual_launches = 0
