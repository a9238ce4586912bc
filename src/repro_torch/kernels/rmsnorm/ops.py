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

The external-statistic mode (:func:`rmsnorm_split`) normalizes rows whose
columns are split over ranks, as GSPMD does for the Mamba2 gate norm: each
rank's fp32 row partials (:func:`row_stat`, the ``rmsnorm_stat_kernel``)
are summed over the ranks by the caller's ``reduce``, then
:func:`rmsnorm_ext` (forward) and :func:`rmsnorm_ext_bwd` (backward) scale
the local columns with those totals.  Their launches count in
``rmsnorm.stat_launches``, ``rmsnorm.ext_launches`` and
``rmsnorm.ext_backward_launches``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .. import KernelCost, count_launch, launch
from .ref import (
    rmsnorm_bwd_ref,
    rmsnorm_ext_bwd_ref,
    rmsnorm_ext_ref,
    rmsnorm_ref,
    rmsnorm_residual_ref,
    row_stat_ref,
)

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


def ext_cost(rows: int, d: int, item: int = 2, w_item: int = 2,
             backward: bool = False) -> KernelCost:
    """One launch of the external-statistic mode on ``rows`` local rows of
    ``d`` columns.  Forward: x and the scale in, each row's fp32 sum of
    squares in, the output out; 3 operations an element.  Backward: x and dy
    in, dx out, the scale in and its gradient out, each row's two fp32
    totals in; 8 operations an element."""
    from ...launch.roofline import FP32_FLOPS

    if backward:
        n_bytes, ops = 3 * rows * d * item + 2 * d * w_item + 8 * rows, 8 * rows * d
    else:
        n_bytes, ops = 2 * rows * d * item + d * w_item + 4 * rows, 3 * rows * d
    return KernelCost(n_bytes, ops, ops, FP32_FLOPS)


def stat_cost(rows: int, d: int, item: int = 2, w_item: int = 2,
              with_dy: bool = False) -> KernelCost:
    """One launch of ``rmsnorm_stat_kernel``: x (and dy and the scale) in,
    one fp32 value a row out; 2 operations an element (4 with dy)."""
    from ...launch.roofline import FP32_FLOPS

    n_bytes = (2 if with_dy else 1) * rows * d * item + (d * w_item if with_dy else 0) + 4 * rows
    ops = (4 if with_dy else 2) * rows * d
    return KernelCost(n_bytes, ops, ops, FP32_FLOPS)


def _rows(x) -> int:
    return x.numel() // max(x.shape[-1], 1)


def _cost_of(x, w, residual=False, backward=False) -> KernelCost:
    d = x.shape[-1]
    return cost(_rows(x), d, x.element_size(), w.element_size(), residual, backward)


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


def _check_stat(x, t, name: str) -> None:
    """A row statistic: fp32, contiguous, one value a row of x, on x's device."""
    if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous() or \
            t.numel() != _rows(x):
        raise ValueError(f"rmsnorm: {name} must be a contiguous fp32 tensor of one value a row "
                         f"of x on {x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(x, w, eps, residual, ss=None, n=None):
    """The forward kernel on CUDA tensors (with ``ss``: the
    external-statistic mode over rows of ``n`` columns in all); on meta
    tensors its checks and outputs only."""
    _check(x, w, residual)
    d = x.shape[-1]
    x2 = x.view(-1, d)
    rows = x2.shape[0]
    ext = ss is not None
    if ext:
        _check_stat(x, ss, "ss")
        name, cost_fn = "rmsnorm_ext", lambda: ext_cost(
            rows, d, x.element_size(), w.element_size())
    else:
        name = "rmsnorm" if residual is None else "rmsnorm_residual"
        cost_fn = lambda: _cost_of(x, w, residual is not None)  # noqa: E731
    with launch(name, cost_fn):
        out = torch.empty_like(x2)
        res_out = torch.empty_like(x2) if residual is not None else out
        if rows and x.device.type == "cuda":
            from . import rmsnorm as kernel  # imports triton: CUDA path only

            r2 = residual.view(-1, d) if residual is not None else x2
            tile, block_a, block_b, warps = _fwd_launch(rows, d, _sms(x.device))
            kernel.rmsnorm_kernel[(-(-rows // tile),)](
                x2, r2, w, out, res_out, ss if ext else x2,
                x2.stride(0), r2.stride(0), out.stride(0), res_out.stride(0),
                rows, d, n if ext else d, eps,
                HAS_RESIDUAL=residual is not None,
                EXT_STAT=ext,
                ROWS=tile, BLOCK_A=block_a, BLOCK_B=block_b,
                num_warps=warps,
            )
            attr = "ext_launches" if ext else (
                "launches" if residual is None else "residual_launches")
            count_launch(rmsnorm, attr)
    if residual is None:
        return out.view(x.shape)
    return out.view(x.shape), res_out.view(x.shape)


def _launch_stat(x, dy, w):
    """``rmsnorm_stat_kernel`` on CUDA tensors (its checks and output only
    on meta tensors): one fp32 value a row."""
    _check(x, w, None)
    if dy is not None and (dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous()):
        raise ValueError("rmsnorm row_stat: dy must match x in shape and dtype, contiguous")
    d = x.shape[-1]
    x2 = x.view(-1, d)
    rows = x2.shape[0]
    with launch("rmsnorm_stat", lambda: stat_cost(rows, d, x.element_size(), w.element_size(),
                                                  dy is not None)):
        out = torch.empty((rows,), dtype=torch.float32, device=x.device)
        if rows and x.device.type == "cuda":
            from . import rmsnorm as kernel  # imports triton: CUDA path only

            y2 = dy.view(-1, d) if dy is not None else x2
            tile, block_a, block_b, warps = _fwd_launch(rows, d, _sms(x.device))
            kernel.rmsnorm_stat_kernel[(-(-rows // tile),)](
                x2, y2, w, out, x2.stride(0), y2.stride(0), rows, d,
                HAS_Y=dy is not None, ROWS=tile, BLOCK_A=block_a, BLOCK_B=block_b,
                num_warps=warps,
            )
            count_launch(rmsnorm, "stat_launches")
    return out


def row_stat(
    x: torch.Tensor, dy: Optional[torch.Tensor] = None, w: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """fp32 [rows] of x [..., D]: each row's sum of x^2, or with ``dy`` (and
    the scale ``w``) of dy (1 + w) x -- the local partials of the
    external-statistic mode."""
    if w is None:
        w = x.new_zeros(x.shape[-1])
    if x.device.type == "cpu":
        return row_stat_ref(x, dy, w)
    if x.device.type in ("cuda", "meta"):
        return _launch_stat(x, dy, w)
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")


def rmsnorm_ext(x: torch.Tensor, w: torch.Tensor, ss: torch.Tensor, n: int,
                eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(ss / n + eps) * (1 + w): the forward of the
    external-statistic mode, ``ss`` each row's fp32 sum of squares over all
    its ``n`` columns (not differentiable: :func:`rmsnorm_split` is)."""
    if x.device.type == "cpu":
        return rmsnorm_ext_ref(x, w, ss, n, eps)
    if x.device.type in ("cuda", "meta"):
        return _launch(x, w, eps, None, ss, n)
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")


def _launch_bwd(dy, x, w, eps, ss=None, c=None, n=None):
    """The backward kernels on CUDA tensors (with ``ss`` and ``c``: the
    external-statistic mode); on meta tensors their checks and outputs
    only."""
    _check(x, w, None)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("rmsnorm backward: dy must match x in shape, dtype and device")
    if ss is None:
        with launch("rmsnorm_bwd", lambda: _cost_of(x, w, backward=True)):
            return _bwd_kernels(dy, x, w, eps)
    _check_stat(x, ss, "ss")
    _check_stat(x, c, "c")
    with launch("rmsnorm_ext_bwd", lambda: ext_cost(
            _rows(x), x.shape[-1], x.element_size(), w.element_size(), backward=True)):
        return _bwd_kernels(dy, x, w, eps, ss, c, n)


def _bwd_kernels(dy, x, w, eps, ss=None, c=None, n=None):
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
        ext = ss is not None
        kernel.rmsnorm_bwd_kernel[(n_prog,)](
            x2, w, dy2, dx, part, ss if ext else x2, c if ext else x2,
            x2.stride(0), dy2.stride(0), dx.stride(0),
            rows, per_prog, d, n if ext else d, eps,
            EXT_STAT=ext,
            ROWS=tile, BLOCK_A=block_a, BLOCK_B=block_b, STAGES=stages,
            num_warps=warps,
        )
    else:
        part.zero_()
    block_c = 128
    kernel.rmsnorm_dw_kernel[(-(-d // block_c),)](
        part, dw, n_prog, d, BLOCK_P=32, BLOCK_C=block_c, num_warps=4,
    )
    count_launch(rmsnorm, "backward_launches" if ss is None else "ext_backward_launches")
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


def rmsnorm_ext_bwd(
    dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor, ss: torch.Tensor, c: torch.Tensor,
    n: int, eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, d(scale)) of :func:`rmsnorm_ext` on the local columns, ``c`` each
    row's sum of dy (1 + w) x over all its ``n`` columns."""
    if x.device.type == "cpu":
        return rmsnorm_ext_bwd_ref(dy, x, w, ss, c, n, eps)
    if x.device.type in ("cuda", "meta"):
        return _launch_bwd(dy, x, w, eps, ss, c, n)
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")


class SplitRMSNorm(torch.autograd.Function):
    """The (1 + w)-scaled RMSNorm of rows whose ``n`` columns are split over
    ranks, x and w this rank's columns: forward, each row's sum of squares
    summed over the ranks by ``reduce`` (an in-place all-reduce), then the
    local columns scaled; backward, each row's sum of dy (1 + w) x summed
    the same way, then dx and this rank's d(scale).  Saves (x, w, the
    summed squares)."""

    @staticmethod
    def forward(ctx, x, w, eps: float, n: int, reduce):
        ss = row_stat(x)
        reduce(ss)
        ctx.save_for_backward(x, w, ss)
        ctx.eps, ctx.n, ctx.reduce = eps, n, reduce
        return rmsnorm_ext(x, w, ss, n, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w, ss = ctx.saved_tensors
        dy = dy.contiguous()
        c = row_stat(x, dy, w)
        ctx.reduce(c)
        dx, dw = rmsnorm_ext_bwd(dy, x, w, ss, c, ctx.n, ctx.eps)
        return dx, dw, None, None, None


def rmsnorm_split(x: torch.Tensor, w: torch.Tensor, eps: float, n: int, reduce) -> torch.Tensor:
    """RMSNorm over rows of ``n`` columns of which x [..., D] and w [D] are
    this rank's; ``reduce(t)`` sums the fp32 row statistics t [rows] over
    the ranks that hold the other columns, in place (see
    :class:`SplitRMSNorm`)."""
    if w.shape != (x.shape[-1],):
        raise ValueError(f"rmsnorm: w {tuple(w.shape)} for rows of {x.shape[-1]}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"rmsnorm: no kernel for device {x.device}")
    return SplitRMSNorm.apply(x.contiguous(), w, eps, n, reduce)


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
rmsnorm.stat_launches = 0
rmsnorm.ext_launches = 0
rmsnorm.ext_backward_launches = 0
