"""Wrapper of C1 (``csrc/causal_conv.cu``): the Mamba2 mixer's depthwise
causal conv, its bias and SiLU, forward and backward.

:func:`causal_conv_silu` is a ``torch.autograd.Function``.  It saves its
inputs only (x in its own dtype, w and b), never its fp32 output: the
backward recomputes the pre-activation.  On CUDA tensors the forward and
the backward launch the kernel or raise; on CPU tensors they run the plain
versions in :mod:`.ref`; on meta tensors they check the instance and
return the kernel's empty outputs (the dry run).  :func:`cost` and
:func:`bwd_cost` are one launch's work.  ``causal_conv_silu.launches``
counts forward calls on the card and ``causal_conv_silu.backward_launches``
backward calls (two kernels each: the pass and the fold of dw and db); the
plain versions do not count.

The channel count and width are read from the tensors, so one instance set
serves the x conv, the B/C conv and a tensor-parallel rank's share of
either.  x's channel dim must be contiguous; its other strides are taken as
they come.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import KernelCost, build, count_launch, launch
from .ref import causal_conv_silu_bwd_ref, causal_conv_silu_ref

#: the conv widths the CUDA source is compiled for
WIDTHS = (2, 3, 4)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: threads a block, channels a thread (kThreads and kC of the CUDA source)
THREADS, CHANNELS = 128, 4
#: positions a thread's tile holds at most and at least; the tile is halved
#: from the most while fewer than FILL threads would run (the B/C conv's
#: narrow rows)
MAX_TILE, MIN_TILE = 64, 16
FILL = 132 * 1024

_Strides = ctypes.c_longlong * 2


class ConvArgs(ctypes.Structure):
    """The C struct ``ConvArgs`` of the CUDA source, field for field."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "dtype", "batch", "seq", "channels", "width", "tile", "tx", "vec")]
        + [(n, ctypes.c_void_p) for n in (
            "x", "w", "b", "dy", "y", "dx", "partial", "dw", "db")]
        + [("x_s", _Strides), ("dy_s", _Strides), ("w_s", ctypes.c_longlong),
           ("stream", ctypes.c_void_p)]
    )


def layout(b: int, s: int, c: int) -> Tuple[int, int]:
    """(positions a thread's tile, channel groups a block) of a launch over
    x [b, s, c]: a block holds 128 threads, ``tx`` channel groups of 4 by
    128 / tx tiles of one row."""
    groups = -(-c // CHANNELS)
    tx = min(32, 1 << (groups - 1).bit_length())
    tile = MAX_TILE
    while tile > MIN_TILE and b * -(-s // tile) * groups < FILL:
        tile //= 2
    return tile, tx


def parts(b: int, s: int, c: int) -> int:
    """The backward's fp32 partials of dw and db a channel: one a block."""
    tile, tx = layout(b, s, c)
    tiles, ty = -(-s // tile), THREADS // tx
    return b * -(-tiles // ty)


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    """The shape rules of :func:`causal_conv_silu`."""
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2] or b.shape != (x.shape[2],):
        raise ValueError(f"causal_conv: x {tuple(x.shape)}, w {tuple(w.shape)}, b "
                         f"{tuple(b.shape)}: want x [B, S, C], w [W, C], b [C]")


def _check_kernel(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    """What the CUDA kernel takes beyond :func:`_check`'s rules."""
    for name, t in (("w", w), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"causal_conv: {name} on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(f"causal_conv: x, w and b must share a dtype of {list(_DTYPE_CODES)}, "
                        f"got {x.dtype}, {w.dtype}, {b.dtype}")
    if w.shape[0] not in WIDTHS:
        raise NotImplementedError(
            f"causal_conv kernel has no instance for width {w.shape[0]} (built for {WIDTHS})")
    if x.stride(2) != 1 or w.stride(1) != 1 or b.stride(0) != 1:
        raise ValueError("causal_conv: the channel dim of x, w and b must be contiguous")


def cost(b: int, s: int, c: int, width: int, item: int = 2) -> KernelCost:
    """One forward launch's work: per output element the W taps (a multiply
    and an add each), the bias and the SiLU (an exp, an add, a divide).
    Bytes: x, w and b in (``item`` bytes an element), the fp32 output.  On
    the fp32 CUDA cores."""
    from ...launch.roofline import FP32_FLOPS

    n = b * s * c
    flops = n * (2 * width + 4)
    n_bytes = n * (item + 4) + (width + 1) * c * item
    return KernelCost(n_bytes, flops, flops, FP32_FLOPS)


def bwd_cost(b: int, s: int, c: int, width: int, item: int = 2) -> KernelCost:
    """One backward launch's work: per element the pre-activation again
    (2W + 1), SiLU's derivative (an exp, a divide and six more), dx, dw and
    db (2W each for dx and dw, one for db).  Bytes: x and the fp32 dy in, dx
    out; w and b in, dw and db out (``item`` bytes an element)."""
    from ...launch.roofline import FP32_FLOPS

    n = b * s * c
    flops = n * (6 * width + 10)
    n_bytes = n * (2 * item + 4) + 2 * (width + 1) * c * item
    return KernelCost(n_bytes, flops, flops, FP32_FLOPS)


def _cost_of(x, w, backward: bool = False) -> KernelCost:
    b, s, c = x.shape
    return (bwd_cost if backward else cost)(b, s, c, w.shape[0], x.element_size())


_entry_fn = None


def _entry():
    global _entry_fn
    if _entry_fn is None:
        fn = build.load("causal_conv").causal_conv_launch
        fn.argtypes = [ctypes.POINTER(ConvArgs), ctypes.c_int]
        fn.restype = ctypes.c_int
        _entry_fn = fn
    return _entry_fn


def _aligned(*tensors) -> bool:
    """Every pointer and the batch and position strides on 16 bytes."""
    return all(t.data_ptr() % 16 == 0 and all(st * t.element_size() % 16 == 0
                                              for st in t.stride()[:2]) for t in tensors)


def _launch(x, w, b, *, y=None, dy=None, dx=None, partial=None, dw=None, db=None) -> None:
    bs, s, c = x.shape
    backward = dy is not None
    tile, tx = layout(bs, s, c)
    a = ConvArgs(
        dtype=_DTYPE_CODES[x.dtype], batch=bs, seq=s, channels=c, width=w.shape[0], tile=tile,
        tx=tx, vec=int(c % CHANNELS == 0 and _aligned(x, *((dy,) if backward else ()))),
        x=x.data_ptr(), w=w.data_ptr(), b=b.data_ptr(),
        **{name: t.data_ptr() if t is not None else None for name, t in (
            ("dy", dy), ("y", y), ("dx", dx), ("partial", partial), ("dw", dw), ("db", db))},
        x_s=_Strides(*x.stride()[:2]),
        dy_s=_Strides(*(dy.stride()[:2] if backward else (0, 0))), w_s=w.stride(0),
        stream=torch.cuda.current_stream(x.device).cuda_stream,
    )
    rc = _entry()(ctypes.byref(a), int(backward))
    if rc != 0:
        raise RuntimeError(f"causal_conv kernel launch failed (cudaError {rc})")


class CausalConvSilu(torch.autograd.Function):
    """SiLU(conv(x, w) + b) whose forward and backward are C1 on CUDA and
    the plain versions on the CPU; saves x, w and b only."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, w, b)
        if x.device.type == "cpu":
            return causal_conv_silu_ref(x, w, b)
        with launch("causal_conv", lambda: _cost_of(x, w)):
            y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
            if x.device.type == "cuda":
                _launch(x, w, b, y=y)
        if x.device.type == "cuda":
            count_launch(causal_conv_silu)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        if dy is None:
            return None, None, None
        return causal_conv_silu_bwd(x, w, b, dy)


def causal_conv_silu_bwd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """C1's backward alone: (dx, dw, db) in the dtypes of x, w and b for the
    gradient ``dy`` of the fp32 output; the kernel on CUDA tensors (counted
    in ``causal_conv_silu.backward_launches``), the plain version on CPU
    tensors."""
    _check(x, w, b)
    if x.device.type == "cpu":
        return causal_conv_silu_bwd_ref(x, w, b, dy)
    _check_kernel(x, w, b)
    with launch("causal_conv_bwd", lambda: _cost_of(x, w, True)):
        dy = dy.float()
        if dy.shape != x.shape:
            raise ValueError(f"causal_conv: dy {tuple(dy.shape)} for x {tuple(x.shape)}")
        if dy.stride(2) != 1:
            dy = dy.contiguous()  # autograd may hand over a broadcast view
        bs, s, c = x.shape
        dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        dw = torch.empty(w.shape, dtype=w.dtype, device=x.device)
        db = torch.empty(b.shape, dtype=b.dtype, device=x.device)
        partial = torch.empty((w.shape[0] + 1, parts(bs, s, c), c), dtype=torch.float32,
                              device=x.device)
        if x.device.type == "cuda":
            _launch(x, w, b, dy=dy, dx=dx, partial=partial, dw=dw, db=db)
    if x.device.type == "cuda":
        count_launch(causal_conv_silu, "backward_launches")
    return dx, dw, db


def causal_conv_silu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SiLU of the depthwise causal conv of x [B, S, C] with w [W, C] plus
    b [C] (zeros before position 0 of each row), fp32 [B, S, C];
    differentiable in x, w and b."""
    _check(x, w, b)
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"causal_conv: no kernel for device {x.device}")
    if x.device.type != "cpu":
        _check_kernel(x, w, b)
    return CausalConvSilu.apply(x, w, b)


causal_conv_silu.launches = 0
causal_conv_silu.backward_launches = 0
