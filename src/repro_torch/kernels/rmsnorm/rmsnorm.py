"""RMSNorm (+ optional residual add) for Hopper, in Triton.

Replaces the Pallas TPU kernels ``_rmsnorm_kernel`` and
``_rmsnorm_residual_kernel`` (``rmsnorm_fwd``) in
src/repro/kernels/rmsnorm/rmsnorm.py.

What bounds it: bytes.  Per row it reads D inputs (2D with a residual) and
writes D outputs (2D) for about 4 flops an element.  The design reads each
row once: one program holds a whole row in registers (``BLOCK_D``, the next
power of two above D, masked at the edge), reduces the fp32 sum of squares
and writes the scaled row, so there is no second pass over device memory.
The residual variant (``HAS_RESIDUAL``) adds ``r`` in fp32, stores the sum
rounded to x's dtype and normalizes the unrounded fp32 sum, as the TPU kernel
does.  Its backward, the port's own (the JAX package differentiates
rms_norm by autodiff), is ``rmsnorm_bwd_kernel`` + ``rmsnorm_dw_kernel``
below.

This module imports ``triton`` at the top: the wrapper in ``ops.py`` imports
it only when it launches the kernel on a CUDA tensor.
"""

import triton
import triton.language as tl


@triton.jit
def rmsnorm_kernel(
    X, R, W, O, RES,
    stride_x, stride_r, stride_o, stride_res,
    D, eps,
    HAS_RESIDUAL: tl.constexpr,
    BLOCK_D: tl.constexpr,
):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK_D)
    mask = cols < D
    x = tl.load(X + row * stride_x + cols, mask=mask, other=0.0).to(tl.float32)
    if HAS_RESIDUAL:
        r = tl.load(R + row * stride_r + cols, mask=mask, other=0.0).to(tl.float32)
        x = x + r
        tl.store(RES + row * stride_res + cols, x.to(RES.dtype.element_ty), mask=mask)
    var = tl.sum(x * x, axis=0) / D
    rstd = tl.rsqrt(var + eps)
    w = tl.load(W + cols, mask=mask, other=0.0).to(tl.float32)
    y = x * rstd * (1.0 + w)
    tl.store(O + row * stride_o + cols, y.to(O.dtype.element_ty), mask=mask)


# ----------------------------------------------------------------- backward
# The gradient of rmsnorm_kernel (HAS_RESIDUAL=False).  The JAX package has
# no backward kernel: it differentiates rms_norm (src/repro/models/layers.py)
# by autodiff.  Per row, with r = rsqrt(mean(x^2) + eps) and w' = 1 + w:
#     dx = w' * r * dy - x * r^3 * mean(dy * w' * x)
# and d(scale) = sum over rows of dy * x * r, all in fp32.
#
# What bounds it: bytes (x and dy read, dx written, once each).  Each program
# walks a contiguous run of rows, keeps one row in registers at a time and
# adds its dy * x * r into an fp32 column partial held in registers; it
# writes that partial once, and rmsnorm_dw_kernel sums the partials of all
# programs per column.  So the column reduction costs one [programs, D] fp32
# pass instead of a [rows, D] one, and needs no atomics (deterministic).


@triton.jit
def rmsnorm_bwd_kernel(
    X, W, DY, DX, PART,
    stride_x, stride_dy, stride_dx,
    n_rows, rows_per_prog, D, eps,
    BLOCK_D: tl.constexpr,
):
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK_D)
    mask = cols < D
    wp = 1.0 + tl.load(W + cols, mask=mask, other=0.0).to(tl.float32)
    dw = tl.zeros((BLOCK_D,), dtype=tl.float32)
    row0 = pid * rows_per_prog
    for row in range(row0, tl.minimum(row0 + rows_per_prog, n_rows)):
        row64 = row.to(tl.int64)
        x = tl.load(X + row64 * stride_x + cols, mask=mask, other=0.0).to(tl.float32)
        dy = tl.load(DY + row64 * stride_dy + cols, mask=mask, other=0.0).to(tl.float32)
        r = tl.rsqrt(tl.sum(x * x, axis=0) / D + eps)
        g = dy * wp
        c = tl.sum(g * x, axis=0) / D
        dx = g * r - x * (r * r * r) * c
        tl.store(DX + row64 * stride_dx + cols, dx.to(DX.dtype.element_ty), mask=mask)
        dw += dy * x * r
    tl.store(PART + pid.to(tl.int64) * D + cols, dw, mask=mask)


@triton.jit
def rmsnorm_dw_kernel(
    PART, DW, n_parts, D,
    BLOCK_P: tl.constexpr,
    BLOCK_C: tl.constexpr,
):
    cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < D
    acc = tl.zeros((BLOCK_C,), dtype=tl.float32)
    for p0 in range(0, n_parts, BLOCK_P):
        parts = p0 + tl.arange(0, BLOCK_P)
        tile = tl.load(
            PART + parts[:, None].to(tl.int64) * D + cols[None, :],
            mask=(parts < n_parts)[:, None] & cmask[None, :],
            other=0.0,
        )
        acc += tl.sum(tile, axis=0)
    tl.store(DW + cols, acc.to(DW.dtype.element_ty), mask=cmask)
