"""RMSNorm (+ optional residual add) for Hopper, in Triton.

Replaces the Pallas TPU kernels ``_rmsnorm_kernel`` and
``_rmsnorm_residual_kernel`` (``rmsnorm_fwd``) in
src/repro/kernels/rmsnorm/rmsnorm.py.

What bounds it: bytes.  Per row it reads D inputs (2D with a residual) and
writes D outputs (2D) for about 4 flops an element.  The design reads each
row once and keeps enough of them in flight to stream at the card's rate:
  * a program normalizes a tile of ``ROWS`` rows at once ([ROWS, D] loads in
    one go), so a program has ROWS rows of loads in flight, not one;
  * a row is held as two power-of-two column blocks, ``BLOCK_A`` (the
    largest power of two <= D) and ``BLOCK_B`` (the rest, rounded up to a
    power of two; 0 when D is one): D 1152 = 1024 + 128 and 2560 = 2048 +
    512 leave no lane idle, where one block of the next power of two left
    44 % and 37.5 % of them masked.  A call of a few rows (a decode step)
    is bound by latency, not lanes: there each program takes one row as one
    masked block of the next power of two (``BLOCK_B`` 0), which reduces
    once instead of twice;
  * the fp32 sum of squares of each row is reduced across both blocks and
    the scaled rows are written, with no second pass over device memory.
The residual variant (``HAS_RESIDUAL``) adds ``r`` in fp32, stores the sum
rounded to x's dtype and normalizes the unrounded fp32 sum, as the TPU kernel
does.  Its backward, the port's own (the JAX package differentiates rms_norm
by autodiff), is ``rmsnorm_bwd_kernel`` + ``rmsnorm_dw_kernel`` below.

The external-statistic mode (``EXT_STAT``, both ways) normalizes a row whose
columns are split over ranks (the Mamba2 gate norm under tensor
parallelism): ``rmsnorm_stat_kernel`` gives each local row's fp32 partial
(the sum of squares forward, sum dy * (1 + w) * x backward), the caller
all-reduces it over the ranks, and the kernels then read each row's total
from ``SS`` (and ``CC``) instead of reducing their own columns, dividing by
the whole row's width ``N`` rather than the local ``D``.

This module imports ``triton`` at the top: the wrapper in ``ops.py`` imports
it only when it launches the kernel on a CUDA tensor.
"""

import triton
import triton.language as tl


@triton.jit
def rmsnorm_kernel(
    X, R, W, O, RES, SS,
    stride_x, stride_r, stride_o, stride_res,
    n_rows, D, N, eps,
    HAS_RESIDUAL: tl.constexpr,
    EXT_STAT: tl.constexpr,
    ROWS: tl.constexpr,
    BLOCK_A: tl.constexpr,
    BLOCK_B: tl.constexpr,
):
    rows = tl.program_id(0).to(tl.int64) * ROWS + tl.arange(0, ROWS)
    ca = tl.arange(0, BLOCK_A)[None, :]
    if ROWS == 1:  # one program a row: every row is in range
        rmask = rows[:, None] >= 0
        ma = ca < D
    else:
        rmask = (rows < n_rows)[:, None]
        ma = rmask & (ca < D)
    xa = tl.load(X + rows[:, None] * stride_x + ca, mask=ma, other=0.0).to(tl.float32)
    if HAS_RESIDUAL:
        ra = tl.load(R + rows[:, None] * stride_r + ca, mask=ma, other=0.0).to(tl.float32)
        xa = xa + ra
        tl.store(RES + rows[:, None] * stride_res + ca, xa.to(RES.dtype.element_ty), mask=ma)
    if not EXT_STAT:
        ss = tl.sum(xa * xa, axis=1)
    if BLOCK_B > 0:
        cb = BLOCK_A + tl.arange(0, BLOCK_B)[None, :]
        mb = rmask & (cb < D)
        xb = tl.load(X + rows[:, None] * stride_x + cb, mask=mb, other=0.0).to(tl.float32)
        if HAS_RESIDUAL:
            rb = tl.load(R + rows[:, None] * stride_r + cb, mask=mb, other=0.0).to(tl.float32)
            xb = xb + rb
            tl.store(RES + rows[:, None] * stride_res + cb, xb.to(RES.dtype.element_ty), mask=mb)
        if not EXT_STAT:
            ss += tl.sum(xb * xb, axis=1)
    if EXT_STAT:  # the whole row's sum of squares, from the caller
        ss = tl.load(SS + rows, mask=rows < n_rows, other=0.0)
    rstd = tl.rsqrt(ss / N + eps)[:, None]
    wa = 1.0 + tl.load(W + ca, mask=ca < D, other=0.0).to(tl.float32)
    tl.store(O + rows[:, None] * stride_o + ca, (xa * rstd * wa).to(O.dtype.element_ty), mask=ma)
    if BLOCK_B > 0:
        wb = 1.0 + tl.load(W + cb, mask=cb < D, other=0.0).to(tl.float32)
        tl.store(O + rows[:, None] * stride_o + cb, (xb * rstd * wb).to(O.dtype.element_ty), mask=mb)


# ----------------------------------------------------------------- backward
# The gradient of rmsnorm_kernel (HAS_RESIDUAL=False).  The JAX package has
# no backward kernel: it differentiates rms_norm (src/repro/models/layers.py)
# by autodiff.  Per row, with r = rsqrt(mean(x^2) + eps) and w' = 1 + w:
#     dx = w' * r * dy - x * r^3 * mean(dy * w' * x)
# and d(scale) = sum over rows of dy * x * r, all in fp32.
#
# What bounds it: bytes (x and dy read, dx written, once each).  Each program
# walks a contiguous run of rows in tiles of ROWS rows (the loads of a whole
# tile in flight at once, and with STAGES > 1 the next tiles' too), held as
# the same column blocks as the forward (one masked block for a call of few
# rows, as there).  It adds each tile's
# dy * x * r into an fp32 [ROWS, D] partial held in registers, element by
# element, so no iteration reduces across threads for d(scale); the partial
# is summed over its rows once, at the end, and written once.
# rmsnorm_dw_kernel then sums the partials of all programs per column.  So
# the column reduction costs one [programs, D] fp32 pass instead of a
# [rows, D] one, and needs no atomics (deterministic).


@triton.jit
def rmsnorm_bwd_kernel(
    X, W, DY, DX, PART, SS, CC,
    stride_x, stride_dy, stride_dx,
    n_rows, rows_per_prog, D, N, eps,
    EXT_STAT: tl.constexpr,
    ROWS: tl.constexpr,
    BLOCK_A: tl.constexpr,
    BLOCK_B: tl.constexpr,
    STAGES: tl.constexpr,
):
    pid = tl.program_id(0)
    ca = tl.arange(0, BLOCK_A)
    wa = (1.0 + tl.load(W + ca, mask=ca < D, other=0.0).to(tl.float32))[None, :]
    dwa = tl.zeros((ROWS, BLOCK_A), dtype=tl.float32)
    if BLOCK_B > 0:
        cb = BLOCK_A + tl.arange(0, BLOCK_B)
        wb = (1.0 + tl.load(W + cb, mask=cb < D, other=0.0).to(tl.float32))[None, :]
        dwb = tl.zeros((ROWS, BLOCK_B), dtype=tl.float32)
    row0 = pid * rows_per_prog
    row_end = tl.minimum(row0 + rows_per_prog, n_rows)
    for r0 in tl.range(row0, row_end, ROWS, num_stages=STAGES):
        rows = (r0 + tl.arange(0, ROWS)).to(tl.int64)
        rmask = (rows < row_end)[:, None]
        ma = rmask & (ca < D)[None, :]
        xa = tl.load(X + rows[:, None] * stride_x + ca[None, :], mask=ma, other=0.0).to(tl.float32)
        dya = tl.load(DY + rows[:, None] * stride_dy + ca[None, :], mask=ma, other=0.0).to(tl.float32)
        ga = dya * wa
        if not EXT_STAT:
            ss = tl.sum(xa * xa, axis=1)
            c = tl.sum(ga * xa, axis=1)
        if BLOCK_B > 0:
            mb = rmask & (cb < D)[None, :]
            xb = tl.load(X + rows[:, None] * stride_x + cb[None, :], mask=mb, other=0.0).to(tl.float32)
            dyb = tl.load(DY + rows[:, None] * stride_dy + cb[None, :], mask=mb, other=0.0).to(tl.float32)
            gb = dyb * wb
            if not EXT_STAT:
                ss += tl.sum(xb * xb, axis=1)
                c += tl.sum(gb * xb, axis=1)
        if EXT_STAT:  # the whole row's statistics, from the caller
            ss = tl.load(SS + rows, mask=rows < row_end, other=0.0)
            c = tl.load(CC + rows, mask=rows < row_end, other=0.0)
        r = tl.rsqrt(ss / N + eps)
        k = (r * r * r * (c / N))[:, None]
        r = r[:, None]
        dxa = ga * r - xa * k
        tl.store(DX + rows[:, None] * stride_dx + ca[None, :], dxa.to(DX.dtype.element_ty), mask=ma)
        dwa += dya * xa * r
        if BLOCK_B > 0:
            dxb = gb * r - xb * k
            tl.store(DX + rows[:, None] * stride_dx + cb[None, :], dxb.to(DX.dtype.element_ty), mask=mb)
            dwb += dyb * xb * r
    tl.store(PART + pid.to(tl.int64) * D + ca, tl.sum(dwa, axis=0), mask=ca < D)
    if BLOCK_B > 0:
        tl.store(PART + pid.to(tl.int64) * D + cb, tl.sum(dwb, axis=0), mask=cb < D)


@triton.jit
def rmsnorm_stat_kernel(
    X, Y, W, OUT,
    stride_x, stride_y,
    n_rows, D,
    HAS_Y: tl.constexpr,
    ROWS: tl.constexpr,
    BLOCK_A: tl.constexpr,
    BLOCK_B: tl.constexpr,
):
    # OUT[row] = the fp32 sum over the row's D columns of x * x, or with
    # HAS_Y of y * (1 + w) * x: the local partial of the external-statistic
    # mode, in the tiles and column blocks of rmsnorm_kernel
    rows = tl.program_id(0).to(tl.int64) * ROWS + tl.arange(0, ROWS)
    rmask = (rows < n_rows)[:, None]
    ca = tl.arange(0, BLOCK_A)[None, :]
    ma = rmask & (ca < D)
    xa = tl.load(X + rows[:, None] * stride_x + ca, mask=ma, other=0.0).to(tl.float32)
    if HAS_Y:
        ya = tl.load(Y + rows[:, None] * stride_y + ca, mask=ma, other=0.0).to(tl.float32)
        wa = 1.0 + tl.load(W + ca, mask=ca < D, other=0.0).to(tl.float32)
        acc = tl.sum(ya * wa * xa, axis=1)
    else:
        acc = tl.sum(xa * xa, axis=1)
    if BLOCK_B > 0:
        cb = BLOCK_A + tl.arange(0, BLOCK_B)[None, :]
        mb = rmask & (cb < D)
        xb = tl.load(X + rows[:, None] * stride_x + cb, mask=mb, other=0.0).to(tl.float32)
        if HAS_Y:
            yb = tl.load(Y + rows[:, None] * stride_y + cb, mask=mb, other=0.0).to(tl.float32)
            wb = 1.0 + tl.load(W + cb, mask=cb < D, other=0.0).to(tl.float32)
            acc += tl.sum(yb * wb * xb, axis=1)
        else:
            acc += tl.sum(xb * xb, axis=1)
    tl.store(OUT + rows, acc, mask=rows < n_rows)


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
