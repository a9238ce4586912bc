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
does.

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
