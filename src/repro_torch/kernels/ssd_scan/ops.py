"""Wrapper of the SSD chunk-scan kernels (``csrc/ssd_scan.cu``, forward, and
``csrc/ssd_scan_bwd.cu``, backward).

:func:`ssd` is a ``torch.autograd.Function``.  On CUDA tensors its forward
launches the forward kernel and saves the kernel's own scratch (cum, C B^T
and the state entering each chunk), and its backward launches the backward
kernel on them, or either raises; on CPU tensors they run the plain
versions in :mod:`.ref` (``ssd_ref``, ``ssd_bwd_ref``), with or without an
initial state; on meta tensors they check the instance and return the
kernels' empty outputs and scratch (the dry run).  :func:`cost` and
:func:`bwd_cost` are one launch's work.  ``ssd.launches`` counts forward
calls on the card and ``ssd.backward_launches`` backward calls (six
kernels each); the plain versions do not count.

The forward kernel runs as five passes (``PASSES``) over scratch that
:func:`workspace` allocates, the backward as six (``BWD_PASSES``) over
scratch that :func:`bwd_workspace` allocates; :func:`run_pass` runs one of
them, the kernel's on CUDA tensors and its plain version on CPU tensors,
and :func:`plain_pass` computes a pass's plain version from the workspace's
current contents, so that a fault is found in the pass that makes it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from .. import KernelCost, build, count_launch, launch
from .ref import (
    ssd_bwd_carry_ref, ssd_bwd_dA_ref, ssd_bwd_dc_ref, ssd_bwd_dprev_ref, ssd_bwd_dx_ref,
    ssd_bwd_fold_ref, ssd_bwd_ref, ssd_carry_ref, ssd_cb_ref, ssd_chunk_states_ref,
    ssd_cum_ref, ssd_output_ref, ssd_ref,
)

#: the instances the CUDA source is compiled for
HEAD_DIMS = (64,)
D_STATES = (64, 128)
MAX_CHUNK = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS = 128  # kR of the CUDA source, the output pass's rows a block: C B^T rows are padded to it

#: the kernel's passes in order, each the bit ``1 << index`` of the launch
PASSES = ("cum", "cb", "chunk_states", "carry", "output")
_ALL = (1 << len(PASSES)) - 1
#: the backward kernel's passes in order, likewise; it has fp32 instances only
BWD_PASSES = ("dprev", "dcarry", "dx", "dc", "ddA", "fold")
_BWD_ALL = (1 << len(BWD_PASSES)) - 1
#: the backward's tensor-core passes; threads a block, positions a ring stage
#: of dx and dc, ring stages, and the blocks an SM the design holds (kThreads,
#: kS and kStages of the CUDA source; 2 x 8 warps)
BWD_TENSOR_PASSES = ("dprev", "dx", "dc")
BWD_THREADS, BWD_STEP, BWD_STAGES, BWD_BLOCKS_PER_SM = 256, 32, 2, 2
#: shared memory a block may have, and an SM has, on an H100, in bytes
BLOCK_SMEM, SM_SMEM = 232448, 233472

_Strides = ctypes.c_longlong * 3


class SsdArgs(ctypes.Structure):
    """The C struct ``SsdArgs`` of the CUDA source, field for field."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "dtype", "batch", "seq", "heads", "groups", "head_dim", "d_state", "chunk",
            "has_init", "vec")]
        + [(n, ctypes.c_void_p) for n in (
            "x", "dA", "B", "C", "init", "y", "final_state", "cum", "cb", "states", "prev")]
        + [(n, _Strides) for n in ("x_s", "a_s", "b_s", "c_s", "y_s")]
        + [("stream", ctypes.c_void_p)]
    )


class SsdBwdArgs(ctypes.Structure):
    """The C struct ``SsdBwdArgs`` of the backward's CUDA source, field for
    field."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "batch", "seq", "heads", "groups", "head_dim", "d_state", "chunk", "has_dfinal",
            "vec")]
        + [(n, ctypes.c_void_p) for n in (
            "x", "B", "C", "dy", "cum", "cb", "prev", "dfinal", "dprev", "dstate", "dx", "dBh",
            "dCh", "dcum_row", "dcum_col", "dw", "ddecay", "d_init", "d_dA", "dB", "dC")]
        + [(n, _Strides) for n in ("x_s", "b_s", "c_s", "dy_s")]
        + [("stream", ctypes.c_void_p)]
    )


@dataclass
class Workspace:
    """One scan: its inputs, the kernel's scratch in its own layouts (cum
    ``[B, H, nC, Q]``, cb ``[B, nC, G, Q, Q]`` as a view of rows padded to
    the output pass's tile, states and prev ``[B, nC, H, P, N]``) and its outputs (y
    ``[B, S, H, P]`` in x's dtype, final ``[B, H, P, N]`` fp32)."""

    x: torch.Tensor
    dA: torch.Tensor
    B: torch.Tensor
    C: torch.Tensor
    chunk: int
    initial_state: Optional[torch.Tensor]
    cum: torch.Tensor
    cb: torch.Tensor
    states: torch.Tensor
    prev: torch.Tensor
    y: torch.Tensor
    final: torch.Tensor


@dataclass
class BwdWorkspace:
    """One backward of a scan: the forward's inputs and saved scratch (a
    :class:`Workspace` whose passes 1-4 ran), ``dy`` ``[B, S, H, P]`` and
    ``dfinal`` ``[B, H, P, N]`` (or None), the kernel's scratch (dprev and
    dstate ``[B, nC, H, P, N]``, each head's dB and dC ``[B, S, H, N]``, the
    parts of dcum ``[B, H, nC, Q]`` and the chunk-decay term ``[B, H, nC]``)
    and its outputs (dx ``[B, S, H, P]``, d_dA ``[B, S, H]``, dB and dC ``[B,
    S, G, N]``, d_init ``[B, H, P, N]``), all fp32."""

    fwd: Workspace
    dy: torch.Tensor
    dfinal: Optional[torch.Tensor]
    dprev: torch.Tensor
    dstate: torch.Tensor
    dBh: torch.Tensor
    dCh: torch.Tensor
    dcum_row: torch.Tensor
    dcum_col: torch.Tensor
    dw: torch.Tensor
    ddecay: torch.Tensor
    dx: torch.Tensor
    d_dA: torch.Tensor
    dB: torch.Tensor
    dC: torch.Tensor
    d_init: torch.Tensor


_entries = {}


def _entry(lib: str, fn_name: str, args_type):
    fn = _entries.get(fn_name)
    if fn is None:
        fn = getattr(build.load(lib), fn_name)
        fn.argtypes = [ctypes.POINTER(args_type), ctypes.c_int]
        fn.restype = ctypes.c_int
        _entries[fn_name] = fn
    return fn


def _check(x, dA, B, C, chunk, initial_state) -> int:
    """The shape rules of :func:`ssd`; returns the chunk length q."""
    b, s, h, p = x.shape
    if dA.shape != (b, s, h):
        raise ValueError(f"ssd: dA {tuple(dA.shape)} for x {tuple(x.shape)}")
    if B.dim() != 4 or B.shape[:2] != (b, s) or C.shape != B.shape:
        raise ValueError(f"ssd: B {tuple(B.shape)}, C {tuple(C.shape)} for x {tuple(x.shape)}")
    g, n = B.shape[2], B.shape[3]
    if h % g:
        raise ValueError(f"ssd: {h} heads over {g} groups")
    if initial_state is not None and initial_state.shape != (b, h, p, n):
        raise ValueError(f"ssd: initial_state {tuple(initial_state.shape)} is not {(b, h, p, n)}")
    q = min(chunk, s)
    if q <= 0 or s % q:
        raise ValueError(f"ssd: seq {s} is not a multiple of chunk {q}")
    return q


def _check_kernel(x, dA, B, C, q, initial_state) -> None:
    """What the CUDA kernel takes beyond :func:`_check`'s rules."""
    p, n = x.shape[3], B.shape[3]
    dev = x.device
    for name, t in (("dA", dA), ("B", B), ("C", C), ("initial_state", initial_state)):
        if t is not None and t.device != dev:
            raise ValueError(f"ssd: {name} on {t.device}, x on {dev}")
    if x.dtype not in _DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd: x, B and C must share a dtype of {list(_DTYPE_CODES)}")
    if dA.dtype != torch.float32:
        raise TypeError(f"ssd: dA must be float32, got {dA.dtype}")
    if initial_state is not None and (
        initial_state.dtype != torch.float32 or not initial_state.is_contiguous()
    ):
        raise ValueError("ssd: initial_state must be a contiguous float32 tensor")
    if p not in HEAD_DIMS or n not in D_STATES or q > MAX_CHUNK:
        raise NotImplementedError(
            f"ssd kernel has no instance for head_dim={p}, d_state={n}, chunk={q} "
            f"(built for {HEAD_DIMS} x {D_STATES}, chunks up to {MAX_CHUNK})"
        )
    if x.stride(3) != 1 or B.stride(3) != 1 or C.stride(3) != 1:
        raise ValueError("ssd: the last dim of x, B and C must be contiguous")


def cost(b: int, s: int, h: int, p: int, n: int, g: int, q: int, init: bool,
         item: int = 4) -> KernelCost:
    """One forward launch's work: C B^T once per (b, chunk, group) and (L o
    S) X per (b, h, chunk), both on the lower triangle only (Q(Q+1)/2
    pairs); per (b, h, chunk) the state term C state^T (none in the first
    chunk without an initial state) and the state update, 2QPN each.  Bytes:
    x in and y out (``item`` bytes an element), dA, B and C in their group
    layout, the final (and initial) state.  The products run in 3xTF32,
    three TF32 products for each fp32 one, at the TF32 tensor-core peak."""
    from ...launch.roofline import TF32_FLOPS

    chunks, tri = s // q, q * (q + 1) // 2
    flops = (b * chunks * g * 2 * n * tri + b * h * chunks * 2 * p * tri
             + b * h * (2 * chunks - (0 if init else 1)) * 2 * q * p * n)
    n_bytes = (2 * b * s * h * p * item  # x in, y out
               + b * s * h * 4  # dA
               + 2 * b * s * g * n * item  # B, C in their group layout
               + b * h * p * n * 4 * (2 if init else 1))  # final (and initial) state
    return KernelCost(n_bytes, flops, 3 * flops, TF32_FLOPS)


def bwd_cost(b: int, s: int, h: int, p: int, n: int, g: int, q: int, init: bool,
             dfinal: bool) -> KernelCost:
    """One backward launch's work (fp32), per (b, h, chunk): four products
    on the lower triangle: dy x^T and S^T dy over P, dM^T C and dM B over
    N; and four Q x P x N state products: (dy o e)^T C and (dy o e) prev,
    none in the first chunk without an initial state (prev is 0 and
    d_initial unused), B g^T and x g, none in the last chunk without dfinal
    (g is 0).  Bytes: x, dy in, dx out; cum in, d_dA out; B, C in, dB, dC
    out; C B^T and prev in; the initial state's and dfinal's.  3xTF32, as
    the forward."""
    from ...launch.roofline import TF32_FLOPS

    chunks, tri = s // q, q * (q + 1) // 2
    flops = (b * h * chunks * 2 * tri * (2 * p + 2 * n)
             + b * h * 2 * q * p * n * 2 * ((chunks - (0 if init else 1))
                                            + (chunks - (0 if dfinal else 1))))
    n_bytes = 4 * (3 * b * s * h * p  # x, dy in, dx out
                   + 2 * b * s * h  # cum in, d_dA out
                   + 4 * b * s * g * n  # B, C in, dB, dC out
                   + b * chunks * g * q * q  # C B^T in
                   + b * chunks * h * p * n  # prev in
                   + b * h * p * n * ((1 if init else 0) + (1 if dfinal else 0)))
    return KernelCost(n_bytes, flops, 3 * flops, TF32_FLOPS)


def _cost_of(x, B, q: int, init: bool, backward: bool = False,
             dfinal: bool = False) -> KernelCost:
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if backward:
        return bwd_cost(b, s, h, p, n, g, q, init, dfinal)
    return cost(b, s, h, p, n, g, q, init, x.element_size())


def workspace(
    x: torch.Tensor,
    dA: torch.Tensor,
    B: torch.Tensor,
    C: torch.Tensor,
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,
) -> Workspace:
    """The inputs of :func:`ssd` with its scratch and outputs allocated (not
    filled), for :func:`run_pass` and :func:`plain_pass`."""
    q = _check(x, dA, B, C, chunk, initial_state)
    if x.device.type in ("cuda", "meta"):
        _check_kernel(x, dA, B, C, q, initial_state)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = s // q
    qp = -(-q // _ROWS) * _ROWS
    f32 = dict(dtype=torch.float32, device=x.device)
    return Workspace(
        x=x, dA=dA, B=B, C=C, chunk=q, initial_state=initial_state,
        cum=torch.empty((b, h, nc, q), **f32),
        cb=torch.empty((b, nc, g, qp, qp), **f32)[..., :q, :q],
        states=torch.empty((b, nc, h, p, n), **f32),
        prev=torch.empty((b, nc, h, p, n), **f32),
        y=torch.empty((b, s, h, p), dtype=x.dtype, device=x.device),
        final=torch.empty((b, h, p, n), **f32),
    )


def _aligned(*tensors) -> bool:
    """Every pointer and stride of the tensors on 16 bytes."""
    return all(
        t.data_ptr() % 16 == 0 and all(st * t.element_size() % 16 == 0 for st in t.stride()[:3])
        for t in tensors
    )


def _launch(ws: Workspace, passes: int) -> None:
    x, B = ws.x, ws.B
    b, s, h, p = x.shape
    init = ws.initial_state
    a = SsdArgs(
        dtype=_DTYPE_CODES[x.dtype], batch=b, seq=s, heads=h, groups=B.shape[2], head_dim=p,
        d_state=B.shape[3], chunk=ws.chunk, has_init=int(init is not None),
        vec=int(_aligned(x, B, ws.C)),
        x=x.data_ptr(), dA=ws.dA.data_ptr(), B=B.data_ptr(), C=ws.C.data_ptr(),
        init=init.data_ptr() if init is not None else None,
        y=ws.y.data_ptr(), final_state=ws.final.data_ptr(), cum=ws.cum.data_ptr(),
        cb=ws.cb.data_ptr(), states=ws.states.data_ptr(), prev=ws.prev.data_ptr(),
        x_s=_Strides(*x.stride()[:3]), a_s=_Strides(*ws.dA.stride()),
        b_s=_Strides(*B.stride()[:3]), c_s=_Strides(*ws.C.stride()[:3]),
        y_s=_Strides(*ws.y.stride()[:3]),
        stream=torch.cuda.current_stream(x.device).cuda_stream,
    )
    rc = _entry("ssd_scan", "ssd_scan_launch", SsdArgs)(ctypes.byref(a), passes)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed (cudaError {rc})")


def bwd_smem_bytes(name: str, n: int) -> int:
    """The dynamic shared memory a block of backward pass ``name`` (one of
    ``BWD_TENSOR_PASSES``) takes at d_state ``n``, in bytes: the sums of
    ``dprev_smem_floats``, ``dx_smem_floats`` and ``dc_smem_floats`` in the
    CUDA source, which ``ssd_scan_bwd_smem_bytes`` returns on the card.
    Tiles are fp32 in rows padded by 4 floats."""
    t, s, p, st = 64, BWD_STEP, HEAD_DIMS[0], BWD_STAGES
    if name == "dprev":  # ring of 64-row stages (dy, C, cum)
        floats = st * (t * (p + 4) + t * (n + 4) + t)
    elif name == "dx":  # x_J, dM, ring (C B^T, dy, C, cum), cum_J, w, folds
        floats = (t * (p + 4) + s * (p + 4)
                  + st * (2 * s * (t + 4) + s * (n + 4) + s) + 6 * t)
    elif name == "dc":  # dy_I, ring (C B^T, x, B, cum), cum_I, folds
        floats = (t * (p + 4) + st * (t * (s + 4) + s * (p + 4) + s * (n + 4) + s)
                  + 3 * t)
    else:
        raise ValueError(f"ssd: {name!r} is not one of {BWD_TENSOR_PASSES}")
    return 4 * floats


def bwd_blocks_per_sm(name: str, n: int) -> int:
    """Blocks of backward pass ``name`` an H100 SM holds by their shared
    memory (1 KB of the SM's reserved a block) and threads."""
    return min(SM_SMEM // (bwd_smem_bytes(name, n) + 1024), 2048 // BWD_THREADS)


def _check_bwd_kernel(x, B, C) -> None:
    """What the backward kernel takes beyond :func:`_check_kernel`'s rules:
    fp32 x, B and C (as both models give them)."""
    if x.dtype != torch.float32 or B.dtype != torch.float32 or C.dtype != torch.float32:
        raise NotImplementedError(
            f"ssd backward kernel has no instance for {x.dtype} inputs (built for float32)"
        )


def bwd_workspace(
    ws: Workspace, dy: Optional[torch.Tensor], dfinal: Optional[torch.Tensor] = None
) -> BwdWorkspace:
    """The backward of the scan whose forward scratch ``ws`` holds (passes
    1-4 run), for the gradients ``dy`` of y (None: zeros) and ``dfinal``
    of the final state (None: zeros), with its scratch and outputs
    allocated (not filled), for :func:`run_pass` and :func:`plain_pass`."""
    x, B = ws.x, ws.B
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc, q = s // ws.chunk, ws.chunk
    if dy is None:
        dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    if dy.shape != x.shape or (dfinal is not None and dfinal.shape != (b, h, p, n)):
        raise ValueError(f"ssd: dy {tuple(dy.shape)} / dfinal for x {tuple(x.shape)}")
    if x.device.type in ("cuda", "meta"):
        _check_bwd_kernel(x, B, ws.C)
        if dy.dtype != torch.float32 or (dfinal is not None and dfinal.dtype != torch.float32):
            raise TypeError("ssd: dy and dfinal must be float32")
        if dy.stride(3) != 1:
            dy = dy.contiguous()  # autograd may hand over a broadcast view
        if dfinal is not None:
            dfinal = dfinal.contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    return BwdWorkspace(
        fwd=ws, dy=dy, dfinal=dfinal,
        dprev=torch.empty((b, nc, h, p, n), **f32),
        dstate=torch.empty((b, nc, h, p, n), **f32),
        dBh=torch.empty((b, s, h, n), **f32),
        dCh=torch.empty((b, s, h, n), **f32),
        dcum_row=torch.empty((b, h, nc, q), **f32),
        dcum_col=torch.empty((b, h, nc, q), **f32),
        dw=torch.empty((b, h, nc, q), **f32),
        ddecay=torch.empty((b, h, nc), **f32),
        dx=torch.empty((b, s, h, p), **f32),
        d_dA=torch.empty((b, s, h), **f32),
        dB=torch.empty((b, s, g, n), **f32),
        dC=torch.empty((b, s, g, n), **f32),
        d_init=torch.empty((b, h, p, n), **f32),
    )


def _launch_bwd(bw: BwdWorkspace, passes: int) -> None:
    f = bw.fwd
    x, B = f.x, f.B
    b, s, h, p = x.shape
    a = SsdBwdArgs(
        batch=b, seq=s, heads=h, groups=B.shape[2], head_dim=p, d_state=B.shape[3],
        chunk=f.chunk, has_dfinal=int(bw.dfinal is not None), vec=int(_aligned(x, B, f.C, bw.dy)),
        x=x.data_ptr(), B=B.data_ptr(), C=f.C.data_ptr(), dy=bw.dy.data_ptr(),
        cum=f.cum.data_ptr(), cb=f.cb.data_ptr(), prev=f.prev.data_ptr(),
        dfinal=bw.dfinal.data_ptr() if bw.dfinal is not None else None,
        **{name: getattr(bw, name).data_ptr() for name in (
            "dprev", "dstate", "dx", "dBh", "dCh", "dcum_row", "dcum_col", "dw", "ddecay",
            "d_init", "d_dA", "dB", "dC")},
        x_s=_Strides(*x.stride()[:3]), b_s=_Strides(*B.stride()[:3]),
        c_s=_Strides(*f.C.stride()[:3]), dy_s=_Strides(*bw.dy.stride()[:3]),
        stream=torch.cuda.current_stream(x.device).cuda_stream,
    )
    rc = _entry("ssd_scan_bwd", "ssd_scan_bwd_launch", SsdBwdArgs)(ctypes.byref(a), passes)
    if rc != 0:
        raise RuntimeError(f"ssd_scan backward kernel launch failed (cudaError {rc})")


def plain_pass(ws, name: str) -> Dict[str, torch.Tensor]:
    """The plain version of pass ``name`` (of ``PASSES`` on a
    :class:`Workspace`, of ``BWD_PASSES`` on a :class:`BwdWorkspace`) on the
    workspace's inputs and its scratch as it stands: the values of the
    fields the pass writes."""
    if name in BWD_PASSES:
        return _plain_bwd_pass(ws, name)
    if name == "cum":
        return {"cum": ssd_cum_ref(ws.dA, ws.chunk)}
    if name == "cb":
        return {"cb": ssd_cb_ref(ws.B, ws.C, ws.chunk)}
    if name == "chunk_states":
        return {"states": ssd_chunk_states_ref(ws.x, ws.B, ws.cum)}
    if name == "carry":
        prev, final = ssd_carry_ref(ws.states, ws.cum, ws.initial_state)
        return {"prev": prev, "final": final}
    if name == "output":
        return {"y": ssd_output_ref(ws.x, ws.C, ws.cb, ws.cum, ws.prev)}
    raise ValueError(f"ssd: no pass {name!r}; the passes are {PASSES} and {BWD_PASSES}")


def _plain_bwd_pass(bw: BwdWorkspace, name: str) -> Dict[str, torch.Tensor]:
    f = bw.fwd
    if name == "dprev":
        return {"dprev": ssd_bwd_dprev_ref(bw.dy, f.C, f.cum)}
    if name == "dcarry":
        dstate, d_init = ssd_bwd_carry_ref(bw.dprev, f.cum, bw.dfinal)
        return {"dstate": dstate, "d_init": d_init}
    if name == "dx":
        return ssd_bwd_dx_ref(f.x, bw.dy, f.B, f.C, f.cb, f.cum, f.prev, bw.dstate)
    if name == "dc":
        return ssd_bwd_dc_ref(f.x, bw.dy, f.B, f.C, f.cb, f.cum, f.prev)
    if name == "ddA":
        return {"d_dA": ssd_bwd_dA_ref(bw.dcum_row, bw.dcum_col, bw.dw, bw.ddecay)}
    dB, dC = ssd_bwd_fold_ref(bw.dBh, bw.dCh, f.B.shape[2])
    return {"dB": dB, "dC": dC}


def run_pass(ws, name: str) -> None:
    """Runs pass ``name`` into the workspace (a forward pass into a
    :class:`Workspace`, a backward pass into a :class:`BwdWorkspace`): the
    kernel's on CUDA tensors, the plain version on CPU tensors.  Not counted
    in ``ssd.launches`` or ``ssd.backward_launches``."""
    bwd = name in BWD_PASSES
    if not bwd and name not in PASSES:
        raise ValueError(f"ssd: no pass {name!r}; the passes are {PASSES} and {BWD_PASSES}")
    if (ws.fwd if bwd else ws).x.device.type == "cuda":
        if bwd:
            _launch_bwd(ws, 1 << BWD_PASSES.index(name))
        else:
            _launch(ws, 1 << PASSES.index(name))
        return
    for field, value in plain_pass(ws, name).items():
        getattr(ws, field).copy_(value)


class SsdScan(torch.autograd.Function):
    """The scan whose forward and backward are the kernels on CUDA and
    their plain versions on the CPU.  On CUDA it saves x, B, C and the
    forward's cum, C B^T and prev scratch, so that the backward recomputes
    none of passes 1-4; on the CPU the inputs."""

    @staticmethod
    def forward(ctx, x, dA, B, C, q: int, initial_state):
        ctx.set_materialize_grads(False)
        ctx.q = q
        if x.device.type == "cpu":
            ctx.save_for_backward(x, dA, B, C, initial_state)
            return ssd_ref(x, dA, B, C, q, initial_state)
        ctx.init = initial_state is not None
        with launch("ssd_scan", lambda: _cost_of(x, B, q, ctx.init)):
            ws = workspace(x, dA, B, C, q, initial_state)
            if any(ctx.needs_input_grad):
                _check_bwd_kernel(x, B, C)  # refuse before the forward, not in the backward
            if x.device.type == "cuda":
                _launch(ws, _ALL)
        if x.device.type == "cuda":
            count_launch(ssd)
        ctx.save_for_backward(x, B, C, ws.cum, ws.cb, ws.prev)
        return ws.y, ws.final

    @staticmethod
    def backward(ctx, dy, dfinal):
        q = ctx.q
        saved = ctx.saved_tensors  # once: remat's checkpoint unpacks each saved tensor once
        if saved[0].device.type == "cpu":
            x, dA, B, C, init = saved
            if dy is None:
                dy = torch.zeros_like(x)
            dx, d_dA, dB, dC, d_init = ssd_bwd_ref(x, dA, B, C, q, init, dy, dfinal)
        else:
            x, B, C, cum, cb, prev = saved
            fwd = Workspace(x=x, dA=None, B=B, C=C, chunk=q, initial_state=None, cum=cum, cb=cb,
                            states=None, prev=prev, y=None, final=None)
            with launch("ssd_scan_bwd",
                        lambda: _cost_of(x, B, q, ctx.init, True, dfinal is not None)):
                bw = bwd_workspace(fwd, dy, dfinal)
                if x.device.type == "cuda":
                    _launch_bwd(bw, _BWD_ALL)
            if x.device.type == "cuda":
                count_launch(ssd, "backward_launches")
            dx, d_dA, dB, dC, d_init = bw.dx, bw.d_dA, bw.dB, bw.dC, bw.d_init
        return dx, d_dA, dB, dC, None, d_init if ctx.needs_input_grad[5] else None


def ssd(
    x: torch.Tensor,  # [B, S, H, P] (dt-weighted)
    dA: torch.Tensor,  # [B, S, H] (dt * A)
    B: torch.Tensor,  # [B, S, G, N]
    C: torch.Tensor,  # [B, S, G, N]
    chunk: int = 256,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD over chunks of ``min(chunk, S)`` positions, which must
    divide S (the JAX wrapper's rule); returns (y [B, S, H, P] in x's dtype,
    final_state [B, H, P, N] fp32), differentiable in x, dA, B, C and the
    initial state."""
    q = _check(x, dA, B, C, chunk, initial_state)
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"ssd: no kernel for device {x.device}")
    return SsdScan.apply(x, dA, B, C, q, initial_state)


ssd.launches = 0
ssd.backward_launches = 0
