"""Wrapper of the SSD chunk-scan kernel (``csrc/ssd_scan.cu``).

On CPU tensors it runs the plain version in :mod:`.ref`; on CUDA tensors it
launches the kernel or raises, with or without an initial state.
``ssd.launches`` counts the kernel's calls, one per :func:`ssd` on the card
(the plain version does not count).  There is no backward kernel: a CUDA
call that needs a gradient raises ``NotImplementedError``.

The kernel runs as five passes (``PASSES``) over scratch that
:func:`workspace` allocates; :func:`run_pass` runs one of them, the kernel's
on CUDA tensors and its plain version on CPU tensors, and
:func:`plain_pass` computes a pass's plain version from the workspace's
current contents, so that a fault is found in the pass that makes it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from .. import build
from .ref import (
    ssd_carry_ref, ssd_cb_ref, ssd_chunk_states_ref, ssd_cum_ref, ssd_output_ref, ssd_ref,
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


_entry = None


def _launcher():
    global _entry
    if _entry is None:
        fn = build.load("ssd_scan").ssd_scan_launch
        fn.argtypes = [ctypes.POINTER(SsdArgs), ctypes.c_int]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


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
    if x.device.type == "cuda":
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
    rc = _launcher()(ctypes.byref(a), passes)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed (cudaError {rc})")


def plain_pass(ws: Workspace, name: str) -> Dict[str, torch.Tensor]:
    """The plain version of pass ``name`` on the workspace's inputs and its
    scratch as it stands: the values of the fields the pass writes."""
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
    raise ValueError(f"ssd: no pass {name!r}; the passes are {PASSES}")


def run_pass(ws: Workspace, name: str) -> None:
    """Runs pass ``name`` into the workspace: the kernel's on CUDA tensors,
    the plain version on CPU tensors.  Not counted in ``ssd.launches``."""
    if name not in PASSES:
        raise ValueError(f"ssd: no pass {name!r}; the passes are {PASSES}")
    if ws.x.device.type == "cuda":
        _launch(ws, 1 << PASSES.index(name))
        return
    for field, value in plain_pass(ws, name).items():
        getattr(ws, field).copy_(value)


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
    final_state [B, H, P, N] fp32)."""
    q = _check(x, dA, B, C, chunk, initial_state)
    if x.device.type == "cpu":
        return ssd_ref(x, dA, B, C, q, initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    tensors = (x, dA, B, C) + ((initial_state,) if initial_state is not None else ())
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("ssd: the chunk scan has no backward kernel")
    ws = workspace(x, dA, B, C, chunk, initial_state)
    _launch(ws, _ALL)
    ssd.launches += 1
    return ws.y, ws.final


ssd.launches = 0
