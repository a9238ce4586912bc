"""Wrapper of the SSD chunk-scan kernel (``csrc/ssd_scan.cu``).

On CPU tensors it runs the plain version in :mod:`.ref`; on CUDA tensors it
launches the kernel or raises, with or without an initial state.
``ssd.launches`` counts the kernel launches (the plain version does not
count).  There is no backward kernel: a CUDA call that needs a gradient
raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import build
from .ref import ssd_ref

#: the instances the CUDA source is compiled for
HEAD_DIMS = (64,)
D_STATES = (64, 128)
MAX_CHUNK = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_Strides = ctypes.c_longlong * 3


class SsdArgs(ctypes.Structure):
    """The C struct ``SsdArgs`` of the CUDA source, field for field."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "dtype", "batch", "seq", "heads", "groups", "head_dim", "d_state", "chunk",
            "has_init")]
        + [(n, ctypes.c_void_p) for n in ("x", "dA", "B", "C", "init", "y", "final_state")]
        + [(n, _Strides) for n in ("x_s", "a_s", "b_s", "c_s", "y_s")]
        + [("stream", ctypes.c_void_p)]
    )


_entry = None


def _launcher():
    global _entry
    if _entry is None:
        fn = build.load("ssd_scan").ssd_scan_launch
        fn.argtypes = [ctypes.POINTER(SsdArgs)]
        fn.restype = ctypes.c_int
        _entry = fn
    return _entry


def _launch(x, dA, B, C, q, initial_state):
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
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
    y = torch.empty((b, s, h, p), dtype=x.dtype, device=dev)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    a = SsdArgs(
        dtype=_DTYPE_CODES[x.dtype], batch=b, seq=s, heads=h, groups=g, head_dim=p,
        d_state=n, chunk=q, has_init=int(initial_state is not None),
        x=x.data_ptr(), dA=dA.data_ptr(), B=B.data_ptr(), C=C.data_ptr(),
        init=initial_state.data_ptr() if initial_state is not None else None,
        y=y.data_ptr(), final_state=final.data_ptr(),
        x_s=_Strides(*x.stride()[:3]), a_s=_Strides(*dA.stride()),
        b_s=_Strides(*B.stride()[:3]), c_s=_Strides(*C.stride()[:3]),
        y_s=_Strides(*y.stride()[:3]),
        stream=torch.cuda.current_stream(dev).cuda_stream,
    )
    rc = _launcher()(ctypes.byref(a))
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed (cudaError {rc})")
    ssd.launches += 1
    return y, final


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
    if x.device.type == "cpu":
        return ssd_ref(x, dA, B, C, q, initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    tensors = (x, dA, B, C) + ((initial_state,) if initial_state is not None else ())
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError("ssd: the chunk scan has no backward kernel")
    return _launch(x, dA, B, C, q, initial_state)


ssd.launches = 0
