"""Wrapper of the decode-attention kernel (``csrc/decode_attention.cu``).

On CPU tensors it runs the plain version in :mod:`.ref`; on CUDA tensors it
launches the kernel or raises.  ``decode_attention.launches`` counts the
kernel launches (the plain version does not count).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import build
from .ref import decode_attention_ref

#: cache slots folded by one block of the first pass (the split-K chunk)
SPLIT_LEN = 32
#: the instances the CUDA source is compiled for
HEAD_DIMS = (64, 128, 256)
GROUPS = (1, 2, 4, 8)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_entry = None


def _launcher():
    global _entry
    if _entry is None:
        fn = build.load("decode_attention").decode_attention_launch
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = (
            [i32] + [ptr] * 8 + [i32] * 8 + [ctypes.c_float] + [i64] * 11 + [ptr]
        )
        fn.restype = i32
        _entry = fn
    return _entry


def _check_aligned(name: str, t: torch.Tensor, dims, align: int) -> None:
    item = t.element_size()
    if t.data_ptr() % align or any((t.stride(i) * item) % align for i in dims):
        raise ValueError(
            f"decode_attention: {name} must be {align}-byte aligned in its base "
            f"pointer and strides {tuple(t.stride(i) for i in dims)}"
        )


def _launch(q3, k_cache, v_cache, positions_q, positions_k, window, sm_scale):
    b, hq, d = q3.shape
    _, sk, hkv, _ = k_cache.shape
    g = hq // hkv
    dev = q3.device
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("positions_q", positions_q), ("positions_k", positions_k)):
        if t.device != dev:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {dev}")
    if q3.dtype not in _DTYPE_CODES:
        raise TypeError(f"decode_attention: unsupported dtype {q3.dtype}")
    if k_cache.dtype != q3.dtype or v_cache.dtype != q3.dtype:
        raise TypeError("decode_attention: q, k_cache and v_cache must share a dtype")
    if positions_q.dtype != torch.int32 or positions_k.dtype != torch.int32:
        raise TypeError("decode_attention: positions must be int32")
    if d not in HEAD_DIMS or g not in GROUPS:
        raise NotImplementedError(
            f"decode_attention kernel has no instance for head_dim={d}, "
            f"group={g} (built for {HEAD_DIMS} x {GROUPS})"
        )
    if q3.stride(2) != 1 or k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("decode_attention: head_dim must be the contiguous dim")
    if positions_q.stride(0) != 1 or positions_k.stride(1) != 1:
        raise ValueError("decode_attention: positions must be contiguous per row")
    align = min(16, (d // 32) * q3.element_size())
    _check_aligned("q", q3, (0, 1), align)
    _check_aligned("k_cache", k_cache, (0, 1, 2), align)
    _check_aligned("v_cache", v_cache, (0, 1, 2), align)

    out = torch.empty((b, hq, d), dtype=q3.dtype, device=dev)
    n_split = math.ceil(sk / SPLIT_LEN)
    part_acc = torch.empty(b * hkv * n_split * g * d, dtype=torch.float32, device=dev)
    part_ml = torch.empty(b * hkv * n_split * g * 2, dtype=torch.float32, device=dev)
    rc = _launcher()(
        _DTYPE_CODES[q3.dtype],
        q3.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        positions_q.data_ptr(), positions_k.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        b, hkv, g, d, sk, SPLIT_LEN, n_split, window or 0, sm_scale,
        q3.stride(0), q3.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        positions_k.stride(0), out.stride(0), out.stride(1),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed (cudaError {rc})")
    decode_attention.launches += 1
    return out


def decode_attention(
    q: torch.Tensor,  # [B, 1, Hq, D] (model layout, single step)
    k_cache: torch.Tensor,  # [B, Sk, Hkv, D]
    v_cache: torch.Tensor,  # [B, Sk, Hkv, D]
    positions_q: torch.Tensor,  # [B] int32: the query's absolute position
    positions_k: torch.Tensor,  # [B, Sk] int32: the position each slot holds
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One-token GQA attention over a (ring) KV cache; returns [B, 1, Hq, D]."""
    b, one, hq, d = q.shape
    _, sk, hkv, dk = k_cache.shape
    if one != 1:
        raise ValueError(f"decode_attention takes one query per row, got {one}")
    if v_cache.shape != k_cache.shape or dk != d or k_cache.shape[0] != b:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)}, k_cache {tuple(k_cache.shape)}, "
            f"v_cache {tuple(v_cache.shape)} do not match"
        )
    if hq % hkv:
        raise ValueError(f"decode_attention: {hq} query heads over {hkv} kv heads")
    if positions_q.shape != (b,) or positions_k.shape != (b, sk):
        raise ValueError("decode_attention: positions must be [B] and [B, Sk]")
    if window is not None and window <= 0:
        raise ValueError(f"decode_attention: window must be positive, got {window}")
    sm_scale = d**-0.5
    if q.device.type == "cpu":
        out = decode_attention_ref(
            q[:, 0], k_cache, v_cache, positions_q, positions_k,
            window=window, sm_scale=sm_scale,
        )
    elif q.device.type == "cuda":
        out = _launch(q[:, 0], k_cache, v_cache, positions_q, positions_k, window, sm_scale)
    else:
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    return out[:, None]


decode_attention.launches = 0
