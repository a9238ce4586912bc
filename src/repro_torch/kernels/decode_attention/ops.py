"""Wrapper of the decode-attention kernel (``csrc/decode_attention.cu``).

On CPU tensors it runs the plain version in :mod:`.ref`; on CUDA tensors it
launches the kernel or raises; on meta tensors it checks the instance and
returns an empty output (the dry run).  :func:`cost` is one launch's work.
``decode_attention.launches`` counts the kernel launches (the plain version
does not count).  One call is one launch
of the kernel, clustered as :func:`split_plan` says, and allocates only the
output.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from .. import KernelCost, build, count_launch, launch
from .ref import decode_attention_ref

#: most blocks that share one (batch, kv head): a thread-block cluster
#: (above 8 a non-portable size, which Hopper allows up to 16)
MAX_SPLIT = 16
#: fewest cache slots worth a block of their own
MIN_SPLIT_LEN = 16
#: blocks a streaming multiprocessor is given: the plan cuts the cache into
#: up to this many blocks per SM over the B*Hkv clusters (2 measured best on
#: the H100 for zamba2-1.2b's 128 clusters; 3 and 4 no longer fit in one wave)
BLOCKS_PER_SM = 2
#: the instances the CUDA source is compiled for (D 80: h2o-danube-1.8b;
#: G 48: granite-34b's 48 query heads over one kv head)
HEAD_DIMS = (64, 80, 128, 256)
GROUPS = (1, 2, 3, 4, 8, 48)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_fns = None
_occupancy: Dict[tuple, Tuple[int, int]] = {}


def split_plan(b: int, hkv: int, sk: int, sms: int) -> Tuple[int, int]:
    """(n_split, split_len): the cache's Sk slots cut into n_split splits of
    split_len slots (the last one may be shorter, none is empty), one block
    each, so that the B*Hkv clusters of n_split blocks roughly fill ``sms``
    streaming multiprocessors: n_split = BLOCKS_PER_SM * sms // (B*Hkv),
    within [1, MAX_SPLIT] and at most one split per MIN_SPLIT_LEN slots."""
    n = max(1, min(MAX_SPLIT, BLOCKS_PER_SM * sms // max(1, b * hkv),
                   math.ceil(sk / MIN_SPLIT_LEN)))
    split_len = math.ceil(sk / n)
    return math.ceil(sk / split_len), split_len


def _kernel_fns():
    """(launch, occupancy) entry points of the built library."""
    global _fns
    if _fns is None:
        lib = build.load("decode_attention")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        launch, occ = lib.decode_attention_launch, lib.decode_attention_occupancy
        launch.argtypes = [i32] + [ptr] * 6 + [i32] * 8 + [ctypes.c_float] + [i64] * 11 + [ptr]
        occ.argtypes = [i32] * 4 + [ctypes.POINTER(i32)] * 2
        launch.restype = occ.restype = i32
        _fns = (launch, occ)
    return _fns


def occupancy(dtype: torch.dtype, d: int, g: int, n_split: int) -> Tuple[int, int]:
    """(clusters of n_split blocks the card holds at once, shared memory
    bytes of a block) of the kernel instance for ``dtype``, head dim ``d``
    and group ``g``; asked of the CUDA runtime once per instance and split.
    Raises if no such cluster fits on the card."""
    key = (dtype, d, g, n_split)
    if key not in _occupancy:
        clusters, smem = ctypes.c_int(0), ctypes.c_int(0)
        rc = _kernel_fns()[1](_DTYPE_CODES[dtype], d, g, n_split,
                              ctypes.byref(clusters), ctypes.byref(smem))
        if rc != 0:
            raise RuntimeError(f"decode_attention occupancy query failed (cudaError {rc})")
        if clusters.value == 0:
            raise RuntimeError(
                f"decode_attention: a cluster of {n_split} blocks of {smem.value} bytes of "
                f"shared memory (dtype {dtype}, D {d}, G {g}) does not fit on this card"
            )
        _occupancy[key] = (clusters.value, smem.value)
    return _occupancy[key]


def device_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_aligned(name: str, t: torch.Tensor, dims, align: int) -> None:
    item = t.element_size()
    if t.data_ptr() % align or any((t.stride(i) * item) % align for i in dims):
        raise ValueError(
            f"decode_attention: {name} must be {align}-byte aligned in its base "
            f"pointer and strides {tuple(t.stride(i) for i in dims)}"
        )


def cost(b: int, sk: int, hq: int, hkv: int, d: int, n_valid: int, item: int = 2) -> KernelCost:
    """One launch's work over a cache of ``sk`` slots of which ``n_valid``
    (batch, slot) pairs are attended: those K and V rows, q in and out, the
    slot positions (one row, broadcast) and the query positions; 4 x
    n_valid x Hq x D products, taken at the bf16 tensor-core peak (the
    kernel multiplies on the CUDA cores in fp32, its own ceiling)."""
    from ...launch.roofline import BF16_FLOPS

    n_bytes = 2 * n_valid * hkv * d * item + 2 * b * hq * d * item + sk * 4 + b * 4
    flops = 4 * n_valid * hq * d
    return KernelCost(n_bytes, flops, flops, BF16_FLOPS)


def _launch_cost(q3, k_cache, window) -> KernelCost:
    """The cost an observer is given, from shapes alone (meta tensors hold
    no positions; on CUDA reading them would stall the stream): every slot
    of every row attended, within the window if there is one."""
    b, hq, d = q3.shape
    _, sk, hkv, _ = k_cache.shape
    n_valid = b * (min(sk, window) if window else sk)
    return cost(b, sk, hq, hkv, d, n_valid, q3.element_size())


def _check(q3, k_cache, v_cache, positions_q, positions_k) -> None:
    """The kernel's device, dtype and instance rules."""
    b, hq, d = q3.shape
    g = hq // k_cache.shape[2]
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


def _launch(q3, k_cache, v_cache, positions_q, positions_k, window, sm_scale):
    """The kernel on CUDA tensors; on meta tensors its checks and output only."""
    b, hq, d = q3.shape
    _, sk, hkv, _ = k_cache.shape
    g = hq // hkv
    dev = q3.device
    _check(q3, k_cache, v_cache, positions_q, positions_k)
    with launch("decode_attention", lambda: _launch_cost(q3, k_cache, window)):
        out = torch.empty((b, hq, d), dtype=q3.dtype, device=dev)
        if dev.type == "meta":
            return out
        # K and V rows go to shared memory as 16-byte cp.async copies
        _check_aligned("k_cache", k_cache, (0, 1, 2), 16)
        _check_aligned("v_cache", v_cache, (0, 1, 2), 16)
        n_split, split_len = split_plan(b, hkv, sk, device_sms(dev))
        occupancy(q3.dtype, d, g, n_split)
        rc = _kernel_fns()[0](
            _DTYPE_CODES[q3.dtype],
            q3.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            positions_q.data_ptr(), positions_k.data_ptr(), out.data_ptr(),
            b, hkv, g, d, sk, split_len, n_split, window or 0, sm_scale,
            q3.stride(0), q3.stride(1),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            positions_k.stride(0), out.stride(0), out.stride(1),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"decode_attention kernel launch failed (cudaError {rc})")
    count_launch(decode_attention)
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
    elif q.device.type in ("cuda", "meta"):
        out = _launch(q[:, 0], k_cache, v_cache, positions_q, positions_k, window, sm_scale)
    else:
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    return out[:, None]


decode_attention.launches = 0
