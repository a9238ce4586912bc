"""Wrapper of the decode-attention kernel (``csrc/decode_attention.cu``).

On CPU tensors it runs the plain version in :mod:`.ref`; on CUDA tensors it
launches the kernel or raises; on meta tensors it checks the instance and
returns an empty output (the dry run).  :func:`cost` is one launch's work.
``decode_attention.launches`` counts the kernel launches (the plain version
does not count).  One call is one launch
of the kernel, clustered as :func:`split_plan` says, and allocates only the
output.

:func:`decode_attention_partial` is the kernel's partial mode, for a cache
whose sequence dim is split over ranks: over this rank's slots it returns
the fp32 output and each row's log-sum-exp (-inf where no slot of the range
is kept), which :func:`fold_partials` folds over the ranks.  Its launches
count in ``decode_attention.partial_launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from .. import KernelCost, build, count_launch, launch
from .ref import decode_attention_partial_ref, decode_attention_ref

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
#: G 48: granite-34b's 48 query heads over one kv head; G 6 and G 12: its
#: heads a rank at model 8 and model 4)
HEAD_DIMS = (64, 80, 128, 256)
GROUPS = (1, 2, 3, 4, 6, 8, 12, 48)
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
        launch.argtypes = [i32] + [ptr] * 7 + [i32] * 8 + [ctypes.c_float] + [i64] * 13 + [ptr]
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


def cost(b: int, sk: int, hq: int, hkv: int, d: int, n_valid: int, item: int = 2,
         partial: bool = False) -> KernelCost:
    """One launch's work over a cache of ``sk`` slots of which ``n_valid``
    (batch, slot) pairs are attended: those K and V rows, q in and out, the
    slot positions (one row, broadcast) and the query positions; 4 x
    n_valid x Hq x D products, taken at the bf16 tensor-core peak (the
    kernel multiplies on the CUDA cores in fp32, its own ceiling).  The
    partial mode writes its output in fp32 and one fp32 log-sum-exp a row."""
    from ...launch.roofline import BF16_FLOPS

    out_bytes = b * hq * (d * 4 + 4) if partial else b * hq * d * item
    n_bytes = 2 * n_valid * hkv * d * item + b * hq * d * item + out_bytes + sk * 4 + b * 4
    flops = 4 * n_valid * hq * d
    return KernelCost(n_bytes, flops, flops, BF16_FLOPS)


def _launch_cost(q3, k_cache, window, partial=False) -> KernelCost:
    """The cost an observer is given, from shapes alone (meta tensors hold
    no positions; on CUDA reading them would stall the stream): every slot
    of every row attended, within the window if there is one."""
    b, hq, d = q3.shape
    _, sk, hkv, _ = k_cache.shape
    n_valid = b * (min(sk, window) if window else sk)
    return cost(b, sk, hq, hkv, d, n_valid, q3.element_size(), partial)


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


def _launch(q3, k_cache, v_cache, positions_q, positions_k, window, sm_scale,
            partial: bool = False):
    """The kernel on CUDA tensors (in the partial mode: (fp32 out, lse)); on
    meta tensors its checks and outputs only."""
    b, hq, d = q3.shape
    _, sk, hkv, _ = k_cache.shape
    g = hq // hkv
    dev = q3.device
    _check(q3, k_cache, v_cache, positions_q, positions_k)
    name = "decode_attention_partial" if partial else "decode_attention"
    with launch(name, lambda: _launch_cost(q3, k_cache, window, partial)):
        out = torch.empty((b, hq, d), dtype=torch.float32 if partial else q3.dtype, device=dev)
        lse = torch.empty((b, hq), dtype=torch.float32, device=dev) if partial else None
        if dev.type == "meta":
            return (out, lse) if partial else out
        # K and V rows go to shared memory as 16-byte cp.async copies
        _check_aligned("k_cache", k_cache, (0, 1, 2), 16)
        _check_aligned("v_cache", v_cache, (0, 1, 2), 16)
        n_split, split_len = split_plan(b, hkv, sk, device_sms(dev))
        occupancy(q3.dtype, d, g, n_split)
        rc = _kernel_fns()[0](
            _DTYPE_CODES[q3.dtype],
            q3.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            positions_q.data_ptr(), positions_k.data_ptr(), out.data_ptr(),
            lse.data_ptr() if partial else None,
            b, hkv, g, d, sk, split_len, n_split, window or 0, sm_scale,
            q3.stride(0), q3.stride(1),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            positions_k.stride(0), out.stride(0), out.stride(1),
            lse.stride(0) if partial else 0, lse.stride(1) if partial else 0,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"decode_attention kernel launch failed (cudaError {rc})")
    count_launch(decode_attention, "partial_launches" if partial else "launches")
    return (out, lse) if partial else out


def _check_args(q, k_cache, v_cache, positions_q, positions_k, window) -> None:
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


def decode_attention_partial(
    q: torch.Tensor,  # [B, 1, Hq, D]
    k_cache: torch.Tensor,  # [B, Sk_local, Hkv, D]: this rank's slots
    v_cache: torch.Tensor,
    positions_q: torch.Tensor,  # [B] int32
    positions_k: torch.Tensor,  # [B, Sk_local] int32: the positions those slots hold
    *,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The partial mode over one rank's range of a split cache: (out [B, Hq,
    D] fp32, normalised over the range's kept slots, 0 where none is kept;
    lse [B, Hq] fp32, the natural log-sum-exp of the kept slots' scaled
    scores, -inf where none is kept).  A range of any length >= 1 is taken
    (one block a (batch, kv head) below MIN_SPLIT_LEN slots)."""
    _check_args(q, k_cache, v_cache, positions_q, positions_k, window)
    sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return decode_attention_partial_ref(
            q[:, 0], k_cache, v_cache, positions_q, positions_k, window=window,
            sm_scale=sm_scale)
    if q.device.type in ("cuda", "meta"):
        return _launch(q[:, 0], k_cache, v_cache, positions_q, positions_k, window, sm_scale,
                       partial=True)
    raise ValueError(f"decode_attention: no kernel for device {q.device}")


def fold_partials(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The ranks' partials folded in rank order in fp32: outs [R, B, Hq, D]
    and lses [R, B, Hq] (dim 0 the ranks of the split, in the order of
    their slot ranges) -> [B, Hq, D] = sum_r exp(lse_r - lse) out_r, lse
    the rows' log-sum-exp over the ranks; a rank whose lse is -inf adds
    nothing, and a row with no kept slot anywhere gives 0."""
    top = lses.amax(dim=0)
    base = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    out = torch.zeros(outs.shape[1:], dtype=torch.float32, device=outs.device)
    total = torch.zeros(lses.shape[1:], dtype=torch.float32, device=lses.device)
    for r in range(outs.shape[0]):
        w = torch.exp(lses[r] - base)  # 0 where lse_r is -inf
        total = total + w
        out = out + w[..., None] * outs[r]
    return torch.where(total[..., None] > 0, out / total.clamp_min(1e-30)[..., None], 0.0)


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
    _check_args(q, k_cache, v_cache, positions_q, positions_k, window)
    sm_scale = q.shape[-1] ** -0.5
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
decode_attention.partial_launches = 0
