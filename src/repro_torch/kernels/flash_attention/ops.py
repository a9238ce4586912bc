"""Wrapper of the flash-attention kernels (``csrc/flash_attention.cu``).

``flash_attention`` is a ``torch.autograd.Function``.  On CUDA tensors its
forward launches the forward kernel and its backward the backward kernels
(or they raise); on CPU tensors both run the plain versions in :mod:`.ref`;
on meta tensors both check the instance and return empty outputs (the dry
run).  :func:`cost` is one launch's work.  ``flash_attention.launches``
counts forward launches and
``flash_attention.backward_launches`` backward launches (three kernels
each: delta, dK/dV, dQ, and a fold of the dK/dV parts where the group is
taken in head parts); the plain versions do not count.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import KernelCost, build, count_launch, launch
from .ref import flash_attention_bwd_ref, flash_attention_ref

#: the instances the CUDA source is compiled for, both ways (the group is a
#: runtime argument; G 48 is granite-34b's 48 query heads over one kv head,
#: G 6 and G 12 its heads a rank at model 8 and model 4)
HEAD_DIMS = (64, 80, 128, 256)
GROUPS = (1, 2, 3, 4, 6, 8, 12, 48)
#: the bf16 dK/dV kernel's head parts by group: its 32-row query tiles hold
#: 32 / (G / P) positions of the G / P heads of one part (G 48: none whole),
#: each part writes fp32 scratch, and a fold kernel sums the parts in order.
#: Each group takes the fastest P at granite-34b's training shape
#: [2, 8192, G/1, 128] on an H100 80GB HBM3 at 700 W
#: (tools/time_port_kernels.py --sweep b1bwd): G 48 6 parts of 8 heads
#: (35.39 ms; P 2-48: 35.39-41.50), G 12 6 of 2 (8.44 ms; whole 16.25, P 2-12
#: 8.44-8.89), G 6 6 of 1 (4.33 ms; whole 7.01, P 2-3 4.44-4.53): whole, the
#: grid has B x Sk / 128 blocks, fewer than the card's 132 SMs
HEAD_PARTS = {6: 6, 12: 6, 48: 6}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_Strides = ctypes.c_longlong * 3


class FlashArgs(ctypes.Structure):
    """The C struct ``FlashArgs`` of the CUDA source, field for field."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "dtype", "batch", "seq_q", "seq_k", "n_kv_heads", "group", "head_dim",
            "causal", "window", "head_parts")]
        + [("scale", ctypes.c_float)]
        + [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "o", "dout", "out", "dq", "dk", "dv", "lse", "delta", "dkv_part")]
        + [(n, _Strides) for n in (
            "q_s", "k_s", "v_s", "o_s", "do_s", "dq_s", "dk_s", "dv_s")]
        + [("stream", ctypes.c_void_p)]
    )


#: the [B, S, H, D] tensors whose strides the kernels take, by field
_STRIDE_FIELDS = dict(q="q_s", k="k_s", v="v_s", o="o_s", dout="do_s", dq="dq_s", dk="dk_s", dv="dv_s")

_entries = {}


def _entry(name: str):
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(build.load("flash_attention"), name)
        fn.argtypes = [ctypes.POINTER(FlashArgs)]
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _check(q, k, v):
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {dev}")
        if t.dtype != q.dtype:
            raise TypeError("flash_attention: q, k and v must share a dtype")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    if d not in HEAD_DIMS or hq // hkv not in GROUPS:
        raise NotImplementedError(
            f"flash_attention kernel has no instance for head_dim={d}, group={hq // hkv} "
            f"(built for {HEAD_DIMS} x {GROUPS})"
        )


def kept_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs that the mask keeps in one (batch, head) of an
    attention of sq queries at positions 0.. over sk keys at 0..: the work a
    kernel that skips the rest does."""
    import numpy as np

    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(q, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def cost(b: int, sq: int, sk: int, hq: int, hkv: int, d: int, causal: bool, window,
         item: int = 2, backward: bool = False) -> KernelCost:
    """One launch's work on [b, sq, hq, d] queries over [b, sk, hkv, d] keys
    and values of ``item`` bytes an element.  Forward: q, k, v in, out and
    the fp32 lse out; 4 x pairs x D products.  Backward: q, k, v, out, dout
    and lse in, dq, dk, dv out; 10 x pairs x D products (the kernels
    execute 14: P is recomputed).  bf16 products at the bf16 tensor-core
    peak, fp32 ones at the fp32 CUDA-core peak."""
    from ...launch.roofline import BF16_FLOPS, FP32_FLOPS

    pairs = b * hq * kept_pairs(sq, sk, causal, window)
    io = (2 * b * sq * hq * d + 2 * b * sk * hkv * d) * item
    lse_bytes = b * hq * sq * 4
    flops = (10 if backward else 4) * pairs * d
    peak = BF16_FLOPS if item == 2 else FP32_FLOPS
    return KernelCost((2 * io if backward else io) + lse_bytes, flops, flops, peak)


def _cost_of(q, k, causal, window, backward=False) -> KernelCost:
    b, sq, hq, d = q.shape
    return cost(b, sq, k.shape[1], hq, k.shape[2], d, causal, window, q.element_size(),
                backward)


def _strides(t: torch.Tensor, name: str):
    """(batch, seq, head) strides of a [B, S, H, D] tensor whose head dim is
    contiguous and whose rows are 16-byte aligned, as the kernel reads them."""
    item = t.element_size()
    if t.stride(3) != 1:
        raise ValueError(f"flash_attention: {name} must have a contiguous head dim")
    if t.data_ptr() % 16 or any((t.stride(i) * item) % 16 for i in range(3)):
        raise ValueError(f"flash_attention: {name} must be 16-byte aligned in its base and strides")
    return _Strides(t.stride(0), t.stride(1), t.stride(2))


def _args(q, k, v, causal, window, scale, **tensors) -> FlashArgs:
    b, sq, hq, d = q.shape
    a = FlashArgs(
        dtype=_DTYPE_CODES[q.dtype], batch=b, seq_q=sq, seq_k=k.shape[1],
        n_kv_heads=k.shape[2], group=hq // k.shape[2], head_dim=d,
        causal=int(causal), window=window or 0, head_parts=1, scale=scale,
        stream=torch.cuda.current_stream(q.device).cuda_stream,
    )
    for name, t in dict(q=q, k=k, v=v, **tensors).items():
        setattr(a, name, t.data_ptr())
        if name in _STRIDE_FIELDS:
            setattr(a, _STRIDE_FIELDS[name], _strides(t, name))
    return a


def _run(entry: str, a: FlashArgs) -> None:
    rc = _entry(entry)(ctypes.byref(a))
    if rc != 0:
        raise RuntimeError(f"{entry} failed (cudaError {rc})")


def _fwd_kernel(q, k, v, causal, window, scale):
    """The forward kernel on CUDA tensors; on meta tensors its checks and
    outputs only."""
    _check(q, k, v)
    b, sq, hq, _ = q.shape
    with launch("flash_attention", lambda: _cost_of(q, k, causal, window)):
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
        lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
        if q.device.type == "meta":
            return out, lse
        a = _args(q, k, v, causal, window, scale, o=out, out=out, lse=lse)
        _run("flash_attention_fwd_launch", a)
    count_launch(flash_attention)
    return out, lse


def _bwd_kernel(q, k, v, out, lse, dout, causal, window, scale):
    """The backward kernels on CUDA tensors; on meta tensors their checks,
    scratch and outputs only."""
    _check(q, k, v)
    b, sq, hq, _ = q.shape
    g = hq // k.shape[2]
    if dout.device != q.device or dout.dtype != q.dtype:
        raise TypeError("flash_attention: dout must match q's device and dtype")
    with launch("flash_attention_bwd", lambda: _cost_of(q, k, causal, window, backward=True)):
        if dout.stride(3) != 1 or any((dout.stride(i) * dout.element_size()) % 16
                                      for i in range(3)):
            dout = dout.contiguous()  # autograd may hand over a broadcast or sliced view
        dq = torch.empty_like(q, memory_format=torch.contiguous_format)
        dk = torch.empty_like(k, memory_format=torch.contiguous_format)
        dv = torch.empty_like(v, memory_format=torch.contiguous_format)
        delta = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
        parts = HEAD_PARTS.get(g, 1) if q.dtype == torch.bfloat16 else 1  # fp32: never split
        scratch = (torch.empty((parts, 2, *k.shape), dtype=torch.float32, device=q.device)
                   if parts > 1 else None)
        if q.device.type == "meta":
            return dq, dk, dv
        a = _args(q, k, v, causal, window, scale, o=out, dout=dout, dq=dq, dk=dk, dv=dv,
                  lse=lse, delta=delta)
        if scratch is not None:
            a.head_parts, a.dkv_part = parts, scratch.data_ptr()
        _run("flash_attention_bwd_launch", a)
    count_launch(flash_attention, "backward_launches")
    return dq, dk, dv


def flash_attention_fwd(q, k, v, causal: bool = True, window: Optional[int] = None):
    """(out [B, Sq, Hq, D], lse [B, Hq, Sq] fp32): the forward kernel on
    CUDA tensors (empty outputs on meta tensors), its plain version on CPU
    tensors; no autograd."""
    scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, sm_scale=scale)
    if q.device.type in ("cuda", "meta"):
        return _fwd_kernel(q, k, v, causal, window, scale)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True, window: Optional[int] = None):
    """(dq, dk, dv) from what the forward saved: the backward kernels on CUDA
    tensors (empty outputs on meta tensors), the plain version on CPU
    tensors."""
    scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(
            q, k, v, out, lse, dout, causal=causal, window=window, sm_scale=scale
        )
    if q.device.type in ("cuda", "meta"):
        return _bwd_kernel(q, k, v, out, lse, dout, causal, window, scale)
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


class FlashAttention(torch.autograd.Function):
    """Attention whose forward and backward are the flash kernels on CUDA
    and their plain versions on the CPU; saves (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        out, lse = flash_attention_fwd(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.causal, ctx.window)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,  # [B, Sq, Hq, D] (model layout)
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """GQA attention with query i and key j at positions i and j; returns
    [B, Sq, Hq, D] in q's dtype and is differentiable in q, k and v."""
    b, sq, hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match"
        )
    if hq % k.shape[2]:
        raise ValueError(f"flash_attention: {hq} query heads over {k.shape[2]} kv heads")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")
    return FlashAttention.apply(q, k, v, causal, window)


flash_attention.launches = 0
flash_attention.backward_launches = 0
