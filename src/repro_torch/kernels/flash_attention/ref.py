"""Plain PyTorch version of the flash-attention kernels.

The same functions as ``csrc/flash_attention.cu``, in fp32, on the model
layout [B, S, H, D], with query i and key j at positions i and j (the
teacher-forced forward).  Key j takes part in query i's row iff j < Sk, and
``j <= i`` when causal, and ``i - j < window`` with a window.

* :func:`flash_attention_ref` -- the forward (``attention_ref`` semantics of
  the JAX package) and the fp32 log-sum-exp ``[B, Hq, Sq]`` of each row's
  scaled scores.  It folds the keys tile by tile with an online softmax, as
  ``repro.models.blocked_attention._fwd_impl`` does, so no [Sq, Sk] score
  matrix of the whole sequence is held.
* :func:`flash_attention_bwd_ref` -- the backward, a copy of
  ``_bwd_rule`` in ``repro/models/blocked_attention.py``: with
  delta = sum_d dout * out, each key tile rebuilds P = exp(S - lse) and adds
  its share of dq, dk and dv.

A row with no key in its mask gives 0 and a log-sum-exp of -inf, as the
kernels do, and no gradient.

``p_dtype`` (default ``None``: everything in fp32) rounds P to that dtype
before P·V, and P and dS before the dV, dK and dQ products: the points where
the bf16 tensor-core kernels round their A operands.  With ``block_k`` set to
:func:`kernel_key_tile`, the forward also folds keys in the kernel's tiles,
so its running maxima, and with them its rounded P, are the kernel's.
:func:`rounding_ratios` is the check that the card's tests hold the bf16
kernels to with it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

#: keys folded per step; the same tile as ``blocked_attention``'s default
BLOCK_K = 1024


def _mask(sq: int, k0: int, k1: int, sk: int, causal: bool, window: Optional[int], device):
    """[Sq, k1 - k0] bool: which (query, key) pairs of keys k0..k1 take part."""
    qpos = torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(k0, k1, device=device)[None, :]
    m = kpos < sk
    if causal:
        m = m & (kpos <= qpos)
    if window is not None:
        m = m & (qpos - kpos < window)
    return m


def flash_attention_ref(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
    block_k: int = BLOCK_K,
    p_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out [B, Sq, Hq, D] in q's dtype, lse [B, Hq, Sq] fp32)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = sm_scale if sm_scale is not None else d**-0.5
    qf = q.float().reshape(b, sq, hkv, g, d)
    m_run = torch.full((b, hkv, g, sq), float("-inf"), device=q.device)
    l_run = torch.zeros((b, hkv, g, sq), device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), device=q.device)
    for k0 in range(0, sk, block_k):
        k1 = min(k0 + block_k, sk)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k[:, k0:k1].float()) * scale
        msk = _mask(sq, k0, k1, sk, causal, window, q.device)
        s = s.masked_fill(~msk, float("-inf"))
        m_new = torch.maximum(m_run, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        p = torch.exp(s - m_safe[..., None])  # exp(-inf) = 0 where masked
        alpha = torch.exp(m_run - m_safe)
        l_run = l_run * alpha + p.sum(-1)
        pv = p if p_dtype is None else p.to(p_dtype).float()
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", pv, v[:, k0:k1].float())
        m_run = m_new
    out = acc / l_run.clamp_min(1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
    lse = torch.where(l_run > 0, m_run + torch.log(l_run), torch.full_like(l_run, float("-inf")))
    return out, lse.reshape(b, hq, sq)


def flash_attention_bwd_ref(
    q: torch.Tensor,  # [B, Sq, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,
    out: torch.Tensor,  # [B, Sq, Hq, D]
    lse: torch.Tensor,  # [B, Hq, Sq] fp32
    dout: torch.Tensor,  # [B, Sq, Hq, D]
    *,
    causal: bool = True,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
    block_k: int = BLOCK_K,
    p_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (dq, dk, dv), each in its input's dtype."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = sm_scale if sm_scale is not None else d**-0.5
    qf = q.float().reshape(b, sq, hkv, g, d)
    dof = dout.float().reshape(b, sq, hkv, g, d)
    of = out.float().reshape(b, sq, hkv, g, d)
    delta = torch.einsum("bqhgd,bqhgd->bhgq", dof, of)
    lse5 = lse.reshape(b, hkv, g, sq)[..., None]
    dq = torch.zeros((b, sq, hkv, g, d), device=q.device)
    dk = torch.zeros((b, sk, hkv, d), device=q.device)
    dv = torch.zeros((b, sk, hkv, d), device=q.device)
    for k0 in range(0, sk, block_k):
        k1 = min(k0 + block_k, sk)
        kb, vb = k[:, k0:k1].float(), v[:, k0:k1].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb) * scale
        msk = _mask(sq, k0, k1, sk, causal, window, q.device)
        p = torch.where(msk, torch.exp(s - lse5), torch.zeros_like(s))
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vb)
        ds = p * (dp - delta[..., None])
        if p_dtype is not None:
            p, ds = p.to(p_dtype).float(), ds.to(p_dtype).float()
        ds = ds * scale
        dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, kb)
        dk[:, k0:k1] = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
        dv[:, k0:k1] = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return (
        dq.reshape(b, sq, hq, d).to(q.dtype),
        dk.to(k.dtype),
        dv.to(v.dtype),
    )


def kernel_key_tile(head_dim: int) -> int:
    """Keys per tile of the bf16 forward kernel (``FwdCfg::BK`` in
    ``csrc/flash_attention.cu``)."""
    return 32 if head_dim > 128 else 64


def _half_ulp(x: torch.Tensor) -> torch.Tensor:
    """Half a unit in the last place of each element of ``x`` in its dtype
    (fp32; 0 at 0): the most that rounding to ``x``'s dtype moved it."""
    m, e = torch.frexp(x.float())
    half = torch.finfo(x.dtype).eps * torch.ldexp(torch.ones_like(m), e - 2)
    return torch.where(m == 0, torch.zeros_like(half), half)


def rounding_ratios(out: torch.Tensor, ref: torch.Tensor, ref_p: torch.Tensor) -> Tuple[float, float]:
    """How far a kernel that rounds inside stays within the error that the
    rounding alone gives; each ratio is at most 1 when it passes.

    ``ref`` is the plain version in fp32; ``ref_p`` is the plain version in
    fp32 that rounds where the kernel rounds (``p_dtype``, ``block_k =
    kernel_key_tile(D)``).  A row is the last dim: one query row of out or
    dq, one key row of dk or dv.

    * row ratio: for every row, max over the row of
      max(0, |out - ref| - half_ulp(out)) over
      2 x max over the row of |ref_p - ref| + 1e-5 x max(1, max over the row of |ref|).
      Half an ulp of ``out`` takes away the kernel's last rounding, to its
      output dtype; the floor is fp32 summation noise where the true value is
      about 0 (a causal row of one key has dq = dk = 0).
    * mean ratio: mean |out - ref| over 2 x mean |ref_p in out's dtype - ref|
      + 1e-5 x max(1, mean |ref|), over the whole tensor.
    """
    o, r, rp = out.float(), ref.float(), ref_p.float()
    excess = ((o - r).abs() - _half_ulp(out)).clamp_min(0)
    row_limit = 2 * (rp - r).abs().amax(-1) + 1e-5 * r.abs().amax(-1).clamp_min(1.0)
    row = (excess.amax(-1) / row_limit).max().item()
    yard = (rp.to(out.dtype).float() - r).abs().mean().item()
    mean = (o - r).abs().mean().item() / (2 * yard + 1e-5 * max(1.0, r.abs().mean().item()))
    return row, mean
