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
        acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, v[:, k0:k1].float())
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
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.einsum("bhgqk,bkhd->bqhgd", ds, kb)
        dk[:, k0:k1] = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
        dv[:, k0:k1] = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return (
        dq.reshape(b, sq, hq, d).to(q.dtype),
        dk.to(k.dtype),
        dv.to(v.dtype),
    )
