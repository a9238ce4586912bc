"""Plain PyTorch version of the decode-attention kernel.

The same function as ``csrc/decode_attention.cu``, in fp32: one query row per
(batch, query head) against a cache in the model layout [B, Sk, Hkv, D]; slot
j takes part iff ``0 <= positions_k[b, j] <= positions_q[b]`` and, with a
window, ``positions_q[b] - positions_k[b, j] < window``.  A row with no slot
in the mask gives 0, as the kernel does.
"""

from __future__ import annotations

from typing import Optional

import torch


def decode_attention_ref(
    q: torch.Tensor,  # [B, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    positions_q: torch.Tensor,  # [B] int
    positions_k: torch.Tensor,  # [B, Sk] int
    *,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    b, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = sm_scale if sm_scale is not None else d**-0.5
    qf = q.float().reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k.float()) * scale
    dpos = positions_q.long()[:, None] - positions_k.long()  # [B, Sk]
    mask = (positions_k >= 0) & (dpos >= 0)
    if window is not None:
        mask &= dpos < window
    mask = mask[:, None, None, :]
    m = s.masked_fill(~mask, float("-inf")).amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    o = o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return o.reshape(b, hq, d).to(q.dtype)
