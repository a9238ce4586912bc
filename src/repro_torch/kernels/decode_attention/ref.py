"""Plain PyTorch version of the decode-attention kernel.

The same function as ``csrc/decode_attention.cu``, in fp32: one query row per
(batch, query head) against a cache in the model layout [B, Sk, Hkv, D]; slot
j takes part iff ``0 <= positions_k[b, j] <= positions_q[b]`` and, with a
window, ``positions_q[b] - positions_k[b, j] < window``.  A row with no slot
in the mask gives 0, as the kernel does.

``decode_attention_partial_ref`` is the plain version of the kernel's partial
mode (one rank's slot range of a split cache): the fp32 output over the
range and each row's log-sum-exp, -inf where the range keeps no slot.
"""

from __future__ import annotations

from typing import Optional, Tuple

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


def _keep(positions_q, positions_k, window):
    dpos = positions_q.long()[:, None] - positions_k.long()  # [B, Sk]
    keep = (positions_k >= 0) & (dpos >= 0)
    if window is not None:
        keep &= dpos < window
    return keep


def decode_attention_partial_ref(
    q: torch.Tensor,  # [B, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]: one rank's slots
    v: torch.Tensor,
    positions_q: torch.Tensor,  # [B] int
    positions_k: torch.Tensor,  # [B, Sk] int
    *,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, Hq, D] fp32 over the kept slots of this range, 0 where none
    is kept; lse [B, Hq] fp32 = log sum exp of the kept slots' scaled
    scores, -inf where none is kept)."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = sm_scale if sm_scale is not None else d**-0.5
    s = torch.einsum("bhgd,bkhd->bhgk", q.float().reshape(b, hkv, g, d), k.float()) * scale
    keep = _keep(positions_q, positions_k, window)[:, None, None, :]
    s = s.masked_fill(~keep, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    base = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(keep, torch.exp(s - base), torch.zeros_like(s))
    lsum = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    o = torch.where(lsum > 0, o / lsum.clamp_min(1e-30), torch.zeros_like(o))
    lse = torch.where(lsum[..., 0] > 0, base[..., 0] + torch.log(lsum[..., 0]),
                      torch.full_like(lsum[..., 0], float("-inf")))
    return o.reshape(b, hq, d), lse.reshape(b, hq)


def decode_attention_split_ref(
    q: torch.Tensor,  # [B, Hq, D]
    k: torch.Tensor,  # [B, Sk, Hkv, D]
    v: torch.Tensor,  # [B, Sk, Hkv, D]
    positions_q: torch.Tensor,  # [B] int
    positions_k: torch.Tensor,  # [B, Sk] int
    *,
    n_split: int,
    split_len: int,
    window: Optional[int] = None,
    sm_scale: Optional[float] = None,
    tile: int = 32,
    partial: bool = False,
):
    """The kernel's order of work in plain PyTorch, in fp32.  Split s (block
    s of a cluster) folds the slots [s*split_len, min((s+1)*split_len, Sk))
    tile by tile into an online-softmax partial (max m, sum l, acc) per query
    head, leaving a row's state as it is over a tile that holds none of its
    kept slots; then the partials are folded in split (cluster rank) order,
    each weighted by exp(m_s - max_s m_s).  A split with no kept slot gives
    m = -inf and adds nothing; a row with none anywhere gives 0.  With
    ``partial`` it returns the partial mode's (fp32 out, lse): the folded
    max and sum give lse = max + log(sum) (in the scaled scores' units),
    -inf for a row with no kept slot."""
    b, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = sm_scale if sm_scale is not None else d**-0.5
    qf = q.float().reshape(b, hkv, g, d) * scale
    kf, vf = k.float(), v.float()
    keep = _keep(positions_q, positions_k, window)
    ninf = torch.full((b, hkv, g), float("-inf"))
    parts = []
    for s in range(n_split):
        m, l, acc = ninf.clone(), torch.zeros(b, hkv, g), torch.zeros(b, hkv, g, d)
        hi = min((s + 1) * split_len, sk)
        for t0 in range(s * split_len, hi, tile):
            t1 = min(t0 + tile, hi)
            kt = keep[:, None, None, t0:t1]
            sc = torch.einsum("bhgd,bnhd->bhgn", qf, kf[:, t0:t1]).masked_fill(~kt, float("-inf"))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            base = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
            alpha = torch.where(torch.isfinite(m), torch.exp(m - base), torch.zeros_like(m))
            p = torch.where(kt, torch.exp(sc - base[..., None]), torch.zeros_like(sc))
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgn,bnhd->bhgd", p, vf[:, t0:t1])
            m = m_new
        parts.append((m, l, acc))
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    base = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    out, l_tot = torch.zeros(b, hkv, g, d), torch.zeros(b, hkv, g)
    for m, l, acc in parts:
        w = torch.where(torch.isfinite(m), torch.exp(m - base), torch.zeros_like(m))
        out = out + acc * w[..., None]
        l_tot = l_tot + l * w
    out = torch.where(l_tot[..., None] > 0, out / l_tot.clamp_min(1e-30)[..., None], 0.0)
    if partial:
        lse = torch.where(l_tot > 0, base + torch.log(l_tot.clamp_min(1e-30)),
                          torch.full_like(l_tot, float("-inf")))
        return out.reshape(b, hq, d), lse.reshape(b, hq)
    return out.reshape(b, hq, d).to(q.dtype)
