"""Plain PyTorch version of the SSD chunk-scan kernel (``csrc/ssd_scan.cu``).

The port's copy of ``ssd_chunked`` in ``repro/models/mamba2.py`` (its
``segsum(dA)`` is taken as differences of the chunk's running sum), in fp32,
with two changes to the interface:
B and C come in their group layout ``[B, S, G, N]`` (head h reads group
``h // (H / G)``; the function repeats them to the heads itself), and an
optional ``initial_state`` ``[B, H, P, N]`` seeds the recurrence.

Within a chunk of length Q, with ``cum`` the running sum of dA over the
chunk, ``y = (C B^T o L) X + (C state^T) o exp(cum)`` where
``L[i, j] = exp(cum_i - cum_j)`` for ``i >= j`` and 0 above the diagonal;
across chunks ``state <- state * exp(cum_last) + (X o exp(cum_last - cum))^T B``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _tril_diff(cs: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = cs_i - cs_j below the diagonal, -inf above it."""
    q = cs.shape[-1]
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=cs.device))
    return diff.masked_fill(~mask, float("-inf"))


def ssd_ref(
    x: torch.Tensor,  # [B, S, H, P] (dt-weighted)
    dA: torch.Tensor,  # [B, S, H] (dt * A, negative)
    B: torch.Tensor,  # [B, S, G, N]
    C: torch.Tensor,  # [B, S, G, N]
    chunk: int,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD with chunks of exactly ``chunk`` positions; returns
    (y [B, S, H, P] in x's dtype, final_state [B, H, P, N] fp32)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"ssd: seq {s} is not a multiple of chunk {chunk}")
    c = s // chunk
    rep = h // g
    xf = x.float().reshape(b, c, chunk, h, p)
    dAf = dA.float().reshape(b, c, chunk, h)
    Bf = B.float().repeat_interleave(rep, dim=2).reshape(b, c, chunk, h, n)
    Cf = C.float().repeat_interleave(rep, dim=2).reshape(b, c, chunk, h, n)

    cum = torch.cumsum(dAf, dim=2)  # [B, C, Q, H]
    # intra-chunk: the decay-masked quadratic form.  L is segsum(dA) taken
    # from the same cum as the decays below, so that one rounding of the
    # running sum (whose values reach ~200 over a chunk) serves all of them
    L = torch.exp(_tril_diff(cum.permute(0, 1, 3, 2)))  # [B, C, H, Q, Q]
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cf, Bf) * L
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores, xf)
    # each chunk's own final state, and the recurrence across chunks
    decay_states = torch.exp(cum[:, :, -1:, :] - cum)  # [B, C, Q, H]
    chunk_states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", Bf, decay_states, xf)
    total_decay = torch.exp(cum[:, :, -1, :])  # [B, C, H]
    state = (
        initial_state.float()
        if initial_state is not None
        else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    )
    prev = []
    for i in range(c):
        prev.append(state)  # the state entering chunk i
        state = state * total_decay[:, i, :, None, None] + chunk_states[:, i]
    prev_states = torch.stack(prev, dim=1)  # [B, C, H, P, N]
    # the carried-in state's contribution
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Cf, prev_states, torch.exp(cum))
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), state
