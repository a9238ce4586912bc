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

Beside :func:`ssd_ref`, one plain function for each of the kernel's five
passes, taking and returning the kernel's scratch layouts:
``ssd_cum_ref`` (cum ``[B, H, nC, Q]``), ``ssd_cb_ref`` (C B^T ``[B, nC, G,
Q, Q]``), ``ssd_chunk_states_ref`` (each chunk's own state ``[B, nC, H, P,
N]``), ``ssd_carry_ref`` (the state entering each chunk, same layout, and
the final state) and ``ssd_output_ref`` (y).  Composed, they compute what
``ssd_ref`` computes.
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


# ---------------------------------------------------------------- the passes
def ssd_cum_ref(dA: torch.Tensor, chunk: int) -> torch.Tensor:
    """Pass 1: the running sum of dA [B, S, H] within each chunk, as
    ``[B, H, nC, Q]`` fp32."""
    b, s, h = dA.shape
    cum = torch.cumsum(dA.float().reshape(b, s // chunk, chunk, h), dim=2)
    return cum.permute(0, 3, 1, 2)


def ssd_cb_ref(B: torch.Tensor, C: torch.Tensor, chunk: int) -> torch.Tensor:
    """Pass 2: C B^T per (batch, chunk, group), ``[B, nC, G, Q, Q]`` fp32
    (the kernel computes only the lower triangle; the caller masks)."""
    b, s, g, n = B.shape
    Bf = B.float().reshape(b, s // chunk, chunk, g, n)
    Cf = C.float().reshape(b, s // chunk, chunk, g, n)
    return torch.einsum("bcqgn,bckgn->bcgqk", Cf, Bf)


def ssd_chunk_states_ref(x: torch.Tensor, B: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """Pass 3: each chunk's own state (X o exp(cum_last - cum))^T B,
    ``[B, nC, H, P, N]`` fp32, from cum ``[B, H, nC, Q]``."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc, q = cum.shape[2], cum.shape[3]
    xf = x.float().reshape(b, nc, q, h, p)
    Bf = B.float().repeat_interleave(h // g, dim=2).reshape(b, nc, q, h, n)
    decay = torch.exp(cum[..., -1:] - cum).permute(0, 2, 3, 1)  # [B, nC, Q, H]
    return torch.einsum("bcqhn,bcqh,bcqhp->bchpn", Bf, decay, xf)


def ssd_carry_ref(
    states: torch.Tensor,  # [B, nC, H, P, N]
    cum: torch.Tensor,  # [B, H, nC, Q]
    initial_state: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 4: the state entering each chunk ``[B, nC, H, P, N]`` and the
    final state ``[B, H, P, N]``, walking the chunks in order."""
    b, nc, h, p, n = states.shape
    total_decay = torch.exp(cum[..., -1])  # [B, H, nC]
    state = (
        initial_state.float()
        if initial_state is not None
        else torch.zeros((b, h, p, n), dtype=torch.float32, device=states.device)
    )
    prev = []
    for i in range(nc):
        prev.append(state)
        state = state * total_decay[:, :, i, None, None] + states[:, i]
    return torch.stack(prev, dim=1), state


def ssd_output_ref(
    x: torch.Tensor,  # [B, S, H, P]
    C: torch.Tensor,  # [B, S, G, N]
    cb: torch.Tensor,  # [B, nC, G, Q, Q], read on and below the diagonal only
    cum: torch.Tensor,  # [B, H, nC, Q]
    prev: torch.Tensor,  # [B, nC, H, P, N]
) -> torch.Tensor:
    """Pass 5: y = (CB o L) X + (C prev^T) o exp(cum), in x's dtype.  Above
    the diagonal ``cb`` is never read into the sum (a select, so that what
    the kernel left there, even inf or NaN, cannot leak in)."""
    b, s, h, p = x.shape
    g, n = C.shape[2], C.shape[3]
    nc, q = cum.shape[2], cum.shape[3]
    xf = x.float().reshape(b, nc, q, h, p)
    Cf = C.float().repeat_interleave(h // g, dim=2).reshape(b, nc, q, h, n)
    cumc = cum.permute(0, 2, 1, 3)  # [B, nC, H, Q]
    L = torch.exp(_tril_diff(cumc))  # [B, nC, H, Q, Q]
    lower = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    scores = torch.where(lower, cb.float().repeat_interleave(h // g, dim=2) * L, 0.0)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores, xf)
    y_off = torch.einsum("bcqhn,bchpn,bchq->bcqhp", Cf, prev, torch.exp(cumc))
    return (y_diag + y_off).reshape(b, s, h, p).to(x.dtype)
