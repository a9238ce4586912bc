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

from typing import Dict, Optional, Tuple

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


# ------------------------------------------------------------ the backward
# The JAX package differentiates ``ssd_chunked`` by autodiff; the port's
# backward is a kernel of its own, and these are its plain versions, one for
# each of its six passes (``BWD_PASSES`` in ops.py), in closed form.  Per
# chunk and head, with M = C B^T, L[i, j] = exp(cum_i - cum_j) for i >= j,
# S = M o L, e = exp(cum), w = exp(cum_last - cum), prev the state entering
# the chunk and g the gradient of the state leaving it:
#   dprev = (dy o e)^T C + exp(cum_last) g  (g of the chunk before; d_initial
#           for the first chunk; g of the last chunk is dfinal),
#   dx    = S^T dy + w o (B g^T),
#   dM    = (dy x^T) o L,  dC = dM B + (dy o e) prev,  dB = dM^T C + (x o w) g,
#   dcum  = rowsum(dS o S) - colsum(dS o S) + the e, w and chunk-decay terms,
#   d_dA  = the reverse running sum of dcum within each chunk.
def _per_head(t: torch.Tensor, h: int, nc: int, q: int) -> torch.Tensor:
    """[B, S, G, N] -> [B, nC, Q, H, N] fp32, each group repeated to its heads."""
    b, _, g, n = t.shape
    return t.float().repeat_interleave(h // g, dim=2).reshape(b, nc, q, h, n)


def _intra(x, dy, cb, cum):
    """(S, dM, dS o S) of every chunk and head, each ``[B, nC, H, Q, Q]``
    fp32 and 0 above the diagonal (a select: ``cb`` may hold anything
    there)."""
    b, s, h, p = x.shape
    nc, q = cum.shape[2], cum.shape[3]
    xf = x.float().reshape(b, nc, q, h, p)
    dyf = dy.float().reshape(b, nc, q, h, p)
    L = torch.exp(_tril_diff(cum.permute(0, 2, 1, 3)))  # [B, nC, H, Q, Q], 0 above
    lower = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    S = torch.where(lower, cb.float().repeat_interleave(h // cb.shape[2], dim=2) * L, 0.0)
    dS = torch.einsum("bcihp,bcjhp->bchij", dyf, xf)
    return S, dS * L, torch.where(lower, dS * S, 0.0)


def _chunks(t: torch.Tensor) -> torch.Tensor:
    """[B, nC, Q, H, ...] -> [B, S, H, ...]."""
    b, nc, q = t.shape[:3]
    return t.reshape(b, nc * q, *t.shape[3:])


def ssd_bwd_dprev_ref(dy: torch.Tensor, C: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """Backward pass 1: the output's part of each chunk's dprev, (dy o e)^T C,
    ``[B, nC, H, P, N]`` fp32."""
    b, s, h, p = dy.shape
    nc, q = cum.shape[2], cum.shape[3]
    e = torch.exp(cum).permute(0, 2, 3, 1)  # [B, nC, Q, H]
    dyf = dy.float().reshape(b, nc, q, h, p)
    return torch.einsum("bcihp,bcih,bcihn->bchpn", dyf, e, _per_head(C, h, nc, q))


def ssd_bwd_carry_ref(
    dprev: torch.Tensor,  # [B, nC, H, P, N], pass 1's
    cum: torch.Tensor,  # [B, H, nC, Q]
    dfinal: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward pass 2: the gradient of the state leaving each chunk,
    ``[B, nC, H, P, N]``, and d_initial ``[B, H, P, N]``, walking the
    chunks in reverse from ``dfinal`` (zeros when None)."""
    b, nc, h, p, n = dprev.shape
    total_decay = torch.exp(cum[..., -1])  # [B, H, nC]
    g = (dfinal.float() if dfinal is not None
         else torch.zeros((b, h, p, n), dtype=torch.float32, device=dprev.device))
    dstate = [None] * nc
    for c in reversed(range(nc)):
        dstate[c] = g
        g = dprev[:, c] + total_decay[:, :, c, None, None] * g
    return torch.stack(dstate, dim=1), g


def ssd_bwd_dx_ref(
    x: torch.Tensor,  # [B, S, H, P]
    dy: torch.Tensor,  # [B, S, H, P]
    B: torch.Tensor,  # [B, S, G, N]
    C: torch.Tensor,  # [B, S, G, N]
    cb: torch.Tensor,  # [B, nC, G, Q, Q], read on and below the diagonal only
    cum: torch.Tensor,  # [B, H, nC, Q]
    prev: torch.Tensor,  # [B, nC, H, P, N]
    dstate: torch.Tensor,  # [B, nC, H, P, N], pass 2's
) -> Dict[str, torch.Tensor]:
    """Backward pass 3, over the keys j of each chunk: dx ``[B, S, H, P]``,
    each head's dB ``[B, S, H, N]``, and of dcum ``[B, H, nC, Q]`` the
    column sums ``-colsum(dS o S)`` and the w term ``dw_j = w_j
    sum_{p,n} g x_j B_j`` (taken from position j and added to the chunk's
    last), with the chunk decay's ``exp(cum_last) <prev, g>`` ``[B, H,
    nC]``, all fp32."""
    b, s, h, p = x.shape
    nc, q = cum.shape[2], cum.shape[3]
    S, dM, T = _intra(x, dy, cb, cum)
    xf = x.float().reshape(b, nc, q, h, p)
    dyf = dy.float().reshape(b, nc, q, h, p)
    Bf, Cf = _per_head(B, h, nc, q), _per_head(C, h, nc, q)
    cumc = cum.permute(0, 2, 3, 1)  # [B, nC, Q, H]
    w = torch.exp(cumc[:, :, -1:] - cumc)[..., None]  # [B, nC, Q, H, 1]
    dx = (torch.einsum("bchij,bcihp->bcjhp", S, dyf)
          + w * torch.einsum("bcjhn,bchpn->bcjhp", Bf, dstate))
    dB_state = w * torch.einsum("bcjhp,bchpn->bcjhn", xf, dstate)
    dB = torch.einsum("bchij,bcihn->bcjhn", dM, Cf) + dB_state
    return {
        "dx": _chunks(dx),
        "dBh": _chunks(dB),
        "dcum_col": -T.sum(dim=3).permute(0, 2, 1, 3),
        "dw": (Bf * dB_state).sum(-1).permute(0, 3, 1, 2),
        "ddecay": (torch.exp(cum[..., -1])
                   * (prev * dstate).sum(dim=(-2, -1)).permute(0, 2, 1)),
    }


def ssd_bwd_dc_ref(
    x: torch.Tensor,  # [B, S, H, P]
    dy: torch.Tensor,  # [B, S, H, P]
    B: torch.Tensor,  # [B, S, G, N]
    C: torch.Tensor,  # [B, S, G, N]
    cb: torch.Tensor,  # [B, nC, G, Q, Q], read on and below the diagonal only
    cum: torch.Tensor,  # [B, H, nC, Q]
    prev: torch.Tensor,  # [B, nC, H, P, N]
) -> Dict[str, torch.Tensor]:
    """Backward pass 4, over the rows i of each chunk: each head's dC ``[B,
    S, H, N]`` and of dcum ``[B, H, nC, Q]`` the row sums ``rowsum(dS o
    S)`` plus the e term ``sum_n C o (dy o e) prev``, fp32."""
    b, s, h, p = x.shape
    nc, q = cum.shape[2], cum.shape[3]
    _, dM, T = _intra(x, dy, cb, cum)
    dyf = dy.float().reshape(b, nc, q, h, p)
    Bf, Cf = _per_head(B, h, nc, q), _per_head(C, h, nc, q)
    e = torch.exp(cum).permute(0, 2, 3, 1)[..., None]  # [B, nC, Q, H, 1]
    dC_state = e * torch.einsum("bcihp,bchpn->bcihn", dyf, prev)
    dC = torch.einsum("bchij,bcjhn->bcihn", dM, Bf) + dC_state
    e_term = (Cf * dC_state).sum(-1).permute(0, 3, 1, 2)  # [B, H, nC, Q]
    return {"dCh": _chunks(dC), "dcum_row": T.sum(dim=4).permute(0, 2, 1, 3) + e_term}


def ssd_bwd_dA_ref(
    dcum_row: torch.Tensor,  # [B, H, nC, Q]
    dcum_col: torch.Tensor,  # [B, H, nC, Q]
    dw: torch.Tensor,  # [B, H, nC, Q]
    ddecay: torch.Tensor,  # [B, H, nC]
) -> torch.Tensor:
    """Backward pass 5: dcum from its four sources, then d_dA ``[B, S, H]``
    fp32, its reverse running sum within each chunk."""
    b, h, nc, q = dcum_row.shape
    dcum = dcum_row + dcum_col - dw
    dcum[..., -1] += dw.sum(-1) + ddecay
    d_dA = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    return d_dA.permute(0, 2, 3, 1).reshape(b, nc * q, h)


def ssd_bwd_fold_ref(dBh: torch.Tensor, dCh: torch.Tensor, groups: int):
    """Backward pass 6: dB and dC ``[B, S, G, N]``, each the sum of its
    group's heads in order."""
    b, s, h, n = dBh.shape
    return tuple(t.reshape(b, s, groups, h // groups, n).sum(3) for t in (dBh, dCh))


def ssd_bwd_scratch_ref(
    x: torch.Tensor,  # [B, S, H, P]
    B: torch.Tensor,  # [B, S, G, N]
    C: torch.Tensor,  # [B, S, G, N]
    cum: torch.Tensor,  # [B, H, nC, Q]
    cb: torch.Tensor,  # [B, nC, G, Q, Q], read on and below the diagonal only
    prev: torch.Tensor,  # [B, nC, H, P, N]
    dy: torch.Tensor,  # [B, S, H, P]
    dfinal: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The six backward passes composed, from the forward's scratch (what
    the backward kernel computes): (dx, d_dA, dB, dC, d_initial), fp32."""
    dstate, d_init = ssd_bwd_carry_ref(ssd_bwd_dprev_ref(dy, C, cum), cum, dfinal)
    sx = ssd_bwd_dx_ref(x, dy, B, C, cb, cum, prev, dstate)
    sc = ssd_bwd_dc_ref(x, dy, B, C, cb, cum, prev)
    d_dA = ssd_bwd_dA_ref(sc["dcum_row"], sx["dcum_col"], sx["dw"], sx["ddecay"])
    dB, dC = ssd_bwd_fold_ref(sx["dBh"], sc["dCh"], B.shape[2])
    return sx["dx"], d_dA, dB, dC, d_init


def ssd_bwd_ref(
    x: torch.Tensor,  # [B, S, H, P]
    dA: torch.Tensor,  # [B, S, H]
    B: torch.Tensor,  # [B, S, G, N]
    C: torch.Tensor,  # [B, S, G, N]
    chunk: int,
    initial_state: Optional[torch.Tensor],  # [B, H, P, N]
    dy: torch.Tensor,  # [B, S, H, P]
    dfinal: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The vector-Jacobian product of :func:`ssd_ref` with chunks of exactly
    ``chunk`` positions: (dx, d_dA, dB, dC, d_initial), in the dtypes of x,
    dA, B, C and fp32; dB and dC in the group layout, summed over each
    group's heads.  The forward's passes 1-4, then the six backward passes."""
    if x.shape[1] % chunk:
        raise ValueError(f"ssd: seq {x.shape[1]} is not a multiple of chunk {chunk}")
    cum = ssd_cum_ref(dA, chunk)
    prev, _ = ssd_carry_ref(ssd_chunk_states_ref(x, B, cum), cum, initial_state)
    dx, d_dA, dB, dC, d_init = ssd_bwd_scratch_ref(
        x, B, C, cum, ssd_cb_ref(B, C, chunk), prev, dy, dfinal)
    return dx.to(x.dtype), d_dA.to(dA.dtype), dB.to(B.dtype), dC.to(C.dtype), d_init
