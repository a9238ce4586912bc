"""DU replication strategies (paper §6.2, Fig. 8, and PD2P-style demand
replication from §3).

Three strategies:
  * **sequential** — one replica after another from the original source
    (paper: SRM/iRODS sequential scenarios);
  * **group** — chunk-striped fan-out: the source first *disperses*
    distinct chunk stripes across the targets in parallel (each target
    receives ~1/N of the DU), then every target *heals* to a full replica
    by striping its missing chunks from the now-many partial holders.
    This generalizes the paper's osgGridFTPGroup fan-out ("optimized
    replication mechanism, which utilizes the replica closest to the
    target site", §6.4) from whole-DU rounds to chunk waves: only ~2
    stripe-sized waves instead of ~log2(R) full-DU rounds.  The
    ``striped=False`` mode keeps the whole-DU round behaviour for
    comparison (benchmarks report both);
  * **demand** — PD2P-style: replicate *popular* DUs to underutilized
    pilots' sites ("replicate popular datasets to underutilized resources
    for later computations"), driven by access statistics the transfer
    service already records.

All strategies return the simulated T_R, so benchmarks can reproduce the
paper's group-vs-sequential comparison quantitatively.
"""

from __future__ import annotations

import collections
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

from .cost_model import estimate_tx
from .data_unit import DataUnit
from .pilot import PilotData, RuntimeContext


def replicate_sequential(
    du: DataUnit, src: PilotData, targets: Sequence[PilotData], ctx: RuntimeContext
) -> float:
    """Chain replication; T_R = Σ T_X(src→target)."""
    t = 0.0
    for dst in targets:
        if dst.has_du(du.id):
            continue
        t += ctx.transfer_service.replicate(du, src, dst)
    return t


def _replicate_group_monolithic(
    du: DataUnit, src: PilotData, targets: Sequence[PilotData], ctx: RuntimeContext
) -> float:
    """Whole-DU fan-out: every round, each current holder feeds one new
    target (closest-first), so rounds ~ log2(R).  Returns simulated T_R
    (max over each round's parallel transfers, summed over rounds)."""
    holders: List[PilotData] = [src]
    remaining = [d for d in targets if not d.has_du(du.id)]
    remaining.sort(
        key=lambda d: estimate_tx(du.size, src.affinity, d.affinity, ctx.topology)
    )
    total = 0.0
    while remaining:
        n = min(len(holders), len(remaining))
        batch, remaining = remaining[:n], remaining[n:]
        # Pair each target with its cheapest current holder (greedy).
        round_times = []
        with ThreadPoolExecutor(max_workers=max(1, n)) as pool:
            futs = []
            for dst in batch:
                best = min(
                    holders,
                    key=lambda h: estimate_tx(
                        du.size, h.affinity, dst.affinity, ctx.topology
                    ),
                )
                futs.append(
                    pool.submit(ctx.transfer_service.replicate, du, best, dst)
                )
            for f in futs:
                round_times.append(f.result())
        total += max(round_times) if round_times else 0.0
        holders.extend(batch)
    return total


def replicate_group(
    du: DataUnit,
    src: PilotData,
    targets: Sequence[PilotData],
    ctx: RuntimeContext,
    striped: bool = True,
) -> float:
    """Group replication; chunk-striped by default (see module docstring).

    Phase 1 (disperse): the DU's chunks are dealt round-robin across the
    targets and each stripe moves src→target in parallel — wave time is the
    max over the per-target stripe transfers.  Phase 2 (heal): each target
    stages its missing chunks through the transfer service's multi-source
    striped fetch, drawing on every partial holder created in phase 1 (and
    the source), again in parallel.  Every target ends holding a full,
    registered replica.
    """
    ts = ctx.transfer_service
    remaining = [d for d in targets if not d.has_du(du.id)]
    if not remaining:
        return 0.0
    if not striped or du.n_chunks <= 1:
        return _replicate_group_monolithic(du, src, remaining, ctx)
    # closest targets first, so the cheap links carry stripes earliest
    remaining.sort(
        key=lambda d: estimate_tx(du.size, src.affinity, d.affinity, ctx.topology)
    )
    stripes: List[List[int]] = [[] for _ in remaining]
    for i in range(du.n_chunks):
        stripes[i % len(remaining)].append(i)
    disperse_times: List[float] = []
    with ThreadPoolExecutor(max_workers=len(remaining)) as pool:
        futs = [
            pool.submit(ts.replicate_chunks, du, src, dst, stripe)
            for dst, stripe in zip(remaining, stripes)
            if stripe
        ]
        disperse_times = [f.result() for f in futs]
    total = max(disperse_times) if disperse_times else 0.0
    # Plan every target's heal BEFORE executing any: all plans see the same
    # post-disperse holdings snapshot, so the simulated heal times are
    # independent of thread interleaving (sources only gain chunks during
    # the heal, so the planned copies all stay valid).
    plans = [ts.plan_chunk_fetch(du, dst, dst.affinity) for dst in remaining]
    heal_times: List[float] = []
    with ThreadPoolExecutor(max_workers=len(remaining)) as pool:
        futs = [
            pool.submit(ts.heal_replica, du, dst, plan)
            for dst, plan in zip(remaining, plans)
        ]
        heal_times = [f.result() for f in futs]
    total += max(heal_times) if heal_times else 0.0
    return total


def _site_of(label: str) -> str:
    """Failure-domain key of an affinity label: the site subtree (first
    two components).  A whole site — its shared FS, its pilots — is the
    unit that tends to die together (walltime kill, maintenance window)."""
    parts = label.split(":")
    return ":".join(parts[:2]) if len(parts) >= 2 else label


def select_heal_targets(
    ctx: RuntimeContext,
    du: DataUnit,
    candidates: Sequence[PilotData],
    n: int,
    held: Sequence[str] = (),
) -> List[PilotData]:
    """Pick up to ``n`` PDs to host new replicas of ``du``,
    failure-domain-aware: candidates in sites that do NOT already hold a
    replica rank first (so re-replication spreads copies across domains
    instead of piling them where the next churn event takes them all),
    then by transfer cost from the surviving holders, then by free space.
    Deterministic for a fixed candidate set.
    """
    if n <= 0 or not candidates:
        return []
    held_sites = {_site_of(label) for label in held}
    src_labels = [label for label in held if label]

    def cost(pd: PilotData) -> float:
        if not src_labels:
            return 0.0  # healing from the local buffer: location-agnostic
        return min(
            estimate_tx(du.size, s, pd.affinity, ctx.topology)
            for s in src_labels
        )

    ranked = sorted(
        candidates,
        key=lambda pd: (
            _site_of(pd.affinity) in held_sites,  # new domains first
            cost(pd),
            -pd.free_bytes,
            pd.id,
        ),
    )
    # never stack two new replicas into the same failure domain while an
    # untouched domain remains available
    out: List[PilotData] = []
    used_sites = set(held_sites)
    for pd in ranked:
        if len(out) >= n:
            break
        if _site_of(pd.affinity) in used_sites:
            continue
        out.append(pd)
        used_sites.add(_site_of(pd.affinity))
    for pd in ranked:
        if len(out) >= n:
            break
        if pd not in out:
            out.append(pd)
    return out


class DemandReplicator:
    """PD2P-style demand-based replication policy.

    Tracks per-DU access counts (remote stagings = cache misses).  When a DU
    has been remotely staged more than ``threshold`` times toward the same
    site subtree, it is proactively replicated to a PD in that subtree so
    later CUs link instead of transfer.
    """

    def __init__(self, ctx: RuntimeContext, threshold: int = 2):
        self.ctx = ctx
        self.threshold = threshold
        self._miss_counts: Dict[Tuple[str, str], int] = collections.Counter()
        self._lock = threading.Lock()
        self.replications: List[Tuple[str, str]] = []

    @staticmethod
    def _site_of(label: str) -> str:
        parts = label.split(":")
        return ":".join(parts[:2]) if len(parts) >= 2 else label

    def observe_staging(self, du: DataUnit, dst_location: str) -> None:
        with self._lock:
            self._miss_counts[(du.id, self._site_of(dst_location))] += 1

    def maybe_replicate(
        self, du: DataUnit, dst_location: str, site_pds: Sequence[PilotData]
    ) -> Optional[float]:
        """If demand at the destination site crossed the threshold, create a
        site-local replica.  Returns simulated T_R or None."""
        site = self._site_of(dst_location)
        with self._lock:
            if self._miss_counts[(du.id, site)] < self.threshold:
                return None
        candidates = [
            pd
            for pd in site_pds
            if self._site_of(pd.affinity) == site
            and not pd.has_du(du.id)
            and pd.free_bytes >= du.size
        ]
        if not candidates:
            return None
        dst = candidates[0]
        src_pd, _ = self.ctx.transfer_service.resolve_access(du, dst.affinity)
        if src_pd is None:
            return None
        t = self.ctx.transfer_service.replicate(du, src_pd, dst)
        with self._lock:
            self.replications.append((du.id, dst.id))
            self._miss_counts[(du.id, site)] = 0
        return t
