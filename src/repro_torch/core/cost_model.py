"""The paper's placement calculus (§6.1), made programmatic.

Parameters (paper notation):
  * ``T_Q``      — queue waiting time at a resource.  ``T_Q_pilot`` is the
                   pilot's provisioning/queue time, ``T_Q_task`` the
                   pilot-internal queueing time.
  * ``T_C``      — compute time of a task.
  * ``T_X``      — raw transfer time.
  * ``T_S``      — staging time = ``T_X + T_register``.
  * ``T_R(R)``   — time to replicate over R sites.
  * ``T_D``      — time until data is accessible across all resources;
                   with replication, ``T_D = T_R(R) + T_S``.

Decision rules implemented exactly as §6.1 lays them out:
  * "If the expected T_X is larger than the T_Q, then the compute is
    assigned to a site first, and subsequently data is placed" — i.e.
    data-to-compute; otherwise compute-to-data.
  * "Resources co-located with data replicas, with the lowest queue waiting
    time present optimal choice."
  * Partial/incremental replication: start with a subset of sites, grow the
    replication factor while co-located compute capacity is insufficient.

All functions are *pure* — they are shared between the threaded runtime
scheduler and the discrete-event simulator, so policy decisions are
identical in both mechanisms.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .affinity import Topology


# ------------------------------------------------------------------ T_* terms
def estimate_tx(nbytes: int, src: str, dst: str, topo: Topology) -> float:
    """Transfer time of ``nbytes`` from src to dst along the topology path."""
    if src == dst:
        return 0.0  # logical link (co-located PD, §4.3.2)
    bw = topo.bandwidth(src, dst)
    lat = topo.latency(src, dst)
    if bw == float("inf"):
        return lat
    return lat + nbytes / bw


def estimate_ts(
    nbytes: int, src: str, dst: str, topo: Topology, t_register: float = 0.0
) -> float:
    """Staging = transfer + catalog registration (paper: T_register was
    measured negligible; kept as an explicit term anyway)."""
    return estimate_tx(nbytes, src, dst, topo) + t_register


def estimate_tr_sequential(
    nbytes: int, src: str, targets: Sequence[str], topo: Topology
) -> float:
    """Sequential replication: one replica after the other from the source."""
    return sum(estimate_tx(nbytes, src, dst, topo) for dst in targets)


def estimate_tr_group(
    nbytes: int, src: str, targets: Sequence[str], topo: Topology
) -> float:
    """Group replication: already-completed replicas serve as sources.

    Models the fan-out the paper observed with iRODS group replication
    (Fig. 8: group ≫ sequential): each round every holder pushes to one new
    target, so completion takes ~ceil(log2(R+1)) rounds instead of R rounds.
    Round time is the slowest transfer scheduled in that round (greedy:
    nearest targets first).
    """
    if not targets:
        return 0.0
    holders = [src]
    remaining = sorted(
        targets, key=lambda dst: estimate_tx(nbytes, src, dst, topo)
    )
    t = 0.0
    while remaining:
        n = min(len(holders), len(remaining))
        batch, remaining = remaining[:n], remaining[n:]
        round_t = max(
            estimate_tx(nbytes, h, d, topo) for h, d in zip(holders, batch)
        )
        t += round_t
        holders.extend(batch)
    return t


def estimate_td(
    nbytes: int,
    src: str,
    targets: Sequence[str],
    topo: Topology,
    mode: str = "group",
    t_register: float = 0.0,
) -> float:
    """T_D: time at which data is accessible across all listed resources."""
    if mode == "group":
        tr = estimate_tr_group(nbytes, src, targets, topo)
    elif mode == "sequential":
        tr = estimate_tr_sequential(nbytes, src, targets, topo)
    else:
        raise ValueError(f"unknown replication mode {mode!r}")
    return tr + t_register * len(targets)


# -------------------------------------------------------------- decisions
@dataclasses.dataclass(frozen=True)
class PlacementChoice:
    """Outcome of the §6.1 trade-off for one (CU, candidate pilot) pair."""

    pilot_id: str
    strategy: str  # "compute-to-data" | "data-to-compute"
    t_queue: float
    t_stage: float  # data movement this choice implies
    score: float  # estimated completion-relevant cost (lower is better)


def decide_placement(
    input_bytes_by_location: Dict[str, int],
    pilots: Sequence[Tuple[str, str, float]],
    topo: Topology,
    affinity_constraint: Optional[str] = None,
) -> List[PlacementChoice]:
    """Rank candidate pilots for a CU by the §6.1 calculus.

    Args:
      input_bytes_by_location: bytes of required input data per *replica
        location* label (a DU replicated at several PDs contributes its
        size at each location; the estimator picks the cheapest replica).
      pilots: (pilot_id, location_label, expected_T_Q) triples.
      topo: weighted topology tree.
      affinity_constraint: optional subtree constraint (paper §5).

    Returns choices sorted best-first.  For each pilot the staging cost is
    the sum over required DUs of the *cheapest replica* transfer; the
    strategy is "compute-to-data" when staging dominates queueing
    (T_X > T_Q ⇒ better to move compute to the data's site; the returned
    ranking already reflects that because co-located pilots get t_stage≈0).
    """
    from .affinity import match_affinity

    choices: List[PlacementChoice] = []
    for pilot_id, loc, t_q in pilots:
        if not match_affinity(affinity_constraint, loc):
            continue
        t_stage = 0.0
        for replica_loc, nbytes in input_bytes_by_location.items():
            t_stage += estimate_tx(nbytes, replica_loc, loc, topo)
        strategy = "data-to-compute" if t_q >= t_stage else "compute-to-data"
        choices.append(
            PlacementChoice(
                pilot_id=pilot_id,
                strategy=strategy,
                t_queue=t_q,
                t_stage=t_stage,
                score=t_q + t_stage,
            )
        )
    choices.sort(key=lambda c: (c.score, c.pilot_id))
    return choices


def cheapest_replica(
    nbytes: int, replicas: Sequence[str], dst: str, topo: Topology
) -> Tuple[Optional[str], float]:
    """Pick the replica with the lowest T_X to ``dst`` (paper §6.4: "the
    optimized replication mechanism ... utilizes the replica closest to the
    target site")."""
    best, best_t = None, float("inf")
    for r in replicas:
        t = estimate_tx(nbytes, r, dst, topo)
        if t < best_t:
            best, best_t = r, t
    return best, best_t


def choose_replication_degree(
    nbytes: int,
    src: str,
    candidate_sites: Sequence[Tuple[str, int]],
    tasks: int,
    task_compute_s: float,
    topo: Topology,
    mode: str = "group",
) -> List[str]:
    """Incremental (partial) replication per §6.1's hybrid mode.

    "replication might commence over a subset of suitably chosen nodes,
    followed by a sequential increase in the replication (factor) if compute
    resources close to the replica do not have sufficient compute capacity."

    Greedy: add replica sites (cheapest-first) while the marginal replication
    cost is outweighed by the compute-parallelism gain of unlocking that
    site's slots.  Returns the ordered list of sites to replicate to.
    """
    if tasks <= 0 or not candidate_sites:
        return []
    # Cheapest-first site order.
    order = sorted(
        candidate_sites, key=lambda s: estimate_tx(nbytes, src, s[0], topo)
    )
    chosen: List[str] = []
    slots = 0

    def makespan(sites: List[str], nslots: int) -> float:
        if nslots <= 0:
            return float("inf")
        tr = (
            estimate_tr_group(nbytes, src, sites, topo)
            if mode == "group"
            else estimate_tr_sequential(nbytes, src, sites, topo)
        )
        return tr + math.ceil(tasks / nslots) * task_compute_s

    best = float("inf")
    for site, site_slots in order:
        cand = chosen + [site]
        m = makespan(cand, slots + site_slots)
        if m < best:
            chosen, slots, best = cand, slots + site_slots, m
        else:
            break  # marginal site no longer pays for itself
    return chosen


def straggler_threshold(durations: Iterable[float], factor: float = 2.5) -> float:
    """Duplicate-launch threshold: factor × median of completed durations.

    Used by the workload manager to implement the paper's §6.4 lesson ("the
    first resource must not be the best one") as an automatic policy.
    """
    ds = sorted(durations)
    if not ds:
        return float("inf")
    mid = len(ds) // 2
    median = ds[mid] if len(ds) % 2 else 0.5 * (ds[mid - 1] + ds[mid])
    return factor * median
