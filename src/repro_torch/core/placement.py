"""Pluggable placement strategies + the shared candidate estimator.

The §6.1 calculus produces, for every (CU, pilot) pair, the two numbers the
paper trades off — expected queue wait T_Q and expected staging cost T_X.
*How those numbers turn into a placement* is policy, and this module makes
policy pluggable: a :class:`PlacementStrategy` ranks the candidate list,
and strategies register by name so schedulers (sync and async alike) and
benchmarks select them from one registry.

Both execution modes share :class:`PlacementEngine` for the estimates and a
strategy instance for the ranking, which is what guarantees the two modes
reproduce identical placement decisions for identical store state.

Built-in strategies (the five benchmarked in ``bench_placement``):

  * ``cost``        — minimize T_Q + T_X (the paper's §6.1 rule; default);
  * ``data-local``  — compute-to-data: minimize staging first, queue second;
  * ``queue-depth`` — load-balance on T_Q only (data-blind);
  * ``round-robin`` — deterministic rotation over pilots (baseline);
  * ``random``      — seeded uniform choice (baseline / tie-break probe).
"""

from __future__ import annotations

import abc
import dataclasses
import random
import threading
from typing import Callable, Dict, List, Optional, Sequence

from .affinity import match_affinity
from .compute_unit import ComputeUnit
from .pilot import PilotCompute, PilotState, RuntimeContext


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One (CU, pilot) pairing with its §6.1 cost terms."""

    pilot: PilotCompute
    t_queue: float
    t_stage: float
    #: fractional chunk locality: bytes of the CU's input chunks already
    #: present at the pilot (sandbox-cached or linkable) / total input
    #: bytes.  1.0 = fully local (or no inputs), 0.0 = everything remote.
    #: Partial replicas score partially — the chunk-granular replacement
    #: for the old boolean has-replica test.
    locality: float = 1.0
    #: effective tier bandwidth (bytes/s): the bytes-weighted backend
    #: bandwidth of the best *local* holder of each input chunk — a DU
    #: cached in a DRAM-tier PD at the pilot scores ~20 GB/s where the
    #: same bytes on a site-shared parallel FS score ~4 GB/s and a chunk
    #: with no local copy scores 0.  Locality says how MUCH is local;
    #: this says how FAST the local copy serves.
    tier_bw: float = 0.0

    @property
    def score(self) -> float:
        return self.t_queue + self.t_stage

    @property
    def strategy(self) -> str:
        """Which direction §6.1 says this pairing moves: data or compute."""
        return (
            "data-to-compute" if self.t_queue >= self.t_stage
            else "compute-to-data"
        )


class PlacementEngine:
    """Computes strategy-independent candidate costs for a CU.

    Estimates are the same math the sync scheduler has always used:
    T_Q from declared per-CU compute seconds of work already bound to the
    pilot, T_X as the cheapest-replica staging cost of each input DU (via
    the transfer service's replica-aware cache)."""

    def __init__(self, ctx: RuntimeContext, avg_cu_estimate_s: float = 0.05):
        self.ctx = ctx
        self.avg_cu_estimate_s = avg_cu_estimate_s

    def pilot_tq_estimate(self, pilot: PilotCompute) -> float:
        """Expected wait before ``pilot`` could start one more CU."""
        st = pilot.state
        if st not in PilotState.PLACEABLE:
            return float("inf")
        tq = 0.0
        if st == PilotState.PROVISIONING:
            tq += pilot.description.queue_time_s

        def cu_cost(cu_id: str) -> float:
            try:
                d = self.ctx.lookup(cu_id).description
                return max(
                    d.sim_compute_s, d.est_compute_s, self.avg_cu_estimate_s
                )
            except KeyError:
                return self.avg_cu_estimate_s

        pending = [
            item["cu"] if isinstance(item, dict) else item
            for item in self.ctx.store.qpeek(pilot.queue_name)
        ]
        running = pilot.running_cus()
        total = sum(cu_cost(c) for c in (*pending, *running))
        free = pilot.slots - len(running) - len(pending)
        if free <= 0:
            tq += total / max(1, pilot.slots)
        return max(tq, 0.0)

    def stage_estimate(self, cu: ComputeUnit, pilot: PilotCompute) -> float:
        """Σ over input DUs of the striped multi-source staging cost of the
        *missing chunks* to ``pilot`` (0 for sandbox cache hits and linkable
        full replicas; partial holdings only pay for the remainder)."""
        t_stage = 0.0
        ts = self.ctx.transfer_service
        tenant = getattr(cu.description, "tenant", None)
        for du_id in cu.description.input_data:
            du = self.ctx.lookup(du_id)
            if pilot.sandbox.has_du(du.id):
                continue  # pilot-level cache hit
            t_stage += ts.estimate_stage_cost(
                du, pilot.affinity, pilot.sandbox, tenant=tenant
            )
        return t_stage

    def _chunk_presence(self, cu: ComputeUnit, pilot: PilotCompute) -> tuple:
        """ONE scan over the CU's input chunk holders at ``pilot``,
        returning ``(locality, tier_bw)`` — the locality fraction and the
        bytes-weighted bandwidth of each chunk's best local holder.  The
        two scores share the per-holder store reads (``chunk_holders`` +
        linkability), which would otherwise be paid twice per candidate
        on the placement hot path."""
        ts = self.ctx.transfer_service
        total = 0
        local = 0
        weighted = 0.0
        sandbox_bw = pilot.sandbox.backend.profile.bandwidth
        for du_id in cu.description.input_data:
            du = self.ctx.lookup(du_id)
            chunks = du.chunks
            total += du.size
            if not chunks:
                continue
            best: Dict[int, float] = {
                i: sandbox_bw for i in pilot.sandbox.chunks_held(du.id)
            }
            for pd_id, idxs in du.chunk_holders().items():
                if pd_id == pilot.sandbox.id or pd_id not in self.ctx.objects:
                    continue
                pd = self.ctx.lookup(pd_id)
                if not ts.is_linkable(pd, pilot.affinity):
                    continue
                bw = pd.backend.profile.bandwidth
                for i in idxs:
                    if bw > best.get(i, 0.0):
                        best[i] = bw
            for i, bw in best.items():
                if i < len(chunks):
                    local += chunks[i].size
                    weighted += chunks[i].size * bw
        if total == 0:
            return 1.0, 0.0
        return local / total, weighted / total

    def chunk_locality(self, cu: ComputeUnit, pilot: PilotCompute) -> float:
        """Fraction of the CU's input bytes whose chunks are already at the
        pilot — in its sandbox or in any PD linkable from its location.
        A DU replicated halfway scores 0.5, not 0 (the chunk-granular
        upgrade of the old boolean ``has_du`` locality test)."""
        return self._chunk_presence(cu, pilot)[0]

    def tier_bandwidth(self, cu: ComputeUnit, pilot: PilotCompute) -> float:
        """Bytes-weighted effective bandwidth of the CU's input chunks at
        ``pilot``: each chunk contributes its best local (sandbox or
        linkable) holder's backend bandwidth, chunks with no local copy
        contribute 0.  Distinguishes two fully-local candidates whose
        replicas live in different storage tiers."""
        return self._chunk_presence(cu, pilot)[1]

    def candidates(
        self,
        cu: ComputeUnit,
        pilots: Sequence[PilotCompute],
        tier_bw: bool = False,
    ) -> List[Candidate]:
        """All affinity-admissible, placeable pilots with their costs.
        Terminal pilots never qualify; neither do SUSPECT ones — a pilot
        in its missed-heartbeat grace period drains in-flight work but
        must not be handed anything new (it may be about to fail, and
        recovery would race the binding).

        ``tier_bw`` additionally scores each candidate's effective tier
        bandwidth — an extra O(chunks × holders) scan per pilot, so it is
        computed only for strategies that declare ``uses_tier_bw``."""
        constraint = cu.description.affinity
        out: List[Candidate] = []
        for p in pilots:
            if p.state not in PilotState.PLACEABLE:
                continue
            if constraint and not match_affinity(constraint, p.affinity):
                continue
            locality, bw = self._chunk_presence(cu, p)
            out.append(
                Candidate(
                    pilot=p,
                    t_queue=self.pilot_tq_estimate(p),
                    t_stage=self.stage_estimate(cu, p),
                    locality=locality,
                    tier_bw=bw if tier_bw else 0.0,
                )
            )
        return out


class PlacementStrategy(abc.ABC):
    """Ranks candidates best-first.  Implementations must be deterministic
    given their construction arguments and the submission order (stateful
    strategies like round-robin/random advance exactly once per ``rank``)."""

    #: registry key; subclasses override
    name: str = "?"
    #: strategies that rank on Candidate.tier_bw set this True so the
    #: engine computes it (it costs an extra per-chunk holder scan)
    uses_tier_bw: bool = False
    #: runtime context, attached by :meth:`bind` — tenant-aware
    #: strategies read the TenantRegistry and queue state through it
    ctx: Optional[RuntimeContext] = None

    def bind(self, ctx: RuntimeContext) -> None:
        """Attach the runtime context (called once by the CDS).  The base
        implementation just stores it; cost-only strategies ignore it."""
        self.ctx = ctx

    @abc.abstractmethod
    def rank(
        self, cu: ComputeUnit, candidates: Sequence[Candidate]
    ) -> List[Candidate]:
        ...


_REGISTRY: Dict[str, Callable[..., PlacementStrategy]] = {}
_registry_lock = threading.Lock()


def register_strategy(name: str):
    """Class decorator: register a strategy factory under ``name``."""

    def deco(cls):
        cls.name = name
        with _registry_lock:
            _REGISTRY[name] = cls
        return cls

    return deco


def make_strategy(name: str, **kwargs) -> PlacementStrategy:
    with _registry_lock:
        if name not in _REGISTRY:
            raise KeyError(
                f"unknown placement strategy {name!r} "
                f"(registered: {sorted(_REGISTRY)})"
            )
        factory = _REGISTRY[name]
    return factory(**kwargs)


def list_strategies() -> List[str]:
    with _registry_lock:
        return sorted(_REGISTRY)


@register_strategy("cost")
class CostStrategy(PlacementStrategy):
    """§6.1: minimize T_Q + T_X; pilot id breaks ties deterministically."""

    def rank(self, cu, candidates):
        return sorted(candidates, key=lambda c: (c.score, c.pilot.id))


@register_strategy("data-local")
class DataLocalStrategy(PlacementStrategy):
    """Compute-to-data: fractional chunk locality dominates the ordering —
    the pilot already holding the most input bytes (partial replicas
    count pro rata) wins; among equally-local candidates the one whose
    replicas sit in the *faster storage tier* (effective tier bandwidth)
    ranks first; residual staging cost and queue wait break ties."""

    uses_tier_bw = True

    def rank(self, cu, candidates):
        return sorted(
            candidates,
            key=lambda c: (
                -c.locality,
                -c.tier_bw,
                c.t_stage,
                c.t_queue,
                c.pilot.id,
            ),
        )


@register_strategy("queue-depth")
class QueueDepthStrategy(PlacementStrategy):
    """Data-blind load balancing on expected queue wait."""

    def rank(self, cu, candidates):
        return sorted(
            candidates, key=lambda c: (c.t_queue, c.t_stage, c.pilot.id)
        )


@register_strategy("round-robin")
class RoundRobinStrategy(PlacementStrategy):
    """Rotate over pilots in id order; one advance per ranked CU."""

    def __init__(self) -> None:
        self._next = 0
        self._lock = threading.Lock()

    def rank(self, cu, candidates):
        if not candidates:
            return []
        ordered = sorted(candidates, key=lambda c: c.pilot.id)
        with self._lock:
            start = self._next % len(ordered)
            self._next += 1
        return ordered[start:] + ordered[:start]


def _queued_cu_ids(store, queue_name: str) -> List[str]:
    return [
        item["cu"] if isinstance(item, dict) else item
        for item in store.qpeek(queue_name)
    ]


@register_strategy("weighted-fair-share")
class WeightedFairShareStrategy(PlacementStrategy):
    """Tenant-fair §6.1: cost plus a same-tenant backlog penalty.

    Each candidate's score is T_Q + T_X plus a penalty proportional to how
    many of the *submitting tenant's own* CUs already sit in that pilot's
    queue, divided by the tenant's fair-share weight.  A flooding tenant
    therefore spreads itself across pilots (its own backlog repels it)
    instead of monopolizing one queue after another, while a light tenant
    — with no backlog anywhere — ranks on pure cost and slips in front of
    the flood.  Weighted round-robin across tenants, emergent rather than
    scheduled: higher weight → smaller penalty → denser packing allowed.

    Degenerates to exactly the ``cost`` ordering when the registry is
    absent or every queued CU belongs to the submitting tenant's own
    single-tenant world."""

    def __init__(self, penalty_s: float = 0.05) -> None:
        #: seconds of score penalty per own-tenant queued CU at weight 1.0
        self.penalty_s = penalty_s

    def rank(self, cu, candidates):
        ctx = self.ctx
        registry = getattr(ctx, "tenant_registry", None) if ctx else None
        if registry is None:
            return sorted(candidates, key=lambda c: (c.score, c.pilot.id))
        tenant = getattr(cu.description, "tenant", None) or "default"
        weight = registry.weight(tenant)
        store = ctx.store

        def penalty(c: Candidate) -> float:
            own = 0
            for cu_id in _queued_cu_ids(store, c.pilot.queue_name):
                holder = store.hget(f"cu:{cu_id}", "tenant") or "default"
                if holder == tenant:
                    own += 1
            return own * self.penalty_s / weight

        return sorted(
            candidates, key=lambda c: (c.score + penalty(c), c.pilot.id)
        )


@register_strategy("priority")
class PriorityStrategy(PlacementStrategy):
    """Priority-discounted §6.1: queue wait counts only the work of
    tenants at equal-or-higher priority.  Lower-priority queued CUs are
    bypassable (the admission controller's queued-only preemption can
    displace them), so a high-priority CU ranks pilots as if that backlog
    were absent — it optimizes for where IT will start soonest, and the
    preemption step in ``ComputeDataService.place`` then makes the
    assumption real.  Ties (and the registry-less case) fall back to the
    plain cost ordering."""

    def __init__(self, avg_cu_estimate_s: float = 0.05) -> None:
        self.avg_cu_estimate_s = avg_cu_estimate_s

    def _cu_estimate(self, cu_id: str) -> float:
        try:
            d = self.ctx.lookup(cu_id).description
            return max(
                d.sim_compute_s, d.est_compute_s, self.avg_cu_estimate_s
            )
        except KeyError:
            return self.avg_cu_estimate_s

    def rank(self, cu, candidates):
        ctx = self.ctx
        registry = getattr(ctx, "tenant_registry", None) if ctx else None
        if registry is None:
            return sorted(candidates, key=lambda c: (c.score, c.pilot.id))
        tenant = getattr(cu.description, "tenant", None) or "default"
        my_pri = registry.get(tenant).priority
        store = ctx.store

        def discounted_tq(c: Candidate) -> float:
            tq = 0.0
            for cu_id in _queued_cu_ids(store, c.pilot.queue_name):
                holder = store.hget(f"cu:{cu_id}", "tenant") or "default"
                if registry.get(holder).priority >= my_pri:
                    tq += self._cu_estimate(cu_id)
            for cu_id in c.pilot.running_cus():
                # running work is never preemptible: it always counts
                tq += self._cu_estimate(cu_id)
            return tq / max(1, c.pilot.slots)

        return sorted(
            candidates,
            key=lambda c: (
                discounted_tq(c) + c.t_stage,
                c.score,
                c.pilot.id,
            ),
        )


@register_strategy("random")
class RandomStrategy(PlacementStrategy):
    """Seeded uniform choice — deterministic under a fixed seed and
    submission order."""

    def __init__(self, seed: int = 0) -> None:
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def rank(self, cu, candidates):
        ordered = sorted(candidates, key=lambda c: c.pilot.id)
        with self._lock:
            self._rng.shuffle(ordered)
        return ordered
