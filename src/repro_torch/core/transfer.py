"""Transfer service: chunk-granular DU movement between Pilot-Data, with a
virtual clock.

Every physical transfer is costed against the topology (bottleneck bandwidth
along the tree path) *and* the two backend profiles (a GridFTP-class backend
moves bytes faster than an SSH-class one at equal topology distance — that
is exactly the spread the paper measures in Fig. 7).  Real bytes move
immediately (container-local); the *simulated* duration is recorded per
transfer so benchmarks reproduce the paper's timing analysis
deterministically.

The unit of transfer is the **chunk** (see ``DataUnit.chunks``): a stage-in
computes the destination's *missing* chunk set, assigns each missing chunk
to its cheapest current holder — full or partial replica alike — with a
greedy list-schedule that balances bytes across sources, and then moves the
per-source groups as parallel striped waves: the simulated duration is the
``max`` over the per-source group times (like ``replicate_group``'s rounds),
so a cold stage-in stripes from N partial holders instead of serializing
from one.

Co-location resolves to a **logical link** (§4.3.2: "In the best case, the
Pilot-Data of the dependent DUs is co-located on the same resource as the
CU, i.e. the data can be directly accessed via a logical filesystem link").
A PD is visible to a pilot when the PD's affinity label is an ancestor of
(or equal to) the pilot's location — e.g. a shared filesystem registered at
the site level is linkable from every host in the site.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..backends import KeyNotFound
from .affinity import match_affinity
from .cost_model import cheapest_replica
from .data_unit import DataUnit
from .pilot import PilotData, RuntimeContext

#: re-plans allowed when an eviction races a planned fetch before raising
MAX_REPLANS = 3


@dataclasses.dataclass
class TransferRecord:
    du_id: str
    src_pd: Optional[str]  # None == initial staging from the submission host
    dst_pd: str
    nbytes: int
    sim_seconds: float
    wall_seconds: float
    linked: bool = False  # True == logical link, no bytes moved
    t_submit_sim: float = 0.0
    #: wall clock (time.monotonic) at transfer start — the pipelining
    #: overlap proof reads these against CU run windows
    wall_start: float = 0.0
    #: True when issued by the async scheduler's prefetch pipeline
    pipelined: bool = False
    #: shared id for the per-DU shares of one batched bulk transfer
    batch_id: Optional[str] = None
    #: chunks moved by this record (0 for links / legacy whole-DU records)
    chunks: int = 0
    #: True when this record is one wave of a multi-source striped fetch
    striped: bool = False


@dataclasses.dataclass
class _FetchGroup:
    """One striped wave: a set of chunks pulled from one source."""

    src: Optional[PilotData]  # None == DU local buffer (submission host)
    indices: List[int]
    nbytes: int
    sim_seconds: float


#: one stager's claim on a set of chunks moving toward one sandbox
_Claim = Tuple[DataUnit, Set[int], threading.Event]


class TransferService:
    """Moves/links DU chunks between PDs and accounts simulated T_X/T_S/T_R."""

    def __init__(self, ctx: RuntimeContext):
        self.ctx = ctx
        ctx.transfer_service = self
        self._records: List[TransferRecord] = []
        self._lock = threading.Lock()
        self._sim_now = 0.0
        #: (du_id, dst_pd_id) -> list of (chunk set, Event) claims currently
        #: in flight; the dedup is chunk-granular — a second stager only
        #: fetches chunks nobody else claimed and *waits* for the rest
        self._inflight: Dict[
            Tuple[str, str], List[Tuple[Set[int], threading.Event]]
        ] = {}
        #: replica-resolution caches, keyed on the DU's location version
        #: (bumped on every chunk-holding change, so partial-replica
        #: progress invalidates them too)
        self._resolve_cache: Dict[Tuple[str, str], Tuple[int, Optional[str], bool]] = {}
        self._estimate_cache: Dict[Tuple[str, str, str], Tuple[int, float]] = {}
        self.cache_hits = 0
        self.cache_misses = 0
        self._batch_ids = itertools.count()
        #: PDs purged after pilot death — never planned as a source or
        #: served from a cached resolution again
        self._dead_pds: Set[str] = set()
        #: (src_pd_id, du_id) -> count of in-flight fetches reading from
        #: that source; quota eviction skips leased holdings so a planned
        #: copy's source cannot vanish mid-transfer
        self._src_leases: Dict[Tuple[str, str], int] = {}
        #: monotonic stamp for du:access records (tier access statistics)
        self._access_seq = itertools.count(1)
        #: per-tenant transfer attribution (sim seconds / bytes moved),
        #: keyed by the DU's owning tenant — fairness accounting
        self._tenant_sim: Dict[str, float] = {}
        self._tenant_bytes: Dict[str, int] = {}

    # ------------------------------------------------------------- costing
    def simulated_transfer_time(
        self, nbytes: int, src: PilotData, dst: PilotData
    ) -> float:
        topo = self.ctx.topology
        lat = (
            topo.latency(src.affinity, dst.affinity)
            + src.backend.profile.op_latency
            + dst.backend.profile.op_latency
        )
        bw = min(
            topo.bandwidth(src.affinity, dst.affinity),
            src.backend.profile.bandwidth,
            dst.backend.profile.bandwidth,
        )
        xfer = 0.0 if bw == float("inf") else nbytes / bw
        return lat + xfer + dst.backend.profile.register_latency

    def simulated_ingest_time(self, nbytes: int, dst: PilotData) -> float:
        """Initial staging from the submission host into a PD (paper Fig. 7:
        T_S per backend).  When the runtime declares a submission-host
        topology label, the transfer is additionally bottlenecked by that
        uplink (a gateway node's WAN link, like the paper's GW68)."""
        p = dst.backend.profile
        bw = p.bandwidth
        lat = p.op_latency
        sub = self.ctx.submission_label
        if sub is not None:
            bw = min(bw, self.ctx.topology.bandwidth(sub, dst.affinity))
            lat += self.ctx.topology.latency(sub, dst.affinity)
        return lat + nbytes / bw + p.register_latency

    # ------------------------------------------------------------ mechanics
    def is_linkable(self, pd: PilotData, location: str) -> bool:
        """Can a pilot at ``location`` access ``pd`` without a transfer?"""
        return match_affinity(pd.affinity, location) or pd.affinity == location

    def record(self, rec: TransferRecord) -> None:
        # attribute the transfer to the DU's owning tenant (store-side
        # lookup BEFORE taking our lock — no store op under a held lock)
        tenant = (
            self.ctx.store.hget(f"du:{rec.du_id}", "tenant") or "default"
        )
        with self._lock:
            self._records.append(rec)
            self._sim_now += rec.sim_seconds
            self._tenant_sim[tenant] = (
                self._tenant_sim.get(tenant, 0.0) + rec.sim_seconds
            )
            self._tenant_bytes[tenant] = (
                self._tenant_bytes.get(tenant, 0) + rec.nbytes
            )

    def records(self) -> List[TransferRecord]:
        with self._lock:
            return list(self._records)

    def per_tenant_transfer(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant transfer totals ({tenant: {"sim_seconds", "bytes"}})
        — the fairness accounting the multi-tenant bench reports on."""
        with self._lock:
            return {
                t: {
                    "sim_seconds": self._tenant_sim.get(t, 0.0),
                    "bytes": float(self._tenant_bytes.get(t, 0)),
                }
                for t in set(self._tenant_sim) | set(self._tenant_bytes)
            }

    def total_sim_seconds(self) -> float:
        with self._lock:
            return sum(r.sim_seconds for r in self._records)

    def reset_records(self) -> None:
        with self._lock:
            self._records.clear()

    def purge_pd(self, pd_id: str) -> None:
        """A PD died (its pilot failed): stop using it immediately.

        Releases every in-flight staging claim destined for it (stagers
        waiting on those claims wake and re-plan against live holders
        instead of blocking out their full timeout) and evicts every
        cached resolution/estimate that names it as source or destination.
        Location-version bumps from the holdings purge invalidate the rest.
        """
        with self._lock:
            self._dead_pds.add(pd_id)
            for key in list(self._inflight):
                if key[1] != pd_id:
                    continue
                for _, done in self._inflight.pop(key):
                    done.set()
            self._resolve_cache = {
                k: v for k, v in self._resolve_cache.items()
                if v[1] != pd_id
            }
            self._estimate_cache = {
                k: v for k, v in self._estimate_cache.items()
                if k[2] != pd_id
            }

    def is_dead(self, pd_id: str) -> bool:
        with self._lock:
            return pd_id in self._dead_pds

    # ------------------------------------------------- eviction interlocks
    def _lease_sources(self, du: DataUnit, groups: List["_FetchGroup"]) -> None:
        with self._lock:
            for g in groups:
                if g.src is not None:
                    k = (g.src.id, du.id)
                    self._src_leases[k] = self._src_leases.get(k, 0) + 1

    def _unlease_sources(self, du: DataUnit, groups: List["_FetchGroup"]) -> None:
        with self._lock:
            for g in groups:
                if g.src is not None:
                    k = (g.src.id, du.id)
                    n = self._src_leases.get(k, 0) - 1
                    if n > 0:
                        self._src_leases[k] = n
                    else:
                        self._src_leases.pop(k, None)

    def source_leased(self, pd_id: str, du_id: str) -> bool:
        """True while an in-flight fetch reads this DU from this PD — the
        TierManager must not evict the holding out from under it."""
        with self._lock:
            return self._src_leases.get((pd_id, du_id), 0) > 0

    def inflight_chunks(self, du_id: str, dst_pd_id: str) -> Set[int]:
        """Chunks currently claimed by stagers moving toward ``dst_pd_id``
        — eviction must not drop what a transfer is about to account."""
        with self._lock:
            out: Set[int] = set()
            for idxs, _ in self._inflight.get((du_id, dst_pd_id), []):
                out |= idxs
            return out

    def _note_access(self, du: DataUnit, location: str) -> None:
        """Publish one access record for the tier layer's frequency/recency
        statistics (rides the store's existing event stream; the TierManager
        folds it in asynchronously off the store dispatcher — readers that
        need up-to-date stats barrier via ``store.flush_events()``)."""
        self.ctx.store.hset(
            "du:access",
            du.id,
            {"location": location, "n": next(self._access_seq)},
        )

    def ingest(self, du: DataUnit, dst: PilotData) -> float:
        """Initial staging of a freshly-described DU into its first PD."""
        t0 = time.monotonic()
        nbytes = dst.put_du(du)
        sim = self.simulated_ingest_time(nbytes, dst)
        self.ctx.sleep_sim(sim)
        self.record(
            TransferRecord(
                du_id=du.id,
                src_pd=None,
                dst_pd=dst.id,
                nbytes=nbytes,
                sim_seconds=sim,
                wall_seconds=time.monotonic() - t0,
                wall_start=t0,
                chunks=du.n_chunks,
            )
        )
        return sim

    def replicate(self, du: DataUnit, src: PilotData, dst: PilotData) -> float:
        """Physically replicate a DU from ``src`` (a full replica) into
        ``dst``; only the chunks ``dst`` is missing move (delta transfer).
        Returns simulated T_X."""
        t0 = time.monotonic()
        n_missing = len(dst.missing_chunks(du))
        nbytes = dst.copy_du_from(du, src)
        sim = self.simulated_transfer_time(nbytes, src, dst)
        self.ctx.sleep_sim(sim)
        self.record(
            TransferRecord(
                du_id=du.id,
                src_pd=src.id,
                dst_pd=dst.id,
                nbytes=nbytes,
                sim_seconds=sim,
                wall_seconds=time.monotonic() - t0,
                wall_start=t0,
                chunks=n_missing,
            )
        )
        return sim

    def replicate_chunks(
        self,
        du: DataUnit,
        src: PilotData,
        dst: PilotData,
        indices: Sequence[int],
    ) -> float:
        """Move an explicit chunk subset from one holder to another — the
        disperse phase of chunk-striped group replication."""
        todo = [i for i in indices if i in set(src.chunks_held(du.id))]
        if not todo:
            return 0.0
        t0 = time.monotonic()
        nbytes = dst.copy_chunks_from(du, src, todo)
        if nbytes == 0:
            return 0.0
        sim = self.simulated_transfer_time(nbytes, src, dst)
        self.ctx.sleep_sim(sim)
        self.record(
            TransferRecord(
                du_id=du.id,
                src_pd=src.id,
                dst_pd=dst.id,
                nbytes=nbytes,
                sim_seconds=sim,
                wall_seconds=time.monotonic() - t0,
                wall_start=t0,
                chunks=len(todo),
                striped=True,
            )
        )
        return sim

    # -------------------------------------------------- chunk fetch planning
    def _chunk_sources(
        self, du: DataUnit, dst: PilotData
    ) -> List[Tuple[PilotData, Set[int]]]:
        """Live PDs (full or partial holders) usable as chunk sources."""
        out: List[Tuple[PilotData, Set[int]]] = []
        with self._lock:
            dead = set(self._dead_pds)
        for pd_id, idxs in sorted(du.chunk_holders().items()):
            if pd_id == dst.id or pd_id in dead or pd_id not in self.ctx.objects:
                continue
            pd = self.ctx.lookup(pd_id)
            if idxs:
                out.append((pd, set(idxs)))
        return out

    def plan_chunk_fetch(
        self,
        du: DataUnit,
        dst: PilotData,
        location: str,
        only: Optional[Set[int]] = None,
    ) -> List[_FetchGroup]:
        """Assign each missing chunk to a source, balancing finish times.

        Greedy list-schedule: chunks (in index order, deterministic) go to
        the holder whose per-source stripe would finish earliest after
        taking the chunk — so a nearby partial holder absorbs chunks until
        its stripe is as long as the next-best source's.  Chunks held by
        nobody fall back to the DU's local buffer (submission-host ingest).
        """
        missing = dst.missing_chunks(du)
        if du.streaming and not du.sealed:
            # live stream: only the published prefix is fetchable — an
            # unpublished chunk must never fall back to the orphan path
            # (its bytes may still change under the producer's pen)
            avail = du.available_chunks()
            missing = [i for i in missing if i < avail]
        if only is not None:
            missing = [i for i in missing if i in only]
        if not missing:
            return []
        chunks = du.chunks
        holders = self._chunk_sources(du, dst)
        topo = self.ctx.topology
        lat: Dict[str, float] = {}
        bw: Dict[str, float] = {}
        for pd, _ in holders:
            lat[pd.id] = (
                topo.latency(pd.affinity, location)
                + pd.backend.profile.op_latency
                + dst.backend.profile.op_latency
                + dst.backend.profile.register_latency
            )
            bw[pd.id] = min(
                topo.bandwidth(pd.affinity, location),
                pd.backend.profile.bandwidth,
                dst.backend.profile.bandwidth,
            )
        assigned: Dict[str, List[int]] = {pd.id: [] for pd, _ in holders}
        stripe_bytes: Dict[str, int] = {pd.id: 0 for pd, _ in holders}
        orphans: List[int] = []
        for i in missing:
            best: Optional[PilotData] = None
            best_t = float("inf")
            for pd, held in holders:
                if i not in held:
                    continue
                nb = stripe_bytes[pd.id] + chunks[i].size
                t = lat[pd.id] + (0.0 if bw[pd.id] == float("inf") else nb / bw[pd.id])
                if t < best_t:
                    best, best_t = pd, t
            if best is None:
                orphans.append(i)
            else:
                assigned[best.id].append(i)
                stripe_bytes[best.id] += chunks[i].size
        groups: List[_FetchGroup] = []
        for pd, _ in holders:
            if not assigned[pd.id]:
                continue
            nb = stripe_bytes[pd.id]
            xfer = 0.0 if bw[pd.id] == float("inf") else nb / bw[pd.id]
            groups.append(
                _FetchGroup(
                    src=pd,
                    indices=assigned[pd.id],
                    nbytes=nb,
                    # same lat/bw terms as the greedy assignment above, so
                    # the planned wave time IS the charged wave time — and
                    # both honor ``location`` (which may differ from the
                    # destination PD's own affinity label)
                    sim_seconds=lat[pd.id] + xfer,
                )
            )
        if orphans:
            nb = sum(chunks[i].size for i in orphans)
            groups.append(
                _FetchGroup(
                    src=None,
                    indices=orphans,
                    nbytes=nb,
                    sim_seconds=self.simulated_ingest_time(nb, dst),
                )
            )
        return groups

    def _fetch_groups(
        self,
        du: DataUnit,
        dst: PilotData,
        groups: List[_FetchGroup],
        register: bool = True,
        pipelined: bool = False,
        batch_id: Optional[str] = None,
        location: Optional[str] = None,
        _depth: int = 0,
    ) -> float:
        """Materialize planned striped waves; simulated time is the max
        over the (parallel) per-source waves.

        Sources are leased for the duration (quota eviction skips leased
        holdings); if an eviction still raced the plan — the source lost
        the chunks between planning and leasing — the missing remainder is
        **re-planned** against the current holders instead of failing the
        stage-in."""
        if not groups:
            return 0.0
        where = location or dst.affinity
        striped = len(groups) > 1
        done_sims: List[float] = []
        raced: Set[int] = set()
        self._lease_sources(du, groups)
        try:
            for g in groups:
                t0 = time.monotonic()
                try:
                    if g.src is None:
                        dst.put_chunks(du, g.indices, register=register)
                    else:
                        dst.copy_chunks_from(du, g.src, g.indices, register=register)
                except (KeyError, KeyNotFound):
                    if _depth >= MAX_REPLANS:
                        raise
                    held = set(dst.chunks_held(du.id))
                    raced.update(i for i in g.indices if i not in held)
                    continue
                self.record(
                    TransferRecord(
                        du_id=du.id,
                        src_pd=g.src.id if g.src is not None else None,
                        dst_pd=dst.id,
                        nbytes=g.nbytes,
                        sim_seconds=g.sim_seconds,
                        wall_seconds=time.monotonic() - t0,
                        wall_start=t0,
                        pipelined=pipelined,
                        batch_id=batch_id,
                        chunks=len(g.indices),
                        striped=striped,
                    )
                )
                done_sims.append(g.sim_seconds)
        finally:
            self._unlease_sources(du, groups)
        sim = max(done_sims, default=0.0)
        self.ctx.sleep_sim(sim)
        if raced:
            # the repair wave runs strictly AFTER the first wave (and
            # sleeps itself, recursively), so the honest model is the sum
            replanned = self.plan_chunk_fetch(du, dst, where, only=raced)
            sim += self._fetch_groups(
                du,
                dst,
                replanned,
                register=register,
                pipelined=pipelined,
                batch_id=batch_id,
                location=where,
                _depth=_depth + 1,
            )
        return sim

    def heal_replica(
        self,
        du: DataUnit,
        dst: PilotData,
        groups: Optional[List[_FetchGroup]] = None,
    ) -> float:
        """Complete a partial replica: stripe ``dst``'s missing chunks in
        from their cheapest current holders.  Unlike :meth:`stage_in` this
        always materializes (no logical-link shortcut) — it is the heal
        phase of chunk-striped group replication, whose contract is that
        ``dst`` ends holding every chunk physically.

        ``groups`` lets the caller pre-plan against a fixed
        holdings snapshot; the replication driver plans all targets
        sequentially before executing them in parallel, so simulated T_R
        does not depend on thread interleaving (the deterministic-clock
        contract the CI regression gate relies on)."""
        if groups is None:
            groups = self.plan_chunk_fetch(du, dst, dst.affinity)
        return self._fetch_groups(du, dst, groups)

    # --------------------------------------------------------- staging API
    def resolve_access(
        self, du: DataUnit, location: str
    ) -> Tuple[Optional[PilotData], bool]:
        """Find the best FULL replica of ``du`` for a pilot at ``location``.

        Returns (pd, linked): ``linked`` means zero-cost direct access; else
        ``pd`` is the cheapest full replica to transfer from (None if the DU
        has no full replica anywhere — callers then stripe from partial
        holders and/or the DU's local buffer).

        Resolutions are memoized per (DU, location) keyed on the DU's
        replica-set version, so the repeated ``cheapest_replica`` scans of
        a hot DU collapse to a dict hit until a chunk holding changes.
        """
        ver = du.locations_version
        key = (du.id, location)
        with self._lock:
            hit = self._resolve_cache.get(key)
            if hit is not None and hit[0] == ver:
                self.cache_hits += 1
                pd_id, linked = hit[1], hit[2]
                if pd_id is None:
                    return None, False
                if pd_id in self.ctx.objects:
                    return self.ctx.lookup(pd_id), linked
            self.cache_misses += 1
        pd, linked = self._resolve_uncached(du, location)
        with self._lock:
            self._resolve_cache[key] = (ver, pd.id if pd else None, linked)
        return pd, linked

    def _resolve_uncached(
        self, du: DataUnit, location: str
    ) -> Tuple[Optional[PilotData], bool]:
        with self._lock:
            dead = set(self._dead_pds)
        replicas = [
            self.ctx.lookup(pd_id)
            for pd_id in du.locations
            if pd_id in self.ctx.objects and pd_id not in dead
        ]
        for pd in replicas:
            if self.is_linkable(pd, location):
                return pd, True
        if not replicas:
            return None, False
        by_label = {pd.affinity: pd for pd in replicas}
        best_label, _ = cheapest_replica(
            du.size, list(by_label), location, self.ctx.topology
        )
        return by_label[best_label], False

    def estimate_stage_cost(
        self,
        du: DataUnit,
        location: str,
        sandbox: PilotData,
        tenant: Optional[str] = None,
    ) -> float:
        """Simulated cost of making ``du`` available at ``location``: 0 for
        linkable full replicas and fully-cached sandboxes, else the striped
        multi-source fetch cost of the *missing* chunks only (max over the
        parallel per-source waves).  Memoized like :meth:`resolve_access`.

        With a ``tenant``, the cost is scaled by that tenant's share of
        the contended bandwidth (its fair-share weight over all active
        tenants' weights): competing tenants see each other's traffic in
        the placement cost model.  The scaling applies AFTER the memoized
        lookup, so the cache stays tenant-neutral (one entry per
        (du, location, sandbox), valid for every requester)."""
        ver = du.locations_version
        key = (du.id, location, sandbox.id)
        cost: Optional[float] = None
        with self._lock:
            hit = self._estimate_cache.get(key)
            if hit is not None and hit[0] == ver:
                self.cache_hits += 1
                cost = hit[1]
            else:
                self.cache_misses += 1
        if cost is None:
            _, linked = self.resolve_access(du, location)
            if linked:
                cost = 0.0
            else:
                groups = self.plan_chunk_fetch(du, sandbox, location)
                cost = max((g.sim_seconds for g in groups), default=0.0)
            with self._lock:
                self._estimate_cache[key] = (ver, cost)
        if tenant is not None and cost > 0:
            registry = getattr(self.ctx, "tenant_registry", None)
            if registry is not None:
                share = registry.bw_share(tenant)
                if share < 1.0:
                    cost = cost / max(share, 1e-9)
        return cost

    def stage_in(
        self,
        du: DataUnit,
        sandbox: PilotData,
        location: str,
        use_cache: bool = True,
        prefix: Optional[int] = None,
    ) -> float:
        """Make ``du`` available to a CU sandbox at ``location``; returns
        simulated staging seconds (0.0 for a logical link).

        For a *live streaming* DU (streaming and not yet sealed) the goal
        is the published chunk prefix — optionally capped at ``prefix``
        chunks — rather than the whole DU: the call returns once the
        sandbox holds that prefix, and the consumer re-calls as the
        producer publishes more (chunk-granular re-planning).

        Only the sandbox's *missing* chunks move, striped in parallel from
        their cheapest current holders (partial replicas included).

        The in-flight dedup is chunk-granular: concurrent stagers of the
        same (DU, sandbox) — e.g. two CU slots sharing an input, or an
        agent racing the async scheduler's prefetch — split the missing
        chunk set instead of re-paying it.  Each caller claims only the
        chunks nobody else is moving, fetches those, and *waits* for the
        claims of others, so exactly one physical transfer happens per
        chunk.

        ``use_cache=False`` models the paper's PD-less naive mode: every CU
        re-stages the whole DU into its own sandbox from one source — the
        full monolithic transfer cost is charged each time and the sandbox
        never becomes a replica."""
        if not use_cache:
            t0 = time.monotonic()
            already = sandbox.has_du(du.id)
            if du.locations:
                pd, _ = self.resolve_access(du, location)
                sim = self.simulated_transfer_time(du.size, pd, sandbox)
                if not already:
                    sandbox.copy_du_from(du, pd, register=False)
            else:
                sim = self.simulated_ingest_time(du.size, sandbox)
                if not already:
                    sandbox.put_du(du, register=False)
            self.ctx.sleep_sim(sim)
            self.record(
                TransferRecord(
                    du_id=du.id,
                    src_pd=None,
                    dst_pd=sandbox.id,
                    nbytes=du.size,
                    sim_seconds=sim,
                    wall_seconds=0.0,
                    wall_start=t0,
                    chunks=du.n_chunks,
                )
            )
            return sim
        live_stream = du.streaming and not du.sealed
        target: Optional[Set[int]] = None
        if live_stream:
            avail = du.available_chunks()
            goal = avail if prefix is None else min(prefix, avail)
            target = set(range(goal))
            if not target:
                return 0.0  # nothing published yet; caller waits and retries
        if du.n_chunks == 0 and not live_stream:
            # empty DU: register the (vacuously full) holding, move nothing
            if not sandbox.has_du(du.id):
                sandbox.put_du(du)
            return 0.0
        # one demand-access record per stage-in (hit or miss alike): the
        # TierManager's frequency/recency stats and promotion thresholds
        # ride this store event
        self._note_access(du, location)
        key = (du.id, sandbox.id)
        total_sim = 0.0
        while True:
            if target is not None:
                if target <= set(sandbox.chunks_held(du.id)):
                    return total_sim  # the requested prefix has landed
            elif sandbox.has_du(du.id):
                return total_sim  # pilot-level cache hit (data-diffusion reuse)
            pd, linked = self.resolve_access(du, location)
            if linked:
                self.record(
                    TransferRecord(
                        du_id=du.id,
                        src_pd=pd.id,
                        dst_pd=sandbox.id,
                        nbytes=0,
                        sim_seconds=0.0,
                        wall_seconds=0.0,
                        wall_start=time.monotonic(),
                        linked=True,
                    )
                )
                return total_sim
            missing = set(sandbox.missing_chunks(du))
            if target is not None:
                missing &= target
            with self._lock:
                claims = self._inflight.setdefault(key, [])
                theirs: Set[int] = set()
                for idxs, _ in claims:
                    theirs |= idxs
                mine = missing - theirs
                if mine:
                    done = threading.Event()
                    claims.append((mine, done))
                    waiting: Optional[List[threading.Event]] = None
                else:
                    # everything missing is being moved by someone else:
                    # wait for their claims to land, then re-check
                    waiting = [ev for _, ev in claims]
            if waiting is not None:
                if not waiting:
                    continue  # holdings changed mid-check; re-evaluate
                for ev in waiting:
                    ev.wait(timeout=120.0)
                continue
            try:
                groups = self.plan_chunk_fetch(du, sandbox, location, only=mine)
                if target is not None and not groups:
                    # the stream rolled back under us (failed producer
                    # attempt reset it): hand control back — the consumer
                    # re-waits on the published prefix and retries
                    return total_sim
                total_sim += self._fetch_groups(du, sandbox, groups, location=location)
            finally:
                with self._lock:
                    entries = self._inflight.get(key, [])
                    self._inflight[key] = [e for e in entries if e[1] is not done]
                    if not self._inflight[key]:
                        self._inflight.pop(key, None)
                done.set()
            # loop: either the DU is now fully held, or other stagers'
            # claims are still landing and we wait for them above

    # ---------------------------------------------------- pipelined staging
    def claim_bulk(self, dus: Sequence[DataUnit], sandbox: PilotData) -> List[_Claim]:
        """Claim the not-yet-in-flight missing chunks of ``dus`` toward
        ``sandbox`` and return the claims.  The async scheduler calls this
        BEFORE the CU is pushed to a pilot queue, so an agent that claims
        the CU immediately still dedups onto the prefetch instead of racing
        it with its own per-chunk transfers.  Pass the result to
        :meth:`stage_in_bulk` (or :meth:`release_claims` on abort)."""
        claimed: List[_Claim] = []
        for du in dus:
            if du.size <= 0 or sandbox.has_du(du.id):
                continue
            missing = set(sandbox.missing_chunks(du))
            if du.streaming and not du.sealed:
                # prefetch only what the producer has published so far; the
                # scheduler re-claims as further publish events arrive
                missing &= set(range(du.available_chunks()))
            if not missing:
                continue
            key = (du.id, sandbox.id)
            with self._lock:
                claims = self._inflight.setdefault(key, [])
                theirs: Set[int] = set()
                for idxs, _ in claims:
                    theirs |= idxs
                mine = missing - theirs
                if not mine:
                    continue
                done = threading.Event()
                claims.append((mine, done))
            claimed.append((du, mine, done))
        return claimed

    def release_claims(
        self,
        claimed: List[_Claim],
        sandbox: PilotData,
    ) -> None:
        for du, _, done in claimed:
            key = (du.id, sandbox.id)
            with self._lock:
                entries = self._inflight.get(key, [])
                self._inflight[key] = [e for e in entries if e[1] is not done]
                if not self._inflight[key]:
                    self._inflight.pop(key, None)
            done.set()

    def stage_in_bulk(
        self,
        dus: Sequence[DataUnit],
        sandbox: PilotData,
        location: str,
        pipelined: bool = False,
        batch_id: Optional[str] = None,
        claimed: Optional[List[_Claim]] = None,
        on_complete=None,
    ) -> float:
        """Stage several DUs into one sandbox, batching same-source chunk
        groups into ONE costed bulk transfer per source (a single
        per-request setup latency + catalog registration amortized over the
        batch, instead of paying both per DU) while distinct sources stripe
        in parallel (total simulated time = max over the per-source
        batches).  Per-DU records carry byte-proportional shares of their
        source batch's cost under a shared ``batch_id``.

        Chunks already present, already in flight (another stager owns
        them), or belonging to empty DUs are skipped.  Returns the
        simulated seconds of the slowest source batch."""
        if claimed is None:
            claimed = self.claim_bulk(dus, sandbox)
        try:
            if not claimed:
                return 0.0
            bid = batch_id or f"batch-{next(self._batch_ids)}"
            # Plan every DU's striped fetch, splitting links from per-source
            # groups; groups sharing a source merge into one bulk transfer.
            by_src: Dict[Optional[str], List[Tuple[DataUnit, _FetchGroup]]] = {}
            for du, mine, _ in claimed:
                src_pd, linked = self.resolve_access(du, location)
                if linked:
                    self.record(
                        TransferRecord(
                            du_id=du.id,
                            src_pd=src_pd.id if src_pd else None,
                            dst_pd=sandbox.id,
                            nbytes=0,
                            sim_seconds=0.0,
                            wall_seconds=0.0,
                            wall_start=time.monotonic(),
                            linked=True,
                            pipelined=pipelined,
                            batch_id=bid,
                        )
                    )
                    continue
                for g in self.plan_chunk_fetch(du, sandbox, location, only=mine):
                    by_src.setdefault(
                        g.src.id if g.src is not None else None, []
                    ).append((du, g))
            wave_sims: List[float] = []
            raced: List[Tuple[DataUnit, Set[int]]] = []
            for src_id, items in by_src.items():
                t0 = time.monotonic()
                src = items[0][1].src
                # Materialize, then cost/record whatever actually moved —
                # if a copy fails mid-batch, the chunks already in the
                # sandbox are still charged and recorded (no free bytes).
                moved: List[Tuple[DataUnit, _FetchGroup]] = []
                try:
                    for du, g in items:
                        self._lease_sources(du, [g])
                        try:
                            if src is None:
                                sandbox.put_chunks(du, g.indices)
                            else:
                                sandbox.copy_chunks_from(du, src, g.indices)
                        except (KeyError, KeyNotFound):
                            # eviction raced the plan: re-plan this DU's
                            # remainder against current holders below
                            held = set(sandbox.chunks_held(du.id))
                            raced.append((du, {i for i in g.indices if i not in held}))
                            continue
                        finally:
                            self._unlease_sources(du, [g])
                        moved.append((du, g))
                finally:
                    moved_bytes = sum(g.nbytes for _, g in moved)
                    if moved:
                        if src is None:
                            sim = self.simulated_ingest_time(moved_bytes, sandbox)
                        else:
                            sim = self.simulated_transfer_time(
                                moved_bytes, src, sandbox
                            )
                        wall = time.monotonic() - t0
                        for du, g in moved:
                            share = (
                                sim * (g.nbytes / moved_bytes)
                                if moved_bytes
                                else 0.0
                            )
                            self.record(
                                TransferRecord(
                                    du_id=du.id,
                                    src_pd=src_id,
                                    dst_pd=sandbox.id,
                                    nbytes=g.nbytes,
                                    sim_seconds=share,
                                    wall_seconds=wall,
                                    wall_start=t0,
                                    pipelined=pipelined,
                                    batch_id=bid,
                                    chunks=len(g.indices),
                                    striped=len(by_src) > 1,
                                )
                            )
                        wave_sims.append(sim)
            raced_sim = 0.0
            for du, missing in raced:
                if not missing:
                    continue
                replanned = self.plan_chunk_fetch(du, sandbox, location, only=missing)
                # repair fetches sleep themselves (sequentially, after the
                # batched waves) — keep them out of the parallel-wave max
                raced_sim += self._fetch_groups(
                    du,
                    sandbox,
                    replanned,
                    pipelined=pipelined,
                    batch_id=bid,
                    location=location,
                    _depth=1,
                )
            batch_sim = max(wave_sims, default=0.0)
            if batch_sim > 0.0:
                self.ctx.sleep_sim(batch_sim)
            total_sim = batch_sim + raced_sim
            if on_complete is not None:
                # runs BEFORE claims release, so anyone woken by the
                # release already sees the completion's side effects
                on_complete(total_sim)
            return total_sim
        finally:
            self.release_claims(claimed, sandbox)

    def lookup_dus(self, cu) -> List[DataUnit]:
        """Resolve a CU's input DU ids to live objects (unknown ids skipped)."""
        dus: List[DataUnit] = []
        for du_id in cu.description.input_data:
            try:
                dus.append(self.ctx.lookup(du_id))
            except KeyError:
                continue
        return dus

    def prefetch_inputs(self, cu, pilot, claimed=None) -> float:
        """Async-scheduler hook: bulk-stage a CU's missing input chunks into
        its assigned pilot's sandbox ahead of execution, so staging overlaps
        the pilot's current compute.  Records the attributed simulated
        seconds on the CU (``sim_prefetch_s``).

        With ``claimed`` provided (the scheduler claimed before pushing the
        CU), the work-list comes entirely from the claims — no re-lookup."""
        dus = [] if claimed is not None else self.lookup_dus(cu)

        def attribute(sim: float) -> None:
            if sim > 0.0:
                self.ctx.store.hset(f"cu:{cu.id}", "sim_prefetch_s", sim)

        return self.stage_in_bulk(
            dus,
            pilot.sandbox,
            pilot.affinity,
            pipelined=True,
            batch_id=f"prefetch-{cu.id}",
            claimed=claimed,
            on_complete=attribute,
        )
