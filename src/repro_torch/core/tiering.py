"""Tiered storage hierarchy: tier classification, quota-driven eviction,
and hot-chunk promotion into a memory-tier cache.

The paper's adaptor pattern (§4.2) gives every Pilot-Data a backend with a
distinct performance profile (Fig. 7 shows backend choice dominating
transfer time), but the runtime historically treated each PD as a flat,
infinite-durability peer: a full PD simply raised ``QuotaExceeded``.  This
module turns the backend spread into a first-class storage *hierarchy* —
the RAM/SSD/Lustre tiering of "Hadoop on HPC" (Luckow et al., 2016) and
the Spark-style in-memory tier of the 2015 pilot-abstraction paper:

  * :func:`classify_tier` maps every PD onto a tier — ``dram-cache`` /
    ``node-local`` / ``site-shared`` / ``archival`` — from an explicit
    ``tier=`` in its description or its backend's :class:`BackendProfile`;
  * :class:`TierManager` tracks per-DU access frequency/recency off the
    coordination store's existing event stream (the transfer service
    publishes one ``du:access`` record per stage-in — no polling);
  * **quota-driven eviction** replaces the hard ``QuotaExceeded``: when a
    put/stage-in would exceed a PD's ``size_quota``, a pluggable
    :class:`EvictionPolicy` (LRU / LFU / largest-first, registered like
    placement strategies) reclaims space by dropping chunk replicas that
    are *redundant* — never the last copy of a sealed DU's chunk, never a
    full replica that would take a DU below its ``replication_factor``,
    never chunks claimed by an in-flight transfer, never the pinned
    inputs of a Waiting/Running consumer (pins are wired through the
    agent and the DependencyTracker);
  * **hot-chunk promotion**: DUs re-read from the same site cross an
    access threshold and are asynchronously copied into a mem-tier cache
    PD at that site (off the critical path, like the async scheduler's
    prefetch); under pressure the same eviction machinery demotes them.

Eviction keeps the replica bookkeeping exact: evicted chunks leave
``du:<id>:chunks``, location versions bump (transfer resolve/estimate
caches invalidate), and a PD that no longer covers every chunk is demoted
from ``locations`` back to a partial holder.
"""

from __future__ import annotations

import abc
import collections
import dataclasses
import itertools
import queue
import threading
from typing import (
    Any,
    Callable,
    Deque,
    Dict,
    List,
    Optional,
    Sequence,
    Set,
    Tuple,
)

from .coordination import StoreEvent
from .data_unit import DataUnit
from .pilot import PilotData, PilotDataDescription, PilotState, RuntimeContext
from .replication import _site_of

# ------------------------------------------------------------------- tiers
#: fastest → slowest; ordinals rank tiers where a scalar is needed
TIER_DRAM = "dram-cache"
TIER_NODE = "node-local"
TIER_SITE = "site-shared"
TIER_ARCHIVE = "archival"
TIERS = (TIER_DRAM, TIER_NODE, TIER_SITE, TIER_ARCHIVE)

#: URL scheme → tier (the adaptor already encodes the hardware class)
_SCHEME_TIERS = {
    "mem": TIER_DRAM,
    "file": TIER_NODE,
    "sharedfs": TIER_SITE,
    "object": TIER_ARCHIVE,
}

#: profile-bandwidth thresholds (bytes/s) for schemes the map doesn't know
_BW_TIERS = ((5e9, TIER_DRAM), (1e9, TIER_NODE), (0.5e9, TIER_SITE))


def classify_tier(pd: PilotData) -> str:
    """Tier of a Pilot-Data: explicit ``tier=`` in its description wins,
    then the backend scheme, then the profile's sustained bandwidth."""
    explicit = getattr(pd.description, "tier", "")
    if explicit:
        if explicit not in TIERS:
            raise ValueError(f"unknown storage tier {explicit!r} (known: {TIERS})")
        return explicit
    tier = _SCHEME_TIERS.get(pd.backend.scheme)
    if tier is not None:
        return tier
    bw = pd.backend.profile.bandwidth
    for threshold, t in _BW_TIERS:
        if bw >= threshold:
            return t
    return TIER_ARCHIVE


def tier_rank(tier: str) -> int:
    """0 = fastest (DRAM); larger = colder."""
    return TIERS.index(tier) if tier in TIERS else len(TIERS)


# ------------------------------------------------------------------- pins
class PinRegistry:
    """DU ids pinned by live consumers — never evicted while pinned.

    Owners are CU ids: a CU pins its declared inputs from submission
    (Waiting CUs included — the DependencyTracker re-pins on re-park)
    until it reaches a terminal state.  Lookups are self-healing: a pin
    whose owner CU is already terminal is dropped lazily, so a crashed
    agent cannot leak a pin forever.
    """

    def __init__(self, ctx: RuntimeContext):
        self.ctx = ctx
        self._lock = threading.Lock()
        self._owners: Dict[str, Set[str]] = {}  # du_id -> owner cu_ids
        #: du_id -> owner cu_id -> consumed chunk prefix (streaming reads):
        #: chunks below EVERY live owner's frontier are consumed and may be
        #: evicted even while the DU stays pinned
        self._frontiers: Dict[str, Dict[str, int]] = {}

    def pin(self, du_id: str, owner: str) -> None:
        with self._lock:
            self._owners.setdefault(du_id, set()).add(owner)

    def pin_inputs(self, cu) -> None:
        for du_id in cu.description.input_data:
            self.pin(du_id, cu.id)

    def unpin(self, du_id: str, owner: str) -> None:
        with self._lock:
            owners = self._owners.get(du_id)
            if owners is not None:
                owners.discard(owner)
                if not owners:
                    del self._owners[du_id]
            fr = self._frontiers.get(du_id)
            if fr is not None:
                fr.pop(owner, None)
                if not fr:
                    del self._frontiers[du_id]

    def unpin_owner(self, owner: str) -> None:
        with self._lock:
            for du_id in list(self._owners):
                self._owners[du_id].discard(owner)
                if not self._owners[du_id]:
                    del self._owners[du_id]
            for du_id in list(self._frontiers):
                self._frontiers[du_id].pop(owner, None)
                if not self._frontiers[du_id]:
                    del self._frontiers[du_id]

    # ------------------------------------------------------ read frontiers
    def advance_frontier(self, du_id: str, owner: str, upto: int) -> int:
        """Record that ``owner`` has consumed the first ``upto`` chunks of
        streaming DU ``du_id``.  Monotone: a frontier never moves backward
        (max-merge), so eviction decisions based on an earlier reading
        stay valid.  Returns the owner's (possibly unchanged) frontier."""
        with self._lock:
            fr = self._frontiers.setdefault(du_id, {})
            cur = fr.get(owner, 0)
            if upto > cur:
                fr[owner] = upto
                return upto
            return cur

    def read_frontier(self, du_id: str) -> int:
        """The slowest *live* pinning consumer's consumed prefix: chunks
        below this index are consumed by everyone and evictable.  A live
        pinning owner with no recorded frontier holds it at 0 (nothing of
        the stream may be reclaimed for it yet); with no live pinning
        owners at all there is no frontier constraint (the plain
        redundancy/replication invariants still apply)."""
        with self._lock:
            owners = list(self._owners.get(du_id, ()))
            fr = dict(self._frontiers.get(du_id, {}))
        live = [o for o in owners if self._owner_live(o)]
        if not live:
            return -1  # unconstrained (no live consumer to starve)
        return min(fr.get(o, 0) for o in live)

    #: owner CU states whose pins bind: a parked consumer's inputs and a
    #: staging/running attempt's inputs must survive; a merely *queued*
    #: (Pending) CU re-stages whatever is missing when it runs, so its
    #: pin does not block eviction of the bytes someone else needs NOW
    _BINDING_STATES = ("Waiting", "Staging", "Running")

    def _owner_live(self, cu_id: str) -> bool:
        state = self.ctx.store.hget(f"cu:{cu_id}", "state")
        return state in self._BINDING_STATES

    def pinned(self, du_id: str) -> bool:
        """True iff a *live* (non-terminal) consumer pins ``du_id``; dead
        owners are garbage-collected on the way through."""
        with self._lock:
            owners = list(self._owners.get(du_id, ()))
        if not owners:
            return False
        dead = [o for o in owners if not self._owner_live(o)]
        if dead:
            with self._lock:
                live = self._owners.get(du_id)
                if live is not None:
                    live.difference_update(dead)
                    if not live:
                        del self._owners[du_id]
                        return False
        return len(owners) > len(dead)

    def pinned_dus(self) -> List[str]:
        with self._lock:
            return sorted(self._owners)


# -------------------------------------------------------- eviction policies
@dataclasses.dataclass
class Victim:
    """One evictable (DU, chunk subset) group inside a PD, with the access
    statistics eviction policies rank on."""

    du_id: str
    indices: List[int]  # evictable chunk indices, ascending
    nbytes: int
    last_access: int  # monotonic access counter (0 = never accessed)
    access_count: int
    #: owning tenant — tenant-aware make_room reclaims the requestor's
    #: own redundant chunks before touching anyone else's
    tenant: str = "default"


class EvictionPolicy(abc.ABC):
    """Orders eviction victims; space is reclaimed front-to-back.

    Implementations must be deterministic for a fixed victim list (the
    CI regression gate replays eviction-churn benchmarks)."""

    #: registry key; subclasses override
    name: str = "?"

    @abc.abstractmethod
    def rank(self, pd: PilotData, victims: Sequence[Victim]) -> List[Victim]:
        ...


_POLICIES: Dict[str, Callable[..., EvictionPolicy]] = {}
_policy_lock = threading.Lock()


def register_eviction_policy(name: str):
    """Class decorator: register an eviction policy factory under ``name``."""

    def deco(cls):
        cls.name = name
        with _policy_lock:
            _POLICIES[name] = cls
        return cls

    return deco


def make_eviction_policy(name: str, **kwargs) -> EvictionPolicy:
    with _policy_lock:
        if name not in _POLICIES:
            raise KeyError(
                f"unknown eviction policy {name!r} "
                f"(registered: {sorted(_POLICIES)})"
            )
        factory = _POLICIES[name]
    return factory(**kwargs)


def list_eviction_policies() -> List[str]:
    with _policy_lock:
        return sorted(_POLICIES)


@register_eviction_policy("lru")
class LRUPolicy(EvictionPolicy):
    """Least-recently-accessed DU first (du id breaks ties)."""

    def rank(self, pd, victims):
        return sorted(victims, key=lambda v: (v.last_access, v.du_id))


@register_eviction_policy("lfu")
class LFUPolicy(EvictionPolicy):
    """Least-frequently-accessed DU first; recency, then id break ties."""

    def rank(self, pd, victims):
        return sorted(
            victims,
            key=lambda v: (v.access_count, v.last_access, v.du_id),
        )


@register_eviction_policy("largest-first")
class LargestFirstPolicy(EvictionPolicy):
    """Most evictable bytes first — frees quota in the fewest evictions."""

    def rank(self, pd, victims):
        return sorted(victims, key=lambda v: (-v.nbytes, v.du_id))


# ------------------------------------------------------------ tier manager
class TierManager:
    """Storage-hierarchy coordinator: tier classification, access stats,
    quota-driven eviction, and mem-tier cache promotion.

    Attached to the :class:`RuntimeContext` (``ctx.tier_manager``) so
    Pilot-Data quota checks can call :meth:`make_room` without an import
    cycle.  Access statistics ride the coordination store's keyspace
    notifications: the transfer service publishes one ``du:access`` record
    per stage-in and this manager folds it into per-DU frequency/recency
    (and per-site demand, which drives promotion).
    """

    def __init__(
        self,
        ctx: RuntimeContext,
        cds: Optional[Any] = None,
        eviction_policy: str = "lru",
        cache_bytes: int = 0,
        promote_after: int = 2,
        auto_promote: bool = True,
    ):
        self.ctx = ctx
        self.cds = cds
        self.policy: EvictionPolicy = (
            eviction_policy
            if isinstance(eviction_policy, EvictionPolicy)
            else make_eviction_policy(eviction_policy)
        )
        self.pins = PinRegistry(ctx)
        self.cache_bytes = cache_bytes
        self.promote_after = promote_after
        #: bounded audit tail of evictions ({"pd", "du", "chunks",
        #: "nbytes", "policy"}) — a churn workload evicts indefinitely,
        #: so the full history cannot be kept; totals below never reset
        self.evictions: Deque[Dict[str, Any]] = collections.deque(maxlen=1000)
        self.evictions_total = 0
        self.evicted_bytes_total = 0
        #: evictions where the requesting tenant reclaimed ANOTHER
        #: tenant's (redundant, unpinned) chunks — only after its own
        #: were exhausted
        self.cross_tenant_evictions_total = 0
        #: cross-tenant evictions that touched a pinned DU: guarded to be
        #: impossible (victim discovery excludes them); bench-gated == 0
        self.cross_tenant_pinned_evictions = 0
        #: bounded audit tail of (du_id, cache_pd_id) promotions
        self.promotions: Deque[tuple] = collections.deque(maxlen=1000)
        self.promotions_total = 0
        #: site -> mem-tier cache PD (created lazily on first promotion)
        self.cache_pds: Dict[str, PilotData] = {}
        self._counter = itertools.count(1)
        self._lock = threading.Lock()
        self._evict_lock = threading.Lock()
        #: serializes cache-PD creation per process (NOT self._lock: a PD
        #: constructor writes to the store, whose callbacks re-enter
        #: _on_access and take self._lock on the same thread)
        self._cache_create_lock = threading.Lock()
        self._freq: Dict[str, int] = {}
        self._last: Dict[str, int] = {}
        self._site_freq: Dict[tuple, int] = {}
        self._promote_q: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._queued: Set[tuple] = set()
        self._stop = threading.Event()
        self._token = ctx.store.subscribe(self._on_access, prefix="du:access")
        ctx.tier_manager = self
        self._thread: Optional[threading.Thread] = None
        if auto_promote and cache_bytes > 0:
            self._thread = threading.Thread(
                target=self._promote_loop, name="tier-promoter", daemon=True
            )
            self._thread.start()

    # -------------------------------------------------------------- tiers
    def tier_of(self, pd: PilotData) -> str:
        return classify_tier(pd)

    def pds_by_tier(self) -> Dict[str, List[str]]:
        """Live PD ids grouped by tier (diagnostics/benchmarks)."""
        out: Dict[str, List[str]] = {t: [] for t in TIERS}
        for obj in list(self.ctx.objects.values()):
            if isinstance(obj, PilotData):
                out[self.tier_of(obj)].append(obj.id)
        return {t: sorted(ids) for t, ids in out.items()}

    # ------------------------------------------------------- access stats
    def _on_access(self, ev: StoreEvent) -> None:
        """Store callback (dispatcher thread): fold one access record into
        the frequency/recency tables; cheap and lock-scoped only."""
        if ev.op != "hset" or ev.key != "du:access" or ev.field is None:
            return
        du_id = ev.field
        location = ""
        if isinstance(ev.value, dict):
            location = ev.value.get("location", "")
        with self._lock:
            tick = next(self._counter)
            self._freq[du_id] = self._freq.get(du_id, 0) + 1
            self._last[du_id] = tick
            hot = False
            if location:
                site = _site_of(location)
                key = (du_id, site)
                self._site_freq[key] = self._site_freq.get(key, 0) + 1
                hot = (
                    self.cache_bytes > 0
                    and self._site_freq[key] >= self.promote_after
                    and key not in self._queued
                )
                if hot:
                    self._queued.add(key)
        if hot:
            self._promote_q.put((du_id, site))

    def access_stats(self, du_id: str) -> tuple:
        """(access_count, last_access_tick) for a DU; (0, 0) if never.
        Barriers on the store dispatcher first, so stats reflect every
        access record already published."""
        self.ctx.store.flush_events()
        with self._lock:
            return self._freq.get(du_id, 0), self._last.get(du_id, 0)

    def _stats_snapshot(self) -> Tuple[Dict[str, int], Dict[str, int]]:
        """One consistent (freq, last) copy — callers that rank many DUs
        take this once instead of barriering per DU."""
        with self._lock:
            return dict(self._freq), dict(self._last)

    # ---------------------------------------------------------- eviction
    def _live_holders(self, du: DataUnit) -> Dict[str, Set[int]]:
        """Registered chunk holders that are still usable sources: live
        objects, not FAILED/CANCELED, not purged by fault recovery."""
        store = self.ctx.store
        ts = self.ctx.transfer_service
        out: Dict[str, Set[int]] = {}
        for pd_id, idxs in du.chunk_holders().items():
            if pd_id not in self.ctx.objects:
                continue
            if store.hget(f"pd:{pd_id}", "state") in (
                PilotState.FAILED,
                PilotState.CANCELED,
            ):
                continue
            if ts is not None and ts.is_dead(pd_id):
                continue
            out[pd_id] = set(idxs)
        return out

    def _du_handle(self, pd: PilotData, du_id: str) -> Optional[DataUnit]:
        du = self.ctx.objects.get(du_id)
        if isinstance(du, DataUnit):
            return du
        return pd._du_objs.get(du_id)

    def evictable_victims(
        self,
        pd: PilotData,
        exclude_du: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> List[Victim]:
        """Chunk replicas in ``pd`` that are safe to drop.

        A chunk is redundant iff at least one OTHER live registered holder
        also holds it — so eviction can never lose the last copy of a
        sealed DU's chunk.  Whole DUs are skipped when they are pinned by
        a live consumer, leased as an in-flight transfer source, being
        staged into ``pd`` right now, or when dropping this (full) replica
        would take the DU below its ``replication_factor``.

        ``tenant`` names the requestor (the tenant whose write needs the
        space): the streaming-frontier carve-out below — the only path
        that may touch a *pinned* DU's chunks — is then restricted to the
        requestor's own DUs, so one tenant's pressure can never reclaim
        even the consumed prefix of ANOTHER tenant's pinned working set.
        """
        ts = self.ctx.transfer_service
        store = self.ctx.store
        # one barrier + one stats copy up front (PD-L002: per-DU
        # access_stats() calls would flush the dispatcher once per DU,
        # and make_room() calls us with _evict_lock held)
        self.ctx.store.flush_events()
        freq, last_seen = self._stats_snapshot()
        out: List[Victim] = []
        for du_id in pd.du_ids():
            if du_id == exclude_du:
                continue
            du = self._du_handle(pd, du_id)
            if du is None:
                continue
            du_tenant = store.hget(f"du:{du_id}", "tenant") or "default"
            frontier: Optional[int] = None
            if self.pins.pinned(du_id):
                if not du.streaming:
                    continue
                if tenant is not None and du_tenant != tenant:
                    # another tenant's pinned streaming working set is
                    # off-limits entirely, consumed prefix included
                    continue
                # streamed chunks are evictable only PAST the slowest live
                # consumer's read frontier: consumed prefix chunks may be
                # reclaimed (that is the backpressure valve), unconsumed
                # ones never (a released prefix-consumer must not observe
                # a chunk gap)
                frontier = self.pins.read_frontier(du_id)
                if frontier == 0:
                    continue  # nothing consumed yet: fully protected
            if ts is not None and ts.source_leased(pd.id, du_id):
                continue
            # local accounting, so transient (register=False) sandbox
            # copies are evictable too; redundancy is judged against the
            # *registered* holdings of every other live PD
            mine = set(pd.chunks_held(du_id))
            holders = self._live_holders(du)
            holders.pop(pd.id, None)
            if not mine:
                continue
            if pd.id in du.locations:
                live_full = [
                    loc
                    for loc in du.locations
                    if loc == pd.id or loc in holders
                ]
                if len(live_full) <= max(du.replication_factor, 1):
                    continue  # would drop the DU below its factor
            elsewhere: Set[int] = set()
            for idxs in holders.values():
                elsewhere |= idxs
            inflight = (
                ts.inflight_chunks(du_id, pd.id) if ts is not None else set()
            )
            indices = sorted(i for i in mine - inflight if i in elsewhere)
            if frontier is not None and frontier >= 0:
                indices = [i for i in indices if i < frontier]
            if not indices:
                continue
            chunks = du.chunks
            nbytes = sum(chunks[i].size for i in indices if i < len(chunks))
            count, last = freq.get(du_id, 0), last_seen.get(du_id, 0)
            out.append(
                Victim(
                    du_id=du_id,
                    indices=indices,
                    nbytes=nbytes,
                    last_access=last,
                    access_count=count,
                    tenant=du_tenant,
                )
            )
        return out

    def make_room(
        self,
        pd: PilotData,
        need: int,
        exclude_du: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> int:
        """Reclaim at least ``need`` bytes in ``pd`` by evicting redundant
        chunk replicas in policy order; returns bytes actually freed (may
        be less when the invariants forbid further eviction — the caller
        then raises ``QuotaExceeded`` exactly as before).

        ``tenant`` names the requestor: its OWN redundant chunks are
        reclaimed (in policy order) before any other tenant's are touched,
        so one tenant's cache pressure is absorbed by its own working set
        first.  Cross-tenant evictions — still invariant-guarded: never a
        pinned DU, never a last copy — are counted separately for audit.
        With ``tenant=None`` (or a single-tenant world, where every victim
        shares the requestor's tenant) the ordering is exactly the
        pre-tenancy policy ranking."""
        if need <= 0:
            return 0
        freed = 0
        # candidate discovery barriers on the store dispatcher, so it must
        # run before _evict_lock is taken (PD-L002: the dispatcher may be
        # delivering a callback that wants this same lock)
        candidates = self.evictable_victims(
            pd, exclude_du=exclude_du, tenant=tenant
        )
        with self._evict_lock:
            if tenant is not None:
                own = [v for v in candidates if v.tenant == tenant]
                others = [v for v in candidates if v.tenant != tenant]
                victims = self.policy.rank(pd, own) + self.policy.rank(
                    pd, others
                )
            else:
                victims = self.policy.rank(pd, candidates)
            for v in victims:
                if freed >= need:
                    break
                du = self._du_handle(pd, v.du_id)
                if du is None:
                    continue
                take: List[int] = []
                taken = 0
                for i in v.indices:
                    if freed + taken >= need:
                        break
                    take.append(i)
                    taken += du.chunks[i].size if i < du.n_chunks else 0
                if not take:
                    continue
                nbytes = pd.evict_chunks(du, take)
                freed += nbytes
                if nbytes:
                    self.evictions_total += 1
                    self.evicted_bytes_total += nbytes
                    cross = tenant is not None and v.tenant != tenant
                    if cross:
                        self.cross_tenant_evictions_total += 1
                        if self.pins.pinned(v.du_id):
                            # guarded against upstream — this counter
                            # staying 0 is the bench-gated isolation claim
                            self.cross_tenant_pinned_evictions += 1
                    self.evictions.append(
                        {
                            "pd": pd.id,
                            "du": v.du_id,
                            "chunks": len(take),
                            "nbytes": nbytes,
                            "policy": self.policy.name,
                            "tenant": v.tenant,
                            "requestor": tenant or "",
                        }
                    )
        return freed

    # --------------------------------------------------------- promotion
    def cache_pd(self, site: str) -> Optional[PilotData]:
        """The mem-tier cache PD for ``site`` (created lazily; racing
        creators serialize so exactly one PD is ever registered)."""
        if self.cache_bytes <= 0:
            return None
        with self._lock:
            pd = self.cache_pds.get(site)
        if pd is not None:
            return pd
        with self._cache_create_lock:
            with self._lock:
                pd = self.cache_pds.get(site)
            if pd is not None:
                return pd  # lost the race: the winner already registered
            desc = PilotDataDescription(
                service_url=f"mem://{site}/tier-cache",
                affinity=site,
                size_quota=self.cache_bytes,
                name=f"tier-cache-{site}",
                tier=TIER_DRAM,
            )
            pd = PilotData(desc, self.ctx)
            self.ctx.register(pd)
            if self.cds is not None:
                self.cds.add_pilot_data(pd)
            with self._lock:
                self.cache_pds[site] = pd
            return pd

    def _promote_one(self, du_id: str, site: str) -> bool:
        """Copy a hot DU into the site's mem-tier cache PD (off the
        consumer's critical path).  Quota pressure in the cache is handled
        by the same eviction machinery — promotion is what *creates* the
        pressure that demotes colder entries."""
        du = self.ctx.objects.get(du_id)
        if not isinstance(du, DataUnit) or not du.sealed:
            return False
        if du.size <= 0 or du.size > self.cache_bytes:
            return False
        cache = self.cache_pd(site)
        if cache is None or not cache.missing_chunks(du):
            return False
        ts = self.ctx.transfer_service
        if ts is None:
            return False
        try:
            ts.heal_replica(du, cache)
        except Exception:
            return False  # quota/invariants blocked: stay at the cold tier
        if cache.has_du(du_id):
            self.promotions_total += 1
            self.promotions.append((du_id, cache.id))
            return True
        return False

    def drain_promotions(self, max_n: int = 100) -> int:
        """Synchronously process queued promotions (deterministic mode for
        benchmarks/tests); returns the number of DUs promoted.  Barriers on
        the store dispatcher first so access records already published have
        fed the promotion queue."""
        self.ctx.store.flush_events()
        done = 0
        for _ in range(max_n):
            try:
                item = self._promote_q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                break
            du_id, site = item
            if self._promote_one(du_id, site):
                done += 1
            with self._lock:
                self._queued.discard(item)
        return done

    def _promote_loop(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._promote_q.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is None:
                break
            du_id, site = item
            try:
                self._promote_one(du_id, site)
            except Exception:
                pass  # a broken promotion must not kill the worker
            finally:
                with self._lock:
                    self._queued.discard(item)

    # ------------------------------------------------------------ control
    def stop(self) -> None:
        self._stop.set()
        self.ctx.store.unsubscribe(self._token)
        self._promote_q.put(None)
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self.ctx.tier_manager is self:
            self.ctx.tier_manager = None
