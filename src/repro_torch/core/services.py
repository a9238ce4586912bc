"""The Pilot-API (§4.3): PilotComputeService, PilotDataService, and the
Compute-Data Service (the affinity-based workload manager of §5).

Multi-level scheduling, exactly as the paper separates it:
  * resource allocation — services that start Pilot-Computes / Pilot-Data
    ("the start of the Pilot") — and
  * workload management — the Compute-Data Service that late-binds CUs and
    DUs onto those pilots using the affinity model and the §6.1 calculus.

The CDS scheduler implements the paper's placement loop verbatim (§5):

  1. find the pilot that best fulfills the CU's requested affinity and the
     location of its input data;
  2. if a pilot with the same affinity exists and has an empty slot, place
     the CU in that pilot's queue;
  3. if delayed scheduling is active, wait n sec and re-check for a free
     slot;
  4. otherwise place the CU in the global queue, pulled by the first pilot
     with an available slot.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

from .agent import GLOBAL_QUEUE
from .compute_unit import ComputeUnit, ComputeUnitDescription, CUState
from .coordination import StoreEvent, StoreEventPump
from .placement import PlacementEngine, PlacementStrategy, make_strategy
from .data_unit import DataUnit, DataUnitDescription, DUState
from .pilot import (
    PilotCompute,
    PilotComputeDescription,
    PilotData,
    PilotDataDescription,
    PilotState,
    RuntimeContext,
)
from .tenancy import DEFAULT_TENANT, TenantRegistry
from .transfer import TransferService


class PilotComputeService:
    """Factory for Pilot-Computes (paper §4.3.1)."""

    def __init__(self, ctx: RuntimeContext):
        self.ctx = ctx
        if ctx.transfer_service is None:
            TransferService(ctx)
        self._pilots: List[PilotCompute] = []

    def create_pilot(self, desc: PilotComputeDescription) -> PilotCompute:
        pilot = PilotCompute(desc, self.ctx)
        self.ctx.register(pilot)
        self.ctx.register(pilot.sandbox)
        pilot.start()
        self._pilots.append(pilot)
        return pilot

    def list_pilots(self) -> List[PilotCompute]:
        return list(self._pilots)

    def cancel(self) -> None:
        for p in self._pilots:
            p.cancel()


class PilotDataService:
    """Factory for Pilot-Data (paper §4.3.1)."""

    def __init__(self, ctx: RuntimeContext):
        self.ctx = ctx
        if ctx.transfer_service is None:
            TransferService(ctx)
        self._pds: List[PilotData] = []

    def create_pilot_data(self, desc: PilotDataDescription) -> PilotData:
        pd = PilotData(desc, self.ctx)
        self.ctx.register(pd)
        self._pds.append(pd)
        return pd

    def list_pilot_data(self) -> List[PilotData]:
        return list(self._pds)


class DependencyTracker:
    """DU-readiness gating for dataflow CUs (Pilot-API v2, paper Fig. 5).

    A CU whose input DUs are not all sealed/first-replicated is parked in
    ``Waiting`` instead of being released to placement; this tracker
    subscribes to the coordination store's keyspace notifications (the same
    StoreEvent machinery the async scheduler rides — no polling; events
    arrive via the store's out-of-lock dispatcher in ``seq`` order, so the
    readiness decisions below see seal/publish transitions in store order)
    and, when an awaited DU seals or turns READY, releases every CU whose
    dependency set just emptied by pushing it onto ``cds:incoming``.  Both execution
    modes drain that queue (the sync loop and the AsyncScheduler reactor),
    so release ordering — recorded in :attr:`release_log` — is identical
    across modes.

    A DU that turns FAILED (its producer CU exhausted retries, or was
    canceled) fails its waiters with a clear upstream error, and the
    waiters' own output DUs are failed in turn — the cascade walks the DAG
    transitively through the same event stream.
    """

    def __init__(self, cds: "ComputeDataService"):
        self.cds = cds
        self.ctx = cds.ctx
        self._lock = threading.Lock()
        #: cu_id -> input du_ids still unmet
        self._unmet: Dict[str, Set[str]] = {}
        #: du_id -> cu_ids waiting on it
        self._waiters: Dict[str, Set[str]] = {}
        #: cu ids in the order they were released to placement (the
        #: sync ≡ async ordering witness)
        self.release_log: List[str] = []
        self._pump = StoreEventPump(
            self.ctx.store,
            handler=self._process,
            prefix="du:",
            # "du:<id>" state/seal/publish transitions, not "du:<id>:chunks"
            accept=lambda ev: (
                ev.op == "hset"
                and ev.field in ("state", "sealed", "published")
                and ev.key.count(":") == 1
            ),
            name="du-readiness-gate",
        )

    def _process(self, ev: StoreEvent) -> None:
        du_id = ev.key.split(":", 1)[1]
        if ev.field == "sealed" and ev.value:
            self._du_ready(du_id)
        elif ev.field == "published":
            self._du_progress(du_id, int(ev.value or 0))
        elif ev.field == "state":
            if ev.value == DUState.READY:
                self._du_ready(du_id)
            elif ev.value == DUState.FAILED:
                self._du_failed(du_id)

    # ------------------------------------------------------------ transitions
    def _du_progress(self, du_id: str, published: int) -> None:
        """Streaming readiness mode (``first_k_chunks``): a chunk-prefix
        publish event satisfies waiters once the published count crosses
        the DU's ``ready_chunks`` threshold — consumers start on the
        prefix while the producer is still writing.  Release order still
        lands on ``cds:incoming`` like every other release, so the
        sync ≡ async ordering proof in :attr:`release_log` covers prefix
        releases too."""
        h = self.ctx.store.hgetall(f"du:{du_id}")
        if not h.get("streaming"):
            return
        threshold = int(h.get("ready_chunks") or 1)
        if published >= threshold:
            self._du_ready(du_id)

    def _du_ready(self, du_id: str) -> None:
        with self._lock:
            released = []
            for cu_id in self._waiters.pop(du_id, ()):  # noqa: B020
                unmet = self._unmet.get(cu_id)
                if unmet is None:
                    continue
                unmet.discard(du_id)
                if not unmet:
                    del self._unmet[cu_id]
                    released.append(cu_id)
        for cu_id in released:
            self._release(cu_id)

    def _release(self, cu_id: str) -> None:
        try:
            cu: ComputeUnit = self.ctx.lookup(cu_id)
        except KeyError:
            return
        # Canceled-while-waiting CUs lose the CAS and are dropped here.
        if cu._cas_state(CUState.WAITING, CUState.PENDING):
            with self._lock:
                self.release_log.append(cu_id)
            # release lands on cds:incoming via the tenant admission gate
            # (pass-through for the default tenant, so the release_log
            # ordering witness is unchanged in single-tenant runs)
            self.cds.admission.submit(cu)

    def _du_failed(self, du_id: str) -> None:
        with self._lock:
            waiters = sorted(self._waiters.pop(du_id, ()))
            for cu_id in waiters:
                self._unmet.pop(cu_id, None)
        store = self.ctx.store
        reason = store.hget(f"du:{du_id}", "error") or "producer failed"
        for cu_id in waiters:
            try:
                cu: ComputeUnit = self.ctx.lookup(cu_id)
            except KeyError:
                continue
            if cu._cas_state(CUState.WAITING, CUState.FAILED):
                msg = f"input du://{du_id} failed: {reason}"
                cu.error = msg
                store.hset(f"cu:{cu.id}", "error", msg)
                # transitive cascade: this CU will never produce its outputs
                cu._fail_outputs(f"producer {cu.url} failed: {msg}")
                if self.ctx.tier_manager is not None:
                    self.ctx.tier_manager.pins.unpin_owner(cu.id)

    # -------------------------------------------------------------- interface
    def add(self, cu: ComputeUnit, unmet: Set[str]) -> None:
        """Park ``cu`` until every DU in ``unmet`` is ready.

        Registration races against the DUs settling concurrently — a
        synthetic re-check event per DU closes the window on the tracker
        thread (where all release decisions are serialized).
        """
        tm = self.ctx.tier_manager
        if tm is not None:
            # a Waiting consumer's inputs (the already-ready ones
            # included) are pinned against quota eviction until the CU
            # settles — re-parks during lineage recovery re-pin too
            tm.pins.pin_inputs(cu)
        with self._lock:
            self._unmet[cu.id] = set(unmet)
            for du_id in unmet:
                self._waiters.setdefault(du_id, set()).add(cu.id)
        store = self.ctx.store
        for du_id in unmet:
            h = store.hgetall(f"du:{du_id}")
            state = h.get("state")
            published = int(h.get("published") or 0)
            if h.get("sealed"):
                field, value = "sealed", True
            elif state in (DUState.READY, DUState.FAILED):
                field, value = "state", state
            elif h.get("streaming") and published >= int(h.get("ready_chunks") or 1):
                # the producer already streamed past the threshold before
                # this consumer registered — close that race too
                field, value = "published", published
            else:
                continue
            self._pump.inject(
                StoreEvent(
                    seq=-1,
                    op="hset",
                    key=f"du:{du_id}",
                    field=field,
                    value=value,
                )
            )

    def waiting(self) -> List[str]:
        with self._lock:
            return sorted(self._unmet)

    def stop(self) -> None:
        self._pump.stop()


class AdmissionController:
    """Per-tenant QoS gate between CU release and placement.

    Every path that used to push a Pending CU straight onto
    ``cds:incoming`` — submission with met dependencies, a
    DependencyTracker release, the agent's sandbox-backpressure requeue —
    now routes through :meth:`submit`/:meth:`requeue`.  A tenant over its
    :class:`~repro.core.tenancy.ResourceQuota` (CU slots, resident
    sandbox bytes) has its CUs *parked*: state stays ``Pending``, no
    retry attempt or quota-wait is burned, and the CU re-enters placement
    — weighted-fair-share ordered across starved tenants — as the
    tenant's earlier CUs turn terminal (observed via the same
    StoreEventPump machinery the DependencyTracker rides).

    With only the bare default tenant (unlimited quota) the controller is
    a deterministic synchronous pass-through, so single-tenant callers
    observe the exact pre-QoS release order (the sync ≡ async decision
    witnesses stay valid).

    The controller also implements *queued-only preemption*: when a CU of
    a strictly higher-priority tenant would otherwise fall to the global
    queue, one queued (never running) CU of the lowest-priority tenant is
    atomically removed from its pilot queue (``qremove`` doubles as the
    did-any-agent-claim-it CAS) and parked at the front of its tenant's
    line; the high-priority CU takes the vacated queue position.
    """

    def __init__(self, cds: "ComputeDataService"):
        self.cds = cds
        self.ctx = cds.ctx
        if self.ctx.tenant_registry is None:
            self.ctx.tenant_registry = TenantRegistry(self.ctx)
        self.registry: TenantRegistry = self.ctx.tenant_registry
        self.ctx.admission = self
        self._lock = threading.Lock()
        #: tenant -> parked CU ids, oldest first (FIFO within a tenant)
        self._parked: Dict[str, Deque[str]] = {}
        #: CU ids admitted in order (observability / fairness tests)
        self.admission_log: List[str] = []
        self.parked_total = 0
        #: audit of queued-CU preemptions: {"cu", "tenant", "by",
        #: "by_tenant", "pilot"}
        self.preemptions: List[Dict] = []
        # capacity returns on terminal CU transitions: drain parked work
        # on the pump thread (same subscribe → queue → thread shape as the
        # DependencyTracker, so no store mutation runs on the dispatcher)
        self._pump = StoreEventPump(
            self.ctx.store,
            handler=self._on_cu_event,
            prefix="cu:",
            accept=lambda ev: (
                ev.op == "hset"
                and ev.field == "state"
                and ev.value in CUState.TERMINAL
            ),
            name="admission-gate",
        )

    # ------------------------------------------------------------ admission
    def _estimate(self, cu: ComputeUnit) -> float:
        d = cu.description
        return max(d.sim_compute_s, d.est_compute_s, self.cds.avg_cu_estimate_s)

    def _tenant_of(self, cu: ComputeUnit) -> str:
        return getattr(cu.description, "tenant", None) or DEFAULT_TENANT

    def _over_quota(self, tenant: str, resident: Optional[int]) -> bool:
        """Quota check for admitting ONE more CU of ``tenant``.  Callers
        compute ``resident`` outside the controller lock (it scans PDs and
        reads the store) and only when a byte quota is actually set."""
        quota = self.registry.get(tenant).quota
        if (
            quota.cu_slots is not None
            and self.registry.inflight(tenant) >= quota.cu_slots
        ):
            return True
        if (
            quota.sandbox_bytes is not None
            and resident is not None
            and resident >= quota.sandbox_bytes
        ):
            return True
        return False

    def _resident(self, tenant: str) -> Optional[int]:
        quota = self.registry.get(tenant).quota
        if quota.sandbox_bytes is None:
            return None
        return self.registry.resident_bytes(tenant)

    def submit(self, cu: ComputeUnit) -> bool:
        """Admit ``cu`` to placement or park it; True iff admitted now.

        Admission pushes onto ``cds:incoming`` exactly as the pre-QoS
        release paths did; parking leaves the CU ``Pending`` off every
        queue with a store-side ``admission: parked`` marker."""
        tenant = self._tenant_of(cu)
        resident = self._resident(tenant)
        with self._lock:
            queue = self._parked.get(tenant)
            if (queue and len(queue) > 0) or self._over_quota(tenant, resident):
                # earlier parked CUs keep FIFO precedence within a tenant
                self._parked.setdefault(
                    tenant, collections.deque()
                ).append(cu.id)
                self.parked_total += 1
                parked = True
            else:
                self.registry.note_admitted(tenant, cu.id, self._estimate(cu))
                self.admission_log.append(cu.id)
                parked = False
        if parked:
            self.ctx.store.hset(f"cu:{cu.id}", "admission", "parked")
            return False
        self.ctx.store.hset(f"cu:{cu.id}", "admission", "admitted")
        self.ctx.store.push("cds:incoming", cu.id)
        return True

    def requeue(self, cu: ComputeUnit) -> bool:
        """Backpressure re-entry from the agent claim path: the CU hit
        sandbox quota pressure mid-staging and went back to ``Pending``.
        Re-check its tenant's quota — if the tenant itself is now over (it
        caused the pressure), park instead of hot-looping through the
        global queue; otherwise hand it straight back to the global queue
        exactly as the pre-QoS path did."""
        tenant = self._tenant_of(cu)
        resident = self._resident(tenant)
        with self._lock:
            self.registry.note_removed(tenant, cu.id)
            if self._over_quota(tenant, resident):
                # oldest work re-admits first: park at the FRONT
                self._parked.setdefault(
                    tenant, collections.deque()
                ).appendleft(cu.id)
                self.parked_total += 1
                parked = True
            else:
                self.registry.note_admitted(tenant, cu.id, 0.0)
                parked = False
        if parked:
            self.ctx.store.hset(f"cu:{cu.id}", "admission", "parked")
            return False
        self.ctx.store.push(GLOBAL_QUEUE, {"cu": cu.id, "dup": False})
        return True

    # ---------------------------------------------------------------- drain
    def _on_cu_event(self, ev: StoreEvent) -> None:
        cu_id = ev.key.split(":", 1)[1]
        tenant = (
            self.ctx.store.hget(f"cu:{cu_id}", "tenant") or DEFAULT_TENANT
        )
        self.registry.note_removed(tenant, cu_id)
        self.poke()

    def poke(self) -> int:
        """Drain parked CUs that now fit their tenants' quotas; returns
        how many were admitted.  Starved tenants go first: candidates are
        ordered by (priority desc, weighted service received asc) — the
        deficit ordering that makes fair-share weights meaningful across
        competing backlogs.  Safe to call from any thread."""
        admitted = 0
        while True:
            released = self._release_one()
            if released is None:
                return admitted
            cu_id, state_ok = released
            if state_ok:
                self.ctx.store.hset(f"cu:{cu_id}", "admission", "admitted")
                self.ctx.store.push("cds:incoming", cu_id)
            admitted += 1

    def _release_one(self) -> Optional[Tuple[str, bool]]:
        """Pop the most deserving parked CU whose tenant has room.  The
        quota reads that touch the store (resident bytes) run before the
        lock is taken; the pick itself is an in-memory decision."""
        with self._lock:
            tenants = [t for t, q in self._parked.items() if q]
        residents = {t: self._resident(t) for t in tenants}
        order = sorted(
            tenants,
            key=lambda t: (
                -self.registry.get(t).priority,
                self.registry.deficit_key(t),
                t,
            ),
        )
        with self._lock:
            for tenant in order:
                queue = self._parked.get(tenant)
                if not queue:
                    continue
                if self._over_quota(tenant, residents.get(tenant)):
                    continue
                cu_id = queue.popleft()
                try:
                    cu = self.ctx.lookup(cu_id)
                except KeyError:
                    return cu_id, False
                self.registry.note_admitted(
                    tenant, cu_id, self._estimate(cu)
                )
                self.admission_log.append(cu_id)
                return cu_id, True
        return None

    # ----------------------------------------------------------- preemption
    def preemption_enabled(self, cu: ComputeUnit) -> bool:
        """Preemption is attempted only when this CU's tenant outranks
        SOME registered tenant — default single-tenant workloads never
        pay the queue scan (and keep their decision order bit-exact)."""
        if not self.registry.multi_tenant:
            return False
        my = self.registry.get(self._tenant_of(cu)).priority
        return my > self.registry.min_priority()

    def preempt_queued_for(self, cu: ComputeUnit, pilots) -> Optional[object]:
        """Evict one *queued* lower-priority CU to make room for ``cu``.

        Scans pilot queues (never running slots, never the global queue —
        removing a global entry frees no pilot capacity) for CUs of
        strictly lower-priority tenants, preferring the lowest-priority,
        most-recently-queued victim.  ``qremove`` returning True is the
        proof no agent claimed the victim; the victim parks at the front
        of its tenant's line (state still ``Pending``, nothing burned)
        and the caller pushes ``cu`` to the vacated pilot queue.
        Returns that pilot, or None when nothing was preemptible."""
        store = self.ctx.store
        my_tenant = self._tenant_of(cu)
        my_pri = self.registry.get(my_tenant).priority
        victims: List[Tuple[int, int, object, Dict, str]] = []
        for pilot in pilots:
            if pilot.state not in PilotState.PLACEABLE:
                continue
            for pos, item in enumerate(store.qpeek(pilot.queue_name)):
                vid = item["cu"] if isinstance(item, dict) else item
                vt = store.hget(f"cu:{vid}", "tenant") or DEFAULT_TENANT
                if vt == my_tenant:
                    continue
                vp = self.registry.get(vt).priority
                if vp < my_pri:
                    victims.append((vp, -pos, pilot, item, vt))
        # lowest priority first; within a queue, the most recently queued
        # (it has waited least — minimal disruption)
        victims.sort(key=lambda v: (v[0], v[1]))
        for vp, _negpos, pilot, item, vt in victims:
            if not store.qremove(pilot.queue_name, item):
                continue  # an agent won the race: victim is running
            vid = item["cu"] if isinstance(item, dict) else item
            with self._lock:
                self.registry.note_removed(vt, vid)
                self._parked.setdefault(
                    vt, collections.deque()
                ).appendleft(vid)
                self.parked_total += 1
                self.preemptions.append(
                    {
                        "cu": vid,
                        "tenant": vt,
                        "by": cu.id,
                        "by_tenant": my_tenant,
                        "pilot": pilot.id,
                    }
                )
            store.hset(f"cu:{vid}", "admission", "preempted")
            return pilot
        return None

    # -------------------------------------------------------------- control
    def parked(self) -> Dict[str, List[str]]:
        with self._lock:
            return {t: list(q) for t, q in self._parked.items() if q}

    def stop(self) -> None:
        self._pump.stop()


class ComputeDataService:
    """Workload manager: late-binds CUs/DUs to pilots by affinity (§5)."""

    def __init__(
        self,
        ctx: RuntimeContext,
        delayed_scheduling_s: float = 0.0,
        avg_cu_estimate_s: float = 0.05,
        strategy: str = "cost",
        start_loop: bool = True,
    ):
        self.ctx = ctx
        if ctx.transfer_service is None:
            TransferService(ctx)
        self.delayed_scheduling_s = delayed_scheduling_s
        self.avg_cu_estimate_s = avg_cu_estimate_s
        self.engine = PlacementEngine(ctx, avg_cu_estimate_s=avg_cu_estimate_s)
        self.strategy: PlacementStrategy = (
            strategy if isinstance(strategy, PlacementStrategy)
            else make_strategy(strategy)
        )
        # tenant-aware strategies read the registry/store through the ctx
        self.strategy.bind(ctx)
        self._pilots: List[PilotCompute] = []
        self._pds: List[PilotData] = []
        self._cus: List[ComputeUnit] = []
        self._dus: List[DataUnit] = []
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._delayed: List[Dict] = []  # {"cu":…, "deadline":…, "pilot":…}
        self._decisions: List[Dict] = []  # audit log of placement choices
        #: invoked with (cu, pilot) just before a CU lands on a pilot queue
        #: — the async scheduler hangs its prefetch pipeline here so the
        #: staging claim exists before any agent can see the CU
        self.pre_push_hook: Optional[Callable] = None
        #: invoked with (cu, unmet) when a CU parks in ``Waiting`` — the
        #: async scheduler speculatively prefetches the CU's already-ready
        #: inputs (e.g. the next training chunk's shard DU) toward the
        #: predicted placement winner while the unmet producers still run
        self.waiting_prefetch_hook: Optional[Callable] = None
        #: DU-readiness gate (dataflow semantics) — shared by both
        #: execution modes, so sync and async release CUs identically
        self.deps = DependencyTracker(self)
        #: per-tenant QoS gate — every release path (submission, dep
        #: release, backpressure requeue) funnels through it; with only
        #: the default tenant it is a deterministic pass-through
        self.admission = AdmissionController(self)
        self._thread: Optional[threading.Thread] = None
        if start_loop:
            # Legacy sync mode: a polling loop owns placement.  In async
            # mode the AsyncScheduler drains the incoming queue instead
            # (event-driven), so no thread is started here.
            self._thread = threading.Thread(
                target=self._scheduler_loop, name="cds-scheduler", daemon=True
            )
            self._thread.start()

    # --------------------------------------------------------- registration
    def add_pilot_compute(self, pilot: PilotCompute) -> None:
        with self._lock:
            self._pilots.append(pilot)

    def add_pilot_data(self, pd: PilotData) -> None:
        with self._lock:
            self._pds.append(pd)

    def pilots(self) -> List[PilotCompute]:
        with self._lock:
            return list(self._pilots)

    def pilot_data(self) -> List[PilotData]:
        with self._lock:
            return list(self._pds)

    # ----------------------------------------------------------- submission
    def submit_data_unit(
        self, desc: DataUnitDescription, target: Optional[PilotData] = None
    ) -> DataUnit:
        """Create a DU and stage it into an affinity-appropriate PD.

        The DU's physical representation is its chunk manifest
        (``desc.chunk_size``); the first ingest registers the target PD as
        a full replica in ``locations`` and further holdings — including
        partial, chunk-level ones — accumulate in the store's
        ``du:<id>:chunks`` hash."""
        du = DataUnit(desc, self.ctx.store)
        self.ctx.register(du)
        with self._lock:
            self._dus.append(du)
        pd = target or self._choose_pd(desc)
        if pd is not None and du.size > 0:
            self.ctx.store.hset(f"du:{du.id}", "state", DUState.PENDING)
            self.ctx.transfer_service.ingest(du, pd)
        return du

    def create_data_unit(self, desc: DataUnitDescription) -> DataUnit:
        """Create a DU *without* staging it anywhere: a dataflow
        placeholder whose content a producer CU will materialize (the
        Session auto-creates output DUs through this).  The store-side
        ``placeholder`` marker is what gates consumers — an empty DU made
        via ``submit_data_unit`` is vacuously complete instead."""
        du = DataUnit(desc, self.ctx.store)
        self.ctx.store.hset(f"du:{du.id}", "placeholder", True)
        self.ctx.register(du)
        with self._lock:
            self._dus.append(du)
        return du

    def _unmet_inputs(self, cu: ComputeUnit) -> Set[str]:
        """Input DUs that must materialize before ``cu`` may be placed.

        A DU gates its consumers while it is unsealed AND is either some
        CU's declared output (``producer`` set) or an explicit dataflow
        placeholder (``create_data_unit``) awaiting a producer not yet
        submitted.  Source DUs made through ``submit_data_unit`` never
        gate — with or without content they are consumable immediately,
        which preserves the v1 submit-then-consume flow.
        """
        store = self.ctx.store
        unmet: Set[str] = set()
        for du_id in cu.description.input_data:
            h = store.hgetall(f"du:{du_id}")
            if not h:
                raise KeyError(f"{cu.url}: unknown input DU du://{du_id}")
            state = h.get("state")
            if state == DUState.FAILED:
                raise ValueError(
                    f"{cu.url}: input du://{du_id} already failed: "
                    f"{h.get('error') or 'producer failed'}"
                )
            if h.get("sealed") or state == DUState.READY:
                continue
            if h.get("streaming") and int(h.get("published") or 0) >= int(
                h.get("ready_chunks") or 1
            ):
                # streaming readiness: enough of a chunk prefix is already
                # published for this consumer to start
                continue
            if h.get("producer") or h.get("placeholder"):
                unmet.add(du_id)
        return unmet

    def _validate_data_refs(self, desc: ComputeUnitDescription) -> None:
        """Reject bad data references BEFORE any side effects: a CU must
        not be created/tracked (and no producer claims stamped) if its
        declared DUs don't exist or its outputs are already immutable —
        otherwise a zombie non-terminal CU poisons ``wait()`` forever."""
        store = self.ctx.store
        for du_id in desc.input_data:
            if not store.hgetall(f"du:{du_id}"):
                raise KeyError(f"unknown input DU du://{du_id}")
        for du_id in desc.output_data:
            h = store.hgetall(f"du:{du_id}")
            if not h:
                raise KeyError(f"unknown output DU du://{du_id}")
            if h.get("sealed"):
                raise ValueError(
                    f"output du://{du_id} is sealed (immutable); "
                    f"declare a fresh DU instead"
                )

    def _claim_outputs(self, cu: ComputeUnit) -> None:
        """Atomically claim each output DU for ``cu`` (CAS on the
        ``producer`` field); on a lost race every claim this CU did win is
        unwound and the CU is failed, so nothing is left half-stamped."""
        store = self.ctx.store
        claimed: List[str] = []
        for du_id in cu.description.output_data:
            if not store.hcas(f"du:{du_id}", "producer", None, cu.id):
                prior = store.hget(f"du:{du_id}", "producer")
                for oid in claimed:
                    store.hdel(f"du:{oid}", "producer")
                msg = (
                    f"{cu.url}: du://{du_id} already has producer "
                    f"cu://{prior}; DUs are single-writer"
                )
                cu.error = msg
                store.hset(f"cu:{cu.id}", "error", msg)
                cu._set_state(CUState.FAILED)
                raise ValueError(msg)
            claimed.append(du_id)

    def submit_compute_unit(self, desc: ComputeUnitDescription) -> ComputeUnit:
        self._validate_data_refs(desc)
        cu = ComputeUnit(desc, self.ctx.store)
        self.ctx.register(cu)
        cu.timings.submitted = time.monotonic()
        self._claim_outputs(cu)
        if self.ctx.tier_manager is not None:
            # pin declared inputs from submission until the CU settles:
            # Waiting/Pending/Running consumers' inputs are never eviction
            # victims (the registry drops pins of terminal CUs lazily)
            self.ctx.tier_manager.pins.pin_inputs(cu)
        with self._lock:
            self._cus.append(cu)
        try:
            unmet = self._unmet_inputs(cu)
        except ValueError as exc:
            # an input already failed: the CU fails at submit, terminally,
            # and the failure cascades through its own outputs
            msg = str(exc)
            cu.error = msg
            self.ctx.store.hset(f"cu:{cu.id}", "error", msg)
            cu._set_state(CUState.FAILED)
            cu._fail_outputs(f"producer {cu.url} failed: {msg}")
            return cu
        if unmet:
            # Dataflow gate: park until every input DU is sealed/replicated.
            cu._set_state(CUState.WAITING)
            self.deps.add(cu, unmet)
            if self.waiting_prefetch_hook is not None:
                try:
                    self.waiting_prefetch_hook(cu, unmet)
                except Exception:
                    pass  # speculative staging must never fail a submit
        else:
            cu._set_state(CUState.PENDING)
            # Asynchronous interface (§4.2): enqueue and return
            # immediately — through the tenant admission gate, which
            # parks over-quota tenants instead of failing them.
            self.admission.submit(cu)
        return cu

    def compute_units(self) -> List[ComputeUnit]:
        with self._lock:
            return list(self._cus)

    def data_units(self) -> List[DataUnit]:
        with self._lock:
            return list(self._dus)

    # ----------------------------------------------------------- scheduling
    def _choose_pd(self, desc: DataUnitDescription) -> Optional[PilotData]:
        """Affinity-aware PD selection for a new DU."""
        from .affinity import match_affinity

        with self._lock:
            pds = list(self._pds)
        need = max(desc.size_hint, sum(map(len, desc.files.values())))
        fits = [pd for pd in pds if pd.free_bytes >= need]
        candidates = [pd for pd in fits if match_affinity(desc.affinity, pd.affinity)]
        if not candidates:
            candidates = fits  # affinity miss: any PD with space
        if not candidates:
            return None  # nowhere fits — DU stays in its local buffer
        # Prefer the emptiest (simple balance; the cost model handles the
        # rest at CU-placement time).
        return max(candidates, key=lambda pd: pd.free_bytes)

    def choose_pilot_data(self, desc: DataUnitDescription) -> Optional[PilotData]:
        """Public affinity-aware PD selection (same ranking the DU submit
        path uses) — lets layers that stage DUs on their own threads (e.g.
        the checkpointer's async commit) pick a home without re-implementing
        the affinity/space policy."""
        return self._choose_pd(desc)

    def predict_pilot(self, cu: ComputeUnit) -> Optional[PilotCompute]:
        """Best placement candidate for ``cu`` *without* placing it: the
        same strategy ranking :meth:`place` uses, but nothing is queued and
        no decision is logged (so the sync ≡ async decision-parity witness
        is untouched).  The async scheduler uses this to aim speculative
        prefetch for CUs still parked ``Waiting``."""
        desc = cu.description
        if desc.pilot is not None:
            try:
                pilot: PilotCompute = self.ctx.lookup(desc.pilot)
            except KeyError:
                return None
            return pilot if pilot.state in PilotState.PLACEABLE else None
        with self._lock:
            pilots = list(self._pilots)
        ranked = self.strategy.rank(
            cu,
            self.engine.candidates(cu, pilots, tier_bw=self.strategy.uses_tier_bw),
        )
        return ranked[0].pilot if ranked else None

    def _has_free_slot(self, pilot: PilotCompute) -> bool:
        depth = self.ctx.store.qlen(pilot.queue_name)
        running = len(pilot.running_cus())
        return pilot.state == PilotState.ACTIVE and (running + depth < pilot.slots)

    def place(self, cu: ComputeUnit) -> Optional[PilotCompute]:
        """One pass of the §5 placement algorithm for one CU.

        Shared by both execution modes (the sync polling loop and the
        event-driven AsyncScheduler call exactly this), which is what keeps
        their placement decisions identical.  Returns the pilot whose queue
        received the CU, or None (global queue / delayed)."""
        desc = cu.description
        if desc.pilot is not None:
            # Application-level direct binding (§4.3.2 control level (i)).
            pilot: PilotCompute = self.ctx.lookup(desc.pilot)
            if pilot.state not in PilotState.PLACEABLE:
                # Pinned to a dead/suspect pilot (it may be the very pilot
                # whose failure re-queued this CU): fall back to the global
                # queue so any live pilot can pull it.
                self.ctx.store.push(GLOBAL_QUEUE, {"cu": cu.id, "dup": False})
                return None
            self._push_to_pilot(cu, pilot)
            return pilot
        with self._lock:
            pilots = list(self._pilots)
        ranked = self.strategy.rank(
            cu,
            self.engine.candidates(cu, pilots, tier_bw=self.strategy.uses_tier_bw),
        )
        if not ranked:
            self.ctx.store.push(GLOBAL_QUEUE, {"cu": cu.id, "dup": False})
            return None
        best = ranked[0]
        self._decisions.append(
            {
                "cu": cu.id,
                "pilot": best.pilot.id,
                "t_q": best.t_queue,
                "t_stage": best.t_stage,
                "strategy": best.strategy,
                "policy": self.strategy.name,
            }
        )
        # Step 2: same-affinity pilot with an empty slot → pilot queue.
        if self._has_free_slot(best.pilot):
            self._push_to_pilot(cu, best.pilot)
            return best.pilot
        # Steps 3/4 leave the CU off the winner's queue for now — but the
        # winner is still where it will most likely run, so the async
        # pipeline prefetches its inputs there speculatively (staging
        # overlaps the work the pilot is currently busy with; a sandbox
        # replica also helps any other pilot via cheapest-replica).
        if self.pre_push_hook is not None:
            try:
                self.pre_push_hook(cu, best.pilot)
            except Exception:
                pass
        # Step 3: delayed scheduling — wait n sec, recheck.
        if self.delayed_scheduling_s > 0:
            with self._lock:
                self._delayed.append(
                    {
                        "cu": cu,
                        "pilot": best.pilot,
                        "deadline": time.monotonic()
                        + self.delayed_scheduling_s,
                    }
                )
            return None
        # Step 4 QoS refinement: before falling to the global queue, a
        # higher-priority tenant may displace one *queued* (never
        # running) CU of a lower-priority tenant and take its slot in
        # line.  Default single-tenant workloads never enter this branch.
        if self.admission.preemption_enabled(cu):
            target = self.admission.preempt_queued_for(cu, pilots)
            if target is not None:
                self._push_to_pilot(cu, target)
                return target
        # Step 4: global queue — first pilot with a slot pulls it.
        self.ctx.store.push(GLOBAL_QUEUE, {"cu": cu.id, "dup": False})
        return None

    def _push_to_pilot(self, cu: ComputeUnit, pilot: PilotCompute) -> None:
        if self.pre_push_hook is not None:
            try:
                self.pre_push_hook(cu, pilot)
            except Exception:
                pass
        if self.ctx.data_mode == "push":
            # Push-mode data management (§4.2): the manager pre-stages the
            # input DUs into the pilot sandbox before the CU is queued.
            for du_id in cu.description.input_data:
                du: DataUnit = self.ctx.lookup(du_id)
                self.ctx.transfer_service.stage_in(du, pilot.sandbox, pilot.affinity)
        item = {"cu": cu.id, "dup": False}
        self.ctx.store.push(pilot.queue_name, item)
        # Close the check-then-push race against pilot death: fault
        # recovery drains a dead pilot's queue exactly once, so a push
        # landing AFTER that drain would strand the CU forever.  The
        # monitor sets FAILED before the drain runs; re-checking here
        # guarantees either the drain sees our item or we see FAILED.
        if pilot.state not in PilotState.PLACEABLE:
            if self.ctx.store.qremove(pilot.queue_name, item):
                self.ctx.store.push(GLOBAL_QUEUE, item)

    def recheck_delayed(self) -> List[tuple]:
        """Re-check delayed CUs (step 3); returns [(cu, pilot)] placed onto
        a pilot queue this pass (the async scheduler prefetches those)."""
        store = self.ctx.store
        now = time.monotonic()
        placed: List[tuple] = []
        with self._lock:
            entries, self._delayed = self._delayed, []
        still: List[Dict] = []
        for entry in entries:
            cu, pilot = entry["cu"], entry["pilot"]
            if cu.state != CUState.PENDING:
                continue
            if self._has_free_slot(pilot):
                self._push_to_pilot(cu, pilot)
                placed.append((cu, pilot))
            elif now >= entry["deadline"]:
                store.push(GLOBAL_QUEUE, {"cu": cu.id, "dup": False})
            else:
                still.append(entry)
        with self._lock:
            self._delayed.extend(still)
        return placed

    def _scheduler_loop(self) -> None:
        store = self.ctx.store
        while not self._stop.is_set():
            try:
                cu_id = store.pop("cds:incoming", timeout=0.02)
            except Exception:
                time.sleep(0.05)
                continue
            if cu_id is not None:
                try:
                    cu = self.ctx.lookup(cu_id)
                    if cu.state == CUState.PENDING:
                        self.place(cu)
                except Exception:
                    pass
            self.recheck_delayed()

    # ------------------------------------------------------------- control
    def decisions(self) -> List[Dict]:
        return list(self._decisions)

    def wait(self, timeout: float = 120.0) -> bool:
        """Block until every submitted CU is terminal.  True on success.

        Event-driven: a keyspace subscription on ``cu:`` state transitions
        wakes the waiter on the very mutation (new submissions also write a
        state field, so a workload growing mid-wait re-checks too); the
        coarse in-wait poll only guards against lost notifications.
        """
        woke = threading.Event()

        def _cb(ev: StoreEvent) -> None:
            if ev.field == "state":
                woke.set()

        token = self.ctx.store.subscribe(_cb, prefix="cu:")
        try:
            deadline = time.monotonic() + timeout
            while True:
                woke.clear()
                with self._lock:
                    cus = list(self._cus)
                if all(c.state in CUState.TERMINAL for c in cus):
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                woke.wait(min(remaining, 0.25))
        finally:
            self.ctx.store.unsubscribe(token)

    def cancel(self) -> None:
        self._stop.set()
        self.deps.stop()
        self.admission.stop()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
