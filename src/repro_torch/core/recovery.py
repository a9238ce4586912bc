"""Self-healing replicated data layer: pilot-death recovery pipeline.

The paper's §4.2 fault-tolerance story ("all framework state lives in the
coordination store, so components can crash, reconnect and resume") covers
*compute* recovery — orphaned CUs are re-queued.  This module adds the
*data* half, the capability "A Comprehensive Perspective on Pilot-Job
Systems" (arXiv:1508.04180) calls the distinguishing production feature of
pilot systems — automated recovery — built on PR 2's chunk-granular
replicas and PR 3's producer/lineage metadata:

  * :class:`FaultManager` — the event-driven pipeline a pilot failure
    flows through: purge the dead sandbox's entries from every DU's
    ``locations``/``du:<id>:chunks`` holdings (bumping location versions
    so transfer resolve/estimate caches, in-flight claim dedup and
    placement locality all stop seeing the dead replica), then triage
    every affected DU — heal, re-ingest, or recompute — prioritizing DUs
    that lost their last full replica, then re-queue the pilot's orphaned
    CUs (consumers of still-recovering DUs re-park on the dependency gate
    instead of exploding in staging);
  * :class:`ReplicaManager` — enforces each DU's declared
    ``replication_factor``: it subscribes to the store's keyspace
    notifications and chunk-stripes a new replica (via the transfer
    service's multi-source ``heal_replica``) whenever a sealed DU's live
    full-replica count drops below its factor — failure-domain-aware
    (targets in sites that do not already hold a replica are preferred,
    so one site's churn cannot take out every copy);
  * **lineage recomputation** — when every replica of a sealed DU is gone
    and its local staging buffer was dropped, the DU is re-opened
    (``Recovering`` state, surfaced through DU futures), its recorded
    ``producer`` CU is reset and re-queued — transitively up the DAG when
    the producer's own inputs were lost too — and the re-run's re-seal
    releases the parked consumers.  Producers are assumed deterministic
    (the re-run rewrites the same logical content).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Set

from .agent import GLOBAL_QUEUE
from .compute_unit import CUState, ComputeUnit
from .coordination import StoreEvent, StoreEventPump
from .data_unit import DataUnit, DataUnitDescription, DUState
from .faults import fail_cu_terminal, requeue_orphans
from .pilot import PilotData, PilotState, RuntimeContext
from .replication import select_heal_targets

#: lineage re-runs per producer CU before the DU is declared lost (guards
#: against a producer whose re-runs keep landing on dying pilots)
MAX_RECOVERIES = 3


def recovering_dus(store) -> List[str]:
    """DU ids currently in ``Recovering`` (rebuilding after total replica
    loss) — the one store scan both FaultManager and Session surface."""
    return [
        key.split(":", 1)[1]
        for key in store.hkeys("du:")
        if key.count(":") == 1
        and store.hget(key, "state") == DUState.RECOVERING
    ]


class ReplicaManager:
    """Keeps every sealed DU at its declared ``replication_factor``.

    Subscribes to ``du:`` keyspace notifications (location/holding
    changes, delivered in store ``seq`` order via the out-of-lock
    dispatcher) and, on the pump thread, re-replicates any sealed DU whose
    live full-replica count fell below its factor — chunk-striped from all
    remaining holders (partial replicas included) via
    ``TransferService.heal_replica``.  Target selection is failure-domain
    aware: sites not already holding a replica win (see
    :func:`repro.core.replication.select_heal_targets`).
    """

    def __init__(self, ctx: RuntimeContext, cds=None):
        self.ctx = ctx
        self.cds = cds
        #: (du_id, target_pd_id) pairs healed, in order
        self.heals: List[tuple] = []
        #: serializes concurrent heal decisions (pump thread vs the
        #: FaultManager's explicit priority pass) so a race cannot create
        #: replicas beyond the factor; guards _healing only — the
        #: transfers themselves run outside it (PD-L002)
        self._ensure_lock = threading.Lock()
        #: du_id -> Event set when that DU's in-flight heal pass finishes
        self._healing: Dict[str, threading.Event] = {}
        self._pump = StoreEventPump(
            ctx.store,
            handler=self._process,
            prefix="du:",
            accept=lambda ev: ev.op == "hset"
            and (
                ev.field in ("locations", "sealed")
                or ev.key.endswith(":chunks")
            ),
            name="replica-manager",
        )

    def _process(self, ev: StoreEvent) -> None:
        du_id = ev.key.split(":", 2)[1]
        store = self.ctx.store
        # Only settled DUs are event-healed: a DU mid-first-ingest or
        # mid-striped-dispersal is still being written by its own transfer
        # plan, and healing it here would race that plan.  (Recovery paths
        # that legitimately operate on unsettled DUs call ensure/recover_du
        # directly.)
        if not store.hget(f"du:{du_id}", "sealed", False):
            return
        if store.hget(f"du:{du_id}", "state") != DUState.READY:
            return
        du = self.ctx.objects.get(du_id)
        if isinstance(du, DataUnit):
            self.ensure(du)

    # ------------------------------------------------------------- healing
    def _candidate_pds(self, du: DataUnit, holders: Set[str]) -> List[PilotData]:
        """Live PDs that could host a new replica: explicitly-created PDs
        plus active pilots' sandboxes, minus current holders and the dead."""
        store = self.ctx.store
        out: List[PilotData] = []
        pds: List[PilotData] = []
        if self.cds is not None:
            pds.extend(self.cds.pilot_data())
            pds.extend(
                p.sandbox
                for p in self.cds.pilots()
                if p.state == PilotState.ACTIVE
            )
        else:
            pds.extend(
                o for o in self.ctx.objects.values()
                if isinstance(o, PilotData)
            )
        seen: Set[str] = set()
        for pd in pds:
            if pd.id in holders or pd.id in seen:
                continue
            seen.add(pd.id)
            if store.hget(f"pd:{pd.id}", "state") in (
                PilotState.FAILED, PilotState.CANCELED,
            ):
                continue
            if pd.free_bytes < du.size:
                continue
            out.append(pd)
        return out

    def ensure(self, du: DataUnit) -> int:
        """Bring ``du`` back to its replication factor; returns the number
        of replicas created.  A DU whose chunks are no longer fully covered
        by holders *or* the local buffer cannot be healed here (lineage
        recomputation owns that case)."""
        # Per-DU gate instead of one big critical section: heal transfers
        # block for seconds, and holding _ensure_lock across them would
        # stall every other DU's heal decision (and trips PD-L002).  The
        # race _ensure_lock exists to prevent — two passes both seeing the
        # DU under-replicated and both healing it — is closed by parking
        # the second pass on the first one's completion event, after which
        # it re-reads the (now updated) locations.
        while True:
            with self._ensure_lock:
                gate = self._healing.get(du.id)
                if gate is None:
                    gate = threading.Event()
                    self._healing[du.id] = gate
                    break
            gate.wait(timeout=60.0)
        try:
            locs = set(du.locations)
            need = du.replication_factor - len(locs)
            if need <= 0:
                return 0
            if not du.has_full_coverage() and not du.iter_files():
                return 0  # data loss: FaultManager recovers by lineage
            targets = select_heal_targets(
                self.ctx, du, self._candidate_pds(du, locs), need,
                held=[
                    self.ctx.objects[pd_id].affinity
                    for pd_id in locs
                    if pd_id in self.ctx.objects
                ],
            )
            made = 0
            for target in targets:
                try:
                    self.ctx.transfer_service.heal_replica(du, target)
                except Exception:
                    continue  # quota/transfer error: try the next candidate
                self.heals.append((du.id, target.id))
                made += 1
            return made
        finally:
            with self._ensure_lock:
                self._healing.pop(du.id, None)
            gate.set()

    def stop(self) -> None:
        self._pump.stop()


class FaultManager:
    """Turns pilot death into an event-driven recovery pipeline.

    Wire :meth:`on_pilot_suspect`/:meth:`on_pilot_failed` into a
    :class:`~repro.core.faults.HeartbeatMonitor`; failures are processed on
    a dedicated worker thread (detection must not stall behind recovery
    transfers):

      1. mark the dead pilot's sandbox PD failed and **purge** it from
         every affected DU's ``locations`` and chunk holdings (location
         versions bump, so the transfer service's resolve/estimate caches
         and the placement engine's locality scores all invalidate; its
         in-flight staging claims are released so racing stagers re-plan);
      2. triage affected DUs worst-first (fewest remaining full replicas):
         re-enforce the replication factor via :class:`ReplicaManager`,
         re-ingest from an intact local buffer, or — when every chunk copy
         is gone — **recompute by lineage** (reset + re-queue the recorded
         producer CU, transitively);
      3. re-queue the pilot's orphaned CUs; consumers whose inputs are
         still ``Recovering`` re-park on the dependency gate.
    """

    def __init__(self, ctx: RuntimeContext, cds=None):
        self.ctx = ctx
        self.cds = cds
        self.replicas = ReplicaManager(ctx, cds=cds)
        #: per-failure audit records {"pilot", "pd", "actions", "requeued"}
        self.log: List[Dict] = []
        #: producer CU ids re-queued for lineage recomputation, in order
        self.recomputed: List[str] = []
        self.suspected: List[str] = []
        self._lock = threading.Lock()
        self._resubmitting: Set[str] = set()
        self._queue: "queue.Queue[Optional[str]]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, name="fault-manager", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------- monitor hooks
    def on_pilot_suspect(self, pilot_id: str) -> None:
        self.suspected.append(pilot_id)

    def on_pilot_failed(self, pilot_id: str) -> None:
        self._queue.put(pilot_id)

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                pilot_id = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            if pilot_id is None:
                break
            try:
                self._handle_failure(pilot_id)
            except Exception:
                pass  # a broken recovery must not kill the pipeline

    # ---------------------------------------------------- failure pipeline
    def _handle_failure(self, pilot_id: str) -> None:
        store = self.ctx.store
        pd_id = store.hget(f"pilot:{pilot_id}", "sandbox_pd")
        affected: List[str] = []
        if pd_id:
            store.hset(f"pd:{pd_id}", "state", PilotState.FAILED)
            affected = list(store.hget(f"pd:{pd_id}", "dus", []))
            if self.ctx.transfer_service is not None:
                self.ctx.transfer_service.purge_pd(pd_id)
            for du_id in affected:
                self._purge_holding(du_id, pd_id)
        # worst-first: a DU that just lost its LAST full replica recovers
        # before one that merely dropped below factor
        order = sorted(
            affected,
            key=lambda d: (len(store.hget(f"du:{d}", "locations", [])), d),
        )
        actions = {du_id: self.recover_du(du_id) for du_id in order}
        requeued = requeue_orphans(
            self.ctx, pilot_id,
            deps=self.cds.deps if self.cds is not None else None,
        )
        self.log.append(
            {
                "pilot": pilot_id,
                "pd": pd_id,
                "actions": actions,
                "requeued": requeued,
            }
        )

    def _purge_holding(self, du_id: str, pd_id: str) -> None:
        """Remove one PD from a DU's replica bookkeeping (live handle when
        available — that bumps the location version the transfer caches and
        placement key on — store-side otherwise)."""
        du = self.ctx.objects.get(du_id)
        if isinstance(du, DataUnit):
            du._remove_location(pd_id)
            return
        store = self.ctx.store
        locs = [
            loc for loc in store.hget(f"du:{du_id}", "locations", [])
            if loc != pd_id
        ]
        store.hset(f"du:{du_id}", "locations", locs)
        store.hdel(f"du:{du_id}:chunks", pd_id)

    # ------------------------------------------------------- DU recovery
    def recover_du(self, du_id: str, depth: int = 0) -> str:
        """Triage one DU after replica loss.  Returns the action taken:
        ``"healed"`` (re-replicated from surviving holders/buffer),
        ``"lineage"`` (producer re-queued for recomputation), ``"lost"``
        (unrecoverable → FAILED, cascading to consumers), or ``"ok"``/
        ``"skipped"`` when nothing was needed/possible."""
        store = self.ctx.store
        rec = store.hgetall(f"du:{du_id}")
        if not rec or rec.get("state") in (DUState.FAILED, DUState.DELETED):
            return "skipped"
        du = self.ctx.objects.get(du_id)
        if not isinstance(du, DataUnit):
            # Store-only DU (a reconnected manager, §4.2): re-attach a
            # live handle — it adopts the persisted manifest/chunks/seal —
            # so healing and lineage recovery work without the original
            # process.  Registered so later transfers resolve it too.
            du = DataUnit(DataUnitDescription(), store, du_id=du_id)
            self.ctx.register(du)
        if du.has_full_coverage() or du.iter_files():
            # content survives (replicas/partials/buffer): enforce factor
            if rec.get("sealed"):
                self.replicas.ensure(du)
                if len(du.locations) < du.replication_factor:
                    # no candidate could host the replica (quota, no live
                    # PDs): surfaced in the audit log; any future holding
                    # event re-triggers the ReplicaManager
                    return "below-factor"
                return "healed"
            return "ok"
        if not rec.get("sealed") and not rec.get("producer"):
            return "ok"  # unsealed source DU: local buffer is authoritative
        producer = rec.get("producer")
        if producer:
            if store.hget(f"cu:{producer}", "state") != CUState.DONE:
                # the producer run is still queued/in flight (or being
                # re-queued by orphan recovery): it will write the outputs
                # itself — resetting it here would race that run
                return "pending-producer"
            recoveries = int(store.hget(f"cu:{producer}", "recoveries", 0))
            if recoveries >= MAX_RECOVERIES:
                self._fail_du(
                    du_id,
                    f"all replicas lost; producer cu://{producer} already "
                    f"recomputed {recoveries}x",
                )
                return "lost"
            du.begin_recovery()
            if self._resubmit_producer(producer, depth=depth):
                self.recomputed.append(producer)
                return "lineage"
            return "lost"
        self._fail_du(du_id, "all replicas lost and no producer recorded")
        return "lost"

    def _fail_du(self, du_id: str, reason: str) -> None:
        store = self.ctx.store
        store.hset(f"du:{du_id}", "error", reason)
        store.hset(f"du:{du_id}", "state", DUState.FAILED)

    # -------------------------------------------------- lineage recompute
    def _resubmit_producer(self, cu_id: str, depth: int = 0) -> bool:
        """Reset a DONE producer CU and re-queue it so its outputs are
        rewritten.  Recurses up the DAG when the producer's own inputs were
        lost too.  Returns False when the re-run is impossible (the CU and
        its outputs are then failed terminally)."""
        if depth > 8:
            fail_cu_terminal(
                self.ctx, cu_id, "lineage recovery recursion limit reached",
                respect_winner=False,
            )
            return False
        with self._lock:
            if cu_id in self._resubmitting:
                return True  # already being handled in this walk
            self._resubmitting.add(cu_id)
        try:
            store = self.ctx.store
            cu = self.ctx.objects.get(cu_id)
            if not isinstance(cu, ComputeUnit):
                # reconnected manager: re-attach the producer from its
                # persisted description, like recover_du does for DUs —
                # the lineage lives in the store, not in this process
                desc_json = store.hget(f"cu:{cu_id}", "desc")
                if not desc_json:
                    fail_cu_terminal(
                        self.ctx, cu_id,
                        "producer description lost; cannot recompute lineage",
                        respect_winner=False,
                    )
                    return False
                from .compute_unit import ComputeUnitDescription

                cu = ComputeUnit(
                    ComputeUnitDescription(**desc_json), store, cu_id=cu_id
                )
                self.ctx.register(cu)
            # un-seal every output for rewrite (the re-run regenerates all
            # of them; deterministic-producer assumption).  Siblings whose
            # replicas survive only need the seal lifted — wiping their
            # holdings would make healthy data unreadable mid-recovery.
            for out_id in cu.description.output_data:
                odu = self.ctx.objects.get(out_id)
                if not isinstance(odu, DataUnit):
                    continue
                if odu.has_full_coverage():
                    store.hset(f"du:{out_id}", "sealed", False)
                else:
                    odu.begin_recovery()
            # ensure inputs, walking the DAG upward for lost ones
            unmet: Set[str] = set()
            for in_id in cu.description.input_data:
                in_du = self.ctx.objects.get(in_id)
                if isinstance(in_du, DataUnit) and not (
                    in_du.has_full_coverage() or in_du.iter_files()
                ):
                    self.recover_du(in_id, depth=depth + 1)
                state = store.hget(f"du:{in_id}", "state")
                if state == DUState.FAILED:
                    fail_cu_terminal(
                        self.ctx, cu_id,
                        f"lineage input du://{in_id} is unrecoverable",
                        respect_winner=False,
                    )
                    return False
                if state == DUState.RECOVERING:
                    unmet.add(in_id)
            # reset execution bookkeeping for the re-run (exactly-once CAS
            # starts fresh; recovery re-runs don't burn the retry budget)
            store.hset(f"cu:{cu_id}", "winner", None)
            store.hset(f"cu:{cu_id}", "pilot", None)
            store.hset(
                f"cu:{cu_id}", "recoveries",
                int(store.hget(f"cu:{cu_id}", "recoveries", 0)) + 1,
            )
            if unmet and self.cds is not None:
                store.hset(f"cu:{cu_id}", "state", CUState.WAITING)
                self.cds.deps.add(cu, unmet)
            else:
                store.hset(f"cu:{cu_id}", "state", CUState.PENDING)
                # straight to the global queue: the original placement may
                # have pinned a pilot that is exactly the one that died
                store.push(GLOBAL_QUEUE, {"cu": cu_id, "dup": False})
            return True
        finally:
            with self._lock:
                self._resubmitting.discard(cu_id)

    # ------------------------------------------------------------- control
    def recovering_dus(self) -> List[str]:
        """DU ids currently in ``Recovering`` (rebuilding via lineage)."""
        return recovering_dus(self.ctx.store)

    def stop(self) -> None:
        self._stop.set()
        self._queue.put(None)
        self._thread.join(timeout=2.0)
        self.replicas.stop()
