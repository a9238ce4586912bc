"""Event-driven async scheduler with pipelined data staging.

The sync :class:`~repro.core.services.ComputeDataService` loop polls its
incoming queue; this module replaces the polling with a **reactor**: the
coordination store publishes keyspace notifications for every CU/DU/pilot
state transition (P*'s pilot lifecycle as an event-driven state machine,
arXiv:1207.6644), and a single scheduler thread consumes them in sequence
order.  Placement itself is the *same* code path as sync mode
(``ComputeDataService.place`` → shared :class:`PlacementEngine` + the
selected :class:`PlacementStrategy` plugin), so the two modes make
identical decisions; what the async mode adds is **transfer pipelining**:

  * the moment a CU is bound to a pilot, its input DUs' *missing chunks*
    (and only those — a partially-cached sandbox pays just the remainder)
    are bulk-staged into the pilot's sandbox on a staging thread-pool —
    staging of CU B overlaps execution of already-ready CU A instead of
    serializing in the agent's slot;
  * multi-DU chunk groups from one source Pilot-Data coalesce into a
    single costed bulk transfer (one setup latency + one registration),
    while groups from distinct sources stripe in parallel;
  * the transfer service's chunk-granular in-flight dedup makes the
    agent's own ``stage_in`` wait on (not repeat) a prefetch already
    moving those chunks;
  * dataflow DAGs pipeline across edges: a CU parked ``Waiting`` on
    unsealed input DUs is released by the CDS DependencyTracker the moment
    its last producer seals — the release lands back on ``cds:incoming``,
    the reactor places it, and the pre-push prefetch stages stage *i+1*'s
    inputs while stage *i*'s remaining CUs are still executing.

Determinism: events carry the store's monotonic sequence number and the
scheduler processes them strictly in arrival order.  With ``autostart=
False`` and ``stage_workers=0`` the reactor runs only when :meth:`step` is
called and stages inline — two identically-scripted runs then produce
identical event logs and decisions (see tests/test_scheduler_async.py).
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Deque, Dict, List, Optional, Tuple

from .compute_unit import CUState
from .coordination import StoreEvent
from .services import ComputeDataService


@dataclasses.dataclass(frozen=True)
class SchedulerEvent:
    """One reactor-relevant occurrence, in store-sequence order."""

    seq: int
    #: "cu-submitted" | "cu-state" | "du-state" | "du-published" |
    #: "pilot-state"
    kind: str
    subject: str  # cu/du/pilot id
    value: Any  # new state (or queue item for submissions)


class AsyncScheduler:
    """Reactor over coordination-store events; owns async-mode placement.

    Subscribes to the store, filters the firehose down to scheduler-
    relevant transitions, and reacts:

      * CU submission  → place (shared CDS path) + prefetch pipeline;
      * CU terminal    → re-check delayed CUs (a slot freed up);
      * pilot Active   → re-check delayed CUs (capacity appeared).
    """

    def __init__(
        self,
        cds: ComputeDataService,
        stage_workers: int = 4,
        autostart: bool = True,
        tick_s: float = 0.02,
        event_log_size: int = 10_000,
    ):
        self.cds = cds
        self.ctx = cds.ctx
        self.tick_s = tick_s
        self._queue: "queue.Queue[SchedulerEvent]" = queue.Queue()
        self._stop = threading.Event()
        #: bounded trace of handled events (oldest evicted) — enough for
        #: determinism tests and debugging without growing with the workload
        self.event_log: Deque[SchedulerEvent] = collections.deque(
            maxlen=event_log_size
        )
        self._log_lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(
                max_workers=stage_workers, thread_name_prefix="stage"
            )
            if stage_workers > 0
            else None
        )
        #: du_id -> [(cu, pilot)] consumers whose streaming input is still
        #: being produced: every publish event re-claims + prefetches the
        #: newly available chunks toward the consumer's sandbox
        self._stream_watch: Dict[str, List[Tuple[Any, Any]]] = {}
        self._watch_lock = threading.Lock()
        self._token = self.ctx.store.subscribe(self._on_store_event)
        # Claim staging BEFORE the CU becomes visible on a pilot queue:
        # agents then dedup onto the prefetch instead of re-staging.
        cds.pre_push_hook = self._begin_prefetch
        # A CU parked Waiting gets no placement (and hence no pre-push
        # prefetch) until its producers seal — but its OTHER inputs may
        # already be ready.  Stage those toward the predicted winner now,
        # so a serial DAG (train chunk i+1 waiting on ckpt_i) still
        # overlaps shard stage-in with chunk i's compute.
        cds.waiting_prefetch_hook = self._prefetch_waiting
        self._thread: Optional[threading.Thread] = None
        if autostart:
            self._thread = threading.Thread(
                target=self._run, name="async-scheduler", daemon=True
            )
            self._thread.start()

    # ---------------------------------------------------------- event intake
    def _on_store_event(self, ev: StoreEvent) -> None:
        """Store callback (dispatcher thread): filter + enqueue, nothing
        else — events arrive in seq order, off the mutating thread."""
        if ev.op == "push" and ev.key == "cds:incoming":
            self._queue.put(
                SchedulerEvent(ev.seq, "cu-submitted", str(ev.value), ev.value)
            )
        elif ev.op == "hset" and ev.field == "state":
            for prefix, kind in (
                ("cu:", "cu-state"),
                ("du:", "du-state"),
                ("pilot:", "pilot-state"),
            ):
                if ev.key.startswith(prefix):
                    self._queue.put(
                        SchedulerEvent(
                            ev.seq, kind, ev.key.split(":", 1)[1], ev.value
                        )
                    )
                    break
        elif (
            ev.op == "hset"
            and ev.field == "published"
            and ev.key.startswith("du:")
            and ev.key.count(":") == 1
        ):
            # a producer published a chunk prefix: pipeline the new chunks
            # toward every watching consumer's sandbox
            self._queue.put(
                SchedulerEvent(
                    ev.seq, "du-published", ev.key.split(":", 1)[1], ev.value
                )
            )

    # -------------------------------------------------------------- reactor
    def _run(self) -> None:
        while not self._stop.is_set():
            self.step(timeout=self.tick_s)

    def step(self, timeout: float = 0.0) -> bool:
        """Process one pending event (or time out re-checking delayed CUs).
        Returns True if an event was handled — the manual-stepping hook the
        determinism tests drive.  With ``timeout=0`` an empty queue first
        drains the store's out-of-lock dispatcher (``flush_events``), so
        manual stepping observes every mutation already issued."""
        try:
            if timeout:
                ev = self._queue.get(timeout=timeout)
            else:
                if self._queue.empty():
                    self.ctx.store.flush_events()
                ev = self._queue.get_nowait()
        except queue.Empty:
            self.cds.recheck_delayed()
            return False
        with self._log_lock:
            self.event_log.append(ev)
        try:
            self._react(ev)
        except Exception:
            pass  # scheduler must survive misbehaving CUs/agents
        return True

    def drain(self, max_events: int = 10_000) -> int:
        """Synchronously process everything queued (manual-stepping mode)."""
        n = 0
        while n < max_events and self.step():
            n += 1
        return n

    def _react(self, ev: SchedulerEvent) -> None:
        if ev.kind == "cu-submitted":
            cu_id = self.ctx.store.pop("cds:incoming", timeout=0.0)
            if cu_id is None:
                return  # sync loop (or a prior event) already took it
            cu = self.ctx.lookup(cu_id)
            if cu.state != CUState.PENDING:
                return
            self.cds.place(cu)  # prefetch rides the pre-push hook
        elif ev.kind == "du-published":
            self._on_published(ev.subject)
        elif ev.kind == "cu-state" and ev.value in CUState.TERMINAL:
            self.cds.recheck_delayed()
            # a slot freed up tenant-side too: re-admit parked CUs on the
            # reactor thread (the admission pump also drains — poke is
            # idempotent — but reacting here keeps async-mode admission
            # latency event-driven instead of cross-thread)
            self.cds.admission.poke()
        elif ev.kind == "pilot-state" and ev.value in (
            "Active", "Suspect", "Failed"
        ):
            # Active: capacity appeared.  Suspect/Failed: capacity VANISHED
            # — delayed CUs parked for that pilot must re-place elsewhere
            # (suspect pilots are non-placeable while their in-flight work
            # drains), and the fault pipeline's re-queues need a pass.
            self.cds.recheck_delayed()

    def _begin_prefetch(self, cu, pilot) -> None:
        """Pre-push hook (pipeline entry): claim the missing input chunks
        NOW — before the CU is visible to agents — then move the bytes on
        the staging pool so they overlap whatever the pilot is executing.
        Chunks the sandbox already holds are never claimed or re-moved.

        Streaming inputs still mid-production are additionally *watched*:
        each subsequent publish event re-claims the newly available chunks
        and stages them too (chunk-granular prefetch re-planning)."""
        if not cu.description.input_data:
            return
        ts = self.ctx.transfer_service
        dus = ts.lookup_dus(cu)
        with self._watch_lock:
            for du in dus:
                if du.streaming and not du.sealed:
                    self._stream_watch.setdefault(du.id, []).append(
                        (cu, pilot)
                    )
        claimed = ts.claim_bulk(dus, pilot.sandbox)
        if not claimed:
            return
        if self._pool is not None:
            try:
                self._pool.submit(ts.prefetch_inputs, cu, pilot, claimed)
                return
            except RuntimeError:
                pass  # pool shut down mid-flight: fall back to inline
        ts.prefetch_inputs(cu, pilot, claimed=claimed)

    def _prefetch_waiting(self, cu, unmet) -> None:
        """Speculative pipeline for ``Waiting`` CUs: claim + stage the
        inputs that are already consumable (everything not in ``unmet``)
        toward the pilot the placement strategy currently favors.  Pure
        data movement — no decision is logged, no queue is touched; if the
        release later lands the CU elsewhere, the sandbox replica still
        helps via cheapest-replica resolution (same rationale as the
        delayed-scheduling prefetch in ``ComputeDataService.place``).

        Runs only when a staging pool exists: with ``stage_workers=0``
        (the determinism-test configuration) submission stays free of
        side effects beyond the dependency registration."""
        if self._pool is None:
            return
        ready_ids = [d for d in cu.description.input_data if d not in unmet]
        if not ready_ids:
            return
        pilot = self.cds.predict_pilot(cu)
        if pilot is None:
            return
        dus = []
        for du_id in ready_ids:
            try:
                dus.append(self.ctx.lookup(du_id))
            except KeyError:
                continue
        ts = self.ctx.transfer_service
        claimed = ts.claim_bulk(dus, pilot.sandbox)
        if not claimed:
            return
        try:
            self._pool.submit(ts.prefetch_inputs, cu, pilot, claimed)
        except RuntimeError:
            ts.release_claims(claimed)  # pool shut down mid-flight

    def _on_published(self, du_id: str) -> None:
        """A streaming producer advanced its published prefix: stage the
        new chunks toward every live watching consumer's sandbox.  The DU
        sealing (its final publish event carries the full chunk count)
        retires the watch."""
        try:
            du = self.ctx.lookup(du_id)
        except KeyError:
            with self._watch_lock:
                self._stream_watch.pop(du_id, None)
            return
        with self._watch_lock:
            pairs = self._stream_watch.get(du_id, [])
            keep = [
                (cu, p) for cu, p in pairs
                if cu.state not in CUState.TERMINAL
            ]
            if du.sealed or not keep:
                self._stream_watch.pop(du_id, None)
            else:
                self._stream_watch[du_id] = keep
        ts = self.ctx.transfer_service
        for cu, pilot in keep:
            claimed = ts.claim_bulk([du], pilot.sandbox)
            if not claimed:
                continue
            if self._pool is not None:
                try:
                    self._pool.submit(ts.prefetch_inputs, cu, pilot, claimed)
                    continue
                except RuntimeError:
                    pass
            ts.prefetch_inputs(cu, pilot, claimed=claimed)

    # -------------------------------------------------------------- control
    def decisions(self) -> List[dict]:
        return self.cds.decisions()

    def stop(self) -> None:
        self._stop.set()
        self.ctx.store.unsubscribe(self._token)
        if self.cds.pre_push_hook is self._begin_prefetch:
            self.cds.pre_push_hook = None
        if self.cds.waiting_prefetch_hook is self._prefetch_waiting:
            self.cds.waiting_prefetch_hook = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self._pool is not None:
            self._pool.shutdown(wait=False)
