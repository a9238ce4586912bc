"""Fault tolerance & straggler mitigation (paper §4.2 "Fault Tolerance" and
the §6.4 lessons).

The paper's design: all framework state lives in the coordination store, so
components can crash, reconnect and resume; transfers retry; and the
evaluation observed "failures due to high loads, wall time limits and file
transfer errors" plus heavy-tailed stragglers ("CUs started later on a
machine run longer", "the first resource must not be the best one").

This module supplies the *active* policies on top of that substrate:

  * :class:`HeartbeatMonitor` — detects dying pilots.  A pilot that misses
    heartbeats first enters a grace-period ``SUSPECT`` state (non-placeable;
    schedulers route around it, its agent stops claiming new work so
    in-flight CUs drain); continued silence hardens it to ``FAILED``, a
    fresh heartbeat returns it to ``ACTIVE``.  The per-tick cost is O(1 +
    changes), not O(keyspace): liveness is ONE ``hgetall`` of the shared
    heartbeats hash and pilot states are tracked incrementally off the
    store's keyspace notifications;
  * :class:`StragglerMitigator` — duplicates long-running idempotent CUs
    onto other pilots; the exactly-once "winner" CAS in the agent makes the
    first finisher authoritative.  The RUNNING set and the completed-
    duration sample are maintained incrementally off store events, so a
    tick issues store ops only for actual straggler candidates —
    O(changes), not O(pilots × CUs);
  * :func:`requeue_orphans` / :func:`fail_cu_terminal` — the shared
    recovery primitives.  Orphan retry accounting rides the store-side
    ``attempts`` counter (a crash-looping pilot cannot retry a CU forever
    just because no live handle resolves), and exhausted retries fail
    through the full dataflow cascade (output DUs go FAILED, waiting
    consumers are released with the upstream cause).

Pilot *death recovery* — purging the dead sandbox's replicas, re-enforcing
per-DU replication factors and lineage recomputation — lives in
:mod:`repro.core.recovery`; the monitor hands failures to it via the
``on_failure`` callback.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Set

from .agent import GLOBAL_QUEUE
from .compute_unit import CUState, ComputeUnit
from .cost_model import straggler_threshold
from .coordination import StoreEvent
from .data_unit import DUState
from .pilot import HEARTBEATS_KEY, PilotState, RuntimeContext


def fail_cu_terminal(
    ctx: RuntimeContext, cu_id: str, reason: str, respect_winner: bool = True
) -> bool:
    """Terminally fail a CU *store-side*, cascading to its output DUs.

    Works without a live :class:`ComputeUnit` handle (the description is
    read back from the store), so orphan recovery on a reconnected manager
    fails dataflow consumers instead of leaving them parked forever.

    The exactly-once winner CAS is poisoned FIRST: a straggler duplicate
    still in flight must not claim the win after the failure cascade fired
    (it would flip the CU to DONE and re-seal outputs whose consumers were
    already failed over).  If a real winner already landed the CU in fact
    completed — with ``respect_winner`` (the orphan-recovery default) the
    failure is then abandoned and False returned; recovery paths that fail
    an already-DONE CU's *future* (impossible lineage recomputation) pass
    ``respect_winner=False``.
    """
    store = ctx.store
    if not store.hcas(f"cu:{cu_id}", "winner", None, "__failed__"):
        winner = store.hget(f"cu:{cu_id}", "winner")
        if respect_winner and winner != "__failed__":
            return False  # a duplicate beat us to completion: let it stand
    store.hset(f"cu:{cu_id}", "error", reason)
    store.hset(f"cu:{cu_id}", "state", CUState.FAILED)
    desc = store.hget(f"cu:{cu_id}", "desc") or {}
    for du_id in desc.get("output_data", ()):
        if store.hget(f"du:{du_id}", "state") != DUState.READY:
            store.hset(
                f"du:{du_id}", "error",
                f"producer cu://{cu_id} failed: {reason}",
            )
            store.hset(f"du:{du_id}", "state", DUState.FAILED)
    try:
        cu: ComputeUnit = ctx.lookup(cu_id)
        cu.error = reason
    except KeyError:
        pass
    if ctx.tier_manager is not None:
        ctx.tier_manager.pins.unpin_owner(cu_id)
    return True


def requeue_orphans(
    ctx: RuntimeContext, pilot_id: str, deps=None
) -> List[str]:
    """Re-queue every CU the (dead) pilot had claimed but not won, AND
    drain its pilot-specific queue back to the global queue (queued-but-
    unclaimed work must not die with the pilot).

    Retry accounting is store-side: each orphan recovery bumps the CU's
    ``attempts`` hash field whether or not a live handle resolves, and a CU
    whose retries are exhausted goes through :func:`fail_cu_terminal` so
    its output DUs fail and dataflow consumers are released with the cause.

    ``deps`` (a :class:`~repro.core.services.DependencyTracker`) re-parks
    orphans whose input DUs are mid-``Recovering`` on the dependency gate
    instead of re-queueing them into a staging path that cannot succeed
    yet; they release the moment the recovered DU re-seals.
    """
    store = ctx.store

    def repark_if_recovering(cu_id: str) -> bool:
        """Park a CU whose inputs are mid-``Recovering`` on the dependency
        gate (re-attaching a handle from the store when none is live) —
        re-queueing it would burn its retry budget on staging that cannot
        succeed until the recovered DU re-seals."""
        if deps is None:
            return False
        desc_json = store.hget(f"cu:{cu_id}", "desc") or {}
        unmet = {
            du_id
            for du_id in desc_json.get("input_data", ())
            if store.hget(f"du:{du_id}", "state") == DUState.RECOVERING
        }
        if not unmet:
            return False
        try:
            cu = ctx.lookup(cu_id)
        except KeyError:
            from .compute_unit import ComputeUnitDescription

            cu = ComputeUnit(
                ComputeUnitDescription(**desc_json), store, cu_id=cu_id
            )
            ctx.register(cu)
        store.hset(f"cu:{cu_id}", "state", CUState.WAITING)
        deps.add(cu, unmet)
        return True

    requeued = []
    # drain the dead pilot's queue (no attempt charge: this work was never
    # claimed, the pilot just happened to be its queue)
    while True:
        item = store.pop(f"queue:pilot:{pilot_id}", timeout=0.0)
        if item is None:
            break
        cu_id = item["cu"] if isinstance(item, dict) else item
        if not repark_if_recovering(cu_id):
            store.push(GLOBAL_QUEUE, item)
        requeued.append(cu_id)
    for key in store.hkeys("cu:"):
        cu_id = key.split(":", 1)[1]
        rec = store.hgetall(key)
        if rec.get("pilot") != pilot_id:
            continue
        if rec.get("state") in (CUState.STAGING, CUState.RUNNING) and (
            rec.get("winner") is None
        ):
            attempts = int(rec.get("attempts", 0)) + 1
            store.hset(key, "attempts", attempts)
            max_retries = (rec.get("desc") or {}).get("max_retries", 2)
            try:
                cu: ComputeUnit = ctx.lookup(cu_id)
                cu.attempts = max(cu.attempts, attempts)
            except KeyError:
                pass  # store-side counters carry the accounting regardless
            if attempts > max_retries:
                fail_cu_terminal(
                    ctx, cu_id,
                    f"pilot {pilot_id} died and retries are exhausted "
                    f"({attempts} attempts > max_retries={max_retries})",
                )
                continue
            if repark_if_recovering(cu_id):
                requeued.append(cu_id)
                continue
            store.hset(key, "state", CUState.PENDING)
            store.push(GLOBAL_QUEUE, {"cu": cu_id, "dup": False})
            requeued.append(cu_id)
    return requeued


class HeartbeatMonitor:
    """Pilot liveness: ACTIVE → SUSPECT (grace) → FAILED, event-driven.

    Per tick the monitor issues ONE store read (``hgetall`` of the shared
    heartbeats hash); the set of pilots worth checking is maintained
    incrementally from ``pilot:`` keyspace notifications, so total store
    traffic per tick is O(1 + state changes) regardless of keyspace size
    (``bench_faults`` proves this on the store's op counter).

    ``on_suspect(pilot_id)`` / ``on_failure(pilot_id)`` hook the
    FaultManager's recovery pipeline in.  When no ``on_failure`` is
    supplied the monitor itself requeues the dead pilot's orphans
    (standalone mode — the pre-recovery behaviour).
    """

    def __init__(
        self,
        ctx: RuntimeContext,
        timeout_s: float = 0.5,
        poll_s: float = 0.05,
        suspect_timeout_s: Optional[float] = None,
        on_suspect: Optional[Callable[[str], None]] = None,
        on_failure: Optional[Callable[[str], None]] = None,
    ):
        self.ctx = ctx
        self.timeout_s = timeout_s
        self.suspect_timeout_s = (
            suspect_timeout_s if suspect_timeout_s is not None
            else timeout_s / 2.0
        )
        self.poll_s = poll_s
        self.on_suspect = on_suspect
        self.on_failure = on_failure
        self._stop = threading.Event()
        self.failures: List[str] = []
        self.suspects: List[str] = []
        self._lock = threading.Lock()
        #: pilot id -> last observed state (fed by keyspace notifications;
        #: seeded once from the store at construction).  Subscribe FIRST,
        #: seed after: a transition landing between the two is then either
        #: delivered as an event or visible to the seed read — never lost.
        self._states: Dict[str, str] = {}
        store = ctx.store
        self._token = store.subscribe(self._on_event, prefix="pilot:")
        # store reads OUTSIDE self._lock (the event callback takes it while
        # holding the store lock — nesting them the other way deadlocks)
        seeded = {
            key.split(":", 1)[1]: store.hget(key, "state")
            for key in store.hkeys("pilot:")
        }
        with self._lock:
            for pid, state in seeded.items():
                # an event that already arrived is newer than our read
                self._states.setdefault(pid, state)
        self._thread = threading.Thread(
            target=self._loop, name="heartbeat-monitor", daemon=True
        )

    def _on_event(self, ev: StoreEvent) -> None:
        # store callback (dispatcher thread): in-memory bookkeeping only
        if ev.op == "hset" and ev.field == "state":
            with self._lock:
                self._states[ev.key.split(":", 1)[1]] = ev.value

    def start(self) -> "HeartbeatMonitor":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.ctx.store.unsubscribe(self._token)
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)

    def _tick(self, now: Optional[float] = None) -> None:
        """One liveness pass (exposed for tests/benchmarks)."""
        store = self.ctx.store
        # events are delivered off the mutating thread: barrier first so
        # _states reflects every pilot transition already written (the
        # flush is not a store op — ticks stay O(changes))
        store.flush_events()
        now = time.monotonic() if now is None else now
        heartbeats = store.hgetall(HEARTBEATS_KEY)  # the single scan
        with self._lock:
            watched = [
                (pid, st) for pid, st in self._states.items()
                if st in (PilotState.ACTIVE, PilotState.SUSPECT)
            ]
        for pilot_id, state in watched:
            silence = now - heartbeats.get(pilot_id, 0.0)
            key = f"pilot:{pilot_id}"
            if silence > self.timeout_s:
                # hard failure: CAS so a racing recovery/agent write wins
                if store.hcas(key, "state", state, PilotState.FAILED):
                    # dead pilots never heartbeat again: drop the entry so
                    # the shared hash doesn't grow with historical churn
                    store.hdel(HEARTBEATS_KEY, pilot_id)
                    self.failures.append(pilot_id)
                    if self.on_failure is not None:
                        self.on_failure(pilot_id)
                    else:
                        requeue_orphans(self.ctx, pilot_id)
            elif silence > self.suspect_timeout_s:
                if state == PilotState.ACTIVE and store.hcas(
                    key, "state", PilotState.ACTIVE, PilotState.SUSPECT
                ):
                    self.suspects.append(pilot_id)
                    if self.on_suspect is not None:
                        self.on_suspect(pilot_id)
            elif state == PilotState.SUSPECT:
                # heartbeats resumed inside the grace window: reinstate
                store.hcas(
                    key, "state", PilotState.SUSPECT, PilotState.ACTIVE
                )

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._tick()
            except Exception:
                pass  # transient store outage: monitor survives (§4.2)
            time.sleep(self.poll_s)


class StragglerMitigator:
    """Duplicate-launches slow CUs (speculative execution).

    Policy: once at least ``min_samples`` CUs of the workload completed, any
    RUNNING CU older than ``factor`` × median completed duration is pushed
    (as a duplicate) to the global queue — another pilot races it; the
    agent's winner-CAS keeps completion exactly-once.  Only CUs marked
    idempotent are eligible.

    The scan is incremental: the RUNNING set and the completed-duration
    sample are maintained from ``cu:`` keyspace notifications (state
    transitions carry the membership, ``timings`` writes carry the
    durations — no store read-back at all), so one tick touches the store
    only for candidates already past the threshold.
    """

    def __init__(
        self,
        ctx: RuntimeContext,
        factor: float = 2.5,
        min_samples: int = 3,
        poll_s: float = 0.05,
    ):
        self.ctx = ctx
        self.factor = factor
        self.min_samples = min_samples
        self.poll_s = poll_s
        self._stop = threading.Event()
        self._lock = threading.Lock()
        #: cu_id -> monotonic time the RUNNING transition was observed
        self._running: Dict[str, float] = {}
        #: bounded rolling sample — the threshold tracks the recent
        #: workload instead of growing with session age
        self._durations: Deque[float] = collections.deque(maxlen=512)
        self._duplicated: Dict[str, float] = {}
        self._ineligible: Set[str] = set()
        self.duplicates: List[str] = []
        # Subscribe FIRST, then seed from the store, so a mitigator
        # attached to an in-progress run sees pre-existing RUNNING CUs and
        # completed-duration samples AND cannot lose a transition landing
        # during the scan (events carry the changes from here on).  Store
        # reads stay outside self._lock — the event callback takes it
        # while holding the store lock.
        self._token = ctx.store.subscribe(self._on_event, prefix="cu:")
        now = time.monotonic()
        store = ctx.store
        running_seed: List[str] = []
        duration_seed: List[float] = []
        for key in store.hkeys("cu:"):
            rec = store.hgetall(key)
            state = rec.get("state")
            if state == CUState.RUNNING:
                running_seed.append(key.split(":", 1)[1])
            t = rec.get("timings")
            if state == CUState.DONE and isinstance(t, dict):
                duration_seed.append(float(t.get("t_c", 0.0)))
        with self._lock:
            for cu_id in running_seed:
                self._running.setdefault(cu_id, now)
            self._durations.extend(duration_seed)
        self._thread = threading.Thread(
            target=self._loop, name="straggler-mitigator", daemon=True
        )

    def _on_event(self, ev: StoreEvent) -> None:
        # store callback (dispatcher thread): in-memory bookkeeping only
        if ev.op != "hset":
            return
        cu_id = ev.key.split(":", 1)[1]
        if ev.field == "state":
            with self._lock:
                if ev.value == CUState.RUNNING:
                    self._running.setdefault(cu_id, time.monotonic())
                else:
                    self._running.pop(cu_id, None)
                    if ev.value in CUState.TERMINAL:
                        # terminal CUs can never be duplicated again:
                        # drop their dedup bookkeeping so long sessions
                        # don't accumulate it
                        self._duplicated.pop(cu_id, None)
                        self._ineligible.discard(cu_id)
        elif ev.field == "timings" and isinstance(ev.value, dict):
            with self._lock:
                self._durations.append(float(ev.value.get("t_c", 0.0)))

    def start(self) -> "StragglerMitigator":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.ctx.store.unsubscribe(self._token)
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)

    def _tick(self, now: Optional[float] = None) -> None:
        """One speculative-execution pass (exposed for tests/benchmarks).
        Store ops: O(candidates past threshold), zero on a quiet tick."""
        store = self.ctx.store
        # barrier: fold in cu: transitions already written but still in
        # flight on the dispatcher (flush_events is not a store op)
        store.flush_events()
        with self._lock:
            if len(self._durations) < self.min_samples:
                return
            threshold = straggler_threshold(list(self._durations), self.factor)
            now = time.monotonic() if now is None else now
            candidates = [
                (cu_id, started)
                for cu_id, started in self._running.items()
                if cu_id not in self._duplicated
                and cu_id not in self._ineligible
                and (now - started) > threshold
            ]
        for cu_id, _ in candidates:
            try:
                cu: ComputeUnit = self.ctx.lookup(cu_id)
            except KeyError:
                continue
            if not cu.description.kwargs.get("idempotent", True):
                with self._lock:
                    self._ineligible.add(cu_id)
                continue
            if store.hget(f"cu:{cu_id}", "winner"):
                # already finished — drop it here too, covering a stale
                # seed entry whose terminal event predated the seeding scan
                with self._lock:
                    self._running.pop(cu_id, None)
                continue
            store.push(GLOBAL_QUEUE, {"cu": cu_id, "dup": True})
            with self._lock:
                self._duplicated[cu_id] = now
            self.duplicates.append(cu_id)

    def _loop(self) -> None:
        while not self._stop.is_set():
            time.sleep(self.poll_s)
            try:
                self._tick()
            except Exception:
                continue
