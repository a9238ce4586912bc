"""Pilot-Agent: the decentralized per-pilot execution loop (§4.2, Fig. 1).

"Each Pilot is represented by a decentral component referred to as the
Pilot-Agent, which manages the set of resources assigned to it. ... Each
Pilot-Agent generally pulls from two queues: its agent-specific queue and a
global queue."

The agent:
  * waits out the (simulated) batch-queue time, then reports ACTIVE and
    pushes local resource information to the coordination store (paper: the
    agent "collects various information about the local resource, which is
    pushed to the Redis server and used by the Pilot-Manager to conduct e.g.
    placement decisions");
  * pulls CU ids from [pilot queue, global queue], claims them with an
    atomic CAS (exactly-once against racing duplicates), stages input DUs
    (pull-mode data management), executes the registered executable, stages
    outputs into DUs, and heartbeats throughout;
  * honors its walltime: unfinished claimed CUs are re-queued (the paper's
    observed walltime-limit failures, §6.4, handled instead of lost);
  * supports hard-kill for fault-injection (heartbeat stops, in-flight work
    is discarded — the manager's monitor re-queues it).
"""

from __future__ import annotations

import itertools
import threading
import time
import traceback
from typing import Dict, Iterator, List, Optional, Tuple

from .affinity import match_affinity
from .compute_unit import CUState, ComputeUnit, FUNCTIONS
from .data_unit import DataUnit, DUState
from .pilot import HEARTBEATS_KEY, PilotState, QuotaExceeded, RuntimeContext

GLOBAL_QUEUE = "queue:global"

#: staging attempts a CU may abandon to quota backpressure (sandbox full
#: of OTHER live consumers' pinned inputs) before the hit counts as a
#: real failure; each wait re-queues without burning a retry attempt
MAX_QUOTA_WAITS = 100

#: quota-blocked waits a streaming producer's flush tolerates before the
#: QuotaExceeded surfaces as a CU failure — each wait is the backpressure
#: that paces a fast producer against a slow consumer's sandbox (eviction
#: can only reclaim streamed chunks the consumers' read frontiers passed)
MAX_STREAM_FLUSH_WAITS = 200

#: attempt-unique stream-writer tokens (``<cu>@<pilot>#<n>``): the pilot id
#: in the middle is what lets a retry prove the prior writer is dead
_stream_tokens = itertools.count()


class CUContext:
    """Execution context handed to CU executables (the sandbox view).

    Output writes are buffered per attempt and flushed into the real output
    DUs only after the exactly-once winner CAS: a CU that raises after
    partial ``write_output`` calls leaves its output DUs untouched (a retry
    starts from a clean buffer instead of appending onto half-written
    state), and a straggler duplicate that loses the race never writes at
    all."""

    def __init__(self, cu: ComputeUnit, pilot, ctx: RuntimeContext):
        self.cu = cu
        self.pilot = pilot
        self.ctx = ctx
        #: output index -> {relpath: bytes}, flushed by the agent on win
        self._out_buffers: Dict[int, Dict[str, bytes]] = {}
        #: this attempt's stream-writer identity (streaming outputs only)
        self._stream_token = f"{cu.id}@{pilot.id}#{next(_stream_tokens)}"
        #: set once this attempt loses a stream to a live foreign writer —
        #: the agent declines the winner CAS instead of double-publishing
        self._stream_lost = False

    # ------------------------------------------------------------- inputs
    def input_dus(self) -> List[DataUnit]:
        return [self.ctx.lookup(d) for d in self.cu.description.input_data]

    def read_input(self, du_id: str, relpath: str) -> bytes:
        """Read an input file — from the sandbox copy if staged, else via
        the logical link to a co-located PD."""
        sandbox = self.pilot.sandbox
        if sandbox.has_du(du_id):
            return sandbox.fetch_du_file(du_id, relpath)
        du = self.ctx.lookup(du_id)
        pd, linked = self.ctx.transfer_service.resolve_access(
            du, self.pilot.affinity
        )
        if pd is not None:
            return pd.fetch_du_file(du_id, relpath)
        return du.read(relpath)  # pre-replica local buffer

    def input_manifest(self, du_id: str) -> Dict[str, int]:
        return self.ctx.lookup(du_id).manifest

    # ------------------------------------------------------------ outputs
    def write_output(self, relpath: str, data: bytes, index: int = 0) -> None:
        """Stage a file for the index-th output DU (Fig. 5 data flow).

        Buffered: the bytes land in the DU only if this attempt wins the
        exactly-once completion race (see :meth:`flush_outputs`)."""
        out_ids = self.cu.description.output_data
        if not out_ids:
            raise RuntimeError(f"{self.cu.url} declares no output_data")
        if not 0 <= index < len(out_ids):
            raise IndexError(
                f"{self.cu.url} has {len(out_ids)} output DUs, no index {index}"
            )
        if relpath.startswith("/") or ".." in relpath.split("/"):
            raise ValueError(f"bad DU-relative path {relpath!r}")
        self._out_buffers.setdefault(index, {})[relpath] = bytes(data)

    def flush_outputs(self) -> None:
        """Move the attempt's buffered writes into the real output DUs —
        called by the agent strictly after the winner CAS, so failed
        attempts and losing duplicates never touch a DU.

        Streaming DUs flush in *insertion* order (their canonical stream is
        append-ordered — already-published chunk prefixes must not shift);
        sealed-at-once DUs keep the deterministic sorted order."""
        out_ids = self.cu.description.output_data
        for index in sorted(self._out_buffers):
            du: DataUnit = self.ctx.lookup(out_ids[index])
            items = self._out_buffers[index].items()
            for relpath, data in (
                items if du.streaming else sorted(items)
            ):
                du.add_file(relpath, data)
        self._out_buffers.clear()

    # -------------------------------------------------- streaming outputs
    def flush_output(self, index: int = 0) -> bool:
        """Flush the buffered writes of streaming output ``index`` NOW,
        publishing every newly-completed chunk to consumers (ordered
        chunk-availability events on the store stream) while this CU keeps
        running.

        Exactly-once is preserved by a **stream-writer CAS** on the DU: the
        first attempt to flush claims the stream; a racing duplicate loses
        the claim, drops its buffer, and returns ``False`` (the agent then
        declines the winner CAS for that attempt).  A writer token whose
        pilot has died is stolen — after rolling the half-written stream
        back to zero — so retries of a crashed producer start clean.

        Returns ``True`` if this attempt owns the stream and the flush
        published; ``False`` if the stream belongs to a live foreign
        attempt (the caller should stop producing)."""
        out_ids = self.cu.description.output_data
        if not out_ids:
            raise RuntimeError(f"{self.cu.url} declares no output_data")
        if not 0 <= index < len(out_ids):
            raise IndexError(
                f"{self.cu.url} has {len(out_ids)} output DUs, no index {index}"
            )
        du: DataUnit = self.ctx.lookup(out_ids[index])
        if not du.streaming:
            raise RuntimeError(
                f"{du.url} is not a streaming DU; buffered writes flush "
                f"after the winner CAS instead"
            )
        store = self.ctx.store
        if store.hget(f"cu:{self.cu.id}", "winner") is not None:
            # another attempt already completed the whole CU
            self._stream_lost = True
            self._out_buffers.pop(index, None)
            return False
        if not self._own_stream(du):
            self._out_buffers.pop(index, None)
            return False
        buf = self._out_buffers.pop(index, None)
        if buf:
            for relpath, data in buf.items():  # insertion order
                du.add_file(relpath, data)
        self._publish_prefix(du)
        return True

    def _own_stream(self, du: DataUnit) -> bool:
        """Acquire (or re-confirm) the stream-writer claim for ``du``."""
        store = self.ctx.store
        key = f"du:{du.id}"
        token = self._stream_token
        if store.hcas(key, "stream_writer", None, token):
            return True
        cur = store.hget(key, "stream_writer")
        if cur == token:
            return True
        writer_pilot = None
        if isinstance(cur, str) and "@" in cur and "#" in cur:
            writer_pilot = cur.split("@", 1)[1].rsplit("#", 1)[0]
        if writer_pilot is not None:
            pstate = store.hget(f"pilot:{writer_pilot}", "state")
            if pstate in (
                PilotState.FAILED, PilotState.CANCELED, PilotState.DONE
            ) and store.hcas(key, "stream_writer", cur, token):
                # the prior writer died mid-stream: roll its partial
                # publishes back so this attempt re-streams from zero
                du.reset_stream()
                return True
        self._stream_lost = True
        return False

    def _publish_prefix(self, du: DataUnit) -> None:
        """Materialize the newly-completed chunks into the producer's
        sandbox PD, cost-account the move, then advance the published
        prefix — strictly in that order, so a consumer released by the
        publish event always finds a registered holder for every chunk of
        the prefix (the no-gap invariant).

        The sandbox quota is the backpressure: when eviction cannot make
        room (consumers' read frontiers haven't passed the already-
        streamed chunks), the producer *waits* here instead of flooding."""
        ts = self.ctx.transfer_service
        sandbox = self.pilot.sandbox
        upto = du.publishable_chunks()
        already = du.published
        if upto <= already:
            return
        t0 = time.monotonic()
        waits = 0
        while True:
            try:
                nbytes = sandbox.put_chunks(du, list(range(already, upto)))
                break
            except QuotaExceeded:
                waits += 1
                if waits > MAX_STREAM_FLUSH_WAITS:
                    raise
                time.sleep(max(self.ctx.poll_s, 0.01))
        if nbytes > 0:
            from .transfer import TransferRecord

            sim = ts.simulated_ingest_time(nbytes, sandbox)
            self.ctx.sleep_sim(sim)
            ts.record(
                TransferRecord(
                    du_id=du.id,
                    src_pd=None,
                    dst_pd=sandbox.id,
                    nbytes=nbytes,
                    sim_seconds=sim,
                    wall_seconds=time.monotonic() - t0,
                    wall_start=t0,
                    chunks=upto - already,
                )
            )
        du.publish_prefix(upto)

    def abort_stream(self) -> None:
        """Roll back this attempt's partially-streamed outputs (the
        exception/retry path): every streaming output DU whose writer
        claim is ours is reset to zero published chunks and the claim
        released — a failed producer attempt publishes nothing durable."""
        store = self.ctx.store
        for du_id in self.cu.description.output_data:
            try:
                du: DataUnit = self.ctx.lookup(du_id)
            except KeyError:
                continue
            if not du.streaming or du.sealed:
                continue
            if store.hget(f"du:{du.id}", "stream_writer") == self._stream_token:
                du.reset_stream()
                store.hdel(f"du:{du.id}", "stream_writer")
        self._out_buffers.clear()

    def lost_stream(self) -> bool:
        """True if a live foreign attempt owns one of our output streams —
        the agent declines the winner CAS for this attempt."""
        return self._stream_lost

    # --------------------------------------------------- streaming inputs
    def stream_input(
        self, du_id: str, window: int = 4
    ) -> Iterator[Tuple[int, bytes]]:
        """Iterate ``(chunk_index, chunk_bytes)`` over a streaming input
        DU, staging chunks into the sandbox as the producer publishes them
        (chunk-granular stage-in, re-planned as more chunks appear) and
        blocking — event-driven on the ``published`` field — when the
        consumer catches up with the producer.

        ``window`` bounds read-ahead: at most that many chunks beyond the
        current read position are staged per call, and the consumer's read
        frontier advances after each yielded chunk so the TierManager may
        evict consumed stream chunks behind it (the backpressure valve)."""
        du: DataUnit = self.ctx.lookup(du_id)
        ts = self.ctx.transfer_service
        sandbox = self.pilot.sandbox
        tm = self.ctx.tier_manager
        store = self.ctx.store
        i = 0
        while True:
            if du.state == DUState.FAILED:
                raise RuntimeError(
                    f"{du.url} failed mid-stream: "
                    f"{store.hget(f'du:{du.id}', 'error') or 'producer failed'}"
                )
            avail = du.available_chunks()
            if i >= avail:
                if du.sealed and i >= du.n_chunks:
                    return
                # producer ahead of us not yet: wait on the next publish
                # event (short timeout so FAILED/reset are re-checked)
                store.wait_field(
                    f"du:{du.id}",
                    "published",
                    lambda v, _i=i: int(v or 0) > _i or du.sealed,
                    timeout=0.5,
                    default=0,
                )
                continue
            ts.stage_in(
                du, sandbox, self.pilot.affinity,
                prefix=min(avail, i + window),
            )
            data = self._read_chunk(du, sandbox, i)
            if data is None:
                # stream rolled back mid-fetch (or holder lost): re-check
                time.sleep(max(self.ctx.poll_s, 0.01))
                continue
            yield i, data
            if tm is not None:
                tm.pins.advance_frontier(du.id, self.cu.id, i + 1)
            i += 1

    def _read_chunk(self, du: DataUnit, sandbox, i: int) -> Optional[bytes]:
        """Chunk ``i``'s bytes from the sandbox — or, when ``stage_in``
        resolved to a *linked* access and physically moved nothing (a
        sealed DU on a same-site PD, e.g. a sharedfs shard), straight from
        a holder replica.  None if no live holder has the chunk (stream
        rolled back mid-fetch)."""
        if i in set(sandbox.chunks_held(du.id)):
            return sandbox.fetch_du_chunk(du.id, i)
        for loc in du.locations:
            try:
                pd = self.ctx.lookup(loc)
            except KeyError:
                continue
            if i in set(pd.chunks_held(du.id)):
                return pd.fetch_du_chunk(du.id, i)
        return None


class PilotAgent:
    def __init__(self, pilot, ctx: RuntimeContext):
        self.pilot = pilot
        self.ctx = ctx
        self._stop = threading.Event()
        self._dead = threading.Event()  # hard failure: discard everything
        self._threads: List[threading.Thread] = []
        self._slots = threading.Semaphore(pilot.description.slots)
        self._started_at: Optional[float] = None
        self._lock = threading.Lock()
        self._running: Dict[str, float] = {}  # cu_id -> start time
        # Own pilot/sandbox state tracked off keyspace notifications, so
        # the claim-loop SUSPECT/FAILED checks are memory reads instead of
        # per-iteration store ops (assignment is atomic; no lock needed).
        # Events land from the store's dispatcher thread a beat after the
        # mutation — the claim loop tolerates that: the monitor's CAS plus
        # the agent's own post-pop state re-check keep decisions correct.
        self._own_state_cache: Optional[str] = ctx.store.hget(
            f"pilot:{pilot.id}", "state"
        )
        self._sandbox_failed_flag = False
        self._sub_tokens = [
            ctx.store.subscribe(
                self._on_pilot_event, prefix=f"pilot:{pilot.id}"
            ),
            ctx.store.subscribe(
                self._on_sandbox_event, prefix=f"pd:{pilot.sandbox.id}"
            ),
        ]

    def _on_pilot_event(self, ev) -> None:
        if ev.op == "hset" and ev.field == "state":
            self._own_state_cache = ev.value

    def _on_sandbox_event(self, ev) -> None:
        if ev.op == "hset" and ev.field == "state":
            self._sandbox_failed_flag = ev.value == PilotState.FAILED

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        t = threading.Thread(
            target=self._main, name=f"agent-{self.pilot.id}", daemon=True
        )
        self._threads.append(t)
        t.start()

    def stop(self) -> None:
        self._stop.set()
        self._unsubscribe()

    def kill(self) -> None:
        """Simulated node crash: stop heartbeating immediately, abandon CUs."""
        self._dead.set()
        self._stop.set()

    def _unsubscribe(self) -> None:
        for token in self._sub_tokens:
            self.ctx.store.unsubscribe(token)
        self._sub_tokens = []

    def join(self, timeout: float = 5.0) -> None:
        for t in self._threads:
            t.join(timeout)

    @property
    def alive(self) -> bool:
        return not self._stop.is_set()

    # ----------------------------------------------------------- main loop
    def _main(self) -> None:
        try:
            self._main_loop()
        finally:
            # every exit path — retire, cancel, hardened-FAILED, crash —
            # drops the store subscriptions, or dead agents' callbacks
            # would tax every future mutation and pin the agent in memory
            self._unsubscribe()

    def _main_loop(self) -> None:
        store, pilot = self.ctx.store, self.pilot
        # Simulated batch-queue wait (T_Q_pilot).
        self.ctx.sleep_sim(pilot.description.queue_time_s)
        if self._stop.is_set():
            return
        store.hset(f"pilot:{pilot.id}", "state", PilotState.ACTIVE)
        store.hset(f"pilot:{pilot.id}", "activated_at", time.monotonic())
        # Resource info push (used by the manager for placement decisions).
        store.hset(
            f"pilot:{pilot.id}",
            "resource_info",
            {
                "slots": pilot.description.slots,
                "affinity": pilot.affinity,
                "sandbox_pd": pilot.sandbox.id,
            },
        )
        self._started_at = time.monotonic()
        self._heartbeat()  # liveness visible the instant we turn ACTIVE
        queues = [pilot.queue_name, GLOBAL_QUEUE]
        while not self._stop.is_set():
            self._heartbeat()
            if self._walltime_exceeded():
                self._retire()
                return
            # reviewed: these caches are refreshed by subscriber callbacks;
            # a stale read here only delays retirement by one loop tick —
            # the poll re-reads next iteration, and a flush_events() per
            # tick would serialize the agent loop on the dispatcher
            own_state = self._own_state()  # pdlint: disable=PD-L004
            # pdlint: disable=PD-L004
            if own_state == PilotState.FAILED and self._sandbox_failed():
                # The monitor hardened us to FAILED (we stalled past the
                # threshold) AND the FaultManager purged our sandbox — our
                # replicas can never register again.  FAILED is terminal,
                # so stop claiming; in-flight workers decline their wins.
                # (Standalone-monitor mode never fails the sandbox: there a
                # falsely-failed-but-alive agent keeps working — its
                # replicas still register and the winner CAS dedups
                # against the re-queued copy.  That also means a CU popped
                # in the ms-wide FAILED→purge window is a deliberate
                # tradeoff: it is declined and handed back once the purge
                # lands, costing at most one store-side attempt — whereas
                # gating on FAILED alone would deadlock single-pilot
                # standalone deployments on a monitor false positive.)
                self._drop_heartbeat()  # we re-wrote it above; retract
                return
            if own_state == PilotState.SUSPECT:
                # Grace period: the monitor flagged us SUSPECT (missed
                # heartbeats).  Drain in-flight CUs but claim nothing new —
                # recovery must not race a half-alive pilot.  The heartbeat
                # we just wrote flips us back to ACTIVE if we're merely slow.
                time.sleep(max(self.ctx.poll_s, 0.01))
                continue
            if not self._slots.acquire(timeout=0.02):
                continue
            try:
                item = store.pop_any(queues, timeout=self.ctx.poll_s)
            except Exception:
                self._slots.release()
                time.sleep(0.02)
                continue
            if item is None:
                self._slots.release()
                continue
            # Post-pop re-check against the STORE, not the event cache: a
            # SUSPECT hset that happened-before this claim's push is then
            # guaranteed visible here even if its notification hasn't been
            # dispatched yet.  One store read per successful claim — the
            # per-iteration checks above stay memory reads.
            authoritative = store.hget(f"pilot:{pilot.id}", "state")
            if authoritative == PilotState.SUSPECT or self._sandbox_failed():
                # SUSPECT (or a recovery purge) landed while we were
                # blocked in the pop: hand the item back instead of racing
                # recovery with a fresh claim
                store.push(GLOBAL_QUEUE, item)
                self._slots.release()
                time.sleep(max(self.ctx.poll_s, 0.01))
                continue
            cu_id = item["cu"] if isinstance(item, dict) else item
            is_dup = isinstance(item, dict) and item.get("dup", False)
            try:
                cu: ComputeUnit = self.ctx.lookup(cu_id)
            except KeyError:
                self._slots.release()
                continue
            # Affinity constraint check: a CU pulled from the global queue
            # may not be runnable here — push it back (step 4 fallthrough).
            constraint = cu.description.affinity
            if constraint and not match_affinity(constraint, pilot.affinity):
                store.push(GLOBAL_QUEUE, item)
                self._slots.release()
                time.sleep(0.01)
                continue
            if not is_dup and not cu._cas_state(CUState.PENDING, CUState.STAGING):
                # canceled or already claimed elsewhere
                self._slots.release()
                continue
            worker = threading.Thread(
                target=self._run_cu,
                args=(cu, is_dup),
                name=f"worker-{pilot.id}-{cu.id}",
                daemon=True,
            )
            self._threads.append(worker)
            worker.start()
        if not self._dead.is_set():
            store.hset(f"pilot:{pilot.id}", "state", PilotState.DONE)
            self._drop_heartbeat()

    def _heartbeat(self) -> None:
        if self._dead.is_set():
            return
        try:
            self.ctx.store.hset(
                HEARTBEATS_KEY, self.pilot.id, time.monotonic()
            )
            with self._lock:
                self.ctx.store.hset(
                    f"pilot:{self.pilot.id}", "running", sorted(self._running)
                )
        except Exception:
            pass  # transient store outage: agents survive (§4.2)

    def _own_state(self) -> Optional[str]:
        return self._own_state_cache

    def _sandbox_failed(self) -> bool:
        """True once fault recovery purged this pilot's sandbox PD — the
        point of no return: replicas written here can never register."""
        return self._sandbox_failed_flag

    def _drop_heartbeat(self) -> None:
        """Remove this pilot's heartbeat entry on orderly shutdown so the
        shared hash (the monitor's single per-tick scan) doesn't grow with
        historical pilot churn."""
        try:
            self.ctx.store.hdel(HEARTBEATS_KEY, self.pilot.id)
        except Exception:
            pass

    def _walltime_exceeded(self) -> bool:
        wt = self.pilot.description.walltime_s
        return (
            self._started_at is not None
            and time.monotonic() - self._started_at > wt
        )

    def _retire(self) -> None:
        """Walltime reached: requeue claimed-but-unfinished CUs, shut down."""
        store = self.ctx.store
        with self._lock:
            running = sorted(self._running)
        for cu_id in running:
            cu = self.ctx.lookup(cu_id)
            if store.hget(f"cu:{cu.id}", "winner") is None:
                cu._set_state(CUState.PENDING)
                store.push(GLOBAL_QUEUE, {"cu": cu.id, "dup": False})
        store.hset(f"pilot:{self.pilot.id}", "state", PilotState.DONE)
        self._drop_heartbeat()

    # -------------------------------------------------------- CU execution
    def _run_cu(self, cu: ComputeUnit, is_dup: bool) -> None:
        store, pilot, ctx = self.ctx.store, self.pilot, self.ctx
        desc = cu.description
        tm = ctx.tier_manager
        cu_ctx: Optional[CUContext] = None
        try:
            with self._lock:
                self._running[cu.id] = time.monotonic()
            if tm is not None:
                # pin inputs for the attempt (idempotent — submission
                # already pinned them): quota eviction must never drop a
                # Staging/Running CU's input chunks from under it
                tm.pins.pin_inputs(cu)
            store.hset(f"cu:{cu.id}", "pilot", pilot.id)
            cu.timings.stage_start = time.monotonic()
            # ---- stage inputs (pull-mode data management, §4.2) ----
            sim_stage = 0.0
            try:
                for du_id in desc.input_data:
                    du: DataUnit = ctx.lookup(du_id)
                    sim_stage += ctx.transfer_service.stage_in(
                        du, pilot.sandbox, pilot.affinity,
                        use_cache=desc.cache_inputs,
                    )
            except QuotaExceeded:
                # Sandbox full and eviction blocked — typically by ANOTHER
                # live consumer's pinned inputs.  That is backpressure,
                # not a failure: hand the CU back (its own pins unbind in
                # Pending, freeing the bytes) and retry once the holder
                # drains, without burning a retry attempt.  The store-side
                # wait counter bounds livelock: past the cap it falls
                # through to the normal failure/retry path.
                if is_dup:
                    return
                waits = int(store.hget(f"cu:{cu.id}", "quota_waits", 0)) + 1
                store.hset(f"cu:{cu.id}", "quota_waits", waits)
                if waits <= MAX_QUOTA_WAITS and not self._dead.is_set():
                    if cu._cas_state(CUState.STAGING, CUState.PENDING):
                        time.sleep(max(self.ctx.poll_s, 0.01))  # pace
                        admission = getattr(ctx, "admission", None)
                        if admission is not None:
                            # re-enter tenant admission: a tenant whose
                            # own resident bytes caused the pressure
                            # parks there instead of hot-looping through
                            # the global queue (starvation valve); every
                            # other case pushes back to the global queue
                            # exactly as before
                            admission.requeue(cu)
                        else:
                            store.push(
                                GLOBAL_QUEUE, {"cu": cu.id, "dup": False}
                            )
                        return
                raise
            cu.timings.stage_end = time.monotonic()
            cu.timings.sim_stage_s = sim_stage
            cu.timings.sim_prefetch_s = (
                store.hget(f"cu:{cu.id}", "sim_prefetch_s", 0.0) or 0.0
            )
            store.hset(f"cu:{cu.id}", "sim_stage_s", sim_stage)
            if not is_dup:
                cu._cas_state(CUState.STAGING, CUState.RUNNING)
            # ---- execute ----
            cu.timings.run_start = time.monotonic()
            fn = FUNCTIONS.resolve(desc.executable)
            cu_ctx = CUContext(cu, pilot, ctx)
            result = fn(cu_ctx, *desc.args, **desc.kwargs)
            if cu_ctx.lost_stream():
                # a live foreign attempt owns one of our output streams —
                # its chunks are already published; decline the win and let
                # that attempt complete (exactly-once for streamed bytes)
                return
            ctx.sleep_sim(desc.sim_compute_s)
            cu.timings.sim_compute_s = desc.sim_compute_s
            cu.timings.run_end = time.monotonic()
            if self._dead.is_set():
                return  # node died mid-flight: results are lost
            # reviewed: stale cache only delays the decline — the winner
            # CAS below still dedups against the re-queued attempt, so no
            # barrier is needed on this advisory check
            if self._sandbox_failed():  # pdlint: disable=PD-L004
                # The monitor declared us dead (false positive: we were
                # merely stalled) and recovery purged our sandbox.
                # Claiming the win now would seal output DUs whose
                # replicas the FAILED sandbox can no longer register —
                # silent data loss.  Decline, and if orphan recovery's
                # one-shot requeue ran BEFORE we claimed (so it missed
                # this CU), hand it back ourselves — otherwise it would
                # sit in STAGING/RUNNING with no winner forever.  Only if
                # the claim is still OURS (nobody re-claimed after a
                # recovery requeue) — else we'd flip another agent's
                # in-flight attempt back to PENDING.
                if (
                    not is_dup
                    and store.hget(f"cu:{cu.id}", "pilot") == pilot.id
                ):
                    for st in (CUState.STAGING, CUState.RUNNING):
                        if cu._cas_state(st, CUState.PENDING):
                            store.push(
                                GLOBAL_QUEUE, {"cu": cu.id, "dup": False}
                            )
                            break
                return
            # ---- exactly-once completion (first finisher wins) ----
            if not store.hcas(f"cu:{cu.id}", "winner", None, pilot.id):
                return  # a duplicate finished first; discard its buffers
            cu.result = result
            # ---- stage outputs: flush the winning attempt's buffered
            # writes, then seal output DUs into the sandbox PD.  Only the
            # winner ever writes/seals — a FAILED attempt or losing
            # duplicate leaves output DUs untouched and unsealed. ----
            cu_ctx.flush_outputs()
            for du_id in desc.output_data:
                du: DataUnit = ctx.lookup(du_id)
                if not pilot.sandbox.has_du(du.id):
                    # streaming DUs only pay for the not-yet-flushed tail
                    # here (put_du skips chunks the sandbox already holds)
                    ctx.transfer_service.ingest(du, pilot.sandbox)
                du.seal()
                if du.streaming:
                    # end-of-stream: the writer claim has served its
                    # purpose (the seal froze the content)
                    store.hdel(f"du:{du.id}", "stream_writer")
            store.hset(f"cu:{cu.id}", "state", CUState.DONE)
            store.hset(
                f"cu:{cu.id}",
                "timings",
                {
                    "t_q_task": cu.timings.t_q_task,
                    "t_s": cu.timings.t_s,
                    "t_c": cu.timings.t_c,
                    "sim_stage_s": cu.timings.sim_stage_s,
                    "sim_compute_s": cu.timings.sim_compute_s,
                    "sim_prefetch_s": cu.timings.sim_prefetch_s,
                },
            )
        except Exception as exc:  # noqa: BLE001 — CU failures are data
            cu.error = f"{type(exc).__name__}: {exc}"
            store.hset(f"cu:{cu.id}", "error", cu.error)
            store.hset(f"cu:{cu.id}", "traceback", traceback.format_exc())
            # the store-side counter is authoritative: orphan recovery may
            # have burned attempts while no live handle was reachable
            cu.attempts = (
                max(cu.attempts, int(store.hget(f"cu:{cu.id}", "attempts", 0)))
                + 1
            )
            store.hset(f"cu:{cu.id}", "attempts", cu.attempts)
            if cu_ctx is not None:
                # a failed attempt must leave ZERO published chunks behind:
                # roll back any streaming output this attempt was writing
                # before the retry (or the terminal failure) proceeds
                try:
                    cu_ctx.abort_stream()
                except Exception:
                    pass
            if cu.attempts <= desc.max_retries and not self._dead.is_set():
                # retry with backoff via the global queue (the failed
                # attempt's buffered output writes were discarded, so the
                # retry starts against clean output DUs)
                cu._set_state(CUState.PENDING)
                store.push(GLOBAL_QUEUE, {"cu": cu.id, "dup": False})
            else:
                cu._set_state(CUState.FAILED)
                # terminal: outputs will never materialize — fail them so
                # dataflow waiters downstream are released with the cause
                cu._fail_outputs(f"producer {cu.url} failed: {cu.error}")
        finally:
            with self._lock:
                self._running.pop(cu.id, None)
            if tm is not None and cu.state in CUState.TERMINAL:
                # terminal attempts release the inputs for eviction;
                # requeued/declined attempts keep the pin until a later
                # attempt settles (the registry also self-heals lazily)
                tm.pins.unpin_owner(cu.id)
            self._slots.release()
