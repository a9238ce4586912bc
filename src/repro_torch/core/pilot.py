"""Pilot-Compute and Pilot-Data (§4.3.1).

"A Pilot-Compute allocates a set of computational resources (e.g. cores).
A Pilot-Data is conceptually similar and represents a physical storage
resource that is used as a logical container for dynamic data placement,
e.g. for compute-local data replicas or for caching intermediate data."
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

from ..backends import StorageAdaptor, chunk_key, make_backend
from .affinity import Topology
from .coordination import CoordinationStore
from .data_unit import DataUnit, _next_id


class PilotState:
    NEW = "New"
    PROVISIONING = "Provisioning"  # waiting in the resource's queue (T_Q_pilot)
    ACTIVE = "Active"
    #: grace period: heartbeats missed but below the failure threshold —
    #: the pilot is non-placeable (schedulers route around it, its agent
    #: stops pulling new work) while in-flight CUs drain; a fresh heartbeat
    #: returns it to ACTIVE, continued silence hardens it to FAILED
    SUSPECT = "Suspect"
    DONE = "Done"
    FAILED = "Failed"
    CANCELED = "Canceled"

    TERMINAL = (DONE, FAILED, CANCELED)
    #: states a scheduler may bind new work to
    PLACEABLE = (NEW, PROVISIONING, ACTIVE)

#: shared hash of per-pilot heartbeat timestamps — ONE ``hgetall`` reads
#: every pilot's liveness (the HeartbeatMonitor's per-tick scan is a single
#: hash-field scan instead of O(pilots) record reads)
HEARTBEATS_KEY = "heartbeats"


@dataclasses.dataclass
class RuntimeContext:
    """Shared runtime plumbing handed to pilots/agents/services."""

    store: CoordinationStore
    topology: Topology
    #: scale simulated delays into real sleeps (0.0 = don't sleep at all;
    #: tests run at 0, demos can use e.g. 1e-3 to watch dynamics)
    time_scale: float = 0.0
    #: agent poll interval
    poll_s: float = 0.01
    #: in-process object table: id -> live DataUnit/ComputeUnit/Pilot objects
    #: (authoritative *state* stays in the coordination store; the table is
    #: how a single-process deployment resolves handles, and is rebuildable
    #: from the store on reconnect)
    objects: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: attached lazily by services (avoids an import cycle)
    transfer_service: Optional[Any] = None
    #: data management mode (§4.2): "pull" = agent stages inputs before the
    #: CU runs; "push" = the manager pre-stages at scheduling time
    data_mode: str = "pull"
    #: topology label of the submission host — ingest transfers (DU local
    #: buffer → first PD) are costed over this uplink when set
    submission_label: Optional[str] = None
    #: attached lazily by the TierManager (avoids an import cycle): owns
    #: tier classification, access stats, and quota-driven eviction
    tier_manager: Optional[Any] = None
    #: attached lazily by the AdmissionController (avoids an import
    #: cycle): per-tenant QoS gate between CU release and placement
    admission: Optional[Any] = None
    #: attached lazily alongside the admission controller: tenant
    #: identities, quotas, and fair-share usage accounting
    tenant_registry: Optional[Any] = None

    def sleep_sim(self, sim_seconds: float) -> None:
        if self.time_scale > 0 and sim_seconds > 0:
            time.sleep(sim_seconds * self.time_scale)

    def lookup(self, obj_id: str) -> Any:
        if obj_id not in self.objects:
            raise KeyError(f"unknown object id {obj_id!r}")
        return self.objects[obj_id]

    def register(self, obj: Any) -> Any:
        self.objects[obj.id] = obj
        return obj


# ---------------------------------------------------------------- Pilot-Data
@dataclasses.dataclass
class PilotDataDescription:
    """JSON-able PD description: where (backend URL + affinity) and how much."""

    service_url: str  # e.g. "sharedfs://cluster:pod0/scratch"
    affinity: str  # topology label, e.g. "cluster:pod0"
    size_quota: int = 1 << 40  # bytes
    name: str = ""
    #: explicit storage-tier override ("dram-cache" / "node-local" /
    #: "site-shared" / "archival"); empty = derive from the backend's
    #: scheme/profile (see repro.core.tiering.classify_tier)
    tier: str = ""

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class QuotaExceeded(RuntimeError):
    pass


class PilotData:
    """An allocated storage container holding DU replicas, chunk-granular.

    The physical representation is the DU's *chunk* stream: each held
    chunk is stored under the key ``<du_id>/.c/<index>`` (see
    :func:`repro.backends.base.chunk_key`); the DU-internal hierarchical
    file namespace is reassembled on read from the chunk ranges recorded
    in the DU manifest.  A PD may hold any subset of a DU's chunks — a
    *partial replica* — and still serve those chunks as a transfer source;
    it is promoted into the DU's ``locations`` only once it covers every
    chunk.
    """

    def __init__(
        self,
        description: PilotDataDescription,
        ctx: RuntimeContext,
        pd_id: Optional[str] = None,
    ):
        self.id = pd_id or _next_id("pd")
        self.description = description
        self.ctx = ctx
        self.backend: StorageAdaptor = make_backend(description.service_url)
        self.affinity = description.affinity
        ctx.topology.ensure(self.affinity)
        self._lock = threading.RLock()
        self._used = 0
        #: bytes admitted by in-flight writes, not yet accounted — the
        #: check-and-reserve admission that keeps racing stagers from
        #: jointly overshooting the quota
        self._reserved = 0
        self._dus: Dict[str, int] = {}  # du_id -> bytes held
        self._du_chunks: Dict[str, set] = {}  # du_id -> held chunk indices
        self._du_total: Dict[str, int] = {}  # du_id -> total chunks in DU
        #: DU handles seen by put/copy — lets chunk-range reads resolve the
        #: manifest even for DUs never registered in ctx.objects (e.g.
        #: partition_du/merge_dus outputs staged directly into a PD)
        self._du_objs: Dict[str, DataUnit] = {}
        ctx.store.hset(f"pd:{self.id}", "state", PilotState.ACTIVE)
        ctx.store.hset(f"pd:{self.id}", "affinity", self.affinity)
        ctx.store.hset(f"pd:{self.id}", "url", description.service_url)
        ctx.store.hset(f"pd:{self.id}", "dus", [])

    @property
    def url(self) -> str:
        return f"pd://{self.id}"

    @property
    def state(self) -> str:
        return self.ctx.store.hget(f"pd:{self.id}", "state", PilotState.NEW)

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used

    @property
    def free_bytes(self) -> int:
        return self.description.size_quota - self.used_bytes

    def du_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._dus)

    def du_bytes(self) -> Dict[str, int]:
        """Accounting snapshot: du_id -> bytes this PD holds for it (the
        per-tenant resident-byte quotas sum these across live PDs)."""
        with self._lock:
            return dict(self._dus)

    def has_du(self, du_id: str) -> bool:
        """True iff this PD holds a FULL replica (every chunk) of the DU.

        For a streaming DU the accounting snapshot (``_du_total`` at last
        write) can lag the growing chunk table, so the live DU handle is
        consulted instead — a holder that covered the stream a moment ago
        is not "full" once the producer appends more."""
        with self._lock:
            if du_id not in self._du_chunks:
                return False
            held = len(self._du_chunks[du_id])
            total = self._du_total.get(du_id, 0)
            du = self._du_objs.get(du_id)
        if du is None:
            du = self.ctx.objects.get(du_id)
        if du is not None and du.streaming:
            total = du.n_chunks
        return held >= total

    def chunks_held(self, du_id: str) -> List[int]:
        with self._lock:
            return sorted(self._du_chunks.get(du_id, ()))

    def fetch_du_chunk(self, du_id: str, index: int) -> bytes:
        """Raw bytes of one locally-held chunk (streaming consumers read
        chunkwise as the producer publishes)."""
        with self._lock:
            if index not in self._du_chunks.get(du_id, ()):
                raise KeyError(
                    f"{self.url} holds no chunk {index} of du://{du_id}"
                )
        return self.backend.get(chunk_key(du_id, index))

    def missing_chunks(self, du: DataUnit) -> List[int]:
        """Chunk indices of ``du`` this PD does not hold yet."""
        with self._lock:
            held = self._du_chunks.get(du.id, set())
        return [i for i in range(du.n_chunks) if i not in held]

    # ------------------------------------------------------------- content
    def _reserve_space(self, du: DataUnit, nbytes: int) -> int:
        """Atomically admit ``nbytes`` against the quota (check-and-reserve
        under the lock, so racing stagers cannot jointly overshoot), with
        tier-aware eviction: when the write would exceed ``size_quota``
        the TierManager reclaims *redundant* chunk replicas (policy-
        ordered, invariant-guarded) and admission retries; only when
        eviction frees nothing does ``QuotaExceeded`` surface.  The caller
        must pair with :meth:`_release_reservation` once accounted."""
        while True:
            with self._lock:
                avail = self.description.size_quota - self._used - self._reserved
                if nbytes <= avail:
                    self._reserved += nbytes
                    return nbytes
                need = nbytes - avail
            tm = self.ctx.tier_manager
            freed = (
                tm.make_room(
                    self,
                    need,
                    exclude_du=du.id,
                    # requestor identity: a tenant's pressure reclaims its
                    # OWN redundant chunks before touching anyone else's
                    tenant=getattr(du.description, "tenant", None),
                )
                if tm is not None
                else 0
            )
            with self._lock:
                avail = self.description.size_quota - self._used - self._reserved
                if nbytes <= avail:
                    self._reserved += nbytes
                    return nbytes
            if freed <= 0:
                raise QuotaExceeded(
                    f"{self.url}: need {nbytes}B, free {avail}B"
                )
            # eviction made progress but not enough yet: try another round

    def _release_reservation(self, nbytes: int) -> None:
        with self._lock:
            self._reserved = max(0, self._reserved - nbytes)

    def _put_chunk_bytes(self, key: str, data: bytes) -> None:
        """Idempotent chunk write: chunk content is immutable (checksummed
        in the DU manifest), so a key that already holds the right bytes —
        an eviction-race re-plan, or a write-once object store revisited —
        is kept as-is.  A mismatching key (stale file from a previous run
        on a persistent filesystem backend) is replaced."""
        if self.backend.exists(key):
            try:
                if self.backend.get(key) == data:
                    return
            except Exception:
                pass
            self.backend.delete(key)
        self.backend.put(key, data)

    def _account_chunks(
        self, du: DataUnit, indices: List[int], register: bool
    ) -> int:
        """Record newly-held chunks; returns bytes newly accounted (chunks
        already held are not double-counted, so racing stagers stay
        consistent).  A PD marked FAILED (its pilot died and recovery
        purged it) records nothing: a dying agent's still-running stage-in
        must not re-register the dead sandbox as a replica holder."""
        if self.state == PilotState.FAILED:
            return 0
        chunks = du.chunks
        with self._lock:
            held = self._du_chunks.setdefault(du.id, set())
            new = [i for i in indices if i not in held]
            nbytes = sum(chunks[i].size for i in new)
            held.update(new)
            self._du_total[du.id] = len(chunks)
            self._du_objs[du.id] = du
            self._dus[du.id] = self._dus.get(du.id, 0) + nbytes
            self._used += nbytes
            self.ctx.store.hset(f"pd:{self.id}", "dus", sorted(self._dus))
        if register:
            du._add_chunks(self.id, indices)
        return nbytes

    def put_chunks(
        self, du: DataUnit, indices: List[int], register: bool = True
    ) -> int:
        """Materialize a subset of a DU's chunks from its in-process buffer
        into this PD.  Returns bytes written.  ``register=False`` stores the
        chunks without reporting this PD as a holder to the DU (transient
        per-CU sandbox staging — the paper's PD-less naive mode)."""
        chunks = du.chunks
        todo = [i for i in indices if i not in self._du_chunks.get(du.id, set())]
        nbytes = sum(chunks[i].size for i in todo)
        self._reserve_space(du, nbytes)
        try:
            for i in todo:
                self._put_chunk_bytes(chunk_key(du.id, i), du.chunk_data(i))
            self._account_chunks(du, todo, register)
        finally:
            self._release_reservation(nbytes)
        return nbytes

    def put_du(self, du: DataUnit, register: bool = True) -> int:
        """Materialize a DU's full chunk set into this PD (initial staging).
        An empty DU still records a (vacuously full) holding."""
        return self.put_chunks(du, list(range(du.n_chunks)), register=register)

    def copy_chunks_from(
        self,
        du: DataUnit,
        src: "PilotData",
        indices: List[int],
        register: bool = True,
    ) -> int:
        """Copy specific chunks of a DU from another PD (a partial holder
        suffices, as long as it has the requested chunks)."""
        src_held = set(src.chunks_held(du.id))
        missing_at_src = [i for i in indices if i not in src_held]
        if missing_at_src:
            raise KeyError(
                f"{src.url} holds no chunks {missing_at_src} of {du.url}"
            )
        chunks = du.chunks
        todo = [i for i in indices if i not in self._du_chunks.get(du.id, set())]
        nbytes = sum(chunks[i].size for i in todo)
        self._reserve_space(du, nbytes)
        try:
            for i in todo:
                self._put_chunk_bytes(
                    chunk_key(du.id, i), src.backend.get(chunk_key(du.id, i))
                )
            self._account_chunks(du, todo, register)
        finally:
            self._release_reservation(nbytes)
        return nbytes

    def copy_du_from(self, du: DataUnit, src: "PilotData", register: bool = True) -> int:
        """Replicate a DU from another PD into this one: copies the chunks
        this PD is still missing (delta transfer — a partial local holding
        only pays for the remainder)."""
        if not src.has_du(du.id):
            raise KeyError(f"{src.url} holds no replica of {du.url}")
        return self.copy_chunks_from(
            du, src, self.missing_chunks(du), register=register
        )

    def fetch_du_file(self, du_id: str, relpath: str) -> bytes:
        """Reassemble one DU file from the locally-held chunks covering its
        byte range in the canonical stream."""
        du: Optional[DataUnit] = self.ctx.objects.get(du_id) or self._du_objs.get(du_id)
        if du is None:
            raise KeyError(f"{self.url}: unknown DU {du_id!r}")
        start, end = du.file_range(relpath)
        if start == end:
            return b""
        csize = du.chunk_size
        out = bytearray()
        for i in du.chunks_for_file(relpath):
            data = self.backend.get(chunk_key(du_id, i))
            lo = i * csize
            out += data[max(0, start - lo) : max(0, end - lo)]
        return bytes(out)

    def verify_du(self, du: DataUnit) -> bool:
        """Checksum-verify every locally-held chunk against the DU's chunk
        manifest; a full replica must cover and match all chunks."""
        import zlib

        if not self.has_du(du.id):
            return False
        for c in du.chunks:
            data = self.backend.get(chunk_key(du.id, c.index))
            if len(data) != c.size or zlib.crc32(data) != c.checksum:
                return False
        return True

    def evict_chunks(self, du: DataUnit, indices: List[int]) -> int:
        """Drop a subset of a DU's locally-held chunks (quota eviction /
        cache demotion).  Returns bytes freed.

        Bookkeeping stays exact: the chunks leave this PD's accounting and
        the DU's ``du:<id>:chunks`` registry (bumping the location version
        so transfer caches invalidate), and if this PD no longer covers
        every chunk it is demoted from ``locations`` to a partial holder.
        Safety (last-copy / replication-factor / pin / in-flight checks)
        is the TierManager's job — this method only executes the drop.
        """
        chunks = du.chunks
        with self._lock:
            held = self._du_chunks.get(du.id)
            if not held:
                return 0
            todo = sorted(i for i in indices if i in held)
            if not todo:
                return 0
            nbytes = sum(chunks[i].size for i in todo if i < len(chunks))
            held.difference_update(todo)
            self._dus[du.id] = max(0, self._dus.get(du.id, 0) - nbytes)
            self._used = max(0, self._used - nbytes)
            if not held:
                self._dus.pop(du.id, None)
                self._du_chunks.pop(du.id, None)
                self._du_total.pop(du.id, None)
                self._du_objs.pop(du.id, None)
            self.ctx.store.hset(f"pd:{self.id}", "dus", sorted(self._dus))
        for i in todo:
            self.backend.delete(chunk_key(du.id, i))
        du._drop_chunks(self.id, todo)
        return nbytes

    def remove_du(self, du: DataUnit) -> None:
        with self._lock:
            nbytes = self._dus.pop(du.id, 0)
            held = self._du_chunks.pop(du.id, set())
            self._du_total.pop(du.id, None)
            self._du_objs.pop(du.id, None)
            self._used -= nbytes
            self.ctx.store.hset(f"pd:{self.id}", "dus", sorted(self._dus))
        for i in held:
            self.backend.delete(chunk_key(du.id, i))
        du._remove_location(self.id)

    def cancel(self) -> None:
        self.ctx.store.hset(f"pd:{self.id}", "state", PilotState.CANCELED)

    def __repr__(self) -> str:  # pragma: no cover
        return f"<PilotData {self.url} at {self.affinity} dus={len(self._dus)}>"


# ------------------------------------------------------------- Pilot-Compute
@dataclasses.dataclass
class PilotComputeDescription:
    """JSON-able PC description (paper: service URL + process count +
    optional backend-specific attributes)."""

    resource_url: str  # e.g. "sim://cluster:pod0:host0"
    slots: int = 1
    affinity: str = ""  # defaults to the resource_url location part
    #: simulated batch-queue wait before the pilot activates (T_Q_pilot)
    queue_time_s: float = 0.0
    walltime_s: float = float("inf")
    name: str = ""
    #: DRAM budget of the pilot's sandbox PD — the memory tier is finite,
    #: so working sets larger than this churn through quota eviction
    #: instead of growing without bound
    sandbox_quota: int = 1 << 40

    def __post_init__(self) -> None:
        if not self.affinity:
            import urllib.parse

            self.affinity = urllib.parse.urlparse(self.resource_url).netloc

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class PilotCompute:
    """A placeholder allocation of compute slots, run by a Pilot-Agent.

    The agent itself lives in :mod:`repro.core.agent`; this class manages
    lifecycle + the pilot's sandbox PD (paper: "For each Pilot instance a
    sandbox is created").
    """

    def __init__(
        self,
        description: PilotComputeDescription,
        ctx: RuntimeContext,
        pilot_id: Optional[str] = None,
    ):
        from .agent import PilotAgent  # local import to avoid cycle

        self.id = pilot_id or _next_id("pc")
        self.description = description
        self.ctx = ctx
        ctx.topology.ensure(description.affinity)
        self.sandbox = PilotData(
            PilotDataDescription(
                service_url=f"mem://{description.affinity}/sandbox-{self.id}",
                affinity=description.affinity,
                size_quota=description.sandbox_quota,
                name=f"sandbox-{self.id}",
            ),
            ctx,
        )
        st = ctx.store
        st.hset(f"pilot:{self.id}", "state", PilotState.NEW)
        st.hset(f"pilot:{self.id}", "affinity", description.affinity)
        st.hset(f"pilot:{self.id}", "slots", description.slots)
        st.hset(f"pilot:{self.id}", "queue_time_s", description.queue_time_s)
        # sandbox PD id at the top level: recovery must find the dead
        # pilot's replica holdings without a live PilotCompute handle
        st.hset(f"pilot:{self.id}", "sandbox_pd", self.sandbox.id)
        st.hset(HEARTBEATS_KEY, self.id, time.monotonic())
        self.agent = PilotAgent(self, ctx)

    @property
    def url(self) -> str:
        return f"pc://{self.id}"

    @property
    def queue_name(self) -> str:
        """The pilot-specific CU queue (§4.2's two-queue scheme)."""
        return f"queue:pilot:{self.id}"

    @property
    def state(self) -> str:
        return self.ctx.store.hget(f"pilot:{self.id}", "state", PilotState.NEW)

    @property
    def affinity(self) -> str:
        return self.description.affinity

    @property
    def slots(self) -> int:
        return self.description.slots

    def start(self) -> "PilotCompute":
        """Submit the placeholder job; the agent activates after the
        (simulated) queue wait."""
        self.ctx.store.hset(f"pilot:{self.id}", "state", PilotState.PROVISIONING)
        self.agent.start()
        return self

    def cancel(self) -> None:
        self.agent.stop()
        self.ctx.store.hset(f"pilot:{self.id}", "state", PilotState.CANCELED)
        self.ctx.store.hdel(HEARTBEATS_KEY, self.id)

    def fail(self) -> None:
        """Simulate a hard node failure (fault-injection tests).

        Deliberately does NOT touch the coordination store: a crashed node
        cannot report its own death.  The HeartbeatMonitor notices the
        missed heartbeats, marks the pilot FAILED, and re-queues its
        orphaned CUs — exactly the recovery path a real failure takes.
        """
        self.agent.kill()

    def wait_active(self, timeout: float = 30.0) -> str:
        """Block until the pilot activates (or terminates), event-driven on
        the coordination store's keyspace notifications (poll only as a
        coarse fallback)."""
        settled = (PilotState.ACTIVE, *PilotState.TERMINAL)
        return self.ctx.store.wait_field(
            f"pilot:{self.id}",
            "state",
            lambda s: s in settled,
            timeout=timeout,
            default=PilotState.NEW,
        )

    def running_cus(self) -> List[str]:
        return list(self.ctx.store.hget(f"pilot:{self.id}", "running", []))

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"<PilotCompute {self.url} at {self.affinity} "
            f"slots={self.slots} state={self.state}>"
        )
