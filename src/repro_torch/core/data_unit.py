"""Data-Unit: the paper's primary data abstraction (§4.3.2).

"A DU is defined as an immutable container for a logical group of 'affine'
data files ... completely decoupled from its physical location and can be
stored in different kinds of backends ... Replicas of a DU can reside in
different Pilot-Data."

Key semantics implemented here:
  * logical identity: a DU has a location-invariant URL ``du://<id>`` that
    stays valid for its whole lifetime ("a simple and useful notion of
    distributed logical location that from an application's perspective is
    invariant over the lifetime");
  * an application-level hierarchical namespace *within* the DU (relative
    file paths), independent of the backend's namespace (object stores are
    flat — the adaptor encodes);
  * immutability after seal: files can be added while the DU is NEW; once
    sealed (first successful staging), mutation raises.  The seal is
    persisted in the coordination store, so *remote* clients attached to
    the same store observe immutability too;
  * **chunk manifest**: the DU's logical content (files concatenated in
    sorted-relpath order) is split into fixed-size chunks with per-chunk
    checksums; files map onto contiguous byte (and therefore chunk)
    ranges.  The chunk is the granularity of the *physical* layer —
    Pilot-Data hold chunk sets, transfers move chunks, and partial
    replicas are first-class — while the logical API (``du://`` URL, file
    namespace, immutability) is untouched;
  * replica set: ``locations`` lists the Pilot-Data holding a FULL replica
    (every chunk); ``chunk_holders`` exposes the per-PD chunk sets
    (including partial holders).  All state is mirrored in the
    coordination store so any client can resolve the DU from anywhere
    (the "distributed namespace").
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import threading
import zlib
from typing import Dict, Iterable, List, Optional, Tuple

from .coordination import CoordinationStore

#: physical chunk size (bytes).  Small enough that the multi-MB simulated
#: datasets of the benchmarks split into dozens of chunks (so striping has
#: parallelism to exploit), large enough that checksum bookkeeping stays
#: negligible for the KB-scale DUs the tests use.
DEFAULT_CHUNK_SIZE = 64 * 1024


class DUState:
    NEW = "New"
    PENDING = "Pending"  # staging to first PD in flight
    READY = "Ready"  # >= 1 full replica materialized; sealed
    #: every replica was lost (pilot churn) and the runtime is rebuilding
    #: the content — by re-ingesting the local buffer or by re-running the
    #: recorded producer CU (lineage recomputation); consumers re-park on
    #: the DU until it re-seals
    RECOVERING = "Recovering"
    FAILED = "Failed"
    DELETED = "Deleted"


_ids = itertools.count()
_ids_lock = threading.Lock()


def _next_id(prefix: str) -> str:
    with _ids_lock:
        return f"{prefix}-{next(_ids):06d}"


@dataclasses.dataclass(frozen=True)
class ChunkInfo:
    """One fixed-size slice of the DU's canonical byte stream."""

    index: int
    size: int
    checksum: int  # crc32 of the chunk's bytes


@dataclasses.dataclass
class DataUnitDescription:
    """JSON-able description (paper: DUD objects 'defined in the JSON
    format')."""

    name: str = ""
    #: initial content: relative path -> bytes
    files: Dict[str, bytes] = dataclasses.field(default_factory=dict)
    #: affinity constraint label (subtree of the topology) or None
    affinity: Optional[str] = None
    #: size hint for placement when content is produced later (output DUs)
    size_hint: int = 0
    #: physical chunking granularity for this DU's replicas
    chunk_size: int = DEFAULT_CHUNK_SIZE
    #: minimum number of live FULL replicas the runtime keeps for this DU;
    #: the ReplicaManager re-replicates (chunk-striped, failure-domain-
    #: aware) whenever pilot churn drops holdings below this
    replication_factor: int = 1
    #: streaming mode: the producer publishes chunks incrementally (ordered
    #: ``published`` prefix events on the store stream) and consumers may be
    #: released on a chunk *prefix* instead of the seal
    streaming: bool = False
    #: readiness threshold for streaming consumers: release waiters once
    #: this many chunks are published (``first_k_chunks`` mode)
    ready_chunks: int = 1
    #: alternative threshold as a fraction of the expected chunk count
    #: (derived from ``size_hint``/``chunk_size``); overrides ``ready_chunks``
    #: when set and a size hint is available
    ready_fraction: Optional[float] = None
    #: owning tenant (multi-tenant QoS: sandbox-byte quotas and
    #: tenant-aware eviction); "default" = unlimited/neutral
    tenant: str = "default"

    def to_json(self) -> Dict:
        return {
            "name": self.name,
            "tenant": self.tenant,
            "files": sorted(self.files),
            "affinity": self.affinity,
            "size_hint": self.size_hint,
            "chunk_size": self.chunk_size,
            "replication_factor": self.replication_factor,
            "streaming": self.streaming,
            "ready_chunks": self.ready_chunks,
            "ready_fraction": self.ready_fraction,
        }

    def resolved_ready_chunks(self) -> int:
        """The readiness threshold in whole chunks (``ready_fraction`` is
        resolved against the expected chunk count from ``size_hint``)."""
        if self.ready_fraction is not None and self.size_hint > 0:
            expected = max(1, math.ceil(self.size_hint / self.chunk_size))
            return max(1, math.ceil(self.ready_fraction * expected))
        return max(1, int(self.ready_chunks))


class DataUnit:
    """A logical, immutable, replicable group of files."""

    def __init__(
        self,
        description: DataUnitDescription,
        store: CoordinationStore,
        du_id: Optional[str] = None,
    ):
        if description.chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        self.id = du_id or _next_id("du")
        self.description = description
        self._store = store
        self._lock = threading.RLock()
        self._files: Dict[str, bytes] = dict(description.files)
        self._manifest: Dict[str, int] = {
            k: len(v) for k, v in self._files.items()
        }
        self._checksums: Dict[str, int] = {
            k: zlib.crc32(v) for k, v in self._files.items()
        }
        #: streaming flag is immutable for the DU's lifetime — cache it so
        #: the hot chunking paths never round-trip through the store
        self._streaming = bool(description.streaming)
        #: canonical stream order.  Sealed-at-once DUs use sorted-relpath
        #: order (deterministic regardless of insertion order); streaming
        #: DUs use *append* order — chunk ``i`` must be final the moment it
        #: is published, which sorted order cannot guarantee.
        self._file_order: List[str] = sorted(self._files)
        #: chunk table is recomputed lazily after mutations (adding N files
        #: would otherwise re-chunk the whole stream N times)
        self._chunks: List[ChunkInfo] = []
        self._file_ranges: Dict[str, Tuple[int, int]] = {}
        #: sorted (stream offset, relpath) pairs for chunk_data bisection
        self._file_offsets: List[Tuple[int, str]] = []
        self._offset_keys: List[int] = []
        self._chunks_dirty = True
        #: bumped on every replica/chunk-set change; replica-resolution
        #: caches key their entries on (du id, this counter) and so
        #: self-invalidate
        self._loc_version = 0
        prior = store.hgetall(f"du:{self.id}") if du_id is not None else {}
        if prior.get("state") is not None:
            # Re-attach to an existing DU record (reconnect semantics): the
            # store is authoritative — adopt its manifest/chunks/seal
            # instead of resetting them, so a second client's handle cannot
            # wipe the persisted seal or the replica bookkeeping.
            if self._files:
                if prior.get("sealed", False):
                    raise RuntimeError(
                        f"du://{self.id} is sealed; cannot re-create it "
                        f"with new content"
                    )
            else:
                description.chunk_size = prior.get(
                    "chunk_size", description.chunk_size
                )
                description.replication_factor = prior.get(
                    "replication_factor", description.replication_factor
                )
                self._manifest = dict(prior.get("manifest", {}))
                self._checksums = dict(prior.get("checksums", {}))
                self._streaming = bool(prior.get("streaming", False))
                description.streaming = self._streaming
                self._file_order = list(
                    prior.get("file_order", None) or sorted(self._manifest)
                )
                self._chunks = [
                    ChunkInfo(index=i, size=s, checksum=c)
                    for i, (s, c) in enumerate(prior.get("chunks", []))
                ]
                self._compute_file_ranges()
                self._chunks_dirty = False
            return
        store.hset(f"du:{self.id}", "state", DUState.NEW)
        store.hset(f"du:{self.id}", "name", description.name)
        store.hset(f"du:{self.id}", "affinity", description.affinity)
        # tenant is read store-side (eviction ordering, byte accounting,
        # transfer attribution) so no live handle is ever required
        store.hset(f"du:{self.id}", "tenant", description.tenant)
        store.hset(f"du:{self.id}", "locations", [])
        store.hset(f"du:{self.id}", "manifest", dict(self._manifest))
        store.hset(f"du:{self.id}", "checksums", dict(self._checksums))
        store.hset(f"du:{self.id}", "sealed", False)
        store.hset(f"du:{self.id}", "chunk_size", description.chunk_size)
        store.hset(
            f"du:{self.id}", "replication_factor",
            description.replication_factor,
        )
        if self._streaming:
            store.hset(f"du:{self.id}", "streaming", True)
            store.hset(f"du:{self.id}", "published", 0)
            store.hset(
                f"du:{self.id}", "ready_chunks",
                description.resolved_ready_chunks(),
            )
            store.hset(f"du:{self.id}", "file_order", list(self._file_order))
        self._ensure_chunks()

    # ------------------------------------------------------------- identity
    @property
    def url(self) -> str:
        """Location-invariant logical URL (single-level namespace, §4 cap. 3)."""
        return f"du://{self.id}"

    @property
    def state(self) -> str:
        return self._store.hget(f"du:{self.id}", "state", DUState.NEW)

    @property
    def locations(self) -> List[str]:
        """Pilot-Data ids currently holding a FULL replica (every chunk).

        Partial holders — PDs with some but not all chunks — are visible
        through :meth:`chunk_holders` instead.
        """
        return list(self._store.hget(f"du:{self.id}", "locations", []))

    @property
    def manifest(self) -> Dict[str, int]:
        return dict(self._manifest)

    @property
    def size(self) -> int:
        return sum(self._manifest.values())

    @property
    def affinity(self) -> Optional[str]:
        return self.description.affinity

    @property
    def locations_version(self) -> int:
        with self._lock:
            return self._loc_version

    @property
    def replication_factor(self) -> int:
        return int(
            self._store.hget(
                f"du:{self.id}", "replication_factor",
                self.description.replication_factor,
            )
        )

    def checksum(self, relpath: str) -> int:
        return self._checksums[relpath]

    # ------------------------------------------------------------- chunking
    def _order(self) -> List[str]:
        """Relpaths in canonical stream order: append order for streaming
        DUs (published chunk prefixes must stay byte-stable), sorted
        otherwise."""
        if self._streaming:
            return list(self._file_order)
        return sorted(self._manifest)

    def _compute_file_ranges(self) -> None:
        """(Re)derive per-file byte ranges + the bisection index from the
        manifest (called under the lock or during construction)."""
        ranges: Dict[str, Tuple[int, int]] = {}
        offsets: List[Tuple[int, str]] = []
        off = 0
        for rel in self._order():
            n = self._manifest[rel]
            ranges[rel] = (off, off + n)
            offsets.append((off, rel))
            off += n
        self._file_ranges = ranges
        self._file_offsets = offsets
        self._offset_keys = [o for o, _ in offsets]

    def _ensure_chunks(self) -> None:
        """Recompute the chunk table from the canonical stream (files
        concatenated in sorted-relpath order) and mirror it to the store."""
        with self._lock:
            if not self._chunks_dirty:
                return
            csize = self.description.chunk_size
            self._compute_file_ranges()
            chunks: List[ChunkInfo] = []
            stream = b"".join(
                self._files.get(rel, b"") for rel in self._order()
            )
            for i in range(0, len(stream), csize):
                piece = stream[i : i + csize]
                chunks.append(
                    ChunkInfo(
                        index=i // csize,
                        size=len(piece),
                        checksum=zlib.crc32(piece),
                    )
                )
            self._chunks = chunks
            self._chunks_dirty = False
            self._store.hset(
                f"du:{self.id}",
                "chunks",
                [[c.size, c.checksum] for c in chunks],
            )

    @property
    def chunk_size(self) -> int:
        return self.description.chunk_size

    @property
    def chunks(self) -> List[ChunkInfo]:
        self._ensure_chunks()
        with self._lock:
            return list(self._chunks)

    @property
    def n_chunks(self) -> int:
        self._ensure_chunks()
        with self._lock:
            return len(self._chunks)

    def chunk_data(self, index: int) -> bytes:
        """Bytes of one chunk, sliced out of the local staging buffer."""
        import bisect

        self._ensure_chunks()
        with self._lock:
            if index < 0 or index >= len(self._chunks):
                raise IndexError(f"{self.url} has no chunk {index}")
            if not self._files and self._manifest:
                raise RuntimeError(
                    f"{self.url}: local buffer dropped; read chunks from a replica"
                )
            csize = self.description.chunk_size
            start, end = index * csize, index * csize + self._chunks[index].size
            # bisect to the first file overlapping the chunk's byte range
            # (a linear scan from file 0 per chunk would make staging
            # O(n_chunks × n_files))
            fi = max(0, bisect.bisect_right(self._offset_keys, start) - 1)
            out = bytearray()
            for lo, rel in self._file_offsets[fi:]:
                if lo >= end:
                    break
                data = self._files[rel]
                hi = lo + len(data)
                if hi > start:
                    out += data[max(0, start - lo) : end - lo]
            return bytes(out)

    def file_range(self, relpath: str) -> Tuple[int, int]:
        """Byte range [start, end) of ``relpath`` in the canonical stream."""
        self._ensure_chunks()
        with self._lock:
            if relpath not in self._file_ranges:
                raise KeyError(f"{self.url} has no file {relpath!r}")
            return self._file_ranges[relpath]

    def chunks_for_file(self, relpath: str) -> List[int]:
        """Chunk indices covering ``relpath`` (empty file → empty list)."""
        start, end = self.file_range(relpath)
        if start == end:
            return []
        csize = self.description.chunk_size
        return list(range(start // csize, (end - 1) // csize + 1))

    # ------------------------------------------------------ chunk holdings
    def chunk_holders(self) -> Dict[str, List[int]]:
        """PD id -> sorted chunk indices held there (partial AND full)."""
        raw = self._store.hgetall(f"du:{self.id}:chunks")
        return {pd: list(idx) for pd, idx in raw.items()}

    def chunks_at(self, pd_id: str) -> List[int]:
        return list(self._store.hget(f"du:{self.id}:chunks", pd_id, []))

    def _add_chunks(self, pd_id: str, indices: Iterable[int]) -> None:
        """Register chunks held by ``pd_id``; promotes the PD into
        ``locations`` once it covers every chunk.  A first physical replica
        (even partial) seals the DU — and the seal is written to the store
        so every client observes it.

        Streaming DUs are the exception: chunk registrations arrive *while
        the producer is still writing*, so they must neither seal the DU
        nor promote a momentarily-complete holder to ``locations``/Ready
        (the chunk table is still growing — "complete" is not final until
        the producer calls :meth:`seal`)."""
        self._ensure_chunks()
        with self._lock:
            held = set(self._store.hget(f"du:{self.id}:chunks", pd_id, []))
            held.update(int(i) for i in indices)
            self._loc_version += 1
            self._store.hset(
                f"du:{self.id}:chunks", pd_id, sorted(held)
            )
            live_stream = self._streaming and not self.sealed
            if len(held) >= len(self._chunks) and not live_stream:
                locs = self.locations
                if pd_id not in locs:
                    locs.append(pd_id)
                    self._store.hset(f"du:{self.id}", "locations", locs)
                self._set_state(DUState.READY)
            if not live_stream:
                self.seal()

    def _add_location(self, pd_id: str) -> None:
        """Register a full replica at ``pd_id`` (all chunks at once)."""
        self._add_chunks(pd_id, range(self.n_chunks))

    def _drop_chunks(self, pd_id: str, indices: Iterable[int]) -> None:
        """Unregister chunks evicted from ``pd_id`` (quota eviction / cache
        demotion).  The location version bumps so resolve/estimate caches
        invalidate, and a holder that no longer covers every chunk is
        demoted from ``locations`` back to a partial holder.  The seal is
        untouched: eviction drops *redundant* replicas, never content."""
        dropped = set(int(i) for i in indices)
        if not dropped:
            return
        self._ensure_chunks()
        with self._lock:
            held = set(self._store.hget(f"du:{self.id}:chunks", pd_id, []))
            held -= dropped
            self._loc_version += 1
            if held:
                self._store.hset(f"du:{self.id}:chunks", pd_id, sorted(held))
            else:
                self._store.hdel(f"du:{self.id}:chunks", pd_id)
            if len(held) < len(self._chunks):
                locs = self.locations
                if pd_id in locs:
                    locs = [loc for loc in locs if loc != pd_id]
                    self._store.hset(f"du:{self.id}", "locations", locs)

    def _remove_location(self, pd_id: str) -> None:
        with self._lock:
            locs = [loc for loc in self.locations if loc != pd_id]
            self._loc_version += 1
            self._store.hset(f"du:{self.id}", "locations", locs)
            self._store.hdel(f"du:{self.id}:chunks", pd_id)

    def has_full_coverage(self) -> bool:
        """True iff the union of all registered holders (full AND partial)
        still covers every chunk — i.e. a full replica can be rebuilt by
        striping, no lineage recomputation needed."""
        self._ensure_chunks()
        held: set = set()
        for idxs in self.chunk_holders().values():
            held.update(idxs)
        with self._lock:
            return len(held) >= len(self._chunks)

    def begin_recovery(self) -> None:
        """All replicas of this sealed DU were lost: reopen it for a
        producer re-run (lineage recomputation).

        Clears every holding, un-seals the DU and parks it in
        ``Recovering`` — consumers submitted against it gate on the
        re-seal exactly like they gated on the first materialization.
        Assumes the producer is deterministic (re-runs rewrite the same
        logical content)."""
        with self._lock:
            self._loc_version += 1
            self._store.hset(f"du:{self.id}", "locations", [])
            for pd_id in list(self._store.hgetall(f"du:{self.id}:chunks")):
                self._store.hdel(f"du:{self.id}:chunks", pd_id)
            self._store.hset(f"du:{self.id}", "sealed", False)
            if self._streaming:
                # the re-run streams from scratch; a stale published prefix
                # would release prefix-mode consumers against zero holders
                self._store.hset(f"du:{self.id}", "published", 0)
            self._store.hset(f"du:{self.id}", "state", DUState.RECOVERING)

    # ----------------------------------------------------------- mutation
    def add_file(self, relpath: str, data: bytes) -> None:
        """Add a file to a not-yet-sealed DU (application-level hierarchical
        namespace: ``relpath`` may contain '/')."""
        with self._lock:
            if self.sealed:
                raise RuntimeError(
                    f"{self.url} is immutable (sealed); create a new DU instead"
                )
            if relpath.startswith("/") or ".." in relpath.split("/"):
                raise ValueError(f"bad DU-relative path {relpath!r}")
            if relpath not in self._manifest:
                self._file_order.append(relpath)
            self._files[relpath] = bytes(data)
            self._manifest[relpath] = len(data)
            self._checksums[relpath] = zlib.crc32(data)
            self._chunks_dirty = True
            self._store.hset(f"du:{self.id}", "manifest", dict(self._manifest))
            self._store.hset(f"du:{self.id}", "checksums", dict(self._checksums))
            if self._streaming:
                self._store.hset(
                    f"du:{self.id}", "file_order", list(self._file_order)
                )

    def seal(self) -> None:
        """Freeze the DU.  Persisted to the coordination store so remote
        clients attached to the same store observe immutability too.

        For a streaming DU the seal is the producer's end-of-stream marker:
        it publishes the final chunk count (the trailing partial chunk only
        becomes visible here) and retro-promotes any holder that already
        covers every chunk — promotions that were deliberately withheld
        while the chunk table was still growing."""
        with self._lock:
            self._ensure_chunks()
            if not self._store.hget(f"du:{self.id}", "sealed", False):
                self._store.hset(f"du:{self.id}", "sealed", True)
                if self._streaming:
                    self._promote_full_holders()
                    self.publish_prefix(len(self._chunks))

    @property
    def sealed(self) -> bool:
        return bool(self._store.hget(f"du:{self.id}", "sealed", False))

    # ----------------------------------------------------------- streaming
    @property
    def streaming(self) -> bool:
        """True if this DU publishes chunks incrementally (stream mode)."""
        return self._streaming

    @property
    def published(self) -> int:
        """Length of the published chunk prefix (monotone while one
        producer attempt streams; reset only by :meth:`reset_stream`)."""
        return int(self._store.hget(f"du:{self.id}", "published", 0) or 0)

    @property
    def stream_threshold(self) -> int:
        """Published-chunk count at which prefix-mode consumers release."""
        return int(self._store.hget(f"du:{self.id}", "ready_chunks", 1) or 1)

    def available_chunks(self) -> int:
        """Chunks a consumer may read *now*: the published prefix while the
        stream is live, every chunk once sealed."""
        if not self._streaming or self.sealed:
            return self.n_chunks
        return min(self.published, self.n_chunks)

    def publishable_chunks(self) -> int:
        """Chunks whose bytes are final and may be published: all of them
        once sealed, only the *full* chunks mid-stream (the trailing
        partial chunk may still grow as files are appended)."""
        self._ensure_chunks()
        with self._lock:
            if self.sealed:
                return len(self._chunks)
            return self.size // self.description.chunk_size

    def publish_prefix(self, upto: int) -> int:
        """Advance the published prefix to ``upto`` chunks (monotone; the
        ``published`` hset is the ordered chunk-availability event consumers
        and the DependencyTracker react to).  Returns the new prefix."""
        if not self._streaming:
            raise RuntimeError(f"{self.url} is not a streaming DU")
        with self._lock:
            upto = min(int(upto), self.publishable_chunks())
            cur = self.published
            if upto > cur:
                self._store.hset(f"du:{self.id}", "published", upto)
                return upto
            return cur

    def _promote_full_holders(self) -> None:
        """Promote every holder covering the (now final) chunk table into
        ``locations`` and mark the DU Ready — called under the lock at
        stream seal."""
        n = len(self._chunks)
        locs = self.locations
        changed = False
        for pd_id, idxs in self.chunk_holders().items():
            if len(set(idxs)) >= n and pd_id not in locs:
                locs.append(pd_id)
                changed = True
        if changed or (locs and self.state != DUState.READY):
            self._loc_version += 1
            self._store.hset(f"du:{self.id}", "locations", locs)
        if locs:
            self._set_state(DUState.READY)

    def reset_stream(self) -> None:
        """Roll a *failed producer attempt's* partial stream back to zero
        so the retry re-streams from a clean slate (exactly-once: a losing
        attempt must leave no published chunks behind).

        Clears the logical content (manifest/checksums/file order/chunk
        table) and the published prefix.  Holder registrations for stale
        chunk indices are dropped with a loc-version bump; like lineage
        recomputation, this assumes the producer is deterministic."""
        if not self._streaming:
            raise RuntimeError(f"{self.url} is not a streaming DU")
        with self._lock:
            if self.sealed:
                raise RuntimeError(f"{self.url} is sealed; cannot reset")
            self._files = {}
            self._manifest = {}
            self._checksums = {}
            self._file_order = []
            self._chunks = []
            self._chunks_dirty = True
            self._loc_version += 1
            self._store.hset(f"du:{self.id}", "manifest", {})
            self._store.hset(f"du:{self.id}", "checksums", {})
            self._store.hset(f"du:{self.id}", "file_order", [])
            self._store.hset(f"du:{self.id}", "chunks", [])
            for pd_id in list(self._store.hgetall(f"du:{self.id}:chunks")):
                self._store.hdel(f"du:{self.id}:chunks", pd_id)
            self._store.hset(f"du:{self.id}", "published", 0)

    # -------------------------------------------------------- content access
    def read(self, relpath: str) -> bytes:
        """Read file content from local staging buffer (pre-seal) — replica
        reads go through PilotData.fetch_du_file."""
        with self._lock:
            if relpath not in self._files:
                raise KeyError(f"{self.url} has no staged copy of {relpath!r}")
            return self._files[relpath]

    def iter_files(self):
        with self._lock:
            return list(self._files.items())

    def drop_local_buffer(self) -> None:
        """Release the in-process staging buffer once replicas exist (the DU
        content then lives only in Pilot-Data backends)."""
        with self._lock:
            if not self.locations:
                raise RuntimeError("refusing to drop buffer with no replica")
            self._files = {}

    # ----------------------------------------------------------- state mgmt
    def _set_state(self, state: str) -> None:
        self._store.hset(f"du:{self.id}", "state", state)

    def wait(self, timeout: float = 30.0) -> str:
        """Block until the DU reaches a terminal-or-ready state.

        Event-driven: waits on the coordination store's keyspace
        notifications for this DU's state field (poll only as a coarse
        fallback against missed events)."""
        terminal = (DUState.READY, DUState.FAILED, DUState.DELETED)
        return self._store.wait_field(
            f"du:{self.id}",
            "state",
            lambda s: s in terminal,
            timeout=timeout,
            default=DUState.NEW,
        )

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"<DataUnit {self.url} state={self.state} files={len(self._manifest)} "
            f"bytes={self.size} chunks={self.n_chunks} replicas={len(self.locations)}>"
        )


def partition_du(
    du: DataUnit,
    n_parts: int,
    store: CoordinationStore,
    name: Optional[str] = None,
) -> List[DataUnit]:
    """Partition a DU's files round-robin into ``n_parts`` new DUs.

    Paper §4.1 usage mode 3: "Support common data processing patterns, such
    as data-partitioning, parallel processing and output gathering" — files
    are the partitioning granularity, matching the BWA read-file splits of
    §6.3.
    """
    if n_parts <= 0:
        raise ValueError("n_parts must be positive")
    files = du.iter_files()
    if not files:
        raise RuntimeError(f"{du.url}: no local buffer to partition from")
    parts: List[DataUnit] = []
    base = name or du.description.name or du.id
    for i in range(n_parts):
        desc = DataUnitDescription(
            name=f"{base}.part{i}",
            affinity=du.description.affinity,
            chunk_size=du.description.chunk_size,
        )
        parts.append(DataUnit(desc, store))
    for idx, (relpath, data) in enumerate(sorted(files)):
        parts[idx % n_parts].add_file(relpath, data)
    return parts


def merge_dus(
    dus: List[DataUnit], store: CoordinationStore, name: str = "merged"
) -> DataUnit:
    """Gather pattern: merge several DUs' files into one new DU (output
    gathering).

    The merge propagates the sources' affinity when they all agree (a
    gather of pod0-affine partitions is itself pod0-affine), and verifies
    each copied file against the source's recorded checksum — a corrupted
    staging buffer fails loudly instead of silently poisoning the merged
    DU.  A source whose local buffer was dropped (content only in
    Pilot-Data backends) cannot be merged from here and raises.
    """
    affinities = {du.description.affinity for du in dus}
    affinity = affinities.pop() if len(affinities) == 1 else None
    desc = DataUnitDescription(name=name, affinity=affinity)
    out = DataUnit(desc, store)
    for du in dus:
        files = dict(du.iter_files())
        if du.manifest and not files:
            raise RuntimeError(
                f"{du.url}: local buffer dropped; re-stage from a replica "
                f"before merging"
            )
        for relpath, data in files.items():
            if zlib.crc32(data) != du.checksum(relpath):
                raise RuntimeError(
                    f"{du.url}/{relpath}: checksum mismatch during merge"
                )
            out.add_file(f"{du.id}/{relpath}", data)
    return out
