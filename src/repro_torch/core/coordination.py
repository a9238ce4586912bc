"""Coordination & control store — the framework's externalized state.

The paper (§4.2, "Distributed Coordination and Control Management") keeps the
*complete* state of the framework in a shared in-memory data store (Redis):
pilot/CU/DU descriptions and states, per-pilot and global work queues, and
resource information pushed by agents.  That externalization is what buys the
fault-tolerance story: managers and agents can disconnect and reconnect, the
store can be snapshotted/restarted, and clients survive transient store
failures.

This module is an embedded, thread-safe re-implementation of exactly that
protocol.  It is *not* a toy dict: it supports

  * namespaced key/value and hash records (``set/get/hset/hgetall``),
  * blocking FIFO queues (``push/pop``) — the global CU queue and the
    per-pilot queues of §4.2 map 1:1 onto these,
  * atomic compare-and-set on hash fields (used for exactly-once CU state
    transitions, e.g. straggler-duplicate "first finisher wins"),
  * durability via a JSON write-ahead log (replayable on restart),
  * fault injection (``fail_for``): operations raise
    :class:`CoordinationUnavailable` for a window, so client retry loops can
    be tested (the paper: "agent and manager are able to survive transient
    Redis failures"), and
  * keyspace notifications (``subscribe``/``unsubscribe``): mutating ops
    (``hset``/``hcas``/``push``) publish :class:`StoreEvent` records to
    registered callbacks — the Redis-keyspace-notification analogue that the
    event-driven scheduler reacts to instead of polling.

**Sharded coordination plane.**  The store is partitioned into N lock-striped
shards: every key (``cu:…``/``du:…``/``pilot:…``/``pd:…`` alike) maps to a
stable shard by a CRC of the full key, so the hot namespaces stripe across
all locks instead of funnelling through one.  The properties the schedulers
rely on survive the sharding:

  * **Total event order.**  Events are *sequenced* while the mutating shard
    lock is still held (a single atomic counter guarded by a tiny event
    lock), so ``StoreEvent.seq`` defines a store-wide total order that is
    consistent with per-key mutation order.
  * **Out-of-lock dispatch.**  Delivery moved OFF the mutating thread's
    critical section: sequenced events land on per-subscriber ordered
    delivery queues drained by a dedicated dispatcher thread, which invokes
    callbacks outside every store lock, per subscriber in exact seq order.
    Writers never wait on subscribers; subscribers may re-enter the store
    freely.  Mutators return *before* their event is delivered — consumers
    that need read-your-event determinism (manual-stepping schedulers,
    monitor ticks) call :meth:`flush_events` first.  ``dispatch="inline"``
    restores synchronous delivery (still outside the shard locks, via a
    combining drain that preserves seq order) for legacy-mode comparisons.
  * **Targeted queue wakeups.**  ``pop_any`` waiters register a per-queue
    waiter event and are woken only by pushes to *their* queues — no global
    ``notify_all`` thundering herd, no 50 ms condition poll.
  * **Group-commit WAL.**  Mutations append replay records to an in-memory
    buffer (under the shard lock, so the WAL stays a valid serialization);
    the buffer is flushed to disk outside every shard lock once
    ``wal_batch`` records accumulate, on a short timer, and on ``close()``.
    The replay format is unchanged.
  * **Indexed prefix scans.**  ``keys()``/``hkeys()`` run a bisect range
    scan over per-shard sorted key indexes — O(log n + matches) per shard,
    not O(full keyspace).

The interface is deliberately Redis-shaped so a networked store could be
substituted without touching managers or agents.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import heapq
import json
import os
import queue
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

#: default number of lock stripes — enough to spread cu:/du:/pilot:/pd:
#: traffic from ~100 pilots' worth of agents without measurable per-op cost
DEFAULT_SHARDS = 16

#: default group-commit size: WAL records buffered before a writer flushes
DEFAULT_WAL_BATCH = 256

#: background WAL flusher interval — bounds how stale the on-disk log can be
#: when the write rate stays below ``wal_batch``
WAL_FLUSH_INTERVAL_S = 0.02

#: cap on a single blocked ``pop_any`` wait: bounds how long an injected
#: ``fail_for`` window can go unnoticed by a parked waiter (the per-queue
#: wakeup makes real pushes land instantly; this is only the failure poll)
POP_FAIL_POLL_S = 0.5


class CoordinationUnavailable(RuntimeError):
    """Raised while the store is in an (injected or real) failure window."""


#: debug hook: when set (see repro.analysis.witness), every coordination
#: lock created from then on is wrapped by the runtime lock-order witness
_LOCK_FACTORY: Optional[Callable[..., Any]] = None


def set_lock_factory(factory: Optional[Callable[..., Any]]) -> None:
    """Install a lock factory ``factory(name, reentrant=False)`` used for
    every store lock created afterwards; ``None`` restores plain
    ``threading`` locks.  Existing stores keep the locks they were built
    with."""
    global _LOCK_FACTORY
    _LOCK_FACTORY = factory


def _make_lock(name: str, *, reentrant: bool = False):
    """Single creation point for every coordination-plane mutex, so the
    ``REPRO_LOCK_WITNESS=1`` debug mode can substitute witnessed locks
    that validate the static PD-L005 lock graph against execution."""
    if _LOCK_FACTORY is not None:
        return _LOCK_FACTORY(name, reentrant)
    return threading.RLock() if reentrant else threading.Lock()


@dataclasses.dataclass(frozen=True)
class StoreEvent:
    """One published keyspace notification.

    ``op`` is "hset" (covers hcas winners too) or "push"; ``key`` is the
    hash key or queue name; ``field`` is the hash field (None for pushes);
    ``value`` the new value / pushed item.
    """

    seq: int
    op: str
    key: str
    field: Optional[str]
    value: Any


def _default(obj: Any) -> Any:
    if isinstance(obj, (set, frozenset)):
        return sorted(obj)
    raise TypeError(f"not JSON serializable: {type(obj)}")


class _Shard:
    """One lock stripe: its own kv/hash/queue maps, sorted key indexes for
    bisect prefix scans, per-queue waiter lists, and an op counter."""

    __slots__ = (
        "lock",
        "kv",
        "hashes",
        "queues",
        "kv_index",
        "hash_index",
        "qwaiters",
        "ops",
    )

    def __init__(self) -> None:
        self.lock = _make_lock("_Shard.lock")
        self.kv: Dict[str, Any] = {}
        self.hashes: Dict[str, Dict[str, Any]] = {}
        self.queues: Dict[str, collections.deque] = {}
        #: sorted key lists kept in lockstep with kv/hashes — prefix scans
        #: bisect into these instead of walking the whole keyspace
        self.kv_index: List[str] = []
        self.hash_index: List[str] = []
        #: queue name -> waiter Events parked in pop_any; push() sets
        #: exactly these (targeted wakeup, no cross-queue thundering herd)
        self.qwaiters: Dict[str, List[threading.Event]] = {}
        self.ops = 0

    def scan(self, index: List[str], prefix: str) -> List[str]:
        """Bisect range scan: the keys in ``index`` starting with
        ``prefix``, as a slice copy — both range bounds found by bisect,
        so the stripe lock is held for O(log n + |slice copy|) with no
        per-key Python loop (PD-L006: materialization stays minimal under
        the lock; cross-shard merging happens outside it)."""
        if not prefix:
            return index[:]
        lo = bisect.bisect_left(index, prefix)
        last = prefix[-1]
        if last < "\U0010ffff":
            # upper bound: bump the prefix's final char — every key with
            # this prefix sorts strictly below it
            hi = bisect.bisect_left(index, prefix[:-1] + chr(ord(last) + 1), lo)
        else:  # degenerate max-codepoint prefix: fall back to a walk
            hi = lo
            while hi < len(index) and index[hi].startswith(prefix):
                hi += 1
        return index[lo:hi]


def _index_add(index: List[str], key: str) -> None:
    i = bisect.bisect_left(index, key)
    if i == len(index) or index[i] != key:
        index.insert(i, key)


def _index_drop(index: List[str], key: str) -> None:
    i = bisect.bisect_left(index, key)
    if i < len(index) and index[i] == key:
        del index[i]


class _Subscriber:
    """One registered callback with its ordered delivery queue.

    The dispatcher appends matched events and drains the queue in seq
    order; ``dead`` flips on unsubscribe so queued-but-undelivered events
    are dropped instead of invoking a retired callback."""

    __slots__ = ("prefix", "callback", "pending", "dead")

    def __init__(self, prefix: str, callback: Callable[[StoreEvent], None]):
        self.prefix = prefix
        self.callback = callback
        self.pending: collections.deque = collections.deque()
        self.dead = False

    def deliver(self) -> None:
        while self.pending:
            ev = self.pending.popleft()
            if self.dead:
                continue
            try:
                self.callback(ev)
            except Exception:
                pass  # a broken subscriber must not poison the dispatcher


class CoordinationStore:
    """Thread-safe, optionally durable, Redis-like coordination service.

    ``shards`` selects the number of lock stripes (1 ≈ the legacy global
    lock); ``dispatch`` is "queued" (events delivered by the dispatcher
    thread, mutators never wait) or "inline" (the mutating thread drains
    the event queue synchronously before returning — still outside the
    shard locks); ``wal_batch`` is the group-commit size (1 = flush every
    record, the legacy durability behaviour).
    """

    def __init__(
        self,
        wal_path: Optional[str] = None,
        replay: bool = True,
        *,
        shards: int = DEFAULT_SHARDS,
        dispatch: str = "queued",
        wal_batch: int = DEFAULT_WAL_BATCH,
    ):
        if dispatch not in ("queued", "inline"):
            raise ValueError(f"dispatch must be 'queued' or 'inline': {dispatch!r}")
        self._nshards = max(1, int(shards))
        self._shards = [_Shard() for _ in range(self._nshards)]
        self.dispatch_mode = dispatch
        self._fail_until = 0.0

        # ---- event plane (sequencing + subscription index + dispatcher)
        self._evlock = _make_lock("CoordinationStore._evlock")
        self._ev_cond = threading.Condition(self._evlock)
        self._seq = 0
        #: seq of the newest event actually enqueued for delivery — the
        #: flush_events barrier target (events with no matching subscriber
        #: are sequenced but complete immediately)
        self._enqueued_seq = 0
        self._delivered_seq = 0
        #: pending (event, [matched subscribers]) batches in seq order
        self._ev_pending: collections.deque = collections.deque()
        self._subs: Dict[int, _Subscriber] = {}
        self._sub_next = 0
        #: prefix -> subscriber tokens, plus the multiset of prefix lengths
        #: in use: matching a key is O(distinct prefix lengths) dict probes
        #: instead of a linear scan over every subscriber
        self._sub_prefixes: Dict[str, List[int]] = {}
        self._sub_lengths: collections.Counter = collections.Counter()
        self._dispatcher: Optional[threading.Thread] = None
        self._dispatch_stop = False
        self._inline_lock = _make_lock(
            "CoordinationStore._inline_lock", reentrant=True
        )

        # ---- durability (group-commit WAL)
        self._wal_path = wal_path
        self._wal_file = None
        self._wal_batch = max(1, int(wal_batch))
        self._wal_buf: List[str] = []
        self._wal_lock = _make_lock("CoordinationStore._wal_lock")
        self._wal_file_lock = _make_lock("CoordinationStore._wal_file_lock")
        self._wal_flusher: Optional[threading.Thread] = None
        self._wal_flusher_stop = threading.Event()
        self._op_count = 0
        if wal_path:
            if replay and os.path.exists(wal_path):
                self._replay(wal_path)
            self._wal_file = open(wal_path, "a", encoding="utf-8")
            if self._wal_batch > 1:
                self._wal_flusher = threading.Thread(
                    target=self._wal_flush_loop, name="wal-flusher", daemon=True
                )
                self._wal_flusher.start()

    # ------------------------------------------------------------- sharding
    def _shard_for(self, key: str) -> _Shard:
        """Stable key → stripe map: a CRC of the full key, so cu:/du:/
        pilot:/pd: records spread across every lock while a given key
        always lands on the same shard."""
        if self._nshards == 1:
            return self._shards[0]
        return self._shards[zlib.crc32(key.encode("utf-8")) % self._nshards]

    # ------------------------------------------------------------- failure
    def fail_for(self, seconds: float) -> None:
        """Inject a transient outage: all ops raise until the window ends."""
        self._fail_until = time.monotonic() + seconds

    def _check_up(self, shard: _Shard) -> None:
        """Liveness check + op accounting — called under ``shard``'s lock
        exactly once per public operation."""
        shard.ops += 1
        if time.monotonic() < self._fail_until:
            raise CoordinationUnavailable("coordination store unavailable")

    @property
    def ops_total(self) -> int:
        """Count of store operations issued so far (every public op checks
        liveness exactly once, so this is the op counter the O(changes)
        monitor micro-benchmarks read deltas from).  The sum over per-shard
        counters; int reads are atomic, so no lock is needed."""
        return sum(sh.ops for sh in self._shards)

    # ------------------------------------------------------------ durability
    def _log(self, op: str, *args: Any) -> bool:
        """Append one replay record to the group-commit buffer (called
        under a shard lock).  Returns True when the buffer crossed the
        batch threshold — the caller flushes AFTER releasing the shard
        lock, so file I/O never extends a critical section."""
        with self._wal_lock:
            self._op_count += 1
            if self._wal_file is None:
                return False
            self._wal_buf.append(json.dumps([op, *args], default=_default))
            return len(self._wal_buf) >= self._wal_batch

    def flush_wal(self) -> None:
        """Group-commit: write and flush every buffered WAL record.

        Batches drain in append order (the file lock serializes flushers),
        so the on-disk log remains a valid serialization prefix."""
        with self._wal_file_lock:
            with self._wal_lock:
                buf, self._wal_buf = self._wal_buf, []
            if buf and self._wal_file is not None:
                # reviewed: the file lock exists to serialize exactly this
                # I/O — it is a leaf lock, never taken under a shard or
                # event lock (PD-L005 graph), so holding it across the
                # write stalls only concurrent flushers, by design
                self._wal_file.write("\n".join(buf) + "\n")  # pdlint: disable=PD-L002
                self._wal_file.flush()  # pdlint: disable=PD-L002

    def _wal_flush_loop(self) -> None:
        while not self._wal_flusher_stop.wait(WAL_FLUSH_INTERVAL_S):
            try:
                self.flush_wal()
            except Exception:
                pass  # a closed file mid-shutdown must not kill the flusher

    def _replay(self, path: str) -> None:
        kv: Dict[str, Any] = {}
        hashes: Dict[str, Dict[str, Any]] = collections.defaultdict(dict)
        queues: Dict[str, collections.deque] = collections.defaultdict(
            collections.deque
        )
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    op, *args = json.loads(line)
                except (ValueError, TypeError):
                    # torn tail: a crash mid-group-commit may leave one
                    # partial record — the log is valid up to here
                    break
                if op == "set":
                    kv[args[0]] = args[1]
                elif op == "delete":
                    kv.pop(args[0], None)
                elif op == "hset":
                    hashes[args[0]][args[1]] = args[2]
                elif op == "hdel":
                    hashes.get(args[0], {}).pop(args[1], None)
                elif op == "push":
                    queues[args[0]].append(args[1])
                elif op == "pop":
                    q = queues.get(args[0])
                    if q:
                        q.popleft()
                elif op == "qremove":
                    q = queues.get(args[0])
                    if q and args[1] in q:
                        q.remove(args[1])
        for key, value in kv.items():
            sh = self._shard_for(key)
            sh.kv[key] = value
            _index_add(sh.kv_index, key)
        for key, fields in hashes.items():
            sh = self._shard_for(key)
            sh.hashes[key] = dict(fields)
            _index_add(sh.hash_index, key)
        for name, items in queues.items():
            self._shard_for(name).queues[name] = collections.deque(items)

    def close(self) -> None:
        # stop the dispatcher AFTER draining what is already sequenced, so
        # close() is also an event barrier; late mutations fall back to
        # inline delivery
        self._stop_dispatcher()
        if self._wal_flusher is not None:
            self._wal_flusher_stop.set()
            self._wal_flusher.join(timeout=2.0)
            self._wal_flusher = None
        self.flush_wal()
        with self._wal_file_lock:
            if self._wal_file is not None:
                self._wal_file.close()
                self._wal_file = None

    # -------------------------------------------------------- notifications
    def subscribe(
        self, callback: Callable[[StoreEvent], None], prefix: str = ""
    ) -> int:
        """Register ``callback`` for mutations on keys starting with
        ``prefix``.

        Delivery contract (sharded store): callbacks run on the store's
        dispatcher thread, OUTSIDE every store lock, in exact ``seq``
        order per subscriber.  They may re-enter the store freely, but a
        slow callback delays every later event (one dispatcher drains all
        subscribers), so heavy consumers should still hand off to their
        own queue/thread (see :class:`StoreEventPump`).  Mutating calls
        return before their event is delivered — use :meth:`flush_events`
        when a consumer must observe everything already written.  After
        ``unsubscribe`` returns, queued events are dropped; one callback
        already in flight on the dispatcher may still complete.
        """
        with self._evlock:
            token = self._sub_next
            self._sub_next += 1
            self._subs[token] = _Subscriber(prefix, callback)
            self._sub_prefixes.setdefault(prefix, []).append(token)
            self._sub_lengths[len(prefix)] += 1
            if (
                self.dispatch_mode == "queued"
                and self._dispatcher is None
                and not self._dispatch_stop
            ):
                # lazy: stores that never subscribe never spawn a thread
                self._dispatcher = threading.Thread(
                    target=self._dispatch_loop, name="store-dispatcher", daemon=True
                )
                self._dispatcher.start()
            return token

    def unsubscribe(self, token: int) -> None:
        with self._evlock:
            sub = self._subs.pop(token, None)
            if sub is None:
                return
            sub.dead = True
            tokens = self._sub_prefixes.get(sub.prefix)
            if tokens is not None:
                try:
                    tokens.remove(token)
                except ValueError:
                    pass
                if not tokens:
                    del self._sub_prefixes[sub.prefix]
            self._sub_lengths[len(sub.prefix)] -= 1
            if self._sub_lengths[len(sub.prefix)] <= 0:
                del self._sub_lengths[len(sub.prefix)]

    def _publish(self, op: str, key: str, field: Optional[str], value: Any) -> None:
        """Sequence one mutation and enqueue it for delivery.

        Called while the mutating shard lock is held: the event lock is
        tiny (counter + prefix-index probes + deque append), and taking it
        under the shard lock is what makes ``seq`` order consistent with
        per-key mutation order.  Actual delivery happens outside both."""
        with self._ev_cond:
            if not self._subs:
                return
            self._seq += 1
            matched: List[_Subscriber] = []
            klen = len(key)
            for plen in self._sub_lengths:
                if plen > klen:
                    continue
                for token in self._sub_prefixes.get(key[:plen], ()):
                    matched.append(self._subs[token])
            if not matched:
                return
            ev = StoreEvent(seq=self._seq, op=op, key=key, field=field, value=value)
            self._ev_pending.append((ev, matched))
            self._enqueued_seq = self._seq
            if self.dispatch_mode == "queued" and not self._dispatch_stop:
                self._ev_cond.notify_all()

    def _maybe_dispatch_inline(self) -> None:
        """Inline/fallback delivery: the mutating thread drains the pending
        queue (combining drain: whichever writer holds the drain lock
        delivers everyone's queued events in seq order), AFTER releasing
        its shard lock.  A writer returns only once its own event was
        delivered — by itself or by a concurrent writer."""
        if self.dispatch_mode == "queued" and not self._dispatch_stop:
            return
        with self._inline_lock:
            while True:
                with self._evlock:
                    if not self._ev_pending:
                        break
                    batch = list(self._ev_pending)
                    self._ev_pending.clear()
                for ev, matched in batch:
                    for sub in matched:
                        sub.pending.append(ev)
                        sub.deliver()
                with self._ev_cond:
                    self._delivered_seq = max(self._delivered_seq, batch[-1][0].seq)
                    self._ev_cond.notify_all()

    def _dispatch_loop(self) -> None:
        while True:
            with self._ev_cond:
                while not self._ev_pending and not self._dispatch_stop:
                    self._ev_cond.wait(timeout=0.5)
                if self._dispatch_stop and not self._ev_pending:
                    return
                batch = list(self._ev_pending)
                self._ev_pending.clear()
            for ev, matched in batch:
                for sub in matched:
                    sub.pending.append(ev)
                    sub.deliver()
            with self._ev_cond:
                self._delivered_seq = max(self._delivered_seq, batch[-1][0].seq)
                self._ev_cond.notify_all()

    def _stop_dispatcher(self) -> None:
        with self._ev_cond:
            self._dispatch_stop = True
            self._ev_cond.notify_all()
            dispatcher = self._dispatcher
        if dispatcher is not None:
            dispatcher.join(timeout=2.0)
            self._dispatcher = None
        self._maybe_dispatch_inline()  # anything sequenced after the stop

    def flush_events(self, timeout: float = 5.0) -> bool:
        """Barrier: block until every event sequenced before this call has
        been delivered to its subscribers.  Returns False on timeout.

        This is the determinism hook for consumers that used to rely on
        in-lock synchronous delivery (manual-stepping schedulers, monitor
        ticks, promotion drains): mutate, ``flush_events()``, then read
        the consumer's derived state.  Does not count as a store op.
        Calling it from inside a subscriber callback is a no-op (the
        dispatcher cannot wait on itself)."""
        if threading.current_thread() is self._dispatcher:
            return True
        self._maybe_dispatch_inline()
        deadline = time.monotonic() + timeout
        with self._ev_cond:
            target = self._enqueued_seq
            while self._delivered_seq < target:
                if self._dispatch_stop or self._dispatcher is None:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._ev_cond.wait(remaining)
        return True

    def wait_field(
        self,
        key: str,
        field: str,
        predicate: Callable[[Any], bool],
        timeout: float = 30.0,
        default: Any = None,
        poll_s: float = 0.25,
    ) -> Any:
        """Block until ``predicate(hget(key, field))`` holds, event-driven.

        Subscribes to the key's keyspace notifications and sleeps on an
        Event, so waiters wake on the very mutation instead of burning a
        polling loop; ``poll_s`` bounds each sleep as a coarse fallback
        (covers a notification lost to subscriber races or store restore).
        Returns the field's final value (which may still fail the predicate
        if the timeout elapsed).
        """
        woke = threading.Event()

        def _cb(ev: StoreEvent) -> None:
            if ev.key == key and ev.field == field:
                woke.set()

        token = self.subscribe(_cb, prefix=key)
        try:
            deadline = time.monotonic() + timeout
            while True:
                # clear BEFORE reading: a mutation landing between the read
                # and the wait then re-sets the event and wakes us at once
                woke.clear()
                value = self.hget(key, field, default)
                if predicate(value):
                    return value
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return value
                woke.wait(min(remaining, poll_s))
        finally:
            self.unsubscribe(token)

    # -------------------------------------------------------------- kv ops
    def set(self, key: str, value: Any) -> None:
        sh = self._shard_for(key)
        with sh.lock:
            self._check_up(sh)
            if key not in sh.kv:
                _index_add(sh.kv_index, key)
            sh.kv[key] = value
            flush = self._log("set", key, value)
        if flush:
            self.flush_wal()

    def get(self, key: str, default: Any = None) -> Any:
        sh = self._shard_for(key)
        with sh.lock:
            self._check_up(sh)
            return sh.kv.get(key, default)

    def delete(self, key: str) -> None:
        sh = self._shard_for(key)
        with sh.lock:
            self._check_up(sh)
            if key in sh.kv:
                del sh.kv[key]
                _index_drop(sh.kv_index, key)
            flush = self._log("delete", key)
        if flush:
            self.flush_wal()

    def keys(self, prefix: str = "") -> List[str]:
        """Keys starting with ``prefix``, sorted — a bisect range scan per
        shard merged across shards: O(shards·log n + matches).  Only the
        per-shard slice copy happens under each stripe lock; the K-way
        merge of the already-sorted slices runs lock-free (PD-L006)."""
        parts: List[List[str]] = []
        for i, sh in enumerate(self._shards):
            with sh.lock:
                if i == 0:
                    self._check_up(sh)
                parts.append(sh.scan(sh.kv_index, prefix))
        return list(heapq.merge(*parts))

    # ------------------------------------------------------------ hash ops
    def hset(self, key: str, field: str, value: Any) -> None:
        sh = self._shard_for(key)
        with sh.lock:
            self._check_up(sh)
            h = sh.hashes.get(key)
            if h is None:
                h = sh.hashes[key] = {}
                _index_add(sh.hash_index, key)
            h[field] = value
            flush = self._log("hset", key, field, value)
            self._publish("hset", key, field, value)
        if flush:
            self.flush_wal()
        self._maybe_dispatch_inline()

    def hget(self, key: str, field: str, default: Any = None) -> Any:
        sh = self._shard_for(key)
        with sh.lock:
            self._check_up(sh)
            return sh.hashes.get(key, {}).get(field, default)

    def hgetall(self, key: str) -> Dict[str, Any]:
        sh = self._shard_for(key)
        with sh.lock:
            self._check_up(sh)
            return dict(sh.hashes.get(key, {}))

    def hdel(self, key: str, field: str) -> None:
        sh = self._shard_for(key)
        with sh.lock:
            self._check_up(sh)
            sh.hashes.get(key, {}).pop(field, None)
            flush = self._log("hdel", key, field)
        if flush:
            self.flush_wal()

    def hcas(self, key: str, field: str, expect: Any, value: Any) -> bool:
        """Atomic compare-and-set on a hash field.

        Returns True iff the field currently equals ``expect`` (and was set).
        This is the primitive behind exactly-once CU completion when
        straggler duplicates race (§ fault tolerance).  Atomicity is per
        key, which the shard lock provides — a key never spans shards.
        """
        sh = self._shard_for(key)
        with sh.lock:
            self._check_up(sh)
            h = sh.hashes.get(key)
            cur = None if h is None else h.get(field)
            if cur != expect:
                return False
            if h is None:
                h = sh.hashes[key] = {}
                _index_add(sh.hash_index, key)
            h[field] = value
            flush = self._log("hset", key, field, value)
            self._publish("hset", key, field, value)
        if flush:
            self.flush_wal()
        self._maybe_dispatch_inline()
        return True

    def hkeys(self, prefix: str = "") -> List[str]:
        """Hash keys starting with ``prefix``, sorted — bisect range scan
        per shard, O(shards·log n + matches) (the HeartbeatMonitor /
        StragglerMitigator O(changes) contract rides on this).  Slice
        copies under the stripe locks, lock-free merge (PD-L006)."""
        parts: List[List[str]] = []
        for i, sh in enumerate(self._shards):
            with sh.lock:
                if i == 0:
                    self._check_up(sh)
                parts.append(sh.scan(sh.hash_index, prefix))
        return list(heapq.merge(*parts))

    # ----------------------------------------------------------- queue ops
    def push(self, queue: str, item: Any) -> None:
        sh = self._shard_for(queue)
        with sh.lock:
            self._check_up(sh)
            dq = sh.queues.get(queue)
            if dq is None:
                dq = sh.queues[queue] = collections.deque()
            dq.append(item)
            flush = self._log("push", queue, item)
            # targeted wakeup: only waiters parked on THIS queue
            for waiter in sh.qwaiters.get(queue, ()):
                waiter.set()
            self._publish("push", queue, None, item)
        if flush:
            self.flush_wal()
        self._maybe_dispatch_inline()

    def pop(self, queue: str, timeout: float = 0.0) -> Optional[Any]:
        """Pop from one queue, blocking up to ``timeout`` seconds."""
        return self.pop_any([queue], timeout)

    def pop_any(self, queues: List[str], timeout: float = 0.0) -> Optional[Any]:
        """Pop the first available item from an ordered list of queues.

        An agent pulls from (its own pilot queue, the global queue) — §4.2:
        "Each Pilot-Agent generally pulls from two queues: its agent-specific
        queue and a global queue."

        Blocked callers park on a per-queue waiter event and are woken by
        the exact push (no store-wide ``notify_all``, no 50 ms poll), so an
        idle agent issues ~zero store ops while parked — one liveness
        check per wakeup pass, charged to the first queue's shard.
        """
        deadline = time.monotonic() + timeout
        waiter: Optional[threading.Event] = None
        registered: List[Tuple[_Shard, str]] = []
        try:
            while True:
                if waiter is not None:
                    waiter.clear()
                first = True
                for q in queues:
                    sh = self._shard_for(q)
                    with sh.lock:
                        if first:
                            # one liveness check + op per pass, like the
                            # legacy loop — but passes are now O(pushes)
                            self._check_up(sh)
                            first = False
                        dq = sh.queues.get(q)
                        if dq:
                            item = dq.popleft()
                            flush = self._log("pop", q)
                        else:
                            continue
                    if flush:
                        self.flush_wal()
                    return item
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                if waiter is None:
                    # register FIRST, then re-check before waiting: a push
                    # landing between the check and the wait sets the
                    # event, so the wakeup cannot be lost
                    waiter = threading.Event()
                    for q in queues:
                        sh = self._shard_for(q)
                        with sh.lock:
                            sh.qwaiters.setdefault(q, []).append(waiter)
                            registered.append((sh, q))
                    continue
                waiter.wait(min(remaining, POP_FAIL_POLL_S))
        finally:
            if waiter is not None:
                for sh, q in registered:
                    with sh.lock:
                        lst = sh.qwaiters.get(q)
                        if lst is not None:
                            try:
                                lst.remove(waiter)
                            except ValueError:
                                pass
                            if not lst:
                                del sh.qwaiters[q]

    def qlen(self, queue: str) -> int:
        sh = self._shard_for(queue)
        with sh.lock:
            self._check_up(sh)
            return len(sh.queues.get(queue, ()))

    def qpeek(self, queue: str) -> List[Any]:
        sh = self._shard_for(queue)
        with sh.lock:
            self._check_up(sh)
            return list(sh.queues.get(queue, ()))

    def qremove(self, queue: str, item: Any) -> bool:
        sh = self._shard_for(queue)
        flush = False
        try:
            with sh.lock:
                self._check_up(sh)
                dq = sh.queues.get(queue)
                if dq and item in dq:
                    dq.remove(item)
                    flush = self._log("qremove", queue, item)
                    return True
                return False
        finally:
            if flush:
                self.flush_wal()

    # ----------------------------------------------------------- snapshot
    def _lock_all(self) -> None:
        # reviewed: stripes are acquired in ascending index order (and
        # _unlock_all releases in reverse), so the same-class nesting the
        # static analyzer cannot order-prove is in fact deadlock-free
        for sh in self._shards:
            sh.lock.acquire()  # pdlint: disable=PD-L005

    def _unlock_all(self) -> None:
        for sh in reversed(self._shards):
            sh.lock.release()

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time copy of the full store (all shard locks held in
        index order for a consistent cut)."""
        self._lock_all()
        try:
            kv: Dict[str, Any] = {}
            hashes: Dict[str, Dict[str, Any]] = {}
            queues: Dict[str, List[Any]] = {}
            for sh in self._shards:
                kv.update(sh.kv)
                for k, v in sh.hashes.items():
                    hashes[k] = dict(v)
                for k, v in sh.queues.items():
                    queues[k] = list(v)
            return {"kv": kv, "hashes": hashes, "queues": queues}
        finally:
            self._unlock_all()

    def restore(self, snap: Dict[str, Any]) -> None:
        self._lock_all()
        try:
            waiters: List[threading.Event] = []
            for sh in self._shards:
                for lst in sh.qwaiters.values():
                    waiters.extend(lst)
                sh.kv = {}
                sh.hashes = {}
                sh.queues = {}
                sh.kv_index = []
                sh.hash_index = []
            for key, value in snap["kv"].items():
                sh = self._shard_for(key)
                sh.kv[key] = value
                _index_add(sh.kv_index, key)
            for key, fields in snap["hashes"].items():
                sh = self._shard_for(key)
                sh.hashes[key] = dict(fields)
                _index_add(sh.hash_index, key)
            for name, items in snap["queues"].items():
                self._shard_for(name).queues[name] = collections.deque(items)
            # parked pop_any waiters must re-check against the new state
            for waiter in waiters:
                waiter.set()
        finally:
            self._unlock_all()


class StoreEventPump:
    """Subscribe → handoff queue → one daemon consumer thread.

    The subscriber contract (callbacks run on the store's dispatcher
    thread, outside the store locks, but a slow callback delays every
    later event) makes this the canonical consumption pattern for heavy
    consumers — the dependency gate and the future dispatcher both ride
    it.  ``accept`` filters on the dispatcher thread (cheap predicate
    only); ``handler`` runs accepted events on the pump thread and may
    block or re-enter the store freely.  ``inject`` enqueues a synthetic
    event, serializing caller-side re-checks with the live stream.
    """

    def __init__(
        self,
        store: "CoordinationStore",
        handler: Callable[[StoreEvent], None],
        prefix: str = "",
        accept: Optional[Callable[[StoreEvent], bool]] = None,
        name: str = "store-event-pump",
    ):
        self._store = store
        self._handler = handler
        self._accept = accept
        self._events: "queue.Queue[StoreEvent]" = queue.Queue()
        self._stop = threading.Event()
        self._token = store.subscribe(self._on_event, prefix=prefix)
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)
        self._thread.start()

    def _on_event(self, ev: StoreEvent) -> None:
        if self._accept is None or self._accept(ev):
            self._events.put(ev)

    def inject(self, ev: StoreEvent) -> None:
        """Queue a synthetic event (bypasses ``accept``)."""
        self._events.put(ev)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                ev = self._events.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                self._handler(ev)
            except Exception:
                pass  # a broken handler must not kill the pump

    def stop(self) -> None:
        self._stop.set()
        self._store.unsubscribe(self._token)
        self._thread.join(timeout=2.0)


def with_retry(
    fn: Callable[[], Any],
    retries: int = 50,
    base_delay: float = 0.02,
    max_delay: float = 0.5,
) -> Any:
    """Run ``fn`` retrying across transient :class:`CoordinationUnavailable`.

    Exponential backoff with a cap; this is the client-side half of the
    paper's "survive transient Redis failures" behaviour.
    """
    delay = base_delay
    for attempt in range(retries):
        try:
            return fn()
        except CoordinationUnavailable:
            if attempt == retries - 1:
                raise
            time.sleep(delay)
            delay = min(max_delay, delay * 2)


if os.environ.get("REPRO_LOCK_WITNESS", "").strip() not in ("", "0"):
    # debug mode: wrap every store lock created from here on in the
    # runtime lock-order witness (the witness-enabled tier-1 CI job runs
    # the whole suite this way, validating the static PD-L005 graph
    # against real executions)
    from ..analysis.witness import install as _install_lock_witness

    _install_lock_witness()
