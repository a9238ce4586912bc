"""Typed futures over Compute-Units and Data-Units (Pilot-API v2).

The paper's API is asynchronous ("the Pilot-API is asynchronous, i.e.
submission calls return immediately", §4.2) but the original handles force
callers back into polling and id-string plumbing.  This module gives the
asynchrony a shape: :class:`CUFuture` / :class:`DUFuture` are typed,
chainable handles with ``result()/done()/add_done_callback()`` semantics
(mirroring :mod:`concurrent.futures`) plus a :func:`gather` combinator, so
whole DAGs are wired by object instead of by raw id string.

Completion is event-driven end to end: blocking waits ride
``CoordinationStore.wait_field`` (keyspace notifications, no polling) and
callbacks are fired by a per-session :class:`FutureDispatcher` thread that
consumes the same store event stream — callbacks never run on the store's
dispatcher thread (or any store lock), so they may block or re-enter the
API freely.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Iterable, List, Optional, Sequence, Tuple

from .compute_unit import ComputeUnit, CUState
from .coordination import CoordinationStore, StoreEvent, StoreEventPump
from .data_unit import DataUnit, DUState


class FutureError(RuntimeError):
    """Base class for future resolution failures."""


class FutureTimeoutError(FutureError, TimeoutError):
    """``result()`` deadline elapsed before the subject settled."""


class ComputeFailedError(FutureError):
    """The underlying CU reached FAILED/CANCELED."""

    def __init__(self, cu_id: str, message: str):
        super().__init__(message)
        self.cu_id = cu_id


class DataUnitFailedError(FutureError):
    """The underlying DU reached FAILED (e.g. its producer CU failed)."""

    def __init__(self, du_id: str, message: str):
        super().__init__(message)
        self.du_id = du_id


class FutureDispatcher:
    """Runs ``add_done_callback`` callbacks off the store's event stream.

    A :class:`StoreEventPump` drains the subscription onto a dedicated
    thread, so user callbacks run off the store's dispatcher (which must
    stay fast for every other subscriber) and may block or re-enter the
    API freely.
    """

    def __init__(self, store: CoordinationStore):
        self._store = store
        self._lock = threading.Lock()
        #: "cu:<id>"/"du:<id>" -> [(future, callback)] not yet fired
        self._pending: dict = {}
        #: "du:<id>" -> [(future, callback)] fired on EVERY publish event
        #: (streaming chunk-prefix progress), dropped once the future is done
        self._progress: dict = {}
        self._pump = StoreEventPump(
            store,
            handler=self._handle,
            accept=lambda ev: (
                ev.op == "hset"
                and ev.field in ("state", "sealed", "published")
                and (ev.key.startswith("cu:") or ev.key.startswith("du:"))
            ),
            name="future-dispatcher",
        )

    def _handle(self, ev: StoreEvent) -> None:
        if ev.field == "published":
            self._fire_progress(ev.key, ev.value)
        self._fire(ev.key)

    def _fire(self, key: str) -> None:
        with self._lock:
            entries = self._pending.get(key)
            if not entries:
                return
            ready = [e for e in entries if e[0].done()]
            if not ready:
                return
            remaining = [e for e in entries if not e[0].done()]
            if remaining:
                self._pending[key] = remaining
            else:
                self._pending.pop(key, None)
        for future, callback in ready:
            try:
                callback(future)
            except Exception:
                pass  # a broken callback must not kill the dispatcher

    def _fire_progress(self, key: str, value: Any) -> None:
        with self._lock:
            entries = list(self._progress.get(key, ()))
            if entries:
                live = [e for e in entries if not e[0].done()]
                if live:
                    self._progress[key] = live
                else:
                    self._progress.pop(key, None)
        for future, callback in entries:
            try:
                callback(future, int(value or 0))
            except Exception:
                pass

    def register(self, key: str, future: Any, callback: Callable) -> None:
        if future.done():
            callback(future)
            return
        with self._lock:
            self._pending.setdefault(key, []).append((future, callback))
        # Completion may have landed between the check and the registration;
        # a synthetic event closes the race on the dispatcher thread.
        self._pump.inject(
            StoreEvent(seq=-1, op="hset", key=key, field="state", value=None)
        )

    def register_progress(
        self, key: str, future: Any, callback: Callable
    ) -> None:
        """Fire ``callback(future, published)`` on every subsequent chunk-
        prefix publish event for ``key`` until the future settles."""
        with self._lock:
            self._progress.setdefault(key, []).append((future, callback))

    def stop(self) -> None:
        self._pump.stop()


class DUFuture:
    """Typed handle on a Data-Unit that may not be materialized yet.

    Resolves when the DU is sealed/first-replicated (READY) — or raises
    :class:`DataUnitFailedError` when its producer CU failed.  Read-only
    properties proxy the underlying :class:`DataUnit` so a future can be
    used wherever a DU handle is inspected.
    """

    _SETTLED = (DUState.READY, DUState.FAILED, DUState.DELETED)

    def __init__(
        self,
        du: DataUnit,
        store: CoordinationStore,
        dispatcher: Optional[FutureDispatcher] = None,
    ):
        self.du = du
        self._store = store
        self._dispatcher = dispatcher

    # ------------------------------------------------------------- proxies
    @property
    def id(self) -> str:
        return self.du.id

    @property
    def url(self) -> str:
        return self.du.url

    @property
    def state(self) -> str:
        return self.du.state

    @property
    def sealed(self) -> bool:
        return self.du.sealed

    @property
    def locations(self) -> List[str]:
        return self.du.locations

    @property
    def manifest(self) -> dict:
        return self.du.manifest

    @property
    def size(self) -> int:
        return self.du.size

    @property
    def error(self) -> Optional[str]:
        return self._store.hget(f"du:{self.id}", "error")

    @property
    def recovering(self) -> bool:
        """True while the runtime rebuilds this DU after total replica
        loss (lineage recomputation / buffer re-ingest).  A recovering
        future is NOT done; ``result()`` keeps waiting and resolves when
        the re-run re-seals the DU — or raises if recovery fails."""
        return self.state == DUState.RECOVERING

    # ----------------------------------------------------------- streaming
    @property
    def streaming(self) -> bool:
        return self.du.streaming

    @property
    def published(self) -> int:
        """Published chunk-prefix length (0 for non-streaming DUs until
        they seal)."""
        return self.du.published if self.du.streaming else (
            self.du.n_chunks if self.du.sealed else 0
        )

    def available_chunks(self) -> int:
        return self.du.available_chunks()

    def wait_prefix(self, n: int, timeout: float = 30.0) -> int:
        """Block until at least ``n`` chunks of this streaming DU are
        published (or the DU settles); returns the published count.

        Raises :class:`DataUnitFailedError` if the DU fails first and
        :class:`FutureTimeoutError` on deadline."""
        self._store.wait_field(
            f"du:{self.id}",
            "published",
            lambda v: int(v or 0) >= n or self.done(),
            timeout=timeout,
            default=0,
        )
        if self.state in (DUState.FAILED, DUState.DELETED):
            raise DataUnitFailedError(
                self.id, f"{self.url} failed: {self.error or self.state}"
            )
        published = self.published
        if published < n and not self.done():
            raise FutureTimeoutError(
                f"{self.url}: prefix {n} not published within {timeout}s "
                f"(published={published})"
            )
        return published

    def add_prefix_callback(
        self, fn: Callable[["DUFuture", int], None]
    ) -> None:
        """Invoke ``fn(future, published)`` on every chunk-prefix publish
        event until the DU settles (streaming progress observation)."""
        if self._dispatcher is None:
            raise RuntimeError(
                "add_prefix_callback needs a dispatcher — create this "
                "future through a Session"
            )
        self._dispatcher.register_progress(f"du:{self.id}", self, fn)

    # ------------------------------------------------------------- futures
    def done(self) -> bool:
        state = self.state
        if state == DUState.RECOVERING:
            return False  # un-sealed for rewrite; the re-seal settles it
        return state in self._SETTLED or self.sealed

    def wait(self, timeout: float = 30.0) -> str:
        """Block until settled; returns the DU state (compat with
        ``DataUnit.wait``)."""
        return self.du.wait(timeout=timeout)

    def result(self, timeout: float = 60.0) -> DataUnit:
        """Block until the DU materializes; returns the sealed DataUnit.

        Raises :class:`DataUnitFailedError` if the DU failed (producer CU
        error propagates here) and :class:`FutureTimeoutError` on deadline.
        """
        self._store.wait_field(
            f"du:{self.id}",
            "state",
            lambda s: s in self._SETTLED,
            timeout=timeout,
            default=DUState.NEW,
        )
        state = self.state
        if state in (DUState.FAILED, DUState.DELETED):
            raise DataUnitFailedError(
                self.id, f"{self.url} failed: {self.error or state}"
            )
        if not self.done():
            raise FutureTimeoutError(
                f"{self.url} not materialized within {timeout}s "
                f"(state={state})"
            )
        return self.du

    def add_done_callback(self, fn: Callable[["DUFuture"], None]) -> None:
        if self._dispatcher is None:
            raise RuntimeError(
                "add_done_callback needs a dispatcher — create this future "
                "through a Session"
            )
        self._dispatcher.register(f"du:{self.id}", self, fn)

    def __repr__(self) -> str:  # pragma: no cover
        return f"<DUFuture {self.url} state={self.state} done={self.done()}>"


class CUFuture:
    """Typed handle on a submitted Compute-Unit.

    ``outputs`` exposes :class:`DUFuture` handles for the CU's output DUs,
    which is what lets whole DAGs be chained by object: pass
    ``cu_future.outputs[0]`` straight into the next CU's ``input_data``.
    """

    def __init__(
        self,
        cu: ComputeUnit,
        store: CoordinationStore,
        outputs: Sequence[DUFuture] = (),
        dispatcher: Optional[FutureDispatcher] = None,
    ):
        self.cu = cu
        self._store = store
        self.outputs: Tuple[DUFuture, ...] = tuple(outputs)
        self._dispatcher = dispatcher

    # ------------------------------------------------------------- proxies
    @property
    def id(self) -> str:
        return self.cu.id

    @property
    def url(self) -> str:
        return self.cu.url

    @property
    def state(self) -> str:
        return self.cu.state

    @property
    def description(self):
        return self.cu.description

    @property
    def timings(self):
        return self.cu.timings

    @property
    def pilot_id(self) -> Optional[str]:
        return self.cu.pilot_id

    @property
    def error(self) -> Optional[str]:
        return self.cu.error or self._store.hget(f"cu:{self.id}", "error")

    @property
    def output(self) -> DUFuture:
        """The sole output DU future (raises if the CU has 0 or >1)."""
        if len(self.outputs) != 1:
            raise ValueError(
                f"{self.url} has {len(self.outputs)} outputs; use .outputs"
            )
        return self.outputs[0]

    def cancel(self) -> None:
        self.cu.cancel()

    # ------------------------------------------------------------- futures
    def done(self) -> bool:
        return self.state in CUState.TERMINAL

    def wait(self, timeout: float = 60.0) -> str:
        """Block until terminal; returns the CU state (compat with
        ``ComputeUnit.wait``)."""
        return self.cu.wait(timeout=timeout)

    def result(self, timeout: float = 60.0) -> Any:
        """Block until the CU is terminal and return its executable's
        return value; raises :class:`ComputeFailedError` on FAILED/CANCELED
        and :class:`FutureTimeoutError` on deadline."""
        state = self.wait(timeout=timeout)
        if state == CUState.DONE:
            return self.cu.result
        if state in (CUState.FAILED, CUState.CANCELED):
            raise ComputeFailedError(
                self.id, f"{self.url} {state.lower()}: {self.error}"
            )
        raise FutureTimeoutError(
            f"{self.url} not terminal within {timeout}s (state={state})"
        )

    def add_done_callback(self, fn: Callable[["CUFuture"], None]) -> None:
        if self._dispatcher is None:
            raise RuntimeError(
                "add_done_callback needs a dispatcher — create this future "
                "through a Session"
            )
        self._dispatcher.register(f"cu:{self.id}", self, fn)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"<CUFuture {self.url} exe={self.description.executable} "
            f"state={self.state} outputs={len(self.outputs)}>"
        )


def gather(
    futures: Iterable[Any], timeout: float = 120.0
) -> List[Any]:
    """Resolve a collection of futures under one shared deadline.

    Returns ``[f.result() for f in futures]``; the first failure raises
    (fail-fast, like ``asyncio.gather`` without ``return_exceptions``).
    """
    import time

    deadline = time.monotonic() + timeout
    out: List[Any] = []
    for f in futures:
        remaining = deadline - time.monotonic()
        if remaining <= 0 and not f.done():
            raise FutureTimeoutError(f"gather: deadline elapsed before {f!r}")
        out.append(f.result(timeout=max(0.001, remaining)))
    return out
