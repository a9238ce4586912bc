"""Runtime lock-order witness for the coordination plane.

With ``REPRO_LOCK_WITNESS=1`` in the environment, ``coordination.py``
creates every store lock through :func:`install`'s factory; each
:class:`WitnessedLock` records a per-thread held-lock stack and, on every
*nested* acquisition, inserts an order edge into a global graph.  The
first edge that closes a cycle raises :class:`LockOrderViolation` with
the acquisition sites of every edge on the cycle — a deadlock caught the
first time the inverted order is *executed*, not the first time two
threads actually collide.

Edges are keyed per lock *instance*, so index-ordered striped
acquisition (``_lock_all``) and multi-store tests cannot alias into
false cycles; :meth:`Witness.observed_class_edges` collapses instances
back to class-level names for cross-checking against the static PD-L005
graph (``analysis/lockgraph.py``).

The wrapper is ``threading.Condition``-compatible: ``Condition(lock)``
only needs ``acquire``/``release`` (its ``_is_owned`` fallback probes
with a non-blocking acquire, which the wrapper forwards faithfully).
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple


class LockOrderViolation(AssertionError):
    """A lock acquisition closed a cycle in the observed order graph."""


def _call_site() -> str:
    """First stack frame outside this module / threading internals."""
    frame = sys._getframe(2)
    while frame is not None:
        base = os.path.basename(frame.f_code.co_filename)
        if base not in ("witness.py", "threading.py"):
            return f"{base}:{frame.f_lineno}"
        frame = frame.f_back
    return "<unknown>"


class Witness:
    """The order graph plus per-thread held stacks."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._tls = threading.local()
        #: serial -> class-level lock name
        self._names: Dict[int, str] = {}
        #: instance-level edges: a_serial -> {b_serial}
        self._succ: Dict[int, Set[int]] = {}
        #: (a_serial, b_serial) -> acquisition site of the first witness
        self._sites: Dict[Tuple[int, int], str] = {}
        self.violations: List[str] = []

    # ------------------------------------------------------------ stacks
    def _stack(self) -> List[list]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def held_names(self) -> List[str]:
        return [entry[0].name for entry in self._stack()]

    # ------------------------------------------------------------- edges
    def on_acquire(self, lock: "WitnessedLock") -> None:
        stack = self._stack()
        for entry in stack:
            if entry[0] is lock:  # re-entrant: no new edge
                entry[1] += 1
                return
        if stack:
            self._record_edge(stack[-1][0], lock, _call_site())
        stack.append([lock, 1])

    def on_release(self, lock: "WitnessedLock") -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] is lock:
                stack[i][1] -= 1
                if stack[i][1] == 0:
                    del stack[i]
                return
        # released by a thread that never recorded the acquire: ignore

    def _record_edge(self, a: "WitnessedLock", b: "WitnessedLock", site: str) -> None:
        if a is b:
            return
        with self._mu:
            self._names[a.serial] = a.name
            self._names[b.serial] = b.name
            succ = self._succ.setdefault(a.serial, set())
            if b.serial in succ:
                return
            back_path = self._find_path(b.serial, a.serial)
            succ.add(b.serial)
            self._sites[(a.serial, b.serial)] = site
            if back_path is None:
                return
            trace = self._format_cycle(a, b, site, back_path)
            self.violations.append(trace)
        raise LockOrderViolation(trace)

    def _find_path(self, src: int, dst: int) -> Optional[List[int]]:
        """DFS path src → dst over instance edges (None if unreachable)."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._succ.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def _format_cycle(
        self, a: "WitnessedLock", b: "WitnessedLock", site: str, back_path: List[int]
    ) -> str:
        lines = [
            "lock-order inversion:",
            f"  new edge {a.name}#{a.serial} → {b.name}#{b.serial} "
            f"acquired at {site}",
            "  conflicts with the previously observed order:",
        ]
        for x, y in zip(back_path, back_path[1:]):
            xs = self._names.get(x, "?")
            ys = self._names.get(y, "?")
            at = self._sites.get((x, y), "?")
            lines.append(f"    {xs}#{x} → {ys}#{y} at {at}")
        lines.append(f"  held by this thread: {self.held_names()}")
        return "\n".join(lines)

    # ---------------------------------------------------------- reporting
    def observed_class_edges(self) -> Set[Tuple[str, str]]:
        """Instance edges collapsed to class-level names; same-name edges
        (index-ordered striping) are dropped."""
        with self._mu:
            out = set()
            for (a, b), _ in self._sites.items():
                an, bn = self._names.get(a, "?"), self._names.get(b, "?")
                if an != bn:
                    out.add((an, bn))
            return out

    def unexplained_edges(
        self, static_edges: Set[Tuple[str, str]]
    ) -> Set[Tuple[str, str]]:
        """Observed class-level edges absent from the static PD-L005
        graph — each one is a hole in the static model."""
        return {e for e in self.observed_class_edges() if e not in static_edges}


class WitnessedLock:
    """Drop-in Lock/RLock wrapper that reports to a :class:`Witness`."""

    _serial_mu = threading.Lock()
    _next_serial = 0

    __slots__ = ("_inner", "name", "reentrant", "serial", "_witness")

    def __init__(self, name: str, reentrant: bool, witness: Witness):
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self.name = name
        self.reentrant = reentrant
        self._witness = witness
        with WitnessedLock._serial_mu:
            WitnessedLock._next_serial += 1
            self.serial = WitnessedLock._next_serial

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if timeout == -1:
            got = self._inner.acquire(blocking)
        else:
            got = self._inner.acquire(blocking, timeout)
        if got:
            self._witness.on_acquire(self)
        return got

    def release(self) -> None:
        self._witness.on_release(self)
        self._inner.release()

    def __enter__(self) -> "WitnessedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<WitnessedLock {self.name}#{self.serial}>"


def witness_factory(witness: Witness):
    """A ``coordination.set_lock_factory``-shaped factory bound to
    ``witness``."""

    def factory(name: str, reentrant: bool = False) -> WitnessedLock:
        return WitnessedLock(name, reentrant, witness)

    return factory


_installed: Optional[Witness] = None


def install(witness: Optional[Witness] = None) -> Witness:
    """Route every subsequently created coordination lock through a
    witness (idempotent; returns the active witness)."""
    global _installed
    from ..core import coordination

    if witness is None:
        witness = _installed or Witness()
    coordination.set_lock_factory(witness_factory(witness))
    _installed = witness
    return witness


def uninstall() -> None:
    """Restore plain ``threading`` locks for new stores."""
    global _installed
    from ..core import coordination

    coordination.set_lock_factory(None)
    _installed = None


def active_witness() -> Optional[Witness]:
    return _installed


def enabled_by_env() -> bool:
    return os.environ.get("REPRO_LOCK_WITNESS", "").strip() not in ("", "0")
