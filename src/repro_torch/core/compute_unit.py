"""Compute-Unit: the paper's task abstraction (§4.3.2).

"A CU represents a self-contained piece of work ... an application task,
i.e. a certain executable to be executed with a set of parameters and input
files."  CUs declare ``input_data`` / ``output_data`` DU dependencies; the
runtime guarantees input DUs are materialized in the CU sandbox before
execution and output files are moved to the output DUs afterwards (Fig. 5).

Executables are names resolved through a :class:`FunctionRegistry` so CU
descriptions stay JSON-able (the paper's CUDs are JSON documents shipped
through Redis) while still invoking real Python/JAX work in-process.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, List, Optional

from .coordination import CoordinationStore
from .data_unit import _next_id


class CUState:
    NEW = "New"
    #: dataflow gate: some input DU is not yet sealed/first-replicated —
    #: the CU is parked until its producers materialize their outputs
    WAITING = "Waiting"
    PENDING = "Pending"  # queued (global or pilot queue)
    STAGING = "Staging"  # input DUs being materialized in the sandbox
    RUNNING = "Running"
    DONE = "Done"
    FAILED = "Failed"
    CANCELED = "Canceled"

    TERMINAL = (DONE, FAILED, CANCELED)


class FunctionRegistry:
    """Name → callable registry for CU executables."""

    def __init__(self) -> None:
        self._fns: Dict[str, Callable] = {}
        self._lock = threading.Lock()

    def register(self, name: str, fn: Optional[Callable] = None):
        if fn is None:  # decorator form

            def deco(f):
                self.register(name, f)
                return f

            return deco
        with self._lock:
            self._fns[name] = fn
        return fn

    def resolve(self, name: str) -> Callable:
        with self._lock:
            if name not in self._fns:
                raise KeyError(
                    f"executable {name!r} not registered "
                    f"(known: {sorted(self._fns)})"
                )
            return self._fns[name]


#: process-global default registry (agents resolve against this)
FUNCTIONS = FunctionRegistry()


@dataclasses.dataclass
class ComputeUnitDescription:
    """JSON-able CU description (paper's CUD)."""

    executable: str
    args: tuple = ()
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    input_data: List[str] = dataclasses.field(default_factory=list)  # DU ids
    output_data: List[str] = dataclasses.field(default_factory=list)  # DU ids
    cores: int = 1
    #: affinity constraint: subtree label the CU must run in, or None
    affinity: Optional[str] = None
    #: pin to a specific pilot (paper: "applications can either bind their
    #: workload directly to a Pilot ... using their own application-level
    #: scheduling")
    pilot: Optional[str] = None
    max_retries: int = 2
    #: False = paper's naive mode: re-stage inputs per CU, no replica reuse
    cache_inputs: bool = True
    #: estimated compute seconds (used by the cost model / simulator)
    est_compute_s: float = 0.0
    #: estimated simulated compute seconds for DES benchmarks
    sim_compute_s: float = 0.0
    #: owning tenant (multi-tenant QoS: admission quotas, fair-share
    #: placement, tenant-aware eviction); "default" = unlimited/neutral
    tenant: str = "default"

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["args"] = list(self.args)
        return d


@dataclasses.dataclass
class CUTimings:
    """Per-CU timing breakdown (the paper's Fig. 10 decomposition)."""

    submitted: float = 0.0
    scheduled: float = 0.0
    stage_start: float = 0.0
    stage_end: float = 0.0
    run_start: float = 0.0
    run_end: float = 0.0
    sim_stage_s: float = 0.0  # simulated T_S (virtual clock)
    sim_compute_s: float = 0.0
    #: simulated staging done AHEAD of execution by the async scheduler's
    #: prefetch pipeline (off the CU's critical path — overlapped)
    sim_prefetch_s: float = 0.0

    @property
    def t_q_task(self) -> float:  # pilot-internal queue time
        return max(0.0, self.stage_start - self.submitted)

    @property
    def t_s(self) -> float:  # wall staging time
        return max(0.0, self.stage_end - self.stage_start)

    @property
    def t_c(self) -> float:  # wall compute time
        return max(0.0, self.run_end - self.run_start)


class ComputeUnit:
    """Live handle over a submitted CU; state lives in the coordination
    store (re-connectable via its URL, §4.2)."""

    def __init__(
        self,
        description: ComputeUnitDescription,
        store: CoordinationStore,
        cu_id: Optional[str] = None,
    ):
        self.id = cu_id or _next_id("cu")
        self.description = description
        self._store = store
        self.timings = CUTimings()
        self.result: Any = None
        self.error: Optional[str] = None
        self.attempts = 0
        prior = store.hgetall(f"cu:{self.id}") if cu_id is not None else {}
        if prior.get("state") is not None:
            # Re-attach to an existing CU record (reconnect semantics, like
            # DataUnit): the store is authoritative — adopt its counters
            # instead of resetting the record from under a live workload.
            self.attempts = int(prior.get("attempts", 0))
            self.error = prior.get("error")
            return
        store.hset(f"cu:{self.id}", "state", CUState.NEW)
        store.hset(f"cu:{self.id}", "desc", description.to_json())
        store.hset(f"cu:{self.id}", "pilot", None)
        # tenant is read store-side by admission/placement/preemption so
        # they never need a live handle
        store.hset(f"cu:{self.id}", "tenant", description.tenant)
        # store-side attempt counter: orphan recovery must be able to bump
        # retries even when no live ComputeUnit handle exists (a crash-
        # looping pilot would otherwise requeue the same CU forever)
        store.hset(f"cu:{self.id}", "attempts", 0)

    @property
    def url(self) -> str:
        return f"cu://{self.id}"

    @property
    def state(self) -> str:
        return self._store.hget(f"cu:{self.id}", "state", CUState.NEW)

    @property
    def pilot_id(self) -> Optional[str]:
        return self._store.hget(f"cu:{self.id}", "pilot")

    def _set_state(self, state: str) -> None:
        self._store.hset(f"cu:{self.id}", "state", state)

    def _cas_state(self, expect: str, state: str) -> bool:
        """Exactly-once transition (straggler duplicates race on this)."""
        return self._store.hcas(f"cu:{self.id}", "state", expect, state)

    def cancel(self) -> None:
        for s in (CUState.NEW, CUState.WAITING, CUState.PENDING):
            if self._cas_state(s, CUState.CANCELED):
                # A canceled CU will never materialize its outputs: fail the
                # output DUs so downstream dataflow waiters are released with
                # a clear error instead of hanging.
                self._fail_outputs(f"producer {self.url} was canceled")
                return

    def _fail_outputs(self, reason: str) -> None:
        from .data_unit import DUState

        for du_id in self.description.output_data:
            key = f"du:{du_id}"
            if self._store.hget(key, "state") != DUState.READY:
                self._store.hset(key, "error", reason)
                self._store.hset(key, "state", DUState.FAILED)

    def wait(self, timeout: float = 60.0) -> str:
        """Block until the CU is terminal — event-driven on the store's
        keyspace notifications (no polling loop; the coarse in-wait poll is
        only a fallback against lost notifications)."""
        return self._store.wait_field(
            f"cu:{self.id}",
            "state",
            lambda s: s in CUState.TERMINAL,
            timeout=timeout,
            default=CUState.NEW,
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"<ComputeUnit {self.url} exe={self.description.executable} state={self.state}>"
