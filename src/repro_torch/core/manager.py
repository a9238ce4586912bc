"""Pilot-Manager: the central coordinator (paper Fig. 1).

"The Pilot-Manager is the central entity of the framework, which is
responsible for managing the lifecycle of a set of Pilots (both
Pilot-Computes and Pilot-Data)."

:class:`PilotManager` is the one-stop construction point: it owns the
coordination store, the topology, the transfer service, the three Pilot-API
services, and the fault/straggler monitors.  It also implements the
reconnect semantics (§4.2): a second manager can attach to an existing
store (same WAL) and resolve pilots/CUs/DUs by URL.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Dict, Optional

from .affinity import Topology
from .compute_unit import ComputeUnitDescription, FUNCTIONS
from .coordination import CoordinationStore
from .data_unit import DataUnitDescription
from .faults import HeartbeatMonitor, StragglerMitigator
from .recovery import FaultManager
from .pilot import (
    PilotComputeDescription,
    PilotDataDescription,
    RuntimeContext,
)
from .scheduler import AsyncScheduler
from .tiering import TierManager
from .services import (
    ComputeDataService,
    PilotComputeService,
    PilotDataService,
)
from .transfer import TransferService


class PilotManager:
    def __init__(
        self,
        topology: Optional[Topology] = None,
        store: Optional[CoordinationStore] = None,
        wal_path: Optional[str] = None,
        time_scale: float = 0.0,
        data_mode: str = "pull",
        delayed_scheduling_s: float = 0.0,
        enable_heartbeat_monitor: bool = False,
        heartbeat_timeout_s: float = 0.5,
        suspect_timeout_s: Optional[float] = None,
        enable_fault_manager: bool = False,
        enable_straggler_mitigation: bool = False,
        straggler_factor: float = 2.5,
        scheduler_mode: str = "sync",
        placement_strategy: str = "cost",
        stage_workers: int = 4,
        eviction_policy: str = "lru",
        tier_cache_bytes: int = 0,
        tier_promote_after: int = 2,
        tier_auto_promote: bool = True,
    ):
        if scheduler_mode not in ("sync", "async"):
            raise ValueError(
                f"scheduler_mode must be 'sync' or 'async', got {scheduler_mode!r}"
            )
        self.store = store or CoordinationStore(wal_path=wal_path)
        self.topology = topology or Topology()
        self.ctx = RuntimeContext(
            store=self.store,
            topology=self.topology,
            time_scale=time_scale,
            data_mode=data_mode,
        )
        self.scheduler_mode = scheduler_mode
        self.transfer = TransferService(self.ctx)
        self.compute_service = PilotComputeService(self.ctx)
        self.data_service = PilotDataService(self.ctx)
        self.cds = ComputeDataService(
            self.ctx,
            delayed_scheduling_s=delayed_scheduling_s,
            strategy=placement_strategy,
            start_loop=(scheduler_mode == "sync"),
        )
        self.scheduler: Optional[AsyncScheduler] = None
        if scheduler_mode == "async":
            self.scheduler = AsyncScheduler(
                self.cds, stage_workers=stage_workers
            )
        # storage-hierarchy layer: tier classification + access stats,
        # quota-driven eviction (replaces hard QuotaExceeded), and — with
        # tier_cache_bytes > 0 — hot-DU promotion into a per-site mem-tier
        # cache PD, off the critical path like the async prefetch
        self.tier_manager = TierManager(
            self.ctx,
            cds=self.cds,
            eviction_policy=eviction_policy,
            cache_bytes=tier_cache_bytes,
            promote_after=tier_promote_after,
            auto_promote=tier_auto_promote,
        )
        self._session = None  # lazy Pilot-API v2 facade (see .session)
        self._sessions: list = []  # every attached Session (incl. facade)
        self.heartbeat_monitor: Optional[HeartbeatMonitor] = None
        self.straggler_mitigator: Optional[StragglerMitigator] = None
        self.fault_manager: Optional[FaultManager] = None
        if enable_fault_manager:
            # Full self-healing pipeline: pilot death purges the dead
            # sandbox's replicas, re-enforces replication factors and
            # recomputes lost DUs by lineage (implies the monitor).
            self.fault_manager = FaultManager(self.ctx, cds=self.cds)
            self.heartbeat_monitor = HeartbeatMonitor(
                self.ctx,
                timeout_s=heartbeat_timeout_s,
                suspect_timeout_s=suspect_timeout_s,
                on_suspect=self.fault_manager.on_pilot_suspect,
                on_failure=self.fault_manager.on_pilot_failed,
            ).start()
        elif enable_heartbeat_monitor:
            self.heartbeat_monitor = HeartbeatMonitor(
                self.ctx,
                timeout_s=heartbeat_timeout_s,
                suspect_timeout_s=suspect_timeout_s,
            ).start()
        if enable_straggler_mitigation:
            self.straggler_mitigator = StragglerMitigator(
                self.ctx, factor=straggler_factor
            ).start()

    # ------------------------------------------------------- convenience API
    def start_pilot(self, **kw) -> "PilotCompute":
        pilot = self.compute_service.create_pilot(PilotComputeDescription(**kw))
        self.cds.add_pilot_compute(pilot)
        return pilot

    def start_pilot_data(self, **kw) -> "PilotData":
        pd = self.data_service.create_pilot_data(PilotDataDescription(**kw))
        self.cds.add_pilot_data(pd)
        return pd

    @property
    def session(self) -> "Session":
        """The Pilot-API v2 facade attached to this manager (lazy)."""
        if self._session is None:
            from .session import Session  # local import: cycle

            self._session = Session(manager=self)
        return self._session

    # every Session registers here so shutdown() can drain their
    # dispatcher threads before the store goes away (a session attached
    # via Session(manager=...) used to outlive the store's dispatcher,
    # leaving its futures waiting on events that never arrive)
    def _attach_session(self, session) -> None:
        if session not in self._sessions:
            self._sessions.append(session)

    def _detach_session(self, session) -> None:
        if session in self._sessions:
            self._sessions.remove(session)

    # ------------------------------------------------ deprecated v1 shims
    def submit_du(self, **kw) -> "DataUnit":
        """Deprecated Pilot-API v1 entry point (kept as a thin shim)."""
        warnings.warn(
            "Pilot-API v1: PilotManager.submit_du() is deprecated; use "
            "Session.submit_du (repro.core.session) which returns a DUFuture",
            DeprecationWarning,
            stacklevel=2,
        )
        target = kw.pop("target", None)
        return self.cds.submit_data_unit(DataUnitDescription(**kw), target=target)

    def submit_cu(self, **kw) -> "ComputeUnit":
        """Deprecated Pilot-API v1 entry point (kept as a thin shim)."""
        warnings.warn(
            "Pilot-API v1: PilotManager.submit_cu() is deprecated; use "
            "Session.submit_cu which takes DU/DUFuture objects and returns "
            "a CUFuture",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.cds.submit_compute_unit(ComputeUnitDescription(**kw))

    def register_function(self, name: str, fn=None):
        return FUNCTIONS.register(name, fn)

    def wait(self, timeout: float = 120.0) -> bool:
        return self.cds.wait(timeout=timeout)

    # ------------------------------------------------------------ reconnect
    def cu_states(self) -> Dict[str, str]:
        out = {}
        for key in self.store.hkeys("cu:"):
            out[key.split(":", 1)[1]] = self.store.hget(key, "state")
        return out

    def pilot_states(self) -> Dict[str, str]:
        out = {}
        for key in self.store.hkeys("pilot:"):
            out[key.split(":", 1)[1]] = self.store.hget(key, "state")
        return out

    def shutdown(self) -> None:
        # teardown order matters: every attached session's future
        # dispatcher drains FIRST (they consume store events), then the
        # scheduler reactor, then cds.cancel() — which stops the
        # dependency tracker and admission controller pumps — and only
        # then the store itself closes its event dispatcher.
        for sess in list(self._sessions):
            with contextlib.suppress(Exception):
                sess._dispatcher.stop()
        self._sessions.clear()
        if self._session is not None:
            with contextlib.suppress(Exception):
                self._session._dispatcher.stop()
            self._session = None
        if self.scheduler is not None:
            with contextlib.suppress(Exception):
                self.scheduler.stop()
        with contextlib.suppress(Exception):
            self.cds.cancel()
        with contextlib.suppress(Exception):
            self.compute_service.cancel()
        if self.heartbeat_monitor:
            self.heartbeat_monitor.stop()
        if self.straggler_mitigator:
            self.straggler_mitigator.stop()
        if self.fault_manager:
            with contextlib.suppress(Exception):
                self.fault_manager.stop()
        if self.tier_manager is not None:
            with contextlib.suppress(Exception):
                self.tier_manager.stop()
        self.store.close()

    def __enter__(self) -> "PilotManager":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
