"""Session: the declarative Pilot-API v2 facade.

The paper's API couples compute and data declaratively — a CU names its
input and output DUs and the runtime guarantees materialization order
(§4.2–4.3, Fig. 5).  :class:`Session` is that contract as the user-facing
surface: ``submit_cu`` accepts inline :class:`DataUnitDescription`s (or
existing DUs / futures) for ``input_data``/``output_data``, auto-creates
output DUs, and returns a :class:`CUFuture` whose :class:`DUFuture`
``outputs`` chain straight into downstream CUs — so a whole DAG
(map → shuffle → reduce, iterative ensembles) is submitted upfront in one
shot, wired by object instead of by id string:

    with Session(topology=topo) as s:
        s.start_pilot(resource_url="sim://cluster:pod0")
        part = s.submit_du(name="part", files={"x": b"..."})
        m = s.submit_cu(executable="map", input_data=[part],
                        output_data=[DataUnitDescription(name="inter")])
        r = s.submit_cu(executable="reduce", input_data=[m.output],
                        output_data=[DataUnitDescription(name="out")])
        print(r.result())          # no user-side waits between stages

Ordering is enforced by the runtime's DU-readiness gate (a consumer parks
in ``Waiting`` until every input DU is sealed/first-replicated), not by
the caller; under ``scheduler_mode="async"`` the release additionally
triggers the prefetch pipeline, overlapping stage *i+1*'s stage-in with
stage *i*'s execution.

The v1 surface (``PilotManager.submit_du/submit_cu`` with raw id strings)
remains as thin deprecated shims.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

from .compute_unit import ComputeUnitDescription
from .data_unit import DataUnit, DataUnitDescription
from .futures import CUFuture, DUFuture, FutureDispatcher, gather
from .pilot import PilotCompute, PilotData
from .tenancy import DEFAULT_TENANT, ResourceQuota

#: anything submit_cu accepts as a data reference
DataRef = Union[str, DataUnit, DUFuture, DataUnitDescription]


class Session:
    """One attached Pilot-API v2 client: a facade over a PilotManager.

    Construct standalone (``Session(topology=...)`` forwards every kwarg to
    :class:`~repro.core.manager.PilotManager`) or attach to an existing
    manager (``Session(manager=mgr)`` / ``mgr.session``).  A standalone
    session owns its manager and shuts it down on ``close()``/context exit;
    an attached session leaves the manager running.

    A session is also the unit of *tenancy*: ``tenant=`` names the owner,
    ``priority=`` / ``quota=`` register its QoS class with the manager's
    :class:`~repro.core.tenancy.TenantRegistry`.  Every DU/CU submitted
    through this session is stamped with the session tenant (unless the
    description already names one), which is what admission control,
    fair-share placement and tenant-aware eviction key on.  Single-tenant
    callers need zero changes: the default tenant keeps the exact pre-QoS
    behavior.
    """

    def __init__(
        self,
        manager: Optional[Any] = None,
        *,
        tenant: str = DEFAULT_TENANT,
        priority: int = 0,
        quota: Optional[ResourceQuota] = None,
        **manager_kwargs: Any,
    ):
        if manager is not None and manager_kwargs:
            raise ValueError("pass either manager= or manager kwargs, not both")
        if manager is None:
            from .manager import PilotManager  # local import: cycle

            manager = PilotManager(**manager_kwargs)
            self._owns_manager = True
        else:
            self._owns_manager = False
        self.manager = manager
        self.tenant = tenant
        if tenant != DEFAULT_TENANT or priority != 0 or quota is not None:
            # re-registering the same tenant name updates its QoS class
            # (latest wins) — two sessions may share one tenant
            manager.cds.admission.registry.register(
                tenant, priority=priority, quota=quota
            )
        self._dispatcher = FutureDispatcher(manager.store)
        self._closed = False
        manager._attach_session(self)

    # ----------------------------------------------------------- delegation
    @property
    def ctx(self):
        return self.manager.ctx

    @property
    def cds(self):
        return self.manager.cds

    @property
    def store(self):
        return self.manager.store

    @property
    def topology(self):
        return self.manager.topology

    @property
    def transfer(self):
        return self.manager.transfer

    @property
    def scheduler(self):
        return self.manager.scheduler

    @property
    def heartbeat_monitor(self):
        return self.manager.heartbeat_monitor

    @property
    def straggler_mitigator(self):
        return self.manager.straggler_mitigator

    @property
    def fault_manager(self):
        """The self-healing pipeline (``enable_fault_manager=True``):
        replica purge on pilot death, replication-factor enforcement,
        lineage recomputation.  None when not enabled."""
        return self.manager.fault_manager

    @property
    def tier_manager(self):
        """The storage-hierarchy layer: tier classification, access
        stats, quota-driven eviction, and mem-tier cache promotion."""
        return self.manager.tier_manager

    def recovering_dus(self) -> List[str]:
        """DU ids currently being rebuilt after total replica loss
        (state ``Recovering``); empty when the data layer is healthy."""
        from .recovery import recovering_dus

        return recovering_dus(self.store)

    def start_pilot(self, **kw) -> PilotCompute:
        return self.manager.start_pilot(**kw)

    def start_pilot_data(self, **kw) -> PilotData:
        return self.manager.start_pilot_data(**kw)

    def register_function(self, name: str, fn=None):
        return self.manager.register_function(name, fn)

    def cu_states(self) -> Dict[str, str]:
        return self.manager.cu_states()

    def pilot_states(self) -> Dict[str, str]:
        return self.manager.pilot_states()

    def decisions(self) -> List[Dict]:
        return self.cds.decisions()

    # ----------------------------------------------------------------- data
    def _stamp_tenant(self, desc: Any) -> Any:
        """Stamp the session tenant onto a DU/CU description in place.

        A description that already names a non-default tenant wins — it
        was set deliberately (e.g. submitting on another tenant's behalf).
        """
        if desc.tenant == DEFAULT_TENANT and self.tenant != DEFAULT_TENANT:
            desc.tenant = self.tenant
        return desc

    def submit_du(
        self,
        desc: Optional[DataUnitDescription] = None,
        *,
        target: Optional[PilotData] = None,
        **kw: Any,
    ) -> DUFuture:
        """Create a DU and stage it into an affinity-appropriate PD;
        returns a :class:`DUFuture` (typically already materialized, since
        first staging is synchronous)."""
        if desc is None:
            desc = DataUnitDescription(**kw)
        elif kw:
            raise ValueError("pass a description or kwargs, not both")
        du = self.cds.submit_data_unit(self._stamp_tenant(desc), target=target)
        return DUFuture(du, self.store, dispatcher=self._dispatcher)

    def create_du(
        self, desc: Optional[DataUnitDescription] = None, **kw: Any
    ) -> DUFuture:
        """Create an *empty placeholder* DU without staging it: a dataflow
        handle whose content a producer CU materializes later.  Consumers
        submitted against it park in ``Waiting`` until the producer seals
        it — this is how a consumer can be submitted before its producer."""
        if desc is None:
            desc = DataUnitDescription(**kw)
        elif kw:
            raise ValueError("pass a description or kwargs, not both")
        du = self.cds.create_data_unit(self._stamp_tenant(desc))
        return DUFuture(du, self.store, dispatcher=self._dispatcher)

    def create_streaming_du(
        self, desc: Optional[DataUnitDescription] = None, **kw: Any
    ) -> DUFuture:
        """Create an empty *streaming* placeholder DU: the producer CU
        publishes chunk prefixes incrementally (``CUContext.flush_output``)
        and consumers are released the moment ``ready_chunks`` chunks (or
        ``ready_fraction`` of the expected total, given a ``size_hint``)
        are published — before the producer seals."""
        if desc is None:
            kw.setdefault("streaming", True)
            desc = DataUnitDescription(**kw)
        elif kw:
            raise ValueError("pass a description or kwargs, not both")
        if not desc.streaming:
            raise ValueError("create_streaming_du needs streaming=True")
        du = self.cds.create_data_unit(self._stamp_tenant(desc))
        return DUFuture(du, self.store, dispatcher=self._dispatcher)

    # -------------------------------------------------------------- compute
    def _resolve_input(self, ref: DataRef) -> str:
        if isinstance(ref, DataUnitDescription):
            # inline input: create + stage it now, depend on the result
            return self.submit_du(ref).id
        return self._ref_id(ref, role="input")

    def _resolve_output(self, ref: DataRef) -> DUFuture:
        if isinstance(ref, DataUnitDescription):
            return self.create_du(ref)
        if isinstance(ref, DUFuture):
            return ref
        if isinstance(ref, DataUnit):
            return DUFuture(ref, self.store, dispatcher=self._dispatcher)
        du_id = self._ref_id(ref, role="output")
        return DUFuture(self._du_handle(du_id), self.store, dispatcher=self._dispatcher)

    def _ref_id(self, ref: DataRef, role: str) -> str:
        if isinstance(ref, (DataUnit, DUFuture)):
            return ref.id
        if isinstance(ref, str):
            warnings.warn(
                f"Pilot-API v1: raw DU id strings in {role}_data are "
                f"deprecated; pass the DataUnit/DUFuture object (or an "
                f"inline DataUnitDescription)",
                DeprecationWarning,
                stacklevel=4,
            )
            return ref
        raise TypeError(
            f"{role}_data entries must be DataUnit, DUFuture, "
            f"DataUnitDescription or id str, got {type(ref).__name__}"
        )

    def _du_handle(self, du_id: str) -> DataUnit:
        try:
            return self.ctx.lookup(du_id)
        except KeyError:
            # remote DU known only to the store: re-attach a handle
            return DataUnit(DataUnitDescription(), self.store, du_id=du_id)

    def submit_cu(
        self,
        desc: Optional[ComputeUnitDescription] = None,
        *,
        input_data: Sequence[DataRef] = (),
        output_data: Sequence[DataRef] = (),
        pilot: Optional[Union[str, PilotCompute]] = None,
        **kw: Any,
    ) -> CUFuture:
        """Submit a CU whose data dependencies are declared by object.

        ``input_data``/``output_data`` accept :class:`DataUnit`,
        :class:`DUFuture` (e.g. another CU's output), or an inline
        :class:`DataUnitDescription` (inputs are created+staged, outputs
        auto-created as placeholders).  Returns a :class:`CUFuture`; its
        ``outputs`` chain into downstream submissions, so an entire DAG can
        be submitted before any CU has run.
        """
        if desc is not None:
            if kw or input_data or output_data or pilot is not None:
                raise ValueError(
                    "pass a ComputeUnitDescription or kwargs, not both"
                )
            cu = self.cds.submit_compute_unit(self._stamp_tenant(desc))
            outs = [
                DUFuture(self._du_handle(i), self.store, dispatcher=self._dispatcher)
                for i in desc.output_data
            ]
            return CUFuture(cu, self.store, outputs=outs, dispatcher=self._dispatcher)
        out_futures = [self._resolve_output(o) for o in output_data]
        kw.setdefault("tenant", self.tenant)
        cud = ComputeUnitDescription(
            input_data=[self._resolve_input(i) for i in input_data],
            output_data=[o.id for o in out_futures],
            pilot=pilot.id if isinstance(pilot, PilotCompute) else pilot,
            **kw,
        )
        cu = self.cds.submit_compute_unit(cud)
        return CUFuture(
            cu, self.store, outputs=out_futures, dispatcher=self._dispatcher
        )

    # -------------------------------------------------------------- control
    def gather(self, futures: Iterable[Any], timeout: float = 120.0) -> List[Any]:
        return gather(futures, timeout=timeout)

    def wait(self, timeout: float = 120.0) -> bool:
        """Block until every submitted CU is terminal (event-driven)."""
        return self.cds.wait(timeout=timeout)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # drain this session's future-dispatcher thread *before* the
        # manager (and ultimately the store's event dispatcher) can go
        # away — a dispatcher outliving the store deadlocks futures
        # waiting on events that will never be delivered
        self._dispatcher.stop()
        self.manager._detach_session(self)
        if self._owns_manager:
            self.manager.shutdown()

    # v1-compat spelling used all over the manager surface
    def shutdown(self) -> None:
        self.close()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"<Session mode={self.manager.scheduler_mode} "
            f"owns_manager={self._owns_manager} closed={self._closed}>"
        )
