"""Multi-tenant identity, quotas, and fair-share accounting.

The paper frames Pilot-Data as an abstraction for *shared* distributed
infrastructure, and the P* model / pilot-job survey (PAPERS.md) both name
multi-user contention for pilots as the defining production problem.  This
module is the identity layer for that: a :class:`Tenant` is a named
principal with a scheduling ``priority`` and a :class:`ResourceQuota`;
the :class:`TenantRegistry` (attached to the runtime context as
``ctx.tenant_registry``) tracks who exists, how much work each tenant has
in flight, and how much service each has received — the numbers the
AdmissionController (``core/services.py``), the ``weighted-fair-share`` /
``priority`` placement strategies (``core/placement.py``), tenant-aware
eviction (``core/tiering.py``) and the transfer cost model
(``core/transfer.py``) all rank on.

Single-tenant deployments need zero changes: every CU/DU defaults to the
``default`` tenant, whose quota is unlimited, so admission is a
pass-through and every fair-share computation degenerates to the
pre-tenancy behavior.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Set

#: the implicit tenant of every CU/DU that never names one — unlimited
#: quota, priority 0, weight 1.0 (exact pre-tenancy semantics)
DEFAULT_TENANT = "default"


@dataclasses.dataclass
class ResourceQuota:
    """Per-tenant resource ceilings.  ``None`` means unlimited.

    * ``cu_slots`` — max CUs admitted past the AdmissionController at
      once (Pending-on-a-queue through Running); excess submissions are
      *parked*, not failed, and re-admitted as earlier CUs turn terminal.
    * ``sandbox_bytes`` — max bytes of the tenant's DU chunks resident
      across all Pilot-Data at admission time; a tenant over this ceiling
      has further CU admissions parked until its bytes drain or evict.
    * ``transfer_bw_share`` — relative weight for the transfer-bandwidth
      share (and the fair-share deficit): a tenant with weight 2 competing
      with one at weight 1 models 2/3 of the contended bandwidth.
    """

    cu_slots: Optional[int] = None
    sandbox_bytes: Optional[int] = None
    transfer_bw_share: float = 1.0

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Tenant:
    """One named principal sharing the runtime."""

    name: str
    #: scheduling priority — higher preempts *queued* (never running) CUs
    #: of strictly lower-priority tenants when starved
    priority: int = 0
    quota: ResourceQuota = dataclasses.field(default_factory=ResourceQuota)

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "priority": self.priority,
            "quota": self.quota.to_json(),
        }


class TenantRegistry:
    """Who the tenants are and what they are currently consuming.

    Usage accounting (in-flight CU ids, served sim-seconds of service,
    resident sandbox bytes) is written by the AdmissionController and read
    by the placement strategies and the transfer cost model.  Unknown
    tenant names auto-register with defaults, so stamping a bare name on a
    description is enough to participate.
    """

    def __init__(self, ctx: Any = None):
        self.ctx = ctx
        self._lock = threading.Lock()
        self._tenants: Dict[str, Tenant] = {
            DEFAULT_TENANT: Tenant(DEFAULT_TENANT)
        }
        #: tenant -> CU ids admitted and not yet terminal
        self._inflight: Dict[str, Set[str]] = {}
        #: tenant -> accumulated admitted work (estimate seconds) — the
        #: deficit counter weighted fair-share admission orders on
        self._served: Dict[str, float] = {}

    # ----------------------------------------------------------- membership
    def register(
        self,
        name: str,
        priority: int = 0,
        quota: Optional[ResourceQuota] = None,
    ) -> Tenant:
        """Create or update a tenant (idempotent; later registrations win)."""
        with self._lock:
            tenant = self._tenants.get(name)
            if tenant is None:
                tenant = Tenant(
                    name=name,
                    priority=priority,
                    quota=quota or ResourceQuota(),
                )
                self._tenants[name] = tenant
            else:
                tenant.priority = priority
                if quota is not None:
                    tenant.quota = quota
            return tenant

    def get(self, name: Optional[str]) -> Tenant:
        name = name or DEFAULT_TENANT
        with self._lock:
            tenant = self._tenants.get(name)
            if tenant is None:
                tenant = Tenant(name)
                self._tenants[name] = tenant
            return tenant

    def tenants(self) -> List[Tenant]:
        with self._lock:
            return [self._tenants[n] for n in sorted(self._tenants)]

    @property
    def multi_tenant(self) -> bool:
        """True once anything beyond the bare default tenant exists — the
        switch that turns admission from a pass-through into a gate."""
        with self._lock:
            if len(self._tenants) > 1:
                return True
            d = self._tenants[DEFAULT_TENANT]
            return (
                d.priority != 0
                or d.quota.cu_slots is not None
                or d.quota.sandbox_bytes is not None
            )

    def min_priority(self) -> int:
        with self._lock:
            return min(t.priority for t in self._tenants.values())

    # ----------------------------------------------------------- accounting
    def weight(self, name: Optional[str]) -> float:
        return max(self.get(name).quota.transfer_bw_share, 1e-9)

    def note_admitted(self, name: str, cu_id: str, est_s: float) -> None:
        with self._lock:
            self._inflight.setdefault(name, set()).add(cu_id)
            self._served[name] = self._served.get(name, 0.0) + est_s

    def note_removed(self, name: str, cu_id: str) -> None:
        with self._lock:
            self._inflight.get(name, set()).discard(cu_id)

    def inflight(self, name: str) -> int:
        with self._lock:
            return len(self._inflight.get(name, ()))

    def served(self, name: str) -> float:
        with self._lock:
            return self._served.get(name, 0.0)

    def deficit_key(self, name: str) -> float:
        """Weighted service received — LOWER means more starved.  The
        admission drain and fair-share ordering pick the smallest."""
        return self.served(name) / self.weight(name)

    def active_tenants(self) -> List[str]:
        """Tenants with admitted, non-terminal CUs (the bandwidth rivals)."""
        with self._lock:
            return sorted(n for n, s in self._inflight.items() if s)

    def bw_share(self, name: Optional[str]) -> float:
        """This tenant's fraction of contended transfer bandwidth: its
        weight over the total weight of all *active* tenants (itself
        included).  1.0 when it has the infrastructure to itself."""
        name = name or DEFAULT_TENANT
        rivals = [t for t in self.active_tenants() if t != name]
        if not rivals:
            return 1.0
        mine = self.weight(name)
        total = mine + sum(self.weight(t) for t in rivals)
        return mine / total

    def resident_bytes(self, name: str) -> int:
        """Bytes of this tenant's DU chunks currently resident across all
        live Pilot-Data — the number ``sandbox_bytes`` quotas gate on.
        Computed on demand from PD accounting (admission-time only, so the
        O(PDs × DUs) scan stays off every hot path)."""
        if self.ctx is None:
            return 0
        total = 0
        store = self.ctx.store
        for obj in list(self.ctx.objects.values()):
            holdings = getattr(obj, "du_bytes", None)
            if holdings is None:
                continue
            for du_id, nbytes in holdings().items():
                owner = store.hget(f"du:{du_id}", "tenant") or DEFAULT_TENANT
                if owner == name:
                    total += nbytes
        return total
