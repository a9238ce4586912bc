"""Pilot-Data core: the paper's abstractions as a composable library.

Import surface mirrors the Pilot-API (§4.3): descriptions + services +
manager.  This package deliberately does NOT import jax — launchers must be
able to set XLA flags before jax initializes.
"""

from .affinity import Topology, make_grid_topology, make_tpu_fleet_topology, match_affinity
from .compute_unit import (
    ComputeUnit,
    ComputeUnitDescription,
    CUState,
    FUNCTIONS,
    FunctionRegistry,
)
from .coordination import (
    CoordinationStore,
    CoordinationUnavailable,
    StoreEvent,
    with_retry,
)
from .cost_model import (
    PlacementChoice,
    cheapest_replica,
    choose_replication_degree,
    decide_placement,
    estimate_td,
    estimate_tr_group,
    estimate_tr_sequential,
    estimate_ts,
    estimate_tx,
    straggler_threshold,
)
from .data_unit import (
    ChunkInfo,
    DEFAULT_CHUNK_SIZE,
    DataUnit,
    DataUnitDescription,
    DUState,
    merge_dus,
    partition_du,
)
from .faults import (
    HeartbeatMonitor,
    StragglerMitigator,
    fail_cu_terminal,
    requeue_orphans,
)
from .futures import (
    ComputeFailedError,
    CUFuture,
    DataUnitFailedError,
    DUFuture,
    FutureError,
    FutureTimeoutError,
    gather,
)
from .manager import PilotManager
from .placement import (
    Candidate,
    PlacementEngine,
    PlacementStrategy,
    list_strategies,
    make_strategy,
    register_strategy,
)
from .pilot import (
    PilotCompute,
    PilotComputeDescription,
    PilotData,
    PilotDataDescription,
    PilotState,
    QuotaExceeded,
    RuntimeContext,
)
from .recovery import FaultManager, ReplicaManager
from .replication import (
    DemandReplicator,
    replicate_group,
    replicate_sequential,
    select_heal_targets,
)
from .scheduler import AsyncScheduler, SchedulerEvent
from .services import (
    AdmissionController,
    ComputeDataService,
    DependencyTracker,
    PilotComputeService,
    PilotDataService,
)
from .session import Session
from .tenancy import (
    DEFAULT_TENANT,
    ResourceQuota,
    Tenant,
    TenantRegistry,
)
from .tiering import (
    EvictionPolicy,
    PinRegistry,
    TIERS,
    TierManager,
    Victim,
    classify_tier,
    list_eviction_policies,
    make_eviction_policy,
    register_eviction_policy,
    tier_rank,
)
from .transfer import TransferRecord, TransferService

__all__ = [
    "Topology", "make_grid_topology", "make_tpu_fleet_topology", "match_affinity",
    "ComputeUnit", "ComputeUnitDescription", "CUState", "FUNCTIONS", "FunctionRegistry",
    "CoordinationStore", "CoordinationUnavailable", "StoreEvent", "with_retry",
    "AsyncScheduler", "SchedulerEvent",
    "Candidate", "PlacementEngine", "PlacementStrategy",
    "list_strategies", "make_strategy", "register_strategy",
    "PlacementChoice", "cheapest_replica", "choose_replication_degree",
    "decide_placement", "estimate_td", "estimate_tr_group", "estimate_tr_sequential",
    "estimate_ts", "estimate_tx", "straggler_threshold",
    "ChunkInfo", "DEFAULT_CHUNK_SIZE",
    "DataUnit", "DataUnitDescription", "DUState", "merge_dus", "partition_du",
    "HeartbeatMonitor", "StragglerMitigator", "requeue_orphans",
    "fail_cu_terminal", "FaultManager", "ReplicaManager", "select_heal_targets",
    "PilotManager",
    "PilotCompute", "PilotComputeDescription", "PilotData", "PilotDataDescription",
    "PilotState", "QuotaExceeded", "RuntimeContext",
    "DemandReplicator", "replicate_group", "replicate_sequential",
    "AdmissionController", "ComputeDataService", "DependencyTracker",
    "PilotComputeService", "PilotDataService",
    "DEFAULT_TENANT", "ResourceQuota", "Tenant", "TenantRegistry",
    "Session", "CUFuture", "DUFuture", "gather",
    "FutureError", "FutureTimeoutError",
    "ComputeFailedError", "DataUnitFailedError",
    "TransferRecord", "TransferService",
    "EvictionPolicy", "PinRegistry", "TIERS", "TierManager", "Victim",
    "classify_tier", "list_eviction_policies", "make_eviction_policy",
    "register_eviction_policy", "tier_rank",
]
