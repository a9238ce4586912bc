"""Distribution on ``torch.distributed``: the counterpart of
``repro.distributed``.  The context and the sharding rules load here; the
expert-parallel MoE layer (:mod:`.moe_parallel`), the kernels' local
regions (:mod:`.tensor_parallel`) and the pipeline (:mod:`.pipeline`) are
imported where they are used."""

from .context import DistContext, constrain, current, distribution
from .sharding_rules import (
    batch_specs,
    cache_specs,
    distribute_tree,
    gather_tree,
    opt_specs,
    param_specs,
)

__all__ = [
    "DistContext", "constrain", "current", "distribution",
    "batch_specs", "cache_specs", "distribute_tree", "gather_tree", "opt_specs", "param_specs",
]
