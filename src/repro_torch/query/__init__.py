"""Declarative query surface + compiled search plans (counterpart of
``repro.query``): a :class:`Query` says what to retrieve, and
``idx.plan(query)`` binds the pipeline that serves it (or, over a mesh,
:func:`compile_sharded_plan`)."""

from repro_torch.query.plan import (
    Capabilities,
    SearchPlan,
    ShardedPlan,
    capabilities,
    compile_plan,
    compile_sharded_plan,
    plan_stats,
    record_cache_hit,
    reset_plan_stats,
)
from repro_torch.query.spec import (
    EXECUTIONS,
    Query,
    degraded,
    validate_query_batch,
)

__all__ = [
    "Capabilities",
    "EXECUTIONS",
    "Query",
    "SearchPlan",
    "ShardedPlan",
    "capabilities",
    "compile_plan",
    "compile_sharded_plan",
    "degraded",
    "plan_stats",
    "record_cache_hit",
    "reset_plan_stats",
    "validate_query_batch",
]
