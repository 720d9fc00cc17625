"""Declarative query surface + compiled search plans (counterpart of
``repro.query``): a :class:`Query` says what to retrieve, and
``idx.plan(query)`` binds the pipeline that serves it."""

from repro_torch.query.plan import (
    Capabilities,
    SearchPlan,
    capabilities,
    compile_plan,
    plan_stats,
    record_cache_hit,
    reset_plan_stats,
)
from repro_torch.query.spec import EXECUTIONS, Query, validate_query_batch

__all__ = [
    "Capabilities",
    "EXECUTIONS",
    "Query",
    "SearchPlan",
    "capabilities",
    "compile_plan",
    "plan_stats",
    "record_cache_hit",
    "reset_plan_stats",
    "validate_query_batch",
]
