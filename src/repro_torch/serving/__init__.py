"""Serving layer (counterpart of ``repro.serving``; DESIGN.md §3.9–3.10): the batched request engine, and the
replicated fault-tolerant tier above it — health-checked replica pool,
retry/hedge/backoff router, admission control with graceful degradation,
and the deterministic fault-injection harness."""

from repro_torch.serving.engine import (
    BatchingEngine,
    Cancelled,
    DeadlineExceeded,
    QueryHandler,
    Request,
)
from repro_torch.serving.faults import FaultPlan, FaultSpec, InjectedFault, \
    ReplicaCrashed
from repro_torch.serving.replicated import Replica, ReplicaDown, ReplicaSet, \
    clone_index
from repro_torch.serving.router import (
    Overloaded,
    ReplicaUnavailable,
    Router,
    RouterConfig,
    RouterResult,
)

__all__ = [
    "BatchingEngine",
    "Cancelled",
    "DeadlineExceeded",
    "FaultPlan",
    "FaultSpec",
    "InjectedFault",
    "Overloaded",
    "QueryHandler",
    "Replica",
    "ReplicaCrashed",
    "ReplicaDown",
    "ReplicaSet",
    "ReplicaUnavailable",
    "Request",
    "Router",
    "RouterConfig",
    "RouterResult",
    "clone_index",
]
