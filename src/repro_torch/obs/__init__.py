"""repro_torch.obs — process-wide telemetry: metrics registry + request
tracing (counterpart of ``repro.obs``, with its own registry and the same
catalogue of series).

See DESIGN.md §3.11. Quick taste::

    from repro_torch import obs

    obs.counter(obs.names.ENGINE_REQUESTS, engine="r0").inc()
    snap = obs.snapshot()            # plain nested dict
    print(obs.to_prometheus(snap))   # Prometheus text exposition

    sampler = obs.TraceSampler(every_n=8)
    t = sampler.sample("request", seq=16)   # deterministic 1-in-N
    ...
    t.finish(); print(t.render())           # text flamegraph

Only stdlib (+numpy) is imported here — every layer can depend on obs
without cycles; the recall estimator's device-side work
(``baselines.exact``, ``online.live_dataset``) is imported lazily inside
its worker.
"""

from repro_torch.obs import names
from repro_torch.obs.metrics import (
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsDumper,
    MetricsRegistry,
    counter,
    gauge,
    histogram,
    registry,
    reset,
    set_enabled,
    snapshot,
    timed,
    to_json,
    to_prometheus,
)
from repro_torch.obs.trace import (
    Span,
    Trace,
    TraceBuffer,
    TraceSampler,
    activate,
    active_spans,
    is_tracing,
    span,
)
from repro_torch.obs.quality import RecallEstimator, wilson
from repro_torch.obs.costlog import CostLog, build_record, load_costlog
from repro_torch.obs.slo import SLOSpec, SLOTracker
from repro_torch.obs.report import Dashboard, build_report, render_dashboard

__all__ = [
    "names",
    # metrics
    "DEFAULT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsDumper",
    "MetricsRegistry",
    "counter",
    "gauge",
    "histogram",
    "registry",
    "reset",
    "set_enabled",
    "snapshot",
    "timed",
    "to_json",
    "to_prometheus",
    # tracing
    "Span",
    "Trace",
    "TraceBuffer",
    "TraceSampler",
    "activate",
    "active_spans",
    "is_tracing",
    "span",
    # quality / cost / SLO / report (DESIGN.md §3.12)
    "RecallEstimator",
    "wilson",
    "CostLog",
    "build_record",
    "load_costlog",
    "SLOSpec",
    "SLOTracker",
    "Dashboard",
    "build_report",
    "render_dashboard",
]
