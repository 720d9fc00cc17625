"""Metric name catalogue — the single source of truth (counterpart of
``repro.obs.names``, equal to it series for series; DESIGN.md §3.11).

Every series the repo exports is named here, following the
``subsystem_name_unit`` convention:

* ``subsystem`` — one of :data:`SUBSYSTEMS` (the layer that owns the
  series: ``engine``, ``router``, ``plan``, ``store``, ``online``,
  ``autotune``, ``trace``, ``quality``, ``slo``);
* ``name`` — one or more snake_case words describing the quantity;
* ``unit`` — the trailing token, one of :data:`UNITS`: ``total``
  (monotonic counter), ``seconds`` / ``bytes`` (histogram, counter or
  gauge in that unit), ``ratio`` (0..1 gauge or histogram), ``count``
  (instantaneous gauge).

The default registry is *strict*: creating a series whose name is not in
:data:`CATALOGUE` raises, so an instrumented call site cannot invent an
undocumented name (``tests/test_torch_obs.py`` holds the catalogue equal
to ``repro``'s, which ``tests/test_obs.py`` lint-checks against
:data:`NAME_RE`). Ad-hoc registries (tests, experiments) pass
``strict=False`` and are held only to the regex.
"""

from __future__ import annotations

import re

SUBSYSTEMS = (
    "engine", "router", "plan", "store", "online", "autotune", "trace",
    "quality", "slo",
)

UNITS = ("total", "seconds", "bytes", "ratio", "count")

# subsystem_name_unit: subsystem prefix, >= 1 snake_case middle word, unit
# suffix. The middle words are [a-z0-9]+ tokens (no leading/trailing/_ _).
NAME_RE = re.compile(
    r"^(?P<subsystem>" + "|".join(SUBSYSTEMS) + r")"
    r"(?:_[a-z0-9]+)+"
    r"_(?P<unit>" + "|".join(UNITS) + r")$"
)

# --------------------------------------------------------------------------
# engine — the batched request engine (serving/engine.py)
# --------------------------------------------------------------------------
ENGINE_REQUESTS = "engine_requests_total"
ENGINE_BATCHES = "engine_batches_total"
ENGINE_WRITES = "engine_writes_total"
ENGINE_WRITE_BATCHES = "engine_write_batches_total"
ENGINE_PREFETCHES = "engine_prefetches_total"
ENGINE_DEADLINE_DROPS = "engine_deadline_drops_total"
ENGINE_CANCELLED_SKIPS = "engine_cancelled_skips_total"
ENGINE_HANDLER_ERRORS = "engine_handler_errors_total"
ENGINE_BATCH_OCCUPANCY = "engine_batch_occupancy_ratio"
ENGINE_QUEUE_DEPTH = "engine_queue_depth_count"
ENGINE_QUEUE_WAIT = "engine_queue_wait_seconds"
ENGINE_HANDLER_TIME = "engine_handler_seconds"

# --------------------------------------------------------------------------
# router — the fault-tolerant replicated front (serving/router.py)
# --------------------------------------------------------------------------
ROUTER_REQUESTS = "router_requests_total"
ROUTER_DISPATCHES = "router_dispatches_total"
ROUTER_RETRIES = "router_retries_total"
ROUTER_HEDGES = "router_hedges_total"
ROUTER_HEDGE_WINS = "router_hedge_wins_total"
ROUTER_REJECTS = "router_admission_rejects_total"
ROUTER_DEGRADED = "router_degraded_total"
ROUTER_FAILURES = "router_failures_total"
ROUTER_DEADLINE_EXCEEDED = "router_deadline_exceeded_total"
ROUTER_HEALTH_TRANSITIONS = "router_health_transitions_total"
ROUTER_LATENCY = "router_request_seconds"

# --------------------------------------------------------------------------
# plan — the query/plan compiler (query/plan.py)
# --------------------------------------------------------------------------
PLAN_COMPILES = "plan_compiles_total"
PLAN_CACHE_HITS = "plan_cache_hits_total"
PLAN_REPLANS = "plan_replans_total"
PLAN_EXECUTIONS = "plan_executions_total"
PLAN_COST_RECORDS = "plan_cost_records_total"

# --------------------------------------------------------------------------
# store — the tiered leaf store's out-of-core payload (store/leaf_store.py)
# --------------------------------------------------------------------------
STORE_FETCHES = "store_granule_fetches_total"
STORE_HITS = "store_granule_hits_total"
STORE_FETCH_BYTES = "store_granule_fetch_bytes"
STORE_PREFETCHED = "store_prefetch_granules_total"
STORE_PREFETCH_USEFUL = "store_prefetch_useful_total"
STORE_CACHE_GRANULES = "store_granule_cache_count"
# The cache hierarchy in front of a remote payload tier (store/cache.py):
# per-tier hit/miss accounting (labelled ``tier=``), eviction counts, the
# decoded bytes resident in the host LRU, in-flight fetch dedup, and the
# async prefetch pool's queue depth / overflow drops.
STORE_CACHE_HITS = "store_cache_hits_total"
STORE_CACHE_MISSES = "store_cache_misses_total"
STORE_CACHE_EVICTIONS = "store_cache_evictions_total"
STORE_CACHE_RESIDENT = "store_cache_resident_bytes"
STORE_CACHE_HIT_RATIO = "store_cache_hit_ratio"
STORE_CACHE_INFLIGHT_DEDUP = "store_cache_inflight_dedup_total"
STORE_PREFETCH_QUEUE = "store_prefetch_queue_count"
STORE_PREFETCH_DROPS = "store_prefetch_drops_total"
# The remote object-store tier itself (store/remote.py; not yet ported, so
# the port does not emit these yet): op counts, error
# counts (fault seam included), and the fetch latency/byte volume of
# granule reads against the backing store.
STORE_REMOTE_GETS = "store_remote_gets_total"
STORE_REMOTE_PUTS = "store_remote_puts_total"
STORE_REMOTE_ERRORS = "store_remote_errors_total"
STORE_REMOTE_FETCH_TIME = "store_remote_fetch_seconds"
STORE_REMOTE_FETCH_BYTES = "store_remote_fetch_bytes"

# --------------------------------------------------------------------------
# online — live writes / epoch swaps (online/epoch.py)
# --------------------------------------------------------------------------
ONLINE_WRITES = "online_writes_applied_total"
ONLINE_WRITE_ERRORS = "online_write_errors_total"
ONLINE_EPOCH_SWAPS = "online_epoch_swaps_total"
ONLINE_COMPACTION_TIME = "online_compaction_seconds"
ONLINE_DELTA_FILL = "online_delta_fill_ratio"
ONLINE_TOMBSTONES = "online_tombstones_count"

# --------------------------------------------------------------------------
# autotune — the launch-geometry winner cache (kernels/autotune.py)
# --------------------------------------------------------------------------
AUTOTUNE_HITS = "autotune_lookup_hits_total"
AUTOTUNE_MISSES = "autotune_lookup_misses_total"
AUTOTUNE_RETUNES = "autotune_retunes_total"

# --------------------------------------------------------------------------
# trace — the tracer's own accounting (obs/trace.py)
# --------------------------------------------------------------------------
TRACE_SAMPLED = "trace_sampled_total"
TRACE_FINISHED = "trace_finished_total"

# --------------------------------------------------------------------------
# quality — the online recall estimator (obs/quality.py)
# --------------------------------------------------------------------------
QUALITY_RECALL = "quality_recall_ratio"
QUALITY_RECALL_MEAN = "quality_recall_mean_ratio"
QUALITY_RECALL_LO = "quality_recall_wilson_lo_ratio"
QUALITY_RECALL_HI = "quality_recall_wilson_hi_ratio"
QUALITY_SAMPLED = "quality_shadow_sampled_total"
QUALITY_ANSWERED = "quality_shadow_answered_total"
QUALITY_DROPPED = "quality_shadow_dropped_total"
QUALITY_ERRORS = "quality_shadow_errors_total"
QUALITY_PENDING = "quality_shadow_pending_count"
QUALITY_LAG = "quality_shadow_lag_seconds"

# --------------------------------------------------------------------------
# slo — the declarative SLO tracker (obs/slo.py)
# --------------------------------------------------------------------------
SLO_SLI = "slo_sli_ratio"
SLO_BURN = "slo_burn_rate_ratio"
SLO_BUDGET = "slo_budget_remaining_ratio"
SLO_ALERTS = "slo_alerts_total"
SLO_EVALUATIONS = "slo_evaluations_total"

CATALOGUE: dict[str, tuple[str, str]] = {
    # name -> (kind, help)
    ENGINE_REQUESTS: ("counter", "search-like requests served per engine"),
    ENGINE_BATCHES: ("counter", "search-like batches dispatched"),
    ENGINE_WRITES: ("counter", "write ops applied between batches"),
    ENGINE_WRITE_BATCHES: ("counter", "write runs handed to the handler"),
    ENGINE_PREFETCHES: ("counter", "between-batch prefetch snapshots run"),
    ENGINE_DEADLINE_DROPS: ("counter", "requests dropped past their deadline"),
    ENGINE_CANCELLED_SKIPS: ("counter", "cancelled requests skipped at "
                                        "batch assembly"),
    ENGINE_HANDLER_ERRORS: ("counter", "batches failed by a handler error"),
    ENGINE_BATCH_OCCUPANCY: ("histogram", "valid rows / batch_size per batch"),
    ENGINE_QUEUE_DEPTH: ("gauge", "requests queued when a batch was taken"),
    ENGINE_QUEUE_WAIT: ("histogram", "enqueue -> taken-into-batch wait"),
    ENGINE_HANDLER_TIME: ("histogram", "handler call duration per batch"),
    ROUTER_REQUESTS: ("counter", "requests admitted by the router"),
    ROUTER_DISPATCHES: ("counter", "attempts dispatched, by replica"),
    ROUTER_RETRIES: ("counter", "re-dispatches after a failed attempt"),
    ROUTER_HEDGES: ("counter", "hedge twin attempts fired"),
    ROUTER_HEDGE_WINS: ("counter", "requests won by the hedge twin"),
    ROUTER_REJECTS: ("counter", "admission-control rejects (Overloaded)"),
    ROUTER_DEGRADED: ("counter", "requests rewritten onto the degraded plan"),
    ROUTER_FAILURES: ("counter", "failed attempts, by replica"),
    ROUTER_DEADLINE_EXCEEDED: ("counter", "requests that missed their "
                                          "deadline"),
    ROUTER_HEALTH_TRANSITIONS: ("counter", "health state machine edges, "
                                           "labelled from/to"),
    ROUTER_LATENCY: ("histogram", "end-to-end router request latency"),
    PLAN_COMPILES: ("counter", "plans compiled, by pipeline"),
    PLAN_CACHE_HITS: ("counter", "plan-cache hits, by pipeline"),
    PLAN_REPLANS: ("counter", "stale-fingerprint transparent replans"),
    PLAN_EXECUTIONS: ("counter", "plan executions, by pipeline"),
    PLAN_COST_RECORDS: ("counter", "plan-execution cost records appended "
                                   "to the cost log"),
    STORE_FETCHES: ("counter", "granules fetched from the exact payload"),
    STORE_HITS: ("counter", "granule requests served from the LRU"),
    STORE_FETCH_BYTES: ("counter", "bytes fetched from the exact payload"),
    STORE_PREFETCHED: ("counter", "granules warmed by prefetch"),
    STORE_PREFETCH_USEFUL: ("counter", "prefetched granules later hit by a "
                                       "real fetch"),
    STORE_CACHE_GRANULES: ("gauge", "granules resident in the exact-payload "
                                    "LRU"),
    STORE_CACHE_HITS: ("counter", "granule cache hits, by tier"),
    STORE_CACHE_MISSES: ("counter", "granule cache misses, by tier"),
    STORE_CACHE_EVICTIONS: ("counter", "granules evicted from the host LRU, "
                                       "by tier"),
    STORE_CACHE_RESIDENT: ("gauge", "decoded granule bytes resident in the "
                                    "host LRU, by tier"),
    STORE_CACHE_HIT_RATIO: ("gauge", "lifetime hit ratio of the granule "
                                     "cache, by tier"),
    STORE_CACHE_INFLIGHT_DEDUP: ("counter", "fetches coalesced onto an "
                                            "in-flight fetch of the same "
                                            "granule"),
    STORE_PREFETCH_QUEUE: ("gauge", "granule keys queued in the async "
                                    "prefetch pool"),
    STORE_PREFETCH_DROPS: ("counter", "prefetch keys dropped (queue at "
                                      "depth bound)"),
    STORE_REMOTE_GETS: ("counter", "objects fetched from the remote store"),
    STORE_REMOTE_PUTS: ("counter", "objects written to the remote store"),
    STORE_REMOTE_ERRORS: ("counter", "remote-store ops that raised "
                                     "(injected faults included)"),
    STORE_REMOTE_FETCH_TIME: ("histogram", "remote granule fetch latency"),
    STORE_REMOTE_FETCH_BYTES: ("counter", "bytes fetched from the remote "
                                          "store"),
    ONLINE_WRITES: ("counter", "upsert/delete ops applied, by op"),
    ONLINE_WRITE_ERRORS: ("counter", "write ops that failed per-op"),
    ONLINE_EPOCH_SWAPS: ("counter", "compaction epoch swaps published"),
    ONLINE_COMPACTION_TIME: ("histogram", "compact-and-swap duration"),
    ONLINE_DELTA_FILL: ("gauge", "delta buffer fill ratio after last write"),
    ONLINE_TOMBSTONES: ("gauge", "tombstoned slots after last write"),
    AUTOTUNE_HITS: ("counter", "winner-cache lookups that found knobs"),
    AUTOTUNE_MISSES: ("counter", "winner-cache lookups that missed"),
    AUTOTUNE_RETUNES: ("counter", "winners recorded (cache mutations)"),
    TRACE_SAMPLED: ("counter", "requests picked by the 1-in-N sampler"),
    TRACE_FINISHED: ("counter", "sampled traces finished and retained"),
    QUALITY_RECALL: ("histogram", "per-shadow-sample recall@k, by pipeline "
                                  "and leg"),
    QUALITY_RECALL_MEAN: ("gauge", "running recall@k estimate, by pipeline "
                                   "and leg"),
    QUALITY_RECALL_LO: ("gauge", "Wilson 95% lower bound on the recall "
                                 "estimate"),
    QUALITY_RECALL_HI: ("gauge", "Wilson 95% upper bound on the recall "
                                 "estimate"),
    QUALITY_SAMPLED: ("counter", "served queries picked for shadow "
                                 "re-answering"),
    QUALITY_ANSWERED: ("counter", "shadow samples answered exactly by the "
                                  "worker"),
    QUALITY_DROPPED: ("counter", "shadow samples dropped (queue full)"),
    QUALITY_ERRORS: ("counter", "shadow re-answers that raised"),
    QUALITY_PENDING: ("gauge", "shadow samples queued awaiting the worker"),
    QUALITY_LAG: ("histogram", "serve -> shadow-answer lag per sample"),
    SLO_SLI: ("gauge", "rolling-window SLI value, by objective"),
    SLO_BURN: ("gauge", "error-budget burn rate, by objective and window"),
    SLO_BUDGET: ("gauge", "fraction of the window's error budget left, by "
                          "objective"),
    SLO_ALERTS: ("counter", "multi-rate burn alerts fired, by objective"),
    SLO_EVALUATIONS: ("counter", "SLO evaluation passes run"),
}


def check(name: str) -> None:
    """Raise ValueError unless ``name`` follows ``subsystem_name_unit``."""
    if NAME_RE.match(name) is None:
        raise ValueError(
            f"metric name {name!r} does not match the subsystem_name_unit "
            f"convention (subsystems: {SUBSYSTEMS}; units: {UNITS})"
        )


def subsystem(name: str) -> str:
    """The owning subsystem of a conventional metric name."""
    return name.split("_", 1)[0]
