"""pdasc [paper] — the paper's own architecture: the distributed multilevel
ANN index itself, as cells (counterpart of ``repro.configs.pdasc``).

  build_1m   — sharded MSA: every rank builds its sub-index over its slice
               of a 2^20 x 100 database (GLOVE-scale, the paper's largest).
  search_1m  — sharded NSA: 4096 queries fan out, per-rank search, the
               global top-k merge (k=10, the paper's 10-NN protocol).

The kernel knobs are the port's ``KernelConfig`` fields (``row_chunk``,
``wpq``, ``qpb``, ``bq``, ``splits``, ``kb``, ``auto``), mirrored field
for field; ``repro``'s Pallas tiles ``bm`` / ``bn`` / ``bd`` / ``bg`` have
no field here (``kernels/ops.py`` maps them onto the CUDA knobs).
``group_chunk`` stays a build knob, as in the port's ``PDASCIndex.build``.
"""

import dataclasses

from repro_torch.configs.base import ArchDef, ShapeSpec, register_arch
from repro_torch.kernels.ops import KernelConfig

_KD = KernelConfig()  # single source of the launch-knob defaults


@dataclasses.dataclass(frozen=True)
class PDASCArchConfig:
    name: str = "pdasc"
    n: int = 1 << 20  # database size (padded power of two: shards evenly)
    d: int = 100  # GLOVE dimensionality
    gl: int = 1024  # group length (paper Table 2 uses 1000; padded to 2^10)
    distance: str = "euclidean"
    method: str = "pam"
    k: int = 10  # neighbours (paper protocol: 10-NN)
    n_queries: int = 4096
    radius: float = 13.0  # paper Table 2, GLOVE euclidean
    # Kernel-layer launch knobs (0 = the kernel's heuristic): rank / scan
    # warps a query and queries a block, knn's query tile and DB splits,
    # the swap sweep's slots a block, and the plain forms' streaming chunk.
    row_chunk: int = _KD.row_chunk
    wpq: int = _KD.wpq
    qpb: int = _KD.qpb
    bq: int = _KD.bq
    splits: int = _KD.splits
    kb: int = _KD.kb
    # auto=True resolves knobs left at 0 from the persisted tuner cache
    # (kernels/autotune.py); explicitly set fields (and explicit per-call
    # knobs) always win over tuned winners.
    auto: bool = _KD.auto
    # Build knobs (not launch knobs, so not in KernelConfig): groups
    # clustered per streamed slab, and the eager swap's per-sweep relative
    # improvement cutoff (0 = full convergence).
    group_chunk: int = 8
    swap_tol: float = 1e-3
    # Storage substrate: payload-tier backend ("fp32" keeps the dense
    # resident path; "int8"/"fp16"/"int4"/"binary" quantise the leaf
    # vectors), granule size (quantisation block == out-of-core fetch unit)
    # and the two-stage search's exact-rerank width (0 = ∞).
    store: str = "int8"
    store_block: int = 1024
    rerank_width: int = 128
    # Remote payload tier: host-LRU capacity (decoded granules), the
    # prefetch pool's worker count and queue depth (None = max(8,
    # cache//2)), and the simulated object store's envelope (per-op
    # latency, transfer bandwidth, concurrent-op cap).
    remote_cache_granules: int = 256
    remote_prefetch_workers: int = 2
    remote_prefetch_depth: int = None
    remote_latency_ms: float = 0.0
    remote_bandwidth_mbps: float = None
    remote_parallelism: int = 8
    # Online substrate: delta-buffer capacity for live upserts, and the
    # epoch-swap compaction triggers.
    delta_capacity: int = 4096
    compact_delta_fill: float = 0.5
    compact_tombstone_ratio: float = 0.2
    # Replicated serving tier: replica count and the router's
    # fault-tolerance knobs.
    n_replicas: int = 2
    router_deadline_s: float = 1.0
    router_max_retries: int = 2
    router_hedge: bool = True
    router_queue_limit: int = 256
    router_degrade_at: float = 0.75
    router_eject_failures: int = 3
    router_probe_cooldown_s: float = 0.2
    # Telemetry: trace 1 request in N through the router (0 = off).
    router_trace_every: int = 0
    # Quality & SLO observability: shadow-sample 1 served request in N
    # (0 = off), plus the serve SLO. None disables an objective.
    router_shadow_every: int = 0
    slo_latency_p99_s: float = None
    slo_recall_floor: float = None
    slo_availability: float = 0.999
    slo_window_s: float = 60.0

    def kernel_config(self) -> KernelConfig:
        # Built field-wise from KernelConfig's own field list so a knob
        # added to KernelConfig (mirrored here as a same-named field) can
        # never silently fall out of the arch config's kernel threading;
        # tests/test_torch_configs.py asserts the mirror stays complete.
        mirrored = {
            f: getattr(self, f)
            for f in KernelConfig._fields
            if hasattr(self, f)
        }
        return KernelConfig()._replace(**mirrored)

    def search_query(self, **overrides):
        """The arch's search protocol as a ``repro_torch.query.Query`` (k /
        radius / rerank width / kernel knobs from this config;
        ``overrides`` pick the execution preference, beam schedule, ...)."""
        from repro_torch.query import Query

        base = dict(k=self.k, radius=self.radius,
                    rerank_width=self.rerank_width,
                    kernel=self.kernel_config())
        base.update(overrides)
        return Query(**base)

    def router_config(self, **overrides):
        """The arch's router knobs as a ``repro_torch.serving.RouterConfig``."""
        from repro_torch.serving.router import RouterConfig

        base = dict(
            deadline_s=self.router_deadline_s,
            max_retries=self.router_max_retries,
            hedge=self.router_hedge,
            queue_limit=self.router_queue_limit,
            degrade_at=self.router_degrade_at,
            eject_failures=self.router_eject_failures,
            probe_cooldown_s=self.router_probe_cooldown_s,
            trace_every=self.router_trace_every,
            shadow_every=self.router_shadow_every,
        )
        base.update(overrides)
        return RouterConfig(**base)

    def slo_spec(self, **overrides):
        """The arch's serve SLO as a ``repro_torch.obs.SLOSpec``."""
        from repro_torch.obs.slo import SLOSpec

        base = dict(
            latency_p99_s=self.slo_latency_p99_s,
            recall_floor=self.slo_recall_floor,
            availability=self.slo_availability,
            window_s=self.slo_window_s,
        )
        base.update(overrides)
        return SLOSpec(**base)


def config() -> PDASCArchConfig:
    return PDASCArchConfig()


def smoke_config() -> PDASCArchConfig:
    return PDASCArchConfig(name="pdasc-smoke", n=512, d=8, gl=32,
                           n_queries=16, radius=2.0, store_block=64,
                           rerank_width=32, delta_capacity=128)


SHAPES = {
    "build_1m": ShapeSpec("build_1m", "build", dict(n=1 << 20, d=100)),
    "search_1m": ShapeSpec("search_1m", "search",
                           dict(n=1 << 20, d=100, n_queries=4096, k=10)),
}

register_arch(ArchDef(
    id="pdasc", family="pdasc", config_fn=config, smoke_fn=smoke_config,
    shapes=SHAPES, source="the paper",
))
