"""PDASCIndex — the user-facing index API (counterpart of
``repro.core.index``).

    idx = PDASCIndex.build(data, gl=256, distance="euclidean")  # on CUDA
    res = idx.plan(Query(k=10))(queries)     # the batched beam pipeline

    idx = PDASCIndex.build(data, gl=256, store="int8", store_path=...)
    idx.release_dense_payload()              # leaf vectors leave the card
    res = idx.plan(Query(k=10))(queries)     # now the two-stage pipeline

Save and load use ``repro``'s own artifact format (``<path>.npz`` arrays
named ``level{l}_{field}`` and ``leaf_ids``, the store's ``store_codes`` and
``store_scales``, plus ``<path>.json`` meta), so an index built by
``repro`` loads here and the two packages can be compared on the identical
index. :meth:`PDASCIndex.from_arrays` carries the state across. Versions 1,
2 (with or without a store) and 4 (packed int4 / binary codes) are read;
``repro``'s online tiers (3) and remote payload manifests (5) are not yet
ported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import distances as dist_lib
from repro_torch.core import msa, nsa, radius as radius_lib
from repro_torch.kernels import ops as kops
from repro_torch.query import plan as query_plan
from repro_torch.query import spec as query_spec
from repro_torch.store import leaf_store as store_lib

_FORMAT_VERSION = 2  # v2: tiered leaf store (payload codes + scales)
_PACKED_VERSION = 4  # v4: packed payload codes (int4 / binary backends)
_READ_VERSIONS = (1, 2, 4)
_NOT_PORTED_VERSIONS = (3, 5)  # online tiers, remote payload


def _validate_points(x, dist: dist_lib.Distance, *, what: str) -> np.ndarray:
    """Shape / dimensionality / finiteness validation of build input."""
    x = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x, np.float32)
    if x.ndim != 2:
        raise ValueError(f"{what} input must be [n, d], got shape {x.shape}")
    if dist.needs_dim is not None and x.shape[1] != dist.needs_dim:
        raise ValueError(
            f"distance {dist.name!r} needs d={dist.needs_dim} inputs, got "
            f"d={x.shape[1]} at {what} time"
        )
    if not np.isfinite(x).all():
        bad = int((~np.isfinite(x).all(axis=1)).sum())
        raise ValueError(
            f"{what} input contains non-finite values ({bad} rows with "
            f"NaN/inf); clean the data before indexing"
        )
    return x


@dataclasses.dataclass
class PDASCIndex:
    data: msa.PDASCIndexData
    stats: msa.BuildStats
    distance: dist_lib.Distance
    gl: int
    n_prototypes: int
    max_children: tuple[int, ...]
    default_radius: float
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))
    # Payload tier. None = leaf vectors stay a dense fp32 device array
    # inside ``data.levels[0]``.
    store: Optional[store_lib.LeafStore] = None
    epoch: int = 0
    _payload_released: bool = dataclasses.field(default=False, repr=False)
    # plan cache: (Query, capability fingerprint) -> SearchPlan
    _plan_cache: Optional[dict] = dataclasses.field(default=None, repr=False)

    # -- construction --------------------------------------------------------

    @classmethod
    def build(
        cls,
        dataset,
        *,
        gl: int,
        n_prototypes: Optional[int] = None,
        distance="euclidean",
        method: str = "pam",
        max_swaps: int = 64,
        generator: Optional[torch.Generator] = None,
        radius_quantile: float = 0.05,
        row_chunk: int = 512,
        group_chunk: int = 8,
        swap_tol: float = 1e-3,
        shuffle: bool = True,
        store: Optional[str] = None,
        store_block: int = 1024,
        store_path: Optional[str] = None,
        device="cuda",
    ) -> "PDASCIndex":
        """Build the index on ``device`` (CUDA unless ``device="cpu"``).
        ``generator`` (a CPU ``torch.Generator``) drives the shuffle and the
        radius sample; omitted, each draws from seed 0. ``store`` ("int8",
        "fp16", "int4", "binary" or "fp32") also attaches the payload store
        (:meth:`attach_store`); ``store_path`` puts its exact fp32 payload
        on disk."""
        dev = resolve_device(device)
        dist = dist_lib.get(distance)
        dataset = _validate_points(dataset, dist, what="build")
        k_protos = n_prototypes or gl // 2
        data, stats = msa.build_index(
            dataset, gl=gl, n_prototypes=k_protos, distance=dist,
            method=method, max_swaps=max_swaps, generator=generator,
            row_chunk=row_chunk, group_chunk=group_chunk, swap_tol=swap_tol,
            shuffle=shuffle, device=dev,
        )
        default_r = radius_lib.estimate_radius(
            torch.from_numpy(dataset).to(dev), dist, quantile=radius_quantile,
            generator=generator,
        )
        idx = cls(data=data, stats=stats, distance=dist, gl=gl,
                  n_prototypes=k_protos, max_children=msa.max_children(data),
                  default_radius=default_r, device=dev)
        if store is not None:
            idx.attach_store(store, block=store_block, path=store_path)
        return idx

    @classmethod
    def from_arrays(cls, arrays: dict, meta: dict, device="cuda"
                    ) -> "PDASCIndex":
        """An index from ``repro``'s saved arrays (``level{l}_{field}``,
        ``leaf_ids``, and ``store_codes`` / ``store_scales`` with a store)
        and JSON meta, placed on ``device``. A store's exact payload is the
        saved ``level0_points``, kept as a host array; the dense leaf array
        is resident again, as after ``repro``'s load."""
        if meta.get("mutable") is not None:
            raise NotImplementedError(
                "online tiers are not yet ported to repro_torch; save the "
                "index without them")
        dev = resolve_device(device)

        def tensor(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        levels = []
        for l in range(meta["n_levels"]):
            f = {name: tensor(arrays[f"level{l}_{name}"])
                 for name in msa.PDASCLevel._fields
                 if f"level{l}_{name}" in arrays}
            pts = f["points"].float()
            levels.append(msa.PDASCLevel(
                points=pts,
                valid=f["valid"].to(torch.bool),
                parent=f["parent"].to(torch.int32),
                child_start=f["child_start"].to(torch.int32),
                child_count=f["child_count"].to(torch.int32),
                # an index saved before the norm cache has no sq_norm
                sq_norm=f["sq_norm"].float() if "sq_norm" in f
                else (pts * pts).sum(-1),
            ))
        data = msa.PDASCIndexData(
            levels=tuple(levels),
            leaf_ids=tensor(arrays["leaf_ids"]).to(torch.int32))
        stats = msa.BuildStats(level_sizes=tuple(meta["level_sizes"]),
                               level_td=tuple(meta["level_td"]),
                               n_levels=meta["n_levels"])
        store = None
        store_meta = meta.get("store")
        if store_meta is not None:
            exact = store_lib.ExactSource(
                np.asarray(arrays["level0_points"], np.float32),
                store_meta["block"])
            codes = scales = None
            if store_meta["backend"] != "fp32":
                codes = tensor(arrays["store_codes"])
                scales = tensor(arrays["store_scales"]).float()
            store = store_lib.LeafStore(
                backend=store_meta["backend"], block=store_meta["block"],
                codes=codes, scales=scales, exact=exact)
        return cls(data=data, stats=stats,
                   distance=dist_lib.get(meta["distance"]), gl=meta["gl"],
                   n_prototypes=meta["n_prototypes"],
                   max_children=tuple(meta["max_children"]),
                   default_radius=meta["default_radius"], device=dev,
                   store=store, epoch=int(meta.get("epoch", 0)))

    # -- payload tier ----------------------------------------------------------

    def attach_store(self, backend: str = "int8", *, block: int = 1024,
                     path: Optional[str] = None, cache_granules: int = 256
                     ) -> store_lib.LeafStore:
        """Create the payload tier from the leaf vectors (index slot
        layout). The codes are made on the index's device and stay there;
        ``path`` backs the exact fp32 payload with an on-disk memmap read in
        ``block``-row granules, None keeps a host copy. Returns the store
        (also ``self.store``)."""
        if self._payload_released:
            raise ValueError(
                "leaf payload already released; rebuild or load the index "
                "before attaching a new store")
        self.store = store_lib.LeafStore.create(
            self.data.levels[0].points, backend, block=block, path=path,
            cache_granules=cache_granules, device=self.device)
        return self.store

    def release_dense_payload(self) -> None:
        """Drop the device-resident fp32 leaf vectors. Needs a quantised
        store; afterwards only ``execution="two_stage"`` can serve (and
        ``"auto"`` resolves to it). The leaf level keeps its row count as a
        ``[n_0, 0]`` placeholder, and its bookkeeping arrays."""
        if self.store is None or self.store.backend == "fp32":
            raise ValueError(
                "release_dense_payload needs a quantised store "
                "(attach_store('int8'|'fp16'|'int4'|'binary') first)")
        if self._payload_released:
            return
        leaf = self.data.levels[0]
        placeholder = leaf.points.new_zeros((leaf.points.shape[0], 0))
        self.data = self.data._replace(
            levels=(leaf._replace(points=placeholder),) + self.data.levels[1:])
        self._payload_released = True

    # -- search ---------------------------------------------------------------

    def plan(self, query=None, **overrides) -> "query_plan.SearchPlan":
        """Compile a :class:`~repro_torch.query.Query` (or keyword
        overrides on one) into a cached executable plan."""
        if query is None:
            query = query_spec.Query(**overrides)
        elif overrides:
            query = dataclasses.replace(query, **overrides)
        if self._plan_cache is None:
            self._plan_cache = {}
        key = (query, query_plan.capabilities(self))
        plan = self._plan_cache.get(key)
        if plan is None:
            plan = self._plan_cache[key] = query_plan.compile_plan(self, query)
        return plan

    def search(self, queries, *, k: int = 10, r: Optional[float] = None,
               query: Optional[query_spec.Query] = None, beam=32,
               leaf_radius_filter: bool = False,
               kernel: Optional[kops.KernelConfig] = None) -> nsa.SearchResult:
        """k-ANN search: a build-plan-and-run wrapper over :meth:`plan`."""
        if query is None:
            query = query_spec.Query(
                k=k, radius=float(r) if r is not None else None, beam=beam,
                leaf_radius_filter=leaf_radius_filter, kernel=kernel)
        return self.plan(query)(queries)

    # -- stats ----------------------------------------------------------------

    def _dim(self) -> int:
        if self.store is not None:
            return self.store.d
        return self.data.levels[-1].points.shape[1]

    @property
    def n_levels(self) -> int:
        return len(self.data.levels)

    @property
    def n_points(self) -> int:
        return int(self.data.levels[0].valid.sum())

    def memory_bytes(self) -> dict:
        """Per-tier memory accounting.

        ``navigation``: the prototype levels 1..L plus the leaf bookkeeping
        arrays (valid / parent / child / sq_norm / leaf_ids), always on the
        device. ``payload``: the leaf vectors' device bytes: the dense fp32
        array, plus the quantised codes + scales once a store is attached
        (the dense copy goes with :meth:`release_dense_payload`).
        ``out_of_core``: exact fp32 payload bytes on the host or on disk (0
        without a quantised store). ``host_cache``: decoded granules held
        by the LRU of an on-disk payload (a host array's cache holds views
        of the already-counted array)."""
        nav = 0
        for lv in self.data.levels[1:]:
            nav += sum(getattr(lv, f).nbytes for f in lv._fields)
        leaf = self.data.levels[0]
        nav += sum(getattr(leaf, f).nbytes for f in leaf._fields
                   if f != "points")
        nav += self.data.leaf_ids.nbytes
        payload = 0 if self._payload_released else int(leaf.points.nbytes)
        out_of_core = host_cache = 0
        if self.store is not None and self.store.backend != "fp32":
            payload += self.store.resident_bytes
            out_of_core = self.store.out_of_core_bytes
            if self.store.exact.on_disk:
                host_cache = self.store.exact.cache_resident_bytes
        n = max(self.n_points, 1)
        total = nav + payload + host_cache
        return dict(
            navigation=int(nav),
            payload=int(payload),
            out_of_core=int(out_of_core),
            host_cache=int(host_cache),
            total_resident=int(total),
            payload_bytes_per_vector=round(payload / n, 2),
            total_bytes_per_vector=round(total / n, 2),
        )

    def describe(self) -> str:
        lines = [
            f"PDASCIndex(distance={self.distance.name}, gl={self.gl}, "
            f"nPrototypes={self.n_prototypes}, levels={self.n_levels}, "
            f"epoch={self.epoch}, device={self.device})"
        ]
        for l, (size, td) in enumerate(zip(self.stats.level_sizes,
                                           self.stats.level_td)):
            slots = self.data.levels[l].points.shape[0]
            lines.append(f"  level {l}: {size} valid / {slots} slots, TD={td:.4g}")
        if self.store is not None:
            where = "on disk" if self.store.exact.on_disk else "in host memory"
            lines.append(
                f"  store: {self.store.backend}, block {self.store.block}, "
                f"exact payload {where}"
                + (", dense payload released" if self._payload_released
                   else ""))
        return "\n".join(lines)

    # -- persistence ----------------------------------------------------------

    def save(self, path: str) -> None:
        """Atomic save in ``repro``'s format: ``<path>.npz`` arrays +
        ``<path>.json`` meta. Version 2, or 4 for packed int4 / binary
        codes. A store saves its codes and scales, and the exact fp32
        payload is always saved as ``level0_points`` (read back from the
        out-of-core source if the dense copy was released), so the artifact
        reloads self-contained. Distances persist by name, so the distance
        must be the registry's entry."""
        try:
            registered = dist_lib.get(self.distance.name)
        except KeyError:
            registered = None
        if registered is None or (registered is not self.distance and
                                  not dist_lib._same_entry(registered,
                                                           self.distance)):
            raise ValueError(
                f"distance {self.distance.name!r} is not the registry's entry "
                f"of that name; save() persists distances by name only"
            )
        arrays = {"leaf_ids": self.data.leaf_ids.cpu().numpy()}
        for l, lv in enumerate(self.data.levels):
            for field in lv._fields:
                arrays[f"level{l}_{field}"] = getattr(lv, field).cpu().numpy()
        store_meta = None
        version = _FORMAT_VERSION
        if self.store is not None:
            if self._payload_released:
                arrays["level0_points"] = self.store.exact.read_all()
            store_meta = dict(backend=self.store.backend,
                              block=self.store.block)
            if self.store.backend != "fp32":
                arrays["store_codes"] = self.store.codes.cpu().numpy()
                arrays["store_scales"] = self.store.scales.cpu().numpy()
            if self.store.backend in ("int4", "binary"):
                version = _PACKED_VERSION  # dc != d: unreadable before v4
        meta = dict(
            version=version,
            distance=self.distance.name,
            gl=self.gl,
            n_prototypes=self.n_prototypes,
            n_levels=self.n_levels,
            max_children=list(self.max_children),
            default_radius=self.default_radius,
            level_sizes=list(self.stats.level_sizes),
            level_td=list(self.stats.level_td),
            store=store_meta,
            epoch=self.epoch,
            mutable=None,
        )
        d = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(d, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=d, suffix=".npz", delete=False) as f:
            np.savez_compressed(f, **arrays)
            tmp = f.name
        os.replace(tmp, path + ".npz")
        with tempfile.NamedTemporaryFile("w", dir=d, suffix=".json",
                                         delete=False) as f:
            json.dump(meta, f)
            tmp = f.name
        os.replace(tmp, path + ".json")

    @classmethod
    def load(cls, path: str, *, device="cuda") -> "PDASCIndex":
        """Load an artifact written by ``repro`` or by :meth:`save`:
        versions 1, 2 and 4."""
        with open(path + ".json") as f:
            meta = json.load(f)
        version = meta.get("version")
        if version in _NOT_PORTED_VERSIONS:
            raise NotImplementedError(
                f"index format version {version} (online tiers or a remote "
                f"payload manifest) is not yet ported to repro_torch "
                f"({path + '.json'})"
            )
        if version not in _READ_VERSIONS:
            raise ValueError(
                f"unsupported index format version {version!r} in "
                f"{path + '.json'}; repro_torch reads versions {_READ_VERSIONS}"
            )
        with np.load(path + ".npz") as z:
            arrays = {name: z[name] for name in z.files}
        return cls.from_arrays(arrays, meta, device=device)
