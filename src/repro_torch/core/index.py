"""PDASCIndex — the user-facing index API (counterpart of
``repro.core.index``).

    idx = PDASCIndex.build(data, gl=256, distance="euclidean")  # on CUDA
    res = idx.plan(Query(k=10))(queries)     # the batched beam pipeline

    idx = PDASCIndex.build(data, gl=256, store="int8", store_path=...)
    idx.release_dense_payload()              # leaf vectors leave the card
    res = idx.plan(Query(k=10))(queries)     # now the two-stage pipeline

    ids = idx.upsert(new_vectors)            # visible to the next search
    idx.delete(ids[:3])                      # gone from every search mode
    idx = idx.compact()                      # a new epoch: tiers folded in

    idx = PDASCIndex.build_streaming(shards, gl=256, remote=store)
    res = idx.plan(Query(k=10))(queries)     # exact rows from the remote tier

Save and load use ``repro``'s own artifact format (``<path>.npz`` arrays
named ``level{l}_{field}`` and ``leaf_ids``, the store's ``store_codes`` and
``store_scales``, plus ``<path>.json`` meta), so an index built by
``repro`` loads here and the two packages can be compared on the identical
index. :meth:`PDASCIndex.from_arrays` carries the state across. Versions 1,
2 (with or without a store), 3 (the online tiers: delta buffer and
tombstones), 4 (packed int4 / binary codes, with or without the online
tiers) and 5 (a remote exact payload: the artifact holds the navigation
tier and the codes, and the manifest of the granules in their object
store) are read and written.

The online tiers (``repro_torch.online``) make the index mutable: an upsert
appends to the delta buffer, a delete sets tombstone bits, and both are
visible to the next search through every pipeline; :meth:`compact` folds
them into a new index object (RCU: the old one stays valid for its
readers).
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
from repro_torch.core.distances import BIG
from repro_torch.kernels import ops as kops
from repro_torch.online import compact as compact_lib
from repro_torch.online import delta as delta_lib
from repro_torch.online import tombstones as tomb_lib
from repro_torch.query import plan as query_plan
from repro_torch.query import spec as query_spec
from repro_torch.store import leaf_store as store_lib

_FORMAT_VERSION = 2  # v2: tiered leaf store (payload codes + scales)
_MUTABLE_VERSION = 3  # v3: v2 + online tiers (delta buffer, tombstones)
_PACKED_VERSION = 4  # v4: packed payload codes (int4 / binary backends)
# v5: the exact fp32 tier stays in its remote object store; the artifact
# carries the store's manifest instead of level0_points
_REMOTE_VERSION = 5
_READ_VERSIONS = (1, 2, 3, 4, 5)

DEFAULT_DELTA_CAPACITY = 4096


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
    # CUDA unless the caller passes another device (raises without one)
    device: torch.device = dataclasses.field(
        default_factory=lambda: resolve_device("cuda"))
    # Payload tier. None = leaf vectors stay a dense fp32 device array
    # inside ``data.levels[0]``.
    store: Optional[store_lib.LeafStore] = None
    # Online tiers. None until the first upsert / delete (or
    # enable_mutations); compaction folds them in and starts fresh ones.
    delta: Optional[delta_lib.DeltaBuffer] = None
    tombstones: Optional[tomb_lib.TombstoneSet] = None
    epoch: int = 0
    _payload_released: bool = dataclasses.field(default=False, repr=False)
    # sorted (ids, slots) arrays for the id -> live-slot lookup (lazy)
    _id_slot: Optional[tuple] = dataclasses.field(default=None, repr=False)
    _next_id: Optional[int] = dataclasses.field(default=None, repr=False)
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
        kb: int = 0,
        shuffle: bool = True,
        store: Optional[str] = None,
        store_block: int = 1024,
        store_path: Optional[str] = None,
        device="cuda",
    ) -> "PDASCIndex":
        """Build the index on ``device`` (CUDA unless ``device="cpu"``).
        ``generator`` (a CPU ``torch.Generator``) drives the shuffle and the
        radius sample; omitted, each draws from seed 0. ``kb``: the swap
        sweep kernel's slots a block (0: its heuristic; ``repro``'s
        ``bg``). ``store`` ("int8", "fp16", "int4", "binary" or "fp32")
        also attaches the payload store (:meth:`attach_store`);
        ``store_path`` puts its exact fp32 payload on disk."""
        dev = resolve_device(device)
        dist = dist_lib.get(distance)
        dataset = _validate_points(dataset, dist, what="build")
        k_protos = n_prototypes or gl // 2
        data, stats = msa.build_index(
            dataset, gl=gl, n_prototypes=k_protos, distance=dist,
            method=method, max_swaps=max_swaps, generator=generator,
            row_chunk=row_chunk, group_chunk=group_chunk, swap_tol=swap_tol,
            kb=kb, shuffle=shuffle, device=dev,
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
    def build_streaming(cls, shards, **kwargs) -> "PDASCIndex":
        """Build shard by shard over a remote payload tier: an iterator of
        ``[m, d]`` shards that never fit in memory together, clustered and
        quantised one at a time, their exact fp32 granules flushed to
        ``remote=`` as they go. Returns the released, two-stage-served form
        (``store.exact`` a ``RemoteSource``); the knobs are
        :func:`repro_torch.store.streaming.build_streaming`'s."""
        from repro_torch.store import streaming as streaming_lib

        return streaming_lib.build_streaming(shards, **kwargs)

    @classmethod
    def from_arrays(cls, arrays: dict, meta: dict, device="cuda", *,
                    remote=None, cache_granules: int = 256,
                    prefetch_workers: int = 2) -> "PDASCIndex":
        """An index from ``repro``'s saved arrays (``level{l}_{field}``,
        ``leaf_ids``, and ``store_codes`` / ``store_scales`` with a store)
        and JSON meta, placed on ``device``. A store's exact payload is the
        saved ``level0_points``, kept as a host array; the dense leaf array
        is resident again, as after ``repro``'s load. A remote manifest (v5)
        instead reopens the payload's object store (``remote``, a live
        ``RemoteStore``, or else ``remote.open_store`` of the manifest)
        behind a ``RemoteSource`` of ``cache_granules`` and
        ``prefetch_workers``, and the index loads released. ``mutable``
        meta (v3, or v4 / v5 with it) restores the delta buffer
        (``delta_{vectors,ids,slots,active}``), the tombstone bits and the
        id ceiling."""
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
        store = manifest = None
        store_meta = meta.get("store")
        if store_meta is not None:
            manifest = store_meta.get("remote")
            if manifest is not None:  # v5: the payload stays remote
                from repro_torch.store import remote as remote_lib

                exact = remote_lib.RemoteSource(
                    remote if remote is not None
                    else remote_lib.open_store(manifest),
                    n=int(manifest["n"]), d=int(manifest["d"]),
                    block=int(manifest["block"]),
                    prefix=manifest.get("prefix", ""),
                    cache_granules=cache_granules,
                    prefetch_workers=prefetch_workers)
            else:
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
        idx = cls(data=data, stats=stats,
                  distance=dist_lib.get(meta["distance"]), gl=meta["gl"],
                  n_prototypes=meta["n_prototypes"],
                  max_children=tuple(meta["max_children"]),
                  default_radius=meta["default_radius"], device=dev,
                  store=store, epoch=int(meta.get("epoch", 0)),
                  _payload_released=manifest is not None)
        mut = meta.get("mutable")
        if mut is not None:
            idx.delta = delta_lib.DeltaBuffer(int(mut["delta_capacity"]),
                                              idx._dim(), device=dev)
            if int(mut["delta_size"]):
                idx.delta.load(*(np.asarray(arrays[f"delta_{f}"]) for f in
                                 ("vectors", "ids", "slots", "active")))
            if mut.get("next_id") is not None:
                idx._next_id = int(mut["next_id"])
            idx.tombstones = tomb_lib.TombstoneSet(
                levels[0].points.shape[0], bits=arrays.get("tombstone_bits"),
                device=dev)
        return idx

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

    # -- online mutability ------------------------------------------------------

    def enable_mutations(self, *, delta_capacity: int = DEFAULT_DELTA_CAPACITY
                         ) -> None:
        """Attach the online tiers (delta buffer + tombstones). Implicit on
        the first :meth:`upsert` / :meth:`delete`; call it to choose the
        delta capacity. Writes are not safe against concurrent searches on
        the same object: ``online.EpochHandle`` serialises them."""
        if self.delta is None:
            self.delta = delta_lib.DeltaBuffer(delta_capacity, self._dim(),
                                               device=self.device)
        if self.tombstones is None:
            self.tombstones = tomb_lib.TombstoneSet(
                self.data.levels[0].points.shape[0], device=self.device)

    def _slots_for_ids(self, ids) -> np.ndarray:
        """Vectorised id -> leaf slot (-1 where the id is not a live
        resident), through a lazily built pair of sorted arrays."""
        if self._id_slot is None:
            leaf_ids = self.data.leaf_ids.cpu().numpy()
            live = self.data.levels[0].valid.cpu().numpy() & (leaf_ids >= 0)
            slots = np.nonzero(live)[0].astype(np.int64)
            keys = leaf_ids[live].astype(np.int64)
            order = np.argsort(keys)
            self._id_slot = (keys[order], slots[order])
        keys, slots = self._id_slot
        ids = np.asarray(ids, np.int64).reshape(-1)
        if keys.size == 0:
            return np.full(ids.shape, -1, np.int64)
        pos = np.clip(np.searchsorted(keys, ids), 0, keys.size - 1)
        return np.where(keys[pos] == ids, slots[pos], -1)

    def _route_to_leaf(self, V: np.ndarray,
                       kernel: Optional[kops.KernelConfig] = None
                       ) -> np.ndarray:
        """Nearest leaf slot per row: the beam descent at beam 1, then one
        k = 1 ``rank_gathered`` (or ``scan_quantized`` over the codes once
        the payload is released). A row whose candidates are all masked
        routes to slot 0, as ``repro``'s does."""
        Qb = torch.from_numpy(np.asarray(V, np.float32)).to(self.device)
        cand_idx, cand_ok = nsa.descend_beam(
            self.data, Qb, dist=self.distance, r=float("inf"), beam=1,
            max_children=self.max_children, kernel=kernel)
        if not self._payload_released:
            leaf = self.data.levels[0]
            d, slot = kops.rank_gathered(
                Qb, leaf.points, leaf.sq_norm, cand_idx, cand_ok,
                self.distance, k=1, config=kernel)
        else:
            d, slot = kops.scan_quantized(
                Qb, self.store.codes, self.store.scales, cand_idx, cand_ok,
                self.distance, k=1, block=self.store.block,
                code_format=self.store.code_format, config=kernel)
        slots = torch.gather(cand_idx, 1, slot.long())[:, 0]
        found = d[:, 0] < BIG / 2
        return torch.where(found, slots, 0).to(torch.int32).cpu().numpy()

    def upsert(self, vectors, ids=None, *,
               kernel: Optional[kops.KernelConfig] = None) -> np.ndarray:
        """Insert (or replace) points, visible to the very next search.

        ``ids``: optional int ids; omitted, fresh ids above every id the
        index has seen. An existing id is replaced: its older occurrence
        (a resident slot or an earlier delta entry) is tombstoned or
        deactivated and the new vector appended. Returns the ids. Raises
        when the delta buffer cannot hold the batch: compact first."""
        if self.delta is None:
            self.enable_mutations()
        V = np.atleast_2d(np.asarray(
            vectors.cpu() if isinstance(vectors, torch.Tensor) else vectors,
            np.float32))
        V = _validate_points(V, self.distance, what="upsert")
        m = V.shape[0]
        if ids is None:
            ids = self._fresh_ids(m)
        ids = np.asarray(ids, np.int32).reshape(-1)
        if ids.shape[0] != m:
            raise ValueError(f"{m} vectors but {ids.shape[0]} ids")
        if np.unique(ids).shape[0] != m:
            raise ValueError("duplicate ids within one upsert batch")
        if self.delta.free < m:
            raise RuntimeError(
                f"delta buffer full ({self.delta.size}/{self.delta.capacity}"
                f" used, {m} requested); call compact() to fold it in")
        self.delta.deactivate_ids(ids)  # replace: retire older occurrences
        stale = self._slots_for_ids(ids)
        stale = stale[stale >= 0]
        if stale.size:
            self.tombstones.add(stale)
        self.delta.append(V, ids, self._route_to_leaf(V, kernel))
        self._bump_next_id(ids)
        return ids

    def delete(self, ids) -> int:
        """Delete by id: tombstone bits and delta deactivations, the index
        arrays stay frozen. Returns the number of live points removed
        (unknown ids are ignored)."""
        if self.delta is None:
            self.enable_mutations()
        ids = np.asarray(ids, np.int32).reshape(-1)
        n = self.delta.deactivate_ids(ids)
        slots = self._slots_for_ids(ids)
        slots = slots[slots >= 0]
        if slots.size:
            n += self.tombstones.add(slots)
        return n

    def _seen_id_ceiling(self) -> int:
        """One above every id this index has seen, deleted and deactivated
        ones included, so that a freed id is never issued again
        (compaction and save/load carry it)."""
        if self._next_id is not None:
            return self._next_id
        hi = int(self.data.leaf_ids.max()) if self.data.leaf_ids.numel() \
            else -1
        if self.delta is not None and self.delta.size:
            hi = max(hi, int(self.delta.ids[: self.delta.size].max()))
        return hi + 1

    def _fresh_ids(self, m: int) -> np.ndarray:
        self._next_id = self._seen_id_ceiling()
        out = np.arange(self._next_id, self._next_id + m, dtype=np.int32)
        self._next_id += m
        return out

    def _bump_next_id(self, ids: np.ndarray) -> None:
        if self._next_id is not None and ids.size:
            self._next_id = max(self._next_id, int(ids.max()) + 1)

    def needs_compaction(self, *, delta_fill: float = 0.5,
                         tombstone_ratio: float = 0.2) -> bool:
        """The compaction trigger: the delta append cursor past
        ``delta_fill`` of capacity, or tombstones past ``tombstone_ratio``
        of the resident population (``stats.level_sizes[0]``)."""
        if self.delta is not None and self.delta.fill_ratio() >= delta_fill:
            return True
        if self.tombstones is not None and self.tombstones.count:
            return (self.tombstones.ratio(self.stats.level_sizes[0])
                    >= tombstone_ratio)
        return False

    def compact(self, *, scope: str = "affected", **kwargs) -> "PDASCIndex":
        """Fold the online tiers into a fresh epoch
        (:func:`repro_torch.online.compact.compact_index`). Never mutates
        ``self``: returns a new index with ``epoch + 1`` and empty tiers of
        the same delta capacity."""
        new = compact_lib.compact_index(self, scope=scope, **kwargs)
        new.enable_mutations(
            delta_capacity=self.delta.capacity if self.delta is not None
            else DEFAULT_DELTA_CAPACITY)
        return new

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
        key = (query, query_plan.capabilities(self, query.kernel))
        plan = self._plan_cache.get(key)
        if plan is not None:
            query_plan.record_cache_hit(plan.pipeline)
            return plan
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

    def per_level_radii(self, *, quantile: float = 0.5) -> tuple[float, ...]:
        """Per-level radii (:func:`repro_torch.core.radius.per_level_radii`)
        from the index's default radius."""
        return radius_lib.per_level_radii(
            self.data, self.distance, base_radius=self.default_radius,
            quantile=quantile)

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
        """Live points: residents less tombstones plus active delta."""
        n = int(self.data.levels[0].valid.sum())
        if self.tombstones is not None:
            n -= self.tombstones.count
        if self.delta is not None:
            n += self.delta.n_active
        return n

    def memory_bytes(self) -> dict:
        """Per-tier memory accounting.

        ``navigation``: the prototype levels 1..L plus the leaf bookkeeping
        arrays (valid / parent / child / sq_norm / leaf_ids), always on the
        device. ``payload``: the leaf vectors' device bytes: the dense fp32
        array, plus the quantised codes + scales once a store is attached
        (the dense copy goes with :meth:`release_dense_payload`).
        ``out_of_core``: exact fp32 payload bytes on the host or on disk (0
        without a quantised store, and for a remote tier).
        ``remote_bytes``: the exact payload held by a remote object store
        (resident nowhere on this node). ``host_cache``: decoded granules
        held by the LRU of an on-disk or remote payload, counted into
        ``total_resident`` (a host array's cache holds views of the
        already-counted array). ``delta`` / ``tombstones``: the online
        tiers' host bytes (0 until mutations are enabled)."""
        nav = 0
        for lv in self.data.levels[1:]:
            nav += sum(getattr(lv, f).nbytes for f in lv._fields)
        leaf = self.data.levels[0]
        nav += sum(getattr(leaf, f).nbytes for f in leaf._fields
                   if f != "points")
        nav += self.data.leaf_ids.nbytes
        payload = 0 if self._payload_released else int(leaf.points.nbytes)
        out_of_core = remote_b = host_cache = 0
        if self.store is not None and self.store.backend != "fp32":
            payload += self.store.resident_bytes
            exact = self.store.exact
            remote = getattr(exact, "remote", False)
            if remote:
                remote_b = exact.nbytes
            else:
                out_of_core = self.store.out_of_core_bytes
            if remote or exact.on_disk:
                host_cache = exact.cache_resident_bytes
        delta_b = self.delta.nbytes if self.delta is not None else 0
        tomb_b = self.tombstones.nbytes if self.tombstones is not None else 0
        n = max(self.n_points, 1)
        total = nav + payload + host_cache + delta_b + tomb_b
        return dict(
            navigation=int(nav),
            payload=int(payload),
            out_of_core=int(out_of_core),
            remote_bytes=int(remote_b),
            host_cache=int(host_cache),
            delta=int(delta_b),
            tombstones=int(tomb_b),
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
            exact = self.store.exact
            where = ("in a remote store" if getattr(exact, "remote", False)
                     else "on disk" if exact.on_disk else "in host memory")
            lines.append(
                f"  store: {self.store.backend}, block {self.store.block}, "
                f"exact payload {where}"
                + (", dense payload released" if self._payload_released
                   else ""))
        if self.delta is not None or self.tombstones is not None:
            nd = self.delta.n_active if self.delta is not None else 0
            nt = self.tombstones.count if self.tombstones is not None else 0
            lines.append(f"  online: {nd} delta, {nt} tombstoned")
        return "\n".join(lines)

    # -- persistence ----------------------------------------------------------

    def save(self, path: str) -> None:
        """Atomic save in ``repro``'s format: :meth:`to_arrays`'s arrays as
        ``<path>.npz`` and its meta as ``<path>.json``."""
        arrays, meta = self.to_arrays()
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

    def to_arrays(self) -> tuple[dict, dict]:
        """The index as ``repro``'s artifact holds it, the inverse of
        :meth:`from_arrays`: host arrays (``level{l}_{field}``,
        ``leaf_ids``, a store's ``store_codes`` / ``store_scales``, the
        online tiers' ``delta_*`` rows and ``tombstone_bits``) and the JSON
        meta. Version 2; 3 with the online tiers (so a loaded index resumes
        with the same live set and id ceiling); 4 for packed int4 / binary
        codes, the online tiers then in its ``mutable`` meta. The exact
        fp32 payload is ``level0_points`` (read back from the out-of-core
        source if the dense copy was released), except behind a remote
        store: version 5 then keeps the payload there and writes the
        store's manifest under ``store["remote"]``. Distances persist by
        name, so the distance must be the registry's entry."""
        try:
            registered = dist_lib.get(self.distance.name)
        except KeyError:
            registered = None
        if registered is None or (registered is not self.distance and
                                  not dist_lib._same_entry(registered,
                                                           self.distance)):
            raise ValueError(
                f"distance {self.distance.name!r} is not the registry's entry "
                f"of that name; an artifact persists distances by name only"
            )
        arrays = {"leaf_ids": self.data.leaf_ids.cpu().numpy()}
        for l, lv in enumerate(self.data.levels):
            for field in lv._fields:
                arrays[f"level{l}_{field}"] = getattr(lv, field).cpu().numpy()
        store_meta = None
        version = _FORMAT_VERSION
        remote_exact = self.store is not None and getattr(
            self.store.exact, "remote", False)
        if self.store is not None:
            if self._payload_released and not remote_exact:
                arrays["level0_points"] = self.store.exact.read_all()
            store_meta = dict(backend=self.store.backend,
                              block=self.store.block)
            if remote_exact:  # the payload stays remote: its manifest only
                store_meta["remote"] = self.store.exact.manifest()
            if self.store.backend != "fp32":
                arrays["store_codes"] = self.store.codes.cpu().numpy()
                arrays["store_scales"] = self.store.scales.cpu().numpy()
        mutable_meta = None
        if self.delta is not None or self.tombstones is not None:
            version = _MUTABLE_VERSION
            delta = self.delta
            mutable_meta = dict(
                delta_capacity=delta.capacity if delta is not None
                else DEFAULT_DELTA_CAPACITY,
                delta_size=delta.size if delta is not None else 0,
                next_id=self._seen_id_ceiling(),
            )
            if delta is not None:
                arrays["delta_vectors"] = delta.vectors[: delta.size]
                arrays["delta_ids"] = delta.ids[: delta.size]
                arrays["delta_slots"] = delta.leaf_slot[: delta.size]
                arrays["delta_active"] = delta.active[: delta.size]
            if self.tombstones is not None:
                arrays["tombstone_bits"] = self.tombstones.bits
        if store_meta is not None and store_meta["backend"] in ("int4",
                                                                "binary"):
            version = _PACKED_VERSION  # dc != d: unreadable before v4
        if remote_exact:
            version = _REMOTE_VERSION  # no level0_points: unreadable before v5
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
            mutable=mutable_meta,
        )
        return arrays, meta

    @classmethod
    def load(cls, path: str, *, device="cuda", remote=None,
             cache_granules: int = 256, prefetch_workers: int = 2
             ) -> "PDASCIndex":
        """Load an artifact written by ``repro`` or by :meth:`save`:
        versions 1 to 5. A v5 artifact reopens its object store from the
        manifest (``localfs``) unless ``remote`` passes a live store (a
        ``sim`` store must be passed); ``cache_granules`` and
        ``prefetch_workers`` size the host LRU and prefetch pool in front
        of it."""
        with open(path + ".json") as f:
            meta = json.load(f)
        version = meta.get("version")
        if version not in _READ_VERSIONS:
            raise ValueError(
                f"unsupported index format version {version!r} in "
                f"{path + '.json'}; repro_torch reads versions {_READ_VERSIONS}"
            )
        with np.load(path + ".npz") as z:
            arrays = {name: z[name] for name in z.files}
        return cls.from_arrays(arrays, meta, device=device, remote=remote,
                               cache_granules=cache_granules,
                               prefetch_workers=prefetch_workers)
