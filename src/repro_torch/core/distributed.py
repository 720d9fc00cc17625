"""Distributed PDASC over ``torch.distributed``: sharded build, sharded
search, global top-k merge (counterpart of ``repro.core.distributed``).

The paper's deployment model (§3.1): the dataset is partitioned across
nodes, each node clusters its own groups, a query fans out to the nodes
and their results merge globally. ``repro`` runs it under ``shard_map``
with one stacked index whose leaves carry a leading shard axis. Here it is
SPMD over processes, one rank each:

* **build** — rank ``p`` (the linear index of its coordinates on the
  database axes) takes rows ``[p*per, (p+1)*per)`` of the global data,
  uploads only those, and builds its own sub-index, a plain
  ``PDASCIndexData`` (:func:`build_sharded`). Ranks that differ only on
  other axes (``model``) build the same shard: the database is replicated
  over them.
* **search** — every rank answers the replicated queries against its own
  sub-index through the port's dense or beam search (its CUDA kernels on
  the card), lifts local rows to global ones, and the per-rank top-k merge
  over the database axes (:func:`search_sharded`).
* **storage** — the navigation tier replicates and the quantised payload
  shards by leaf-row range (:func:`shard_payload`,
  :func:`scan_quantized_sharded`, :func:`payload_placement`).
* **one process** — :func:`build_stacked` and :func:`search_stacked` run
  every shard in turn on one device, over ``repro``'s stacked index (a
  leading shard axis on every leaf): the global step of the PDASC cells
  (``launch/steps.py``), equal to what the ranks build and return.

Merges (the collective hot path; ``[B, k]`` pairs per rank):

``topk_merge_allgather``
    one ``all_gather`` of every rank's pairs over the axis, then each rank
    selects from ``P*k`` candidates.
``topk_merge_butterfly``
    ``log2(P)`` rounds; in round t a rank exchanges its pairs with
    ``rank ^ (1 << t)`` in the axis group (``batch_isend_irecv``) and keeps
    the k smallest of the 2k. Refuses an axis whose size is not a power of
    two.

Both keep the k smallest keyed on (distance, global id): a stable sort by
id, then a stable sort by distance, in plain PyTorch on the tensors'
device (``repro`` takes ``jax.lax.top_k`` outside any kernel). The key is
a total order, so the butterfly and the all-gather agree bit for bit and
every rank returns identical tensors; ``repro``'s butterfly keeps the
lower position of ``[own, partner's]`` on an exact tie, so at an exact tie
on the k-th distance the two packages may keep different ids.

The exchange is host-staged, on every call and by design. Ranks that share
one card cannot use NCCL (it refuses two ranks on one device), so the
groups are ``gloo``'s, which take host tensors only: each round copies the
rank's ``[B, k]`` pairs to the host (one int32 message holding the
distances' bits and the ids), exchanges them, and copies the partner's back
to the device; :func:`search_sharded`'s ``[B]`` candidate counts are summed
through one host ``all_reduce`` per axis. The per-rank search stays on the
card.

Write routing (:func:`route_writes`, :func:`local_slot_valid`) is host
numpy, identical to ``repro``'s.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch._device import resolve_device
from repro_torch.core import distances as dist_lib
from repro_torch.core import msa, nsa
from repro_torch.core.distances import BIG
from repro_torch.kernels import ops as kops

Tensor = torch.Tensor


def axis_size(mesh, axis_name: str) -> int:
    """Size of one named mesh axis."""
    return mesh.get_group(axis_name).size()


def _axes_size(mesh, axes: Sequence[str]) -> int:
    out = 1
    for a in axes:
        out *= axis_size(mesh, a)
    return out


def shard_index(mesh, axes: Sequence[str]) -> int:
    """This rank's linear shard index across (possibly several) mesh axes,
    the first axis slowest, as ``repro`` takes it."""
    idx = 0
    for a in axes:
        idx = idx * axis_size(mesh, a) + mesh.get_local_rank(a)
    return idx


def shard_generator(seed: int, shard: int) -> torch.Generator:
    """The build generator of one shard, seeded from ``(seed, shard)``
    (``repro`` folds its key by the shard index)."""
    state = np.random.SeedSequence([int(seed), int(shard)]).generate_state(1)
    return torch.Generator().manual_seed(int(state[0]))


# ---------------------------------------------------------------------------
# Global top-k merge collectives
# ---------------------------------------------------------------------------


def _select(dists: Tensor, ids: Tensor, k: int):
    """The k smallest pairs keyed on (distance, id), ascending."""
    by_id = torch.sort(ids, dim=-1, stable=True).indices
    dists = torch.gather(dists, -1, by_id)
    ids = torch.gather(ids, -1, by_id)
    order = torch.sort(dists, dim=-1, stable=True).indices[..., :k]
    return torch.gather(dists, -1, order), torch.gather(ids, -1, order)


def _pack(dists: Tensor, ids: Tensor) -> Tensor:
    """One host int32 message ``[2, ..., k]``: the distances' bits, then the
    ids (``gloo`` exchanges host tensors only)."""
    d = dists.to(torch.float32).contiguous().view(torch.int32)
    return torch.stack([d, ids.to(torch.int32)]).cpu()


def _unpack(msg: Tensor, device):
    msg = msg.to(device)
    return msg[0].contiguous().view(torch.float32), msg[1]


def topk_merge_allgather(dists: Tensor, ids: Tensor, mesh, axis_name: str,
                         k: int):
    """Naive merge: every rank all-gathers the axis's ``[B, k]`` pairs and
    selects the k smallest of ``P*k``."""
    group = mesh.get_group(axis_name)
    msg = _pack(dists, ids)
    got = [torch.empty_like(msg) for _ in range(group.size())]
    tdist.all_gather(got, msg, group=group)
    parts = [_unpack(m, dists.device) for m in got]
    return _select(torch.cat([p[0] for p in parts], -1),
                   torch.cat([p[1] for p in parts], -1), k)


def topk_merge_butterfly(dists: Tensor, ids: Tensor, mesh, axis_name: str,
                         k: int):
    """Butterfly (recursive-doubling) merge: ``log2(P)`` exchange rounds.

    After round t every rank holds the top-k over its ``2^(t+1)``-rank
    sub-cube; after ``log2(P)`` rounds every rank holds the global top-k.
    Requires a power-of-two axis size."""
    group = mesh.get_group(axis_name)
    Pn = group.size()
    if Pn & (Pn - 1):
        raise ValueError(f"butterfly merge needs power-of-two axis, got {Pn}")
    me = mesh.get_local_rank(axis_name)
    for t in range(int(math.log2(Pn))):
        peer = tdist.get_global_rank(group, me ^ (1 << t))
        send = _pack(dists, ids)
        recv = torch.empty_like(send)
        for work in tdist.batch_isend_irecv([
                tdist.P2POp(tdist.isend, send, peer, group),
                tdist.P2POp(tdist.irecv, recv, peer, group)]):
            work.wait()
        od, oi = _unpack(recv, dists.device)
        dists, ids = _select(torch.cat([dists, od], -1),
                             torch.cat([ids.to(torch.int32), oi], -1), k)
    return dists, ids


def topk_merge(dists, ids, mesh, axis_names: Sequence[str], k: int, *,
               method: str = "butterfly"):
    """Merge across several mesh axes, in the order given (fastest axis
    first)."""
    fn = topk_merge_butterfly if method == "butterfly" else topk_merge_allgather
    for ax in axis_names:
        dists, ids = fn(dists, ids, mesh, ax, k)
    return dists, ids


def _psum(x: Tensor, mesh, axis_names: Sequence[str]) -> Tensor:
    """Sum over the axes through one host ``all_reduce`` each."""
    host = x.cpu().clone()
    for ax in axis_names:
        tdist.all_reduce(host, group=mesh.get_group(ax))
    return host.to(x.device)


# ---------------------------------------------------------------------------
# Sharded MSA build
# ---------------------------------------------------------------------------


def _shard_rows(data, lo: int, hi: int):
    """Rows ``[lo, hi)`` of a global table: a tensor slice, or a float32
    host copy read from a numpy array or memmap (only those rows)."""
    if isinstance(data, Tensor):
        return data[lo:hi]
    return np.array(data[lo:hi], np.float32)


def build_sharded(
    data,
    mesh,
    *,
    db_axes: Sequence[str] = ("data",),
    gl: int,
    n_prototypes: Optional[int] = None,
    distance="euclidean",
    method: str = "pam",
    max_swaps: int = 64,
    seed: int = 0,
    row_chunk: int = 512,
    group_chunk: int = 8,
    swap_tol: float = 1e-3,
    kb: int = 0,
    device="cuda",
) -> msa.PDASCIndexData:
    """Build this rank's PDASC sub-index.

    ``data``: the global ``[n, d]`` table (a numpy array, memmap or tensor),
    ``n`` divisible by the product of the ``db_axes`` sizes; the rank reads
    and uploads only its rows. Its generator is :func:`shard_generator`
    ``(seed, shard)``. ``group_chunk`` bounds the rank's clustering working
    set at O(group_chunk · gl²); ``kb`` is the swap sweep kernel's slots a
    block on the card (``repro``'s ``bg``; 0: its heuristic). Returns the
    rank's ``PDASCIndexData`` on ``device`` (CUDA unless
    ``device="cpu"``)."""
    Pn = _axes_size(mesh, db_axes)
    n = data.shape[0]
    if n % Pn:
        raise ValueError(f"n={n} not divisible by shard count {Pn}")
    per = n // Pn
    p = shard_index(mesh, db_axes)
    index, _ = msa.build_index_arrays(
        _shard_rows(data, p * per, (p + 1) * per), gl=gl,
        n_prototypes=n_prototypes, distance=distance, method=method,
        max_swaps=max_swaps, generator=shard_generator(seed, p),
        row_chunk=row_chunk, group_chunk=group_chunk, swap_tol=swap_tol,
        kb=kb, device=device)
    return index


def max_children_sharded(local_index: msa.PDASCIndexData, mesh,
                         db_axes: Sequence[str] = ("data",)) -> tuple:
    """The per-level child bound over every shard (``repro`` reads it off
    the stacked index): the elementwise max of each rank's
    ``msa.max_children``, by one host ``all_reduce(MAX)`` per axis."""
    mc = torch.tensor(msa.max_children(local_index), dtype=torch.int64)
    for ax in db_axes:
        tdist.all_reduce(mc, op=tdist.ReduceOp.MAX, group=mesh.get_group(ax))
    return tuple(int(c) for c in mc.tolist())


def local_index_from_stacked(arrays: dict, shard: int, *, device="cuda"
                             ) -> msa.PDASCIndexData:
    """Shard ``shard`` of ``repro``'s stacked sharded index (host arrays
    with a leading shard axis, named ``level{l}_{field}`` and ``leaf_ids``)
    as the port's ``PDASCIndexData`` on ``device``."""
    dev = resolve_device(device)

    def t(name):
        return torch.from_numpy(np.ascontiguousarray(arrays[name][shard])
                                ).to(dev)

    levels, l = [], 0
    while f"level{l}_points" in arrays:
        pts = t(f"level{l}_points").float()
        levels.append(msa.PDASCLevel(
            points=pts,
            valid=t(f"level{l}_valid").to(torch.bool),
            parent=t(f"level{l}_parent").to(torch.int32),
            child_start=t(f"level{l}_child_start").to(torch.int32),
            child_count=t(f"level{l}_child_count").to(torch.int32),
            sq_norm=t(f"level{l}_sq_norm").float()
            if f"level{l}_sq_norm" in arrays else (pts * pts).sum(-1),
        ))
        l += 1
    return msa.PDASCIndexData(levels=tuple(levels),
                              leaf_ids=t("leaf_ids").to(torch.int32))


# ---------------------------------------------------------------------------
# Sharded NSA search
# ---------------------------------------------------------------------------


def search_sharded(
    local_index: msa.PDASCIndexData,
    Q,
    mesh,
    *,
    db_axes: Sequence[str] = ("data",),
    dist,
    k: int = 10,
    r,
    mode: str = "dense",
    beam=32,
    max_children: Optional[tuple] = None,
    merge: str = "butterfly",
    leaf_radius_filter: bool = False,
    with_stats: bool = True,
    kernel: Optional[kops.KernelConfig] = None,
    slot_valid: Optional[Tensor] = None,
) -> nsa.SearchResult:
    """Distributed NSA: this rank's search + the global top-k merge.

    Every rank passes the same queries and its own sub-index; the result
    (global dataset rows, ``-1`` kept) is identical on every rank.
    ``mode="beam"`` needs ``max_children``, the per-level child bound over
    all shards (:func:`max_children_sharded`). ``slot_valid``: this rank's
    optional ``bool[n_leaf_local]`` tombstone mask (build it from global
    ids with :func:`route_writes` + :func:`local_slot_valid`), applied
    before the local ranking, so deleted ids never enter the merge. Local
    ids lift as ``shard * per_shard_n + local`` with ``per_shard_n`` the
    sub-index's leaf slot count, as in ``repro``. ``n_candidates`` is summed
    over the database axes."""
    res = _search_local(local_index, Q, dist=dist, k=k, r=r, mode=mode,
                        beam=beam, max_children=max_children,
                        leaf_radius_filter=leaf_radius_filter,
                        with_stats=with_stats, kernel=kernel,
                        slot_valid=slot_valid)
    gids = _lift(res.ids, shard_index(mesh, db_axes),
                 local_index.leaf_ids.shape[0])
    d_m, i_m = topk_merge(res.dists, gids, mesh, tuple(db_axes), k,
                          method=merge)
    nc = _psum(res.n_candidates, mesh, tuple(db_axes))
    return nsa.SearchResult(dists=d_m, ids=i_m, n_candidates=nc)


def _search_local(local_index, Q, *, dist, k, r, mode, beam, max_children,
                  leaf_radius_filter, with_stats, kernel, slot_valid=None
                  ) -> nsa.SearchResult:
    """One shard's search, local leaf ids."""
    dist = dist_lib.get(dist)
    dev = local_index.leaf_ids.device
    Q = torch.as_tensor(Q).to(dev, torch.float32)
    if slot_valid is not None:
        slot_valid = torch.as_tensor(slot_valid, dtype=torch.bool).to(dev)
    if mode == "dense":
        return nsa.search_dense(
            local_index, Q, dist=dist, k=k, r=r,
            leaf_radius_filter=leaf_radius_filter, with_stats=with_stats,
            kernel=kernel, slot_valid=slot_valid)
    if max_children is None:
        raise ValueError(
            "per-shard 'beam' needs max_children (the per-level child "
            "bound over every shard: max_children_sharded)")
    return nsa.search_beam(
        local_index, Q, dist=dist, k=k, r=r, beam=beam,
        max_children=tuple(max_children),
        leaf_radius_filter=leaf_radius_filter, kernel=kernel,
        slot_valid=slot_valid)


def _lift(ids: Tensor, shard: int, per_shard_n: int) -> Tensor:
    """Local leaf ids as global rows (``-1`` kept)."""
    return torch.where(ids >= 0, ids + shard * per_shard_n, -1
                       ).to(torch.int32)


# ---------------------------------------------------------------------------
# Every shard in one process (a stacked index)
# ---------------------------------------------------------------------------


def shard_of(stacked, p: int):
    """Shard ``p`` of a stacked index (leaves with a leading shard axis)."""
    return type(stacked)(
        levels=tuple(type(lv)(*(a[p] for a in lv)) for lv in stacked.levels),
        leaf_ids=stacked.leaf_ids[p])


def build_stacked(data: Tensor, n_shards: int, *, gl: int,
                  distance="euclidean", method: str = "pam",
                  max_swaps: int = 64, seed: int = 0, row_chunk: int = 512,
                  group_chunk: int = 8, swap_tol: float = 1e-3, kb: int = 0
                  ) -> msa.PDASCIndexData:
    """What :func:`build_sharded` builds on each of ``n_shards`` ranks, in
    one process on ``data``'s device: every leaf stacked on a leading shard
    axis, as ``repro``'s ``shard_map`` returns it."""
    n = data.shape[0]
    if n % n_shards:
        raise ValueError(f"n={n} not divisible by shard count {n_shards}")
    per = n // n_shards
    parts = [msa.build_index_arrays(
        data[p * per:(p + 1) * per], gl=gl, distance=distance,
        method=method, max_swaps=max_swaps,
        generator=shard_generator(seed, p), row_chunk=row_chunk,
        group_chunk=group_chunk, swap_tol=swap_tol, kb=kb,
        device=data.device)[0] for p in range(n_shards)]
    return type(parts[0])(
        levels=tuple(type(lv)(*(torch.stack(f) for f in zip(*same)))
                     for lv, same in zip(parts[0].levels,
                                         zip(*(q.levels for q in parts)))),
        leaf_ids=torch.stack([q.leaf_ids for q in parts]))


def search_stacked(index: msa.PDASCIndexData, Q, *, dist, k: int = 10, r,
                   mode: str = "dense", beam=32,
                   max_children: Optional[tuple] = None,
                   leaf_radius_filter: bool = False, with_stats: bool = True,
                   kernel: Optional[kops.KernelConfig] = None
                   ) -> nsa.SearchResult:
    """What :func:`search_sharded` returns on every rank, in one process:
    each shard of a stacked index searched in turn, then one selection of
    the k smallest (distance, global id) pairs over all of them (the
    merges' key, so the result is theirs)."""
    dists, gids, nc = [], [], 0
    for p in range(index.leaf_ids.shape[0]):
        local = shard_of(index, p)
        res = _search_local(local, Q, dist=dist, k=k, r=r, mode=mode,
                            beam=beam, max_children=max_children,
                            leaf_radius_filter=leaf_radius_filter,
                            with_stats=with_stats, kernel=kernel)
        dists.append(res.dists)
        gids.append(_lift(res.ids, p, local.leaf_ids.shape[0]))
        nc = nc + res.n_candidates
    d_m, i_m = _select(torch.cat(dists, -1), torch.cat(gids, -1), k)
    return nsa.SearchResult(dists=d_m, ids=i_m, n_candidates=nc)


# ---------------------------------------------------------------------------
# Sharded payload tier
# ---------------------------------------------------------------------------


def shard_payload(store, mesh, *, db_axes: Sequence[str] = ("data",)):
    """This rank's slice of a quantised payload tier.

    The navigation tier stays replicated; the payload codes shard by
    leaf-row range: shard ``p`` owns rows ``[p*per, (p+1)*per)`` and the
    matching per-block scales. Returns ``(codes [per, dc], scales
    [nb_per])`` for :func:`scan_quantized_sharded`."""
    if store.backend == "fp32" or store.codes is None:
        raise ValueError(
            "shard_payload needs a quantised store (int8/fp16/int4/binary)")
    Pn = _axes_size(mesh, db_axes)
    n = store.codes.shape[0]
    if n % Pn:
        raise ValueError(f"payload rows n={n} not divisible by shards {Pn}")
    per = n // Pn
    if per % store.block:
        raise ValueError(
            f"per-shard rows {per} not granule-aligned (block={store.block}); "
            f"scales cannot shard cleanly")
    nb_per = per // store.block
    p = shard_index(mesh, db_axes)
    return (store.codes[p * per:(p + 1) * per],
            store.scales[p * nb_per:(p + 1) * nb_per])


def payload_placement(n: int, block: int, n_shards: int) -> list:
    """Granule co-placement map for a remote exact tier: shard ``p`` owns
    rows ``[p*per, (p+1)*per)`` and granules ``[p*per//block,
    (p+1)*per//block)``, so a node's exact-rerank fetches touch only its
    own granules. Returns ``[dict(shard=p, rows=(lo, hi), granules=(g_lo,
    g_hi)), ...]`` (half-open ranges)."""
    if n % n_shards:
        raise ValueError(f"payload rows n={n} not divisible by "
                         f"shards {n_shards}")
    per = n // n_shards
    if per % block:
        raise ValueError(
            f"per-shard rows {per} not granule-aligned (block={block}); "
            f"granules would straddle shard boundaries")
    g_per = per // block
    return [
        dict(shard=p, rows=(p * per, (p + 1) * per),
             granules=(p * g_per, (p + 1) * g_per))
        for p in range(n_shards)
    ]


def scan_quantized_sharded(
    codes: Tensor,
    scales: Tensor,
    Q: Tensor,
    cand_idx: Tensor,
    cand_ok: Tensor,
    mesh,
    *,
    db_axes: Sequence[str] = ("data",),
    distance="l2",
    k: int,
    block: int,
    merge: str = "butterfly",
    kernel: Optional[kops.KernelConfig] = None,
    slot_valid: Optional[Tensor] = None,
    code_format: str = "dense",
):
    """Distributed stage-1 scan: each rank scans the candidates it owns.

    ``codes [per, dc]`` / ``scales [nb_per]``: this rank's slice
    (:func:`shard_payload`). The descent is replicated (every rank passes
    the same *global* ``cand_idx [B, W]`` / ``cand_ok``); each rank masks
    the table to its row range, runs ``ops.scan_quantized`` (the CUDA scan
    on the card), and the per-rank top-k merge. Returns ``(dists [B, k],
    slots [B, k])``, identical on every rank, ``slots`` global leaf rows
    (-1 for missing). ``slot_valid``: this rank's optional ``bool[per]``
    tombstone mask."""
    per = codes.shape[0]
    lo = shard_index(mesh, db_axes) * per
    local_ok = cand_ok & (cand_idx >= lo) & (cand_idx < lo + per)
    ci_local = torch.clamp(cand_idx - lo, 0, per - 1)
    d, slot = kops.scan_quantized(
        Q.to(torch.float32), codes, scales, ci_local, local_ok, distance,
        k=k, block=block, slot_valid=slot_valid, code_format=code_format,
        config=kernel)
    gslots = torch.gather(cand_idx, 1, slot.long()).to(torch.int32)
    gslots = torch.where(d < BIG / 2, gslots, -1)
    return topk_merge(d, gslots, mesh, tuple(db_axes), k, method=merge)


# ---------------------------------------------------------------------------
# Shard-by-id write routing (host numpy, as repro's)
# ---------------------------------------------------------------------------


def route_writes(ids, n_shards: int, per_shard_n: int):
    """Route global dataset rows to the shard that owns them: shard ``p``
    owns ``[p*per_shard_n, (p+1)*per_shard_n)``, the mapping
    :func:`search_sharded` lifts ids with. Returns ``[(shard, local_rows
    int64[m_p]), ...]`` for the shards that receive at least one write."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    if ids.size and (ids.min() < 0 or ids.max() >= n_shards * per_shard_n):
        raise ValueError(
            f"write ids out of range [0, {n_shards * per_shard_n}) for "
            f"{n_shards} shards x {per_shard_n} rows"
        )
    shard = ids // per_shard_n
    return [
        (int(s), ids[shard == s] - int(s) * per_shard_n)
        for s in range(n_shards)
        if bool(np.any(shard == s))
    ]


def local_slot_valid(leaf_ids_local, deleted_local_rows):
    """Per-shard tombstone mask from locally routed deleted rows.

    ``leaf_ids_local``: int32[n_0], the shard's leaf-slot -> local-row map;
    ``deleted_local_rows``: the shard's entry from :func:`route_writes`.
    Returns bool[n_0] (True = live) for ``search_sharded(slot_valid=...)``."""
    leaf_ids_local = np.asarray(leaf_ids_local)
    dead = np.zeros(int(leaf_ids_local.max(initial=0)) + 1, bool)
    rows = np.asarray(deleted_local_rows, np.int64)
    dead[rows[rows <= leaf_ids_local.max(initial=0)]] = True
    ok = ~dead[np.clip(leaf_ids_local, 0, dead.shape[0] - 1)]
    return ok | (leaf_ids_local < 0)  # padding slots stay "live" (invalid anyway)


# ---------------------------------------------------------------------------
# Distributed exact k-NN (ground truth)
# ---------------------------------------------------------------------------


def exact_knn_sharded(
    DB,
    Q,
    mesh,
    *,
    db_axes: Sequence[str] = ("data",),
    distance="l2",
    k: int = 10,
    merge: str = "butterfly",
    device="cuda",
):
    """Brute-force distributed k-NN: each rank uploads its row range of the
    global ``DB [n, d]`` and runs ``ops.knn`` on it (the CUDA knn kernel on
    the card; no ``[q, per]`` matrix), then the global merge. Returns
    ``(dists [q, k], ids [q, k])`` identical on every rank, ids global
    rows."""
    Pn = _axes_size(mesh, db_axes)
    n = DB.shape[0]
    if n % Pn:
        raise ValueError(f"n={n} not divisible by {Pn}")
    per = n // Pn
    shard = shard_index(mesh, db_axes)
    dev = resolve_device(device)
    db = torch.as_tensor(_shard_rows(DB, shard * per, (shard + 1) * per)
                         ).to(dev, torch.float32)
    d, idx = kops.knn(torch.as_tensor(Q, dtype=torch.float32).to(dev), db,
                      distance, k=k)
    gids = idx.to(torch.int32) + shard * per
    return topk_merge(d, gids, mesh, tuple(db_axes), k, method=merge)
