"""Streaming shard-by-shard index build over a remote payload tier
(counterpart of ``repro.store.streaming``).

``build_streaming`` consumes an *iterator* of ``[m, d]`` fp32 shards (a
dataset that never fits in memory) and produces a served-form
:class:`~repro_torch.core.index.PDASCIndex`: quantised codes resident on
the device, the exact fp32 payload living as granules in a
:class:`~repro_torch.store.remote.RemoteStore`, no dense leaf array ever
made.

Per shard (one pass; live memory ~ one shard + the medoid accumulator):

1. **cluster** the shard's leaf groups with ``msa._build_level``, the same
   code the in-memory build and the compaction run (the pairwise and
   swap_deltas kernels for pam; k-means and the relabel's pairwise for
   ``method="kmeans"``);
2. **quantise** the reordered leaf rows into the resident codes on the
   device (``leaf_store.quantize``: a shard's slot count is
   granule-aligned, so per-shard scales concatenate exactly);
3. **flush** the exact fp32 rows to the remote store as whole granules
   (``remote.upload_granules``) and free the shard.

Only the shards' medoids accumulate; after the stream ends they are
clustered bottom-up into the upper levels by
``msa._cluster_levels(prev_levels=[leaf])``, the mechanism the compaction
regrows the hierarchy with, which fixes the leaf's parent pointers through
the first upper level's reorder.

The stream order *is* the group assignment: there is no shuffle. A ragged
last shard is allowed, as long as its padded slot count is a multiple of
``block``.
"""

from __future__ import annotations

import json
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.core import distances as dist_lib
from repro_torch.core import msa, radius as radius_lib
from repro_torch.store import remote as remote_lib
from repro_torch.store.leaf_store import LeafStore, quantize

# rows sampled (evenly across shards) for the default-radius estimate
_RADIUS_SAMPLE = 4096


def build_streaming(
    shards: Iterable,
    *,
    gl: int,
    remote: remote_lib.RemoteStore,
    n_prototypes: Optional[int] = None,
    distance="euclidean",
    store: str = "int8",
    block: int = 1024,
    method: str = "pam",
    max_swaps: int = 64,
    generator: Optional[torch.Generator] = None,
    radius_quantile: float = 0.05,
    row_chunk: int = 512,
    group_chunk: int = 8,
    swap_tol: float = 1e-3,
    kb: int = 0,
    cache_granules: int = 256,
    prefetch_workers: int = 2,
    prefix: str = "",
    device="cuda",
):
    """Build a remote-payload PDASC index from a shard iterator.

    Args:
      shards: iterable of ``[m, d]`` float32 arrays. Every shard's padded
        slot count (``ceil(m/gl) * gl``) must be a multiple of ``block``, so
        granules never straddle shards (the co-placement unit
        ``core.distributed.payload_placement`` hands out).
      gl / n_prototypes / distance / method / ...: the MSA build knobs
        (``PDASCIndex.build``); ``generator`` (a CPU ``torch.Generator``,
        seed 0 when omitted) draws the k-means++ seeds.
      remote: the object store receiving the exact fp32 granules.
      store: the resident payload backend, a *quantised* one
        (int8/fp16/int4/binary).
      block: granule rows (quantisation block == remote fetch unit).
      cache_granules / prefetch_workers: the host LRU and prefetch pool in
        front of the remote tier.
      device: where the build runs and the codes stay (CUDA unless
        ``device="cpu"``).

    Returns a :class:`~repro_torch.core.index.PDASCIndex` on ``device``
    with ``_payload_released=True`` and ``store.exact`` a
    :class:`~repro_torch.store.remote.RemoteSource`.
    """
    from repro_torch.core.index import PDASCIndex, _validate_points

    dist = dist_lib.get(distance)
    k = n_prototypes or gl // 2
    if k < 1 or k > gl:
        raise ValueError(f"need 1 <= n_prototypes <= gl, got {k} vs gl={gl}")
    if store == "fp32" or store not in ("int8", "fp16", "int4", "binary"):
        raise ValueError(
            f"build_streaming needs a quantised store backend "
            f"(int8/fp16/int4/binary), got {store!r} — the dense payload is "
            f"never resident on the streaming path"
        )
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)

    d: Optional[int] = None
    row_off = 0  # leaf slots flushed so far (granule-aligned)
    group_off = 0  # leaf groups so far (parent offset unit)
    id_off = 0  # stream rows so far (leaf id space)
    valid_parts, parent_parts, ids_parts, norm_parts = [], [], [], []
    codes_parts, scales_parts = [], []
    med_pts, med_valid, med_cs, med_cc = [], [], [], []
    leaf_td = 0.0
    radius_sample: list[np.ndarray] = []
    n_shards = 0

    for shard in shards:
        shard = _validate_points(shard, dist, what="build_streaming shard")
        m = shard.shape[0]
        if d is None:
            d = shard.shape[1]
        elif shard.shape[1] != d:
            raise ValueError(
                f"shard {n_shards} has d={shard.shape[1]}, earlier shards "
                f"had d={d}"
            )
        G = -(-m // gl)
        n_pad = G * gl
        if n_pad % block:
            raise ValueError(
                f"shard {n_shards}: padded slot count {n_pad} (= ceil({m}/"
                f"{gl})*{gl}) is not a multiple of block={block}; granules "
                f"would straddle the shard boundary. Use shard sizes whose "
                f"ceil(m/gl)*gl is block-aligned (e.g. gl a multiple of "
                f"block, or shards of a fixed block-aligned group count)."
            )
        with obs.span("stream_shard", kind="host", shard=n_shards, rows=m):
            level, nxt, _, td = msa._build_level(
                torch.from_numpy(shard).to(dev),
                torch.ones(m, dtype=torch.bool, device=dev),
                torch.arange(id_off, id_off + m, dtype=torch.int32,
                             device=dev),
                torch.full((m,), -1, dtype=torch.int32, device=dev),
                dist=dist, gl=gl, k=k, method=method, max_swaps=max_swaps,
                swap_tol=swap_tol, row_chunk=row_chunk,
                group_chunk=group_chunk, generator=gen, kb=kb,
            )
            # resident tier: the final-layout shard rows, quantised on the
            # device
            c, s = quantize(level["points"], store, block)
            codes_parts.append(c)
            scales_parts.append(s)
            # exact tier: whole granules to the remote store
            rows = level["points"].cpu().numpy()  # [n_pad, d]
            remote_lib.upload_granules(remote, rows, block,
                                       row_offset=row_off, prefix=prefix)
            # leaf bookkeeping in the global layout: this shard owns slots
            # [row_off, row_off + n_pad) and upper items
            # [group_off*k, (group_off+G)*k)
            valid_parts.append(level["valid"])
            parent = level["parent"]
            parent_parts.append(torch.where(parent >= 0,
                                            parent + group_off * k, -1))
            ids_parts.append(level["carry_a"])
            norm_parts.append(np.einsum("ij,ij->i", rows, rows,
                                        dtype=np.float32))
            med_pts.append(nxt["points"])
            med_valid.append(nxt["valid"])
            med_cs.append(nxt["child_start"] + row_off)
            med_cc.append(nxt["child_count"])
            leaf_td += float(td)
            stride = max(1, m // max(1, _RADIUS_SAMPLE // 8))
            radius_sample.append(shard[::stride][:_RADIUS_SAMPLE])
        row_off += n_pad
        group_off += G
        id_off += m
        n_shards += 1

    if n_shards == 0:
        raise ValueError("build_streaming got an empty shard iterator")
    msa._check_level_convergence(id_off, gl, k)

    n_total = row_off
    # the leaf in released form: a [n, 0] placeholder, as
    # release_dense_payload leaves; sq_norm is set from the streamed rows
    leaf = dict(
        points=torch.zeros((n_total, 0), device=dev),
        valid=torch.cat(valid_parts),
        parent=torch.cat(parent_parts).to(torch.int32),
        child_start=torch.full((n_total,), -1, dtype=torch.int32,
                               device=dev),
        child_count=torch.zeros(n_total, dtype=torch.int32, device=dev),
        leaf_ids=torch.cat(ids_parts).to(torch.int32),
    )
    med = torch.cat(med_pts)
    mv, cs, cc = (torch.cat(p).to(t) for p, t in (
        (med_valid, torch.bool), (med_cs, torch.int32), (med_cc, torch.int32)))

    if group_off == 1:  # one group: its medoids are the top level
        raw_levels, upper_td = [leaf], []
        top = dict(points=med, valid=mv,
                   parent=torch.full((med.shape[0],), -1, dtype=torch.int32,
                                     device=dev),
                   child_start=cs, child_count=cc)
    else:
        with obs.span("stream_upper_levels", kind="host",
                      items=int(med.shape[0])):
            raw_levels, upper_td, top = msa._cluster_levels(
                med, mv, cs, cc, dist=dist, gl=gl, k=k, method=method,
                max_swaps=max_swaps, swap_tol=swap_tol, row_chunk=row_chunk,
                group_chunk=group_chunk, generator=gen, prev_levels=[leaf],
                kb=kb,
            )
    data = msa.finalize_index(raw_levels, top)
    lv0 = data.levels[0]
    data = data._replace(levels=(lv0._replace(sq_norm=torch.from_numpy(
        np.concatenate(norm_parts)).to(dev)),) + data.levels[1:])

    sizes = torch.stack([lv.valid.sum() for lv in data.levels]).tolist()
    tds = [leaf_td] + [float(t) for t in upper_td] + [0.0]
    stats = msa.BuildStats(level_sizes=tuple(int(s) for s in sizes),
                           level_td=tuple(tds), n_levels=len(sizes))

    sample = np.concatenate(radius_sample)[:_RADIUS_SAMPLE]
    default_r = radius_lib.estimate_radius(
        torch.from_numpy(sample).to(dev), dist, quantile=radius_quantile)

    source = remote_lib.RemoteSource(
        remote, n=n_total, d=d, block=block, prefix=prefix,
        cache_granules=cache_granules, prefetch_workers=prefetch_workers,
    )
    leaf_store = LeafStore(backend=store, block=block,
                           codes=torch.cat(codes_parts),
                           scales=torch.cat(scales_parts), exact=source)
    remote.put(prefix + remote_lib.MANIFEST_KEY,
               json.dumps(source.manifest()).encode("utf-8"))
    return PDASCIndex(
        data=data, stats=stats, distance=dist, gl=gl, n_prototypes=k,
        max_children=msa.max_children(data), default_radius=default_r,
        device=dev, store=leaf_store, _payload_released=True,
    )
