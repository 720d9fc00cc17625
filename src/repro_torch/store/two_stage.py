"""Two-stage (scan -> rerank) search over the tiered leaf store
(counterpart of ``repro.store.two_stage``).

Stage 0, the beam descent (``nsa.descend_beam``): levels L..1 rank exactly
as :func:`repro_torch.core.nsa.search_beam` and give the leaf candidate
table ``cand_idx [B, W]``.

Stage 1, the quantised scan (``ops.scan_quantized``, the CUDA scan kernel
on the card): candidates score against the device-resident payload codes in
their native container; the top ``rerank_width`` survivors per query
advance. These distances carry the quantisation error.

Stage 2, the exact rerank: the survivors' exact fp32 rows come from the
out-of-core payload in ``block``-row granules (host memmap + LRU: the one
deliberately host-synchronising step) and are reranked by
``ops.rank_candidates`` (the CUDA rank kernel on the card). Reported
distances are exact.

``rerank_width=None`` (∞) skips the scan: the full exact payload is read
back, the leaf level rebuilt around it, and the *same* ``search_beam``
runs on it, so dists, ids and candidate counts are bit-identical to the
``beam`` pipeline's. While stage 1 runs, the candidates' granules are
prefetched into the exact source's cache on its prefetch pool (memmapped
sources only; a host array's fetch is a plain slice).

Tracing: on a traced request the stages record ``descend``, ``scan`` and
``rerank`` spans (the ``granule_fetch`` span is the exact source's). Only
then does each device stage wait for its work (an event recorded on the
current stream), so its span holds its device time; untraced, nothing
waits until the host needs the survivors. Every serving thread shares the
default stream, so a traced device span can also hold work that another
engine queued before it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import distances as dist_lib
from repro_torch.core.distances import BIG
from repro_torch.core.msa import PDASCIndexData
from repro_torch.core.nsa import (
    SearchResult,
    _per_level_radii,
    _squeezed,
    assemble_result,
    descend_beam,
    search_beam,
)
from repro_torch.kernels import ops as kops
from repro_torch.store.leaf_store import LeafStore

PREFETCH_WAIT_S = 30.0  # prefetch is advisory: never wait longer for it


def _settle(t: torch.Tensor) -> None:
    """Wait for the work queued so far on the current stream (a traced
    stage's device time; no device-wide synchronise)."""
    if t.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        ev.synchronize()


def search_two_stage(
    index: PDASCIndexData,
    store: LeafStore,
    Q: torch.Tensor,
    *,
    dist: dist_lib.Distance,
    k: int = 10,
    r,
    beam,
    max_children: tuple,
    rerank_width: Optional[int] = 128,
    exact_rerank: bool = True,
    leaf_radius_filter: bool = False,
    kernel: Optional[kops.KernelConfig] = None,
    prefetch: bool = True,
    slot_valid: Optional[torch.Tensor] = None,
) -> SearchResult:
    """Two-stage NSA over a tiered leaf store. ``Q``: ``[B, d]`` (or
    ``[d]``), on the index's device.

    Args:
      store: the payload tier. A quantised backend enables the stage-1
        scan; an fp32 backend reranks every candidate (``search_beam``
        served from the exact payload).
      rerank_width: survivors per query advancing to the exact rerank,
        clamped to at least ``k``. None or <= 0 is ∞: rerank every
        candidate, bit-identical to ``search_beam``.
      exact_rerank: False skips stage 2: the scan's top-k on code-space
        distances is the result and the exact payload is never read.
        Ignored on an fp32 backend and in ∞ mode.
      prefetch: warm the granule cache for the candidate rows while the
        scan runs.
      slot_valid: optional ``bool[n_0]`` mask of live leaf slots; dead
        slots rank ``BIG`` in the scan and in the ∞/fp32 ``search_beam``.
    """
    dist = dist_lib.get(dist)
    kernel = kernel or kops.DEFAULT
    Q = Q.to(torch.float32)
    squeeze = Q.dim() == 1
    Qb = Q[None] if squeeze else Q
    radii = _per_level_radii(r, len(index.levels))

    infinite = rerank_width is None or rerank_width <= 0
    if infinite or store.backend == "fp32":
        # No approximate tier: the same search_beam over the exact payload.
        # If the dense leaf array is still resident it IS that payload;
        # a released index reads the out-of-core source back in full (the
        # validation mode's deliberate cost). The leaf keeps its sq_norm.
        leaf = index.levels[0]
        full = index
        if leaf.points.shape[1] != store.d:
            table = torch.from_numpy(store.exact.read_all()).to(
                leaf.sq_norm.device)
            full = index._replace(
                levels=(leaf._replace(points=table),) + index.levels[1:])
        return search_beam(
            full, Q, dist=dist, k=k, r=r, beam=beam,
            max_children=tuple(max_children),
            leaf_radius_filter=leaf_radius_filter, kernel=kernel,
            slot_valid=slot_valid,
        )

    tracing = obs.is_tracing()
    with obs.span("descend", kind="device", beam=beam):
        cand_idx, cand_ok = descend_beam(index, Qb, dist=dist, r=r, beam=beam,
                                         max_children=tuple(max_children),
                                         kernel=kernel)
        if tracing:
            _settle(cand_idx)
    W = cand_idx.shape[1]
    # a small rerank_width bounds fetch traffic, never the result count
    R = min(max(int(rerank_width), k), W)

    def scan(width):
        return kops.scan_quantized(
            Qb, store.codes, store.scales, cand_idx, cand_ok, dist, k=width,
            block=store.block, slot_valid=slot_valid,
            code_format=store.code_format, config=kernel,
        )

    if not exact_rerank:
        # scan-only: the scan's top-k is the result; no fetch, no stage 2
        with obs.span("scan", kind="device", candidates=W,
                      backend=store.backend, scan_only=True):
            d_scan, slot = scan(min(k, W))
            if tracing:
                _settle(d_scan)
        slots = torch.gather(cand_idx, 1, slot.long())
        res = assemble_result(index, d_scan, slots, cand_ok, k=k,
                              leaf_radius=radii[0],
                              leaf_radius_filter=leaf_radius_filter)
        return _squeezed(res) if squeeze else res

    prefetcher = None
    if prefetch and store.exact.wants_prefetch:
        # warm the granule cache on the pool while the scan runs
        prefetcher = store.prefetch_rows_async(cand_idx.cpu().numpy())
    with obs.span("scan", kind="device", candidates=W, survivors=R,
                  backend=store.backend):
        d_scan, slot = scan(R)
        surv_idx = torch.gather(cand_idx, 1, slot.long())  # [B, R]
        surv_ok = d_scan < BIG / 2
        if tracing:
            _settle(surv_idx)
    if prefetcher is not None:
        prefetcher.wait(timeout=PREFETCH_WAIT_S)

    # stage 2: exact fp32 rows from the out-of-core payload, granule-wise
    # (the granule_fetch span is recorded inside ExactSource.fetch_rows)
    C = store.fetch_rows(surv_idx.cpu().numpy())
    with obs.span("rerank", kind="device", survivors=R):
        dists, slot2 = kops.rank_candidates(
            Qb, torch.from_numpy(C).to(Qb.device), surv_ok, dist,
            k=min(k, R), config=kernel)
        if tracing:
            _settle(dists)
    slots = torch.gather(surv_idx, 1, slot2.long())
    res = assemble_result(index, dists, slots, cand_ok, k=k,
                          leaf_radius=radii[0],
                          leaf_radius_filter=leaf_radius_filter)
    return _squeezed(res) if squeeze else res
