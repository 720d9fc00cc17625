"""Dispatch over the CUDA kernels (counterpart of ``repro.kernels.ops``).

Public ops, the one execution substrate for every MSA and NSA distance
evaluation and ranking step:

  pairwise_distance(X, Y, distance)       -> [m, n]  (or [G, m, n])
  knn(Q, DB, distance, k)                 -> (dists[q, k], ids[q, k])
  rank_candidates(Q, C, ok, distance, k)  -> (dists[b, k], slots[b, k])
  rank_gathered(Q, points, sq_norms, cand_idx, cand_ok, distance, k)
                                          -> (dists[b, k], slots[b, k])
  swap_deltas(D, d1, d2, n1, valid, k)    -> [k, g]  (or [G, k, g])
  scan_quantized(Q, codes, scales, cand_idx, cand_ok, distance, k, block)
                                          -> (dists[b, k], slots[b, k])

``distance`` may be a kernel form (``ref.FORMS``), a registry name
(``repro_torch.core.distances``) or a ``Distance``. Dispatch:

* CUDA tensors, kernel form -> the CUDA kernel. If it is missing or fails,
  the op raises; it never falls back to the plain version.
* CPU tensors, kernel form  -> the plain PyTorch version in ``ref.py``.
* a form with no kernel (haversine, jaccard, fractional05, minkowski(p))
  -> the registry's plain PyTorch path, on either device.

Each kernel wrapper counts its launches (:func:`launch_counts`), so a run can
show that it went through the kernels.

``KernelConfig`` bundles the launch knobs of the CUDA kernels, so callers
thread one hashable object through the search and build paths. Each knob
is 0 by default, meaning the kernel's own heuristic for the call's shape
(``topk.rank_geometry``, ``quantized.scan_geometry``, ``topk.knn_geometry``,
``kmedoids.swap_geometry``). ``repro``'s Pallas block knobs map onto them:

  ``bm`` / ``bn`` / ``bd`` (pairwise grid)  -> none: ``pairwise.cu``'s
                                             [128, 128] tile is fixed by its
                                             ``wgmma`` layout
  ``bq`` (rank / scan query tile)          -> ``qpb`` queries a block, and
                                             ``wpq`` warps a query
  ``bn`` (rank / scan candidate tile)      -> none: a warp takes 32-slot
                                             tiles
  ``bq`` / ``bn`` (knn query / DB tiles)   -> ``bq`` (16, 32, 64 or 128
                                             queries a block) and ``splits``
                                             (DB splits, one block each)
  ``bg`` (swap row tile)                   -> ``kb`` slots a block

Resolution per op (:func:`resolve_blocks`), as ``repro``'s:

  explicit call knob  >  non-zero ``KernelConfig`` field  >
  autotuned winner (``auto=True``, ``kernels/autotune.py`` cache lookup)  >
  the kernel's heuristic for the call's shape

A tuned winner that cannot run at the call's own shape (its bucket holds
other shapes) is skipped and counted as a lookup miss. Each (op, shape,
knobs) resolves against the tuner once per cache generation. The knobs apply to
CUDA tensors; the plain versions ignore them.
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import kmedoids as _kmk
from repro_torch.kernels import pairwise as _pw
from repro_torch.kernels import quantized as _qk
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import topk as _tk

Tensor = torch.Tensor


class KernelConfig(NamedTuple):
    """Knobs of the kernel layer (hashable). A launch knob at 0 takes the
    kernel's heuristic."""

    row_chunk: int = 1024  # streaming chunk of the plain broadcast forms
    wpq: int = 0  # rank / scan: warps a query
    qpb: int = 0  # rank / scan: queries a block
    bq: int = 0  # knn: queries a block (16, 32, 64 or 128)
    splits: int = 0  # knn: DB splits, one block a split and query tile
    kb: int = 0  # swap sweep: slots a block
    auto: bool = False  # resolve unset knobs from the tuner's cache
    tuned_gen: int = -1  # autotune generation stamped by the plan compiler


DEFAULT = KernelConfig()

# each op's launch knobs, as KernelConfig names them
OP_KNOBS = {"pairwise": (), "rank": ("wpq", "qpb"), "scan": ("wpq", "qpb"),
            "knn": ("bq", "splits"), "swap": ("kb",)}


def resolve_blocks(op: str, form: Optional[str], dtype: str, shape,
                   config: Optional[KernelConfig] = None, **explicit) -> dict:
    """Resolve one op's launch knobs (the precedence chain in the module
    doc). ``explicit`` carries the per-call knobs (None = unset); ``shape``
    is the tuner's key shape (``autotune.cache_key``). Returns ``{knob:
    value or None}``, None meaning the kernel's heuristic."""
    out = {}
    for knob in OP_KNOBS[op]:
        exp = explicit.get(knob)
        if exp is not None:
            out[knob] = int(exp)
        elif config is not None and getattr(config, knob):
            out[knob] = int(getattr(config, knob))
        else:
            out[knob] = None
    if config is not None and config.auto:
        from repro_torch.kernels import autotune as _at  # ops <-> tuner cycle

        out = dict(_tuned(op, form, dtype, tuple(shape), tuple(out.items()),
                          _at.generation()))
    return out


@functools.lru_cache(maxsize=4096)
def _tuned(op: str, form: Optional[str], dtype: str, shape: tuple,
           fixed: tuple, generation: int) -> tuple:
    """``fixed`` (``(knob, value or None)`` pairs) with its unset knobs
    taken from the tuner's winner where the whole fits ``shape``. Memoised
    per tuner ``generation`` (a record or a new cache file makes a new
    one), so a key is looked up and counted once per generation, as
    ``repro`` looks it up once per trace, and a hot path pays a dict read."""
    from repro_torch.kernels import autotune as _at

    def merged(tuned: dict) -> tuple:
        return tuple((k, v if v is not None else tuned.get(k))
                     for k, v in fixed)

    tuned = _at.lookup(
        op=op, form=form or "none", dtype=dtype, shape=shape,
        accept=lambda t: _at.fits(op, dict(merged(t)), shape, form))
    return fixed if tuned is None else merged(tuned)


def resolve_form(distance) -> Optional[str]:
    """Map a distance spec to a kernel form (None = no kernel)."""
    if isinstance(distance, str):
        if distance in _ref.FORMS:
            return distance
        return _ref.FORM_OF.get(distance)
    name = getattr(distance, "name", None)
    return _ref.FORM_OF.get(name) if name else None


# Launches per CUDA kernel since the last reset. Each wrapper adds one
# where it launches its kernel, from whichever thread serves the call (the
# serving engines' workers, the shadow-recall worker), so the adds take a
# lock: a bare ``n += 1`` can lose counts between threads.
_LAUNCH_LOCK = threading.Lock()
_LAUNCHES = dict.fromkeys(("pairwise", "rank", "knn", "swap_deltas", "scan"), 0)


def count_launch(name: str) -> None:
    """Add one launch of kernel ``name`` (a key of :func:`launch_counts`)."""
    with _LAUNCH_LOCK:
        _LAUNCHES[name] += 1


def launch_counts() -> dict:
    """Kernel launches per CUDA kernel since the last reset."""
    with _LAUNCH_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0


def _on_cuda(*tensors) -> bool:
    """True when every tensor is on a CUDA device, False when all are on
    the CPU; mixed placements raise."""
    cuda = {t.is_cuda for t in tensors if t is not None}
    if len(cuda) > 1:
        raise ValueError("ops inputs must all lie on one device")
    return cuda == {True}


def _f32(t: Tensor) -> Tensor:
    return t.to(torch.float32).contiguous()


def pairwise_distance(
    X: Tensor,
    Y: Tensor,
    distance="l2",
    *,
    row_chunk: Optional[int] = None,
    config: Optional[KernelConfig] = None,
) -> Tensor:
    """``[m, d] x [n, d] -> [m, n]`` distances, or batched over groups
    ``[G, m, d] x [G, n, d] -> [G, m, n]``.

    ``row_chunk`` bounds the peak memory of the plain broadcast forms (the
    cube streams in ``[row_chunk, row_chunk, d]`` slabs); the CUDA kernel
    never builds it."""
    if row_chunk is None:
        row_chunk = (config or DEFAULT).row_chunk
    form = resolve_form(distance)
    if form is None:
        from repro_torch.core import distances as dist_lib  # registry path

        if X.dim() == 3:  # one group at a time bounds the cube
            return torch.stack([
                dist_lib.pairwise_chunked(distance, x, y, chunk=row_chunk)
                for x, y in zip(X, Y)
            ])
        return dist_lib.pairwise_chunked(distance, X, Y, chunk=row_chunk)
    if _on_cuda(X, Y):
        resolve_blocks("pairwise", form, "float32",
                       (X.shape[-2], Y.shape[-2], X.shape[-1]), config)
        return _pw.pairwise_cuda(_f32(X), _f32(Y), form)
    if form in _ref.VPU_FORMS:
        return _ref.pairwise_ref_chunked(X, Y, form, row_chunk)
    return _ref.pairwise_ref(X, Y, form)


def knn(Q: Tensor, DB: Tensor, distance="l2", *, k: int = 10,
        bq: Optional[int] = None, splits: Optional[int] = None,
        config: Optional[KernelConfig] = None) -> tuple[Tensor, Tensor]:
    """Fused brute-force k-NN (ascending dists, int32 ids)."""
    form = resolve_form(distance)
    if form is None:
        from repro_torch.core import distances as dist_lib

        return _ref.topk_smallest(dist_lib.pairwise_chunked(distance, Q, DB), k)
    if _on_cuda(Q, DB):
        knobs = resolve_blocks(
            "knn", form, "float32", (Q.shape[0], DB.shape[0], Q.shape[1], k),
            config, bq=bq, splits=splits)
        return _tk.knn_cuda(_f32(Q), _f32(DB), k, form, **knobs)
    return _ref.knn_ref(Q, DB, k, form)


def rank_candidates(
    Q: Tensor,
    C: Tensor,
    ok: Tensor,
    distance="l2",
    *,
    k: int,
    c_sq_norms: Optional[Tensor] = None,
    wpq: Optional[int] = None,
    qpb: Optional[int] = None,
    config: Optional[KernelConfig] = None,
) -> tuple[Tensor, Tensor]:
    """Masked ranking of per-query gathered candidates ``C [b, w, d]``.

    Returns ``(dists[b, k] ascending, slots[b, k])``; masked slots rank as
    ``BIG``. On CUDA the cube is the rank kernel's point table and the
    candidate indices enumerate it."""
    form = resolve_form(distance)
    if form is None:
        return _registry_rank(Q, C, ok, distance, k)
    if _on_cuda(Q, C, ok):
        b, w, d = C.shape
        points = _f32(C).reshape(b * w, d)
        cc = None
        if form in _ref.NORM_FORMS:
            cc = (_f32(c_sq_norms).reshape(-1) if c_sq_norms is not None
                  else (points * points).sum(-1))
        idx = torch.arange(b * w, device=C.device, dtype=torch.int32)
        knobs = resolve_blocks("rank", form, "float32", (b, w, d, k), config,
                               wpq=wpq, qpb=qpb)
        return _tk.rank_cuda(_f32(Q), points, cc, idx.reshape(b, w),
                             ok.to(torch.bool).contiguous(), k, form, **knobs)
    return _ref.rank_ref(Q, C, ok, k, form, cc=c_sq_norms)


def _registry_rank(Q, C, ok, distance, k):
    from repro_torch.core import distances as dist_lib

    D = dist_lib.get(distance).point(Q[:, None, :], C)
    D = torch.where(ok, D, torch.full((), dist_lib.BIG, device=D.device))
    return _ref.topk_smallest(D, k)


def rank_gathered(
    Q: Tensor,
    points: Tensor,
    sq_norms: Optional[Tensor],
    cand_idx: Tensor,
    cand_ok: Tensor,
    distance="l2",
    *,
    k: int,
    slot_valid: Optional[Tensor] = None,
    wpq: Optional[int] = None,
    qpb: Optional[int] = None,
    config: Optional[KernelConfig] = None,
) -> tuple[Tensor, Tensor]:
    """Rank per-query candidates given as *indices* into a shared point
    table (the beam-search layout: ``cand_idx[b]`` indexes rows of
    ``points``). Returns ``(dists[b, k] ascending, slots[b, k])`` into the
    candidate axis.

    ``slot_valid``: optional ``bool[n]`` mask of live table rows, folded
    into ``cand_ok`` first. On CUDA the rank kernel gathers the rows
    itself, so the ``[b, w, d]`` cube never exists in device memory."""
    cand_ok = _ref.fold_slot_valid(cand_idx, cand_ok, slot_valid)
    form = resolve_form(distance)
    if form is None:
        rows = torch.clamp(cand_idx.long(), 0, points.shape[0] - 1)
        return _registry_rank(Q, points[rows], cand_ok, distance, k)
    if _on_cuda(Q, points, cand_idx, cand_ok):
        cc = None
        if form in _ref.NORM_FORMS:
            cc = (_f32(sq_norms) if sq_norms is not None
                  else (_f32(points) ** 2).sum(-1))
        knobs = resolve_blocks(
            "rank", form, "float32",
            (Q.shape[0], cand_idx.shape[1], Q.shape[1], k), config,
            wpq=wpq, qpb=qpb)
        return _tk.rank_cuda(
            _f32(Q), _f32(points), cc, cand_idx.to(torch.int32).contiguous(),
            cand_ok.to(torch.bool).contiguous(), k, form, **knobs,
        )
    return _ref.rank_gathered_ref(Q, points, sq_norms, cand_idx, cand_ok, k, form)


def swap_deltas(
    D: Tensor, d1: Tensor, d2: Tensor, n1: Tensor, valid: Tensor, *, k: int,
    kb: Optional[int] = None, config: Optional[KernelConfig] = None,
) -> Tensor:
    """FasterPAM swap-sweep deltas ``[k, g]`` from ``D [g, g]`` and the
    ``[g]`` caches, or batched ``[G, k, g]`` from ``[G, g, g]`` and
    ``[G, g]``. Unmasked: callers mask medoid and invalid columns before
    taking argmins (``core.kmedoids``). ``kb``: the sweep's slots a block
    on the card (``repro``'s row tile ``bg``)."""
    if _on_cuda(D, d1, d2, n1, valid):
        batched = D.dim() == 3
        knobs = resolve_blocks("swap", "none", "float32", (D.shape[-1], k),
                               config, kb=kb)
        args = [_f32(D), _f32(d1), _f32(d2), n1.to(torch.int32).contiguous(),
                valid.to(torch.bool).contiguous()]
        if not batched:
            args = [a[None] for a in args]
        out = _kmk.swap_deltas_cuda(*args, k=k, **knobs)
        return out if batched else out[0]
    return _ref.swap_deltas_ref(D, d1, d2, n1, valid, k)


def scan_quantized(
    Q: Tensor,
    codes: Tensor,
    scales: Tensor,
    cand_idx: Tensor,
    cand_ok: Tensor,
    distance="l2",
    *,
    k: int,
    block: int,
    slot_valid: Optional[Tensor] = None,
    code_format: str = "dense",
    wpq: Optional[int] = None,
    qpb: Optional[int] = None,
    config: Optional[KernelConfig] = None,
) -> tuple[Tensor, Tensor]:
    """Stage 1 of the two-stage search: rank per-query candidates against
    the *quantised* payload tier in its native container.

    ``codes``: ``[n, dc]`` leaf payload codes (int8 / fp16 for
    ``code_format="dense"``, two int4 nibbles per int8 byte for ``"int4"``,
    eight sign bits per uint8 byte for ``"binary"``); ``scales``: ``[nb]``
    per-block scales, ``block`` rows per block; ``cand_idx``/``cand_ok``:
    ``[b, w]`` candidate rows into ``codes`` and their validity (the beam
    layout). Returns ``(dists[b, k] ascending, slots[b, k])`` into the
    candidate axis: *approximate* distances, which callers rerank against
    the exact payload. ``slot_valid`` (``bool[n]``, True = live row) is
    folded into ``cand_ok`` first. On CUDA the scan kernel reads the code
    rows and scales in place: no ``[b, w, dc]`` cube is built. ``wpq`` /
    ``qpb`` (or ``config``'s) set its launch geometry."""
    cand_ok = _ref.fold_slot_valid(cand_idx, cand_ok, slot_valid)
    form = resolve_form(distance)
    if form is None:
        C = _ref.dequantize_rows(codes, scales, block, cand_idx, code_format,
                                 Q.shape[-1])
        return _registry_rank(Q, C, cand_ok, distance, k)
    if _on_cuda(Q, codes, scales, cand_idx, cand_ok):
        dtype = code_format if code_format != "dense" \
            else str(codes.dtype).removeprefix("torch.")
        knobs = resolve_blocks(
            "scan", form, dtype,
            (Q.shape[0], cand_idx.shape[1], Q.shape[1], k), config,
            wpq=wpq, qpb=qpb)
        return _qk.scan_cuda(
            _f32(Q), codes.contiguous(), _f32(scales), block,
            cand_idx.to(torch.int32).contiguous(),
            cand_ok.to(torch.bool).contiguous(), k, form, code_format,
            **knobs,
        )
    return _ref.scan_gathered_ref(Q, codes, scales, block, cand_idx, cand_ok,
                                  k, form, fmt=code_format)
