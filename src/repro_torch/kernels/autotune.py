"""Launch-geometry autotuner with a persistent winner cache (counterpart of
``repro.kernels.autotune``).

The CUDA kernel wrappers take launch knobs (``ops.KernelConfig``: ``wpq`` /
``qpb`` for rank and scan, ``bq`` / ``splits`` for knn, ``kb`` for the swap
sweep); by default each takes its heuristic's geometry for the call's
shape. This module learns better ones on the card:

* **candidate grids** (:func:`candidate_grid`) hold the heuristic's pick
  first, then a fixed set of geometries around it, each kept only where
  :func:`fits` says the kernel can launch it (the wrappers' own shared
  memory and grid limits) and deduplicated by the geometry it launches, so
  the cached winner never loses to the heuristic on the sweep's own
  timings. ``pairwise`` has one member: ``pairwise.cu``'s ``[128, 128]``
  tile is fixed by its ``wgmma`` layout;
* **timing** (:func:`time_knobs`) runs the real wrapper on the card, CUDA
  events around each call (a replay of a CUDA graph that holds it, so the
  host's time to enqueue it is not counted), after a warmup that also
  absorbs ``nvcc``'s first build, and takes the median; it never times a
  plain version, and raises where there is no CUDA device. The score is ``median_us * (1 +
  pad_waste)``: launched query, slot or row capacity beyond the problem
  counts against a geometry, so one that wins only because the timing
  shape fits it exactly is not cached for the whole bucket;
* **winners** persist in a versioned JSON cache, the format of ``repro``'s
  (each package keeps the other's entries), keyed ``backend|op|form|dtype|
  bucket`` with backend ``cuda``. Shapes bucket to power-of-two ceilings.
  ``rank``, ``scan`` and ``knn`` key on ``(rows, width, d, k)`` and
  ``swap`` on ``(g, k)``: ``repro``'s shapes with k last, since whether a
  geometry fits Hopper's shared memory depends on k. Corrupt or
  stale-version files are ignored with a warning.

Resolution happens at ``ops`` dispatch (``ops.resolve_blocks``):
``KernelConfig(auto=True)`` makes unset knobs come from :func:`lookup`,
whose winner must fit the call's own shape or it counts as a miss. Tuning
is explicit (:func:`tune`), never from a hot path. Every cache change bumps
:func:`generation`, which the plan compiler stamps into ``auto=True``
kernel configs, so their cached plans re-plan when the winners change.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import kmedoids as _kmk
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import pairwise as _pw
from repro_torch.kernels import quantized as _qk
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import topk as _tk
from repro_torch.obs import names as mnames

CACHE_VERSION = 1
_ENV_PATH = "REPRO_TORCH_TUNE_CACHE"
BACKEND = "cuda"

OPS = ("pairwise", "knn", "rank", "scan", "swap")

SCAN_BLOCK = 256  # rows a scale block in the scan's timing inputs
_SWAP_D_BYTES = 1 << 28  # the swap timing slab's D: 1,024 groups at g = 256
_RANK_AXIS = (1, 2, 4, 8)  # wpq and qpb candidates (wpq * qpb <= 8)
_KNN_SPLIT_FACTORS = (0.5, 1, 2)  # x the heuristic's splits
_SWAP_KB = (512, 256, 128, 64)  # besides k itself

_state: dict = {"path": None, "entries": None, "gen": 0}

# Serialises in-process record() mutate+save pairs; cross-process safety
# comes from _save's unique temp file + atomic rename (last writer wins,
# never a torn file).
_write_lock = threading.Lock()


# ---------------------------------------------------------------------------
# Winner cache (versioned on-disk JSON)
# ---------------------------------------------------------------------------


def cache_path() -> str:
    """The winner-cache file: ``set_cache_path`` > $REPRO_TORCH_TUNE_CACHE >
    ``~/.cache/repro_torch/kernel_tune.json``."""
    if _state["path"] is not None:
        return _state["path"]
    env = os.environ.get(_ENV_PATH)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "kernel_tune.json")


def set_cache_path(path: Optional[str]) -> None:
    """Point the tuner at a cache file (None = default), dropping the
    in-memory snapshot. Bumps the generation: plans stamped with the tuner
    state re-plan against the new cache."""
    _state["path"] = path
    _state["entries"] = None
    _state["gen"] += 1


def generation() -> int:
    """Monotonic counter bumped on every cache change (record / repoint),
    stamped into ``auto=True`` kernel configs by ``query/plan.py``."""
    return _state["gen"]


def _entries() -> dict:
    if _state["entries"] is None:
        entries: dict = {}
        path = cache_path()
        if os.path.exists(path):
            try:
                with open(path) as f:
                    blob = json.load(f)
                if not isinstance(blob, dict) or "version" not in blob:
                    raise ValueError("not a tuner cache blob")
                if blob["version"] != CACHE_VERSION:
                    warnings.warn(
                        f"kernel-tune cache {path} has version "
                        f"{blob['version']!r} != {CACHE_VERSION}; ignoring it")
                else:
                    entries = {
                        k: v for k, v in blob.get("entries", {}).items()
                        if isinstance(v, dict)
                        and isinstance(v.get("knobs"), dict)
                    }
            except (ValueError, OSError) as e:
                warnings.warn(f"ignoring corrupt kernel-tune cache {path}: {e}")
        _state["entries"] = entries
    return _state["entries"]


def _save() -> None:
    path = os.path.abspath(cache_path())
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    # a unique temp file per writer, then an atomic rename in the same
    # directory: readers see the old cache or a whole new one
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp", dir=parent)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump({"version": CACHE_VERSION, "entries": _entries()}, f,
                      indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def shape_bucket(shape) -> tuple:
    """Power-of-two ceiling per axis (128 -> 128, 129 -> 256, 1 -> 1)."""
    return tuple(
        1 if int(x) <= 1 else 1 << (int(x) - 1).bit_length() for x in shape)


def cache_key(op: str, form: str, dtype: str, shape,
              backend: Optional[str] = None) -> str:
    bucket = "x".join(str(v) for v in shape_bucket(shape))
    return f"{backend or BACKEND}|{op}|{form}|{dtype}|{bucket}"


def lookup(*, op: str, form: str, dtype: str, shape,
           backend: Optional[str] = None, accept=None) -> Optional[dict]:
    """Cached winner knobs for a key, or None. ``accept(knobs)``: where
    given and false, the winner is skipped and counted as a miss (a winner
    that cannot run at the caller's own shape)."""
    entry = _entries().get(cache_key(op, form, dtype, shape, backend))
    knobs = dict(entry["knobs"]) if entry else None
    if knobs is not None and accept is not None and not accept(knobs):
        knobs = None
    obs.counter(mnames.AUTOTUNE_HITS if knobs is not None
                else mnames.AUTOTUNE_MISSES, op=op).inc()
    return knobs


def record(*, op: str, form: str, dtype: str, shape, knobs: dict, us: float,
           backend: Optional[str] = None) -> None:
    """Persist a winner and bump the generation."""
    with _write_lock:
        _entries()[cache_key(op, form, dtype, shape, backend)] = dict(
            knobs={k: int(v) for k, v in knobs.items()}, us=float(us))
        _save()
        _state["gen"] += 1
    obs.counter(mnames.AUTOTUNE_RETUNES, op=op).inc()


# ---------------------------------------------------------------------------
# Geometry: what a knob set launches at a shape, and whether it can
# ---------------------------------------------------------------------------


def _pairwise_dims(shape) -> tuple:
    """``(G, m, n)`` of a pairwise shape ``(m, n, d)`` or ``(G, m, n, d)``."""
    return (1, *shape[:2]) if len(shape) == 3 else tuple(shape[:3])


def geometry(op: str, knobs: dict, shape, form: Optional[str] = "l2",
             sms: int = _tk.H100_SMS):
    """The launch geometry the op's wrapper takes for ``knobs`` (missing or
    None knobs: the heuristic) at ``shape``; raises ``ValueError`` naming
    the limit where it cannot run. Shapes: rank / scan ``(b, w, d, k)``,
    knn ``(nq, n, d, k)``, swap ``(g, k)``, pairwise ``(m, n, d)`` or
    ``(G, m, n, d)``."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; tunable ops: {OPS}")
    unknown = set(knobs) - set(_ops.OP_KNOBS[op])
    if unknown:
        raise ValueError(f"{op} has no launch knob {sorted(unknown)}; its "
                         f"knobs: {_ops.OP_KNOBS[op]}")
    get = knobs.get
    if op == "rank":
        b, w, d, k = shape
        return _tk.rank_geometry(b, d, w, k, wpq=get("wpq"), qpb=get("qpb"))
    if op == "scan":
        b, w, d, k = shape
        return _qk.scan_geometry(b, d, w, k, wpq=get("wpq"), qpb=get("qpb"))
    if op == "knn":
        nq, n, d, k = shape
        return _tk.knn_geometry(nq, n, d, k, form, sms, bq=get("bq"),
                                splits=get("splits"))
    if op == "swap":
        g, k = shape
        return _kmk.check_swap_shape(g, k, get("kb"))
    return _pw.pairwise_geometry(*_pairwise_dims(shape))


def fits(op: str, knobs: dict, shape, form: Optional[str] = "l2") -> bool:
    """Whether the op's kernel can launch ``knobs`` at ``shape`` (the
    wrapper would raise otherwise)."""
    try:
        geometry(op, knobs, shape, form)
    except ValueError:
        return False
    return True


def knobs_of(op: str, geo) -> dict:
    """The explicit knobs that launch geometry ``geo``."""
    return {knob: int(getattr(geo, knob)) for knob in _ops.OP_KNOBS[op]}


def heuristic(op: str, shape, form: Optional[str] = "l2") -> dict:
    """The heuristic's geometry at ``shape``, as explicit knobs."""
    return knobs_of(op, geometry(op, {}, shape, form))


def pad_waste(op: str, knobs: dict, shape, form: Optional[str] = "l2"
              ) -> float:
    """Launched capacity beyond the problem, as a fraction of it: queries
    past ``b`` in the last block (rank, scan), queries past ``nq`` and DB
    rows past ``n`` (knn), slots past ``k`` (swap), output past ``m x n``
    in the 128-row tiles (pairwise)."""
    geo = geometry(op, knobs, shape, form)
    if op in ("rank", "scan"):
        launched, real = geo.blocks * geo.qpb, shape[0]
    elif op == "knn":
        nq, n = shape[0], shape[1]
        launched = -(-nq // geo.bq) * geo.bq * geo.chunk * geo.splits
        real = nq * n
    elif op == "swap":
        launched, real = geo.slot_blocks * geo.kb, shape[1]
    else:
        _, m, n = _pairwise_dims(shape)
        launched, real = geo.tiles_m * geo.tiles_n * 128 * 128, m * n
    return launched / max(real, 1) - 1.0


def _raw_grid(op: str, shape, form: Optional[str]) -> list:
    if op in ("rank", "scan"):
        return [dict(wpq=a, qpb=b) for a in _RANK_AXIS for b in _RANK_AXIS
                if a * b <= 8]
    if op == "knn":
        s0 = geometry(op, {}, shape, form).splits
        splits = sorted({max(1, int(s0 * f)) for f in _KNN_SPLIT_FACTORS})
        return [dict(bq=bq, splits=s) for bq in _tk._KNN_TILES
                for s in splits]
    if op == "swap":
        k = shape[1]
        return [dict(kb=kb) for kb in (k,) + _SWAP_KB if kb <= k]
    return []


def candidate_grid(op: str, form: str, dtype: str, shape, *,
                   backend: Optional[str] = None) -> list:
    """The sweep: the heuristic's geometry first (as explicit knobs), then
    the op's grid (rank / scan ``wpq, qpb in {1, 2, 4, 8}`` with ``wpq *
    qpb <= 8``; knn ``bq in {16, 32, 64, 128}`` x ``splits in {1/2, 1, 2}``
    x the heuristic's splits; swap ``kb in {k, 512, 256, 128, 64}`` up to
    k; pairwise nothing more), each kept where it :func:`fits` and
    launches a geometry no earlier member launches. ``dtype`` and
    ``backend`` do not change the grid (``repro``'s signature)."""
    out, seen = [], set()
    for knobs in [heuristic(op, shape, form)] + _raw_grid(op, shape, form):
        if not fits(op, knobs, shape, form):
            continue
        geo = geometry(op, knobs, shape, form)
        if geo in seen:
            continue
        seen.add(geo)
        out.append(knobs)
    return out


# ---------------------------------------------------------------------------
# Timing harness (the card only)
# ---------------------------------------------------------------------------


def make_inputs(op: str, form: str, dtype: str, shape, device="cuda"):
    """Deterministic inputs for one op at one (dtype, shape), drawn from
    ``np.random.default_rng(0xC0FFEE)`` in the wrappers' layouts:

    * pairwise ``(X, Y)``: ``[G, m, d]`` and ``[G, n, d]``, Y the same
      tensor as X where m == n (the build's slab);
    * knn ``(Q, DB)``;
    * rank ``(Q, points, sq_norm, cand_idx, ok)``: ``b * w`` table rows, a
      permutation of them as the candidates, 90% of slots unmasked;
    * scan ``(Q, codes, scales, cand_idx, ok)``: the codes of ``b * w``
      rows in ``dtype``'s container (int8, float16, int4, binary),
      :data:`SCAN_BLOCK` rows a scale;
    * swap ``(D, d1, d2, n1, valid)``: symmetric ``[G, g, g]`` with the
      caches of k random medoids a group, ``G`` groups filling 256 MiB of
      D (1,024 at g = 256, the build's slab)."""
    rng = np.random.default_rng(0xC0FFEE)
    f32 = np.float32

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def normal(*size):
        return rng.standard_normal(size, dtype=f32)

    if op == "pairwise":
        G, m, n = _pairwise_dims(shape)
        X = t(normal(G, m, shape[-1]))
        return (X, X if m == n else t(normal(G, n, shape[-1])))
    if op == "knn":
        nq, n, d, _ = shape
        return (t(normal(nq, d)), t(normal(n, d)))
    if op in ("rank", "scan"):
        b, w, d, _ = shape
        Q = t(normal(b, d))
        cand = t(rng.permutation(b * w).astype(np.int32).reshape(b, w))
        ok = t(rng.random((b, w)) < 0.9)
        vals = normal(b * w, d)
        if op == "rank":
            P = t(vals)
            return (Q, P, (P * P).sum(1), cand, ok)
        nb = -(-(b * w) // SCAN_BLOCK)
        scales = np.full(nb, 0.05, f32)
        if dtype == "float16":
            codes, scales = t(vals.astype(np.float16)), np.ones(nb, f32)
        elif dtype == "int4":
            codes = _ref.pack_int4(torch.from_numpy(np.clip(
                np.round(vals / 0.05), -7, 7).astype(np.int32))).to(device)
        elif dtype == "binary":
            codes = _ref.pack_binary(torch.from_numpy(vals)).to(device)
        elif dtype == "int8":
            codes = t(np.clip(np.round(vals / 0.05), -127, 127)
                      .astype(np.int8))
        else:
            raise ValueError(f"scan codes come as int8, float16, int4 or "
                             f"binary, not {dtype!r}")
        return (Q, codes, t(scales), cand, ok)
    if op == "swap":
        g, k = shape
        G = max(1, _SWAP_D_BYTES // (4 * g * g))
        D = np.abs(normal(G, g, g))
        D = D + D.transpose(0, 2, 1)
        D[:, np.arange(g), np.arange(g)] = 0.0
        med = np.argsort(rng.random((G, g)), axis=1)[:, :k]
        dm = np.take_along_axis(D, med[:, None, :], axis=2)  # [G, g, k]
        part = np.argpartition(dm, min(1, k - 1), axis=2)
        d1 = np.take_along_axis(dm, part[..., :1], axis=2)[..., 0]
        d2 = np.take_along_axis(dm, part[..., 1:2], axis=2)[..., 0] \
            if k > 1 else np.full_like(d1, 1e30)
        return (t(D), t(d1), t(d2), t(part[..., 0].astype(np.int32)),
                t(np.ones((G, g), bool)))
    raise ValueError(f"unknown op {op!r}; tunable ops: {OPS}")


def launch(op: str, form: str, dtype: str, inputs, knobs: dict, k: int):
    """One call of the op's CUDA wrapper on :func:`make_inputs`' tensors
    at ``knobs``."""
    if op == "pairwise":
        return _pw.pairwise_cuda(*inputs, form)
    if op == "knn":
        return _tk.knn_cuda(*inputs, k, form, **knobs)
    if op == "rank":
        return _tk.rank_cuda(*inputs, k, form, **knobs)
    if op == "scan":
        Q, codes, scales, cand, ok = inputs
        fmt = dtype if dtype in ("int4", "binary") else "dense"
        return _qk.scan_cuda(Q, codes, scales, SCAN_BLOCK, cand, ok, k, form,
                             fmt, **knobs)
    if op == "swap":
        return _kmk.swap_deltas_cuda(*inputs, k, **knobs)
    raise ValueError(f"unknown op {op!r}; tunable ops: {OPS}")


def shape_k(op: str, shape) -> int:
    """The k of a key shape (its last axis; pairwise has none)."""
    return 0 if op == "pairwise" else int(shape[-1])


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("the tuner times the CUDA kernels on the card; "
                           "this machine has no CUDA device")


def time_knobs(op: str, form: str, dtype: str, shape, knobs: dict, *,
               reps: int = 5, warmup: int = 1, inputs=None) -> float:
    """Median device time (us) of one knob set on the card: ``warmup``
    calls on a side stream (the first builds the kernel), one call
    captured in a CUDA graph, then CUDA events around each of ``reps``
    replays of it, so the host's time to prepare and enqueue the call is
    not counted (the wrappers allocate with ``torch.empty`` and launch on
    the current stream: both capture). Raises where there is no CUDA
    device: the plain versions are never timed."""
    _require_cuda()
    if inputs is None:
        inputs = make_inputs(op, form, dtype, shape)
    k = shape_k(op, shape)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(max(warmup, 1)):
            launch(op, form, dtype, inputs, knobs, k)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch(op, form, dtype, inputs, knobs, k)
    times = []
    for _ in range(max(reps, 1)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    del graph
    return float(np.median(times))


def tune(op: str, *, form: str = "l2", dtype: str = "float32", shape,
         backend: Optional[str] = None, reps: int = 5, warmup: int = 1,
         force: bool = False, measure=None) -> dict:
    """Sweep the candidate grid for one key and cache the winner.

    Returns ``dict(winner, winner_us, default, default_us, sweep,
    cached)``, ``default`` being the heuristic's knobs. A cache hit (and
    ``force=False``) returns without timing anything. ``measure(knobs) ->
    us`` injects the timing (tests, or a caller that checks each
    candidate's output first); the default is :func:`time_knobs` on one
    set of inputs. ``swap`` keys on form ``"none"`` whatever ``form`` says,
    as ``ops.swap_deltas`` looks it up (its sweep has no distance form)."""
    if op == "swap":
        form = "none"
    cached = lookup(op=op, form=form, dtype=dtype, shape=shape,
                    backend=backend)
    if cached is not None and not force:
        entry = _entries()[cache_key(op, form, dtype, shape, backend)]
        return dict(winner=cached, winner_us=entry.get("us"), default=None,
                    default_us=None, sweep=[], cached=True)
    if measure is None:
        _require_cuda()
        inputs = make_inputs(op, form, dtype, shape)

        def measure(knobs):
            return time_knobs(op, form, dtype, shape, knobs, reps=reps,
                              warmup=warmup, inputs=inputs)
    default = heuristic(op, shape, form)
    sweep = []
    for knobs in candidate_grid(op, form, dtype, shape, backend=backend):
        us = float(measure(knobs))
        waste = pad_waste(op, knobs, shape, form)
        sweep.append(dict(knobs=knobs, us=us, waste=round(waste, 4),
                          score=us * (1.0 + waste)))
    best = min(sweep, key=lambda r: r["score"])
    record(op=op, form=form, dtype=dtype, shape=shape, knobs=best["knobs"],
           us=best["us"], backend=backend)
    return dict(winner=dict(best["knobs"]), winner_us=best["us"],
                default=default, default_us=sweep[0]["us"], sweep=sweep,
                cached=False)
