#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PDASC (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. Build the four CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together); print the build seconds and the
   card's name and power limit.
2. Kernel parity: each kernel against its plain PyTorch version on the
   card, over every form, shapes that are not multiples of any tile,
   masked rows and ``k = w``.
3. The main path at a real size: ``dense_embed`` (a GloVe-100-sized
   surrogate), n = 1,000,000, d = 100, built with gl = 256, euclidean,
   ``method="pam"``; 1,000 held-out queries through
   ``idx.plan(Query(k=10))`` (beam 32); recall@10 against ``exact_knn`` on
   the card; the card's search held against the port's CPU search on the
   same index for 256 queries. Launch counts are zeroed just before and
   read just after; every kernel must have launched.
4. Each kernel timed with CUDA events at the main path's shapes, beside
   its plain version, one PyTorch library call where one computes the same
   function, and its bound (bytes over 3.35 TB/s or fp32 operations over
   67 TFLOP/s, the H100 SXM's published peaks).
5. Recall against the record: dense_embed n = 7,800, gl = 256, euclidean,
   beam 32 must reach recall@10 >= 0.85.
6. The quickstart on the card: euclidean, manhattan, chebyshev and cosine
   with beam; haversine and jaccard with dense.

Tolerance rule (as in tests/test_torch_*.py): fp32 results agree within
rtol = 1e-5 and atol = 1e-5 * max(1, max|ref|); l2 distances are compared
squared (near-zero distances amplify the Gram form's cancellation error
through the square root); top-k ids agree except among entries whose
distances lie within that tolerance of each other. TF32 is off for every
matrix product (``allow_tf32 = False``, matmul precision "highest").

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

N_MAIN = 1_000_000  # main-path points (GloVe-100 has 1.18M vectors)
N_QUERIES = 1000
GROUP_CHUNK = 1024  # groups per build slab (the result does not depend on it)
N_CPU_CHECK = 256
RECALL_FLOOR = 0.85  # repro on the CPU records 0.904 (BENCH_search.json)
PEAK_FLOPS = 67e12  # H100 SXM fp32 on the CUDA cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
BIG = 1e30

KERNELS = {
    "pairwise": ("src/repro_torch/csrc/pairwise.cu",
                 "src/repro/kernels/pairwise.py:168"),
    "rank": ("src/repro_torch/csrc/rank.cu", "src/repro/kernels/topk.py:283"),
    "knn": ("src/repro_torch/csrc/knn.cu", "src/repro/kernels/topk.py:132"),
    "swap_deltas": ("src/repro_torch/csrc/swap.cu",
                    "src/repro/kernels/kmedoids.py:113"),
}


class CheckFailed(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def log(*args) -> None:
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# tolerance rule
# ---------------------------------------------------------------------------


def atol_of(ref: np.ndarray) -> float:
    real = np.abs(ref[np.isfinite(ref) & (np.abs(ref) < BIG / 2)])
    return 1e-5 * max(1.0, float(real.max()) if real.size else 1.0)


def values_agree(out, ref, *, squared: bool = False) -> float:
    """Max abs error of ``out`` against ``ref``; raises outside the rule."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    a, b = (out * out, ref * ref) if squared else (out, ref)
    tol = atol_of(b) + 1e-5 * np.abs(b)
    bad = np.abs(a - b) > tol
    require(not bad.any(), f"values disagree at {int(bad.sum())} entries; "
            f"max err {float(np.abs(a - b).max())}")
    return float(np.abs(out - ref).max()) if out.size else 0.0


def topk_agree(kd, ki, rd, ri, recomputed) -> float:
    """Kernel top-k ``(kd, ki)`` against the plain ``(rd, ri)``; also the
    plain distance of each kernel id (``recomputed``) must equal ``kd``."""
    kd, rd, recomputed = (np.asarray(x, np.float64) for x in (kd, rd, recomputed))
    ki, ri = np.asarray(ki), np.asarray(ri)
    real = rd < BIG / 2
    require(np.array_equal(real, kd < BIG / 2), "masked entries differ")
    err = values_agree(np.where(real, kd, 0), np.where(real, rd, 0))
    values_agree(np.where(real, recomputed, 0), np.where(real, kd, 0))
    atol = atol_of(rd)
    for b in range(rd.shape[0]):
        row = rd[b][real[b]]
        for p in np.nonzero((ki[b] != ri[b]) & real[b])[0]:
            tied = (np.abs(row - rd[b, p]) <= atol).sum() > 1
            require(tied or p == row.size - 1,
                    f"row {b} position {p}: id {ki[b, p]} vs {ri[b, p]} "
                    f"without a near-tie")
    return err


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def recall(ids: np.ndarray, gt: np.ndarray) -> float:
    k = gt.shape[1]
    return float(np.mean([
        len(set(ids[i][ids[i] >= 0].tolist()) & set(gt[i].tolist())) / k
        for i in range(len(gt))
    ]))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build() -> float:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    secs = time.perf_counter() - t0
    log(f"[build] nvcc sm_90a, {len(_build.KERNELS)} kernels: {secs:.3f} s")
    return secs


def _cuda(x):
    import torch

    return torch.from_numpy(np.ascontiguousarray(x)).cuda()


def phase_parity() -> dict:
    """Every kernel against its plain version on the card; returns the max
    error per kernel over the sweep."""
    import torch
    from repro_torch.kernels import kmedoids as kmk, pairwise as pw
    from repro_torch.kernels import ref, topk

    rng = np.random.default_rng(0)
    errs = {name: 0.0 for name in KERNELS}

    for form in ref.FORMS:
        for G, m, n, d in [(1, 37, 91, 13), (3, 70, 65, 100), (1, 1, 129, 2),
                           (2, 64, 64, 16)]:
            X = _cuda(rng.normal(size=(G, m, d)).astype(np.float32))
            Y = _cuda(rng.normal(size=(G, n, d)).astype(np.float32))
            out = pw.pairwise_cuda(X, Y, form).cpu().numpy()
            want = ref.pairwise_ref(X, Y, form).cpu().numpy()
            errs["pairwise"] = max(errs["pairwise"], values_agree(
                out, want, squared=form == "l2"))

        for b, w, d, k, n in [(5, 300, 37, 10, 500), (3, 17, 100, 17, 40),
                              (4, 130, 8, 7, 1000), (9, 1, 3, 1, 5)]:
            Q = _cuda(rng.normal(size=(b, d)).astype(np.float32))
            P = _cuda(rng.normal(size=(n, d)).astype(np.float32))
            sq = (P * P).sum(-1)
            idx = _cuda(rng.integers(0, n, size=(b, w)).astype(np.int32))
            ok = _cuda(rng.random((b, w)) > 0.3)
            ok[0] = False  # an all-masked row
            kd, ks = topk.rank_cuda(Q, P, sq, idx, ok, k, form)
            rd, rs = ref.rank_gathered_ref(Q, P, sq, idx, ok, k, form)
            picked = torch.gather(idx, 1, ks.long())
            again = ref.rowwise_ref(Q, P[picked.long()], form,
                                    sq[picked.long()])
            require(bool(((ks >= 0) & (ks < w)).all()), "rank slots outside [0, w)")
            errs["rank"] = max(errs["rank"], topk_agree(
                kd.cpu(), ks.cpu(), rd.cpu(), rs.cpu(), again.cpu()))

        for q, n, d, k in [(37, 1000, 13, 10), (16, 129, 100, 1),
                           (3, 300, 5, 300), (70, 5000, 64, 32)]:
            Q = _cuda(rng.normal(size=(q, d)).astype(np.float32))
            DB = _cuda(rng.normal(size=(n, d)).astype(np.float32))
            kd, ki = topk.knn_cuda(Q, DB, k, form)
            rd, ri = ref.knn_ref(Q, DB, k, form)
            again = torch.gather(ref.pairwise_ref(Q, DB, form), 1, ki.long())
            errs["knn"] = max(errs["knn"], topk_agree(
                kd.cpu(), ki.cpu(), rd.cpu(), ri.cpu(), again.cpu()))

    for G, g, k in [(3, 50, 7), (2, 256, 128), (1, 33, 1), (5, 100, 50)]:
        D = _cuda(np.abs(rng.normal(size=(G, g, g))).astype(np.float32))
        d1 = _cuda(np.abs(rng.normal(size=(G, g))).astype(np.float32))
        d2 = d1 + _cuda(np.abs(rng.normal(size=(G, g))).astype(np.float32))
        n1 = _cuda(rng.integers(0, k, size=(G, g)).astype(np.int32))
        valid = _cuda(rng.random((G, g)) > 0.2)
        out = kmk.swap_deltas_cuda(D, d1, d2, n1, valid, k)
        want = ref.swap_deltas_ref(D, d1, d2, n1, valid, k)
        errs["swap_deltas"] = max(errs["swap_deltas"], values_agree(
            out.cpu().numpy(), want.cpu().numpy()))
        again = kmk.swap_deltas_cuda(D, d1, d2, n1, valid, k)
        require(bool(torch.equal(out, again)), "swap_deltas differs run to run")
    torch.cuda.synchronize()
    log(f"[parity] all kernels agree with their plain versions: "
        f"{json.dumps(errs)}")
    return errs


def phase_main_path(data: np.ndarray, test: np.ndarray) -> dict:
    """The port's main path at full size; returns what later phases need."""
    import torch
    from repro_torch.baselines import exact_knn
    from repro_torch.core.index import PDASCIndex
    from repro_torch.kernels import ops
    from repro_torch.query import Query

    n = data.shape[0]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()

    t0 = time.perf_counter()
    idx = PDASCIndex.build(data, gl=256, distance="euclidean",
                           radius_quantile=0.35, group_chunk=GROUP_CHUNK,
                           device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_mem = torch.cuda.max_memory_allocated()

    plan = idx.plan(Query(k=10))
    Qc = _cuda(test)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = plan(Qc)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, gt = exact_knn(Qc, data, k=10, device="cuda")
    torch.cuda.synchronize()
    exact_s = time.perf_counter() - t0
    counts = ops.launch_counts()

    rec = recall(res.ids.cpu().numpy(), gt.cpu().numpy())
    log(f"[main] dense_embed n={n} d={data.shape[1]} gl=256 euclidean pam "
        f"group_chunk={GROUP_CHUNK}: build {build_s:.3f} s, "
        f"levels {idx.stats.level_sizes}, peak device memory "
        f"{build_mem / 2**30:.3f} GiB (build) / "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB (run)")
    log(f"[main] plan: {plan.explain()}")
    log(f"[main] {len(test)} queries, beam 32, k=10: {search_s:.4f} s "
        f"({len(test) / search_s:.1f} queries/s, first call), "
        f"recall@10 {rec:.4f}; exact_knn {exact_s:.4f} s")
    log(f"[main] kernel launches on the main path: {json.dumps(counts)}")
    for name, c in counts.items():
        require(c > 0, f"kernel {name} never launched on the main path")
    for beam in (64, 128, 256):
        wide = idx.plan(Query(k=10, beam=beam))(Qc)
        log(f"[main] beam {beam}: recall@10 "
            f"{recall(wide.ids.cpu().numpy(), gt.cpu().numpy()):.4f}, mean "
            f"candidates {float(wide.n_candidates.float().mean()):.0f}")
    t0 = time.perf_counter()
    res2 = plan(Qc)
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    log(f"[main] second search call: {again_s:.4f} s "
        f"({len(test) / again_s:.1f} queries/s)")
    require(np.array_equal(res.ids.cpu().numpy(), res2.ids.cpu().numpy()),
            "the search is not repeatable")
    return dict(idx=idx, res=res, counts=counts, build_s=build_s,
                search_s=search_s, recall=rec, Qc=Qc)


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_breakdown(label: str, fn) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and print where the device
    time went: the busy share of the call's wall time (timed again without
    the profiler) and the ops that took most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side records only (kernels, copies): a CPU op's own device
    # time repeats its kernels'; CUPTI's buffer requests are the tracer's
    events = [e for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and _device_us(e) > 0
              and not e.key.startswith("Activity Buffer")]
    busy_ms = sum(_device_us(e) for e in events) / 1e3
    if busy_ms == 0:  # CUPTI gave no device activity: the share is unknown
        log(f"[profile] {label}: wall {wall_ms:.3f} ms, device busy share "
            f"not measured (the profiler saw no device time)")
        return dict(wall_ms=wall_ms, busy_ms=None)
    top = sorted(events, key=_device_us, reverse=True)[:6]
    log(f"[profile] {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of wall, idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f}%)")
    for e in top:
        log(f"[profile]   {_device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms)


def phase_cpu_check(main: dict) -> None:
    """The card's search against the port's CPU search on the same index."""
    from repro_torch.core.index import PDASCIndex
    from repro_torch.query import Query

    idx = main["idx"]
    arrays = {"leaf_ids": idx.data.leaf_ids.cpu().numpy()}
    for l, lv in enumerate(idx.data.levels):
        for f in lv._fields:
            arrays[f"level{l}_{f}"] = getattr(lv, f).cpu().numpy()
    meta = dict(n_levels=idx.n_levels, level_sizes=idx.stats.level_sizes,
                level_td=idx.stats.level_td, distance=idx.distance.name,
                gl=idx.gl, n_prototypes=idx.n_prototypes,
                max_children=idx.max_children,
                default_radius=idx.default_radius)
    cpu = PDASCIndex.from_arrays(arrays, meta, device="cpu")
    Q = main["Qc"][:N_CPU_CHECK].cpu()
    t0 = time.perf_counter()
    want = cpu.plan(Query(k=10))(Q)
    got = main["res"]
    gd = got.dists[:N_CPU_CHECK].cpu().numpy()
    gi = got.ids[:N_CPU_CHECK].cpu().numpy()
    topk_agree(gd, gi, want.dists.numpy(), want.ids.numpy(), gd)
    log(f"[cpu-check] card search == CPU search on {N_CPU_CHECK} queries "
        f"(CPU took {time.perf_counter() - t0:.1f} s)")


def phase_profile(data: np.ndarray, main: dict) -> None:
    """Device busy share and top ops of one search call and one build."""
    from repro_torch.core.index import PDASCIndex
    from repro_torch.query import Query

    plan = main["idx"].plan(Query(k=10))
    profile_breakdown(f"search {N_QUERIES} queries, beam 32",
                      lambda: plan(main["Qc"]))
    profile_breakdown(
        f"build n={data.shape[0]}",
        lambda: PDASCIndex.build(data, gl=256, distance="euclidean",
                                 radius_quantile=0.35,
                                 group_chunk=GROUP_CHUNK, device="cuda"))


def phase_timing(data: np.ndarray, main: dict) -> list:
    """Each kernel at the main path's shapes: kernel, plain version,
    library call and bound."""
    import torch
    from repro_torch.core import kmedoids as km, nsa
    from repro_torch.kernels import kmedoids as kmk, pairwise as pw
    from repro_torch.kernels import ref, topk

    idx, Qc = main["idx"], main["Qc"]
    rows = []

    def row(name, shape, ms, plain_ms, lib_ms, flops, nbytes, err):
        b_ms, b_by = bound(flops, nbytes)
        src, rep = KERNELS[name]
        rows.append(dict(name=name, route="cuda", source=src, replaces=rep,
                         launches=main["counts"][name], max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, shape=shape))
        log(f"[time] {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), max abs err {err:.3g}")

    # pairwise: one build slab of level 0 (group_chunk groups of 256, d=100)
    G, g, d = GROUP_CHUNK, 256, data.shape[1]
    X = _cuda(data[:G * g].reshape(G, g, d))
    out = pw.pairwise_cuda(X, X, "l2")
    want = ref.pairwise_ref(X, X, "l2")
    err = values_agree(out.cpu().numpy(), want.cpu().numpy(), squared=True)
    row("pairwise", [G, g, g, d],
        time_ms(lambda: pw.pairwise_cuda(X, X, "l2")),
        time_ms(lambda: ref.pairwise_ref(X, X, "l2")),
        time_ms(lambda: torch.cdist(X, X)),
        2.0 * G * g * g * d, 4.0 * (2 * G * g * d + G * g * g), err)

    # swap_deltas: the first sweep of that slab (pruned BUILD medoids)
    k = g // 2
    valid = torch.ones((G, g), dtype=torch.bool, device="cuda")
    medoids = km.build_grouped_pruned(out, k, valid)
    d1, n1, d2 = km._nearest_caches(out, medoids, valid)
    sw = kmk.swap_deltas_cuda(out, d1, d2, n1, valid, k)
    err = values_agree(sw.cpu().numpy(),
                       ref.swap_deltas_ref(out, d1, d2, n1, valid, k).cpu().numpy())
    row("swap_deltas", [G, g, k],
        time_ms(lambda: kmk.swap_deltas_cuda(out, d1, d2, n1, valid, k)),
        time_ms(lambda: ref.swap_deltas_ref(out, d1, d2, n1, valid, k)),
        None, 7.0 * G * g * g,
        4.0 * G * g * g + 13.0 * G * g + 4.0 * G * k * g, err)
    del X, out, want, sw

    # rank: the leaf ranking of the main search (its own candidate table)
    leaf = idx.data.levels[0]
    cand_idx, cand_ok = nsa.descend_beam(
        idx.data, Qc, dist=idx.distance, r=idx.default_radius, beam=32,
        max_children=idx.max_children)
    b, w = cand_idx.shape
    kd, ks = topk.rank_cuda(Qc, leaf.points, leaf.sq_norm, cand_idx, cand_ok,
                            10, "l2")
    rd, rs = ref.rank_gathered_ref(Qc, leaf.points, leaf.sq_norm, cand_idx,
                                   cand_ok, 10, "l2")
    picked = torch.gather(cand_idx, 1, ks.long()).long()
    again = ref.rowwise_ref(Qc, leaf.points[picked], "l2", leaf.sq_norm[picked])
    err = topk_agree(kd.cpu(), ks.cpu(), rd.cpu(), rs.cpu(), again.cpu())
    n_ok = int(cand_ok.sum())
    row("rank", [b, w, d, 10],
        time_ms(lambda: topk.rank_cuda(Qc, leaf.points, leaf.sq_norm, cand_idx,
                                       cand_ok, 10, "l2")),
        time_ms(lambda: ref.rank_gathered_ref(Qc, leaf.points, leaf.sq_norm,
                                              cand_idx, cand_ok, 10, "l2")),
        None, 2.0 * n_ok * d,
        4.0 * b * d + n_ok * (4.0 * d + 4) + 5.0 * b * w + 8.0 * b * 10, err)

    # knn: exact_knn's call, 1000 queries against the whole dataset
    DB = _cuda(data)
    kd, ki = topk.knn_cuda(Qc, DB, 10, "l2")
    rd, ri = ref.knn_ref(Qc, DB, 10, "l2")
    again = ref.rowwise_ref(Qc, DB[ki.long()], "l2")
    err = topk_agree(kd.cpu(), ki.cpu(), rd.cpu(), ri.cpu(), again.cpu())
    del rd, ri
    nq, n = Qc.shape[0], DB.shape[0]
    row("knn", [nq, n, d, 10],
        time_ms(lambda: topk.knn_cuda(Qc, DB, 10, "l2"), iters=5),
        time_ms(lambda: ref.knn_ref(Qc, DB, 10, "l2"), iters=2, warmup=1),
        time_ms(lambda: torch.topk(torch.cdist(Qc, DB), 10, largest=False),
                iters=2, warmup=1),
        2.0 * nq * n * d, 4.0 * (nq * d + n * d) + 8.0 * nq * 10, err)
    return rows


def phase_recall_record() -> float:
    import torch
    from repro_torch.baselines import exact_knn
    from repro_torch.core.index import PDASCIndex
    from repro_torch.data import make_dataset
    from repro_torch.query import Query

    data = make_dataset("dense_embed", n=7800 + 512, seed=0)
    train, test = data[:7800], data[7800:]
    idx = PDASCIndex.build(train, gl=256, distance="euclidean",
                           radius_quantile=0.35, device="cuda")
    res = idx.plan(Query(k=10, beam=32))(test)
    _, gt = exact_knn(test, train, k=10, device="cuda")
    torch.cuda.synchronize()
    rec = recall(res.ids.cpu().numpy(), gt.cpu().numpy())
    log(f"[record] dense_embed n=7800 gl=256 euclidean beam=32, 512 queries: "
        f"recall@10 {rec:.4f} (floor {RECALL_FLOOR}; repro on the CPU "
        f"records 0.904)")
    require(rec >= RECALL_FLOOR, f"recall@10 {rec:.4f} < {RECALL_FLOOR}")
    return rec


def phase_quickstart() -> dict:
    from repro_torch.baselines import exact_knn
    from repro_torch.core.index import PDASCIndex
    from repro_torch.data import make_dataset
    from repro_torch.query import Query

    out = {}

    def run(name, train, test, gl, distance, quantile, execution):
        idx = PDASCIndex.build(train, gl=gl, distance=distance,
                               radius_quantile=quantile, device="cuda")
        res = idx.plan(Query(k=10, execution=execution))(test)
        _, gt = exact_knn(test, train, distance=distance, k=10, device="cuda")
        out[name] = recall(res.ids.cpu().numpy(), gt.cpu().numpy())
        require(np.isfinite(res.dists.cpu().numpy()).all(),
                f"{name}: non-finite distances")
        log(f"[quickstart] {name:10s} ({execution}) recall@10 = "
            f"{out[name]:.3f}, mean candidates "
            f"{float(res.n_candidates.float().mean()):.0f} of {len(train)}")

    data = make_dataset("dense_embed", n=6000, seed=0)
    for distance in ("euclidean", "manhattan", "chebyshev", "cosine"):
        run(distance, data[:5900], data[5900:5950], 256, distance, 0.35, "auto")
    geo = make_dataset("geo_clusters", n=3000, seed=1)
    run("haversine", geo[:2900], geo[2900:2950], 60, "haversine", 0.5, "dense")
    docs = np.abs(make_dataset("sparse_highdim", n=3000, seed=2))
    run("jaccard", docs[:2900], docs[2900:2950], 128, "jaccard", 0.6, "dense")
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py drives the port on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = nvidia_smi()
    log(f"[env] {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"TF32 off (matmul allow_tf32=False, precision 'highest', cudnn "
        f"allow_tf32=False)")

    from repro_torch.data import make_dataset

    phase_build()
    phase_parity()
    t0 = time.perf_counter()
    full = make_dataset("dense_embed", n=N_MAIN + N_QUERIES, seed=0)
    data, test = full[:N_MAIN], full[N_MAIN:]
    log(f"[main] data made in {time.perf_counter() - t0:.1f} s (set-up)")
    main_run = phase_main_path(data, test)
    phase_cpu_check(main_run)
    phase_profile(data, main_run)
    rows = phase_timing(data, main_run)
    phase_recall_record()
    phase_quickstart()
    torch.cuda.synchronize()
    log(json.dumps({"kernels": rows}))
    log(nvidia_smi())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
