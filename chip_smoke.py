#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PDASC (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. Build the five CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together); print the build seconds and the
   card's name and power limit.
2. Kernel parity: each kernel against its plain PyTorch version on the
   card, over every form, shapes that are not multiples of any tile,
   masked rows and ``k = w``. pairwise at G = 1, 3 and a 1024-group slab
   whose last group is part padding, m and n of 1, 37, 129 and 300, d = 1,
   3, 13, 100 and 1536, X the same tensor as Y and not, and on integer
   data bit for bit (sqeuclidean); rank at w = 1, 31, 33, 384 and 4096
   with k = 1, 10 and w, d = 3, 100 and 1536, one table row in two slots
   (lower slot first); knn at d = 3 and 100, q = 1 and 129, k = 1024, on a
   DB of copied rows (lower ids first among copies), on near-duplicate rows
   at the largest d its wgmma route admits (~1,224, where it accumulates
   longest), and on its streaming route (d = 1536 and 4096 in every form,
   k = 33, 100 and 1024, and the largest k it admits, its states in device
   memory, at d = 100 and 1536); swap_deltas also at g = 300, k = 1 and
   with every row of one slot masked, and past g = 1,456 at (g, k) =
   (1,457, 728), (2,048, 1,024) and (4,096, 2,048) (its slot-split
   layout); pairwise also at [1024, 256, 100] x [1024, 128, 100] (X not
   Y: the k-means relabel); rank and scan at k = 1 through the ops with a
   ``slot_valid`` mask that kills every slot of one query (the online
   routing); the scan kernel over every form x
   {int8, fp16, int4, binary}, ragged shapes, w = 1, a ``slot_valid``
   mask, and d = 3, 13, 100 and 101 at w = 384 with k = 1, 10, 128 and
   w, a row with fewer unmasked slots than k and one table row in two
   slots (lower slot first). Every kernel's repeat call must be
   bit-identical.
   Then the card's build against the port's CPU build: integer-valued
   dense_embed-shaped data (n = 20,000, d = 100, values in [0, 64)),
   gl = 256, euclidean, pam, no shuffle, equal level by level, and each
   level's fp64 sum of its points' distances to their medoids within rtol
   1e-6; a real-valued 50,000-row slice with level-0 TD within 1%.
3. The main path at a real size: ``dense_embed`` (a GloVe-100-sized
   surrogate), n = 1,000,000, d = 100, built with gl = 256, euclidean,
   ``method="pam"``; 1,000 held-out queries through
   ``idx.plan(Query(k=10))`` (beam 32); recall@10 against ``exact_knn`` on
   the card; the card's search held against the port's CPU search on the
   same index for 256 queries. Launch counts are zeroed just before and
   read just after; every kernel must have launched.
   Then the storage path on the same index: an int8 store (block 256,
   exact payload in a memmapped file), ``release_dense_payload()``, and
   ``idx.plan(Query(k=10))``, which must resolve to ``two_stage``; the
   1,000 queries through it with launch counts zeroed just before and
   read just after (scan and rank must launch), recall@10 held to the beam
   recall minus 0.01, the ∞ rerank width held bit-equal to the beam
   result, the card held against the port's CPU two-stage on 256 queries;
   payload bytes per vector; fp16, int4 and binary stores through
   ``search_two_stage``; a profile of one two-stage call.
4. Each kernel's device time (CUDA events around replays of a CUDA graph
   of its calls: no host gaps; rank and scan also without the graph,
   host gaps included) at the main path's shapes, beside its plain
   version and one PyTorch library call or composition that computes the
   same function (CUDA events around back-to-back calls), and its bound:
   the larger of bytes over 3.35 TB/s and operations over the peak of
   the fastest route the work can take at its precision (the H100 SXM's
   published peaks): 67 TFLOP/s fp32 on the CUDA cores, or for the Gram
   forms of knn and pairwise the lesser time of that and 3xTF32 on the
   tensor cores (495 TFLOP/s TF32 / 3). pairwise and knn also in l1
   (their CUDA-core routes), knn also on its streaming route at [1000,
   100,000, 1536, 10] and in l1 at [1000, 100,000, 3072, 10] (one plain
   and one library call there); rank also summed over one beam search's
   launches (from the profile). The scan kernel at the storage path's
   shapes in each of its four code formats.
   Then k-means and its users: ``method="kmeans"`` at n = 1M, gl = 256
   (the port's own ``check_index_invariants``, level TDs all 0, recall@10
   beside the pam build's); pam at gl = 2048 (k = 1024) on 200,000 rows
   (swap_deltas's split slots on the build path); IVF-Flat at 1M with
   n_cells = n // 256 and n_probe = 8 (build s, query s, recall@10).
   Then the online tiers on a copy of the 1M index (``from_arrays`` of
   its arrays): 2,048 upserts of resident rows + N(0, 0.05) noise in 16
   batches of 128, 256 replacements, 1,024 resident deletes and 256
   deletes of upserted ids through ``EpochHandle.apply_writes``;
   ``needs_compaction()`` true; 1,000 queries through
   ``plan(Query(k=10))`` with the delta leg and the tombstone mask: no
   deleted id, an upserted vector finds itself first, card == CPU on 256
   queries, recall@10 within 0.02 of a fresh build on the live set;
   ``compact(scope="affected")`` and ``"full"``: invariants, untouched
   groups bit-identical, the share of changed groups, the dense exact
   search equal to exact_knn over the live set as sets; writes/s, q/s
   under churn and frozen, both compaction times. After the store phase
   the same stream at 1/8 its size on the released int8 index: routing
   by the scan at k = 1, two-stage under the mask, an affected compaction
   whose ``LeafStore.rebuild`` writes a fresh file and keeps the
   unchanged blocks' codes (the share re-quantised printed). Launch
   counts are zeroed before each of these phases and read after it:
   every kernel of the phase's path must have launched.
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

The last three lines are the kernels' JSON record (each kernel's
``launches`` on the main path, and under ``phase_launches`` its launches
in each phase's own run), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

N_MAIN = 1_000_000  # main-path points (GloVe-100 has 1.18M vectors)
N_QUERIES = 1000
GROUP_CHUNK = 1024  # groups per build slab (the result does not depend on it)
N_CPU_CHECK = 256
RECALL_FLOOR = 0.85  # repro on the CPU records 0.904 (BENCH_search.json)
PEAK_FP32 = 67e12  # H100 SXM fp32 on the CUDA cores
PEAK_TF32 = 495e12  # H100 SXM TF32 tensor cores, dense
# The Gram forms may take either route: fp32 on the CUDA cores, or 3xTF32
# (three TF32 products per fp32 product) on the tensor cores.
PEAK_GRAM = max(PEAK_FP32, PEAK_TF32 / 3)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
BIG = 1e30
PHASE_LAUNCHES: dict = {}  # phase -> launch counts of its own run

KNN_CASES = [  # (q, n, d, k): ragged against every tile, q = 1 and 129
    (37, 1000, 13, 10), (16, 129, 100, 1), (3, 300, 5, 300), (70, 5000, 64, 32),
    (20, 1037, 3, 10), (45, 3001, 100, 16), (1, 2000, 100, 10),
    (129, 1500, 100, 10), (5, 3000, 100, 1024)]
KNN_STREAM_SHAPE = (1000, 100_000, 1536)  # timed: q, n, d (k = 10, l2)
KNN_STREAM_L1_SHAPE = (1000, 100_000, 3072)  # timed in l1 (fp32 cores)
KNN_STREAM_CASES = [  # (q, n, d, k): the streaming route (any d; k > 1024)
    (37, 3000, 1536, 10), (5, 2000, 4096, 10), (20, 3000, 1536, 1024),
    (130, 2600, 4096, 33), (150, 1900, 1536, 100), (7, 2100, 1541, 10)]
PAIRWISE_CASES = [  # (G, m, n, d, X is Y): ragged against the 128-row tile
    (1, 37, 91, 13, False), (3, 70, 65, 100, False), (1, 1, 129, 2, False),
    (2, 64, 64, 16, False), (1, 1, 37, 1, False), (3, 37, 129, 3, False),
    (1, 129, 300, 13, False), (3, 300, 1, 100, False), (1, 37, 129, 1536, False), (3, 129, 129, 100, True),
    (1, 300, 300, 1536, True), (3, 37, 37, 13, True), (1024, 256, 256, 100, True),
    (1024, 256, 128, 100, False)]  # the k-means relabel: groups x their medoids
PAIRWISE_INT_CASES = [  # (G, m, n, d, |x| <, X is Y): every sum below 2^24
    (3, 129, 300, 3, 2048, False), (2, 256, 256, 100, 64, True),
    (1, 37, 129, 1536, 64, False), (1, 300, 300, 1536, 64, True)]
RANK_CASES = [  # (b, w, d, k, n), then every RANK_WIDTHS x k in {1, 10, w}
    (5, 300, 37, 10, 500), (3, 17, 100, 17, 40), (4, 130, 8, 7, 1000),
    (9, 1, 3, 1, 5)]
RANK_WIDTHS = (1, 31, 33, 384, 4096)
RANK_DIMS = (3, 100, 1536)
SWAP_CASES = [  # (G, g, k): g = 300 is ragged against the 64-column tile;
    (3, 50, 7), (2, 256, 128), (1, 33, 1), (5, 100, 50), (2, 300, 64),
    (3, 300, 1),  # past g = 1,456: staged in chunks, then the slots split
    (2, 1457, 728), (1, 2048, 1024), (1, 4096, 2048)]
KERNELS = {
    "pairwise": ("src/repro_torch/csrc/pairwise.cu",
                 "src/repro/kernels/pairwise.py:168"),
    "rank": ("src/repro_torch/csrc/rank.cu", "src/repro/kernels/topk.py:283"),
    "knn": ("src/repro_torch/csrc/knn.cu", "src/repro/kernels/topk.py:132"),
    "swap_deltas": ("src/repro_torch/csrc/swap.cu",
                    "src/repro/kernels/kmedoids.py:113"),
    "scan": ("src/repro_torch/csrc/scan.cu",
             "src/repro/kernels/quantized.py:153"),
}
BEAM_PATH_KERNELS = ("pairwise", "rank", "knn", "swap_deltas")  # phase 3
STORE_PATH_KERNELS = ("scan", "rank")  # the two-stage call
# the new phases' windows: each zeroes the counts just before its own work
# and requires these kernels just after it
WINDOW_KERNELS = {
    "kmeans-build": ("pairwise",),  # Lloyd relabel of the snapped medoids
    "kmeans-search": ("rank",),  # beam 32 on the k-means index
    "kmeans-truth": ("knn",),  # exact_knn for its recall
    "pam-gl2048": ("pairwise", "swap_deltas"),  # the split slot blocks
    "ivf": ("pairwise",),  # IVF-Flat build and search
    "online-writes": ("rank",),  # routing: beam-1 descent, rank at k = 1
    "online-search": ("pairwise", "rank"),  # delta scan, masked leaf rank
    "online-truth": ("knn",),  # exact_knn over the live set
    "online-compact": ("pairwise", "swap_deltas"),  # both scopes
    "online-compacted": ("rank",),  # the compacted epochs' searches
    "store-churn-writes": ("rank", "scan"),  # routing through scan, k = 1
    "store-churn-search": ("pairwise", "rank", "scan"),  # two-stage + legs
    "store-churn-compact": ("pairwise", "swap_deltas"),  # + LeafStore.rebuild
}
SYMBOLS = {  # each kernel's __global__ functions
    "pairwise": ("pairwise_kernel",), "rank": ("rank_kernel",),
    "knn": ("knn_kernel", "knn_stream_kernel", "knn_split_kernel", "knn_merge_kernel"),
    "swap_deltas": ("swap_order_kernel", "swap_kernel", "swap_finish_kernel"),
    "scan": ("scan_kernel",)}
KERNEL_SYMBOLS = tuple(s for syms in SYMBOLS.values() for s in syms)
STORE_BLOCK = 256  # bench_store.py's full-run block size
RERANK_WIDTH = 128  # Query's default rerank_width
SCAN_FORMATS = {"int8": "dense", "fp16": "dense", "int4": "int4",
                "binary": "binary"}
SCAN_CASES = [  # (b, w, d, k, n, block): ragged shapes, then SCAN_DIMS x k
    (5, 300, 37, 10, 500, 64), (3, 17, 13, 17, 40, 8),
    (4, 130, 100, 7, 1000, 256), (9, 1, 3, 1, 5, 2)]
SCAN_DIMS = (3, 13, 100, 101)  # odd d: a padded int4 nibble, part-filled bytes
SCAN_WIDTH = 384  # the two-stage path's leaf candidate width
N_BIG_GL = 200_000  # rows of the gl = 2048 build
IVF_PROBE = 8  # bench_recall.py: n_cells = n // 256, n_probe = 8
CHURN = dict(upserts=2048, batch=128, replace=256, delete=1024,
             delete_upserted=256)  # the online phase's write stream


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


def values_agree(out, ref, *, squared: bool = False, atol=None) -> float:
    """Max abs error of ``out`` against ``ref``; raises outside the rule
    (``atol`` overrides the rule's, taken from ``ref`` itself)."""
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    a, b = (out * out, ref * ref) if squared else (out, ref)
    tol = (atol_of(b) if atol is None else atol) + 1e-5 * np.abs(b)
    bad = np.abs(a - b) > tol
    require(not bad.any(), f"values disagree at {int(bad.sum())} entries; "
            f"max err {float(np.abs(a - b).max())}")
    return float(np.abs(out - ref).max()) if out.size else 0.0


def topk_agree(kd, ki, rd, ri, recomputed, *, squared: bool = False,
               atol=None) -> float:
    """Kernel top-k ``(kd, ki)`` against the plain ``(rd, ri)``; also the
    plain distance of each kernel id (``recomputed``) must equal ``kd``.
    ``squared`` and ``atol`` as in ``values_agree`` (near-tied ids are then
    judged on the squared values)."""
    kd, rd, recomputed = (np.asarray(x, np.float64) for x in (kd, rd, recomputed))
    ki, ri = np.asarray(ki), np.asarray(ri)
    real = rd < BIG / 2
    require(np.array_equal(real, kd < BIG / 2), "masked entries differ")
    err = values_agree(np.where(real, kd, 0), np.where(real, rd, 0),
                       squared=squared, atol=atol)
    values_agree(np.where(real, recomputed, 0), np.where(real, kd, 0),
                 squared=squared, atol=atol)
    if squared:
        rd = rd * rd
    atol = atol_of(rd) if atol is None else atol
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
    """Time of one call of ``fn`` on the card's clock: CUDA events around
    ``iters`` back-to-back calls after ``warmup``. Where the host takes
    longer to enqueue a call than the card to run it, this measures the
    host (``kernel_ms`` does not)."""
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


def kernel_ms(fn, iters: int = 10, replays: int = 3) -> float:
    """Device time of one call of a kernel wrapper ``fn``: ``iters`` calls
    captured in a CUDA graph, CUDA events around ``replays`` replays, so no
    host gap between launches is counted (the wrappers allocate with
    ``torch.empty`` and launch on the current stream: both capture)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * iters)


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32
          ) -> tuple[float, str]:
    """Least time in ms, and what bounds it: operations over ``peak`` (the
    operation rate of the fastest route the work can take at its
    precision) or bytes over the HBM rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
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
    from repro_torch.kernels import kmedoids as kmk
    from repro_torch.kernels import ref, topk

    rng = np.random.default_rng(0)
    errs = {name: 0.0 for name in KERNELS}

    for form in ref.FORMS:
        errs["pairwise"] = max(errs["pairwise"], parity_pairwise(rng, form))
        errs["rank"] = max(errs["rank"], parity_rank(rng, form))

        for q, n, d, k in KNN_CASES:
            Q = _cuda(rng.normal(size=(q, d)).astype(np.float32))
            DB = _cuda(rng.normal(size=(n, d)).astype(np.float32))
            errs["knn"] = max(errs["knn"], parity_knn(Q, DB, k, form))
        # the streaming route: widths no query tile of the other route
        # holds (l1 and chebyshev keep theirs to d = 1536), k past 1024,
        # and the largest k it admits (its states in device memory), on
        # small DBs
        kmax = topk.knn_max_k()
        for q, n, d, k in KNN_STREAM_CASES + [(3, 12_000, 100, kmax),
                                              (2, kmax + 15, 1536, kmax)]:
            if form not in ref.VPU_FORMS or d > 2000 or k > 1024:
                require(topk.knn_geometry(q, n, d, k, form).route == "stream",
                        f"knn {form} [{q}, {n}, {d}, {k}] does not stream")
            Q = _cuda(rng.normal(size=(q, d)).astype(np.float32))
            DB = _cuda(rng.normal(size=(n, d)).astype(np.float32))
            errs["knn"] = max(errs["knn"], parity_knn(Q, DB, k, form))
        if form not in ref.VPU_FORMS:
            errs["knn"] = max(errs["knn"], parity_knn_near_duplicates(form))
        # duplicated rows: equal distances come back lower id first
        src = rng.integers(0, 40, size=777)
        base = rng.normal(size=(40, 100)).astype(np.float32)
        Q = _cuda(rng.normal(size=(33, 100)).astype(np.float32))
        DB = _cuda(base[src])
        errs["knn"] = max(errs["knn"], parity_knn(Q, DB, 50, form, src))

    errs["scan"] = parity_scan(rng)
    k1 = parity_masked_k1(rng)
    errs["rank"] = max(errs["rank"], k1["rank"])
    errs["scan"] = max(errs["scan"], k1["scan"])

    for G, g, k in SWAP_CASES:
        D = _cuda(np.abs(rng.normal(size=(G, g, g))).astype(np.float32))
        d1 = _cuda(np.abs(rng.normal(size=(G, g))).astype(np.float32))
        d2 = d1 + _cuda(np.abs(rng.normal(size=(G, g))).astype(np.float32))
        n1 = _cuda(rng.integers(0, k, size=(G, g)).astype(np.int32))
        valid = _cuda(rng.random((G, g)) > 0.2)
        if k > 1:  # every row of slot 1 dropped: its T row holds no term
            valid &= n1 != 1
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


def parity_pairwise(rng, form) -> float:
    """The pairwise kernel against its plain version in one form: G = 1, 3
    and a 1024-group build slab whose last group is part padding (zero
    rows, as the build pads it); m and n of 1, 37, 129, 300; d = 1, 3, 13,
    100 and 1536; X the same tensor as Y (the mirrored tiles) and not; a
    repeat call that must be bit-identical; and integer-valued inputs
    (|x| < 2^11, every sum below 2^24), where sqeuclidean must equal the
    plain version bit for bit. Returns the max error."""
    import torch
    from repro_torch.kernels import pairwise as pw, ref

    err = 0.0
    for G, m, n, d, same in PAIRWISE_CASES:
        X = _cuda(rng.normal(size=(G, m, d)).astype(np.float32))
        if G == 1024:
            X[-1, 100:] = 0.0  # the last group: 100 points and padding
        Y = X if same else _cuda(rng.normal(size=(G, n, d)).astype(np.float32))
        out = pw.pairwise_cuda(X, Y, form)
        want = torch.cat([ref.pairwise_ref(X[i:i + 32], Y[i:i + 32], form)
                          for i in range(0, G, 32)])  # slabs bound the l1 cube
        err = max(err, values_agree(out.cpu().numpy(), want.cpu().numpy(),
                                    squared=form == "l2"))
        require(bool(torch.equal(out, pw.pairwise_cuda(X, Y, form))),
                f"pairwise {form} {(G, m, n, d)} differs run to run")
    if form == "sqeuclidean":
        for G, m, n, d, hi, same in PAIRWISE_INT_CASES:
            X = _cuda(rng.integers(-hi + 1, hi, size=(G, m, d)).astype(np.float32))
            Y = X if same else _cuda(
                rng.integers(-hi + 1, hi, size=(G, n, d)).astype(np.float32))
            require(bool(torch.equal(pw.pairwise_cuda(X, Y, form),
                                     ref.pairwise_ref(X, Y, form))),
                    f"pairwise on integers {(G, m, n, d)} is not bit-equal")
    return err


def parity_rank(rng, form) -> float:
    """The rank kernel against its plain version in one form: RANK_CASES,
    then w = 1, 31, 33, 384 and 4096 with k = 1, 10 and w, d = 3, 100 and
    1536; in each an all-masked row, one table row in two slots of a row
    (the lower slot first) and a repeat call that must be bit-identical.
    Returns the max error."""
    import torch
    from repro_torch.kernels import ref, topk

    err = 0.0
    grid = [(w, k) for w in RANK_WIDTHS for k in sorted({1, min(10, w), w})]
    cases = RANK_CASES + [(6, w, RANK_DIMS[i % len(RANK_DIMS)], k, max(2 * w, 50))
                          for i, (w, k) in enumerate(grid)]
    for b, w, d, k, n in cases:
        Q = _cuda(rng.normal(size=(b, d)).astype(np.float32))
        P = _cuda(rng.normal(size=(n, d)).astype(np.float32))
        sq = (P * P).sum(-1)
        idx = _cuda(rng.integers(0, n, size=(b, w)).astype(np.int32))
        ok = _cuda(rng.random((b, w)) > 0.3)
        ok[0] = False  # an all-masked row
        if w > 1:  # row 1: slots 0 and 1 hold one table row
            idx[1, 1] = idx[1, 0]
            ok[1, :2] = True
            idx[1, 2:] = (idx[1, 0] + 1 + torch.arange(w - 2, device="cuda")) % n
        kd, ks = topk.rank_cuda(Q, P, sq, idx, ok, k, form)
        rd, rs = ref.rank_gathered_ref(Q, P, sq, idx, ok, k, form)
        picked = torch.gather(idx, 1, ks.long())
        again = ref.rowwise_ref(Q, P[picked.long()], form, sq[picked.long()])
        require(bool(((ks >= 0) & (ks < w)).all()), "rank slots outside [0, w)")
        err = max(err, topk_agree(kd.cpu(), ks.cpu(), rd.cpu(), rs.cpu(),
                                  again.cpu()))
        kd2, ks2 = topk.rank_cuda(Q, P, sq, idx, ok, k, form)
        require(bool(torch.equal(kd, kd2) and torch.equal(ks, ks2)),
                f"rank {form} w={w} k={k} differs run to run")
        if w > 1:
            row = ks[1].tolist()
            require(1 not in row or (0 in row and row.index(0) < row.index(1)),
                    f"rank {form} w={w} k={k}: slot 1 before its twin slot 0")
    return err


def parity_knn(Q, DB, k, form, src=None) -> float:
    """The knn kernel against its plain version on one case, a repeat call
    that must be bit-identical and, where ``src`` says which DB rows are
    copies of one row (``DB = base[src]``), lower ids first among copies.
    Returns the max error."""
    import torch
    from repro_torch.kernels import ref, topk

    kd, ki = topk.knn_cuda(Q, DB, k, form)
    rd, ri = ref.knn_ref(Q, DB, k, form)
    again = torch.gather(ref.pairwise_ref(Q, DB, form), 1, ki.long())
    err = topk_agree(kd.cpu(), ki.cpu(), rd.cpu(), ri.cpu(), again.cpu())
    kd2, ki2 = topk.knn_cuda(Q, DB, k, form)
    require(bool(torch.equal(kd, kd2) and torch.equal(ki, ki2)),
            f"knn {form} {tuple(Q.shape)} x {tuple(DB.shape)} k={k} differs "
            f"run to run")
    if src is not None:
        ids = ki.cpu().numpy()
        for b in range(ids.shape[0]):
            got = set(ids[b].tolist())
            for i in ids[b]:
                lower = np.nonzero(src[:i] == src[i])[0]
                require(got.issuperset(lower.tolist()),
                        f"knn {form}: id {i} returned, a lower copy not")
    return err


def parity_knn_near_duplicates(form) -> float:
    """knn's wgmma route at the largest d it admits at k = 10 (~1,224),
    where it accumulates longest: a DB whose first 1,500 rows are copies of
    the 37 queries plus noise of 1e-3 |x|, so every top-k lies near zero.
    There fp32's Gram form cancels terms of size |x|^2, so the values are
    held (l2 squared) to the atol of the whole plain distance matrix, the
    scale pairwise's rule takes; a copy of each query comes first. Returns
    the max error."""
    import torch
    from repro_torch.kernels import ref, topk

    q, n, k = 37, 3000, 10
    d = max(d for d in range(1000, 1400)
            if topk.knn_geometry(q, n, d, k, form).route == "wgmma")
    require(d > 1200, f"the wgmma route stops at d = {d}")
    rng = np.random.default_rng(7)
    Q = rng.normal(size=(q, d)).astype(np.float32)
    DB = rng.normal(size=(n, d)).astype(np.float32)
    u = rng.normal(size=(n // 2, d))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    src = Q[np.arange(n // 2) % q]
    DB[:n // 2] = src + 1e-3 * np.linalg.norm(src, axis=1, keepdims=True) * u
    Q, DB = _cuda(Q), _cuda(DB)
    full = ref.pairwise_ref(Q, DB, form).cpu().numpy()
    squared = form == "l2"
    atol = atol_of(full * full if squared else full)
    kd, ki = topk.knn_cuda(Q, DB, k, form)
    rd, ri = ref.knn_ref(Q, DB, k, form)
    again = torch.gather(ref.pairwise_ref(Q, DB, form), 1, ki.long())
    err = topk_agree(kd.cpu(), ki.cpu(), rd.cpu(), ri.cpu(), again.cpu(),
                     squared=squared, atol=atol)
    first = ki[:, 0].cpu().numpy()
    if form != "dot":  # dot ranks by -x.y, not by nearness
        require(bool((first < n // 2).all() and (first % q == np.arange(q)).all()),
                f"knn {form} near duplicates at d={d}: a copy is not first")
    kd2, ki2 = topk.knn_cuda(Q, DB, k, form)
    require(bool(torch.equal(kd, kd2) and torch.equal(ki, ki2)),
            f"knn {form} near duplicates at d={d} differ run to run")
    log(f"[parity] knn {form} near duplicates at d={d} (wgmma route): max "
        f"err {err:.3g} (atol {atol:.3g})")
    return err


def scan_rows(Q, codes, scales, block, idx, form, fmt):
    """The plain distance of every candidate ``idx [b, w]`` of a code
    table (what the scan kernel scores), for re-checking its picks."""
    from repro_torch.kernels import ref

    return ref.rowwise_ref(
        Q, ref.dequantize_rows(codes, scales, block, idx, fmt, Q.shape[1]),
        form)


def parity_scan(rng) -> float:
    """The scan kernel against its plain version: every form x code format
    over SCAN_CASES (ragged shapes, a slot_valid mask, k = w, w = 1), then
    d = 3, 13, 100 and 101 at the path's width w = 384 (~30% unmasked, as
    on the path) with k = 1, 10, 128 and w; in each an all-masked row, a
    row with 3 unmasked slots (fewer than k), one table row in two slots of
    a row (the lower slot first), and a repeat call that must be
    bit-identical. Returns the max error."""
    import torch
    from repro_torch.kernels import quantized, ref
    from repro_torch.store import quantize

    err = 0.0
    grid = [(6, SCAN_WIDTH, d, k, 2000, 256) for d in SCAN_DIMS
            for k in (1, 10, 128, SCAN_WIDTH)]
    for backend, fmt in SCAN_FORMATS.items():
        for b, w, d, k, n, block in SCAN_CASES + grid:
            codes, scales = quantize(
                _cuda(rng.normal(size=(n, d)).astype(np.float32)), backend,
                block)
            Q = _cuda(rng.normal(size=(b, d)).astype(np.float32))
            idx = _cuda(rng.integers(0, n, size=(b, w)).astype(np.int32))
            ok = _cuda(rng.random((b, w)) > (0.7 if w == SCAN_WIDTH else 0.3))
            ok[0] = False  # an all-masked row
            if d == 13 and w != SCAN_WIDTH:  # tombstoned table rows, folded as ops does
                live = _cuda(rng.random(n) > 0.3)
                ok = ref.fold_slot_valid(idx, ok, live)
            if w == SCAN_WIDTH:
                ok[1] = False  # row 1: three unmasked, slots 0 and 1 one row
                ok[1, [0, 1, 200]] = True
                idx[1, 1] = idx[1, 0]
            for form in ref.FORMS:
                kd, ks = quantized.scan_cuda(Q, codes, scales, block, idx,
                                             ok, k, form, fmt)
                rd, rs = ref.scan_gathered_ref(Q, codes, scales, block, idx,
                                               ok, k, form, fmt)
                again = torch.gather(
                    scan_rows(Q, codes, scales, block, idx, form, fmt), 1,
                    ks.long())
                require(bool(((ks >= 0) & (ks < w)).all()),
                        "scan slots outside [0, w)")
                err = max(err, topk_agree(kd.cpu(), ks.cpu(), rd.cpu(),
                                          rs.cpu(), again.cpu()))
                kd2, ks2 = quantized.scan_cuda(Q, codes, scales, block, idx,
                                               ok, k, form, fmt)
                require(bool(torch.equal(kd, kd2) and torch.equal(ks, ks2)),
                        f"scan {form}/{backend} d={d} k={k} differs run to run")
                if w == SCAN_WIDTH:
                    row = ks[1].tolist()
                    require(1 not in row or (0 in row and row.index(0) < row.index(1)),
                            f"scan {form}/{backend} d={d} k={k}: slot 1 before "
                            f"its twin slot 0")
    return err


def parity_masked_k1(rng) -> dict:
    """rank and scan at k = 1 (the online tiers' routing) through the ops
    with a ``slot_valid`` mask that kills every slot of query 0 and a
    fifth of the table, at the path's width w = 384, d = 100, every form:
    query 0 finds nothing (``BIG``), the rest agree with the plain
    versions on the folded mask, and repeat calls are bit-identical.
    Returns the max error per kernel."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.store import quantize

    b, w, d, n = 64, SCAN_WIDTH, 100, 5000
    P = _cuda(rng.normal(size=(n, d)).astype(np.float32))
    sq = (P * P).sum(-1)
    Q = _cuda(rng.normal(size=(b, d)).astype(np.float32))
    idx = _cuda(rng.integers(0, n, size=(b, w)).astype(np.int32))
    ok = _cuda(rng.random((b, w)) > 0.3)
    live = _cuda(rng.random(n) > 0.2)
    live[idx[0].long()] = False  # every slot of query 0 is dead
    folded = ref.fold_slot_valid(idx, ok, live)
    codes, scales = quantize(P, "int8", STORE_BLOCK)
    errs = {"rank": 0.0, "scan": 0.0}
    for form in ref.FORMS:
        runs = {
            "rank": (lambda: ops.rank_gathered(Q, P, sq, idx, ok, form, k=1,
                                               slot_valid=live),
                     ref.rank_gathered_ref(Q, P, sq, idx, folded, 1, form),
                     lambda s: ref.rowwise_ref(Q, P[s], form, sq[s])),
            "scan": (lambda: ops.scan_quantized(
                Q, codes, scales, idx, ok, form, k=1, block=STORE_BLOCK,
                slot_valid=live),
                ref.scan_gathered_ref(Q, codes, scales, STORE_BLOCK, idx,
                                      folded, 1, form),
                None)}
        for name, (kernel, (rd, rs), again_of) in runs.items():
            kd, ks = kernel()
            require(float(kd[0, 0]) >= BIG / 2,
                    f"{name} {form} k=1: a dead query found slot "
                    f"{int(ks[0, 0])}")
            if again_of is None:
                again = torch.gather(scan_rows(Q, codes, scales, STORE_BLOCK,
                                               idx, form, "dense"), 1,
                                     ks.long())
            else:
                again = again_of(torch.gather(idx, 1, ks.long()).long())
            errs[name] = max(errs[name], topk_agree(
                kd.cpu(), ks.cpu(), rd.cpu(), rs.cpu(), again.cpu()))
            kd2, ks2 = kernel()
            require(bool(torch.equal(kd, kd2) and torch.equal(ks, ks2)),
                    f"{name} {form} k=1 with slot_valid differs run to run")
    log(f"[parity] rank and scan at k=1, slot_valid killing query 0: "
        f"{json.dumps(errs)}")
    return errs


def level_sums(idx) -> list:
    """fp64 sums, on the index's own device, of each clustered level's
    per-point distances to its medoid (its parent): the level TDs of a
    k-medoids build, summed without fp32's order dependence."""
    sums = []
    for l in range(idx.n_levels - 1):
        lv, up = idx.data.levels[l], idx.data.levels[l + 1]
        par = lv.parent.long().clamp(0, up.points.shape[0] - 1)
        dd = idx.distance.point(lv.points, up.points[par])
        sums.append(float(dd[lv.valid].double().sum()))
    return sums


def phase_build_parity(data: np.ndarray) -> dict:
    """The card's build against the port's CPU build. Integer-valued
    dense_embed-shaped data (the first 20,000 rows scaled to integers in
    [0, 64): every Gram sum is exact in fp32, so both devices compute the
    same distances), gl = 256, euclidean, pam, no shuffle: the level sizes
    and every level's arrays (the medoids' slots, parents and children)
    must be equal, and each level's fp64 sum of its per-point distances to
    their medoids, taken on each build's device, within rtol 1e-6 (the
    builds' fp32 level TDs sum 20,000 terms in another order each, and are
    printed only). Then a real-valued 50,000-row slice of
    the main data: level-0 TD within 1% (rounding-level near-ties in
    k-medoids may go the other way). Also ``core.build_index`` called
    without a device must build on CUDA."""
    import torch
    from repro_torch.core.index import PDASCIndex

    x = data[:20_000]
    lo, hi = float(x.min()), float(x.max())
    xi = np.clip(np.round((x - lo) / (hi - lo) * 63), 0, 63).astype(np.float32)
    kw = dict(gl=256, distance="euclidean", method="pam", shuffle=False)
    t0 = time.perf_counter()
    card = PDASCIndex.build(xi, device="cuda", **kw)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = PDASCIndex.build(xi, device="cpu", **kw)
    cpu_s = time.perf_counter() - t0
    require(card.stats.level_sizes == cpu.stats.level_sizes,
            f"integer build: level sizes {card.stats.level_sizes} on the card, "
            f"{cpu.stats.level_sizes} on the CPU")
    for l, (a, b) in enumerate(zip(card.data.levels, cpu.data.levels)):
        for f in a._fields:
            require(bool(torch.equal(getattr(a, f).cpu(), getattr(b, f))),
                    f"integer build: level {l} {f} differs card vs CPU")
    require(bool(torch.equal(card.data.leaf_ids.cpu(), cpu.data.leaf_ids)),
            "integer build: leaf ids differ card vs CPU")
    card_sums, cpu_sums = level_sums(card), level_sums(cpu)
    np.testing.assert_allclose(card_sums, cpu_sums, rtol=1e-6)
    log(f"[build-parity] integer dense_embed n={len(xi)} gl=256 euclidean "
        f"pam: card == CPU level by level, levels {card.stats.level_sizes}, "
        f"fp64 level sums card {card_sums}, CPU {cpu_sums}; fp32 TDs card "
        f"{list(card.stats.level_td)}, CPU {list(cpu.stats.level_td)} (card "
        f"{card_s:.2f} s, CPU {cpu_s:.2f} s)")

    # the build's core entry point without a device runs on the card
    from repro_torch.core import build_index

    index, _ = build_index(xi[:2000], gl=256, distance="euclidean")
    require(all(lv.points.is_cuda for lv in index.levels),
            "core.build_index without a device did not build on CUDA")
    log(f"[build-parity] core.build_index without a device: built on "
        f"{index.levels[0].points.device}")

    real = data[:50_000]
    kw = dict(gl=256, distance="euclidean", method="pam", radius_quantile=0.35)
    card = PDASCIndex.build(real, device="cuda", **kw)
    cpu = PDASCIndex.build(real, device="cpu", **kw)
    td_card, td_cpu = card.stats.level_td[0], cpu.stats.level_td[0]
    rel = abs(td_card - td_cpu) / td_cpu
    log(f"[build-parity] real-valued n={len(real)}: level-0 TD card "
        f"{td_card:.6f}, CPU {td_cpu:.6f} (rel {rel:.3g}, limit 0.01)")
    require(rel <= 0.01, f"level-0 TD differs by {rel:.3g} card vs CPU")
    return dict(int_card_s=card_s, int_cpu_s=cpu_s, real_td_rel=rel)


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
    PHASE_LAUNCHES["main"] = counts
    log(f"[main] kernel launches on the main path: {json.dumps(counts)}")
    for name in BEAM_PATH_KERNELS:
        require(counts[name] > 0,
                f"kernel {name} never launched on the main path")
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
                search_s=search_s, recall=rec, Qc=Qc, gt=gt.cpu().numpy())


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
        return dict(wall_ms=wall_ms, busy_ms=None, kernels={})
    # the port's kernels by their symbols: device ms and launches in the call
    kernels = {}
    for sym in KERNEL_SYMBOLS:
        hits = [e for e in events if sym in e.key]
        kernels[sym] = (sum(_device_us(e) for e in hits) / 1e3,
                        sum(e.count for e in hits))
    top = sorted(events, key=_device_us, reverse=True)[:6]
    log(f"[profile] {label}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of wall, idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f}%)")
    for e in top:
        log(f"[profile]   {_device_us(e) / 1e3:9.3f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    log(f"[profile]   the port's kernels (ms, launches): {json.dumps(kernels)}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, kernels=kernels)


def phase_cpu_check(main: dict) -> None:
    """The card's search against the port's CPU search on the same index."""
    from repro_torch.core.index import PDASCIndex
    from repro_torch.query import Query

    cpu = PDASCIndex.from_arrays(*main["idx"].to_arrays(), device="cpu")
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
    """Device busy share and top ops of one search call and one build; the
    search's profile is kept in ``main`` (its rank launches' sum)."""
    from repro_torch.core.index import PDASCIndex
    from repro_torch.query import Query

    plan = main["idx"].plan(Query(k=10))
    main["search_profile"] = profile_breakdown(
        f"search {N_QUERIES} queries, beam 32", lambda: plan(main["Qc"]))
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

    def row(name, shape, ms, plain_ms, lib_ms, flops, nbytes, err,
            peak=PEAK_FP32):
        b_ms, b_by = bound(flops, nbytes, peak)
        src, rep = KERNELS[name]
        rows.append(dict(name=name, route="cuda", source=src, replaces=rep,
                         symbols=SYMBOLS[name],
                         launches=main["counts"][name], max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, shape=shape))
        log(f"[time] {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), max abs err {err:.3g}")

    # pairwise: one build slab of level 0 (group_chunk groups of 256, d=100);
    # X is Y, as in the build
    G, g, d = GROUP_CHUNK, 256, data.shape[1]
    X = _cuda(data[:G * g].reshape(G, g, d))
    out = pw.pairwise_cuda(X, X, "l2")
    want = ref.pairwise_ref(X, X, "l2")
    err = values_agree(out.cpu().numpy(), want.cpu().numpy(), squared=True)
    row("pairwise", [G, g, g, d],
        kernel_ms(lambda: pw.pairwise_cuda(X, X, "l2")),
        time_ms(lambda: ref.pairwise_ref(X, X, "l2")),
        time_ms(lambda: torch.cdist(X, X)),
        2.0 * G * g * g * d, 4.0 * (G * g * d + G * g * g), err, PEAK_GRAM)

    # pairwise in l1 at the same shape: the CUDA-core route (one subtract
    # and one add an element); the plain version in slabs of 32 groups
    def plain_l1():
        return torch.cat([ref.pairwise_ref(X[i:i + 32], X[i:i + 32], "l1")
                          for i in range(0, G, 32)])

    err = values_agree(pw.pairwise_cuda(X, X, "l1").cpu().numpy(),
                       plain_l1().cpu().numpy())
    b_ms, b_by = bound(2.0 * G * g * g * d, 4.0 * (G * g * d + G * g * g))
    l1 = dict(ms=kernel_ms(lambda: pw.pairwise_cuda(X, X, "l1")),
              plain_ms=time_ms(plain_l1, iters=2, warmup=1),
              library_ms=time_ms(lambda: torch.cdist(X, X, p=1), iters=3),
              bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    rows[-1]["l1"] = l1
    log(f"[time] pairwise l1 [{G}, {g}, {g}, {d}]: kernel {l1['ms']:.4f} ms, "
        f"plain {l1['plain_ms']:.4f} ms, library {l1['library_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), max abs err {err:.3g}")

    # swap_deltas: the first sweep of that slab (pruned BUILD medoids)
    k = g // 2
    valid = torch.ones((G, g), dtype=torch.bool, device="cuda")
    medoids = km.build_grouped_pruned(out, k, valid)
    d1, n1, d2 = km._nearest_caches(out, medoids, valid)
    sw = kmk.swap_deltas_cuda(out, d1, d2, n1, valid, k)
    err = values_agree(sw.cpu().numpy(),
                       ref.swap_deltas_ref(out, d1, d2, n1, valid, k).cpu().numpy())
    row("swap_deltas", [G, g, k],
        kernel_ms(lambda: kmk.swap_deltas_cuda(out, d1, d2, n1, valid, k)),
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

    def library_rank():  # gather, cdist, mask, top-k: PyTorch calls
        C = leaf.points[cand_idx.long()]
        D = torch.cdist(Qc[:, None], C).squeeze(1).masked_fill(~cand_ok, BIG)
        return torch.topk(D, 10, largest=False)

    row("rank", [b, w, d, 10],
        kernel_ms(lambda: topk.rank_cuda(Qc, leaf.points, leaf.sq_norm, cand_idx,
                                         cand_ok, 10, "l2")),
        time_ms(lambda: ref.rank_gathered_ref(Qc, leaf.points, leaf.sq_norm,
                                              cand_idx, cand_ok, 10, "l2")),
        time_ms(library_rank), 2.0 * n_ok * d,
        4.0 * b * d + n_ok * (4.0 * d + 4) + 5.0 * b * w + 8.0 * b * 10, err)
    rows[-1]["event_ms"] = time_ms(lambda: topk.rank_cuda(
        Qc, leaf.points, leaf.sq_norm, cand_idx, cand_ok, 10, "l2"))
    # what one beam search pays: its rank launches, from the profile
    prof = main.get("search_profile", {}).get("kernels", {})
    ms, count = prof.get("rank_kernel", (None, 0))
    rows[-1].update(per_search_ms=ms, per_search_launches=count)
    log(f"[time] rank by CUDA events around back-to-back calls (host gaps "
        f"included): {rows[-1]['event_ms']:.4f} ms")
    log(f"[time] rank over one beam search: {count} launches, "
        f"{'not measured' if ms is None else f'{ms:.4f} ms'} (profile)")

    # knn: exact_knn's call, 1000 queries against the whole dataset
    DB = _cuda(data)
    kd, ki = topk.knn_cuda(Qc, DB, 10, "l2")
    rd, ri = ref.knn_ref(Qc, DB, 10, "l2")
    again = ref.rowwise_ref(Qc, DB[ki.long()], "l2")
    err = topk_agree(kd.cpu(), ki.cpu(), rd.cpu(), ri.cpu(), again.cpu())
    del rd, ri
    nq, n = Qc.shape[0], DB.shape[0]
    flops, nbytes = 2.0 * nq * n * d, 4.0 * (nq * d + n * d) + 8.0 * nq * 10
    row("knn", [nq, n, d, 10],
        kernel_ms(lambda: topk.knn_cuda(Qc, DB, 10, "l2"), iters=5),
        time_ms(lambda: ref.knn_ref(Qc, DB, 10, "l2"), iters=2, warmup=1),
        time_ms(lambda: torch.topk(torch.cdist(Qc, DB), 10, largest=False),
                iters=2, warmup=1),
        flops, nbytes, err, PEAK_GRAM)

    # knn in l1 at the same shape: the VPU route (no product, fp32 cores;
    # one subtract and one add an element)
    def plain_l1():
        return ref.topk_smallest(ref.pairwise_ref_chunked(Qc, DB, "l1", 1024),
                                 10)

    kd, ki = topk.knn_cuda(Qc, DB, 10, "l1")
    rd, ri = plain_l1()
    again = ref.rowwise_ref(Qc, DB[ki.long()], "l1")
    err = topk_agree(kd.cpu(), ki.cpu(), rd.cpu(), ri.cpu(), again.cpu())
    del rd, ri
    b_ms, b_by = bound(flops, nbytes)
    l1 = dict(ms=kernel_ms(lambda: topk.knn_cuda(Qc, DB, 10, "l1"), iters=3),
              plain_ms=time_ms(plain_l1, iters=1, warmup=0),
              library_ms=time_ms(lambda: torch.topk(
                  torch.cdist(Qc, DB, p=1), 10, largest=False),
                  iters=1, warmup=1),
              bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    rows[-1]["l1"] = l1
    log(f"[time] knn l1 [{nq}, {n}, {d}, 10]: kernel {l1['ms']:.4f} ms, "
        f"plain {l1['plain_ms']:.4f} ms, library {l1['library_ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), max abs err {err:.3g}")
    del DB, kd, ki, again

    # knn's streaming route: a 1536-d table (a text-embedding width) that
    # no wgmma query tile holds; normal data from a seed, made on the card
    gen = torch.Generator(device="cuda").manual_seed(1)
    nq, n, d = KNN_STREAM_SHAPE
    Q2 = torch.randn((nq, d), device="cuda", generator=gen)
    DB2 = torch.randn((n, d), device="cuda", generator=gen)
    require(topk.knn_geometry(nq, n, d, 10, "l2").route == "stream",
            "the 1536-d knn does not take the streaming route")
    kd, ki = topk.knn_cuda(Q2, DB2, 10, "l2")
    rd, ri = ref.knn_ref(Q2, DB2, 10, "l2")
    err = topk_agree(kd.cpu(), ki.cpu(), rd.cpu(), ri.cpu(),
                     ref.rowwise_ref(Q2, DB2[ki.long()], "l2").cpu())
    b_ms, b_by = bound(2.0 * nq * n * d, 4.0 * (nq * d + n * d) + 8.0 * nq * 10,
                       PEAK_GRAM)
    stream = dict(shape=[nq, n, d, 10],
                  ms=kernel_ms(lambda: topk.knn_cuda(Q2, DB2, 10, "l2"), iters=2,
                               replays=2),
                  plain_ms=time_ms(lambda: ref.knn_ref(Q2, DB2, 10, "l2"),
                                   iters=2, warmup=1),
                  library_ms=time_ms(lambda: torch.topk(
                      torch.cdist(Q2, DB2), 10, largest=False), iters=2,
                      warmup=1),
                  bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    rows[-1]["stream"] = stream
    log(f"[time] knn stream {stream['shape']} l2: kernel {stream['ms']:.4f} "
        f"ms, plain {stream['plain_ms']:.4f} ms, library "
        f"{stream['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), max "
        f"abs err {err:.3g}")
    del Q2, DB2, kd, ki, rd, ri

    # the streaming route in l1 at a wider table: fp32 micro-tiles on the
    # CUDA cores (one subtract and one add an element); the plain version
    # in [512, 512, d] slabs and cdist(p=1) are slow here, one call each
    nq, n, d = KNN_STREAM_L1_SHAPE
    Q3 = torch.randn((nq, d), device="cuda", generator=gen)
    DB3 = torch.randn((n, d), device="cuda", generator=gen)
    require(topk.knn_geometry(nq, n, d, 10, "l1").route == "stream",
            "the 3072-d l1 knn does not take the streaming route")

    def plain_l1_stream():
        return ref.topk_smallest(ref.pairwise_ref_chunked(Q3, DB3, "l1", 512), 10)

    kd, ki = topk.knn_cuda(Q3, DB3, 10, "l1")
    t0 = time.perf_counter()
    rd, ri = plain_l1_stream()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = topk_agree(kd.cpu(), ki.cpu(), rd.cpu(), ri.cpu(),
                     ref.rowwise_ref(Q3, DB3[ki.long()], "l1").cpu())
    b_ms, b_by = bound(2.0 * nq * n * d, 4.0 * (nq * d + n * d) + 8.0 * nq * 10)
    stream_l1 = dict(shape=[nq, n, d, 10],
                     ms=kernel_ms(lambda: topk.knn_cuda(Q3, DB3, 10, "l1"), iters=2,
                                  replays=1),
                     plain_ms=plain_ms,
                     library_ms=time_ms(lambda: torch.topk(
                         torch.cdist(Q3, DB3, p=1), 10, largest=False), iters=1,
                         warmup=0),
                     bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
    rows[-1]["stream_l1"] = stream_l1
    log(f"[time] knn stream {stream_l1['shape']} l1: kernel "
        f"{stream_l1['ms']:.4f} ms, plain {plain_ms:.4f} ms (one call), library "
        f"{stream_l1['library_ms']:.4f} ms (one call), bound {b_ms:.4f} ms "
        f"({b_by}), max abs err {err:.3g}")
    return rows


def phase_store(main: dict, workdir: str) -> dict:
    """The storage path on the main path's 1M index: int8 store, release,
    the default plan (two_stage), its checks and the other code formats.
    Must run after every phase that reads the dense leaf payload."""
    import torch
    from repro_torch.core.msa import PDASCIndexData, PDASCLevel
    from repro_torch.kernels import ops
    from repro_torch.query import Query
    from repro_torch.store import LeafStore, search_two_stage

    idx, Qc, gt = main["idx"], main["Qc"], main["gt"]
    leaf = idx.data.levels[0]
    n0 = leaf.points.shape[0]

    # fp16, int4 and binary on the same leaf points, dense payload kept
    others = {}
    for backend in ("fp16", "int4", "binary"):
        st = LeafStore.create(leaf.points, backend, block=STORE_BLOCK)
        res = search_two_stage(
            idx.data, st, Qc, dist=idx.distance, k=10, r=idx.default_radius,
            beam=32, max_children=idx.max_children)
        torch.cuda.synchronize()
        rec = recall(res.ids.cpu().numpy(), gt)
        bpv = st.resident_bytes / n0
        log(f"[store] {backend}: recall@10 {rec:.4f}, payload "
            f"{bpv:.3f} bytes/vector (dense fp32 400)")
        others[backend] = dict(recall=rec, bytes_per_vector=bpv,
                               codes=st.codes, scales=st.scales)
        del st, res

    t0 = time.perf_counter()
    idx.attach_store("int8", block=STORE_BLOCK,
                     path=os.path.join(workdir, "payload.f32"))
    idx.release_dense_payload()
    torch.cuda.synchronize()
    log(f"[store] attach_store('int8', block={STORE_BLOCK}, memmap) + "
        f"release_dense_payload: {time.perf_counter() - t0:.3f} s")
    plan = idx.plan(Query(k=10))
    log(f"[store] plan: {plan.explain()}")
    require(plan.pipeline == "two_stage" and "scan_quantized" in plan.explain(),
            "the default plan of a released index is not two_stage")

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = plan(Qc)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res2 = plan(Qc)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    counts = PHASE_LAUNCHES["store"] = ops.launch_counts()
    require(torch.equal(res.ids, res2.ids), "two-stage is not repeatable")
    log(f"[store] kernel launches on the two-stage path (2 calls): "
        f"{json.dumps(counts)}")
    for name in STORE_PATH_KERNELS:
        require(counts[name] > 0, f"kernel {name} never launched on the "
                f"two-stage path")

    rec = recall(res.ids.cpu().numpy(), gt)
    mem = idx.memory_bytes()
    cache = idx.store.exact.cache.stats
    log(f"[store] {len(Qc)} queries, two_stage int8, beam 32, R="
        f"{RERANK_WIDTH}: first call {first_s:.4f} s "
        f"({len(Qc) / first_s:.1f} queries/s), second {second_s:.4f} s "
        f"({len(Qc) / second_s:.1f} queries/s)")
    log(f"[store] recall@10 {rec:.4f} (beam on the same index "
        f"{main['recall']:.4f}); payload {mem['payload_bytes_per_vector']} "
        f"bytes/vector (dense fp32 400); memory_bytes {json.dumps(mem)}")
    log(f"[store] granule cache: {json.dumps(cache)}")
    require(rec >= main["recall"] - 0.01,
            f"two-stage recall {rec:.4f} < beam {main['recall']:.4f} - 0.01")

    inf = idx.plan(Query(k=10, rerank_width=None))(Qc)
    for a, b in zip(inf, main["res"]):
        require(torch.equal(a, b), "∞ rerank width differs from beam")
    log("[store] rerank_width=None (∞) == the beam result, bit for bit")

    cpu_data = PDASCIndexData(
        levels=tuple(PDASCLevel(*(t.cpu() for t in lv))
                     for lv in idx.data.levels),
        leaf_ids=idx.data.leaf_ids.cpu())
    cpu_store = dataclasses.replace(idx.store, codes=idx.store.codes.cpu(),
                                    scales=idx.store.scales.cpu())
    cpu = dataclasses.replace(idx, data=cpu_data, store=cpu_store,
                              device=torch.device("cpu"), _plan_cache=None)
    t0 = time.perf_counter()
    want = cpu.plan(Query(k=10))(Qc[:N_CPU_CHECK].cpu())
    gd = res.dists[:N_CPU_CHECK].cpu().numpy()
    topk_agree(gd, res.ids[:N_CPU_CHECK].cpu().numpy(), want.dists.numpy(),
               want.ids.numpy(), gd)
    log(f"[store] card two-stage == CPU two-stage on {N_CPU_CHECK} queries "
        f"(CPU took {time.perf_counter() - t0:.1f} s)")

    prof = profile_breakdown(f"two-stage {len(Qc)} queries, int8, R="
                             f"{RERANK_WIDTH}", lambda: plan(Qc))
    if idx.store.exact._pool is not None:
        idx.store.exact._pool.close()
    return dict(counts=counts, recall=rec, first_s=first_s,
                second_s=second_s, mem=mem, cache=dict(cache), others=others,
                profile=prof)


def phase_scan_timing(main: dict, store: dict) -> dict:
    """The scan kernel at the storage path's shapes (its own candidate
    table, k = R = 128) in each code format: kernel, plain version and
    bound. Returns the kernels-line row (int8, the path's format, with
    every format under ``formats``)."""
    import torch
    from repro_torch.core import nsa
    from repro_torch.kernels import quantized, ref

    idx, Qc = main["idx"], main["Qc"]
    cand_idx, cand_ok = nsa.descend_beam(
        idx.data, Qc, dist=idx.distance, r=idx.default_radius, beam=32,
        max_children=idx.max_children)
    b, w = cand_idx.shape
    d = Qc.shape[1]
    n_ok = int(cand_ok.sum())
    tables = {"int8": (idx.store.codes, idx.store.scales)}
    tables.update({k: (v["codes"], v["scales"])
                   for k, v in store["others"].items()})
    formats = {}
    for backend, (codes, scales) in tables.items():
        fmt = SCAN_FORMATS[backend]

        def kernel():
            return quantized.scan_cuda(Qc, codes, scales, STORE_BLOCK,
                                       cand_idx, cand_ok, RERANK_WIDTH,
                                       "l2", fmt)

        def plain():
            return ref.scan_gathered_ref(Qc, codes, scales, STORE_BLOCK,
                                         cand_idx, cand_ok, RERANK_WIDTH,
                                         "l2", fmt)

        def library():  # dequantised gathered rows, cdist, mask, top-k
            C = ref.dequantize_rows(codes, scales, STORE_BLOCK, cand_idx, fmt, d)
            D = torch.cdist(Qc[:, None], C).squeeze(1).masked_fill(~cand_ok, BIG)
            return torch.topk(D, RERANK_WIDTH, largest=False)

        kd, ks = kernel()
        rd, rs = plain()
        again = torch.gather(scan_rows(Qc, codes, scales, STORE_BLOCK,
                                       cand_idx, "l2", fmt), 1, ks.long())
        err = topk_agree(kd.cpu(), ks.cpu(), rd.cpu(), rs.cpu(), again.cpu())
        row_bytes = codes.shape[1] * codes.element_size()
        nbytes = (n_ok * row_bytes + 5.0 * b * w + 4.0 * b * d
                  + 8.0 * b * RERANK_WIDTH)
        b_ms, b_by = bound(5.0 * n_ok * d, nbytes)
        formats[backend] = dict(
            ms=kernel_ms(kernel), event_ms=time_ms(kernel), plain_ms=time_ms(plain),
            library_ms=time_ms(library), bound_ms=b_ms, bound_by=b_by,
            max_abs_err=err, bytes_per_row=row_bytes)
        f = formats[backend]
        log(f"[time] scan {backend} [{b}, {w}, d={d}, k={RERANK_WIDTH}] "
            f"({n_ok} unmasked): kernel {f['ms']:.4f} ms (events "
            f"{f['event_ms']:.4f}), plain "
            f"{f['plain_ms']:.4f} ms, library {f['library_ms']:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), max abs err {err:.3g}")
    src, rep = KERNELS["scan"]
    main8 = formats["int8"]
    return dict(name="scan", route="cuda", source=src, replaces=rep,
                symbols=SYMBOLS["scan"], launches=store["counts"]["scan"],
                max_abs_err=max(f["max_abs_err"] for f in formats.values()),
                ms=main8["ms"], plain_ms=main8["plain_ms"],
                bound_ms=main8["bound_ms"], bound_by=main8["bound_by"],
                library_ms=main8["library_ms"], shape=[b, w, d, RERANK_WIDTH],
                formats=formats)


def launched(phase: str, names=None) -> dict:
    """Read the launch counts after ``phase`` (zeroed just before it),
    keep them for the kernels line, and fail for a kernel of the phase's
    path (``names``, by default its ``WINDOW_KERNELS`` entry) that never
    launched."""
    from repro_torch.kernels import ops

    names = WINDOW_KERNELS[phase] if names is None else names
    counts = ops.launch_counts()
    PHASE_LAUNCHES[phase] = counts
    log(f"[{phase}] kernel launches: {json.dumps(counts)}")
    for name in names:
        require(counts[name] > 0, f"kernel {name} never launched in {phase}")
    return counts


def start_phase() -> None:
    import torch
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()


def sync_s(t0: float) -> float:
    import torch

    torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_kmeans(data: np.ndarray, test: np.ndarray, main: dict) -> dict:
    """The k-means build at the main path's size and its two users beside
    it: ``method="kmeans"`` at n = 1M, gl = 256 (invariants, level TDs of
    0, recall@10 of beam 32 beside the pam build's); a pam build at
    gl = 2048 on a 200,000-row slice (swap_deltas past g = 1,456, the
    split slots); and IVF-Flat at 1M with bench_recall.py's n_cells =
    n // 256 and n_probe = 8."""
    from repro_torch.baselines import IVFFlatIndex, exact_knn
    from repro_torch.core.index import PDASCIndex
    from repro_torch.core.reference_impl import check_index_invariants
    from repro_torch.query import Query

    Qc = main["Qc"]
    start_phase()
    t0 = time.perf_counter()
    idx = PDASCIndex.build(data, gl=256, distance="euclidean", method="kmeans",
                           radius_quantile=0.35, group_chunk=GROUP_CHUNK,
                           device="cuda")
    build_s = sync_s(t0)
    launched("kmeans-build")
    errs = check_index_invariants(idx.data)
    require(errs == [], f"k-means build: {errs[:5]}")
    require(all(t == 0.0 for t in idx.stats.level_td),
            f"k-means level TDs {idx.stats.level_td} are not all 0")
    start_phase()
    _, gt = exact_knn(Qc, data, k=10, device="cuda")
    gt = gt.cpu().numpy()
    launched("kmeans-truth")
    start_phase()
    res = idx.plan(Query(k=10))(Qc)
    rec = recall(res.ids.cpu().numpy(), gt)
    launched("kmeans-search")
    log(f"[kmeans] dense_embed n={len(data)} gl=256 euclidean kmeans: build "
        f"{build_s:.3f} s, levels {idx.stats.level_sizes}, invariants hold, "
        f"level TDs all 0; recall@10 beam 32 {rec:.4f} (pam build "
        f"{main['recall']:.4f})")
    del idx, res
    profile_breakdown(
        f"k-means build n={N_BIG_GL}",
        lambda: PDASCIndex.build(data[:N_BIG_GL], gl=256, method="kmeans",
                                 group_chunk=GROUP_CHUNK, device="cuda"))

    big = data[:N_BIG_GL]
    start_phase()
    t0 = time.perf_counter()
    idx = PDASCIndex.build(big, gl=2048, distance="euclidean", method="pam",
                           radius_quantile=0.35, group_chunk=64,
                           device="cuda")
    big_s = sync_s(t0)
    launched("pam-gl2048")
    errs = check_index_invariants(idx.data)
    require(errs == [], f"gl=2048 build: {errs[:5]}")
    log(f"[kmeans] pam gl=2048 (k=1024) on n={len(big)}: build {big_s:.3f} "
        f"s, levels {idx.stats.level_sizes}, invariants hold")
    del idx

    n_cells = len(data) // 256
    start_phase()
    t0 = time.perf_counter()
    ivf = IVFFlatIndex.build(data, n_cells=n_cells, device="cuda")
    ivf_build_s = sync_s(t0)
    t0 = time.perf_counter()
    _, ivf_ids = ivf.search(test, k=10, n_probe=IVF_PROBE)
    ivf_query_s = sync_s(t0)
    launched("ivf")
    ivf_rec = recall(ivf_ids, gt)
    require(np.isfinite(ivf_rec) and ivf_rec > 0, "IVF-Flat found nothing")
    log(f"[kmeans] IVF-Flat n={len(data)} n_cells={n_cells} "
        f"n_probe={IVF_PROBE}: build {ivf_build_s:.3f} s, {len(test)} "
        f"queries {ivf_query_s:.4f} s ({len(test) / ivf_query_s:.1f} "
        f"queries/s), recall@10 {ivf_rec:.4f}")
    return dict(build_s=build_s, recall=rec, big_s=big_s,
                ivf_build_s=ivf_build_s, ivf_query_s=ivf_query_s,
                ivf_recall=ivf_rec)


def churn_ops(rng, data, leaf_ids, scale: int = 1):
    """The write stream of the online phases (``CHURN`` / ``scale``):
    upserts of resident rows plus N(0, 0.05) noise in batches,
    replacements of resident ids, and deletes of other resident ids.
    Returns ``(upsert ops, replacement op, resident deletes)``."""
    c = {k: v // scale for k, v in CHURN.items()}
    d = data.shape[1]
    src = rng.choice(len(data), c["upserts"], replace=False)
    new = data[src] + rng.normal(0, 0.05, size=(len(src), d)).astype(np.float32)
    ups = [("upsert", new[i:i + c["batch"]])
           for i in range(0, len(new), c["batch"])]
    ids = rng.choice(leaf_ids, c["replace"] + c["delete"], replace=False)
    rep_ids, dead = ids[:c["replace"]], ids[c["replace"]:]
    rep = data[rep_ids] + rng.normal(0, 0.05, size=(len(rep_ids), d)).astype(
        np.float32)
    return ups, ("upsert", (rep, rep_ids.astype(np.int32))), dead, c


def apply_churn(handle, ups, rep, dead, c, rng) -> dict:
    """Drive the stream through ``EpochHandle.apply_writes`` (every op must
    succeed); returns the upserted ids, the deleted ids and the time."""
    t0 = time.perf_counter()
    out = handle.apply_writes(ups + [rep])
    bad = [o for o in out if isinstance(o, Exception)]
    require(not bad, f"writes failed: {bad[:3]}")
    upserted = np.concatenate(out[:len(ups)])
    dead_up = rng.choice(upserted, c["delete_upserted"], replace=False)
    out = handle.apply_writes([("delete", dead), ("delete", dead_up)])
    require(out == [len(dead), len(dead_up)], f"deletes removed {out}")
    write_s = sync_s(t0)
    n_ops = len(upserted) + len(rep[1][1]) + len(dead) + len(dead_up)
    return dict(upserted=upserted, deleted=np.concatenate([dead, dead_up]),
                dead_up=dead_up, write_s=write_s, n_ops=n_ops)


def check_self_found(plan, idx, upserted, deleted) -> None:
    """A query equal to a live upserted vector returns its own id first."""
    import torch

    alive = np.setdiff1d(upserted, deleted)[:64]
    pos = np.nonzero(np.isin(idx.delta.ids[:idx.delta.size], alive)
                     & idx.delta.active[:idx.delta.size])[0]
    res = plan(torch.from_numpy(idx.delta.vectors[pos]).cuda())
    require(np.array_equal(res.ids[:, 0].cpu().numpy(), idx.delta.ids[pos]),
            "an upserted vector does not find itself first")


def check_exact_sets(res, gd, gt) -> None:
    """A dense exact search (radius 1e9) against exact_knn over the live
    set, as sets: an id in one and not the other must sit at the k-th
    place's distance, within the tolerance rule (l2 compared squared)."""
    ids, dists = res.ids.cpu().numpy(), res.dists.cpu().numpy()
    atol = atol_of(gd * gd)
    for q in range(len(gt)):
        diff = set(ids[q].tolist()) ^ set(gt[q].tolist())
        if diff:
            kth = max(float(gd[q, -1]), float(dists[q, -1])) ** 2
            near = [float(x) ** 2 for i, x in zip(ids[q], dists[q]) if i in diff]
            near += [float(x) ** 2 for i, x in zip(gt[q], gd[q]) if i in diff]
            require(all(abs(x - kth) <= atol + 1e-5 * kth for x in near),
                    f"query {q}: exact search {sorted(ids[q])} != "
                    f"exact_knn {sorted(gt[q])}")


def phase_online(main: dict, data: np.ndarray, workdir: str) -> dict:
    """The online tiers on a copy of the main 1M index (``from_arrays`` of
    its arrays, so phases 3 and 4 keep measuring the frozen index): the
    ``beam_vmap`` plan on the clean copy against the beam plan, then the
    CHURN write stream through ``EpochHandle.apply_writes`` (its swap
    policy off: this phase compacts by hand), the default plan with the
    delta leg and the tombstone mask, a save / load of the churned index
    (format v3) in ``workdir``, compaction of both scopes. Launch counts
    are read per window (``WINDOW_KERNELS``)."""
    import torch
    from repro_torch.baselines import exact_knn
    from repro_torch.core.index import PDASCIndex
    from repro_torch.core.reference_impl import check_index_invariants
    from repro_torch.online import EpochHandle, live_dataset
    from repro_torch.query import Query

    Qc, gl = main["Qc"], 256
    idx = PDASCIndex.from_arrays(*main["idx"].to_arrays(), device="cuda")
    idx.enable_mutations()
    frozen = idx.plan(Query(k=10))
    fres = frozen(Qc)
    t0 = time.perf_counter()
    frozen(Qc)
    frozen_s = sync_s(t0)

    # the seed per-query beam (gathers + dist.point, no kernel of the port)
    # on the clean copy, against the batched beam plan's results
    vplan = idx.plan(Query(k=10, execution="beam_vmap"))
    require(vplan.pipeline == "beam_vmap", f"planned {vplan.pipeline}")
    Qv = Qc[:N_CPU_CHECK]
    start_phase()
    t0 = time.perf_counter()
    vres = vplan(Qv)
    vmap_s = sync_s(t0)
    vcounts = launched("online-beam-vmap", ())
    require(not any(vcounts.values()),
            f"beam_vmap launched a kernel: {vcounts}")
    vd = vres.dists.cpu().numpy()
    topk_agree(vd, vres.ids.cpu().numpy(), fres.dists[:N_CPU_CHECK].cpu().numpy(),
               fres.ids[:N_CPU_CHECK].cpu().numpy(), vd)
    # a candidate at the radius within rounding may count on one side only
    n_cand_diff = int((vres.n_candidates.cpu()
                       != fres.n_candidates[:N_CPU_CHECK].cpu()).sum())
    log(f"[online] beam_vmap plan on the clean copy, {len(Qv)} queries: "
        f"{vmap_s:.4f} s, no kernel launched, == the beam plan (ids modulo "
        f"near-ties); candidate counts differ on {n_cand_diff} queries")

    rng = np.random.default_rng(1)
    leaf_ids = idx.data.leaf_ids[idx.data.levels[0].valid].cpu().numpy()
    ups, rep, dead, c = churn_ops(rng, data, leaf_ids)
    start_phase()
    handle = EpochHandle(idx, delta_fill=1.0, tombstone_ratio=1.0)
    w = apply_churn(handle, ups, rep, dead, c, rng)
    counts = {"online-writes": launched("online-writes")}
    require(handle.current is idx and handle.swaps == 0, "the handle swapped")
    fill = idx.delta.size / idx.delta.capacity
    require(idx.needs_compaction(), f"needs_compaction() is false at delta "
            f"fill {idx.delta.size}/{idx.delta.capacity}")

    start_phase()
    plan = idx.plan(Query(k=10))
    legs = plan.describe()["online_legs"]
    require(legs["tombstone_mask"] and legs["delta"],
            f"the plan lacks an online leg: {legs}")
    res = plan(Qc)
    t0 = time.perf_counter()
    res = plan(Qc)
    churn_s = sync_s(t0)
    require(not np.isin(res.ids.cpu().numpy(), w["deleted"]).any(),
            "a deleted id surfaced under churn")
    check_self_found(plan, idx, w["upserted"], w["deleted"])
    counts["online-search"] = launched("online-search")

    cpu = PDASCIndex.from_arrays(*idx.to_arrays(), device="cpu")
    t0 = time.perf_counter()
    want = cpu.plan(Query(k=10))(Qc[:N_CPU_CHECK].cpu())
    gd = res.dists[:N_CPU_CHECK].cpu().numpy()
    topk_agree(gd, res.ids[:N_CPU_CHECK].cpu().numpy(), want.dists.numpy(),
               want.ids.numpy(), gd)
    cpu_s = time.perf_counter() - t0
    del cpu

    # save / load of the churned index: format v3 (the online tiers in its
    # mutable meta), loaded on the card with the same tiers and results
    path = os.path.join(workdir, "online_index")
    t0 = time.perf_counter()
    idx.save(path)
    save_s = time.perf_counter() - t0
    with open(path + ".json") as f:
        version = json.load(f)["version"]
    require(version == 3, f"the churned index saved as version {version}")
    t0 = time.perf_counter()
    loaded = PDASCIndex.load(path, device="cuda")
    load_s = sync_s(t0)
    n_d = idx.delta.size
    require(loaded.device.type == "cuda", f"loaded on {loaded.device}")
    require(loaded.delta.size == n_d
            and np.array_equal(loaded.delta.ids[:n_d], idx.delta.ids[:n_d])
            and np.array_equal(loaded.delta.active[:n_d],
                               idx.delta.active[:n_d])
            and np.array_equal(loaded.tombstones.bits, idx.tombstones.bits)
            and loaded._seen_id_ceiling() == idx._seen_id_ceiling(),
            "the loaded index's online tiers differ from the saved ones")
    lres = loaded.plan(Query(k=10))(Qc)
    require(torch.equal(lres.ids, res.ids) and torch.equal(lres.dists, res.dists),
            "the loaded index's search differs from the saved index's")
    del loaded, lres
    for ext in (".npz", ".json"):
        os.remove(path + ext)
    log(f"[online] save (v3, mutable meta) {save_s:.3f} s, load on the card "
        f"{load_s:.3f} s: tiers and id ceiling equal, search bit-equal")

    start_phase()
    live_vecs, live_ids = live_dataset(idx)
    gd_live, gt_rows = exact_knn(Qc, live_vecs, k=10, device="cuda")
    gt = live_ids[gt_rows.cpu().numpy()]
    gd_live = gd_live.cpu().numpy()
    counts["online-truth"] = launched("online-truth")
    rec_churn = recall(res.ids.cpu().numpy(), gt)
    fresh = PDASCIndex.build(live_vecs, gl=gl, distance="euclidean",
                             radius_quantile=0.35, group_chunk=GROUP_CHUNK,
                             device="cuda")
    fr = fresh.plan(Query(k=10, radius=idx.default_radius))(Qc)
    fr_ids = fr.ids.cpu().numpy()
    rec_fresh = recall(np.where(fr_ids >= 0, live_ids[np.clip(fr_ids, 0, None)],
                                -1), gt)
    del fresh
    require(rec_fresh - rec_churn <= 0.02,
            f"recall under churn {rec_churn:.4f} vs a fresh build "
            f"{rec_fresh:.4f}: more than 0.02 lower")

    G = idx.data.levels[0].points.shape[0] // gl
    dead_slots = idx.tombstones.dead_slots()
    touched = set((idx.delta.leaf_slot[:idx.delta.size][
        idx.delta.active[:idx.delta.size]] // gl).tolist()) | set(
        (dead_slots // gl).tolist())
    start_phase()
    t0 = time.perf_counter()
    aff = idx.compact(scope="affected", group_chunk=GROUP_CHUNK)
    aff_s = sync_s(t0)
    t0 = time.perf_counter()
    full = idx.compact(scope="full", group_chunk=GROUP_CHUNK)
    full_s = sync_s(t0)
    counts["online-compact"] = launched("online-compact")
    old, new = idx.data.levels[0], aff.data.levels[0]
    same = ((old.points == new.points[:old.points.shape[0]]).all(-1)
            & (idx.data.leaf_ids == aff.data.leaf_ids[:old.points.shape[0]]))
    same_group = same.reshape(G, gl).all(-1).cpu().numpy()
    untouched = np.setdiff1d(np.arange(G), list(touched))
    require(same_group[untouched].all(),
            "affected compaction changed an untouched group's rows")
    share = 1.0 - same_group.mean()
    profile_breakdown("compact(affected)", lambda: idx.compact(
        scope="affected", group_chunk=GROUP_CHUNK))
    profile_breakdown(f"routing of {CHURN['batch']} upserts",
                      lambda: idx._route_to_leaf(ups[0][1]))
    exact = {}
    start_phase()
    for name, c_idx in (("affected", aff), ("full", full)):
        errs = check_index_invariants(c_idx.data)
        require(errs == [], f"{name} compaction: {errs[:5]}")
        require(c_idx.n_points == len(live_ids) and c_idx.epoch == 1,
                f"{name} compaction holds {c_idx.n_points} points")
        ex = c_idx.plan(Query(k=10, execution="dense", radius=1e9))(Qc)
        check_exact_sets(ex, gd_live, gt)
        exact[name] = recall(c_idx.plan(Query(k=10))(Qc).ids.cpu().numpy(), gt)
    counts["online-compacted"] = launched("online-compacted")
    out = dict(writes_per_s=w["n_ops"] / w["write_s"], write_s=w["write_s"],
               n_ops=w["n_ops"], delta_fill=fill,
               qps_frozen=len(Qc) / frozen_s, qps_churn=len(Qc) / churn_s,
               recall_churn=rec_churn, recall_fresh=rec_fresh,
               affected_s=aff_s, full_s=full_s, affected_share=share,
               recall_compacted=exact, vmap_s=vmap_s, save_s=save_s,
               load_s=load_s, counts=counts)
    log(f"[online] {w['n_ops']} writes (CHURN {json.dumps(CHURN)}) through "
        f"EpochHandle.apply_writes: {w['write_s']:.3f} s "
        f"({out['writes_per_s']:.1f} writes/s); delta fill "
        f"{idx.delta.size}/{idx.delta.capacity}, {idx.tombstones.count} "
        f"tombstoned; needs_compaction() true")
    log(f"[online] {len(Qc)} queries, beam 32 + delta leg + tombstone mask: "
        f"{churn_s:.4f} s ({out['qps_churn']:.1f} queries/s) against "
        f"{frozen_s:.4f} s frozen ({out['qps_frozen']:.1f} queries/s); no "
        f"deleted id surfaced; upserted vectors find themselves first; card "
        f"== CPU on {N_CPU_CHECK} queries (CPU took {cpu_s:.1f} s)")
    log(f"[online] recall@10 under churn {rec_churn:.4f}, a fresh build on "
        f"the {len(live_ids)} live points {rec_fresh:.4f} (bar: within 0.02)")
    log(f"[online] compact(affected) {aff_s:.3f} s ({100 * share:.2f}% of "
        f"{G} groups changed, untouched groups bit-identical), "
        f"compact(full) {full_s:.3f} s; both pass the invariants, their "
        f"dense exact search == exact_knn over the live set as sets; "
        f"recall@10 beam 32 after {json.dumps(exact)}")
    return out


def phase_store_churn(main: dict, data: np.ndarray) -> dict:
    """The CHURN stream at 1/8 its size on the store phase's index (int8
    store, memmapped exact payload, dense payload released): upserts
    route through the scan at k = 1, the default two-stage plan runs
    under the tombstone mask with the delta leg, and an affected
    compaction rebuilds the store into a fresh file."""
    from repro_torch.core.reference_impl import check_index_invariants
    from repro_torch.online import EpochHandle
    from repro_torch.query import Query

    idx, Qc = main["idx"], main["Qc"]
    require(idx._payload_released, "the store phase's index is not released")
    idx.enable_mutations()
    rng = np.random.default_rng(2)
    leaf_ids = idx.data.leaf_ids[idx.data.levels[0].valid].cpu().numpy()
    ups, rep, dead, c = churn_ops(rng, data, leaf_ids, scale=8)
    start_phase()
    w = apply_churn(EpochHandle(idx, delta_fill=1.0, tombstone_ratio=1.0),
                    ups, rep, dead, c, rng)
    counts = {"store-churn-writes": launched("store-churn-writes")}
    start_phase()
    plan = idx.plan(Query(k=10))
    legs = plan.describe()["online_legs"]
    require(plan.pipeline == "two_stage" and legs["tombstone_mask"]
            and legs["delta"], f"store churn plan: {plan.pipeline} {legs}")
    t0 = time.perf_counter()
    res = plan(Qc)
    q_s = sync_s(t0)
    require(not np.isin(res.ids.cpu().numpy(), w["deleted"]).any(),
            "a deleted id surfaced in two-stage under churn")
    check_self_found(plan, idx, w["upserted"], w["deleted"])
    counts["store-churn-search"] = launched("store-churn-search")

    old_path = idx.store.exact.path
    start_phase()
    t0 = time.perf_counter()
    new = idx.compact(scope="affected", group_chunk=GROUP_CHUNK)
    comp_s = sync_s(t0)
    counts["store-churn-compact"] = launched("store-churn-compact")
    errs = check_index_invariants(new.data)
    require(errs == [], f"store compaction: {errs[:5]}")
    require(new._payload_released and new.store.exact.path != old_path
            and new.store.exact.path.endswith(".epoch1"),
            f"the new epoch's payload file is {new.store.exact.path}")
    rb = new.store.last_rebuild
    block = idx.store.block
    n_old = idx.store.n
    old_rows = idx.store.exact.read_all()
    new_rows = new.store.exact.read_all()[:n_old]
    same = (old_rows == new_rows).all(-1) & (
        idx.data.leaf_ids.cpu().numpy() == new.data.leaf_ids.cpu().numpy()[:n_old])
    nb = n_old // block
    keep = same[:nb * block].reshape(nb, block).all(-1)
    rows = np.nonzero(np.repeat(keep, block))[0]
    require(np.array_equal(idx.store.codes[rows].cpu().numpy(),
                           new.store.codes[rows].cpu().numpy()),
            "unchanged blocks' codes differ after the rebuild")
    res2 = new.plan(Query(k=10))(Qc)
    require(not np.isin(res2.ids.cpu().numpy(), w["deleted"]).any(),
            "a deleted id surfaced after the store compaction")
    share = rb["requantized"] / rb["blocks"]
    log(f"[store-churn] {w['n_ops']} writes on the released int8 index: "
        f"{w['write_s']:.3f} s ({w['n_ops'] / w['write_s']:.1f} writes/s, "
        f"routed by the scan at k=1); two-stage {len(Qc)} queries with the "
        f"delta leg and the tombstone mask {q_s:.4f} s, no deleted id; "
        f"compact(affected) {comp_s:.3f} s, re-quantised {rb['requantized']} "
        f"of {rb['blocks']} blocks ({100 * share:.2f}%), {int(keep.sum())} "
        f"unchanged blocks' codes bit-equal, payload in a fresh file "
        f"({os.path.basename(new.store.exact.path)})")
    for st in (idx.store, new.store):
        if st.exact._pool is not None:
            st.exact._pool.close()
    return dict(write_s=w["write_s"], n_ops=w["n_ops"], query_s=q_s,
                compact_s=comp_s, requantized_share=share, counts=counts)


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
    phase_build_parity(data)
    main_run = phase_main_path(data, test)
    phase_cpu_check(main_run)
    phase_profile(data, main_run)
    rows = phase_timing(data, main_run)
    phase_kmeans(data, test, main_run)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as work:
        phase_online(main_run, data, work)
        store = phase_store(main_run, work)
        rows.append(phase_scan_timing(main_run, store))
        phase_store_churn(main_run, data)
    for r in rows:  # each phase's launches of the kernel, beside the main path's
        r["phase_launches"] = {ph: c[r["name"]] for ph, c in PHASE_LAUNCHES.items()}
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
