#!/usr/bin/env python3
"""Where a CUDA kernel's time goes, on one GPU.

    python3 tools/kernel_phases.py [--kernel knn|rank|pairwise|scan|swap]
                                   [--route wgmma|stream] [--source FILE]

Builds copies of one kernel source under ``build/tools/`` and times each
with CUDA events at the main path's shape (inputs are normal data from a
seed), then prints one JSON object with the card's name and power limit:

* ``knn`` (``csrc/knn.cu``; 1,000 queries against 1,000,000 rows, d = 100,
  k = 10, l2 and dot; with ``--route stream`` the streaming route at
  chip_smoke.py's KNN_STREAM_SHAPE, 1,000 queries against 100,000 rows,
  d = 1536): the kernel, a copy without its top-k epilogue (the products
  alone), a copy that counts ``clock64`` cycles a warp per phase (wait
  for the ring and the block barrier, products (with the stream route's
  query split), distances, appends, merges, the tile's barrier) and, on
  the stream route, a copy that does not promote its products (what the
  fp32 promotion costs; its values drift past the tolerance rule).
* ``rank`` (``csrc/rank.cu``; the leaf ranking of the main path: 1,000
  queries, 384 candidate slots each, ~30% unmasked, into the 1,000,000-row
  leaf table of an index built as chip_smoke.py builds it, d = 100, k = 10,
  l2; ``--table synthetic`` for a table of that shape from a seed): the
  kernel and a copy that counts cycles a warp in the gather of candidate
  rows and their distances, the wait at the block barriers, and the top-k
  merges, with the slowest warp's total.
* ``pairwise`` (``csrc/pairwise.cu``; one build slab, 1024 groups of 256
  points, d = 100, l2 and l1, with X as Y (the build's call: the upper
  triangle) and with a copy of X as Y (every tile)): the kernel and a copy
  that drops the output stores (what the products and the epilogue cost
  without them).
* ``scan`` (``csrc/scan.cu``; stage 1 of the two-stage call: the leaf
  candidate table of ``rank`` above, k = R = 128, l2, over the leaf points
  quantised with block 256 as int8, fp16, int4 and binary codes): the
  kernel and a copy that counts cycles a warp in the gather (code rows,
  unpacking, distances), the block barriers and the top-k merges.

* ``swap`` (``csrc/swap.cu``; one sweep of the build's slab, 1,024 groups
  of 256 points, k = 128, the caches from a seed with ~80% of the rows
  valid): the kernel alone, through its C entry on preallocated buffers,
  in three rounds of 50 calls that alternate the designs' order.

``--source FILE`` (rank, scan, swap) also measures another version of the
kernel's source (e.g. the parent commit's file, any of its designs) in
the same run, so that the two designs are compared on one card; the
results of the two must be equal. Exits 2 without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))

# Per-warp cycle counters: declared once, read back by the C entry below.
COUNTERS = (
    "__device__ unsigned long long phase_cycles[8];\n"
    "extern \"C\" void read_phase_cycles(unsigned long long* out) {\n"
    "  cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));\n}\n"
    "namespace {")
FLUSH = ("  if ((threadIdx.x & 31) == 0) {\n    long long all_ = 0;\n"
         "    for (int i = 0; i < 7; ++i) {\n"
         "      atomicAdd(&phase_cycles[i], (unsigned long long)PH[i]);\n"
         "      all_ += PH[i];\n    }\n"
         "    atomicMax(&phase_cycles[7], (unsigned long long)all_);\n  }\n")


def tick(i: int) -> str:
    """Add the cycles since the last tick to phase ``i``."""
    return f"T1 = clock64(); PH[{i}] += T1 - T0; T0 = T1;\n"


def edit(src: str, edits: list, what: str) -> str:
    for old, new in edits + [("namespace {", COUNTERS)]:
        if src.count(old) != 1:
            raise RuntimeError(f"{what} changed; no single anchor {old[:50]!r}")
        src = src.replace(old, new, 1)
    return src


# ---- knn -------------------------------------------------------------------

KNN_PHASES = ["wait", "products", "distances", "appends", "merges", "tile_barrier"]
KNN_NOEPI = """    if (!last) continue;
    if (true) {  // the products alone: drop the tile's accumulator
      float z = 0.0f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        z += acc[i];
        acc[i] = 0.0f;
      }
      if (z == 1234.5f) cnt[0] = 1;
      continue;
    }
"""


KNN_STREAM_PROMOTED = "knn_tile<FORM, BQ, true, is_gram(FORM)>"


def knn_instrumented(src: str) -> str:
    return edit(src, [
        ("  for (int s = 0; s < steps; ++s) {\n    cp_wait<NST - 2>();\n"
         "    if (TMA) mbar_wait(bar + s % NST, (s / NST) & 1);\n"
         "    __syncthreads();\n    issue(s + NST - 1);\n",
         "  long long PH[8] = {}, T0, T1;\n"
         "  for (int s = 0; s < steps; ++s) {\n    T0 = clock64();\n"
         "    cp_wait<NST - 2>();\n"
         "    if (TMA) mbar_wait(bar + s % NST, (s / NST) & 1);\n"
         "    __syncthreads();\n    issue(s + NST - 1);\n    " + tick(0)),
        ("    if (!last) continue;\n", "    " + tick(1) + "    if (!last) continue;\n"),
        ("    uint64_t done = 0;\n", "    " + tick(2) + "    uint64_t done = 0;\n"),
        ("      if (!__syncthreads_or(ready)) break;\n",
         "      " + tick(3) + "      const int any_ = __syncthreads_or(ready);\n"
         "      " + tick(5) + "      if (!any_) break;\n"),
        ("      if (!retry) break;\n    }\n",
         "      " + tick(4) + "      if (!retry) break;\n    }\n"),
        ("  for (int e = threadIdx.x; e < BQ * k; e += THREADS) {\n"
         "    const int gq = q0 + e / k;",
         FLUSH + "  for (int e = threadIdx.x; e < BQ * k; e += THREADS) {\n"
         "    const int gq = q0 + e / k;"),
    ], "knn.cu")


# ---- rank ------------------------------------------------------------------

RANK_PHASES = ["gather", "barrier", "merge"]


def rank_instrumented(src: str, what: str = "rank.cu") -> str:
    """Cycle counters in any design of rank.cu or scan.cu: the first (a
    block a query, a warp a candidate, merge_tile per 128-slot tile), PR
    14's rank.cu (warps a query, a compacted gather, merges of a candidate
    buffer, all in the file) or the current one (the same on topk.cuh):
    the gather and distances, the wait at block barriers, the top-k
    merges."""
    if "merge_tile(sd, si, nd, ni, td, ti, TILE, k);" in src:  # the first
        return edit(src, [
            ("  for (int t0 = 0; t0 < w; t0 += TILE) {\n",
             "  long long PH[8] = {}, T0 = clock64(), T1;\n"
             "  for (int t0 = 0; t0 < w; t0 += TILE) {\n"),
            ("    __syncthreads();\n    merge_tile(sd, si, nd, ni, td, ti, TILE, k);\n"
             "    __syncthreads();\n",
             "    " + tick(0) + "    __syncthreads();\n    " + tick(1)
             + "    merge_tile(sd, si, nd, ni, td, ti, TILE, k);\n"
             "    __syncthreads();\n    " + tick(2)),
            ("  for (int i = threadIdx.x; i < k; i += THREADS) {\n"
             "    out_d[b * k + i] = sd[i];",
             FLUSH + "  for (int i = threadIdx.x; i < k; i += THREADS) {\n"
             "    out_d[b * k + i] = sd[i];"),
        ], what)
    if "top.make_room(STEP);" in src:  # the current design, on topk.cuh
        return edit(src, [
            ("  auto step = [&](int head, int take) {\n",
             "  long long PH[8] = {}, T0 = clock64(), T1;\n"
             "  auto step = [&](int head, int take) {\n"),
            ("    top.make_room(STEP);",
             "    " + tick(0) + "    top.make_room(STEP);\n    " + tick(2)),
            ("  top.flush();\n", "  " + tick(0) + "  top.flush();\n  " + tick(2)),
            ("  __syncthreads();\n  if (live) top.write_query(",
             "  __syncthreads();\n  " + tick(1) + FLUSH
             + "  if (live) top.write_query("),
        ], what)
    return edit(src, [
        ("  const int tiles = live ? (w + 31) / 32 : 0;\n",
         "  long long PH[8] = {}, T0 = clock64(), T1;\n"
         "  const int tiles = live ? (w + 31) / 32 : 0;\n"),
        ("      warp_merge(sd, si, bd, bi, bc, k);\n      bc = 0;\n",
         "      " + tick(0) + "      warp_merge(sd, si, bd, bi, bc, k);\n"
         "      " + tick(2) + "      bc = 0;\n"),
        ("  if (bc > 0) {\n    __syncwarp();\n    warp_merge(sd, si, bd, bi, bc, k);\n  }\n",
         "  " + tick(0) + "  if (bc > 0) {\n    __syncwarp();\n"
         "    warp_merge(sd, si, bd, bi, bc, k);\n  }\n  " + tick(2)),
        ("  __syncthreads();\n  if (live && wi == 0) {\n",
         "  __syncthreads();\n  " + tick(1) + FLUSH + "  if (live && wi == 0) {\n"),
    ], "rank.cu")


def scan_instrumented(src: str) -> str:
    return rank_instrumented(src, "scan.cu")


def rank_inputs(torch, rng, table: str):
    """The leaf ranking's inputs. ``real``: the main path's own, as
    chip_smoke.py makes them (dense_embed, n = 1,000,000, gl = 256,
    euclidean, 1,000 held-out queries, the beam-32 descent's candidate
    table). ``synthetic``: the same shape, 32 beams x 12 child slots a
    query with the first ``c`` of a beam valid (``c`` uniform in [0, 7],
    ~30%), each beam's children contiguous rows of a normal table."""
    if table == "real":
        from repro_torch.core import nsa
        from repro_torch.core.index import PDASCIndex
        from repro_torch.data import make_dataset

        full = make_dataset("dense_embed", n=1_001_000, seed=0)
        idx = PDASCIndex.build(full[:1_000_000], gl=256, distance="euclidean",
                               radius_quantile=0.35, group_chunk=1024,
                               device="cuda")
        Q = torch.from_numpy(full[1_000_000:]).cuda()
        cand, ok = nsa.descend_beam(idx.data, Q, dist=idx.distance,
                                    r=idx.default_radius, beam=32,
                                    max_children=idx.max_children)
        leaf = idx.data.levels[0]
        return dict(Q=Q, P=leaf.points, sq=leaf.sq_norm,
                    idx=cand.to(torch.int32).contiguous(), ok=ok.contiguous())
    n, d, b, beams, kids = 1_000_000, 100, 1000, 32, 12
    P = rng.normal(size=(n, d)).astype(np.float32)
    Q = rng.normal(size=(b, d)).astype(np.float32)
    start = rng.integers(0, n - kids, size=(b, beams, 1))
    idx = (start + np.arange(kids)).reshape(b, beams * kids).astype(np.int32)
    count = rng.integers(0, 8, size=(b, beams, 1))
    ok = (np.arange(kids) < count).reshape(b, beams * kids)
    t = lambda x: torch.from_numpy(x).cuda()  # noqa: E731
    Pc = t(P)
    return dict(Q=t(Q), P=Pc, sq=(Pc * Pc).sum(-1), idx=t(idx), ok=t(ok))


# ---- pairwise --------------------------------------------------------------

PAIRWISE_STORE = "  if ((ld & 3) == 0) {  // rows 16-byte aligned; cols a multiple of 4\n"
PAIRWISE_NOSTORE = ("  if (ost[threadIdx.x] == 1234.5f) out[0] = 1.0f;  // keep the tile\n"
                    "  return;\n" + PAIRWISE_STORE)


# ---- swap --------------------------------------------------------------------


def swap_designs(torch, out, sources, rng, time_ms, G=1024, g=256, k=128,
                 rounds=3):
    """Time each design of swap.cu on one sweep of the build's slab through
    its C entry (the unsplit design's takes 9 pointers; the slot-split one
    adds the slot offsets and the partial S), in ``rounds`` rounds that
    alternate the designs' order (A B B A ...), and say whether they agree
    bit for bit."""
    from repro_torch.kernels import kmedoids as kmk

    t = lambda x: torch.from_numpy(x).cuda()  # noqa: E731
    D = t(np.abs(rng.normal(size=(G, g, g))).astype(np.float32))
    d1 = t(np.abs(rng.normal(size=(G, g))).astype(np.float32))
    d2 = d1 + t(np.abs(rng.normal(size=(G, g))).astype(np.float32))
    n1 = t(rng.integers(0, k, size=(G, g)).astype(np.int32))
    valid = t(rng.random((G, g)) > 0.2)
    runs, outs = {}, {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for tag, text in sources.items():
        split = "void* off" in text
        lib = build("swap", {tag: text},
                    {"swap_launch": [P] * (11 if split else 9) + [I] * 3 + [P]})[tag]
        nz = kmk.swap_geometry(g, k).slot_blocks if split else 1
        o = torch.empty((G, k, g), device="cuda")
        scratch = [torch.empty((G, g), device="cuda", dtype=torch.int32),
                   torch.empty((G, g, 4), device="cuda")]
        if split:
            scratch.append(torch.empty((G, k + 1), device="cuda", dtype=torch.int32))
        scratch.append(torch.empty(G, device="cuda", dtype=torch.int32))
        if split:
            scratch.append(torch.empty((G, nz, g) if nz > 1 else (1,), device="cuda"))
        args = ([x.data_ptr() for x in (D, d1, d2, n1, valid, o)]
                + [x.data_ptr() for x in scratch]
                + [G, g, k, torch.cuda.current_stream().cuda_stream])
        runs[tag] = lambda lib=lib, a=args: _check(lib.swap_launch(*a), "swap")  # noqa: E731
        runs[tag]()
        outs[tag] = o.clone()
    ms = {tag: [] for tag in runs}
    order = list(runs)
    for r in range(rounds):
        for tag in (order if r % 2 == 0 else order[::-1]):
            ms[tag].append(time_ms(runs[tag], iters=50))
    first = next(iter(outs.values()))
    out.update(shape=[G, g, k], ms=ms,
               median_ms={tag: float(np.median(v)) for tag, v in ms.items()},
               designs_bit_equal=all(torch.equal(v, first) for v in outs.values()))


# ---- build, count, main ------------------------------------------------------


def build(name: str, variants: dict, signatures: dict) -> dict:
    """Compile each ``{variant: source text}`` of csrc/``name``.cu with
    the kernels' flags (one nvcc each, all started together)."""
    from repro_torch.kernels import _build

    out_dir = os.path.join(ROOT, "build", "tools", name)
    procs = {}
    for var, text in variants.items():
        d = os.path.join(out_dir, var)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{name}.cu"), "w") as f:
            f.write(text)
        for hdr in _build.CSRC.glob("*.cuh"):
            with open(os.path.join(d, hdr.name), "w") as f:
                f.write(hdr.read_text())
        procs[var] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
             os.path.join(d, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for var, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}/{var}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, var, "lib.so"))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[var] = lib
    return libs


def cycles(torch, lib, run, phases: list, warps: int) -> dict:
    before, after = (ctypes.c_ulonglong * 8)(), (ctypes.c_ulonglong * 8)()
    lib.read_phase_cycles(before)
    run()
    torch.cuda.synchronize()
    lib.read_phase_cycles(after)
    out = {p: (after[i] - before[i]) / warps for i, p in enumerate(phases)}
    out["slowest_warp"] = after[7]  # a maximum over every run of this copy
    return out


def compare_designs(torch, out, sources, what, instrumented, signature_of,
                    cases, time_ms) -> None:
    """Build each design of ``what`` (``{tag: text}``) with its cycle
    counting copy, then for each case ``{label: (args_of, outputs)}``
    (``args_of(text)``: the C entry's arguments for a design) time them,
    count their cycles, require each copy to give its kernel's result, and
    say whether the designs agree bit for bit."""
    libs = {}
    for tag, text in sources.items():
        libs.update(build(what, {f"{tag}_kernel": text,
                                 f"{tag}_phases": instrumented(text)},
                          signature_of(text)))
    for label, (args_of, outputs) in cases.items():
        res = out.setdefault(label, {"ms": {}, "cycles_per_warp": {}})
        results = {}
        runs = {}
        for name, lib in libs.items():
            text = sources[name.rsplit("_", 1)[0]]
            runs[name] = (lambda lib=lib, a=args_of(text): _check(
                getattr(lib, f"{what}_launch")(*a), what))
            res["ms"][name] = time_ms(runs[name])
            runs[name]()
            results[name] = tuple(t.clone() for t in outputs)
        for tag in sources:
            per = cycles(torch, libs[f"{tag}_phases"], runs[f"{tag}_phases"],
                         RANK_PHASES, 1)
            slowest = per.pop("slowest_warp")
            total = sum(per.values())
            res["cycles_per_warp"][tag] = {
                "share": {p: v / total for p, v in per.items()},
                "total_cycles_all_warps": total, "slowest_warp": slowest}
            if not all(torch.equal(a, b) for a, b in zip(
                    results[f"{tag}_phases"], results[f"{tag}_kernel"])):
                raise RuntimeError(f"{what} {tag}: the counting copy disagrees")
        kernels = [results[f"{tag}_kernel"] for tag in sources]
        res["designs_bit_equal"] = all(
            torch.equal(a, b) for r in kernels[1:] for a, b in zip(r, kernels[0]))


def _check(err: int, what: str) -> None:
    from repro_torch.kernels import _build

    _build.check(err, what)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("knn", "rank", "pairwise", "scan",
                                         "swap"),
                    default="knn")
    ap.add_argument("--route", choices=("wgmma", "stream"), default="wgmma",
                    help="knn's route (stream: at KNN_STREAM_SHAPE)")
    ap.add_argument("--source", help="another version of rank.cu, scan.cu or "
                    "swap.cu, "
                    "measured beside it")
    ap.add_argument("--table", choices=("real", "synthetic"), default="real",
                    help="rank's and scan's candidate table (default: the "
                    "main path's)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, pairwise as pw, topk
    from repro_torch.kernels.ref import FORMS

    def time_ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    out = {"kernel": args.kernel, "device": torch.cuda.get_device_name(0),
           "card": card, "ms": {}, "cycles_per_warp": {}}
    rng = np.random.default_rng(0)
    src = (_build.CSRC / f"{args.kernel}.cu").read_text()
    sources = {"current": src}
    if args.source:
        if args.kernel not in ("rank", "scan", "swap"):
            raise SystemExit("--source is for --kernel rank, scan or swap")
        with open(args.source) as f:
            sources["source"] = f.read()

    if args.kernel == "knn":
        if src.count("    if (!last) continue;\n") != 1:
            raise RuntimeError("knn.cu changed; no single epilogue anchor")
        variants = {"kernel": src, "products": src.replace(
            "    if (!last) continue;\n", KNN_NOEPI), "phases": knn_instrumented(src)}
        if args.route == "stream":
            if src.count(KNN_STREAM_PROMOTED) != 1:
                raise RuntimeError("knn.cu changed; no single stream anchor")
            variants["unpromoted"] = src.replace(KNN_STREAM_PROMOTED,
                                                 "knn_tile<FORM, BQ, true, false>")
        libs = build("knn", variants, topk._KNN)
        nq, n, d = (1000, 1_000_000, 100) if args.route == "wgmma" \
            else (1000, 100_000, 1536)  # chip_smoke.py's KNN_STREAM_SHAPE
        Q = torch.from_numpy(rng.normal(size=(nq, d)).astype(np.float32)).cuda()
        DB = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).cuda()
        geo = topk.knn_geometry(nq, n, d, 10, "l2",
                                torch.cuda.get_device_properties(0).multi_processor_count)
        if geo.route != args.route:
            raise RuntimeError(f"[{nq}, {n}, {d}] takes the {geo.route} route")
        warps = geo.splits * -(-nq // geo.bq) * 8
        out.update(shape=[nq, n, d, 10], geometry=geo._asdict())
        for form in ("l2", "dot"):
            for name, lib in libs.items():
                _build._libs["knn"] = lib
                out["ms"][f"{name}/{form}"] = time_ms(
                    lambda: topk.knn_cuda(Q, DB, 10, form), iters=5)
            _build._libs["knn"] = libs["phases"]
            out["cycles_per_warp"][form] = cycles(
                torch, libs["phases"], lambda: topk.knn_cuda(Q, DB, 10, form),
                KNN_PHASES, warps)
    elif args.kernel in ("rank", "scan"):
        x = rank_inputs(torch, rng, args.table)
        b, w = x["idx"].shape
        per_query = x["ok"].sum(1)
        k = 10 if args.kernel == "rank" else 128  # scan: k = R = 128
        out.update(shape=[b, w, 100, k], table=args.table,
                   unmasked=int(per_query.sum()),
                   unmasked_per_query={"mean": float(per_query.float().mean()),
                                       "max": int(per_query.max())},
                   points_16B_aligned=x["P"].data_ptr() % 16 == 0)
        od = torch.empty((b, k), device="cuda")
        os_ = torch.empty((b, k), device="cuda", dtype=torch.int32)
        stream = torch.cuda.current_stream().cuda_stream
        geo = topk.rank_geometry(b, 100, w, k)
        # a design that takes the block shape ends its C entry with it
        shaped = lambda text: "int wpq, int qpb" in text  # noqa: E731
        if args.kernel == "rank":
            head = [x["Q"].data_ptr(), x["P"].data_ptr(), x["sq"].data_ptr(),
                    x["idx"].data_ptr(), x["ok"].data_ptr(), od.data_ptr(),
                    os_.data_ptr(), b, x["P"].shape[0], 100, w, k,
                    FORMS.index("l2")]
            compare_designs(
                torch, out, sources, "rank", rank_instrumented,
                lambda text: {"rank_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int]
                              * (6 + 2 * shaped(text)) + [ctypes.c_void_p]},
                {"l2": (lambda text: head + ([geo.wpq, geo.qpb] if shaped(text)
                                             else []) + [stream], (od, os_))},
                time_ms)
        else:
            from repro_torch.kernels import quantized
            from repro_torch.store import quantize

            cases = {}
            for backend, fmt, container in (("int8", "dense", 0), ("fp16", "dense", 1),
                                            ("int4", "int4", 2), ("binary", "binary", 3)):
                codes, scales = quantize(x["P"], backend, 256)
                vec = quantized.load_width(codes.shape[1] * codes.element_size(),
                                           codes.data_ptr(), 4 if fmt == "binary" else 16)
                head = [x["Q"].data_ptr(), codes.data_ptr(), scales.data_ptr(),
                        x["idx"].data_ptr(), x["ok"].data_ptr(), od.data_ptr(),
                        os_.data_ptr(), b, codes.shape[0], scales.shape[0], 256,
                        100, codes.shape[1], w, k, FORMS.index("l2"), container]
                cases[backend] = (
                    lambda text, head=head, vec=vec, codes=codes, scales=scales:
                    head + ([geo.wpq, geo.qpb, vec] if shaped(text) else [])
                    + [stream], (od, os_))
                out[f"{backend}_load_bytes"] = vec
            compare_designs(
                torch, out, sources, "scan", scan_instrumented,
                lambda text: {"scan_launch": [ctypes.c_void_p] * 7 + [ctypes.c_int]
                              * (10 + 3 * shaped(text)) + [ctypes.c_void_p]},
                cases, time_ms)
    elif args.kernel == "swap":
        swap_designs(torch, out, sources, rng, time_ms)
    else:
        variants = {}
        for tag, text in sources.items():
            if text.count(PAIRWISE_STORE) != 1:
                raise RuntimeError(f"pairwise.cu ({tag}) has no single store anchor")
            variants[f"{tag}_kernel"] = text
            variants[f"{tag}_no_store"] = text.replace(PAIRWISE_STORE, PAIRWISE_NOSTORE)
        libs = build("pairwise", variants, pw._SIGNATURES)
        X = torch.from_numpy(rng.normal(size=(1024, 256, 100)).astype(np.float32)).cuda()
        Y = X.clone()  # the same values, not the same tensor: every tile
        out.update(shape=[1024, 256, 256, 100])
        for form in ("l2", "l1"):
            for name, lib in libs.items():
                _build._libs["pairwise"] = lib
                out["ms"][f"{name}/{form}"] = time_ms(lambda: pw.pairwise_cuda(X, X, form))
                out["ms"][f"{name}/{form}/copy"] = time_ms(
                    lambda: pw.pairwise_cuda(X, Y, form))
    _build._libs.clear()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
