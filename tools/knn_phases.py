#!/usr/bin/env python3
"""Where the time of the knn kernel goes, on one GPU.

    python3 tools/knn_phases.py

Builds three copies of ``src/repro_torch/csrc/knn.cu`` under
``build/tools/``: the kernel as it is, one without its top-k epilogue (the
products alone: each tile's accumulator is summed and dropped), and one
that counts ``clock64`` cycles per phase in every warp. Times each at the
main path's shape (1,000 queries against 1,000,000 rows, d = 100, k = 10;
normal data from a seed) with CUDA events, for l2 and dot, and prints one
JSON object: the times in ms and the mean cycles a warp spends per phase
(wait for the ring and the block barrier, products, distances, appends,
merges, the tile's barrier), with the card's name and power limit. Exits
2 without a GPU.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))

NOEPI = """    if (!last) continue;
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

PHASES = ["wait", "products", "distances", "appends", "merges", "tile_barrier"]


def instrumented(src: str) -> str:
    """``src`` with per-warp clock64 counters around each phase."""
    edits = [
        ("  for (int s = 0; s < steps; ++s) {\n    cp_wait<STAGES - 2>();\n"
         "    __syncthreads();\n    issue(s + STAGES - 1);\n",
         "  long long P[6] = {0, 0, 0, 0, 0, 0}, T0, T1;\n"
         "  for (int s = 0; s < steps; ++s) {\n    T0 = clock64();\n"
         "    cp_wait<STAGES - 2>();\n    __syncthreads();\n"
         "    issue(s + STAGES - 1);\n    T1 = clock64(); P[0] += T1 - T0; T0 = T1;\n"),
        ("    if (!last) continue;\n",
         "    T1 = clock64(); P[1] += T1 - T0; T0 = T1;\n    if (!last) continue;\n"),
        ("    uint64_t done = 0;\n",
         "    T1 = clock64(); P[2] += T1 - T0; T0 = T1;\n    uint64_t done = 0;\n"),
        ("      if (!__syncthreads_or(ready)) break;\n",
         "      T1 = clock64(); P[3] += T1 - T0; T0 = T1;\n"
         "      const int any_ = __syncthreads_or(ready);\n"
         "      T1 = clock64(); P[5] += T1 - T0; T0 = T1;\n"
         "      if (!any_) break;\n"),
        ("      if (!retry) break;\n    }\n",
         "      T1 = clock64(); P[4] += T1 - T0; T0 = T1;\n"
         "      if (!retry) break;\n    }\n"),
        ("  for (int e = threadIdx.x; e < BQ * k; e += THREADS) {\n"
         "    const int gq = q0 + e / k;",
         "  if ((threadIdx.x & 31) == 0)\n    for (int i = 0; i < 6; ++i)\n"
         "      atomicAdd(&phase_cycles[i], (unsigned long long)P[i]);\n"
         "  for (int e = threadIdx.x; e < BQ * k; e += THREADS) {\n"
         "    const int gq = q0 + e / k;"),
        ("namespace {",
         "__device__ unsigned long long phase_cycles[6];\n"
         "extern \"C\" void knn_phase_cycles(unsigned long long* out) {\n"
         "  cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));\n}\n"
         "namespace {"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"knn.cu changed; no single anchor {old[:40]!r}")
        src = src.replace(old, new, 1)
    return src


def build(variants: dict) -> dict:
    from repro_torch.kernels import _build, topk

    out_dir = os.path.join(ROOT, "build", "tools")
    procs = {}
    for name, text in variants.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "knn.cu"), "w") as f:
            f.write(text)
        with open(os.path.join(d, "common.cuh"), "w") as f:
            f.write((_build.CSRC / "common.cuh").read_text())
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(d, "lib.so"),
             os.path.join(d, "knn.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out_dir, name, "lib.so"))
        lib.knn_launch.argtypes = topk._KNN["knn_launch"]
        lib.knn_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, topk

    def time_ms(fn, iters=5):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / iters

    src = (_build.CSRC / "knn.cu").read_text()
    if src.count("    if (!last) continue;\n") != 1:
        raise RuntimeError("knn.cu changed; no single epilogue anchor")
    libs = build({"kernel": src, "products": src.replace(
        "    if (!last) continue;\n", NOEPI), "phases": instrumented(src)})
    rng = np.random.default_rng(0)
    Q = torch.from_numpy(rng.normal(size=(1000, 100)).astype(np.float32)).cuda()
    DB = torch.from_numpy(rng.normal(size=(1_000_000, 100)).astype(np.float32)).cuda()
    geo = topk.knn_geometry(1000, DB.shape[0], 100, 10, "l2",
                            torch.cuda.get_device_properties(0).multi_processor_count)
    warps = geo.splits * -(-1000 // geo.bq) * 8
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    out = {"device": torch.cuda.get_device_name(0), "card": card,
           "shape": [1000, DB.shape[0], 100, 10],
           "geometry": geo._asdict(), "ms": {}, "cycles_per_warp": {}}
    for form in ("l2", "dot"):
        for name, lib in libs.items():
            _build._libs["knn"] = lib
            out["ms"][f"{name}/{form}"] = time_ms(lambda: topk.knn_cuda(Q, DB, 10, form))
        lib = libs["phases"]
        before, after = (ctypes.c_ulonglong * 6)(), (ctypes.c_ulonglong * 6)()
        lib.knn_phase_cycles(before)
        _build._libs["knn"] = lib
        topk.knn_cuda(Q, DB, 10, form)
        torch.cuda.synchronize()
        lib.knn_phase_cycles(after)
        out["cycles_per_warp"][form] = {
            p: (after[i] - before[i]) / warps for i, p in enumerate(PHASES)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
