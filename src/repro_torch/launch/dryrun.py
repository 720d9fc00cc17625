"""Dry-run of every (arch x shape x mesh) cell on the meta device
(counterpart of ``repro.launch.dryrun``).

``repro`` lowers and compiles each cell for 256 or 512 placeholder TPU
devices and reads XLA's cost and memory analyses. The port builds each
cell (``launch/steps.py``) over a :class:`~repro_torch.launch.mesh.MeshShape`
and runs its global step once on ``torch.device("meta")`` tensors made
from ``cell.args``: shapes flow, nothing is computed or allocated. Per
cell it records, to ``<out>/<arch>__<shape>__<mesh>[__<variant>].json``:

  * ``cost_analysis`` — per-rank FLOPs (``torch.utils.flop_counter``'s
    count of the global step over the ranks) and bytes: every aten op's
    reads and writes summed, unfused (the port runs eagerly, so this is
    what it moves short of caches; a gather counts the elements it picks),
    over the ranks. The kernels' wrappers take their plain versions on
    meta tensors, so a kernel's bytes are its plain version's;
  * ``memory_analysis`` — per-rank argument and output bytes from the
    specs (each leaf's block on one rank; an output spec of None counts as
    replicated), the donated bytes, and ``fits_hbm`` against the card's
    80 GB. XLA's temp and peak bytes have no counterpart on meta: None;
  * ``collectives`` — None: no HLO to parse (the mesh paths are ROADMAP
    item 9d-2);
  * ``roofline`` — compute seconds at the peak of the cell's route (bf16
    tensor cores for the LM's projections, 3xTF32 for PDASC's Gram forms,
    fp32 elsewhere) against memory seconds at HBM rate, on the H100
    constants of ``launch.mesh`` (spec-sheet figures). The keys are
    ``repro``'s.

LM cells count a 1- and a 2-layer probe and extrapolate over the depth,
as ``repro`` does: F(L) = F1 + (L - 1) (F2 - F1). The PDASC build's
compute and bytes are analytic (its clustering is data-dependent, so it
cannot run on meta). The PDASC search's shards are alike, and depend on
the mesh: it counts one shard's search over a mesh's shard shapes, times
the ranks. Every other count does not depend on the mesh and is made once
a cell.

Usage:
  python -m repro_torch.launch.dryrun --all     # 42 cells x 2 meshes
  python -m repro_torch.launch.dryrun --arch qwen3-moe-235b-a22b --shape train_4k --mesh multi
  python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pt_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch._spec import ShapeDtype, shard_shape
from repro_torch._tree import tree_flatten_with_path, tree_map
from repro_torch.launch import mesh as mesh_lib

DEFAULT_OUT = "experiments/dryrun_torch"
BYTES_KIND = "unfused: every aten op's reads and writes on the meta device"


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    p.add_argument("--all", action="store_true")
    p.add_argument("--list", action="store_true")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--skip-existing", action="store_true")
    p.add_argument("--variant", default="base",
                   choices=["base", "opt", "opt-beam"],
                   help="a PDASC search variant (suffixes the JSON)")
    return p.parse_args(argv)


# gathers read only the elements they pick from their first argument
_GATHERS = frozenset(("aten::embedding", "aten::index_select", "aten::gather",
                      "aten::index", "aten::take"))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _pt_leaves(tree)
               if isinstance(t, torch.Tensor))


class BytesCounter(TorchDispatchMode):
    """Sums the bytes every aten op reads (its tensor inputs) and writes
    (its tensor outputs); views move nothing and are skipped, and a gather
    reads from its source only the elements it writes out."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        if func._schema.name in _GATHERS:
            self.total += _nbytes((args[1:], kwargs)) + 2 * _nbytes(out)
        else:
            self.total += _nbytes((args, kwargs, out))
        return out


def _meta(tree):
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), tree)


def _shapes(tree):
    return tree_map(lambda t: ShapeDtype(tuple(t.shape), t.dtype)
                    if isinstance(t, torch.Tensor) else None, tree)


def count_step(cell, args=None) -> dict:
    """FLOPs and unfused bytes of one global step on meta tensors (made
    from ``args``, by default ``cell.args``), and the step's output
    shapes."""
    args = _meta(cell.args if args is None else args)
    with FlopCounterMode(display=False) as flops, BytesCounter() as nbytes:
        out = cell.step(*args)
    return dict(flops=float(flops.get_total_flops()),
                bytes=float(nbytes.total), out=_shapes(out))


def _spec_at(specs, path):
    for key in path:
        if specs is None or getattr(type(specs), "_tree_leaf", False):
            break
        specs = (getattr(specs, key) if isinstance(key, str)
                 and not isinstance(specs, dict) else specs[key])
    return specs if getattr(type(specs), "_tree_leaf", False) else None


def rank_bytes(shapes, specs, mesh) -> int:
    """Bytes one rank holds of a ``ShapeDtype`` tree laid out by ``specs``
    (a leaf without a spec is replicated)."""
    sizes = mesh_lib.axis_sizes(mesh)
    total = 0
    for path, s in tree_flatten_with_path(shapes):
        if s is None:
            continue
        block = shard_shape(s.shape, _spec_at(specs, path), sizes)
        total += math.prod(block) * s.dtype.itemsize
    return total


def _route_peak(family: str) -> tuple[float, str]:
    if family == "lm":
        return mesh_lib.PEAK_FLOPS_BF16, "bf16 tensor cores"
    if family == "pdasc":
        return mesh_lib.PEAK_FLOPS_3XTF32, "3xTF32 tensor cores"
    return mesh_lib.PEAK_FLOPS_FP32, "fp32 CUDA cores"


def _pdasc_build_counts(cell, mesh) -> dict:
    """The build's analytic counts: its distance-matrix FLOPs (``meta``),
    and bytes of each group's points read once and its [gl, gl] matrix
    written and read once; the output is the stacked index."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import pdasc_index_shapes

    cfg = get_arch(cell.arch).config_fn()
    n_shards = mesh.size()
    per, gl = cfg.n // n_shards, cfg.gl
    nbytes, level_n = 0.0, per
    while True:
        G = -(-level_n // gl)
        nbytes += G * (4.0 * gl * cfg.d + 8.0 * gl * gl)
        level_n = G * (gl // 2)
        if G == 1:
            break
    return dict(flops=float(cell.meta["model_flops"]),
                bytes=nbytes * n_shards,
                out=pdasc_index_shapes(per, cfg.d, gl, n_shards))


_COUNTS: dict = {}  # (arch, shape, variant[, ranks]) -> counts of the step


def _counts(arch, shape, variant, cell, mesh) -> tuple[dict, dict]:
    """The global step's counts (each made once a process) and the probe
    record."""
    from repro_torch.launch.steps import (build_cell, needs_probe,
                                          probe_trip_count)

    if needs_probe(arch):
        key = (arch, shape, variant)
        if key not in _COUNTS:
            L = probe_trip_count(arch)
            c1 = count_step(build_cell(arch, shape, mesh, 1, variant))
            c2 = count_step(build_cell(arch, shape, mesh, 2, variant))
            _COUNTS[key] = (L, c1, c2)
        L, c1, c2 = _COUNTS[key]

        def extr(a1, a2):
            return max(a1, a1 + (L - 1) * (a2 - a1))

        counts = dict(flops=extr(c1["flops"], c2["flops"]),
                      bytes=extr(c1["bytes"], c2["bytes"]))
        o1 = rank_bytes(c1["out"], cell.out_specs, mesh)
        o2 = rank_bytes(c2["out"], cell.out_specs, mesh)
        counts["out_rank_bytes"] = int(extr(o1, o2))
        probe = dict(n_layers=L,
                     probe1=dict(flops=c1["flops"], bytes=c1["bytes"]),
                     probe2=dict(flops=c2["flops"], bytes=c2["bytes"]),
                     corrected=dict(flops=counts["flops"],
                                    bytes=counts["bytes"]))
        return counts, probe
    if cell.kind == "build":  # PDASC: analytic
        counts = _pdasc_build_counts(cell, mesh)
        probe = dict(analytic=True)
    elif cell.kind == "search":  # PDASC: one shard's search, times ranks
        key = (arch, shape, variant, mesh.size())
        if key not in _COUNTS:
            index, queries = cell.args
            one = tree_map(lambda s: ShapeDtype((1,) + s.shape[1:], s.dtype),
                           index)
            c = count_step(cell, (one, queries))
            _COUNTS[key] = dict(c, flops=c["flops"] * mesh.size(),
                                bytes=c["bytes"] * mesh.size())
        counts, probe = dict(_COUNTS[key]), dict(shards_alike=True)
    else:
        key = (arch, shape, variant)
        if key not in _COUNTS:
            _COUNTS[key] = count_step(cell)
        counts, probe = dict(_COUNTS[key]), None
    counts["out_rank_bytes"] = rank_bytes(counts.pop("out"), cell.out_specs,
                                          mesh)
    return counts, probe


def run_cell(arch: str, shape: str, mesh_kind: str, variant: str = "base",
             *, mesh=None) -> dict:
    """One cell's record (the module doc). ``mesh`` (a ``MeshShape``)
    replaces ``mesh_kind``'s production mesh."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_cell

    if mesh is None:
        mesh = mesh_lib.make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_chips = mesh.size()
    t0 = time.time()
    cell = build_cell(arch, shape, mesh, variant=variant)
    t_build = time.time() - t0
    counts, probe = _counts(arch, shape, variant, cell, mesh)
    t_count = time.time() - t0 - t_build

    flops_dev = counts["flops"] / n_chips
    bytes_dev = counts["bytes"] / n_chips
    arg_bytes = rank_bytes(cell.args, cell.in_specs, mesh)
    donated = sum(rank_bytes(cell.args[i], cell.in_specs[i], mesh)
                  for i in cell.donate)
    out_bytes = counts["out_rank_bytes"]
    mem = dict(
        argument_size_in_bytes=arg_bytes,
        output_size_in_bytes=out_bytes,
        alias_size_in_bytes=min(donated, out_bytes),
        temp_size_in_bytes=None,  # no counterpart on meta
        peak_memory_in_bytes=None,
        hbm_bytes=mesh_lib.HBM_BYTES,
    )
    mem["fits_hbm"] = bool(arg_bytes + out_bytes - mem["alias_size_in_bytes"]
                           <= mesh_lib.HBM_BYTES)

    peak, route = _route_peak(get_arch(arch).family)
    terms = dict(compute_s=flops_dev / peak,
                 memory_s=bytes_dev / mesh_lib.HBM_BW)
    bottleneck = max(terms, key=terms.get)
    model_flops = float(cell.meta.get("model_flops", 0.0))
    flops_total = flops_dev * n_chips
    return dict(
        arch=arch, shape=shape, mesh=mesh_kind, kind=cell.kind,
        variant=variant, n_chips=int(n_chips), ok=True,
        device=mesh_lib.DEVICE_NAME,
        lower_s=round(t_build, 3), compile_s=round(t_count, 3),
        cost_analysis={"flops": flops_dev, "bytes accessed": bytes_dev,
                       "bytes_kind": BYTES_KIND},
        memory_analysis=mem,
        collectives=None,
        probe=probe,
        roofline=dict(
            **terms, collective_s=None, bottleneck=bottleneck,
            peak_flops=peak, route=route, hbm_bw=mesh_lib.HBM_BW,
            model_flops=model_flops,
            hlo_flops_per_device=flops_dev,
            hlo_flops_total=flops_total,
            useful_flops_ratio=(model_flops / flops_total
                                if flops_total else None),
            step_time_lower_bound_s=max(terms.values()),
        ),
        meta={k: (float(v) if isinstance(v, (int, float)) else v)
              for k, v in cell.meta.items()},
    )


def main(argv=None) -> int:
    args = _parse_args(argv)
    from repro_torch.configs import all_cells

    if args.list:
        for a, s in all_cells():
            print(f"{a:24s} {s}")
        return 0

    cells = all_cells()
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    if not cells:
        raise SystemExit("no matching cells")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    os.makedirs(args.out, exist_ok=True)
    n_ok = n_fail = 0
    suffix = "" if args.variant == "base" else f"__{args.variant}"
    for arch, shape in cells:
        for mk in meshes:
            path = os.path.join(args.out, f"{arch}__{shape}__{mk}{suffix}.json")
            if args.skip_existing and os.path.exists(path):
                print(f"[skip] {arch} x {shape} x {mk}")
                continue
            print(f"[dryrun] {arch} x {shape} x {mk} ...", flush=True)
            try:
                res = run_cell(arch, shape, mk, variant=args.variant)
                n_ok += 1
                r, m = res["roofline"], res["memory_analysis"]
                print(f"  ok: count={res['compile_s']:.2f}s "
                      f"flops/rank={res['cost_analysis']['flops']:.3e} "
                      f"bottleneck={r['bottleneck']} "
                      f"lb={r['step_time_lower_bound_s'] * 1e3:.3f}ms "
                      f"args/rank={m['argument_size_in_bytes'] / 2**30:.3f}GiB "
                      f"fits_hbm={m['fits_hbm']}", flush=True)
            except Exception as e:  # recorded in the cell's JSON
                n_fail += 1
                res = dict(arch=arch, shape=shape, mesh=mk, ok=False,
                           error=f"{type(e).__name__}: {e}",
                           traceback=traceback.format_exc()[-4000:])
                print(f"  FAIL: {type(e).__name__}: {e}", flush=True)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
    print(f"\ndry-run complete: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
