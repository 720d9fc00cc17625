"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU: cells
built over the production ``MeshShape`` and costed on the meta device,
with no process group and no fake devices.

``repro``'s own dry-run tests (``tests/test_dryrun_cells.py``) lower six
cells and a probe on a 16-device mesh in subprocesses; here the same six
cells and the same probe run on the production meshes in process. The
probe's extrapolation is held to a full-depth count of one LM cell within
rtol 1e-6, the byte counter to a hand count, and the CLI to its listing
and its JSON record.
"""

import json
import math

import pytest
import torch

from repro_torch._spec import PSpec, ShapeDtype
from repro_torch.configs import all_cells
from repro_torch.launch import dryrun, steps
from repro_torch.launch import mesh as mesh_lib

SIX = [("granite-3-2b", "train_4k", "single"),
       ("deepseek-moe-16b", "decode_32k", "multi"),
       ("egnn", "minibatch_lg", "single"),
       ("din", "serve_p99", "multi"),
       ("autoint", "train_batch", "single"),
       ("pdasc", "search_1m", "single")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch, shape, mesh_kind", SIX)
def test_cells_cost_on_meta(arch, shape, mesh_kind):
    res = dryrun.run_cell(arch, shape, mesh_kind)
    assert res["ok"] and res["n_chips"] == (256 if mesh_kind == "single"
                                            else 512)
    assert res["cost_analysis"]["flops"] > 0, (arch, shape)
    assert res["cost_analysis"]["bytes accessed"] > 0
    r = res["roofline"]
    assert r["step_time_lower_bound_s"] > 0
    assert r["step_time_lower_bound_s"] == max(r["compute_s"], r["memory_s"])
    assert r["collective_s"] is None and res["collectives"] is None
    m = res["memory_analysis"]
    assert m["argument_size_in_bytes"] > 0 and m["output_size_in_bytes"] > 0
    assert m["temp_size_in_bytes"] is None and m["fits_hbm"]


def test_probe_extrapolation_monotone():
    res = dryrun.run_cell("stablelm-1.6b", "train_4k", "single")
    p = res["probe"]
    assert p is not None and p["n_layers"] == 24
    # two layers cost more than one; the corrected count more than two
    assert p["probe2"]["flops"] > p["probe1"]["flops"]
    assert p["corrected"]["flops"] > p["probe2"]["flops"]
    assert res["cost_analysis"]["flops"] * res["n_chips"] == pytest.approx(
        p["corrected"]["flops"], rel=1e-12)
    # within 3x of the analytic 6*N*D
    model = res["meta"]["model_flops"]
    ratio = model / (p["corrected"]["flops"])
    assert 0.2 < ratio < 3.0, ratio


def test_extrapolation_equals_a_full_depth_count():
    mesh = mesh_lib.make_production_mesh()
    res = dryrun.run_cell("stablelm-1.6b", "decode_32k", "single")
    full = dryrun.count_step(steps.build_cell("stablelm-1.6b", "decode_32k",
                                              mesh))
    n = res["n_chips"]
    assert res["cost_analysis"]["flops"] * n == pytest.approx(
        full["flops"], rel=1e-6)
    assert res["cost_analysis"]["bytes accessed"] * n == pytest.approx(
        full["bytes"], rel=1e-6)
    cell = steps.build_cell("stablelm-1.6b", "decode_32k", mesh)
    assert res["memory_analysis"]["output_size_in_bytes"] == \
        dryrun.rank_bytes(full["out"], cell.out_specs, mesh)


def test_production_mesh_shapes():
    m1 = mesh_lib.make_production_mesh()
    assert m1.mesh_dim_names == ("data", "model") and m1.shape == (16, 16)
    m2 = mesh_lib.make_production_mesh(multi_pod=True)
    assert m2.mesh_dim_names == ("pod", "data", "model")
    assert m2.shape == (2, 16, 16) and m2.size() == 512
    assert mesh_lib.batch_axes_of(m2) == ("pod", "data")
    assert mesh_lib.all_axes_of(m1) == ("data", "model")
    assert mesh_lib.axis_sizes(m2) == dict(pod=2, data=16, model=16)


def test_bytes_counter_and_rank_bytes():
    a = torch.empty(64, 32, device="meta")
    b = torch.empty(32, 16, device="meta")
    with dryrun.BytesCounter() as c:
        a.t().contiguous()  # a view (free), then a copy: read + write
        a @ b
    assert c.total == 2 * 64 * 32 * 4 + (64 * 32 + 32 * 16 + 64 * 16) * 4
    shapes = dict(w=ShapeDtype((64, 32), torch.float32),
                  s=ShapeDtype((), torch.int32))
    specs = dict(w=PSpec("data", "model"), s=PSpec())
    mesh = mesh_lib.make_production_mesh()
    assert dryrun.rank_bytes(shapes, specs, mesh) == 4 * 2 * 4 + 4
    assert dryrun.rank_bytes(shapes, None, mesh) == 64 * 32 * 4 + 4


def test_cli_lists_and_writes(tmp_path, capsys):
    assert dryrun.main(["--list"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(all_cells()) == 42
    assert dryrun.main(["--arch", "din", "--shape", "serve_p99", "--out",
                        str(tmp_path)]) == 0
    assert "dry-run complete: 2 ok, 0 failed" in capsys.readouterr().out
    for mk in ("single", "multi"):
        res = json.loads((tmp_path / f"din__serve_p99__{mk}.json").read_text())
        assert {"arch", "shape", "mesh", "kind", "n_chips", "ok", "lower_s",
                "compile_s", "cost_analysis", "memory_analysis",
                "collectives", "probe", "roofline", "meta"} <= set(res)
        assert res["ok"] and res["mesh"] == mk
        assert res["cost_analysis"]["bytes_kind"] == dryrun.BYTES_KIND
        assert res["device"] == "H100 80GB HBM3, 700 W"
        assert math.isfinite(res["roofline"]["step_time_lower_bound_s"])
