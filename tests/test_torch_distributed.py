"""The distributed deployment of the port (``repro_torch.core.distributed``,
``repro_torch.launch.mesh``, ``ShardedPlan``) against ``repro``'s.

The port runs one rank per process: each case below reads the outputs of
one 8-rank run (``gloo`` subprocesses through ``launch.ranks.run_ranks``, a
``file://`` group under the test's temporary directory, one thread each) on
a ``(4, 2)`` mesh ``("data", "model")``, and one 3-rank run for the
butterfly's refusal. ``repro``'s outputs come from one 8-fake-device
subprocess (``conftest.run_in_devices``) that writes them as ``.npz``:
its exact k-NN merge, its stacked sharded index (carried across shard by
shard with ``local_index_from_stacked``), and its sharded plans, dense and
beam, with and without per-shard tombstone masks.

Tolerances are the port's: distances within rtol = atol = 1e-5 (atol
scaled by the largest distance), ids equal except at near-ties.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch.core import distributed as dd
from repro_torch.core import msa
from repro_torch.core.distances import BIG
from repro_torch.core.index import PDASCIndex
from repro_torch.core.reference_impl import check_index_invariants
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.launch.mesh import all_axes_of, batch_axes_of, make_mesh
from repro_torch.launch.ranks import run_ranks
from repro_torch.query import Query, compile_sharded_plan
from repro_torch.store import LeafStore

HERE = os.path.abspath(__file__)
P_DATA, P_MODEL = 4, 2
N_SHARDED, GL = 1600, 50
PER = N_SHARDED // P_DATA
SCAN_N, SCAN_BLOCK = 1024, 32
MODES = [(m, masked) for m in ("dense", "beam") for masked in (False, True)]

REPRO_SCRIPT = """
import json
import numpy as np, jax.numpy as jnp
from repro.core import distributed as dd, distances as dl, radius as rl
from repro.launch.mesh import make_mesh
from repro.query import Query, compile_sharded_plan

mesh = make_mesh((4, 2), ("data", "model"))
rng = np.random.default_rng(0)
db = rng.normal(size=(1600, 16)).astype(np.float32)
q = rng.normal(size=(8, 16)).astype(np.float32)
out = dict(knn_db=db, knn_q=q)
gd, gi = dd.exact_knn_sharded(jnp.asarray(db), jnp.asarray(q), mesh,
                              db_axes=("data",), distance="l2", k=10)
out.update(jknn_d=np.asarray(gd), jknn_i=np.asarray(gi))
rng = np.random.default_rng(1)
sdb = rng.normal(size=(1600, 12)).astype(np.float32)
sq = rng.normal(size=(16, 12)).astype(np.float32)
sidx = dd.build_sharded(jnp.asarray(sdb), mesh, db_axes=("data",), gl=50,
                        distance="euclidean")
r = float(rl.estimate_radius(jnp.asarray(sdb), dl.get("euclidean"),
                             quantile=0.85))
mc = (0,) + tuple(int(np.max(np.asarray(lv.child_count)))
                  for lv in sidx.levels[1:])
dead = np.random.default_rng(2).choice(1600, size=160, replace=False)
leaf_ids = np.asarray(sidx.leaf_ids)
sv = np.ones(leaf_ids.shape, bool)
for s, rows in dd.route_writes(dead, 4, 400):
    sv[s] = dd.local_slot_valid(leaf_ids[s], rows)
out.update(sdb=sdb, sq=sq, r=np.float64(r), mc=np.array(mc), dead=dead,
           sv=sv, sidx_leaf_ids=leaf_ids)
for l, lv in enumerate(sidx.levels):
    for f in lv._fields:
        out[f"sidx_level{l}_{f}"] = np.asarray(getattr(lv, f))
descs = {}
for mode in ("dense", "beam"):
    plan = compile_sharded_plan(mesh, Query(k=10, radius=r, execution=mode),
                                dist="euclidean", max_children=mc)
    descs[mode] = plan.describe()
    for masked in (0, 1):
        res = plan(sidx, jnp.asarray(sq),
                   slot_valid=jnp.asarray(sv) if masked else None)
        for f in ("dists", "ids", "n_candidates"):
            out[f"j_{mode}_{masked}_{f}"] = np.asarray(getattr(res, f))
np.savez(OUT + ".npz", **out)
json.dump(descs, open(OUT + ".json", "w"))
"""


def _tol(want) -> float:
    want = np.asarray(want, np.float64)
    real = np.abs(want[np.abs(want) < BIG / 2])
    return 1e-5 * max(1.0, float(real.max()) if real.size else 1.0)


def assert_topk_agree(gd, gi, wd, wi):
    """Distances within the tolerance, ids equal except at near-ties."""
    gd, wd = np.asarray(gd, np.float64), np.asarray(wd, np.float64)
    gi, wi = np.asarray(gi), np.asarray(wi)
    real = wd < BIG / 2
    assert np.array_equal(real, gd < BIG / 2)
    atol = _tol(wd)
    np.testing.assert_allclose(np.where(real, gd, 0), np.where(real, wd, 0),
                               rtol=1e-5, atol=atol)
    for q in range(wd.shape[0]):
        row = wd[q][real[q]]
        for p in np.nonzero((gi[q] != wi[q]) & real[q])[0]:
            assert (np.abs(row - wd[q, p]) <= atol).sum() > 1 \
                or p == row.size - 1, (q, p, gi[q], wi[q])


# ---------------------------------------------------------------------------
# the rank processes
# ---------------------------------------------------------------------------


def _np(res):
    return tuple(t.numpy() for t in res)


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def ranks_main(rank, world, *, ref):
    """One rank of the 8-rank run: every case, its outputs as numpy."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh

    z = dict(np.load(ref))
    mesh = make_mesh((P_DATA, P_MODEL), ("data", "model"))
    out = dict(batch_axes=batch_axes_of(mesh), all_axes=all_axes_of(mesh))
    shard = dd.shard_index(mesh, ("data",))
    out["shard"] = shard

    # exact k-NN merges: one axis (P = 4) and two (P = 8), both methods
    for axes in (("data",), ("data", "model")):
        for merge in ("butterfly", "allgather"):
            out[f"knn_{len(axes)}_{merge}"] = _np(dd.exact_knn_sharded(
                z["knn_db"], z["knn_q"], mesh, db_axes=axes, distance="l2",
                k=10, merge=merge, device="cpu"))
    # permutation invariance on an (8,) mesh over the same ranks
    flat = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("data",))
    rng = np.random.default_rng(2)
    db8 = rng.normal(size=(800, 8)).astype(np.float32)
    q8 = rng.normal(size=(4, 8)).astype(np.float32)
    perm = rng.permutation(800)
    out["perm"] = perm
    out["knn8"] = _np(dd.exact_knn_sharded(db8, q8, flat, k=7, device="cpu"))
    out["knn8_perm"] = _np(dd.exact_knn_sharded(db8[perm], q8, flat, k=7,
                                                device="cpu"))

    # repro's stacked index, this rank's shard, searched and planned
    stacked = {k[5:]: v for k, v in z.items() if k.startswith("sidx_")}
    local = dd.local_index_from_stacked(stacked, shard, device="cpu")
    r, mc = float(z["r"]), tuple(int(c) for c in z["mc"])
    out["max_children"] = dd.max_children_sharded(local, mesh)
    groups0 = len(tdist.distributed_c10d._world.pg_map)
    descs = {}
    for mode, masked in MODES:
        sv = torch.from_numpy(z["sv"][shard]) if masked else None
        out[f"search_{mode}_{int(masked)}"] = _np(dd.search_sharded(
            local, z["sq"], mesh, dist="euclidean", k=10, r=r, mode=mode,
            max_children=mc, slot_valid=sv))
        plan = compile_sharded_plan(mesh, Query(k=10, radius=r,
                                                execution=mode),
                                    dist="euclidean", max_children=mc)
        descs[mode] = plan.describe()
        for _ in range(3):
            got = _np(plan(local, z["sq"], slot_valid=sv))
        out[f"plan_{mode}_{int(masked)}"] = got
    out["descs"] = descs
    out["groups"] = (groups0, len(tdist.distributed_c10d._world.pg_map))

    # the port's own sharded build: rank p against a single build of its rows
    built = dd.build_sharded(z["sdb"], mesh, gl=GL, device="cpu")
    single, _ = msa.build_index_arrays(
        z["sdb"][shard * PER:(shard + 1) * PER], gl=GL,
        generator=dd.shard_generator(0, shard), device="cpu")
    out["build_equal"] = all(
        torch.equal(getattr(a, f), getattr(b, f))
        for a, b in zip(built.levels, single.levels) for f in a._fields
    ) and torch.equal(built.leaf_ids, single.leaf_ids)
    out["invariants"] = check_index_invariants(built)
    out["built"] = _np(dd.search_sharded(built, z["sq"], mesh,
                                         dist="euclidean", k=10, r=r))
    # deletes routed by id: never returned, exact at an infinite radius
    routed = dict(dd.route_writes(z["dead"], P_DATA, PER))
    sv = dd.local_slot_valid(built.leaf_ids.numpy(), routed.get(shard, []))
    out["deleted"] = _np(dd.search_sharded(
        built, z["sdb"][:16], mesh, dist="euclidean", k=10, r=1e9,
        slot_valid=torch.from_numpy(sv)))

    # the sharded payload scan against one rank's scan of the whole table
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(SCAN_N, 16)).astype(np.float32)
    Qs = torch.from_numpy(rng.normal(size=(6, 16)).astype(np.float32))
    ci = torch.from_numpy(rng.integers(0, SCAN_N, (6, 96)).astype(np.int32))
    ok = torch.from_numpy(rng.random((6, 96)) > 0.2)
    live = torch.from_numpy(rng.random(SCAN_N) > 0.1)
    per = SCAN_N // P_DATA
    for backend in ("int8", "int4"):
        store = LeafStore.create(pts, backend, block=SCAN_BLOCK, device="cpu")
        codes, scales = dd.shard_payload(store, mesh)
        out[f"scan_{backend}"] = _np(dd.scan_quantized_sharded(
            codes, scales, Qs, ci, ok, mesh, k=7, block=SCAN_BLOCK,
            slot_valid=live[shard * per:(shard + 1) * per],
            code_format=store.code_format))
        d, slot = kops.scan_quantized(Qs, store.codes, store.scales, ci, ok,
                                      "l2", k=7, block=SCAN_BLOCK,
                                      slot_valid=live,
                                      code_format=store.code_format)
        out[f"scan1_{backend}"] = (d.numpy(), torch.gather(
            ci, 1, slot.long()).numpy())
    out["payload_errors"] = [
        _error(lambda: dd.shard_payload(LeafStore.create(
            pts[:1002], "int8", block=8, device="cpu"), mesh)),
        _error(lambda: dd.shard_payload(LeafStore.create(
            np.resize(pts, (1040, 16)), "int8", block=32, device="cpu"),
            mesh)),
        _error(lambda: dd.shard_payload(LeafStore.create(
            pts, "fp32", block=32, device="cpu"), mesh)),
    ]
    return out


def ranks_three(rank, world):
    """The 3-rank run: the all-gather merge works, the butterfly refuses."""
    mesh = make_mesh((3,), ("data",))
    rng = np.random.default_rng(3)
    db = rng.normal(size=(300, 6)).astype(np.float32)
    q = rng.normal(size=(5, 6)).astype(np.float32)
    return dict(
        allgather=_np(dd.exact_knn_sharded(db, q, mesh, k=4,
                                           merge="allgather", device="cpu")),
        error=_error(lambda: dd.exact_knn_sharded(db, q, mesh, k=4,
                                                  device="cpu")),
        db=db, q=q)


@pytest.fixture(scope="module")
def repro_ref(tmp_path_factory):
    from conftest import run_in_devices

    base = str(tmp_path_factory.mktemp("repro_dist") / "ref")
    run_in_devices(f"OUT = {base!r}\n" + REPRO_SCRIPT, n_devices=8)
    with open(base + ".json") as f:
        descs = json.load(f)
    return base + ".npz", dict(np.load(base + ".npz")), descs


@pytest.fixture(scope="module")
def ranks(repro_ref, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("ranks"))
    return run_ranks(f"{HERE}:ranks_main", P_DATA * P_MODEL, workdir=work,
                     kwargs=dict(ref=repro_ref[0]), timeout=300)


@pytest.fixture(scope="module")
def three(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("ranks3"))
    return run_ranks(f"{HERE}:ranks_three", 3, workdir=work, timeout=120)


# ---------------------------------------------------------------------------
# merges
# ---------------------------------------------------------------------------


def test_merges_equal_repro_and_knn_ref(ranks, repro_ref):
    _, z, _ = repro_ref
    wd, wi = kref.knn_ref(torch.from_numpy(z["knn_q"]),
                          torch.from_numpy(z["knn_db"]), 10, "l2")
    out = ranks[0]
    gd, gi = out["knn_1_butterfly"]
    assert_topk_agree(gd, gi, z["jknn_d"], z["jknn_i"])
    assert_topk_agree(gd, gi, wd.numpy(), wi.numpy())
    for key in ("knn_1_allgather", "knn_2_butterfly", "knn_2_allgather"):
        # the merge key (distance, global id) is a total order
        np.testing.assert_array_equal(out[key][0], gd)
        np.testing.assert_array_equal(out[key][1], gi)


def test_merge_is_permutation_invariant(ranks):
    out = ranks[0]
    d1, i1 = out["knn8"]
    d2, i2 = out["knn8_perm"]
    np.testing.assert_allclose(d1, d2, rtol=1e-5, atol=_tol(d1))
    mapped = out["perm"][i2]
    for q in range(d1.shape[0]):
        assert set(mapped[q].tolist()) == set(i1[q].tolist())


def test_butterfly_refuses_non_power_of_two_axis(three):
    for out in three:
        assert "power-of-two" in out["error"]
    wd, wi = kref.knn_ref(torch.from_numpy(three[0]["q"]),
                          torch.from_numpy(three[0]["db"]), 4, "l2")
    assert_topk_agree(*three[0]["allgather"], wd.numpy(), wi.numpy())


def test_every_rank_returns_identical_results(ranks):
    keys = [k for k, v in ranks[0].items()
            if isinstance(v, tuple) and v and isinstance(v[0], np.ndarray)]
    assert len(keys) >= 16
    for out in ranks[1:]:
        for key in keys:
            for a, b in zip(ranks[0][key], out[key]):
                np.testing.assert_array_equal(a, b, err_msg=key)


def test_mesh_axes_and_shard_index(ranks):
    assert [o["shard"] for o in ranks] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert ranks[0]["batch_axes"] == ("data",)
    assert ranks[0]["all_axes"] == ("data", "model")


# ---------------------------------------------------------------------------
# search on repro's stacked index, and the sharded plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,masked", MODES)
def test_search_on_repro_stacked_index_equals_repro(ranks, repro_ref, mode,
                                                    masked):
    _, z, _ = repro_ref
    gd, gi, gn = ranks[0][f"search_{mode}_{int(masked)}"]
    tag = f"j_{mode}_{int(masked)}"
    assert_topk_agree(gd, gi, z[tag + "_dists"], z[tag + "_ids"])
    np.testing.assert_array_equal(gn, z[tag + "_n_candidates"])
    if masked:
        assert not set(z["dead"].tolist()) & set(gi.ravel().tolist())


def test_sharded_plan_equals_search_sharded_and_repro_describe(ranks,
                                                              repro_ref):
    _, _, jdescs = repro_ref
    out = ranks[0]
    for mode, masked in MODES:
        for a, b in zip(out[f"plan_{mode}_{int(masked)}"],
                        out[f"search_{mode}_{int(masked)}"]):
            np.testing.assert_array_equal(a, b)
    for mode in ("dense", "beam"):
        got, want = dict(out["descs"][mode]), dict(jdescs[mode])
        # each package names its own ops in the lowering text
        assert got.pop("lowering").startswith(
            "per level" if mode == "dense" else "nsa.descend_beam")
        want.pop("lowering")
        assert got == want


def test_repeated_plan_calls_create_no_process_groups(ranks):
    for out in ranks:
        before, after = out["groups"]
        assert before == after


def test_max_children_sharded_equals_the_stacked_bound(ranks, repro_ref):
    _, z, _ = repro_ref
    for out in ranks:
        assert out["max_children"] == tuple(int(c) for c in z["mc"])


def test_compile_plan_points_sharded_queries_to_the_mesh():
    idx = PDASCIndex.build(np.random.default_rng(0).normal(
        size=(64, 4)).astype(np.float32), gl=16, device="cpu")
    with pytest.raises(ValueError, match="compile_sharded_plan"):
        idx.plan(Query(execution="sharded"))
    with pytest.raises(ValueError, match="max_children"):
        compile_sharded_plan(None, Query(execution="beam", radius=1.0),
                             dist="euclidean")
    with pytest.raises(ValueError, match="radius"):
        compile_sharded_plan(None, Query(), dist="euclidean")
    with pytest.raises(ValueError, match="two_stage"):
        compile_sharded_plan(None, Query(execution="two_stage", radius=1.0),
                             dist="euclidean")


# ---------------------------------------------------------------------------
# the sharded build
# ---------------------------------------------------------------------------


def test_build_sharded_rank_equals_its_single_build(ranks):
    for out in ranks:
        assert out["build_equal"]
        assert out["invariants"] == []


def test_build_sharded_recall(ranks, repro_ref):
    _, z, _ = repro_ref
    _, gt = kref.knn_ref(torch.from_numpy(z["sq"]),
                         torch.from_numpy(z["sdb"]), 10, "l2")
    ids, gt = ranks[0]["built"][1], gt.numpy()
    rec = np.mean([len(set(ids[i].tolist()) & set(gt[i].tolist())) / 10
                   for i in range(len(gt))])
    assert rec > 0.9, rec
    assert ((ids >= -1) & (ids < N_SHARDED)).all()


def test_deleted_ids_never_returned_sharded(ranks, repro_ref):
    _, z, _ = repro_ref
    ids = ranks[0]["deleted"][1]
    dead = z["dead"]
    assert not set(dead.tolist()) & set(ids.ravel().tolist())
    # an infinite radius: brute force over the live rows
    data, q = z["sdb"], z["sdb"][:16]
    alive = np.setdiff1d(np.arange(N_SHARDED), dead)
    D = np.linalg.norm(q[:, None, :] - data[None, alive, :], axis=-1)
    gt = alive[np.argsort(D, axis=1)[:, :10]]
    assert np.array_equal(np.sort(ids, 1), np.sort(gt, 1))


# ---------------------------------------------------------------------------
# the sharded payload tier and the write routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["int8", "int4"])
def test_scan_quantized_sharded_equals_one_rank(ranks, backend):
    gd, gi = ranks[0][f"scan_{backend}"]
    wd, wi = ranks[0][f"scan1_{backend}"]
    wi = np.where(wd < BIG / 2, wi, -1)
    assert_topk_agree(gd, gi, wd, wi)


def test_shard_payload_misalignment_errors(ranks):
    divisible, granule, quantised = ranks[0]["payload_errors"]
    assert "not divisible" in divisible
    assert "granule" in granule
    assert "quantised" in quantised


def test_route_writes_and_local_slot_valid_equal_repro():
    from repro.core import distributed as jdd

    rng = np.random.default_rng(11)
    for _ in range(20):
        n_shards = int(rng.integers(1, 9))
        per = int(rng.integers(1, 50))
        ids = rng.integers(0, n_shards * per, int(rng.integers(0, 60)))
        got, want = dd.route_writes(ids, n_shards, per), \
            jdd.route_writes(ids, n_shards, per)
        assert [s for s, _ in got] == [s for s, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        leaf = rng.integers(-1, per, per + 7).astype(np.int32)
        rows = rng.integers(0, per + 3, int(rng.integers(0, 10)))
        np.testing.assert_array_equal(dd.local_slot_valid(leaf, rows),
                                      jdd.local_slot_valid(leaf, rows))
    for fn in (dd.route_writes, jdd.route_writes):
        with pytest.raises(ValueError, match="out of range"):
            fn([0, 40], 4, 10)


def test_payload_placement_equals_repro():
    from repro.core import distributed as jdd

    for args in ((1024, 64, 4), (4096, 256, 8), (256, 256, 1)):
        assert dd.payload_placement(*args) == jdd.payload_placement(*args)
    for args, match in (((100, 10, 3), "divisible"),
                        ((120, 16, 3), "granule-aligned")):
        with pytest.raises(ValueError, match=match):
            dd.payload_placement(*args)
