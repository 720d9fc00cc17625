"""The port's slice as a whole against ``repro``, on the CPU: an index built
by one package is saved in ``repro``'s artifact format, loaded by the other
(``PDASCIndex.load`` -> ``from_arrays``), and both packages answer the same
queries on the identical index.

Tolerance: fp32 values within rtol = 1e-5 and atol = 1e-5 * max(1,
max|ref|) (the packages sum in another order); ids equal except among
entries whose distances lie within that tolerance of each other. The radius
sits in a wide gap of the query-to-prototype distances, so that a
last-ulp difference cannot flip a ``d < r`` test between the packages.
"""

import ast
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.baselines import exact_knn as j_exact_knn
from repro.core import distances as jdl
from repro.core.index import PDASCIndex as JIndex
from repro.data import synthetic as jsyn
from repro.query import Query as JQuery
from repro_torch.baselines import exact_knn
from repro_torch.core import nsa
from repro_torch.core.index import PDASCIndex
from repro_torch.data import synthetic
from repro_torch.query import Query

BIG = 1e30
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests are small, and the suite's other
    workers (some running 8-device JAX subprocesses) share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(want) -> float:
    want = np.asarray(want, np.float64)
    real = np.abs(want[np.abs(want) < BIG / 2])
    return 1e-5 * max(1.0, float(real.max()) if real.size else 1.0)


def assert_results_agree(got, want, *, squared=False):
    """``squared`` compares l2 distances squared: the Gram form's
    cancellation error is absolute in d^2, and the square root amplifies it
    near zero."""
    gd, wd = np.asarray(got.dists, np.float64), np.asarray(want.dists, np.float64)
    gi, wi = np.asarray(got.ids), np.asarray(want.ids)
    real = wd < BIG / 2
    assert np.array_equal(real, gd < BIG / 2)
    a, b = (gd * gd, wd * wd) if squared else (gd, wd)
    np.testing.assert_allclose(np.where(real, a, 0), np.where(real, b, 0),
                               rtol=1e-5, atol=_tol(np.where(real, b, BIG)))
    atol = _tol(wd)
    for q in range(wd.shape[0]):
        row = wd[q][real[q]]
        for p in np.nonzero((gi[q] != wi[q]) & real[q])[0]:
            assert (np.abs(row - wd[q, p]) <= atol).sum() > 1 \
                or p == row.size - 1, (q, p, gi[q], wi[q])
    np.testing.assert_array_equal(np.asarray(got.n_candidates),
                                  np.asarray(want.n_candidates))


def _gap_radius(levels, distance, Q, quantile=0.5, min_gap=5e-3):
    """A radius in a wide gap of the query-to-prototype distances."""
    ds = []
    for pts, valid in levels:
        D = np.asarray(jdl.get(distance).pairwise(jnp.asarray(Q),
                                                  jnp.asarray(pts)))
        ds.append(D[:, valid].ravel())
    ds = np.unique(np.concatenate(ds))
    gaps = np.diff(ds)
    for j in range(int(len(ds) * quantile), len(gaps)):
        if gaps[j] > min_gap:
            return float((ds[j] + ds[j + 1]) / 2)
    return float(ds[-1] + 1.0)


def _data(distance, n, seed):
    rng = np.random.default_rng(seed)
    if distance == "haversine":
        return jsyn.geo_clusters(n=n, seed=seed)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    return np.abs(x) if distance == "jaccard" else x


def _save_load(src, tmp_path, load):
    path = str(tmp_path / "idx")
    src.save(path)
    return load(path)


def _levels(idx):
    return [(np.asarray(lv.points), np.asarray(lv.valid))
            for lv in idx.data.levels]


def test_repro_built_index_searches_identically(tmp_path):
    """repro builds and saves; the port loads through from_arrays and both
    run the beam plan (execution="auto") and the dense plan."""
    data = _data("euclidean", 500, seed=1)
    jidx = JIndex.build(data, gl=32, distance="euclidean", radius_quantile=0.3)
    tidx = _save_load(jidx, tmp_path,
                      lambda p: PDASCIndex.load(p, device="cpu"))
    assert tidx.stats == jidx.stats and tidx.max_children == jidx.max_children
    Q = _data("euclidean", 540, seed=1)[500:]
    r = _gap_radius(_levels(jidx), "euclidean", Q)
    for execution in ("auto", "dense"):
        want = jidx.plan(JQuery(k=10, radius=r, execution=execution))(Q)
        got = tidx.plan(Query(k=10, radius=r, execution=execution))(Q)
        assert_results_agree(got, want, squared=True)


@pytest.mark.parametrize("distance", ["manhattan", "chebyshev", "cosine",
                                      "haversine", "jaccard"])
def test_port_built_index_searches_identically(distance, tmp_path):
    """The port builds and saves in repro's format; repro loads it; beam
    (kernel distances) and dense plans agree on the identical index."""
    data = _data(distance, 500, seed=2)
    tidx = PDASCIndex.build(data, gl=32, distance=distance,
                            radius_quantile=0.3, device="cpu")
    jidx = _save_load(tidx, tmp_path, JIndex.load)
    Q = _data(distance, 530, seed=2)[500:]
    r = _gap_radius(_levels(jidx), distance, Q)
    executions = (["dense"] if distance in ("haversine", "jaccard")
                  else ["auto", "dense"])
    for execution in executions:
        want = jidx.plan(JQuery(k=10, radius=r, execution=execution))(Q)
        got = tidx.plan(Query(k=10, radius=r, execution=execution))(Q)
        assert_results_agree(got, want, squared=distance == "euclidean")


@pytest.mark.parametrize("distance", ["euclidean", "manhattan", "cosine"])
def test_full_width_beam_equals_dense(distance):
    """Inside the port, a beam as wide as every level returns the dense
    search's result (DESIGN.md §3.2)."""
    data = _data(distance, 400, seed=3)
    idx = PDASCIndex.build(data, gl=32, distance=distance,
                           radius_quantile=0.4, device="cpu")
    Q = torch.from_numpy(data[:15] + 0.01)
    dense = nsa.search_dense(idx.data, Q, dist=idx.distance, k=7,
                             r=idx.default_radius)
    beam = nsa.search_beam(idx.data, Q, dist=idx.distance, k=7,
                           r=idx.default_radius, beam=100_000,
                           max_children=idx.max_children)
    assert_results_agree(beam, dense, squared=distance == "euclidean")
    single = nsa.search_beam(idx.data, Q[0], dist=idx.distance, k=7,
                             r=idx.default_radius, beam=100_000,
                             max_children=idx.max_children)
    assert single.ids.shape == (7,)
    assert torch.equal(single.ids, beam.ids[0])


def test_dense_search_in_query_chunks_equals_one_batch(monkeypatch):
    """``search_dense`` bounds its level matrices by running the queries in
    chunks; the chunks' results are the whole batch's, bit for bit."""
    data = _data("euclidean", 400, seed=5)
    idx = PDASCIndex.build(data, gl=32, radius_quantile=0.4, device="cpu")
    Q = torch.from_numpy(data[:23] + 0.01)
    whole = nsa.search_dense(idx.data, Q, dist=idx.distance, k=7,
                             r=idx.default_radius)
    monkeypatch.setattr(nsa, "DENSE_CHUNK_ENTRIES", 5 * 400)  # 5 queries
    chunked = nsa.search_dense(idx.data, Q, dist=idx.distance, k=7,
                               r=idx.default_radius)
    for a, b in zip(chunked, whole):
        assert torch.equal(a, b)


def test_exact_knn_matches_repro():
    rng = np.random.default_rng(4)
    Q, DB = rng.normal(size=(12, 6)), rng.normal(size=(700, 6))
    for distance in ("euclidean", "haversine"):
        q, db = (Q[:, :2], DB[:, :2]) if distance == "haversine" else (Q, DB)
        gd, gi = exact_knn(q, db, distance=distance, k=5, device="cpu", chunk=5)
        wd, wi = j_exact_knn(q, db, distance=distance, k=5)
        np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5,
                                   atol=_tol(wd))
        assert np.array_equal(gi.numpy(), np.asarray(wi))


def test_save_load_roundtrip_and_unported_formats(tmp_path):
    data = _data("euclidean", 200, seed=5)
    idx = PDASCIndex.build(data, gl=32, device="cpu")
    path = str(tmp_path / "a")
    idx.save(path)
    back = PDASCIndex.load(path, device="cpu")
    assert back.stats == idx.stats and back.default_radius == idx.default_radius
    for a, b in zip(idx.data.levels, back.data.levels):
        assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields)
    meta = json.load(open(path + ".json"))
    assert meta["version"] == 2 and meta["mutable"] is None
    # version 5 reads too (a remote payload manifest when the store has one;
    # this artifact has no store, so it loads as it is, as in repro)
    json.dump(dict(meta, version=5), open(path + ".json", "w"))
    v5 = PDASCIndex.load(path, device="cpu")
    assert v5.store is None and not v5._payload_released
    # the online tiers (v3) now load: an empty delta and no tombstones
    json.dump(dict(meta, version=3, mutable=dict(
        delta_capacity=16, delta_size=0, next_id=500)),
        open(path + ".json", "w"))
    online = PDASCIndex.load(path, device="cpu")
    assert online.delta.capacity == 16 and online.tombstones.count == 0
    assert online._seen_id_ceiling() == 500
    json.dump(dict(meta, version=99), open(path + ".json", "w"))
    with pytest.raises(ValueError, match="unsupported"):
        PDASCIndex.load(path, device="cpu")


def test_query_surface():
    idx = PDASCIndex.build(_data("euclidean", 120, seed=6), gl=24, device="cpu")
    plan = idx.plan(Query(k=3))
    assert plan.pipeline == "beam" and idx.plan(Query(k=3)) is plan
    assert "rank_gathered" in plan.explain()
    assert idx.plan(k=3, execution="dense").pipeline == "dense"
    assert idx.plan(k=3, execution="beam_vmap").pipeline == "beam_vmap"
    with pytest.raises(ValueError, match="compile_sharded_plan"):
        idx.plan(Query(execution="sharded"))
    with pytest.raises(ValueError, match="needs a leaf store"):
        idx.plan(Query(execution="two_stage"))
    with pytest.raises(ValueError, match="non-finite"):
        plan(np.full((2, 8), np.nan, np.float32))
    with pytest.raises(ValueError, match="does not match"):
        plan(np.zeros((2, 5), np.float32))
    res = idx.search(np.zeros(8, np.float32), k=3)
    assert res.ids.shape == (3,) and "level 0: 120 valid" in idx.describe()


@pytest.mark.parametrize("distance", ["euclidean", "cosine"])
def test_beam_vmap_equals_repro_and_the_batched_beam(distance, tmp_path):
    """The seed per-query beam on a repro-built index: equal to repro's
    search_beam_vmap (dists within the rule, ids modulo near-ties, the
    same candidate counts), and to the port's batched beam, through the
    plan and directly, with and without the leaf radius filter."""
    from repro.core import nsa as jnsa

    data = _data(distance, 500, seed=7)
    jidx = JIndex.build(data, gl=32, distance=distance, radius_quantile=0.3)
    tidx = _save_load(jidx, tmp_path,
                      lambda p: PDASCIndex.load(p, device="cpu"))
    Q = _data(distance, 530, seed=7)[500:]
    r = _gap_radius(_levels(jidx), distance, Q)
    for beam, lrf in ((4, False), (16, True)):
        want = jnsa.search_beam_vmap(
            jidx.data, jnp.asarray(Q), dist=jidx.distance, k=6, r=r,
            beam=beam, max_children=jidx.max_children, leaf_radius_filter=lrf)
        got = nsa.search_beam_vmap(
            tidx.data, torch.from_numpy(Q), dist=tidx.distance, k=6, r=r,
            beam=beam, max_children=tidx.max_children, leaf_radius_filter=lrf)
        assert_results_agree(got, want, squared=distance == "euclidean")
        planned = tidx.plan(Query(k=6, radius=r, beam=beam,
                                  leaf_radius_filter=lrf,
                                  execution="beam_vmap"))(Q)
        assert all(torch.equal(a, b) for a, b in zip(planned, got))
        batched = tidx.plan(Query(k=6, radius=r, beam=beam,
                                  leaf_radius_filter=lrf))(Q)
        assert_results_agree(batched, got, squared=distance == "euclidean")
    one = nsa.search_beam_vmap(tidx.data, torch.from_numpy(Q[0]),
                               dist=tidx.distance, k=6, r=r, beam=4,
                               max_children=tidx.max_children)
    assert one.ids.shape == (6,)


def test_plan_stats_count_as_repro():
    """plan_stats() after the same sequence of plan calls: compiles, cache
    hits, re-plans of a stale plan, and executions per pipeline."""
    from repro.query import plan_stats as j_plan_stats
    from repro.query import reset_plan_stats as j_reset_plan_stats
    from repro_torch.query import plan_stats, reset_plan_stats

    data = _data("euclidean", 300, seed=8)
    Q = data[:4] + 0.01
    for make, stats, reset, query in (
            (lambda: JIndex.build(data, gl=24), j_plan_stats,
             j_reset_plan_stats, JQuery),
            (lambda: PDASCIndex.build(data, gl=24, device="cpu"), plan_stats,
             reset_plan_stats, Query)):
        idx = make()
        reset()
        beam = idx.plan(query(k=3))
        beam(Q)
        idx.plan(query(k=3))(Q)  # a cache hit
        idx.plan(query(k=3, execution="dense"))(Q)
        idx.plan(query(k=3, execution="beam_vmap"))(Q)
        idx.upsert(Q[:1] + 1.0)
        beam(Q)  # stale: re-plans
        idx.delete([0])
        idx.plan(query(k=3))(Q)
        if query is JQuery:
            want = stats()
        else:
            got = stats()
    assert got == want
    assert got["beam"] == dict(compiles=3, cache_hits=1, replans=1,
                               executions=4)


def test_per_level_radii_equal_repro(tmp_path):
    data = _data("manhattan", 400, seed=9)
    jidx = JIndex.build(data, gl=24, distance="manhattan")
    tidx = _save_load(jidx, tmp_path,
                      lambda p: PDASCIndex.load(p, device="cpu"))
    for q in (0.5, 0.9):
        np.testing.assert_allclose(tidx.per_level_radii(quantile=q),
                                   jidx.per_level_radii(quantile=q),
                                   rtol=1e-5)


@pytest.mark.parametrize("name", synthetic.dataset_names())
def test_synthetic_bit_identical(name):
    for seed in (0, 3):
        a = synthetic.make_dataset(name, n=500, seed=seed)
        b = jsyn.make_dataset(name, n=500, seed=seed)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_exact_knn_needs_a_gpu_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        exact_knn(np.zeros((2, 3)), np.zeros((5, 3)), k=2)


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
