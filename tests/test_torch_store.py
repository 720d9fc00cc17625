"""The port's storage slice against ``repro``, on the CPU: packed codes and
quantisation, the scan op (``repro``'s Pallas scan in interpret mode), the
out-of-core exact source and its granule cache, two-stage search on an
index built by ``repro`` and loaded by the port, plan resolution after
``release_dense_payload``, and save/load of indexes with a store in both
directions.

Tolerance: the rule of ``tests/test_torch_search.py`` — fp32 values within
rtol = 1e-5 and atol = 1e-5 * max(1, max|ref|), l2 compared squared, ids
equal except among entries whose distances lie within that tolerance of
each other. Binary codes dequantise to ±scale for a whole block, so scan
distances take few distinct values and the top-R boundary is a field of
near-ties: scan results are held to the near-tie rule, and a binary store's
final two-stage result to recall, not to ids. Codes are bit-equal to
``repro``'s; binary scales are sums taken in another order and agree
within rtol = 1e-6.
"""

import collections
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import PDASCIndex as JIndex
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.query import Query as JQuery
from repro.store import ExactSource as JExactSource
from repro.store import quantize as jquantize
from repro_torch.baselines import exact_knn
from repro_torch.core import nsa
from repro_torch.core.index import PDASCIndex
from repro_torch.kernels import ops, ref
from repro_torch.query import Query
from repro_torch.store import GranuleCache, LeafStore, dequantize, quantize
from repro_torch.store.two_stage import search_two_stage
from test_torch_search import _gap_radius, _levels, _tol, assert_results_agree

BIG = 1e30
REPO = pathlib.Path(__file__).resolve().parents[1]
BACKENDS = ("int8", "fp16", "int4", "binary")
FMT = {"int8": "dense", "fp16": "dense", "int4": "int4", "binary": "binary"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests are small, and the suite's other
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def assert_scan_agree(gd, gs, wd, ws, *, squared=False):
    """Scan top-k: dists within the rule, slots equal except among
    near-tied real entries."""
    gd, wd = np.asarray(gd, np.float64), np.asarray(wd, np.float64)
    gs, ws = np.asarray(gs), np.asarray(ws)
    real = wd < BIG / 2
    assert np.array_equal(real, gd < BIG / 2)
    a, b = (gd * gd, wd * wd) if squared else (gd, wd)
    np.testing.assert_allclose(np.where(real, a, 0), np.where(real, b, 0),
                               rtol=1e-5, atol=_tol(np.where(real, b, BIG)))
    atol = _tol(wd)
    for q in range(wd.shape[0]):
        row = wd[q][real[q]]
        for p in np.nonzero((gs[q] != ws[q]) & real[q])[0]:
            assert (np.abs(row - wd[q, p]) <= atol).sum() > 1 \
                or p == row.size - 1, (q, p, gs[q], ws[q])


def _recall(ids, gt):
    ids, gt = np.asarray(ids), np.asarray(gt)
    return float(np.mean([len(set(a[a >= 0].tolist()) & set(b.tolist()))
                          / gt.shape[1] for a, b in zip(ids, gt)]))


# ---------------------------------------------------------------------------
# packed codes and quantisation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 7, 8, 13, 16])
def test_pack_unpack_match_repro(d):
    """Odd d for int4, d % 8 != 0 for binary, and int4 bytes whose sign bit
    is set (a high nibble in [-8, -1])."""
    rng = np.random.default_rng(d)
    vals = rng.integers(-8, 8, size=(5, 3, d)).astype(np.int32)
    vals[0, 0, 1 % d] = -8
    p4 = ref.pack_int4(torch.from_numpy(vals))
    assert p4.dtype == torch.int8 and p4.shape[-1] == ref.packed_width(d, "int4")
    assert np.array_equal(p4.numpy(), np.asarray(jref.pack_int4(vals)))
    if d > 1:
        assert (p4.numpy() < 0).any()  # sign bit set in the int8 container
    assert np.array_equal(ref.unpack_codes(p4, "int4", d).numpy(), vals)

    x = rng.normal(size=(5, 3, d)).astype(np.float32)
    pb = ref.pack_binary(torch.from_numpy(x))
    assert pb.dtype == torch.uint8 and pb.shape[-1] == ref.packed_width(d, "binary")
    assert np.array_equal(pb.numpy(), np.asarray(jref.pack_binary(x)))
    assert np.array_equal(ref.pack_binary(torch.from_numpy(x >= 0)).numpy(),
                          pb.numpy())
    ub = ref.unpack_codes(pb, "binary", d).numpy()
    assert np.array_equal(ub, np.where(x >= 0, 1, -1))
    assert np.array_equal(ub, np.asarray(jref.unpack_codes(
        jnp.asarray(pb.numpy()), "binary", d)))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,d,block", [(300, 9, 32), (79, 13, 80),
                                       (1, 1, 1), (100, 3, 7), (64, 16, 64)])
def test_quantize_matches_repro(backend, n, d, block):
    x = _points(n, d, seed=n + d)
    codes, scales = quantize(torch.from_numpy(x), backend, block)
    jc, js = jquantize(x, backend, block)
    jc, js = np.asarray(jc), np.asarray(js)
    assert codes.numpy().dtype == jc.dtype and np.array_equal(codes.numpy(), jc)
    if backend == "binary":
        np.testing.assert_allclose(scales.numpy(), js, rtol=1e-6, atol=0)
    else:
        assert np.array_equal(scales.numpy(), js)
    back = dequantize(codes, scales, block, code_format=FMT[backend], d=d)
    np.testing.assert_allclose(back.numpy(), x if backend == "fp16" else
                               jref.unpack_codes(jnp.asarray(jc), FMT[backend], d)
                               .astype(np.float32)
                               * js[np.minimum(np.arange(n) // block,
                                               len(js) - 1)][:, None],
                               rtol=1e-6 if backend != "fp16" else 1e-3,
                               atol=1e-3 if backend == "fp16" else 0)


# ---------------------------------------------------------------------------
# the scan op
# ---------------------------------------------------------------------------


def _scan_case(backend, *, n=200, d=13, b=5, w=20, block=32, seed=0):
    rng = np.random.default_rng(seed)
    codes, scales = quantize(torch.from_numpy(_points(n, d, seed)), backend,
                             block)
    Q = rng.normal(size=(b, d)).astype(np.float32)
    ci = rng.integers(0, n, size=(b, w)).astype(np.int32)
    ok = rng.random((b, w)) > 0.3
    ok[1] = False  # an all-masked row
    return Q, codes, scales, ci, ok


@pytest.mark.parametrize("form", ref.FORMS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_scan_matches_pallas_interpret(form, backend):
    """k = w, an all-masked row, d = 13 (odd: a padded int4 nibble and a
    part-filled binary byte)."""
    Q, codes, scales, ci, ok = _scan_case(backend)
    w = ci.shape[1]
    gd, gs = ops.scan_quantized(
        torch.from_numpy(Q), codes, scales, torch.from_numpy(ci),
        torch.from_numpy(ok), form, k=w, block=32, code_format=FMT[backend])
    wd, ws = jops.scan_quantized(
        jnp.asarray(Q), jnp.asarray(codes.numpy()), jnp.asarray(scales.numpy()),
        jnp.asarray(ci), jnp.asarray(ok), form, k=w, block=32,
        code_format=FMT[backend], force_pallas=True, bq=8, bn=128)
    assert gs.dtype == torch.int32 and gd.shape == (5, w)
    assert_scan_agree(gd, gs, wd, ws, squared=form == "l2")
    # repro's contract over pre-gathered codes gives the op's result
    rows = torch.from_numpy(ci).long()
    cd, cs = ref.scan_quantized_ref(torch.from_numpy(Q), codes[rows],
                                    scales[rows // 32], torch.from_numpy(ok),
                                    w, form, fmt=FMT[backend])
    assert torch.equal(cd, gd) and torch.equal(cs, gs)


@pytest.mark.parametrize("backend", ["int8", "binary"])
def test_scan_slot_valid_and_short_k(backend):
    Q, codes, scales, ci, ok = _scan_case(backend, seed=3)
    live = np.random.default_rng(4).random(codes.shape[0]) > 0.2
    t = torch.from_numpy
    gd, gs = ops.scan_quantized(t(Q), codes, scales, t(ci), t(ok), "l2", k=4,
                                block=32, slot_valid=t(live),
                                code_format=FMT[backend])
    wd, ws = jops.scan_quantized(
        jnp.asarray(Q), jnp.asarray(codes.numpy()), jnp.asarray(scales.numpy()),
        jnp.asarray(ci), jnp.asarray(ok), "l2", k=4, block=32,
        slot_valid=jnp.asarray(live), code_format=FMT[backend])
    assert_scan_agree(gd, gs, wd, ws, squared=True)
    dead = ~live[ci] | ~ok
    picked = np.take_along_axis(dead, gs.numpy(), 1)
    assert not (picked & (gd.numpy() < BIG / 2)).any()


@pytest.mark.parametrize("distance", ["jaccard", "fractional05", "haversine"])
def test_scan_registry_path_matches_repro(distance):
    """A distance without a kernel form scans through the registry."""
    rng = np.random.default_rng(5)
    d = 2 if distance == "haversine" else 6
    x = np.abs(_points(120, d, 6)) * (0.5 if distance == "haversine" else 1)
    codes, scales = quantize(torch.from_numpy(x), "int8", 16)
    Q = (np.abs(rng.normal(size=(4, d))) * 0.5).astype(np.float32)
    ci = rng.integers(0, 120, size=(4, 15)).astype(np.int32)
    ok = rng.random((4, 15)) > 0.2
    t = torch.from_numpy
    gd, gs = ops.scan_quantized(t(Q), codes, scales, t(ci), t(ok), distance,
                                k=6, block=16)
    wd, ws = jops.scan_quantized(
        jnp.asarray(Q), jnp.asarray(codes.numpy()), jnp.asarray(scales.numpy()),
        jnp.asarray(ci), jnp.asarray(ok), distance, k=6, block=16)
    assert_scan_agree(gd, gs, wd, ws)


@pytest.mark.parametrize("b,d,w,k", [(1000, 100, 384, 128), (1000, 100, 384, 1),
                                     (9, 3, 1, 1), (7, 13, 33, 33),
                                     (5, 101, 4096, 4096), (3, 100, 31, 10),
                                     (1, 1536, 128, 128)])
def test_scan_geometry_covers_every_query_and_slot_once(b, d, w, k):
    """Each query has one block and ``wpq`` warps, whose 32-slot tiles
    (warp j: tiles j, j + wpq, ...) cover its w slots once; the block's
    shared memory fits and it has at most 8 warps."""
    from repro_torch.kernels import quantized, topk

    geo = quantized.scan_geometry(b, d, w, k)
    assert geo.wpq in (1, 2, 4) and geo.wpq * geo.qpb <= 8
    queries = [blk * geo.qpb + q for blk in range(geo.blocks)
               for q in range(geo.qpb) if blk * geo.qpb + q < b]
    assert queries == list(range(b))
    tiles = -(-w // 32)
    slots = sorted(s for j in range(geo.wpq) for t in range(j, tiles, geo.wpq)
                   for s in range(32 * t, min(w, 32 * t + 32)))
    assert slots == list(range(w))
    assert topk.rank_smem_bytes(d, k, geo.wpq, geo.qpb) <= 227 * 1024
    if (b, d, w, k) == (1000, 100, 384, 128):  # the two-stage path's scan
        assert (geo.wpq, geo.qpb) == (4, 2)


@pytest.mark.parametrize("k", [1, 2, 3, 10, 128, 1000, 5000, 14_000])
def test_scan_geometry_admits_what_the_block_merge_design_admitted(k):
    """Every (d, k <= w) that the first scan.cu admitted, 4 (d + 4k + 256)
    bytes within 227 KB, is admitted, up to its largest d; the geometry
    raises only where one query's one-warp state does not fit, and says
    the limit."""
    from repro_torch.kernels import quantized, topk

    limit = 227 * 1024
    d_old = limit // 4 - 256 - 4 * k  # the largest d the old check took
    for d in (1, 3, 101, d_old - 3, d_old - 1, d_old):
        geo = quantized.scan_geometry(1000, d, max(k, 384), k)
        assert topk.rank_smem_bytes(d, k, geo.wpq, geo.qpb) <= limit
    d_new = max(d for d in range(d_old, d_old + 4 * k + 8)
                if topk.rank_smem_bytes(d, k, 1, 1) <= limit)
    quantized.scan_geometry(3, d_new, k, k)
    with pytest.raises(ValueError, match=f"exceeds shared memory.*{limit}"):
        quantized.scan_geometry(3, d_new + 4, k, k)


@pytest.mark.parametrize("row_bytes,address,widest,vec", [
    (100, 0, 16, 4), (50, 0, 16, 2), (13, 0, 4, 1), (200, 0, 16, 8),
    (1536, 256, 16, 16), (100, 2, 16, 2), (7, 16, 16, 1), (16, 8, 16, 8),
    (16, 0, 4, 4)])
def test_scan_load_width_never_straddles_a_row(row_bytes, address, widest, vec):
    """scan.cu reads ``vec`` bytes of a code row at a time: the widest (up
    to ``widest``; binary's is 4) that divides the row stride (int8 100 B,
    int4 50 B, binary 13 B, fp16 200 B at d = 100) and the table's
    address."""
    from repro_torch.kernels import quantized

    assert quantized.load_width(row_bytes, address, widest) == vec


def test_plain_scan_counts_no_launch():
    ops.reset_launch_counts()
    Q, codes, scales, ci, ok = _scan_case("int4")
    ops.scan_quantized(torch.from_numpy(Q), codes, scales,
                       torch.from_numpy(ci), torch.from_numpy(ok), "l2", k=3,
                       block=32, code_format="int4")
    assert ops.launch_counts()["scan"] == 0


# ---------------------------------------------------------------------------
# the exact source and its granule cache
# ---------------------------------------------------------------------------


def test_memmap_store_equals_in_memory_and_counts_like_repro(tmp_path):
    x = _points(500, 9, seed=7)
    mem = LeafStore.create(x, "int8", block=32, cache_granules=4,
                           device="cpu")
    disk = LeafStore.create(torch.from_numpy(x), "int8", block=32,
                            path=str(tmp_path / "p.f32"), cache_granules=4,
                            device="cpu")
    assert disk.exact.on_disk and not mem.exact.on_disk
    assert disk.exact.wants_prefetch and not mem.exact.wants_prefetch
    assert torch.equal(mem.codes, disk.codes) and torch.equal(mem.scales,
                                                              disk.scales)
    assert np.array_equal(disk.exact.read_all(), x)
    assert mem.out_of_core_bytes == 500 * 9 * 4
    assert mem.resident_bytes == 500 * 9 + 16 * 4
    jsrc = JExactSource(x, 32, cache_granules=4)
    rng = np.random.default_rng(8)
    for _ in range(4):  # each call spans more granules than the cache holds
        idx = rng.integers(0, 500, size=(6, 5))
        got = disk.fetch_rows(idx)
        assert np.array_equal(got, x[idx]) and np.array_equal(
            mem.fetch_rows(idx), got)
        assert np.array_equal(np.asarray(jsrc.fetch_rows(idx)), got)
        assert disk.exact.stats == jsrc.stats == mem.exact.stats
    assert disk.exact.cache.stats["evictions"] > 0
    assert len(disk.exact.cache) == 4


def test_store_needs_a_gpu_or_cpu():
    """A store is an entry point: CUDA unless device="cpu" is asked for."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LeafStore.create(np.zeros((4, 3), np.float32), "int8", block=2)


def test_prefetch_warms_the_cache(tmp_path):
    x = _points(300, 4, seed=9)
    store = LeafStore.create(x, "int4", block=16, path=str(tmp_path / "p"),
                             cache_granules=32, device="cpu")
    rows = np.array([[1, 40, 41], [290, 3, 100]])
    store.prefetch_rows(rows)
    c = store.exact.cache.stats
    assert c["misses"] == 4 and c["hits"] == 0
    store.fetch_rows(rows)
    assert c["hits"] == 4 and c["prefetch_useful"] == 4
    handle = store.prefetch_rows_async(np.array([160, 170, 200, 1]))
    assert handle.wait(timeout=10)
    assert store.exact.cache.claimed(10) and store.exact.cache.claimed(12)
    before = c["misses"]
    assert np.array_equal(store.fetch_rows([160, 200]), x[[160, 200]])
    assert c["misses"] == before  # both rows came from warmed granules
    assert store.exact._pool.stats["accepted"] == 2  # granule 0 was resident
    store.exact._pool.close()
    assert store.exact.cache_resident_bytes > 0


def test_granule_cache_dedups_concurrent_fetches_and_survives_errors():
    """16 threads (more than the cores) hammer 8 keys with a short switch
    interval: each key is fetched exactly once (in-flight dedup) and every
    get is counted once; a fetch that raises leaves no claim behind."""
    import sys
    import threading

    cache = GranuleCache(capacity=8)
    calls = collections.Counter()
    lock = threading.Lock()

    def fetch(key):
        with lock:
            calls[key] += 1
        return np.full(4, key, np.float32)

    def worker(seed):
        rng = np.random.default_rng(seed)
        for key in rng.integers(0, 8, size=200).tolist():
            assert cache.get(key, fetch)[0] == key

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert dict(calls) == {k: 1 for k in range(8)}
    st = cache.stats
    assert st["misses"] == 8 and st["hits"] + st["misses"] == 16 * 200

    def broken(key):
        raise OSError("disk gone")

    with pytest.raises(OSError):
        cache.get(99, broken)
    assert not cache.claimed(99)
    assert cache.get(99, fetch)[0] == 99


# ---------------------------------------------------------------------------
# two-stage search on an index built by repro
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_store_indexes(tmp_path_factory):
    """repro builds one index and saves it with an int8 store (v2) and an
    int4 store (v4); returns the data, queries, radius, the artifacts'
    paths and per backend the repro index and the port's load of its
    artifact."""
    tmp = tmp_path_factory.mktemp("stores")
    data = _points(1200, 12, seed=10)
    Q = _points(40, 12, seed=11)
    out = dict(data=data, Q=Q)
    built = JIndex.build(data, gl=64, distance="euclidean",
                         radius_quantile=0.4)
    for backend, version in (("int8", 2), ("int4", 4)):
        built.attach_store(backend, block=64)
        path = out[f"{backend}_path"] = str(tmp / backend)
        built.save(path)
        assert json.load(open(path + ".json"))["version"] == version
        out[backend] = (JIndex.load(path), PDASCIndex.load(path, device="cpu"))
    out["r"] = _gap_radius(_levels(out["int8"][0]), "euclidean", Q)
    out["gt"] = exact_knn(Q, data, k=10, device="cpu")[1].numpy()
    return out


@pytest.mark.parametrize("backend", ["int8", "int4"])
def test_two_stage_matches_repro_on_its_index(jax_store_indexes, backend):
    s = jax_store_indexes
    jidx, tidx = s[backend]
    Q, r = s["Q"], s["r"]
    assert np.array_equal(tidx.store.codes.numpy(), np.asarray(jidx.store.codes))
    assert np.array_equal(tidx.store.scales.numpy(),
                          np.asarray(jidx.store.scales))
    assert tidx.store.code_format == jidx.store.code_format

    def both(**kw):
        return (tidx.plan(Query(k=10, radius=r, execution="two_stage", **kw))(Q),
                jidx.plan(JQuery(k=10, radius=r, execution="two_stage", **kw))(Q))

    # every candidate reranked: the scan orders only, so results agree
    got, want = both(rerank_width=10**6)
    assert_results_agree(got, want, squared=True)
    # the default width: the scan decides the survivors
    got, want = both()
    assert abs(_recall(got.ids, s["gt"]) - _recall(want.ids, s["gt"])) <= 0.01
    # scan-only: code-space distances
    got, want = both(exact_rerank=False)
    assert_results_agree(got, want, squared=True)
    # ∞ is the port's own beam, bit for bit
    beam = tidx.plan(Query(k=10, radius=r))(Q)
    inf, _ = both(rerank_width=None)
    for a, b in zip(inf, beam):
        assert torch.equal(a, b)
    assert_results_agree(beam, jidx.plan(JQuery(k=10, radius=r))(Q),
                         squared=True)


def test_plan_resolution_after_release(tmp_path):
    data = _points(400, 8, seed=12)
    idx = PDASCIndex.build(data, gl=32, device="cpu")
    with pytest.raises(ValueError, match="needs a leaf store"):
        idx.plan(Query(execution="two_stage"))
    with pytest.raises(ValueError, match="needs a quantised store"):
        idx.release_dense_payload()
    Q = data[:6] + 0.01
    beam_plan = idx.plan(Query(k=5))
    beam = beam_plan(Q)
    assert beam_plan.pipeline == "beam"
    idx.attach_store("binary", block=32, path=str(tmp_path / "p"))
    assert idx.plan(Query(k=5)).pipeline == "beam"  # payload still resident
    idx.release_dense_payload()
    idx.release_dense_payload()  # idempotent
    assert idx.data.levels[0].points.shape == (idx.data.levels[0].valid.shape[0], 0)
    assert idx._dim() == 8
    plan = idx.plan(Query(k=5))
    assert plan.pipeline == "two_stage"
    assert plan.describe()["effective_pipeline"] == "two_stage"
    assert "scan_quantized" in plan.explain() and "payload released" in plan.explain()
    assert idx.plan(Query(k=5, rerank_width=0)).describe()[
        "effective_pipeline"] == "two_stage_inf"
    assert "two_stage_scan" == idx.plan(Query(k=5, exact_rerank=False)) \
        .describe()["effective_pipeline"]
    for execution in ("beam", "dense", "beam_vmap"):
        with pytest.raises(ValueError, match="was released"):
            idx.plan(Query(execution=execution))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        idx.plan(Query(execution="sharded"))
    with pytest.raises(ValueError, match="already released"):
        idx.attach_store("int8")
    # the plan compiled before the release re-plans to two_stage
    res = beam_plan(Q)
    inf = idx.plan(Query(k=5, rerank_width=None))(Q)
    for a, b in zip(inf, beam):
        assert torch.equal(a, b)
    assert res.ids.shape == (6, 5)
    single = plan(Q[0])
    assert single.ids.shape == (5,) and torch.equal(single.ids, plan(Q).ids[0])
    mem = idx.memory_bytes()
    n0 = idx.data.levels[0].points.shape[0]
    assert mem["payload"] == n0 * 1 + 13 * 4  # ceil(8/8) byte a row, 13 scales
    assert mem["out_of_core"] == n0 * 8 * 4
    assert "store: binary" in idx.describe()


def test_two_stage_memmap_equals_in_memory(tmp_path):
    data = _points(1000, 10, seed=13)
    idx = PDASCIndex.build(data, gl=32, device="cpu", radius_quantile=0.4)
    Q = torch.from_numpy(_points(20, 10, seed=14))
    kw = dict(dist=idx.distance, k=10, r=idx.default_radius, beam=16,
              max_children=idx.max_children, rerank_width=32)
    leaf = idx.data.levels[0].points
    mem = LeafStore.create(leaf, "fp16", block=64, device="cpu")
    disk = LeafStore.create(leaf, "fp16", block=64, path=str(tmp_path / "p"),
                            cache_granules=64, device="cpu")
    a = search_two_stage(idx.data, mem, Q, **kw)
    b = search_two_stage(idx.data, disk, Q, **kw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert disk.exact._pool is not None  # the scan overlapped a prefetch
    assert disk.exact.stats["hits"] > 0
    assert mem.exact._pool is None  # a host array does not prefetch
    fp32 = LeafStore.create(leaf, "fp32", block=64, device="cpu")
    beam = nsa.search_beam(idx.data, Q, dist=idx.distance, k=10,
                           r=idx.default_radius, beam=16,
                           max_children=idx.max_children)
    for x, y in zip(search_two_stage(idx.data, fp32, Q, **kw), beam):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# save / load with a store, both ways
# ---------------------------------------------------------------------------


def test_port_saves_released_index_repro_loads_it(tmp_path):
    data = _points(500, 12, seed=15)
    Q = _points(25, 12, seed=16)
    tidx = PDASCIndex.build(data, gl=32, device="cpu", radius_quantile=0.4,
                            store="int8", store_block=64,
                            store_path=str(tmp_path / "payload.f32"))
    tidx.release_dense_payload()
    path = str(tmp_path / "idx")
    tidx.save(path)
    meta = json.load(open(path + ".json"))
    assert meta["version"] == 2 and meta["store"] == dict(backend="int8",
                                                          block=64)
    jidx = JIndex.load(path)
    assert np.array_equal(np.asarray(jidx.store.codes), tidx.store.codes.numpy())
    assert np.array_equal(np.asarray(jidx.data.levels[0].points),
                          tidx.store.exact.read_all())
    r = _gap_radius(_levels(jidx), "euclidean", Q)
    got = tidx.plan(Query(k=10, radius=r, rerank_width=10**6))(Q)
    want = jidx.plan(JQuery(k=10, radius=r, execution="two_stage",
                            rerank_width=10**6))(Q)
    assert_results_agree(got, want, squared=True)
    back = PDASCIndex.load(path, device="cpu")  # self-contained, resident
    assert not back._payload_released
    assert torch.equal(back.data.levels[0].points,
                       torch.from_numpy(tidx.store.exact.read_all()))
    assert torch.equal(back.store.codes, tidx.store.codes)
    assert torch.equal(back.store.scales, tidx.store.scales)
    for a, b in zip(back.data.levels[1:], tidx.data.levels[1:]):
        assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields)


def test_repro_saves_released_binary_index_port_loads_it(
        jax_store_indexes, tmp_path):
    data, Q = jax_store_indexes["data"], jax_store_indexes["Q"]
    jidx = JIndex.load(jax_store_indexes["int8_path"])
    jidx.attach_store("binary", block=64)
    jidx.release_dense_payload()
    path = str(tmp_path / "idx")
    jidx.save(path)
    assert json.load(open(path + ".json"))["version"] == 4
    tidx = PDASCIndex.load(path, device="cpu")
    assert tidx.store.backend == "binary" and tidx.store.codes.dtype == torch.uint8
    assert np.array_equal(tidx.store.codes.numpy(), np.asarray(jidx.store.codes))
    tidx.release_dense_payload()
    plan = tidx.plan(Query(k=10))
    assert plan.pipeline == "two_stage"
    gt = exact_knn(Q, data, k=10, device="cpu")[1].numpy()
    got, want = plan(Q), jidx.plan(JQuery(k=10))(Q)
    assert abs(_recall(got.ids, gt) - _recall(want.ids, gt)) <= 0.01
    assert np.array_equal(got.n_candidates.numpy(),
                          np.asarray(want.n_candidates))
    again = str(tmp_path / "again")
    tidx.save(again)
    back = PDASCIndex.load(again, device="cpu")
    assert torch.equal(back.store.codes, tidx.store.codes)
    assert back.store.exact.read_all().shape == (tidx.store.n, 12)


def test_port_modules_include_the_store():
    """The no-jax / no-repro import check (test_torch_search) walks every
    module of the port; the storage slice's modules are among them."""
    files = {p.relative_to(REPO / "src" / "repro_torch").as_posix()
             for p in (REPO / "src" / "repro_torch").rglob("*.py")}
    assert {"store/__init__.py", "store/cache.py", "store/leaf_store.py",
            "store/two_stage.py", "kernels/quantized.py"} <= files
    from test_torch_search import test_port_imports_neither_jax_nor_repro

    test_port_imports_neither_jax_nor_repro()
