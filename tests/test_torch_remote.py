"""The remote payload tier of the port (``repro_torch.store.remote``,
``repro_torch.store.streaming``, save/load v5, ``--store remote``) against
``repro``'s, on the CPU.

The same numpy inputs go through both packages: the object stores' ops and
fault seam, ``RemoteSource`` against ``ExactSource`` and ``repro``'s
``RemoteSource``, ``make_remote`` two-stage serving, the streaming build
level by level (``method="pam"`` on integer data, where the builds draw
nothing and sum exactly), and v5 artifacts written by either package.
Tolerances are the port's: distances within rtol = atol = 1e-5, ids equal
except at near-ties.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from repro.core.index import PDASCIndex as JIndex
from repro.query import Query as JQuery
from repro.store import LocalFSStore as JLocalFSStore
from repro.store import RemoteSource as JRemoteSource
from repro.store import SimulatedObjectStore as JSimStore
from repro.store import build_streaming as j_build_streaming
from repro.store import make_remote as j_make_remote
from repro.store import upload_payload as j_upload_payload
from repro_torch import obs
from repro_torch.core.index import PDASCIndex
from repro_torch.query import Query, capabilities
from repro_torch.serving.faults import FaultPlan
from repro_torch.store import (
    ExactSource,
    LocalFSStore,
    RemoteSource,
    RemoteStoreError,
    SimulatedObjectStore,
    build_streaming,
    make_remote,
    open_store,
    upload_payload,
)
from repro_torch.store.remote import granule_key
from test_torch_search import assert_results_agree


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests are small, and the suite's other
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_registry_reset():
    yield
    obs.set_enabled(True)
    obs.reset()


def _points(n=300, d=9, seed=7):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _grid(n, d, seed):
    return np.random.default_rng(seed).integers(0, 16, size=(n, d)).astype(
        np.float32)


def _remote_source(n=256, d=8, block=64, seed=0, **kw):
    pts = _points(n, d, seed)
    store = SimulatedObjectStore()
    upload_payload(store, pts, block)
    return pts, store, RemoteSource(store, n=n, d=d, block=block, **kw)


def _shards(data, sizes):
    out, lo = [], 0
    for m in sizes:
        out.append(data[lo:lo + m])
        lo += m
    return out


# ---------------------------------------------------------------------------
# the object stores
# ---------------------------------------------------------------------------


def test_localfs_store_roundtrip_and_reopen(tmp_path):
    store = LocalFSStore(str(tmp_path / "objs"))
    store.put("granule/00000000", b"abc")
    store.put("granule/00000001", b"defg")
    assert store.get("granule/00000000") == b"abc"
    assert store.list_keys("granule/") == ["granule/00000000",
                                           "granule/00000001"]
    assert store.get_batch(["granule/00000001", "granule/00000000"]) == \
        [b"defg", b"abc"]
    store.delete("granule/00000000")
    store.delete("granule/00000000")  # absent: no-op
    with pytest.raises(KeyError):
        store.get("granule/00000000")
    assert store.exists("granule/00000001")
    assert open_store(store.manifest()).get("granule/00000001") == b"defg"
    # repro reads the same objects: the manifest is the same
    jstore = JLocalFSStore(store.root)
    assert jstore.manifest() == store.manifest()
    assert jstore.get("granule/00000001") == b"defg"
    with pytest.raises(ValueError, match="escapes"):
        store.put("../outside", b"x")
    with pytest.raises(ValueError, match="cannot be reopened"):
        open_store(dict(kind="sim"))


def test_simulated_store_latency_counts_and_batch():
    store = SimulatedObjectStore(latency_ms=5.0, parallelism=4)
    store.put("k", b"1234")
    t0 = time.perf_counter()
    assert store.get("k") == b"1234"
    assert time.perf_counter() - t0 >= 0.004
    assert store.op_counts == dict(get=1, put=1, list=0, delete=0, errors=0)
    assert store.total_bytes == 4
    with pytest.raises(KeyError):
        store.get("missing")
    for i in range(6):
        store.put(f"b/{i}", bytes([i]))
    assert store.get_batch([f"b/{i}" for i in (5, 0, 3)]) == \
        [b"\x05", b"\x00", b"\x03"]
    assert store.list_keys("b/") == [f"b/{i}" for i in range(6)]


def test_simulated_store_fault_seam_equals_repro():
    """A fault plan's error window (the serving tier's injectors) makes the
    store's ops fail as repro's do: RemoteStoreError naming the injected
    fault, counted in op_counts and the errors series."""
    from repro.serving.faults import FaultPlan as JFaultPlan

    store = SimulatedObjectStore(faults=FaultPlan.parse(
        "error:r0@1+2").injector(0))
    jstore = JSimStore(faults=JFaultPlan.parse("error:r0@1+2").injector(0))
    msgs = []
    for s in (store, jstore):
        s.put("k", b"x")  # dispatch 0: before the window
        for _ in range(2):
            with pytest.raises(Exception) as e:
                s.get("k")
            msgs.append(str(e.value))
        assert s.get("k") == b"x"  # the window has passed
    assert msgs[:2] == msgs[2:]
    assert msgs[0].startswith("remote get failed: InjectedFault: injected "
                              "error (replica r0, dispatch 1")
    assert store.op_counts == jstore.op_counts
    assert store.op_counts["errors"] == 2
    snap = obs.snapshot()[obs.names.STORE_REMOTE_ERRORS]
    assert snap["series"][0]["value"] == 2


def test_injected_error_message_names_the_fault():
    store = SimulatedObjectStore(faults=FaultPlan.parse(
        "error:r0@0+1").injector(0))
    with pytest.raises(RemoteStoreError, match="remote put failed: "
                       "InjectedFault"):
        store.put("k", b"x")


# ---------------------------------------------------------------------------
# RemoteSource
# ---------------------------------------------------------------------------


def test_remote_source_fetch_rows_equals_exact_source_and_repro():
    pts, store, src = _remote_source(n=250, d=8, block=64)  # short last
    local = ExactSource(pts, 64)
    jstore = JSimStore()
    j_upload_payload(jstore, pts, 64)
    jsrc = JRemoteSource(jstore, n=250, d=8, block=64)
    rng = np.random.default_rng(1)
    for shape in ((3,), (4, 5), (2, 3, 7)):
        idx = rng.integers(0, 250, shape)
        got = src.fetch_rows(idx)
        np.testing.assert_array_equal(got, local.fetch_rows(idx))
        np.testing.assert_array_equal(got, jsrc.fetch_rows(idx))
        np.testing.assert_array_equal(got, pts[idx])
    assert src.stats == jsrc.stats
    np.testing.assert_array_equal(src.read_all(), pts)
    assert src.nbytes == 250 * 8 * 4
    assert src.remote and src.wants_prefetch and not src.on_disk
    assert src.manifest() == dict(kind="sim", n=250, d=8, block=64, prefix="",
                                  n_granules=4)
    assert src.manifest() == jsrc.manifest()
    src.close()
    jsrc.close()


def test_remote_source_cache_stats_and_series():
    pts, store, src = _remote_source(cache_granules=2)
    src.fetch_rows([0])  # granule 0: miss
    src.fetch_rows([1])  # granule 0: hit
    assert src.stats == dict(fetches=1, hits=1)
    src.fetch_rows([64, 128])  # granules 1, 2: the cache (2) evicts 0
    src.fetch_rows([0])  # miss again
    assert src.stats["fetches"] == 4
    assert src.cache_resident_bytes <= 2 * 64 * 8 * 4
    assert src.prefetch_async([3]).wait(5)
    src.fetch_rows([200])  # granule 3: warm
    assert src.stats["fetches"] == 5
    snap = obs.snapshot()
    n = obs.names
    assert snap[n.STORE_REMOTE_GETS]["series"][0]["value"] == 5
    assert snap[n.STORE_REMOTE_PUTS]["series"][0]["value"] == 4
    assert snap[n.STORE_REMOTE_FETCH_BYTES]["series"][0]["value"] == \
        5 * 64 * 8 * 4
    src.close()


def test_remote_source_fault_errors_surface_without_wedging():
    pts = _points(128, 4)
    # the window opens after the 3 upload puts (2 granules + manifest)
    store = SimulatedObjectStore(faults=FaultPlan.parse(
        "error:r0@3+2").injector(0))
    upload_payload(store, pts, 64)
    src = RemoteSource(store, n=128, d=4, block=64)
    with pytest.raises(RemoteStoreError):
        src.fetch_rows([0])
    with pytest.raises(RemoteStoreError):
        src.fetch_rows([64])
    np.testing.assert_array_equal(src.fetch_rows([0, 64]), pts[[0, 64]])
    src.close()


def test_remote_source_corrupt_granule_detected():
    pts, store, src = _remote_source(n=128, d=4, block=64)
    store.put(granule_key(0), b"\x00" * 12)  # wrong payload size
    with pytest.raises(RemoteStoreError, match="expected"):
        src.fetch_rows([0])
    src.close()


def test_concurrent_fetches_read_each_granule_once():
    pts = _points(512, 4)
    store = SimulatedObjectStore(latency_ms=2.0)
    upload_payload(store, pts, 64)
    src = RemoteSource(store, n=512, d=4, block=64, cache_granules=16)
    out = []
    threads = [threading.Thread(target=lambda: out.append(
        src.fetch_rows(np.arange(512)))) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads) and len(out) == 6
    for o in out:
        np.testing.assert_array_equal(o, pts)
    assert store.op_counts["get"] == 8  # one read per granule
    src.close()


# ---------------------------------------------------------------------------
# make_remote, memory, capabilities
# ---------------------------------------------------------------------------


def _built(n=512, d=8, gl=32, block=64):
    pts = _points(n, d)
    jidx = JIndex.build(pts, gl=gl, distance="euclidean", store="int8",
                        store_block=block, shuffle=False)
    return pts, jidx


def _pair(tmp_path, jidx):
    path = str(tmp_path / "idx")
    jidx.save(path)
    return PDASCIndex.load(path, device="cpu"), JIndex.load(path)


def test_make_remote_serves_as_repro(tmp_path):
    pts, jidx = _built()
    idx, jidx = _pair(tmp_path, jidx)
    q, jq = (Query(k=5, execution="two_stage", beam=8, rerank_width=32),
             JQuery(k=5, execution="two_stage", beam=8, rerank_width=32))
    local = idx.plan(q)(pts[:16])
    assert capabilities(idx).remote is False
    src = make_remote(idx, SimulatedObjectStore(), cache_granules=2)
    j_make_remote(jidx, JSimStore(), cache_granules=2)
    caps = capabilities(idx)
    assert caps.remote and caps.payload_released and caps.store == "int8"
    plan = idx.plan(q)
    assert "remote exact tier" in plan.explain()
    got = plan(pts[:16])
    np.testing.assert_array_equal(got.ids.numpy(), local.ids.numpy())
    np.testing.assert_array_equal(got.dists.numpy(), local.dists.numpy())
    # self-queries: l2 near zero is compared squared (Gram cancellation)
    assert_results_agree(got, jidx.plan(jq)(pts[:16]), squared=True)
    mem, jmem = idx.memory_bytes(), jidx.memory_bytes()
    for key in ("payload", "out_of_core", "remote_bytes", "host_cache"):
        assert mem[key] == jmem[key], key
    assert mem["remote_bytes"] == 512 * 8 * 4 and mem["out_of_core"] == 0
    assert 0 < mem["host_cache"] <= 2 * 64 * 8 * 4
    assert "in a remote store" in idx.describe()
    src.close()
    jidx.store.exact.close()


def test_make_remote_requires_a_quantised_store():
    idx = PDASCIndex.build(_points(128, 4), gl=16, device="cpu")
    with pytest.raises(ValueError, match="quantised"):
        make_remote(idx, SimulatedObjectStore())


# ---------------------------------------------------------------------------
# the streaming build
# ---------------------------------------------------------------------------

STREAM = dict(gl=32, block=32, method="pam", distance="manhattan",
              store="int8")
SIZES = (128, 128, 80)  # the last shard ragged: 80 rows pad to 96 slots


@pytest.fixture(scope="module")
def streamed():
    data = _grid(sum(SIZES), 4, seed=3)
    idx = build_streaming(_shards(data, SIZES), remote=SimulatedObjectStore(),
                          device="cpu", **STREAM)
    jidx = j_build_streaming(_shards(data, SIZES), remote=JSimStore(),
                             **STREAM)
    yield data, idx, jidx
    idx.store.exact.close()
    jidx.store.exact.close()


def test_build_streaming_equals_repro_level_by_level(streamed):
    data, idx, jidx = streamed
    assert idx.stats.level_sizes == jidx.stats.level_sizes
    np.testing.assert_allclose(idx.stats.level_td, jidx.stats.level_td,
                               rtol=1e-6)
    np.testing.assert_array_equal(idx.data.leaf_ids.numpy(),
                                  np.asarray(jidx.data.leaf_ids))
    for tl, jl in zip(idx.data.levels, jidx.data.levels):
        for f in tl._fields:
            np.testing.assert_array_equal(getattr(tl, f).numpy(),
                                          np.asarray(getattr(jl, f)), f)
    assert idx.max_children == jidx.max_children
    np.testing.assert_array_equal(idx.store.codes.numpy(),
                                  np.asarray(jidx.store.codes))
    np.testing.assert_array_equal(idx.store.scales.numpy(),
                                  np.asarray(jidx.store.scales))
    np.testing.assert_array_equal(idx.store.exact.read_all(),
                                  jidx.store.exact.read_all())
    assert idx.store.exact.manifest() == jidx.store.exact.manifest()


def test_build_streaming_layout_and_ragged_last_shard(streamed):
    data, idx, _ = streamed
    leaf = idx.data.levels[0]
    valid, ids = leaf.valid.numpy(), idx.data.leaf_ids.numpy()
    assert leaf.points.shape == (128 + 128 + 96, 0)  # released form
    assert idx.n_points == sum(SIZES) and valid.sum() == sum(SIZES)
    rows = idx.store.exact.read_all()
    np.testing.assert_array_equal(rows[valid], data[ids[valid]])
    np.testing.assert_allclose(leaf.sq_norm.numpy(), (rows ** 2).sum(1),
                               rtol=1e-6)
    for l in range(1, idx.n_levels):
        lv, lo = idx.data.levels[l], idx.data.levels[l - 1]
        cs, cc = lv.child_start.numpy(), lv.child_count.numpy()
        for s in np.nonzero(lv.valid.numpy())[0]:
            assert (lo.parent.numpy()[cs[s]:cs[s] + cc[s]] == s).all()
    assert idx._payload_released and capabilities(idx).remote
    assert idx.device == torch.device("cpu")
    assert idx.store.codes.device == idx.device


def test_build_streaming_searches_as_repro(streamed):
    data, idx, jidx = streamed
    q = data[::37] + 0.25
    for rerank in (32, None):
        got = idx.plan(Query(k=5, beam=8, rerank_width=rerank,
                             radius=4.0))(q)
        want = jidx.plan(JQuery(k=5, beam=8, rerank_width=rerank,
                                radius=4.0))(q)
        assert_results_agree(got, want)


def test_build_streaming_kmeans_end_to_end():
    from repro_torch.baselines import exact_knn

    rng = np.random.default_rng(3)
    centres = rng.normal(0, 3.0, size=(16, 8))
    comp = rng.integers(0, 16, 1024 + 24)
    x = (centres[comp] + rng.normal(size=(1024 + 24, 8))).astype(np.float32)
    train, test = x[:1024], x[1024:]
    idx = build_streaming(_shards(train, (512, 512)), gl=64, block=64,
                          remote=SimulatedObjectStore(), method="kmeans",
                          radius_quantile=0.35, device="cpu")
    res = idx.plan(Query(k=10, beam=32, rerank_width=128))(test)
    _, gt = exact_knn(test, train, k=10, device="cpu")
    ids, gt = res.ids.numpy(), gt.numpy()
    rec = np.mean([len(set(r[r >= 0]) & set(g)) / 10 for r, g in zip(ids, gt)])
    assert rec >= 0.5
    d0 = np.linalg.norm(train[ids[0, 0]] - test[0])
    np.testing.assert_allclose(float(res.dists[0, 0]), d0, rtol=1e-4)
    idx.store.exact.close()


def test_build_streaming_refusals():
    store = SimulatedObjectStore()
    with pytest.raises(ValueError, match="multiple of block"):
        build_streaming(_shards(_points(64, 4), (32, 32)), gl=32, block=64,
                        remote=store, method="kmeans", device="cpu")
    with pytest.raises(ValueError, match="quantised"):
        build_streaming(iter([]), gl=32, remote=store, store="fp32",
                        device="cpu")
    with pytest.raises(ValueError, match="empty"):
        build_streaming(iter([]), gl=32, block=32, remote=store,
                        method="kmeans", device="cpu")
    with pytest.raises(ValueError, match="earlier shards"):
        build_streaming(iter([_points(32, 4), _points(32, 5)]), gl=32,
                        block=32, remote=store, method="kmeans", device="cpu")


def test_index_device_defaults_to_cuda():
    """A PDASCIndex made without a device is labelled CUDA (the entry
    points' default), never the CPU: here, without a GPU, it raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    idx = PDASCIndex.build(_points(64, 4), gl=16, device="cpu")
    fields = dict(data=idx.data, stats=idx.stats, distance=idx.distance,
                  gl=16, n_prototypes=8, max_children=idx.max_children,
                  default_radius=1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PDASCIndex(**fields)
    assert PDASCIndex(**fields, device=torch.device("cpu")).device.type == "cpu"


# ---------------------------------------------------------------------------
# save / load v5
# ---------------------------------------------------------------------------


def test_save_load_v5_roundtrip_localfs(tmp_path):
    data = _grid(256, 8, seed=2)
    idx = build_streaming(_shards(data, (128, 128)),
                          remote=LocalFSStore(str(tmp_path / "objs")),
                          device="cpu", **STREAM)
    q = Query(k=5, beam=8, rerank_width=32, radius=8.0)
    want = idx.plan(q)(data[:8] + 0.5)
    path = str(tmp_path / "idx")
    idx.save(path)
    with open(path + ".json") as f:
        meta = json.load(f)
    assert meta["version"] == 5
    assert meta["store"]["remote"]["kind"] == "localfs"
    with np.load(path + ".npz") as z:
        assert z["level0_points"].shape[1] == 0  # the payload stays remote
    back = PDASCIndex.load(path, device="cpu")
    assert back._payload_released and capabilities(back).remote
    got = back.plan(q)(data[:8] + 0.5)
    np.testing.assert_array_equal(got.ids.numpy(), want.ids.numpy())
    np.testing.assert_array_equal(got.dists.numpy(), want.dists.numpy())
    for a, b in zip(back.data.levels, idx.data.levels):
        for f in a._fields:
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          getattr(b, f).numpy(), f)
    idx.store.exact.close()
    back.store.exact.close()


def test_save_load_v5_sim_needs_the_live_store(tmp_path):
    data = _grid(128, 4, seed=2)
    store = SimulatedObjectStore()
    idx = build_streaming(_shards(data, (64, 64)), remote=store,
                          device="cpu", **STREAM)
    path = str(tmp_path / "idx")
    idx.save(path)
    with pytest.raises(ValueError, match="cannot be reopened"):
        PDASCIndex.load(path, device="cpu")
    back = PDASCIndex.load(path, remote=store, device="cpu",
                           cache_granules=3)
    np.testing.assert_array_equal(back.store.exact.read_all(),
                                  idx.store.exact.read_all())
    assert back.store.exact.cache.capacity == 3
    idx.store.exact.close()
    back.store.exact.close()


def test_load_a_repro_written_v5_artifact(tmp_path):
    data = _grid(256, 8, seed=4)
    jidx = j_build_streaming(_shards(data, (128, 128)),
                             remote=JLocalFSStore(str(tmp_path / "objs")),
                             **STREAM)
    path = str(tmp_path / "j")
    jidx.save(path)
    idx = PDASCIndex.load(path, device="cpu")
    jback = JIndex.load(path)
    assert idx._payload_released and capabilities(idx).remote
    q = data[:12] + 0.5
    for rerank in (32, None):
        got = idx.plan(Query(k=5, beam=8, rerank_width=rerank,
                             radius=8.0))(q)
        want = jback.plan(JQuery(k=5, beam=8, rerank_width=rerank,
                                 radius=8.0))(q)
        assert_results_agree(got, want)
    # and repro reads the port's v5 artifact back
    idx.save(str(tmp_path / "t"))
    again = JIndex.load(str(tmp_path / "t"))
    np.testing.assert_array_equal(again.store.exact.read_all(),
                                  idx.store.exact.read_all())
    for h in (idx, jidx, jback, again):
        h.store.exact.close()
