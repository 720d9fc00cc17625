"""The port's online tiers against ``repro``, on the CPU: one small index
built by ``repro`` (integer data, manhattan, ``shuffle=False``, pam, an
int8 store) is
loaded into both packages, and the same upserts, replacements and deletes
go to both. Then the tiers (tombstone bits, delta rows, the id ceiling),
the insert-time routing, every search pipeline, ``merge_topk``, both
compaction scopes, ``LeafStore.rebuild``, save/load v3 and v4 in both
directions, ``EpochHandle`` and the write validation are held to
``repro``'s.

Tolerance: the rule of ``tests/test_torch_search.py`` (fp32 values within
rtol = 1e-5 and atol = 1e-5 * max(1, max|ref|), ids equal except among
near-tied entries). On integer data every manhattan distance, and every
sum of them a k-medoids step takes, is exact in fp32, so routing and
compaction are compared exactly (level arrays equal, level TDs within rtol
1e-6).
"""

import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import msa as jmsa
from repro.core.index import PDASCIndex as JIndex
from repro.online import EpochHandle as JEpochHandle
from repro.online import compact as jcompact
from repro.online import merge_topk as jmerge_topk
from repro.query import Query as JQuery
from repro_torch.core import reference_impl
from repro_torch.core.index import PDASCIndex
from repro_torch.online import EpochHandle, WriteLog, live_dataset, merge_topk
from repro_torch.query import Query
from test_torch_search import assert_results_agree

BIG = 1e30
N, D, GL, BLOCK = 600, 4, 24, 64
DIST = "manhattan"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _integer_data(n, seed):
    return np.random.default_rng(seed).integers(0, 16, size=(n, D)).astype(
        np.float32)


def _writes(seed=1):
    """The write stream: new rows near residents, replacements of resident
    ids, deletes of residents and of upserted ids (integer vectors)."""
    rng = np.random.default_rng(seed)
    base = _integer_data(N, 0)
    new = base[rng.choice(N, 40, replace=False)] + rng.integers(
        -1, 2, size=(40, D))
    replace_ids = rng.choice(N, 10, replace=False).astype(np.int32)
    replace = base[replace_ids] + rng.integers(-2, 3, size=(10, D))
    dead = rng.choice(np.setdiff1d(np.arange(N), replace_ids), 30,
                      replace=False).astype(np.int32)
    return [("upsert", new[:20].astype(np.float32)),
            ("upsert", new[20:].astype(np.float32)),
            ("upsert", (replace.astype(np.float32), replace_ids)),
            ("delete", dead),
            ("delete", np.arange(N + 3, N + 8, dtype=np.int32))]


def _apply(idx, ops):
    for kind, payload in ops:
        if kind == "upsert":
            vectors, ids = payload if isinstance(payload, tuple) else (
                payload, None)
            idx.upsert(vectors, ids=ids)
        else:
            idx.delete(payload)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """``(repro index, port index)``: the same artifact, the same writes."""
    path = str(tmp_path_factory.mktemp("online") / "idx")
    JIndex.build(_integer_data(N, 0), gl=GL, distance=DIST, shuffle=False,
                 store="int8", store_block=BLOCK,
                 radius_quantile=0.3).save(path)
    j, t = JIndex.load(path), PDASCIndex.load(path, device="cpu")
    ops = _writes()
    _apply(j, ops)
    _apply(t, ops)
    return j, t


def _queries(seed=2, n=24):
    return _integer_data(n, seed) + 0.25


def _deleted_ids():
    ops = _writes()
    return np.concatenate([ops[3][1], ops[4][1]])


def test_tiers_and_id_ceiling_equal_repro(pair):
    j, t = pair
    np.testing.assert_array_equal(t.tombstones.bits, j.tombstones.bits)
    assert t.tombstones.count == j.tombstones.count == 40
    size = j.delta.size
    assert t.delta.size == size == 50
    for f in ("vectors", "ids", "active"):
        np.testing.assert_array_equal(getattr(t.delta, f)[:size],
                                      getattr(j.delta, f)[:size])
    assert t._seen_id_ceiling() == j._seen_id_ceiling() == N + 40
    assert t.n_points == j.n_points
    assert t.needs_compaction() == j.needs_compaction()
    assert t.memory_bytes()["delta"] == j.memory_bytes()["delta"]
    assert t.memory_bytes()["tombstones"] == j.memory_bytes()["tombstones"]
    mask = t.tombstones.valid_mask()
    assert mask is t.tombstones.valid_mask()  # cached until the next add
    t.tombstones.add(t.tombstones.dead_slots()[:1])  # a re-delete: no-op
    assert t.tombstones.valid_mask() is mask
    assert "online: 45 delta, 40 tombstoned" in t.describe()


def test_routing_equals_repro(pair):
    """Insert-time routing (beam-1 descent + one k = 1 rank): the same
    leaf slot for every row; on integer data the distances are exact, so
    only an exact tie could pick another slot."""
    j, t = pair
    V = _integer_data(50, 3) + 0.5
    js = np.asarray(j._route_to_leaf(V))
    ts = t._route_to_leaf(V)
    leaf = np.asarray(j.data.levels[0].points)
    for q in np.nonzero(js != ts)[0]:
        a = np.abs(leaf[js[q]] - V[q]).sum()
        b = np.abs(leaf[ts[q]] - V[q]).sum()
        assert abs(a - b) <= 1e-5 * max(1.0, a)
    np.testing.assert_array_equal(t.delta.leaf_slot[:t.delta.size],
                                  j.delta.leaf_slot[:j.delta.size])


@pytest.mark.parametrize("execution", ["beam", "dense", "two_stage"])
def test_searches_equal_repro_and_hide_deleted_ids(pair, execution):
    j, t = pair
    Q = _queries()
    kw = dict(k=8, execution=execution, radius=40.0)
    if execution == "two_stage":
        kw["rerank_width"] = 32
    plan = t.plan(Query(**kw))
    assert plan.describe()["online_legs"] == dict(
        plan.describe()["online_legs"], tombstone_mask=True, delta=True)
    got = plan(Q)
    want = j.plan(JQuery(**kw))(jnp.asarray(Q))
    assert_results_agree(got, want)
    assert not np.isin(got.ids.numpy(), _deleted_ids()).any()


def test_upserted_vector_finds_itself_and_plans_replan(pair):
    j, t = pair
    plan = t.plan(Query(k=3))
    v = np.full((1, D), 7.25, np.float32)
    ids = t.upsert(v)
    jids = j.upsert(v)
    assert ids.tolist() == jids.tolist() == [N + 40]
    res = plan(v)  # bound before the write: re-plans with the delta leg
    assert res.ids[0, 0].item() == ids[0] and res.dists[0, 0].item() == 0.0
    t.delete(ids)
    j.delete(jids)
    assert not np.isin(t.plan(Query(k=3))(v).ids.numpy(), ids).any()


def test_merge_topk_bit_equal_to_repro():
    rng = np.random.default_rng(4)
    for ka, kb, k in [(5, 5, 5), (3, 2, 8), (1, 1, 3), (10, 4, 6)]:
        da = np.sort(rng.integers(0, 6, (7, ka)).astype(np.float32), axis=1)
        db = np.sort(rng.integers(0, 6, (7, kb)).astype(np.float32), axis=1)
        da[0, -1] = BIG
        ia = rng.integers(0, 100, (7, ka)).astype(np.int32)
        ib = rng.integers(100, 200, (7, kb)).astype(np.int32)
        jd, ji = jmerge_topk(jnp.asarray(da), jnp.asarray(ia),
                             jnp.asarray(db), jnp.asarray(ib), k)
        td, ti = merge_topk(*(torch.from_numpy(x) for x in (da, ia, db, ib)),
                            k)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _assert_levels_equal(t_data, j_data):
    assert len(t_data.levels) == len(j_data.levels)
    for l, (a, b) in enumerate(zip(t_data.levels, j_data.levels)):
        for f in a._fields:
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)),
                                          err_msg=f"level {l} {f}")
    np.testing.assert_array_equal(t_data.leaf_ids.numpy(),
                                  np.asarray(j_data.leaf_ids))


def test_affected_compaction_equals_repro(pair):
    j, t = pair
    jn = j.compact(scope="affected")
    tn = t.compact(scope="affected")
    assert reference_impl.check_index_invariants(tn.data) == []
    _assert_levels_equal(tn.data, jn.data)
    assert tn.stats.level_sizes == jn.stats.level_sizes
    np.testing.assert_allclose(tn.stats.level_td, jn.stats.level_td,
                               rtol=1e-6)
    assert tn.epoch == jn.epoch == 1 and tn.delta.n_active == 0
    assert tn._seen_id_ceiling() == jn._seen_id_ceiling()
    # LeafStore.rebuild re-quantised the same blocks, to the same codes
    assert tn.store.last_rebuild == jn.store.last_rebuild
    np.testing.assert_array_equal(tn.store.codes.numpy(),
                                  np.asarray(jn.store.codes))
    np.testing.assert_array_equal(tn.store.scales.numpy(),
                                  np.asarray(jn.store.scales))
    # RCU: the old epoch still serves its own live set
    assert t.delta.n_active and t.tombstones.count
    # untouched groups kept their rows bit for bit
    old, new = t.data.levels[0], tn.data.levels[0]
    dead = np.zeros(old.points.shape[0], bool)
    dead[t.tombstones.dead_slots()] = True
    touched = set((t.delta.leaf_slot[t.delta.active] // GL).tolist()) | set(
        (np.nonzero(dead)[0] // GL).tolist())
    for g in sorted(set(range(old.points.shape[0] // GL)) - touched):
        sl = slice(g * GL, (g + 1) * GL)
        assert torch.equal(old.points[sl], new.points[sl])
        assert torch.equal(t.data.leaf_ids[sl], tn.data.leaf_ids[sl])


def test_leaf_store_rebuild_requantizes_only_changed_blocks(tmp_path):
    """``LeafStore.rebuild`` against ``repro``'s on one payload: the same
    blocks re-quantised (those overlapping changed rows, and the appended
    tail), the same codes and scales, the unchanged blocks' bits kept, and
    the new payload in a fresh file."""
    from repro.store import LeafStore as JLeafStore
    from repro_torch.store import LeafStore

    rng = np.random.default_rng(11)
    pts = rng.normal(size=(200, 6)).astype(np.float32)
    new = np.concatenate([pts, rng.normal(size=(30, 6)).astype(np.float32)])
    new[40:45] += 1.0
    changed = np.zeros(230, bool)
    changed[40:45] = changed[200:] = True
    for backend in ("int8", "int4", "binary"):
        t = LeafStore.create(torch.from_numpy(pts), backend, block=16,
                             path=str(tmp_path / f"{backend}.0"),
                             device="cpu")
        j = JLeafStore.create(pts, backend, block=16)
        tn = t.rebuild(new, changed, path=str(tmp_path / f"{backend}.1"))
        jn = j.rebuild(new, changed)
        assert tn.last_rebuild == jn.last_rebuild == dict(blocks=15,
                                                           requantized=4)
        np.testing.assert_array_equal(tn.codes.numpy(), np.asarray(jn.codes))
        np.testing.assert_allclose(tn.scales.numpy(), np.asarray(jn.scales),
                                   rtol=1e-6)
        kept = np.r_[0:32, 48:192]
        assert torch.equal(tn.codes[kept], t.codes[kept])
        assert tn.exact.path != t.exact.path
        np.testing.assert_array_equal(t.exact.read_all(), pts)
        np.testing.assert_array_equal(tn.exact.read_all(), new)


def test_full_compaction_is_a_build_of_the_live_set(pair):
    """A full compaction is a build over ``live_dataset`` (the same live
    set as ``repro``'s), drawing its shuffle from the compaction's
    generator: it equals the port's build of that set with the same
    generator, and that build without the shuffle equals ``repro``'s level
    by level. (The shuffle's ``torch.Generator`` draws differ from
    ``repro``'s key, so the two full compactions are not id-equal.)"""
    from repro_torch.core import msa
    from repro_torch.online.compact import default_generator

    j, t = pair
    vecs, ids = live_dataset(t)
    jvecs, jids = jcompact.live_dataset(j)
    np.testing.assert_array_equal(vecs, jvecs)
    np.testing.assert_array_equal(ids, jids)
    tn = t.compact(scope="full")
    assert reference_impl.check_index_invariants(tn.data) == []
    data, _ = msa.build_index(vecs, gl=GL, distance=DIST, device="cpu",
                              generator=default_generator(t.epoch))
    rows = data.leaf_ids.numpy()  # rows of `vecs`: lift them to live ids
    _assert_levels_equal(tn.data, data._replace(leaf_ids=np.where(
        rows >= 0, ids[np.clip(rows, 0, len(ids) - 1)], -1)))
    plain, pstats = msa.build_index(vecs, gl=GL, distance=DIST, shuffle=False,
                                    device="cpu")
    jdata, jstats = jmsa.build_index(jvecs, gl=GL, distance=DIST,
                                     shuffle=False)
    _assert_levels_equal(plain, jdata)
    np.testing.assert_allclose(pstats.level_td, jstats.level_td, rtol=1e-6)
    assert tn.store.last_rebuild["requantized"] == \
        tn.store.last_rebuild["blocks"]


def test_compacted_exact_search_equals_the_live_set():
    """After compaction, the dense exact search (radius 1e9) returns the
    live set's exact neighbours, as sets."""
    t = PDASCIndex.build(_integer_data(N, 0), gl=GL, distance=DIST,
                         shuffle=False,
                         device="cpu")
    _apply(t, _writes())
    Q = _queries()
    for scope in ("affected", "full"):
        c = t.compact(scope=scope)
        vecs, ids = live_dataset(c)
        res = c.plan(Query(k=6, execution="dense", radius=1e9))(Q)
        want = np.abs(Q[:, None, :] - vecs[None]).sum(-1)
        kth = np.sort(want, axis=1)[:, 5]
        for q in range(len(Q)):
            got = set(res.ids[q].tolist())
            sure = set(ids[want[q] < kth[q] - 1e-4].tolist())
            assert sure <= got <= set(ids[want[q] <= kth[q] + 1e-4].tolist())


def _save_load(src, path, load):
    src.save(path)
    return load(path)


@pytest.mark.parametrize("backend,version", [("int8", 3), ("int4", 4)])
def test_save_load_mutable_both_ways(tmp_path, backend, version):
    src = JIndex.build(_integer_data(N, 0), gl=GL, distance=DIST,
                       shuffle=False, store=backend, store_block=BLOCK)
    _apply(src, _writes())
    t = _save_load(src, str(tmp_path / "j"),
                   lambda p: PDASCIndex.load(p, device="cpu"))
    meta = json.load(open(tmp_path / "j.json"))
    assert meta["version"] == version and meta["mutable"] is not None
    back = _save_load(t, str(tmp_path / "t"), JIndex.load)
    meta_t = json.load(open(tmp_path / "t.json"))
    assert meta_t["version"] == version
    assert meta_t["mutable"] == meta["mutable"]
    for idx in (t, back):
        np.testing.assert_array_equal(idx.tombstones.bits, src.tombstones.bits)
        n = src.delta.size
        for f in ("vectors", "ids", "leaf_slot", "active"):
            np.testing.assert_array_equal(getattr(idx.delta, f)[:n],
                                          getattr(src.delta, f)[:n])
        assert idx._seen_id_ceiling() == src._seen_id_ceiling()
    Q = _queries()
    kw = dict(k=5, execution="two_stage", rerank_width=32, radius=40.0)
    want = src.plan(JQuery(**kw))(jnp.asarray(Q))
    got = t.plan(Query(**kw))(Q)
    if backend == "int8":
        assert_results_agree(got, want)
    assert not np.isin(got.ids.numpy(), _deleted_ids()).any()
    assert_results_agree(back.plan(JQuery(**kw))(jnp.asarray(Q)), want)


def test_epoch_handle_isolates_errors_and_swaps():
    t = PDASCIndex.build(_integer_data(N, 0), gl=GL, distance=DIST,
                         shuffle=False,
                         device="cpu")
    t.enable_mutations(delta_capacity=64)
    j = JIndex.build(_integer_data(N, 0), gl=GL, distance=DIST,
                     shuffle=False)
    j.enable_mutations(delta_capacity=64)
    ops = [("upsert", _integer_data(3, 5)),
           ("upsert", (_integer_data(2, 6), np.array([1, 1], np.int32))),
           ("delete", np.array([4, 5], np.int32)),
           ("frobnicate", None),
           ("upsert", np.full((1, D), np.nan, np.float32)),
           ("upsert", _integer_data(40, 7))]
    th, jh = EpochHandle(t), JEpochHandle(j)
    out, jout = th.apply_writes(ops), jh.apply_writes(ops)
    assert [type(o).__name__ for o in out] == \
        [type(o).__name__ for o in jout]
    assert isinstance(out[1], ValueError) and isinstance(out[3], ValueError)
    assert out[2] == 2 and out[0].tolist() == [N, N + 1, N + 2]
    # 43 of 64 rows used: past delta_fill 0.5, so the run ended in a swap
    assert th.swaps == jh.swaps == 1 and th.current.epoch == 1
    assert th.current.delta.size == 0 and t.delta.size == 43
    assert th.current.n_points == jh.current.n_points == N + 43 - 2
    log = WriteLog()
    assert [log.append(k, p) for k, p in ops[:3]] == [0, 1, 2]
    assert [e[0] for e in log.since(0)] == [1, 2] and log.last_seq == 2


def test_epoch_handle_never_tears_under_a_reader():
    """A reader searching snapshots while a writer upserts, deletes and
    swaps epochs: every result comes from one snapshot (no id that the
    snapshot had deleted, no failure)."""
    t = PDASCIndex.build(_integer_data(N, 0), gl=GL, distance=DIST,
                         shuffle=False,
                         device="cpu")
    t.enable_mutations(delta_capacity=32)
    handle = EpochHandle(t, delta_fill=0.5)
    Q = _queries(n=8)
    stop, errors, seen = threading.Event(), [], []

    def reader():
        while not stop.is_set():
            snap = handle.current
            dead = set(snap.data.leaf_ids[torch.from_numpy(
                snap.tombstones.dead_slots())].tolist()) \
                if snap.tombstones.count else set()
            try:
                res = snap.plan(Query(k=5))(Q)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)
                return
            live = set(res.ids.flatten().tolist()) - {-1}
            if live & (dead - set(snap.delta.ids[snap.delta.active].tolist())):
                errors.append(("deleted id served", snap.epoch))
            seen.append(snap.epoch)

    th = threading.Thread(target=reader)
    th.start()
    rng = np.random.default_rng(8)
    for step in range(6):
        handle.apply_writes([
            ("upsert", _integer_data(6, 20 + step)),
            ("delete", rng.choice(N, 4, replace=False).astype(np.int32))])
    stop.set()
    th.join()
    assert not errors and seen
    assert handle.swaps >= 1


def test_write_validation_raises_where_repro_does():
    t = PDASCIndex.build(_integer_data(N, 0), gl=GL, distance=DIST,
                         shuffle=False,
                         device="cpu")
    j = JIndex.build(_integer_data(N, 0), gl=GL, distance=DIST,
                     shuffle=False)
    for idx in (t, j):
        idx.enable_mutations(delta_capacity=8)
        with pytest.raises(RuntimeError, match="delta buffer full"):
            idx.upsert(_integer_data(9, 9))
        with pytest.raises(ValueError, match="duplicate ids"):
            idx.upsert(_integer_data(2, 9), ids=[3, 3])
        with pytest.raises(ValueError, match="2 vectors but 1 ids"):
            idx.upsert(_integer_data(2, 9), ids=[3])
        with pytest.raises(ValueError, match="non-finite"):
            idx.upsert(np.full((1, D), np.inf, np.float32))
        assert idx.delete([10 ** 6]) == 0  # unknown ids are ignored
        with pytest.raises(ValueError, match="beam_vmap"):
            idx.delete([0])
            idx.plan(k=3, execution="beam_vmap")
    with pytest.raises(ValueError, match="unknown compaction scope"):
        t.compact(scope="everything")


def test_online_tiers_default_to_cuda_and_scan_on_their_own_device():
    """DeltaBuffer and TombstoneSet run on CUDA unless given device="cpu"
    (here, with no GPU, the default raises); a delta scan refuses queries
    on another device rather than moving them."""
    from repro_torch.online import DeltaBuffer, TombstoneSet

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DeltaBuffer(8, 4)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TombstoneSet(8)
    buf = DeltaBuffer(8, 4, device="cpu")
    assert TombstoneSet(8, device="cpu").device.type == "cpu"
    buf.append(np.eye(4, dtype=np.float32), np.arange(4), np.zeros(4))
    got = buf.scan(torch.eye(4), "euclidean", k=2)
    assert got.ids[:, 0].tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="queries on meta"):
        buf.scan(torch.eye(4, device="meta"), "euclidean", k=2)
