"""The port's serving layer against ``repro``'s, on the CPU: fault plans,
``degraded``, the batching engine (answers, deadline drops, cancellation,
writes between batches, a failing handler), ``clone_index`` and the
replica set's write fan-out with kill + restart, the router under a
wedged replica, and the ``launch.serve`` entry point on both of its paths.

The index is the small ``repro``-built artifact of
``tests/test_torch_obs.py`` (integer data, manhattan, an int8 store),
loaded into both packages. Answers are held to ``repro``'s under the rule
of ``tests/test_torch_search.py`` (ids equal except among near-ties) and
to the port's own plan bit for bit: a query's answer must not depend on
the batch it rode in. Every engine, router and estimator is closed in a
``finally``, every wait has a timeout, and no test asserts a wall-clock
bound.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core.index import PDASCIndex as JIndex
from repro.online import EpochHandle as JEpochHandle
from repro.online import live_dataset as jlive_dataset
from repro.query import Query as JQuery
from repro.query import degraded as jdegraded
from repro.serving import BatchingEngine as JEngine
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import QueryHandler as JQueryHandler
from repro.serving import ReplicaSet as JReplicaSet
from repro_torch import obs
from repro_torch.core.index import PDASCIndex
from repro_torch.core.nsa import SearchResult
from repro_torch.online import EpochHandle, live_dataset
from repro_torch.query import Query, degraded
from repro_torch.serving import (
    BatchingEngine,
    Cancelled,
    DeadlineExceeded,
    FaultPlan,
    QueryHandler,
    ReplicaSet,
    Router,
    RouterConfig,
    clone_index,
)
from repro_torch.serving import faults as tfaults
from repro.serving import faults as jfaults
from test_torch_obs import integer_data, integer_queries, save_repro_index
from test_torch_search import assert_results_agree

QUERY = dict(k=5, execution="beam", beam=16, with_stats=False)
WAIT = 60.0  # every wait's timeout (s)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_registries():
    obs.reset()
    jobs.reset()
    yield


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    return save_repro_index(str(tmp_path_factory.mktemp("serving") / "idx"))


def _as_result(dists, ids):
    return SearchResult(dists=np.asarray(dists), ids=np.asarray(ids),
                        n_candidates=np.zeros(len(ids), np.int32))


# ---------------------------------------------------------------------------
# fault plans and degraded
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", [
    "wedge:r1@20+8", "wedge:r1@6+5:0.5",
    "latency:r0@10+30:0.05;error:r2@40+5",
    "wedge:r1@20+8; error:r0@5+3 , latency:r2@0+4:0.1", "crash:r3@0+1"])
def test_fault_plan_parse_equals_repro(text):
    t, j = FaultPlan.parse(text), JFaultPlan.parse(text)
    assert [vars(s) for s in t.specs] == [vars(s) for s in j.specs]
    assert t.max_dispatch() == j.max_dispatch()
    for r in range(4):
        assert [vars(s) for s in t.for_replica(r)] == \
            [vars(s) for s in j.for_replica(r)]


@pytest.mark.parametrize("bad", ["wedge:r1", "nope:r0@1+2", "wedge:r1@1+0"])
def test_fault_plan_parse_refuses_alike(bad):
    for cls in (FaultPlan, JFaultPlan):
        with pytest.raises(ValueError):
            cls.parse(bad)


@pytest.mark.parametrize("seed", [0, 1, 17])
def test_fault_plan_generate_equals_repro(seed):
    kw = dict(seed=seed, n_replicas=4, n_faults=6, horizon=50)
    t, j = FaultPlan.generate(**kw), JFaultPlan.generate(**kw)
    assert [vars(s) for s in t.specs] == [vars(s) for s in j.specs]


def test_fault_injectors_fire_alike():
    text = "latency:r0@1+2:0.001;error:r0@4+2;crash:r0@7+1"
    outcomes = []
    for cls, mod in ((FaultPlan, tfaults), (JFaultPlan, jfaults)):
        inj = cls.parse(text).injector(0)
        seen = []
        for _ in range(9):
            try:
                inj.on_dispatch()
                seen.append("ok")
            except mod.InjectedFault:
                seen.append("error")
            except mod.ReplicaCrashed:
                seen.append("crash")
        outcomes.append((seen, inj.dispatches))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ["ok"] * 4 + ["error"] * 2 + ["ok", "crash", "ok"]


@pytest.mark.parametrize("beam", [32, 9, (32, 16, 4)])
def test_degraded_equals_repro(beam):
    t = degraded(Query(k=10, beam=beam, rerank_width=64))
    j = jdegraded(JQuery(k=10, beam=beam, rerank_width=64))
    assert (t.k, t.beam, t.rerank_width, t.exact_rerank, t.with_stats) == \
        (j.k, j.beam, j.rerank_width, j.exact_rerank, j.with_stats)


# ---------------------------------------------------------------------------
# the batching engine
# ---------------------------------------------------------------------------


def test_engine_answers_equal_repro_and_the_plan_rows(saved):
    j, t = JIndex.load(saved), PDASCIndex.load(saved, device="cpu")
    Q = integer_queries(40, seed=4)
    engines = [BatchingEngine(QueryHandler(t, Query(**QUERY)), batch_size=8,
                              max_wait_ms=2.0, name="t"),
               JEngine(JQueryHandler(j, JQuery(**QUERY)), batch_size=8,
                       max_wait_ms=2.0, name="j")]
    try:
        answers = []
        for eng in engines:
            reqs = []
            lock = threading.Lock()

            def submit(rows, eng=eng, reqs=reqs, lock=lock):
                for i in rows:
                    r = eng.submit(Q[i])
                    with lock:
                        reqs.append((i, r))

            threads = [threading.Thread(target=submit,
                                        args=(range(w, len(Q), 4),))
                       for w in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=WAIT)
            got = {i: r.wait(timeout=WAIT) for i, r in reqs}
            answers.append([got[i] for i in range(len(Q))])
            assert eng.stats["requests"] >= len(Q)
    finally:
        for eng in engines:
            eng.close()
    tres, jres = answers
    for d, i in tres:  # callers get numpy rows, as from repro
        assert isinstance(d, np.ndarray) and isinstance(i, np.ndarray)
    got = _as_result(np.stack([a[0] for a in tres]),
                     np.stack([a[1] for a in tres]))
    want = _as_result(np.stack([a[0] for a in jres]),
                      np.stack([a[1] for a in jres]))
    assert_results_agree(got, want)
    plan = t.plan(Query(**QUERY))(Q)
    np.testing.assert_array_equal(got.ids, plan.ids.numpy())
    np.testing.assert_array_equal(got.dists, plan.dists.numpy())


class _Gate:
    """A handler that blocks its first call until released, so requests
    queue behind it deterministically."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()
        self.calls = 0

    def __call__(self, batch, n_valid):
        self.calls += 1
        if self.calls == 1:
            self.entered.set()
            assert self.release.wait(WAIT)
        return batch.sum(axis=1), np.arange(len(batch))


def _drops_and_cancels(engine_cls, cancelled_cls, deadline_cls):
    gate = _Gate()
    eng = engine_cls(gate, batch_size=4, max_wait_ms=1.0)
    try:
        first = eng.submit(np.ones(3, np.float32))
        assert gate.entered.wait(WAIT)
        expired = [eng.submit(np.full(3, i, np.float32), deadline_s=0.001)
                   for i in range(3)]
        dropped = eng.submit(np.zeros(3, np.float32))
        dropped.cancel()
        timed_out = eng.submit(np.zeros(3, np.float32))
        with pytest.raises(TimeoutError):
            timed_out.wait(timeout=0.01)  # a waiter that gives up cancels
        live = eng.submit(np.full(3, 2, np.float32), deadline_s=WAIT)
        time.sleep(0.05)  # the deadlines pass while the worker is held
        gate.release.set()
        out = [first.wait(timeout=WAIT)[0], live.wait(timeout=WAIT)[0]]
        kinds = []
        for r in expired + [dropped, timed_out]:
            with pytest.raises((cancelled_cls, deadline_cls)) as e:
                r.wait(timeout=WAIT)
            kinds.append(type(e.value).__name__)
        return out, kinds, {k: v for k, v in eng.stats.items()
                            if k != "occupancy_sum"}
    finally:
        gate.release.set()
        eng.close()


def test_engine_deadline_drops_and_cancellation_equal_repro():
    from repro.serving import Cancelled as JCancelled
    from repro.serving import DeadlineExceeded as JDeadline

    t = _drops_and_cancels(BatchingEngine, Cancelled, DeadlineExceeded)
    j = _drops_and_cancels(JEngine, JCancelled, JDeadline)
    assert t == j
    assert t[1] == ["DeadlineExceeded"] * 3 + ["Cancelled"] * 2
    assert t[2]["deadline_drops"] == 3 and t[2]["cancelled_skips"] == 2
    snap = obs.snapshot()
    assert snap[obs.names.ENGINE_DEADLINE_DROPS]["series"][0]["value"] == 3


def _failing_batch(engine_cls):
    calls = []

    def handler(batch, n_valid):
        calls.append(n_valid)
        if len(calls) == 1:
            raise RuntimeError("boom")
        return batch[:, 0], batch[:, 1]

    eng = engine_cls(handler, batch_size=2, max_wait_ms=1.0)
    try:
        bad = eng.submit(np.array([1.0, 2.0], np.float32))
        with pytest.raises(RuntimeError, match="boom"):
            bad.wait(timeout=WAIT)
        good = eng.submit(np.array([3.0, 4.0], np.float32))
        a, b = good.wait(timeout=WAIT)  # the worker survived
        return float(a), float(b), eng.stats["batches"]
    finally:
        eng.close()


def test_engine_handler_error_fails_one_batch_alike():
    assert _failing_batch(BatchingEngine) == _failing_batch(JEngine) == \
        (3.0, 4.0, 2)
    snap = obs.snapshot()
    assert snap[obs.names.ENGINE_HANDLER_ERRORS]["series"][0]["value"] == 1


def test_engine_writes_between_batches_read_your_writes(saved):
    runs = []
    rows = integer_data(6, 21) + 0.5
    for idx, hcls, qh, ecls, qcls in (
            (PDASCIndex.load(saved, device="cpu"), EpochHandle, QueryHandler,
             BatchingEngine, Query),
            (JIndex.load(saved), JEpochHandle, JQueryHandler, JEngine,
             JQuery)):
        idx.enable_mutations(delta_capacity=64)
        handle = hcls(idx, delta_fill=0.9)
        eng = ecls(qh(handle, qcls(**QUERY)), batch_size=4, max_wait_ms=1.0,
                   write_handler=handle.apply_writes)
        try:
            ids = [eng.submit_upsert(r) for r in rows]
            hits = [eng.submit(r) for r in rows]  # queued after the writes
            new = [int(np.asarray(w.wait(timeout=WAIT))[0]) for w in ids]
            first = [int(h.wait(timeout=WAIT)[1][0]) for h in hits]
            gone = eng.submit_delete(np.array(new[:3]))
            assert int(gone.wait(timeout=WAIT)) == 3
            after = [h.wait(timeout=WAIT)[1]
                     for h in [eng.submit(r) for r in rows[:3]]]
            runs.append((new, first, [sorted(set(a.tolist()) & set(new))
                                      for a in after], eng.stats["writes"]))
        finally:
            eng.close()
    assert runs[0] == runs[1]
    new, first, after, writes = runs[0]
    assert first == new  # each upserted vector found first, right after
    assert after == [[]] * 3 and writes == 7  # no deleted id served


# ---------------------------------------------------------------------------
# replicas and the router
# ---------------------------------------------------------------------------


def test_clone_index_shares_the_levels_and_refuses_dirty_tiers(saved):
    t = PDASCIndex.load(saved, device="cpu")
    c = clone_index(t)
    assert c is not t and c.data is t.data and c.store is t.store
    assert c.delta is None and c.tombstones is None
    t.upsert(integer_data(1, 3))
    with pytest.raises(ValueError, match="clean online tiers"):
        clone_index(t)


def _live(idx_live):
    vecs, ids = idx_live
    order = np.argsort(ids, kind="stable")
    return ids[order], vecs[order]


def test_replica_set_writes_and_restart_equal_repro(saved):
    sets = []
    rng = np.random.default_rng(5)
    ups = integer_data(12, 31) + 0.5
    dead = rng.choice(600, 5, replace=False)
    for idx, cls, live in (
            (PDASCIndex.load(saved, device="cpu"), ReplicaSet, live_dataset),
            (JIndex.load(saved), JReplicaSet, jlive_dataset)):
        rs = cls(idx, (Query if cls is ReplicaSet else JQuery)(**QUERY),
                 n_replicas=3, batch_size=4, max_wait_ms=0.5)
        try:
            ids = [int(x) for x in rs.upsert(ups[:6])]
            assert int(rs.delete(dead)) == 5
            rs.kill(2)
            ids += [int(x) for x in rs.upsert(ups[6:])]  # r2 misses these
            rs.delete(np.array(ids[:2]))
            rs.restart(2)  # replays the log suffix it missed
            probe = rs.replicas[2].engine.submit(ups[0])
            probe.wait(timeout=WAIT)  # its queue drained past the replay
            for r in rs.replicas:  # every replica drained its writes
                r.submit(ups[0]).wait(timeout=WAIT)
            lives = [_live(live(r.handle.current)) for r in rs.replicas]
            for ids_r, vecs_r in lives[1:]:
                np.testing.assert_array_equal(ids_r, lives[0][0])
                np.testing.assert_array_equal(vecs_r, lives[0][1])
            sets.append((ids, lives[0]))
        finally:
            rs.close()
    (tids, (tl, tv)), (jids, (jl, jv)) = sets
    assert tids == jids
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tv, jv)


def test_router_answers_equal_the_plan_and_route_around_a_wedge(saved):
    t = PDASCIndex.load(saved, device="cpu")
    q = Query(**QUERY)
    Q = integer_queries(30, seed=6)
    want = t.plan(q)(Q)
    plan = FaultPlan.parse("wedge:r1@1+4:0.4")
    rs = ReplicaSet(t, q, n_replicas=3, batch_size=4, max_wait_ms=0.5,
                    degraded_query=degraded(q), fault_plan=plan)
    router = Router(rs, RouterConfig(
        deadline_s=10.0, hedge=True, hedge_min_s=0.02, eject_failures=2,
        probe_cooldown_s=0.05, probe_timeout_s=0.2, probe_interval_s=0.02,
        seed=0, trace_every=4))
    errors = 0
    try:
        for i in range(len(Q)):
            try:
                res = router.search(Q[i])
            except Exception:  # noqa: BLE001 — the caller-visible count
                errors += 1
                continue
            assert isinstance(res.ids, np.ndarray)
            if not res.degraded:
                np.testing.assert_array_equal(res.ids, want.ids[i].numpy())
                np.testing.assert_array_equal(res.dists,
                                              want.dists[i].numpy())
            time.sleep(0.005)
        deadline = time.time() + WAIT
        while time.time() < deadline:
            if router.event_counts().get("readmit", 0) >= 1:
                break
            router.search(Q[0])
            time.sleep(0.05)
        ev = router.event_counts()
        assert errors == 0
        assert ev.get("eject", 0) >= 1 and ev.get("readmit", 0) >= 1, ev
        ex = router.traces.exemplar()
        names = {s.name for s in ex.root.walk()}
        assert {"attempt", "queue_wait", "batch_wait", "execute",
                "plan"} <= names, names
    finally:
        router.close(close_replicas=True)
    snap = obs.snapshot()
    for name in (obs.names.ROUTER_REQUESTS, obs.names.ENGINE_REQUESTS,
                 obs.names.PLAN_EXECUTIONS, obs.names.TRACE_FINISHED):
        assert sum(r["value"] for r in snap[name]["series"]) > 0, name


# ---------------------------------------------------------------------------
# the serve entry point
# ---------------------------------------------------------------------------

SERVE = ["--n", "2000", "--gl", "64", "--queries", "48", "--batch", "8",
         "--mode", "beam", "--beam", "16", "--device", "cpu"]


def test_serve_single_engine_path_runs_to_its_end(tmp_path, capsys):
    from repro_torch.launch import serve

    dump, traces = tmp_path / "m.json", tmp_path / "t.json"
    serve.main(SERVE + ["--churn", "12", "--trace-sample", "8",
                        "--shadow-sample", "8", "--metrics-dump", str(dump),
                        "--trace-dump", str(traces), "--cost-log",
                        str(tmp_path / "c.jsonl")])
    out = capsys.readouterr().out
    assert "recall@10=" in out and "online recall estimate" in out, out
    assert "epoch_swaps=" in out and "slowest sampled trace" in out
    assert dump.exists() and traces.exists()
    assert len(obs.load_costlog(str(tmp_path / "c.jsonl"))) == 6


def test_serve_replicated_path_runs_to_its_end(capsys):
    from repro_torch.launch import serve

    serve.main(SERVE + ["--replicas", "3", "--faults", "wedge:r1@20+8:0.4",
                        "--churn", "12", "--shadow-sample", "16",
                        "--slo-p99-ms", "500"])
    out = capsys.readouterr().out
    assert "errors=0" in out and "online recall estimate" in out, out


def test_serve_build_slab_follows_gl(monkeypatch):
    """The CLI's build clusters slabs of about 2^26 distances, so the slab
    follows ``--gl`` (1,024 groups at gl 256, 16,384 at gl 64); the index
    does not depend on it."""
    from repro_torch.launch import serve

    seen = []
    real = serve.PDASCIndex.build

    def spy(*args, **kw):
        seen.append((kw["gl"], kw["group_chunk"]))
        return real(*args, **kw)

    monkeypatch.setattr(serve.PDASCIndex, "build", spy)
    monkeypatch.setattr(serve, "_serve_single", lambda *a: None)
    serve.main(SERVE)
    serve.main(SERVE + ["--gl", "256"])
    assert seen == [(64, 16384), (256, 1024)]


def test_serve_refuses_the_remote_store(capsys):
    """``--store remote`` is ported: the two-stage index moves its exact
    payload into a simulated object store and serves from it, on the
    single-engine path and (errors=0) on the replicated one."""
    from repro_torch.launch import serve

    remote = ["--mode", "two_stage", "--store", "remote", "--store-block",
              "64", "--remote-latency-ms", "0.1", "--remote-cache-granules",
              "4", "--remote-prefetch-workers", "1"]
    serve.main(SERVE + remote)
    out = capsys.readouterr().out
    assert "remote exact tier" in out and "recall@10=" in out, out
    assert "exact payload in a remote store" in out
    serve.main(SERVE + remote + ["--replicas", "2"])
    assert "errors=0" in capsys.readouterr().out
