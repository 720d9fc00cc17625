"""The port's observability layer against ``repro``'s, on the CPU: the
catalogue of series, the registry (snapshots, Prometheus and JSON text,
percentiles, the dumper, ``set_enabled``, ``timed``), spans and traces,
the counters and spans that the ported modules emit for the same
operations, the shadow-recall estimator, the SLO tracker, the cost log and
the report.

Every test resets both registries first (``_fresh_registries``): engines,
stores and caches bind their series when they are made, so the indexes a
test compares are loaded after the reset. The index is one small artifact
built by ``repro`` (integer data, manhattan, ``shuffle=False``, an int8
store) and loaded into both packages, as in ``tests/test_torch_online.py``.
Timing histograms are compared by their counts only; no test asserts a
wall-clock bound.
"""

import io
import json
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core.index import PDASCIndex as JIndex
from repro.obs import names as jnames
from repro.online import EpochHandle as JEpochHandle
from repro.query import Query as JQuery
from repro_torch import obs
from repro_torch.core.index import PDASCIndex
from repro_torch.obs import names
from repro_torch.online import EpochHandle
from repro_torch.query import Query

N, D, GL, BLOCK = 600, 4, 24, 64
DIST = "manhattan"
# the subsystems the ported modules emit, compared series for series
PORTED = ("plan", "store", "online")


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
    obs.set_enabled(True)
    jobs.set_enabled(True)
    yield
    obs.set_enabled(True)
    jobs.set_enabled(True)


def integer_data(n, seed):
    return np.random.default_rng(seed).integers(0, 16, size=(n, D)).astype(
        np.float32)


def integer_queries(n=24, seed=2):
    return integer_data(n, seed) + 0.25


def save_repro_index(path):
    """A ``repro``-built index with an int8 store, saved at ``path``."""
    JIndex.build(integer_data(N, 0), gl=GL, distance=DIST, shuffle=False,
                 store="int8", store_block=BLOCK,
                 radius_quantile=0.3).save(path)
    return path


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    return save_repro_index(str(tmp_path_factory.mktemp("obs") / "idx"))


def load_pair(path):
    return JIndex.load(path), PDASCIndex.load(path, device="cpu")


def series_of(snap, subsystems):
    """The snapshot's series of ``subsystems``, timing histograms reduced
    to their counts."""
    out = {}
    for name, entry in snap.items():
        if names.subsystem(name) not in subsystems:
            continue
        rows = []
        for row in entry["series"]:
            if entry["kind"] == "histogram":
                rows.append((row["labels"], row["hist"]["count"]))
            else:
                rows.append((row["labels"], row["value"]))
        out[name] = (entry["kind"], rows)
    return out


# ---------------------------------------------------------------------------
# catalogue and registry
# ---------------------------------------------------------------------------


def test_catalogue_equals_repro():
    assert names.CATALOGUE == jnames.CATALOGUE
    assert names.SUBSYSTEMS == jnames.SUBSYSTEMS
    assert names.UNITS == jnames.UNITS
    assert names.NAME_RE.pattern == jnames.NAME_RE.pattern
    consts = {k: v for k, v in vars(jnames).items()
              if k.isupper() and isinstance(v, str)}
    assert consts == {k: v for k, v in vars(names).items()
                      if k.isupper() and isinstance(v, str)}
    assert set(consts.values()) == set(names.CATALOGUE)


@pytest.mark.parametrize("name", [
    "engine_requests_total", "router_request_seconds", "store_x_bytes",
    "plan_total", "bogus_requests_total", "engine_Requests_total",
    "engine__requests_total", "slo_sli_ratio"])
def test_check_and_subsystem_behave_alike(name):
    outcomes = []
    for mod in (names, jnames):
        try:
            mod.check(name)
            outcomes.append(("ok", mod.subsystem(name)))
        except ValueError:
            outcomes.append(("raises", None))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("name,kind", [
    ("engine_bogus_total", "counter"),  # well-formed, undocumented
    ("engine_requests_total", "gauge"),  # documented as a counter
    ("not a name", "counter")])
def test_default_registries_reject_alike(name, kind):
    for mod in (obs, jobs):
        with pytest.raises(ValueError):
            getattr(mod, kind)(name)


def _observe(mod, rng):
    """One fixed stream of observations through ``mod``'s registry."""
    n = mod.names
    for rid in ("r0", "r1"):
        mod.counter(n.ENGINE_REQUESTS, engine=rid).inc(int(rng.integers(50)))
        mod.counter(n.ENGINE_BATCHES, engine=rid).inc()
        mod.gauge(n.ENGINE_QUEUE_DEPTH, engine=rid).set(
            float(rng.integers(9)))
        h = mod.histogram(n.ENGINE_QUEUE_WAIT, engine=rid)
        for v in rng.exponential(2e-3, 300):
            h.observe(float(v))
        h.observe(float("nan"))
    g = mod.gauge(n.STORE_CACHE_RESIDENT, tier='we"ird\\label\n')
    g.inc(7)
    g.dec(2)
    ratio = mod.histogram(n.QUALITY_RECALL, (0.25, 0.5, 0.75, 1.0),
                          pipeline="beam", leg="normal")
    for v in rng.uniform(0, 1, 64):
        ratio.observe(float(v))
    with mod.timed(mod.histogram(n.ROUTER_LATENCY)):
        pass


@pytest.mark.parametrize("seed", [0, 1])
def test_registries_agree_on_the_same_observations(seed):
    _observe(obs, np.random.default_rng(seed))
    _observe(jobs, np.random.default_rng(seed))
    snap, jsnap = obs.snapshot(), jobs.snapshot()
    # ROUTER_LATENCY holds a wall-clock time: compared by its count
    t_lat = snap.pop(names.ROUTER_LATENCY)["series"][0]["hist"]["count"]
    j_lat = jsnap.pop(names.ROUTER_LATENCY)["series"][0]["hist"]["count"]
    assert t_lat == j_lat == 1
    assert snap == jsnap
    assert obs.to_prometheus(snap) == jobs.to_prometheus(jsnap)
    assert obs.to_json(snap, indent=1) == jobs.to_json(jsnap, indent=1)
    for rid in ("r0", "r1"):
        h = obs.histogram(names.ENGINE_QUEUE_WAIT, engine=rid)
        jh = jobs.histogram(names.ENGINE_QUEUE_WAIT, engine=rid)
        for q in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0):
            assert h.percentile(q) == jh.percentile(q)


def test_disabled_registries_and_dumpers_alike(tmp_path):
    for mod in (obs, jobs):
        mod.set_enabled(False)
        mod.counter(mod.names.ENGINE_REQUESTS, engine="r0").inc(5)
        mod.set_enabled(True)
        mod.counter(mod.names.ENGINE_REQUESTS, engine="r0").inc(2)
    texts = []
    for mod, tag in ((obs, "t"), (jobs, "j")):
        out = []
        for ext in (".json", ".prom"):
            d = mod.MetricsDumper(mod.registry(), str(tmp_path / (tag + ext)),
                                  period_s=0)
            d.close()  # a final dump
            out.append((tmp_path / (tag + ext)).read_text())
        buf = io.StringIO()
        mod.MetricsDumper(mod.registry(), "-", period_s=0).dump(buf)
        out.append(buf.getvalue())
        texts.append(out)
    assert texts[0] == texts[1]
    assert json.loads(texts[0][0])[names.ENGINE_REQUESTS]["series"][0][
        "value"] == 2


def test_launch_counter_loses_no_count_from_eight_threads():
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    per, workers = 5000, 8
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda name: [ops.count_launch(name) for _ in range(per)],
            args=(name,))
            for name in ("rank", "rank", "rank", "rank", "knn", "knn",
                         "scan", "pairwise")][:workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert ops.launch_counts() == dict(pairwise=per, rank=4 * per,
                                       knn=2 * per, swap_deltas=0, scan=per)
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}


# ---------------------------------------------------------------------------
# spans and traces
# ---------------------------------------------------------------------------


def _fixed_trace(mod):
    """A trace with fixed times: root 0..10 ms, two levels of children."""
    tr = mod.Trace("request", seq=16, kind="search")
    tr.trace_id = 7
    root = tr.root
    root.t0, root.t1 = 100.0, 100.010
    a = root.child("attempt", leg="primary", replica=1)
    a.t0, a.t1 = 100.0005, 100.0095
    for name, t0, t1 in (("queue_wait", 100.0005, 100.001),
                         ("batch_wait", 100.001, 100.002),
                         ("execute", 100.002, 100.009)):
        c = a.child(name)
        c.t0, c.t1 = t0, t1
    p = c.child("plan", pipeline="two_stage")
    p.t0, p.t1 = 100.0021, 100.0089
    tr.finish(outcome="ok")
    root.t1 = 100.010
    return tr


def test_spans_with_fixed_times_render_alike():
    t, j = _fixed_trace(obs), _fixed_trace(jobs)
    assert t.to_dict() == j.to_dict()
    assert t.render() == j.render()
    assert t.to_json(indent=1) == j.to_json(indent=1)
    buf, jbuf = obs.TraceBuffer(maxlen=2), jobs.TraceBuffer(maxlen=2)
    for b, mod in ((buf, obs), (jbuf, jobs)):
        for _ in range(3):
            b.add(_fixed_trace(mod))
    assert buf.to_json(indent=1) == jbuf.to_json(indent=1)
    assert len(buf) == len(jbuf) == 2
    assert buf.exemplar(0.01).to_dict() == jbuf.exemplar(0.01).to_dict()


def test_span_mirroring_and_sampling_alike():
    shapes = []
    for mod in (obs, jobs):
        assert not mod.is_tracing()
        parents = [mod.Span("a"), mod.Span("b")]
        with mod.activate(parents):
            assert mod.is_tracing() and mod.active_spans() == tuple(parents)
            with mod.span("plan", pipeline="beam"):
                with mod.span("scan", rows=3):
                    pass
        assert not mod.is_tracing()
        with mod.span("idle") as s:  # the no-op manager off the trace
            assert s is None
        sampler = mod.TraceSampler(every_n=4)
        picked = [seq for seq in range(20) if sampler.sample("r", seq)]
        shapes.append(([[(c.name, c.attrs, [(g.name, g.attrs)
                                            for g in c.children])
                         for c in p.children] for p in parents], picked))
    assert shapes[0] == shapes[1]
    assert obs.snapshot()[names.TRACE_SAMPLED]["series"][0]["value"] == 5


# ---------------------------------------------------------------------------
# the ported modules' counters and spans
# ---------------------------------------------------------------------------


def _drive(idx, handle_cls, query_cls, Q):
    """The same operations on either package's index: beam and two-stage
    plan executions (cache hits on the second call), a write run that
    trips a compaction, and the compacted epoch's searches."""
    beam, two = query_cls(k=5), query_cls(k=5, execution="two_stage")
    for _ in range(2):
        idx.plan(beam)(Q)
        idx.plan(two)(Q)
    idx.enable_mutations(delta_capacity=32)
    h = handle_cls(idx, delta_fill=0.5, tombstone_ratio=0.9)
    rows = integer_data(20, 5)
    out = h.apply_writes([("upsert", rows[:10]), ("delete", np.arange(8)),
                          ("delete", np.array([10 ** 6])),
                          ("upsert", rows[10:]), ("bogus", None)])
    assert isinstance(out[-1], ValueError)
    h.current.plan(two)(Q)
    h.current.plan(beam)(Q)
    return h


def test_counters_equal_repro_on_the_same_operations(saved):
    j, t = load_pair(saved)
    Q = integer_queries()
    jh = _drive(j, JEpochHandle, JQuery, Q)
    th = _drive(t, EpochHandle, Query, Q)
    assert jh.swaps == th.swaps == 1
    got = series_of(obs.snapshot(), PORTED)
    want = series_of(jobs.snapshot(), PORTED)
    for name in (names.PLAN_EXECUTIONS, names.PLAN_CACHE_HITS,
                 names.PLAN_COMPILES, names.ONLINE_WRITES,
                 names.ONLINE_WRITE_ERRORS, names.ONLINE_EPOCH_SWAPS,
                 names.ONLINE_COMPACTION_TIME, names.STORE_FETCHES,
                 names.STORE_FETCH_BYTES, names.STORE_HITS,
                 names.STORE_CACHE_HITS, names.STORE_CACHE_MISSES):
        assert name in got, name
    assert got == want


def test_two_stage_traced_span_names_equal_repro(saved):
    j, t = load_pair(saved)
    Q = integer_queries(8)
    trees = []
    for idx, mod, qcls in ((t, obs, Query), (j, jobs, JQuery)):
        plan = idx.plan(qcls(k=5, execution="two_stage"))
        plan(Q)  # untraced: no spans anywhere
        tr = mod.Trace("request")
        with mod.activate([tr.root]):
            plan(Q)
        tr.finish()
        trees.append([(s.name, sorted(s.attrs)) for s in tr.root.walk()])
        for s in tr.root.walk():  # every child inside its parent
            for c in s.children:
                assert s.t0 <= c.t0 <= c.t1 <= s.t1, (s.name, c.name)
    assert trees[0] == trees[1]
    assert [n for n, _ in trees[0]] == [
        "request", "plan", "descend", "scan", "granule_fetch", "rerank"]


def test_recall_estimator_and_wilson_equal_repro(saved):
    j, t = load_pair(saved)
    Q = integer_queries(32, seed=9)
    served = []
    for q in Q:  # served answers: a narrow beam, so recall is below 1
        served.append(np.asarray(
            j.plan(JQuery(k=10, beam=2))(q).ids).reshape(-1))
    ests = []
    for mod, src in ((obs, t), (jobs, j)):
        est = mod.RecallEstimator(src, every_n=3)
        try:
            picked = [est.observe(i, Q[i], served[i], pipeline="beam")
                      for i in range(len(Q))]
            assert est.drain(timeout=60)
            ests.append((picked, est.estimate(), est.legs()))
        finally:
            est.close()
    assert ests[0][0] == ests[1][0]
    assert ests[0][1] == ests[1][1]
    assert ests[0][2] == ests[1][2] == [("beam", "normal")]
    assert 0 < ests[0][1]["recall"] < 1
    for s, n in ((0, 0), (3, 10), (97, 100), (100, 100)):
        assert obs.wilson(s, n) == jobs.wilson(s, n)
    snap, jsnap = obs.snapshot(), jobs.snapshot()
    for name in (names.QUALITY_RECALL_MEAN, names.QUALITY_RECALL_LO,
                 names.QUALITY_RECALL_HI, names.QUALITY_SAMPLED,
                 names.QUALITY_ANSWERED):
        assert snap[name] == jsnap[name], name


def test_recall_estimator_keeps_its_reference_on_the_index_device(saved):
    t = PDASCIndex.load(saved, device="cpu")
    est = obs.RecallEstimator(t, every_n=1)
    try:
        idx, (vecs, ids) = est._reference()
        assert isinstance(vecs, torch.Tensor) and vecs.device == t.device
        assert est._reference()[1][0] is vecs  # cached: no second upload
        t.upsert(integer_data(1, 11))  # the live set changed
        assert est._reference()[1][0] is not vecs
    finally:
        est.close()


def test_slo_tracker_alerts_equal_repro():
    states = []
    for mod in (obs, jobs):
        slo = mod.SLOTracker(mod.SLOSpec(latency_p99_s=0.05,
                                         recall_floor=0.9, window_s=60.0))
        for i in range(40):
            slo.record_request(0.2 if i % 3 == 0 else 0.01, ok=i % 7 != 0)
            slo.record_recall(0.5 if i % 2 else 0.95)
        slo.evaluate()
        for _ in range(40):
            slo.record_request(0.01, ok=True)
            slo.record_recall(0.99)
        slo.evaluate(now=slo._t0 + 1e3)  # past the window: alerts clear
        events = [{k: v for k, v in e.items() if k != "t"}
                  for e in slo.events()]
        states.append((events, slo.alert_counts()))
    assert states[0] == states[1]
    assert states[0][1] == {"latency": 1, "availability": 1, "recall": 1}
    got = series_of(obs.snapshot(), ("slo",))
    assert got == series_of(jobs.snapshot(), ("slo",))


def test_cost_log_records_equal_repro(tmp_path, saved):
    j, t = load_pair(saved)
    records = []
    for mod, idx, qcls, tag in ((obs, t, Query, "t"), (jobs, j, JQuery, "j")):
        desc = idx.plan(qcls(k=5, execution="two_stage")).describe()
        log = mod.CostLog(str(tmp_path / f"{tag}.jsonl"))
        log.record(_fixed_trace(mod), desc, replica=1)
        log.record(_fixed_trace(mod).to_dict(), None)
        log.close()
        loaded = mod.load_costlog(str(tmp_path / f"{tag}.jsonl"))
        assert len(log) == len(loaded) == 2
        records.append(loaded)
    # the capabilities differ only in the port's `device` field, which
    # a cost record does not carry
    assert records[0] == records[1]


def test_report_text_equals_repro(tmp_path):
    for mod in (obs, jobs):
        _observe(mod, np.random.default_rng(3))
        mod.counter(mod.names.STORE_CACHE_HITS, tier="host").inc(30)
        mod.counter(mod.names.STORE_CACHE_MISSES, tier="host").inc(10)
    snap = obs.snapshot()
    jsnap = jobs.snapshot()
    for s in (snap, jsnap):  # the one wall-clock series, made equal
        s[names.ROUTER_LATENCY] = snap[names.ROUTER_LATENCY]
    traces = [_fixed_trace(obs).to_dict()]
    rep = obs.build_report(snap, traces)
    jrep = jobs.build_report(jsnap, [_fixed_trace(jobs).to_dict()])
    assert rep == jrep
    from repro.obs import report as jreport
    from repro_torch.obs import report

    assert report.render_text(rep) == jreport.render_text(jrep)
    assert report.render_html(rep) == jreport.render_html(jrep)
    assert obs.render_dashboard(snap) == jobs.render_dashboard(jsnap)
    (tmp_path / "m.json").write_text(obs.to_json(snap))
    (tmp_path / "t.json").write_text(json.dumps({"traces": traces}))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", "--metrics",
         str(tmp_path / "m.json"), "--trace", str(tmp_path / "t.json")],
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout == report.render_text(rep)
