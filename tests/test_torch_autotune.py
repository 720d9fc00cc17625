"""The port's launch-geometry autotuner (``repro_torch.kernels.autotune``)
against ``repro.kernels.autotune``: the winner cache's round trip,
bucketing, keys and file format (each package reads the other's file and
keeps its entries), corrupt and stale files, the resolution precedence at
``ops`` dispatch, the candidate grids and their limits, and the plan
compiler's re-plan on a retune.

Timing is injected (``tune(measure=...)``): the CPU has no CUDA kernel to
time, and the tuner never times a plain version (``time_knobs`` raises
there). The grids are checked at the main path's shapes and at ragged ones
through the geometry functions the wrappers launch with.
"""

from __future__ import annotations

import json
import os
import threading
import warnings

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jautotune
from repro_torch import obs
from repro_torch.core.index import PDASCIndex
from repro_torch.kernels import autotune, kmedoids, ops, quantized, topk
from repro_torch.obs import names as mnames
from repro_torch.query import Query, plan_stats, reset_plan_stats

# (op, shape): the main path's shapes and ragged ones (rank / scan / knn:
# (rows, width, d, k); swap: (g, k))
GRID_SHAPES = [
    ("rank", (1000, 384, 100, 10)), ("rank", (1, 1, 3, 1)),
    ("scan", (1000, 384, 100, 10)), ("scan", (1, 1, 3, 1)),
    ("knn", (1000, 1_000_000, 100, 10)), ("knn", (1000, 100_000, 1536, 10)),
    ("swap", (256, 128)), ("swap", (1457, 728)),
    ("pairwise", (1024, 256, 256, 100)),
]


@pytest.fixture()
def tuner_cache(tmp_path):
    """Point both tuners at one throwaway cache file; restore the defaults
    (and drop the in-memory snapshots) afterwards."""
    path = str(tmp_path / "tune.json")
    autotune.set_cache_path(path)
    jautotune.set_cache_path(path)
    yield path
    autotune.set_cache_path(None)
    jautotune.set_cache_path(None)


def _fake_measure(best_knobs, best_us=10.0, other_us=100.0):
    """A deterministic timer: ``best_knobs`` is fast, everything else slow."""
    def measure(knobs):
        return best_us if knobs == best_knobs else other_us
    return measure


def _count(name, op) -> float:
    return obs.counter(name, op=op).value


# ---------------------------------------------------------------------------
# Cache round trip
# ---------------------------------------------------------------------------


def test_tune_caches_winner_and_second_call_never_times(tuner_cache):
    shape = (64, 96, 32, 10)
    fast = dict(wpq=1, qpb=4)
    r1 = autotune.tune("rank", form="l2", dtype="float32", shape=shape,
                       measure=_fake_measure(fast))
    assert not r1["cached"]
    assert r1["winner"] == fast and r1["winner_us"] == 10.0
    # the heuristic's geometry is the sweep's first member
    assert r1["default"] == autotune.heuristic("rank", shape, "l2")
    assert r1["sweep"][0]["knobs"] == r1["default"]
    assert r1["default_us"] == 100.0
    gen = autotune.generation()

    def exploding_measure(knobs):  # pragma: no cover - must not run
        raise AssertionError("a cache hit must not time anything")

    r2 = autotune.tune("rank", form="l2", dtype="float32", shape=shape,
                       measure=exploding_measure)
    assert r2["cached"] and r2["winner"] == fast
    assert autotune.generation() == gen  # a read changes nothing

    autotune.set_cache_path(tuner_cache)  # a fresh snapshot from the file
    assert autotune.lookup(op="rank", form="l2", dtype="float32",
                           shape=shape) == fast
    blob = json.load(open(tuner_cache))
    assert blob["version"] == autotune.CACHE_VERSION


def test_record_bumps_generation(tuner_cache):
    g0 = autotune.generation()
    retunes = _count(mnames.AUTOTUNE_RETUNES, "swap")
    autotune.record(op="swap", form="none", dtype="float32", shape=(96, 48),
                    knobs=dict(kb=32), us=5.0)
    assert autotune.generation() == g0 + 1
    assert _count(mnames.AUTOTUNE_RETUNES, "swap") == retunes + 1


def test_concurrent_record_never_tears_the_cache_file(tuner_cache):
    """Parallel writers never leave a torn JSON on disk: every save goes
    through its own temp file and an atomic rename."""
    stop = threading.Event()
    bad: list = []

    def reader():
        while not stop.is_set():
            if not os.path.exists(tuner_cache):
                continue
            try:
                blob = json.load(open(tuner_cache))
                assert blob["version"] == autotune.CACHE_VERSION
            except (ValueError, AssertionError) as e:
                bad.append(repr(e))
                return

    def writer(base):
        for i in range(25):
            autotune.record(op="swap", form=f"f{base + i}", dtype="float32",
                            shape=(96, 48), knobs=dict(kb=32), us=float(i))

    rt = threading.Thread(target=reader)
    writers = [threading.Thread(target=writer, args=(1000 * w,))
               for w in range(4)]
    rt.start()
    for t in writers:
        t.start()
    for t in writers:
        t.join(timeout=60)
        assert not t.is_alive()
    stop.set()
    rt.join(timeout=60)
    assert not rt.is_alive()
    assert not bad, f"a reader saw a torn cache file: {bad}"
    leftovers = [f for f in os.listdir(os.path.dirname(tuner_cache))
                 if f.endswith(".tmp")]
    assert not leftovers, leftovers
    assert len(json.load(open(tuner_cache))["entries"]) == 100


# ---------------------------------------------------------------------------
# Bucketing and keys
# ---------------------------------------------------------------------------


def test_shape_bucket_power_of_two_boundaries():
    assert autotune.shape_bucket((127, 128, 129)) == (128, 128, 256)
    assert autotune.shape_bucket((1, 2, 3)) == (1, 2, 4)
    assert autotune.shape_bucket((0,)) == (1,)


@pytest.mark.parametrize("shape", [
    (0,), (1,), (2, 3), (127, 128, 129), (1000, 384, 100, 10),
    (1000, 1_000_000, 100, 10), (1457, 728), (1, 1, 3, 1),
    (1024, 256, 256, 100), (65, 1025, 65, 4097)])
@pytest.mark.parametrize("backend", ["cuda", "cpu", "tpu"])
def test_bucket_and_key_equal_repro(shape, backend):
    assert autotune.shape_bucket(shape) == jautotune.shape_bucket(shape)
    for op, form, dtype in [("rank", "l2", "float32"), ("scan", "l1", "int4"),
                            ("swap", "none", "float32")]:
        assert autotune.cache_key(op, form, dtype, shape, backend=backend) \
            == jautotune.cache_key(op, form, dtype, shape, backend=backend)
    assert autotune.cache_key("knn", "l2", "float32", shape).startswith(
        "cuda|knn|l2|float32|")


def test_lookup_hits_any_shape_in_the_bucket(tuner_cache):
    autotune.record(op="knn", form="l2", dtype="float32",
                    shape=(100, 2000, 70, 10), knobs=dict(bq=32, splits=2),
                    us=1.0)
    # (100, 2000, 70, 10) buckets to (128, 2048, 128, 16)
    for shape in [(128, 2048, 128, 16), (65, 1025, 65, 9), (100, 2000, 70, 10)]:
        assert autotune.lookup(op="knn", form="l2", dtype="float32",
                               shape=shape) == dict(bq=32, splits=2), shape
    # the next bucket up misses, in rows and in k
    for shape in [(129, 2048, 128, 16), (128, 2048, 128, 17)]:
        assert autotune.lookup(op="knn", form="l2", dtype="float32",
                               shape=shape) is None


def test_cache_key_is_backend_and_dtype_scoped(tuner_cache):
    autotune.record(op="scan", form="l2", dtype="int8",
                    shape=(16, 64, 16, 8), knobs=dict(wpq=2, qpb=4), us=1.0)
    assert autotune.lookup(op="scan", form="l2", dtype="int4",
                           shape=(16, 64, 16, 8)) is None
    assert autotune.lookup(op="scan", form="l2", dtype="int8",
                           shape=(16, 64, 16, 8), backend="tpu") is None
    assert autotune.lookup(op="scan", form="l2", dtype="int8",
                           shape=(16, 64, 16, 8)) == dict(wpq=2, qpb=4)


def test_cache_files_cross_between_packages(tuner_cache):
    """One file, both packages: each loads the other's writes without a
    warning and keeps the other's entries when it records its own."""
    jautotune.record(op="swap", form="none", dtype="float32", shape=(96,),
                     knobs=dict(bg=32), us=2.0, backend="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        autotune.set_cache_path(tuner_cache)  # re-read the file
        assert autotune.lookup(op="swap", form="none", dtype="float32",
                               shape=(96,), backend="cpu") == dict(bg=32)
        autotune.record(op="swap", form="none", dtype="float32",
                        shape=(96, 48), knobs=dict(kb=32), us=1.0)
        jautotune.set_cache_path(tuner_cache)
        assert jautotune.lookup(op="swap", form="none", dtype="float32",
                                shape=(96,), backend="cpu") == dict(bg=32)
        assert jautotune.lookup(op="swap", form="none", dtype="float32",
                                shape=(96, 48), backend="cuda") == dict(kb=32)
        jautotune.record(op="rank", form="l2", dtype="float32",
                         shape=(8, 64, 16), knobs=dict(bq=8, bn=64), us=3.0,
                         backend="cpu")
        autotune.set_cache_path(tuner_cache)
        assert autotune.lookup(op="swap", form="none", dtype="float32",
                               shape=(96, 48)) == dict(kb=32)
    entries = json.load(open(tuner_cache))["entries"]
    assert sorted(entries) == sorted([
        "cpu|swap|none|float32|128", "cuda|swap|none|float32|128x64",
        "cpu|rank|l2|float32|8x64x16"])


# ---------------------------------------------------------------------------
# Corrupt / stale / missing cache files: warn and ignore, never raise
# ---------------------------------------------------------------------------


def test_corrupt_cache_file_warns_and_is_ignored(tmp_path):
    path = str(tmp_path / "corrupt.json")
    with open(path, "w") as f:
        f.write("{not json!!")
    autotune.set_cache_path(path)
    try:
        with pytest.warns(UserWarning, match="corrupt"):
            assert autotune.lookup(op="rank", form="l2", dtype="float32",
                                   shape=(64, 96, 32, 10)) is None
        autotune.record(op="rank", form="l2", dtype="float32",
                        shape=(64, 96, 32, 10), knobs=dict(wpq=1, qpb=8),
                        us=1.0)
        assert json.load(open(path))["version"] == autotune.CACHE_VERSION
    finally:
        autotune.set_cache_path(None)


def test_stale_version_cache_warns_and_is_ignored(tmp_path):
    path = str(tmp_path / "stale.json")
    with open(path, "w") as f:
        json.dump({"version": autotune.CACHE_VERSION + 1, "entries": {
            "cuda|rank|l2|float32|64x128x32x16": {
                "knobs": {"wpq": 8}, "us": 1.0}}}, f)
    autotune.set_cache_path(path)
    try:
        with pytest.warns(UserWarning, match="version"):
            assert autotune.lookup(op="rank", form="l2", dtype="float32",
                                   shape=(64, 96, 32, 10)) is None
    finally:
        autotune.set_cache_path(None)


def test_missing_cache_file_is_silently_empty(tmp_path):
    autotune.set_cache_path(str(tmp_path / "nope" / "tune.json"))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert autotune.lookup(op="swap", form="none", dtype="float32",
                                   shape=(96, 48)) is None
    finally:
        autotune.set_cache_path(None)


def test_default_cache_path_and_environment(monkeypatch, tmp_path):
    autotune.set_cache_path(None)
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE", raising=False)
    assert autotune.cache_path() == os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch", "kernel_tune.json")
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "t.json"))
    assert autotune.cache_path() == str(tmp_path / "t.json")


# ---------------------------------------------------------------------------
# Resolution at ops dispatch
# ---------------------------------------------------------------------------


def test_resolve_blocks_precedence_chain(tuner_cache):
    shape = (1000, 384, 100, 10)
    tuned = dict(wpq=2, qpb=4)
    autotune.record(op="rank", form="l2", dtype="float32", shape=shape,
                    knobs=tuned, us=1.0)
    heur = dict(wpq=None, qpb=None)
    # 1. no config: the heuristic, tuner not consulted
    assert ops.resolve_blocks("rank", "l2", "float32", shape) == heur
    # 2. auto=True: the tuned winner for the unset knobs
    auto = ops.KernelConfig(auto=True)
    assert ops.resolve_blocks("rank", "l2", "float32", shape, auto) == tuned
    # 3. an explicit call knob beats the tuned winner
    r = ops.resolve_blocks("rank", "l2", "float32", shape, auto, wpq=1)
    assert r == dict(wpq=1, qpb=4)
    # 4. a non-zero config field beats the tuned winner
    r = ops.resolve_blocks("rank", "l2", "float32", shape,
                           ops.KernelConfig(auto=True, qpb=2))
    assert r == dict(wpq=2, qpb=2)
    # 5. an auto=False config never consults the tuner
    assert ops.resolve_blocks("rank", "l2", "float32", shape,
                              ops.KernelConfig()) == heur
    assert ops.resolve_blocks("rank", "l2", "float32", shape,
                              ops.KernelConfig(wpq=8, qpb=1)) \
        == dict(wpq=8, qpb=1)


def test_a_winner_that_does_not_fit_the_call_is_a_counted_miss(tuner_cache):
    """k = 3000 and k = 4000 share a bucket; wpq = 8 fits shared memory at
    the first and not at the second, so there the heuristic runs."""
    fits_at, call_at = (1000, 4096, 100, 3000), (1000, 4096, 100, 4000)
    winner = dict(wpq=8, qpb=1)
    assert autotune.fits("rank", winner, fits_at)
    assert not autotune.fits("rank", winner, call_at)
    autotune.record(op="rank", form="l2", dtype="float32", shape=fits_at,
                    knobs=winner, us=1.0)
    auto = ops.KernelConfig(auto=True)
    hits = _count(mnames.AUTOTUNE_HITS, "rank")
    misses = _count(mnames.AUTOTUNE_MISSES, "rank")
    assert ops.resolve_blocks("rank", "l2", "float32", fits_at, auto) == winner
    assert _count(mnames.AUTOTUNE_HITS, "rank") == hits + 1
    assert ops.resolve_blocks("rank", "l2", "float32", call_at, auto) \
        == dict(wpq=None, qpb=None)
    assert _count(mnames.AUTOTUNE_MISSES, "rank") == misses + 1
    assert _count(mnames.AUTOTUNE_HITS, "rank") == hits + 1
    # the call still launches: the heuristic's geometry fits
    assert autotune.fits("rank", {}, call_at)


def test_a_key_resolves_once_per_generation(tuner_cache):
    """Repeat calls read the memo; a record (a new generation) re-reads
    the cache, so its winner applies from the next call on."""
    shape, auto = (1000, 384, 100, 10), ops.KernelConfig(auto=True)
    hits = _count(mnames.AUTOTUNE_HITS, "rank")
    misses = _count(mnames.AUTOTUNE_MISSES, "rank")
    for _ in range(3):
        assert ops.resolve_blocks("rank", "l2", "float32", shape, auto) \
            == dict(wpq=None, qpb=None)
    assert _count(mnames.AUTOTUNE_MISSES, "rank") == misses + 1
    autotune.record(op="rank", form="l2", dtype="float32", shape=shape,
                    knobs=dict(wpq=2, qpb=2), us=1.0)
    for _ in range(3):
        assert ops.resolve_blocks("rank", "l2", "float32", shape, auto) \
            == dict(wpq=2, qpb=2)
    assert _count(mnames.AUTOTUNE_HITS, "rank") == hits + 1
    assert _count(mnames.AUTOTUNE_MISSES, "rank") == misses + 1


@pytest.mark.parametrize("op,shape", GRID_SHAPES)
def test_auto_with_an_empty_cache_is_the_heuristic(tuner_cache, op, shape):
    knobs = ops.resolve_blocks(op, "l2", "float32", shape,
                               ops.KernelConfig(auto=True))
    assert set(knobs.values()) <= {None}
    assert autotune.geometry(op, knobs, shape) \
        == autotune.geometry(op, {}, shape)


def test_ops_take_config_and_knobs_on_the_cpu():
    """On CPU tensors the plain versions run and ignore the launch knobs."""
    rng = np.random.default_rng(0)
    Q = torch.from_numpy(rng.normal(size=(5, 8)).astype(np.float32))
    P = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 40, (5, 12)).astype(np.int32))
    ok = torch.from_numpy(rng.random((5, 12)) < 0.8)
    cfg = ops.KernelConfig(wpq=8, qpb=1, bq=16, splits=3, kb=2, auto=True)
    for a, b in [
        (ops.knn(Q, P, "l2", k=4), ops.knn(Q, P, "l2", k=4, config=cfg,
                                           bq=32, splits=2)),
        (ops.rank_gathered(Q, P, None, idx, ok, "l2", k=3),
         ops.rank_gathered(Q, P, None, idx, ok, "l2", k=3, config=cfg,
                           wpq=2, qpb=4)),
        (ops.rank_candidates(Q, P[idx.long()], ok, "l1", k=3),
         ops.rank_candidates(Q, P[idx.long()], ok, "l1", k=3, config=cfg)),
    ]:
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    codes = torch.from_numpy(rng.integers(-100, 100, (40, 8)).astype(np.int8))
    scales = torch.full((5,), 0.05)
    a = ops.scan_quantized(Q, codes, scales, idx, ok, "l2", k=3, block=8)
    b = ops.scan_quantized(Q, codes, scales, idx, ok, "l2", k=3, block=8,
                           config=cfg, qpb=2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    D = torch.from_numpy(np.abs(rng.normal(size=(12, 12))).astype(np.float32))
    d1, d2 = D[:, 0].clone(), D[:, 1].clone() + 1
    n1 = torch.zeros(12, dtype=torch.int32)
    v = torch.ones(12, dtype=torch.bool)
    assert torch.equal(ops.swap_deltas(D, d1, d2, n1, v, k=3),
                       ops.swap_deltas(D, d1, d2, n1, v, k=3, kb=1,
                                       config=cfg))


# ---------------------------------------------------------------------------
# Candidate grids and the wrappers' limits
# ---------------------------------------------------------------------------


def test_candidate_grid_holds_the_heuristic_first_and_fits():
    shape = (1000, 384, 100, 10)
    grid = autotune.candidate_grid("rank", "l2", "float32", shape)
    assert grid[0] == autotune.heuristic("rank", shape) == dict(wpq=4, qpb=2)
    assert len(grid) == 10  # wpq, qpb in {1, 2, 4, 8}, wpq * qpb <= 8
    for knobs in grid:
        assert autotune.fits("rank", knobs, shape)
    assert autotune.candidate_grid("pairwise", "l2", "float32",
                                   (1024, 256, 256, 100)) == [{}]


def _wrapper_geometry(op, knobs, shape):
    """The geometry function each wrapper calls, with its knobs as the
    wrapper passes them."""
    if op == "rank":
        b, w, d, k = shape
        return topk.rank_geometry(b, d, w, k, **knobs)
    if op == "scan":
        b, w, d, k = shape
        return quantized.scan_geometry(b, d, w, k, **knobs)
    if op == "knn":
        nq, n, d, k = shape
        return topk.knn_geometry(nq, n, d, k, "l2", topk.H100_SMS, **knobs)
    if op == "swap":
        return kmedoids.check_swap_shape(*shape, **knobs)
    return None


@pytest.mark.parametrize("op,shape", GRID_SHAPES)
def test_every_grid_member_fits_and_passes_the_wrapper(op, shape):
    grid = autotune.candidate_grid(op, "l2", "float32", shape)
    assert grid and grid[0] == autotune.heuristic(op, shape)
    geos = set()
    for knobs in grid:
        assert autotune.fits(op, knobs, shape), knobs
        geo = autotune.geometry(op, knobs, shape)
        assert geo not in geos  # deduplicated by what it launches
        geos.add(geo)
        assert autotune.pad_waste(op, knobs, shape) >= 0.0
        if op != "pairwise":
            assert _wrapper_geometry(op, knobs, shape) == geo
    if op == "knn":
        assert {k["bq"] for k in grid} <= set(topk._KNN_TILES)
        h = autotune.heuristic(op, shape)["splits"]
        assert {k["splits"] for k in grid} <= {h // 2, h, 2 * h}
    if op == "swap":
        assert {k["kb"] for k in grid} <= {shape[1], 512, 256, 128, 64}
        assert all(k["kb"] <= shape[1] for k in grid)


def test_wrappers_validate_geometry_before_the_device():
    """The wrappers take the grid's knobs: on CPU tensors they get past
    the geometry and stop at the device check."""
    rng = np.random.default_rng(1)
    Q = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32))
    P = torch.from_numpy(rng.normal(size=(20, 5)).astype(np.float32))
    idx = torch.zeros((3, 40), dtype=torch.int32)
    ok = torch.ones((3, 40), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        topk.rank_cuda(Q, P, None, idx, ok, 4, "l1", wpq=2, qpb=4)
    with pytest.raises(ValueError, match="wpq\\*qpb"):
        topk.rank_cuda(Q, P, None, idx, ok, 4, "l1", wpq=4, qpb=4)
    codes = torch.zeros((20, 5), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        quantized.scan_cuda(Q, codes, torch.ones(1), 256, idx, ok, 4, "l2",
                            wpq=8, qpb=1)
    D = torch.zeros((1, 30, 30))
    z = torch.zeros((1, 30))
    with pytest.raises(ValueError, match="CUDA"):
        kmedoids.swap_deltas_cuda(D, z, z, z.int(), z.bool(), 8, kb=4)
    with pytest.raises(ValueError, match=r"\[1, k=8\]"):
        kmedoids.swap_deltas_cuda(D, z, z, z.int(), z.bool(), 8, kb=9)


@pytest.mark.parametrize("op,knobs,shape,limit", [
    ("rank", dict(wpq=4, qpb=4), (1000, 384, 100, 10), r"wpq\*qpb"),
    ("rank", dict(wpq=16), (1000, 384, 100, 10), r"wpq\*qpb"),
    ("rank", dict(wpq=0, qpb=2), (1000, 384, 100, 10), "at least 1"),
    ("rank", dict(wpq=8, qpb=1), (1000, 4096, 100, 4000), "shared memory"),
    ("scan", dict(qpb=8, wpq=2), (1000, 384, 100, 128), r"wpq\*qpb"),
    ("scan", dict(wpq=4, qpb=2), (1000, 4096, 1536, 4000), "shared memory"),
    ("knn", dict(bq=8), (1000, 1_000_000, 100, 10), "compiled query tiles"),
    ("knn", dict(bq=256), (1000, 1_000_000, 100, 10), "compiled query tiles"),
    ("knn", dict(bq=128), (1000, 1_000_000, 100, 1000), "fits 227 KB"),
    ("knn", dict(splits=9), (1000, 1000, 100, 10), "leave a split empty"),
    ("knn", dict(splits=70_000), (10, 10**8, 4, 10), "65,535"),
    ("knn", dict(splits=0), (10, 1000, 4, 10), "at least 1"),
    ("swap", dict(kb=129), (256, 128), r"\[1, k=128\]"),
    ("swap", dict(kb=0), (256, 128), r"\[1, k=128\]"),
    ("swap", dict(kb=1024), (256, 1024), "shared memory"),
    ("swap", dict(kb=1), (256, 70_000), "order kernel"),
    ("pairwise", dict(bm=64), (64, 96, 32), "no launch knob"),
])
def test_explicit_knobs_that_cannot_run_raise_naming_the_limit(
        op, knobs, shape, limit):
    with pytest.raises(ValueError, match=limit):
        autotune.geometry(op, knobs, shape)
    assert not autotune.fits(op, knobs, shape)
    if op != "pairwise":
        with pytest.raises(ValueError, match=limit):
            _wrapper_geometry(op, knobs, shape)


def test_swap_one_slot_a_block_fits_up_to_the_k_cap():
    """k = 14,527 at one slot a block is 14,527 slot blocks: it fits; the
    65,535 grid-axis limit lies past the order kernel's k cap."""
    assert autotune.fits("swap", dict(kb=1), (256, kmedoids.SWAP_MAX_K))
    assert autotune.geometry("swap", dict(kb=1),
                             (256, kmedoids.SWAP_MAX_K)).slot_blocks \
        == kmedoids.SWAP_MAX_K


def test_pad_waste_counts_launched_capacity():
    assert autotune.pad_waste("rank", dict(wpq=1, qpb=8), (1001, 64, 8, 4)) \
        == pytest.approx(126 * 8 / 1001 - 1)
    assert autotune.pad_waste("swap", dict(kb=64), (256, 100)) \
        == pytest.approx(128 / 100 - 1)
    geo = topk.knn_geometry(1000, 10**6, 100, 10, "l2", bq=64, splits=8)
    assert autotune.pad_waste("knn", dict(bq=64, splits=8),
                              (1000, 10**6, 100, 10)) == pytest.approx(
        16 * 64 * geo.chunk * 8 / (1000 * 10**6) - 1)


def test_time_knobs_and_tune_need_the_card(tuner_cache, monkeypatch):
    """The tuner never times a plain version: without CUDA it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.time_knobs("rank", "l2", "float32", (8, 64, 16, 4),
                            dict(wpq=1, qpb=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune.tune("swap", shape=(48, 8))
    assert autotune.lookup(op="swap", form="none", dtype="float32",
                           shape=(48, 8)) is None


def test_tune_scores_with_pad_waste(tuner_cache):
    """Equal times: the geometry that launches fewer idle queries wins."""
    shape = (1001, 64, 8, 4)
    r = autotune.tune("rank", shape=shape, measure=lambda knobs: 50.0)
    wastes = {tuple(s["knobs"].items()): s["waste"] for s in r["sweep"]}
    best = min(wastes.values())
    assert wastes[tuple(r["winner"].items())] == best
    assert r["winner"]["qpb"] == 1  # 1,001 queries: qpb > 1 pads the last


# ---------------------------------------------------------------------------
# Plans: a retune re-plans auto=True plans only
# ---------------------------------------------------------------------------


def test_record_replans_auto_plans_and_leaves_default_plans(tuner_cache):
    rng = np.random.default_rng(4)
    data = rng.normal(size=(600, 8)).astype(np.float32)
    idx = PDASCIndex.build(data, gl=32, device="cpu")
    Q = data[:7] + 0.01
    auto_q = Query(k=5, kernel=ops.KernelConfig(auto=True))
    plain_q = Query(k=5)
    p_auto, p_plain = idx.plan(auto_q), idx.plan(plain_q)
    assert p_auto.kernel.tuned_gen == autotune.generation()
    assert p_plain.kernel is None and p_plain.caps.tuned_gen == -1
    want_auto, want_plain = p_auto(Q), p_plain(Q)
    reset_plan_stats()
    autotune.record(op="rank", form="l2", dtype="float32",
                    shape=(7, 64, 8, 5), knobs=dict(wpq=1, qpb=8), us=1.0)
    got_auto, got_plain = p_auto(Q), p_plain(Q)
    stats = plan_stats()["beam"]
    assert stats["replans"] == 1  # the auto plan only
    assert stats["compiles"] == 1
    new_auto = idx.plan(auto_q)
    assert new_auto is not p_auto
    assert new_auto.kernel.tuned_gen == autotune.generation()
    assert idx.plan(plain_q) is p_plain
    for a, b in [(got_auto, want_auto), (got_plain, want_plain)]:
        assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)


def test_sharded_plan_carries_the_stamped_kernel(tuner_cache):
    from repro_torch.query import compile_sharded_plan

    q = Query(k=5, radius=1.0, kernel=ops.KernelConfig(auto=True))
    plan = compile_sharded_plan(None, q, dist="euclidean")
    assert plan.kernel == q.kernel._replace(tuned_gen=autotune.generation())
    plain = compile_sharded_plan(None, Query(k=5, radius=1.0),
                                 dist="euclidean")
    assert plain.kernel is None


def test_serve_cli_forwards_kernel_knobs(monkeypatch):
    from repro_torch.launch import serve

    seen = {}
    monkeypatch.setattr(serve, "_build", lambda args, train: None)
    monkeypatch.setattr(serve, "_serve_single",
                        lambda args, idx, kernel, train, test:
                        seen.setdefault("kernel", kernel))
    serve.main(["--n", "40", "--wpq", "2", "--qpb", "4", "--bq", "32",
                "--splits", "3", "--row-chunk", "256", "--device", "cpu"])
    assert seen["kernel"] == ops.KernelConfig(wpq=2, qpb=4, bq=32, splits=3,
                                              row_chunk=256)
    args = serve._parse([])
    assert (args.wpq, args.qpb, args.bq, args.splits) == (0, 0, 0, 0)
