"""The port's config layer and training driver against ``repro``'s, and the
swap knob ``kb`` on every path that clusters.

* The drift guard of ``tests/test_configs.py``, on the port's
  ``KernelConfig``: every launch knob is mirrored in ``PDASCArchConfig``
  and ``kernel_config()`` carries it through.
* Every ported config (``config()`` and ``smoke_config()`` of the four
  recsys and the five LM archs, ``pdasc``'s shared fields), the shape sets
  and the cells equal to ``repro``'s (``egnn``'s config is held to
  ``repro``'s in ``tests/test_torch_gnn.py``).
* ``launch.train.main([... "--smoke", "--device", "cpu"])`` learns, and a
  ``--ckpt`` restart ends bit-equal to an uninterrupted run, for a recsys
  and an LM arch.
* ``kb`` reaches ``ops.swap_deltas`` from ``compact_index`` (both
  scopes), ``build_sharded`` and ``build_streaming``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.configs import base as jbase
from repro.configs.pdasc import PDASCArchConfig as JPDASCArchConfig
from repro.models import transformer as jt
from repro_torch import configs
from repro_torch._tree import tree_flatten_with_path, tree_leaves
from repro_torch.configs import base
from repro_torch.configs.pdasc import PDASCArchConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ops import DEFAULT, KernelConfig
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tt

RECSYS = ["autoint", "din", "wide-deep", "xdeepfm"]
LM = ["deepseek-moe-16b", "granite-3-2b", "minitron-8b",
      "qwen3-moe-235b-a22b", "stablelm-1.6b"]

# KernelConfig fields that are not user-facing arch knobs: tuned_gen is
# plan-compiler plumbing (the generation stamp that invalidates cached
# plans on retune).
_UNMIRRORED = {"tuned_gen"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------- drift guard -----------------------------------


def test_every_kernel_knob_is_mirrored_in_arch_config():
    cfg_fields = {f.name for f in dataclasses.fields(PDASCArchConfig)}
    missing = set(KernelConfig._fields) - _UNMIRRORED - cfg_fields
    assert not missing, (
        f"KernelConfig knobs {sorted(missing)} have no PDASCArchConfig "
        f"mirror field: kernel_config() would silently drop them")


def test_kernel_config_defaults_round_trip():
    assert PDASCArchConfig().kernel_config() == DEFAULT


def test_kernel_config_carries_every_mirrored_field():
    overrides = dict(row_chunk=512, wpq=2, qpb=4, bq=16, splits=8, kb=64,
                     auto=True)
    assert set(overrides) == set(KernelConfig._fields) - _UNMIRRORED
    kc = PDASCArchConfig(**overrides).kernel_config()
    for name, val in overrides.items():
        assert getattr(kc, name) == val, name
    assert kc.tuned_gen == DEFAULT.tuned_gen


def test_kernel_config_auto_flag_reaches_search_query():
    q = PDASCArchConfig(auto=True, bq=16).search_query(execution="beam")
    assert q.kernel.auto is True
    assert q.kernel.bq == 16
    assert q.k == 10 and q.radius == 13.0 and q.rerank_width == 128


def test_router_and_slo_helpers_equal_repro():
    cfg = PDASCArchConfig(router_trace_every=4, router_shadow_every=16,
                          slo_latency_p99_s=0.05, slo_recall_floor=0.8)
    jcfg = JPDASCArchConfig(router_trace_every=4, router_shadow_every=16,
                            slo_latency_p99_s=0.05, slo_recall_floor=0.8)
    assert (dataclasses.asdict(cfg.router_config(hedge=False))
            == dataclasses.asdict(jcfg.router_config(hedge=False)))
    assert (dataclasses.asdict(cfg.slo_spec())
            == dataclasses.asdict(jcfg.slo_spec()))


# --------------------------- configs against repro -------------------------


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("dtype")
    return d


@pytest.mark.parametrize("arch_id", RECSYS)
def test_recsys_configs_equal_repro(arch_id):
    a, ja = configs.get_arch(arch_id), jconfigs.get_arch(arch_id)
    assert (a.id, a.family, a.source, a.notes) == (ja.id, ja.family,
                                                   ja.source, ja.notes)
    for fn, jfn in ((a.config_fn, ja.config_fn), (a.smoke_fn, ja.smoke_fn)):
        cfg, jcfg = fn(), jfn()
        assert _fields(cfg) == _fields(jcfg)
        assert cfg.dtype == torch.float32 and str(jcfg.dtype.dtype) == "float32"
        assert cfg.n_params() == jcfg.n_params()
    assert a.shapes.keys() == ja.shapes.keys()
    for name, s in a.shapes.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(ja.shapes[name])


@pytest.mark.parametrize("arch_id", LM)
def test_lm_configs_equal_repro(arch_id):
    a, ja = configs.get_arch(arch_id), jconfigs.get_arch(arch_id)
    assert (a.id, a.family, a.source, a.notes) == (ja.id, ja.family,
                                                   ja.source, ja.notes)
    for fn, jfn in ((a.config_fn, ja.config_fn), (a.smoke_fn, ja.smoke_fn)):
        cfg, jcfg = fn(), jfn()
        mine, theirs = dataclasses.asdict(cfg), dataclasses.asdict(jcfg)
        for d in (mine, theirs):
            d.pop("dtype"), d.pop("param_dtype")
        assert mine == theirs  # every field, the MoE config's too
        # repro's jnp dtypes, as torch dtypes
        assert cfg.dtype == torch.bfloat16 and jcfg.dtype.dtype.name == "bfloat16"
        assert (cfg.param_dtype == torch.float32
                and jcfg.param_dtype.dtype.name == "float32")
        assert (cfg.hd, cfg.vocab_padded) == (jcfg.hd, jcfg.vocab_padded)
        assert cfg.n_params() == jcfg.n_params()
        assert cfg.n_active_params() == jcfg.n_active_params()
        shapes = dict(tree_flatten_with_path(tt.param_shapes(cfg)))
        jshapes = dict(tree_flatten_with_path(jt.param_shapes(jcfg)))
        assert {k: v.shape for k, v in shapes.items()} == {
            k: tuple(v.shape) for k, v in jshapes.items()}
        cache = tt.cache_shapes(cfg, 4, 64)
        jcache = jt.cache_shapes(jcfg, 4, 64)
        assert {k: v.shape for k, v in cache.items()} == {
            k: tuple(v.shape) for k, v in jcache.items()}
        assert cache["k"].dtype == torch.bfloat16
    assert a.shapes.keys() == ja.shapes.keys()
    for name, s in a.shapes.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(ja.shapes[name])


def test_shape_sets_and_cells_equal_repro():
    for mine, theirs in ((base.LM_SHAPES, jbase.LM_SHAPES),
                         (base.RECSYS_SHAPES, jbase.RECSYS_SHAPES),
                         (base.GNN_SHAPES, jbase.GNN_SHAPES)):
        assert {k: dataclasses.asdict(v) for k, v in mine.items()} == {
            k: dataclasses.asdict(v) for k, v in theirs.items()}
    assert configs.arch_ids() == sorted(RECSYS + LM + ["egnn", "pdasc"])
    assert configs.arch_ids() == jconfigs.arch_ids()
    assert configs.all_cells() == jconfigs.all_cells()
    assert configs.all_cells(include_pdasc=False) == jconfigs.all_cells(
        include_pdasc=False)


def test_unported_arch_raises_listing_the_registry():
    with pytest.raises(KeyError, match="unknown arch 'no-such-arch'") as e:
        configs.get_arch("no-such-arch")
    with pytest.raises(KeyError, match="unknown arch 'no-such-arch'"):
        jconfigs.get_arch("no-such-arch")
    assert str(sorted(RECSYS + LM + ["egnn", "pdasc"])) in str(e.value)
    with pytest.raises(ValueError, match="already registered"):
        base.register_arch(configs.get_arch("din"))


def test_pdasc_config_equals_repro_on_shared_fields():
    a, ja = configs.get_arch("pdasc"), jconfigs.get_arch("pdasc")
    assert (a.family, a.source) == (ja.family, ja.source)
    for name, s in a.shapes.items():
        assert dataclasses.asdict(s) == dataclasses.asdict(ja.shapes[name])
    for fn, jfn in ((a.config_fn, ja.config_fn), (a.smoke_fn, ja.smoke_fn)):
        mine, theirs = dataclasses.asdict(fn()), dataclasses.asdict(jfn())
        shared = set(mine) & set(theirs)
        # repro's Pallas tiles have no field; the port's CUDA knobs are new
        assert set(theirs) - shared == {"bm", "bn", "bd", "bg"}
        assert set(mine) - shared == {"wpq", "qpb", "splits", "kb"}
        # bq names a tile in each package: repro's rank/knn query tile
        # (default 8), the port's knn query tile (0 = the heuristic)
        assert mine["bq"] == DEFAULT.bq and theirs["bq"] == 8
        same = shared - {"bq"}
        assert {k: mine[k] for k in same} == {k: theirs[k] for k in same}


# --------------------------- the training driver ---------------------------


def test_launch_train_smoke_learns(capsys):
    out = launch_train.main(["--arch", "din", "--smoke", "--device", "cpu",
                             "--steps", "40", "--batch", "128", "--lr",
                             "0.5", "--seed", "1"])
    losses = [loss for _, loss in out["history"]]
    assert len(losses) == 40 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.01, losses
    text = capsys.readouterr().out
    assert "[train] done: step 39" in text and "ms a step" in text


def test_launch_train_restart_equals_uninterrupted(tmp_path):
    argv = ["--arch", "xdeepfm", "--smoke", "--device", "cpu", "--batch",
            "64", "--lr", "0.05", "--seed", "3", "--deterministic"]
    ref = launch_train.main(argv + ["--steps", "8"])
    ck = str(tmp_path / "ck")
    # 8 steps sit inside the 100-step warmup: the schedule does not
    # depend on --steps, so a 4-step run is the first half of the 8
    launch_train.main(argv + ["--steps", "4", "--ckpt", ck,
                              "--ckpt-every", "2"])
    resumed = launch_train.main(argv + ["--steps", "8", "--ckpt", ck,
                                        "--ckpt-every", "2"])
    assert resumed["history"][0][0] == 4
    assert int(resumed["opt_state"].step) == 8
    assert resumed["opt_state"].step.shape == ()
    for k, v in ref["params"].items():
        assert torch.equal(v, resumed["params"][k]), k
        assert torch.equal(ref["opt_state"].nu[k], resumed["opt_state"].nu[k])
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("argv, match", [
    (["--arch", "no-such-arch"], "unknown arch"),
    (["--arch", "pdasc"], "pdasc"),
    (["--arch", "din", "--smoke", "--mesh", "2x1"], "only 1x1"),
    (["--arch", "egnn"], "is gnn"),  # driven from the examples, as in repro
])
def test_launch_train_refuses_what_is_not_ported(argv, match):
    with pytest.raises((SystemExit, KeyError), match=match):
        launch_train.main(argv + ["--device", "cpu"])


LM_ARGV = ["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu",
           "--batch", "8", "--seq", "32", "--lr", "0.05", "--seed", "1"]


def test_launch_train_lm_smoke_learns(capsys):
    out = launch_train.main(LM_ARGV + ["--steps", "30"])
    losses = [loss for _, loss in out["history"]]
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 1.0, losses
    assert sorted(out["params"]) == ["embed", "final_norm", "layers",
                                     "lm_head"]
    text = capsys.readouterr().out
    assert "[train] done: step 29" in text
    assert "stablelm-1.6b-smoke batch 8 x seq 32 on cpu" in text


def test_launch_train_lm_restart_equals_uninterrupted(tmp_path):
    argv = LM_ARGV + ["--deterministic"]
    ref = launch_train.main(argv + ["--steps", "6"])
    ck = str(tmp_path / "ck")
    # inside the 100-step warmup the schedule does not depend on --steps
    launch_train.main(argv + ["--steps", "3", "--ckpt", ck,
                              "--ckpt-every", "1"])
    resumed = launch_train.main(argv + ["--steps", "6", "--ckpt", ck,
                                        "--ckpt-every", "1"])
    assert resumed["history"][0][0] == 3
    assert int(resumed["opt_state"].step) == 6
    for tree in ("params", "opt_state"):
        mine = tree_flatten_with_path(resumed[tree])
        theirs = dict(tree_flatten_with_path(ref[tree]))
        assert len(mine) == len(theirs) == len(tree_leaves(ref[tree]))
        for path, leaf in mine:
            assert torch.equal(leaf, theirs[path]), path
    assert not torch.are_deterministic_algorithms_enabled()


# --------------------------- kb on every clustering path -------------------


@pytest.fixture
def kb_seen(monkeypatch):
    seen = []
    real = ops.swap_deltas

    def spy(*args, **kw):
        seen.append(kw.get("kb"))
        return real(*args, **kw)

    monkeypatch.setattr(ops, "swap_deltas", spy)
    return seen


def _data(n=384, d=6, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("scope", ["affected", "full"])
def test_kb_reaches_swap_from_compaction(kb_seen, scope):
    from repro_torch.core.index import PDASCIndex

    idx = PDASCIndex.build(_data(), gl=32, shuffle=False, device="cpu")
    idx.enable_mutations(delta_capacity=64)
    idx.upsert(_data(20, seed=1))
    idx.delete(np.arange(10))
    kb_seen.clear()
    new = idx.compact(scope=scope, kb=64)
    assert kb_seen and set(kb_seen) == {64}
    assert new.epoch == idx.epoch + 1
    assert new.stats.level_sizes[0] == 384 + 20 - 10
    kb_seen.clear()
    idx.compact(scope=scope)  # unset: the kernel's heuristic
    assert kb_seen and set(kb_seen) == {None}


def test_kb_reaches_swap_from_the_streamed_build(kb_seen):
    from repro_torch.store import SimulatedObjectStore, build_streaming

    data = _data(320)
    idx = build_streaming([data[:128], data[128:256], data[256:]], gl=32,
                          block=32, remote=SimulatedObjectStore(), kb=64,
                          device="cpu")
    assert kb_seen and set(kb_seen) == {64}
    assert idx.stats.level_sizes[0] == 320
    idx.store.exact.close()


def test_kb_reaches_swap_from_the_sharded_build(kb_seen, tmp_path):
    import torch.distributed as dist

    from repro_torch.core import distributed as dd
    from repro_torch.launch.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh((1,), ("data",))
        local = dd.build_sharded(_data(256), mesh, gl=32, kb=64, device="cpu")
    finally:
        dist.destroy_process_group()
    assert kb_seen and set(kb_seen) == {64}
    assert int(local.levels[0].valid.sum()) == 256
