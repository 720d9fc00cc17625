"""The port's cells (``repro_torch.launch.steps``) against ``repro``'s on
the CPU.

Every (arch, shape) cell on both production meshes is built by both
packages: ``repro``'s on a ``jax.sharding.AbstractMesh`` (no devices), the
port's on a ``MeshShape``. They must agree, leaf by leaf and by key path,
on the kind, the donated arguments, each argument's shape and dtype, each
in and out spec, the bytes a rank holds of the arguments (``repro``'s
``NamedSharding(...).shard_shape`` summed) and ``meta`` (``model_flops``
at rtol 1e-12, the rest exactly). The PDASC search's analytic index shapes
are held to ``jax.eval_shape`` of ``repro``'s build.

Then one step of each kind runs in both packages on the same inputs, with
each family's ``smoke_fn`` swapped in for its ``config_fn`` in both
registries and small ``ShapeSpec``s: ``repro`` on a ``(1, 1)``
``jax.make_mesh``, the port's global step on a ``(1, 1)`` ``MeshShape``.
Weights go across through the existing converters (``params_from_repro``).
Tolerances: fp32 values (losses, logits, caches, scores) rtol = atol =
1e-5; the AdamW moments and new params 1e-4 (the two packages sum the
gradients in another order); ids and next tokens equal, retrieval ids
modulo scores within 1e-5 of each other. The PDASC build and search run on
a ``gloo`` world of one (``HashStore``, a ``(1, 1)`` ``DeviceMesh``): the
build held to its invariants, its analytic shapes and recall@10 against
``exact_knn``; the search equal to the port's one-process search on the
same index, and ``repro``'s search cell on that index equal to it up to
near-ties.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import base as j_base
from repro.core import msa as j_msa
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh as j_make_mesh, set_mesh
from repro.models import gnn as jg
from repro.models import recsys as jr
from repro.models import transformer as jt
from repro.optim import adamw_init as j_adamw_init
from repro_torch._spec import PSpec, ShapeDtype, placements, shard_shape
from repro_torch._tree import tree_flatten_with_path, tree_map
from repro_torch.configs import base as t_base
from repro_torch.core import nsa
from repro_torch.core import distances as dist_lib
from repro_torch.data import recsys_batch
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import gnn as tg
from repro_torch.models import recsys as tr
from repro_torch.models import transformer as tt
from repro_torch.optim import adamw_init

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, s, m) for a, s in t_base.all_cells() for m in MESHES]
RTOL = ATOL = 1e-5
GTOL = 1e-4  # AdamW moments and new params
ONE = MeshShape(("data", "model"), (1, 1))

_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dt(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


def _shapes(tree) -> dict:
    """``{path: (shape, dtype name)}`` of a ShapeDtype / ShapeDtypeStruct
    tree of either package."""
    if not any(isinstance(x, ShapeDtype) for x in jax.tree.leaves(tree)):
        tree = jax.tree.map(lambda s: ShapeDtype(tuple(s.shape), s.dtype),
                            tree)
    return {p: (tuple(s.shape), _dt(s.dtype))
            for p, s in tree_flatten_with_path(tree)}


def _jspecs(tree):
    """``repro``'s PartitionSpec tree with PSpec leaves (None kept)."""
    return jax.tree.map(lambda s: None if s is None else PSpec(*s), tree,
                        is_leaf=lambda x: x is None or isinstance(x, P))


def _specs(tree) -> dict:
    return dict(tree_flatten_with_path(tree))


@pytest.fixture(scope="module")
def repro_cells():
    out = {}
    for m, (sizes, names) in MESHES.items():
        mesh = AbstractMesh(sizes, names)
        for a, s in j_base.all_cells():
            out[(a, s, m)] = (jsteps.build_cell(a, s, mesh), mesh)
    return out


def test_the_port_has_repros_cells():
    assert t_base.all_cells() == j_base.all_cells()
    assert len(CELLS) == 84


@pytest.mark.parametrize("arch, shape, mesh_kind", CELLS)
def test_cell_equals_repro(arch, shape, mesh_kind, repro_cells):
    jcell, jmesh = repro_cells[(arch, shape, mesh_kind)]
    sizes, names = MESHES[mesh_kind]
    mesh = MeshShape(names, sizes)
    cell = steps.build_cell(arch, shape, mesh)
    assert (cell.arch, cell.shape, cell.kind) == (arch, shape, jcell.kind)
    assert tuple(cell.donate) == tuple(jcell.donate)

    args = _shapes(cell.args)
    assert args == _shapes(jcell.args)
    in_specs = _specs(cell.in_specs)
    assert in_specs == _specs(_jspecs(jcell.in_specs))
    assert sorted(in_specs) == sorted(args)
    if jcell.out_specs is None:
        assert cell.out_specs is None
    else:
        jout = _jspecs(jcell.out_specs)
        assert _specs(cell.out_specs) == _specs(jout)
        assert [x is None for x in cell.out_specs] == [x is None for x in jout]

    want = sum(math.prod(NamedSharding(jmesh, P(*in_specs[p])).shard_shape(
        shape_)) * np.dtype(jnp.dtype(dt)).itemsize
        for p, (shape_, dt) in args.items())
    assert dryrun.rank_bytes(cell.args, cell.in_specs, mesh) == want

    assert sorted(cell.meta) == sorted(jcell.meta)
    for k, v in jcell.meta.items():
        if k == "model_flops":
            assert math.isclose(cell.meta[k], v, rel_tol=1e-12), k
        else:
            assert cell.meta[k] == v, k
    cell.in_shardings(mesh)  # every spec is a DTensor layout
    cell.out_shardings(mesh)


@pytest.mark.parametrize("n, gl, shards", [(4096, 64, 4), (3000, 32, 2)])
def test_pdasc_index_shapes_equal_repros_eval_shape(n, gl, shards):
    per, d = n // shards, 5

    def build_one(x):
        return j_msa.build_index_arrays(x, gl=gl, distance="euclidean",
                                        method="build",
                                        key=jax.random.PRNGKey(0))[0]

    one = jax.eval_shape(build_one, jax.ShapeDtypeStruct((per, d),
                                                         jnp.float32))
    want = {p: ((shards,) + s, dt) for p, (s, dt) in _shapes(one).items()}
    assert _shapes(steps.pdasc_index_shapes(per, d, gl, shards)) == want
    sizes = steps.pdasc_level_sizes(per, gl)
    assert sizes == [lv.points.shape[0] for lv in one.levels]


# ------------------------------- the specs ---------------------------------


def test_pspec_normalises_as_partition_spec():
    assert PSpec(("data",), None) == PSpec("data", None)
    assert tuple(PSpec(("data",), None)) == tuple(P(("data",), None))
    assert PSpec((), "model") == PSpec(None, "model")
    assert PSpec(("pod", "data")).axes(0) == ("pod", "data")
    # a PSpec is a leaf of the port's trees
    assert tree_flatten_with_path({"w": PSpec("data", None)}) == [
        (("w",), PSpec("data", None))]


def test_placements_and_shard_shape():
    from torch.distributed.tensor import Replicate, Shard

    names = ("pod", "data", "model")
    assert placements(names, PSpec(None, ("pod", "data"), "model")) == (
        Shard(1), Shard(1), Shard(2))
    assert placements(names, PSpec("model", None)) == (
        Replicate(), Replicate(), Shard(0))
    assert placements(names, PSpec()) == (Replicate(),) * 3
    for bad in (PSpec(("data", "pod")), PSpec("x"), PSpec("data", "data")):
        with pytest.raises(ValueError):
            placements(names, bad)
    sizes = dict(pod=2, data=16, model=16)
    assert shard_shape((64, 48, 7), PSpec(None, ("pod", "data"), "model"),
                       sizes) == (64, 2, 1)
    assert shard_shape((64, 48), None, sizes) == (64, 48)


def test_a_device_mesh_of_more_ranks_is_not_ported(world_of_one,
                                                   monkeypatch):
    cell = steps.build_cell("wide-deep", "serve_p99", world_of_one)
    monkeypatch.setattr(world_of_one, "size", lambda mesh_dim=None: 4)
    with pytest.raises(NotImplementedError, match="ROADMAP item 9d-2"):
        cell.step(None, None)


# ------------------------------- the steps ---------------------------------


@pytest.fixture(scope="module")
def world_of_one():
    """A ``gloo`` process group of one rank and its (1, 1) mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    made = not dist.is_initialized()
    if made:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    yield make_mesh((1, 1), ("data", "model"))
    if made:
        dist.destroy_process_group()


def _small(monkeypatch, arch_id, dims: dict, j_changes=None, t_changes=None):
    """Both registries' ``arch_id`` with its smoke config (and the given
    field changes) as ``config_fn`` and ``dims`` as its shapes
    (``{name: (kind, dims)}``)."""
    for base, changes in ((j_base, j_changes), (t_base, t_changes)):
        a = base.get_arch(arch_id)
        fn = (lambda a=a, c=changes or {}:
              dataclasses.replace(a.smoke_fn(), **c))
        shapes = {n: base.ShapeSpec(n, kind, d)
                  for n, (kind, d) in dims.items()}
        monkeypatch.setitem(base._REGISTRY, arch_id, dataclasses.replace(
            a, config_fn=fn, shapes=shapes))


def _jmesh():
    return j_make_mesh((1, 1), ("data", "model"))


def _run_repro(cell, mesh, *args):
    with set_mesh(mesh):
        fn = jax.jit(cell.step).lower(*args).compile(_FAST_COMPILE)
        return jax.tree.map(np.asarray, fn(*args))


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _close(got, want, tol=RTOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol, atol=tol)


def _tree_close(got, want, tol):
    want = dict(tree_flatten_with_path(want))
    got = tree_flatten_with_path(got)
    assert sorted(p for p, _ in got) == sorted(want)
    for p, g in got:
        np.testing.assert_allclose(_np(g), np.asarray(want[p]), rtol=tol,
                                   atol=tol, err_msg=str(p))


def _ids_agree(ids, want, d, tol=ATOL):
    """Ranked ids equal but among near-ties: an id may differ only where
    its distance ``d`` (ascending) lies within ``tol`` of another entry's
    of the row, or at the last place; the ids clear of the last place's
    distance are the same set."""
    for r in range(len(ids)):
        for j in np.flatnonzero(ids[r] != want[r]):
            near = np.abs(d[r] - d[r, j]) <= tol
            near[j] = False
            assert near.any() or j == d.shape[1] - 1, (r, j)
        clear = d[r] < d[r, -1] - tol
        assert set(ids[r][clear]) == set(want[r][clear]), r


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _draw(rng, shapes, ones=()):
    """Weights at ``repro``'s init scales (N(0, 1/shape[-2]); 1-D leaves
    zeros, or ones for ``ones``), drawn with numpy."""

    def draw(path, s):
        if path[-1] in ones:
            return np.ones(s.shape, np.float32)
        if len(s.shape) < 2:
            return np.zeros(s.shape, np.float32)
        return (rng.normal(size=s.shape) / np.sqrt(s.shape[-2])).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(
        lambda kp, s: draw(tuple(getattr(k, "key", k) for k in kp), s),
        shapes)


LM_DIMS = {"train_4k": ("train", dict(seq_len=16, global_batch=4, n_micro=2)),
           "prefill_32k": ("prefill", dict(seq_len=16, global_batch=2)),
           "decode_32k": ("decode", dict(seq_len=24, global_batch=2))}


@pytest.mark.parametrize("arch, shape", [
    ("deepseek-moe-16b", "train_4k"), ("deepseek-moe-16b", "prefill_32k"),
    ("deepseek-moe-16b", "decode_32k"), ("stablelm-1.6b", "decode_32k")])
def test_lm_step_equals_repro(arch, shape, monkeypatch):
    _small(monkeypatch, arch, LM_DIMS, dict(dtype=jnp.float32),
           dict(dtype=torch.float32))
    jcell = jsteps.build_cell(arch, shape, _jmesh())
    cell = steps.build_cell(arch, shape, ONE)
    jcfg = j_base.get_arch(arch).config_fn()
    assert (jcfg.moe is not None) == (arch == "deepseek-moe-16b")
    rng = np.random.default_rng(7)
    params = _draw(rng, jt.param_shapes(jcfg),
                   ones=("ln1", "ln2", "final_norm"))
    tparams = tt.params_from_repro(params, device="cpu")
    assert _shapes(tparams) == _shapes(cell.args[0])
    kind, dims = LM_DIMS[shape]
    B, S = dims["global_batch"], dims["seq_len"]
    ints = lambda *s: rng.integers(0, jcfg.vocab, s).astype(np.int32)  # noqa: E731

    if kind == "train":
        batch = dict(tokens=ints(B, S), labels=ints(B, S))
        want = _run_repro(jcell, _jmesh(), params, j_adamw_init(params),
                          batch)
        new_p, new_o, m = cell.step(tparams, adamw_init(tparams),
                                    _torch(batch))
        _close(m["loss"], want[2]["loss"])
        _tree_close(new_o.mu, want[1].mu, GTOL)
        _tree_close(new_o.nu, want[1].nu, GTOL)
        _tree_close(new_p, want[0], GTOL)
    elif kind == "prefill":
        tokens = ints(B, S)
        want = _run_repro(jcell, _jmesh(), params, tokens)
        logits, cache = cell.step(tparams, torch.from_numpy(tokens))
        _close(logits, want[0])
        _tree_close(cache, want[1], RTOL)
    else:
        cache = {n: rng.normal(size=s.shape).astype(np.float32)
                 for n, s in jt.cache_shapes(jcfg, B, S).items()}
        tokens, pos = ints(B, 1), np.int32(5)
        if jcfg.moe is None:
            want = _run_repro(jcell, _jmesh(), params, cache, tokens, pos)
        else:
            # repro's decode cell on a mesh runs moe_decode_2d, which drops
            # slots past capacity (the mesh paths are 9d-2); the port's
            # global step is repro's decode_step without a mesh
            def dec(p, c, t, q):
                logits, c = jt.decode_step(p, c, t, q, jcfg,
                                           jt.ShardingConfig())
                return jnp.argmax(logits, -1).astype(jnp.int32)[:, None], c

            want = jax.tree.map(np.asarray, jax.jit(dec).lower(
                params, cache, tokens, pos).compile(_FAST_COMPILE)(
                params, cache, tokens, pos))
        nxt, new_cache = cell.step(tparams, _torch(cache),
                                   torch.from_numpy(tokens),
                                   torch.tensor(5, dtype=torch.int32))
        assert nxt.dtype == torch.int32 and nxt.shape == (B, 1)
        np.testing.assert_array_equal(_np(nxt), want[0])
        _tree_close(new_cache, want[1], RTOL)


REC_DIMS = {"train_batch": ("train", dict(batch=32)),
            "serve_p99": ("serve", dict(batch=16)),
            "retrieval_cand": ("retrieval", dict(
                batch=1, n_candidates=1000, n_candidates_padded=1024))}


@pytest.mark.parametrize("shape", list(REC_DIMS))
def test_recsys_step_equals_repro(shape, monkeypatch):
    _small(monkeypatch, "wide-deep", REC_DIMS)
    jcell = jsteps.build_cell("wide-deep", shape, _jmesh())
    cell = steps.build_cell("wide-deep", shape, ONE)
    cfg = t_base.get_arch("wide-deep").config_fn()
    jcfg = j_base.get_arch("wide-deep").config_fn()
    params = jax.tree.map(np.asarray, jr.init_params(jcfg,
                                                     jax.random.PRNGKey(5)))
    tparams = tr.params_from_repro(params, device="cpu")
    assert _shapes(tparams) == _shapes(cell.args[0])
    kind, dims = REC_DIMS[shape]
    batch = recsys_batch(0, dims["batch"], cfg, seed=3)
    if kind != "train":
        batch.pop("labels")
    assert _shapes(_torch(batch)) == _shapes(cell.args[2 if kind == "train"
                                                       else 1])

    if kind == "train":
        want = _run_repro(jcell, _jmesh(), params, j_adamw_init(params),
                          batch)
        new_p, new_o, m = cell.step(tparams, adamw_init(tparams),
                                    _torch(batch))
        _close(m["loss"], want[2]["loss"])
        _tree_close(new_o.mu, want[1].mu, GTOL)
        _tree_close(new_p, want[0], GTOL)
    elif kind == "serve":
        want = _run_repro(jcell, _jmesh(), params, batch)
        _close(cell.step(tparams, _torch(batch)), want)
    else:
        cand = np.random.default_rng(4).normal(
            size=(dims["n_candidates_padded"], cfg.retrieval_dim)).astype(
            np.float32)
        want_s, want_i = _run_repro(jcell, _jmesh(), params, batch, cand)
        scores, ids = cell.step(tparams, _torch(batch), torch.from_numpy(cand))
        _close(scores, want_s)
        _ids_agree(_np(ids), want_i, -_np(scores))


def _subgraphs(rng, G, n_max, e_max, cfg, labelled):
    """G padded subgraphs: ``labelled[g]`` labelled nodes in subgraph g, its
    last quarter of edge slots masked with src = dst = 0 (the sampler's
    padding)."""
    edges = rng.integers(0, n_max, (G, 2, e_max)).astype(np.int32)
    edge_mask = np.arange(e_max)[None, :].repeat(G, 0) < (3 * e_max) // 4
    edges[:, :, (3 * e_max) // 4:] = 0
    label_mask = np.zeros((G, n_max), bool)
    for g, c in enumerate(labelled):
        label_mask[g, rng.choice(n_max, c, replace=False)] = True
    return dict(
        feats=rng.normal(size=(G, n_max, cfg.d_feat)).astype(np.float32),
        coords=rng.normal(size=(G, n_max, 3)).astype(np.float32),
        edges=edges, edge_mask=edge_mask,
        labels=rng.integers(0, cfg.n_classes, (G, n_max)).astype(np.int32),
        label_mask=label_mask)


GNN_DIMS = {"molecule": ("train", dict(n_nodes=6, n_edges=10, batch=3)),
            "minibatch_lg": ("train", dict(n_nodes=1000, n_edges=5000,
                                           batch_nodes=4, fanouts=(2, 2),
                                           n_subgraphs=3))}


@pytest.mark.parametrize("shape", list(GNN_DIMS))
def test_egnn_step_equals_repro(shape, monkeypatch):
    from repro.configs import egnn as j_egnn
    from repro_torch.configs import egnn as t_egnn

    _small(monkeypatch, "egnn", GNN_DIMS)
    jcell = jsteps.build_cell("egnn", shape, _jmesh())
    cell = steps.build_cell("egnn", shape, ONE)
    jcfg = j_egnn.specialise(j_base.get_arch("egnn").config_fn(), shape)
    cfg = t_egnn.specialise(t_base.get_arch("egnn").config_fn(), shape)
    rng = np.random.default_rng(11)
    params = _draw(rng, jg.param_shapes(jcfg))
    tparams = tg.params_from_repro(params, device="cpu")
    dims = GNN_DIMS[shape][1]
    if shape == "molecule":
        B, n, e = dims["batch"], dims["n_nodes"], dims["n_edges"]
        batch = dict(feats=rng.normal(size=(B, n, cfg.d_feat)).astype(
            np.float32), coords=rng.normal(size=(B, n, 3)).astype(np.float32),
            edges=rng.integers(0, n, (B, 2, e)).astype(np.int32),
            targets=rng.normal(size=(B,)).astype(np.float32))
    else:
        G = dims["n_subgraphs"]
        n_max, e_max = cell.args[2]["feats"].shape[1], \
            cell.args[2]["edges"].shape[2]
        batch = _subgraphs(rng, G, n_max, e_max, cfg, labelled=(6, 2, 1))
    assert _shapes(_torch(batch)) == _shapes(cell.args[2])
    want = _run_repro(jcell, _jmesh(), params, j_adamw_init(params), batch)
    tb = _torch(batch)
    new_p, new_o, m = cell.step(tparams, adamw_init(tparams), tb)
    _close(m["loss"], want[2]["loss"])
    _tree_close(new_o.mu, want[1].mu, GTOL)
    _tree_close(new_p, want[0], GTOL)
    if shape == "minibatch_lg":
        # the mean of each subgraph's own mean, not one mean over every
        # labelled node of the disjoint graph
        with torch.no_grad():
            each = [tg.node_class_loss(tparams, {k: v[g] for k, v in
                                                 tb.items()}, cfg)[0]
                    for g in range(G)]
            pooled = tg.node_class_loss(tparams, steps.subgraph_batch(tb),
                                        cfg)[0]
        _close(m["loss"], torch.stack(each).mean())
        assert abs(float(m["loss"]) - float(pooled)) > 1e-3


PDASC_DIMS = {"build_1m": ("build", dict(n=512, d=8)),
              "search_1m": ("search", dict(n=512, d=8, n_queries=16, k=10))}


@pytest.fixture
def pdasc_small(monkeypatch):
    _small(monkeypatch, "pdasc", PDASC_DIMS, None, dict(kb=64))
    cfg = t_base.get_arch("pdasc").config_fn()
    rng = np.random.default_rng(2)
    centres = rng.normal(size=(16, cfg.d)).astype(np.float32) * 3
    data = (centres[rng.integers(0, 16, cfg.n)]
            + rng.normal(size=(cfg.n, cfg.d)).astype(np.float32) * 0.3)
    queries = data[rng.choice(cfg.n, cfg.n_queries, replace=False)] + \
        rng.normal(size=(cfg.n_queries, cfg.d)).astype(np.float32) * 0.05
    return cfg, torch.from_numpy(data), torch.from_numpy(queries)


@pytest.fixture
def kb_seen(monkeypatch):
    seen = []
    real = ops.swap_deltas

    def spy(*args, **kw):
        seen.append(kw.get("kb"))
        return real(*args, **kw)

    monkeypatch.setattr(ops, "swap_deltas", spy)
    return seen


@pytest.mark.parametrize("variant", ["base", "opt", "opt-beam"])
def test_pdasc_build_then_search_on_a_world_of_one(variant, pdasc_small,
                                                   world_of_one, kb_seen):
    from repro_torch.baselines.exact import exact_knn
    from repro_torch.core.reference_impl import check_index_invariants

    cfg, data, queries = pdasc_small
    build = steps.build_cell("pdasc", "build_1m", world_of_one)
    index = build.step(data)
    assert kb_seen and set(kb_seen) == {64}  # kb reaches the swap sweep
    local = tree_map(lambda a: a[0], index)
    assert check_index_invariants(local) == []
    assert _shapes(index) == _shapes(steps.pdasc_index_shapes(
        cfg.n, cfg.d, cfg.gl, 1))
    # the global step on one device builds the same index
    again = steps.build_cell("pdasc", "build_1m", ONE).step(data)
    _tree_close(again, index, 0)

    search = steps.build_cell("pdasc", "search_1m", world_of_one,
                              variant=variant)
    dist = dist_lib.get(cfg.distance)
    if variant == "opt":  # the index and the queries stored in bf16
        index = tree_map(lambda a: a.bfloat16() if a.dtype == torch.float32
                         else a, index)
        queries = queries.bfloat16()
    assert _shapes(index) == _shapes(search.args[0])
    assert _shapes(queries) == _shapes(search.args[1])
    res = search.step(index, queries)
    one = tree_map(lambda a: a[0].float() if a.is_floating_point() else a[0],
                   index)
    if variant == "opt-beam":
        mc = (0,) + (8,) * (len(one.levels) - 1)
        want = nsa.search_beam(one, queries.float(), dist=dist, k=cfg.k,
                               r=cfg.radius, beam=32, max_children=mc)
    else:
        want = nsa.search_dense(one, queries.float(), dist=dist, k=cfg.k,
                                r=cfg.radius)
    np.testing.assert_array_equal(_np(res.ids), _np(want.ids))
    np.testing.assert_array_equal(_np(res.dists), _np(want.dists))
    # and the global step on one device answers the same
    glob = steps.build_cell("pdasc", "search_1m", ONE, variant=variant)
    np.testing.assert_array_equal(_np(glob.step(index, queries).ids),
                                  _np(res.ids))

    _, gt = exact_knn(queries.float(), data, k=cfg.k, device="cpu")
    rec = np.mean([len(set(_np(res.ids[i])) & set(_np(gt[i]))) / cfg.k
                   for i in range(len(gt))])
    assert rec >= 0.9, rec

    if variant == "base":  # repro's search cell on the same index
        jcell = jsteps.build_cell("pdasc", "search_1m", _jmesh())
        jindex = j_msa.PDASCIndexData(
            levels=tuple(j_msa.PDASCLevel(**{k: _np(v) for k, v in
                                             lv._asdict().items()})
                         for lv in index.levels),
            leaf_ids=_np(index.leaf_ids))
        jres = _run_repro(jcell, _jmesh(), jindex, _np(queries))
        np.testing.assert_allclose(_np(res.dists), jres.dists, rtol=RTOL,
                                   atol=ATOL)
        _ids_agree(_np(res.ids), jres.ids, _np(res.dists))
