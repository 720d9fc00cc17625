"""The port's GNN family (``repro_torch.models.gnn``,
``repro_torch.models.graph_sampler`` and ``configs/egnn.py``) against
``repro``'s on the CPU.

Both packages get the same weights (drawn with numpy from a seed at
``repro.models.gnn.init_params``' scales, carried across by
``params_from_repro``) and the same numpy graphs. Tolerances: fp32 values
(forward outputs, coordinates, losses) rtol = atol = 1e-5; gradients 1e-4
(the two packages sum the scatters and products in another order);
``sample_subgraph`` and ``CSRGraph`` equal array by array; ``knn_graph``
edges equal except among neighbours whose distances lie within 1e-5 *
max(1, max distance) of each other; the equivariance check takes
``tests/test_models.py``'s atol (2e-3 on features, 1e-2 on coordinates).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as j_ops
from repro.configs import egnn as j_egnn
from repro.configs import get_arch as j_get_arch
from repro.models import gnn as jg
from repro.models import graph_sampler as jgs
from repro_torch._tree import tree_flatten_with_path
from repro_torch.configs import egnn, get_arch
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.kernels import ops
from repro_torch.models import gnn as tg
from repro_torch.models import graph_sampler as tgs
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               value_and_grad)

RTOL = ATOL = 1e-5
GTOL = 1e-4  # gradients
OPT = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=100, weight_decay=0.0,
                  schedule="constant")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests are small, and the suite's other
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _close(got, want, tol=RTOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol, atol=tol)


def _tree_close(got, want, tol):
    want_flat = dict(tree_flatten_with_path(want))
    got_flat = tree_flatten_with_path(got)
    assert sorted(p for p, _ in got_flat) == sorted(want_flat)
    for path, g in got_flat:
        np.testing.assert_allclose(_np(g), np.asarray(want_flat[path]),
                                   rtol=tol, atol=tol, err_msg=str(path))


def _np_params(jcfg, seed) -> dict:
    """Params at ``repro.models.gnn.init_params``' scales (a leaf of two or
    more axes N(0, 1/shape[-2]), a 1-D leaf zeros), drawn with numpy."""
    rng = np.random.default_rng(seed)

    def draw(s):
        if len(s.shape) < 2:
            return np.zeros(s.shape, np.float32)
        return (rng.normal(size=s.shape) / np.sqrt(s.shape[-2])).astype(
            np.float32)

    return jax.tree.map(draw, jg.param_shapes(jcfg))


def _configs(**kw):
    """(repro's smoke config, the port's), with the same replacements."""
    return (dataclasses.replace(j_get_arch("egnn").smoke_fn(), **kw),
            dataclasses.replace(get_arch("egnn").smoke_fn(), **kw))


def _flat_graph(rng, N, E, cfg, *, pad=0, d_edge=0):
    """A flat graph of ``E`` random edges and ``pad`` padded ones (src = dst
    = 0 and masked, as ``sample_subgraph`` pads), as numpy arrays."""
    edges = np.zeros((2, E + pad), np.int32)
    edges[:, :E] = rng.integers(0, N, (2, E))
    b = dict(feats=rng.normal(size=(N, cfg.d_feat)).astype(np.float32),
             coords=rng.normal(size=(N, 3)).astype(np.float32),
             edges=edges,
             edge_mask=np.arange(E + pad) < E,
             labels=rng.integers(0, cfg.n_classes, N).astype(np.int32),
             label_mask=rng.random(N) < 0.6)
    if d_edge:
        b["edge_attr"] = rng.normal(size=(E + pad, d_edge)).astype(np.float32)
    return b


def _molecules(rng, B, n, e, cfg):
    return dict(feats=rng.normal(size=(B, n, cfg.d_feat)).astype(np.float32),
                coords=rng.normal(size=(B, n, 3)).astype(np.float32),
                edges=rng.integers(0, n, (B, 2, e)).astype(np.int32),
                targets=rng.normal(size=(B,)).astype(np.float32))


def _torch(b: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


# ------------------------------- configs -----------------------------------


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    assert d.pop("dtype") in (jnp.float32, torch.float32)
    return d


def test_egnn_config_equals_repro():
    a, ja = get_arch("egnn"), j_get_arch("egnn")
    assert (a.family, a.source, a.notes) == (ja.family, ja.source, ja.notes)
    assert a.shapes is GNN_SHAPES and a.shapes.keys() == ja.shapes.keys()
    for fn, jfn in ((a.config_fn, ja.config_fn), (a.smoke_fn, ja.smoke_fn)):
        for shape in (None, *GNN_SHAPES):
            cfg, jcfg = fn(), jfn()
            if shape is not None:
                cfg, jcfg = (egnn.specialise(cfg, shape),
                             j_egnn.specialise(jcfg, shape))
            assert _fields(cfg) == _fields(jcfg)
            assert cfg.dtype == torch.float32
            assert cfg.n_params() == jcfg.n_params()
            shapes = dict(tree_flatten_with_path(tg.param_shapes(cfg)))
            jshapes = dict(tree_flatten_with_path(jg.param_shapes(jcfg)))
            assert {k: v.shape for k, v in shapes.items()} == {
                k: tuple(v.shape) for k, v in jshapes.items()}


def test_init_params_is_seeded_and_at_repros_scales():
    cfg = dataclasses.replace(get_arch("egnn").config_fn(), n_layers=8)
    a = tg.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = tg.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    flat = tree_flatten_with_path(a)
    assert all(torch.equal(x, y) for (_, x), (_, y)
               in zip(flat, tree_flatten_with_path(b)))
    assert sum(v.numel() for _, v in flat) == cfg.n_params()
    assert torch.equal(a["embed_b"], torch.zeros(64))
    assert torch.equal(a["head_b"], torch.zeros(cfg.n_classes))
    # the embedding's fan_in is d_feat; a stacked bias [L, n] is 2-D, so
    # repro draws it at 1/sqrt(L), not zeros
    assert abs(float(a["embed_w"].std()) * np.sqrt(128) - 1) < 0.05
    assert abs(float(a["layers"]["phi_e_b0"].std()) * np.sqrt(8) - 1) < 0.2
    assert abs(float(a["layers"]["phi_h_w0"].std()) * np.sqrt(128) - 1) < 0.05


def test_entry_points_run_on_cuda_by_default(monkeypatch):
    """No fallback: without a GPU the default device raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("egnn").smoke_fn()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgs.knn_graph(np.zeros((5, 3), np.float32), 2)


# ------------------------- forward, losses, grads ---------------------------


@pytest.mark.parametrize("case", ["flat", "masked", "edge_attr"])
def test_forward_equals_repro(case):
    """Flat edges; padded edges under a mask (they add to node 0's degree,
    in both packages); edge attributes."""
    d_edge = 2 if case == "edge_attr" else 0
    jcfg, cfg = _configs(d_edge=d_edge)
    rng = np.random.default_rng(1)
    b = _flat_graph(rng, 40, 150, cfg, pad=30 if case == "masked" else 0,
                    d_edge=d_edge)
    mask = b["edge_mask"] if case == "masked" else None
    attr = b.get("edge_attr")
    p = _np_params(jcfg, 7)
    want_h, want_x = jg.forward(
        jax.tree.map(jnp.asarray, p), jnp.asarray(b["feats"]),
        jnp.asarray(b["coords"]), jnp.asarray(b["edges"]), jcfg,
        edge_mask=None if mask is None else jnp.asarray(mask),
        edge_attr=None if attr is None else jnp.asarray(attr))
    tb = _torch(b)
    got_h, got_x = tg.forward(
        tg.params_from_repro(p, device="cpu"), tb["feats"], tb["coords"],
        tb["edges"], cfg, edge_mask=None if mask is None else tb["edge_mask"],
        edge_attr=tb.get("edge_attr"))
    _close(got_h, want_h)
    _close(got_x, want_x)
    if case == "masked":  # the padded edges damp node 0's update
        _, x_unpadded = tg.forward(
            tg.params_from_repro(p, device="cpu"), tb["feats"], tb["coords"],
            tb["edges"][:, :150], cfg)
        assert not torch.allclose(x_unpadded[0], got_x[0], atol=1e-4)


@pytest.fixture(scope="module")
def repro_grads():
    """``repro``'s loss and gradients of both tasks (one jit each)."""
    out = {}
    for task in ("node_class", "graph_reg"):
        jcfg, cfg = _configs(task=task)
        rng = np.random.default_rng(2)
        b = (_flat_graph(rng, 50, 200, cfg, pad=20) if task == "node_class"
             else _molecules(rng, 6, 12, 20, cfg))
        p = _np_params(jcfg, 11)
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda pp, bb: jg.loss_fn(pp, bb, jcfg), has_aux=True))(
                jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, b))
        out[task] = (cfg, p, b, float(loss), jax.tree.map(np.asarray, g))
    return out


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("task", ["node_class", "graph_reg"])
def test_loss_and_grads_equal_repro(repro_grads, task, remat):
    cfg, p, b, want_loss, want_g = repro_grads[task]
    cfg = dataclasses.replace(cfg, remat=remat)
    (loss, aux), g = value_and_grad(lambda pp, bb: tg.loss_fn(pp, bb, cfg),
                                    tg.params_from_repro(p, device="cpu"),
                                    _torch(b))
    assert aux == {}
    _close(loss, want_loss)
    _tree_close(g, want_g, GTOL)


def test_graph_reg_is_the_per_molecule_sum():
    """The disjoint graph of B molecules equals B separate forwards."""
    _, cfg = _configs(task="graph_reg")
    b = _torch(_molecules(np.random.default_rng(4), 5, 9, 14, cfg))
    p = tg.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    pred = torch.stack([tg.forward(p, b["feats"][i], b["coords"][i],
                                   b["edges"][i], cfg)[0].sum()
                        for i in range(5)])
    want = ((pred - b["targets"]) ** 2).mean()
    _close(tg.graph_reg_loss(p, b, cfg)[0], want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_egnn_equivariance(seed):
    """Random proper rotation and translation of the coordinates: features
    invariant, coordinates equivariant (``tests/test_models.py``'s property
    at its sizes and tolerances, as cases over a few seeds)."""
    rng = np.random.default_rng(seed)
    cfg = tg.EGNNConfig(name="t", n_layers=2, d_hidden=16, d_feat=8,
                        n_classes=4)
    p = tg.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    N, E = 30, 90
    feats = torch.from_numpy(rng.normal(size=(N, 8)).astype(np.float32))
    coords = torch.from_numpy(rng.normal(size=(N, 3)).astype(np.float32))
    edges = torch.from_numpy(rng.integers(0, N, size=(2, E)).astype(np.int32))
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1  # proper rotation
    Q = torch.from_numpy(Q.astype(np.float32))
    t = torch.from_numpy(rng.normal(size=(3,)).astype(np.float32))
    with torch.no_grad():
        h1, x1 = tg.forward(p, feats, coords, edges, cfg)
        h2, x2 = tg.forward(p, feats, coords @ Q.T + t, edges, cfg)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), atol=2e-3)
    np.testing.assert_allclose((x1 @ Q.T + t).numpy(), x2.numpy(), atol=1e-2)


def test_edge_mask_blocks_messages():
    rng = np.random.default_rng(1)
    cfg = tg.EGNNConfig(name="t", n_layers=1, d_hidden=8, d_feat=4,
                        n_classes=3)
    p = tg.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    feats = torch.from_numpy(rng.normal(size=(10, 4)).astype(np.float32))
    coords = torch.from_numpy(rng.normal(size=(10, 3)).astype(np.float32))
    edges = torch.from_numpy(rng.integers(0, 10, size=(2, 20)))
    h_all, _ = tg.forward(p, feats, coords, edges, cfg,
                          edge_mask=torch.zeros(20, dtype=torch.bool))
    h_empty, _ = tg.forward(p, feats, coords,
                            torch.zeros((2, 1), dtype=torch.int32), cfg,
                            edge_mask=torch.zeros(1, dtype=torch.bool))
    _close(h_all, h_empty.detach())


# ---------------------------- the graph sampler ----------------------------


def test_csr_graph_equals_repro():
    """Duplicate edges, repeated sources, isolated nodes and an edge count
    that is not a power of two."""
    rng = np.random.default_rng(5)
    src = rng.integers(0, 150, 3001)
    dst = rng.integers(0, 200, 3001)
    src[:40] = 7  # a heavy source keeps its edges in their given order
    for s, d in ((src, dst), (src.astype(np.int32), dst.astype(np.int32)),
                 (src[:1], dst[:1])):
        got = tgs.CSRGraph.from_edge_list(s, d, 200)
        want = jgs.CSRGraph.from_edge_list(s, d, 200)
        assert np.array_equal(got.indptr, want.indptr)
        assert got.indptr.dtype == want.indptr.dtype
        assert np.array_equal(got.indices, want.indices)
        assert got.indices.dtype == want.indices.dtype
        assert (got.n_nodes, got.n_edges) == (want.n_nodes, want.n_edges)
        for u in (0, 7, 199):
            assert np.array_equal(got.neighbours(u), want.neighbours(u))


def test_sample_subgraph_equals_repro():
    rng = np.random.default_rng(6)
    src, dst = rng.integers(0, 300, 4000), rng.integers(0, 300, 4000)
    feats = rng.normal(size=(300, 6)).astype(np.float32)
    labels = rng.integers(0, 4, 300)
    coords = rng.normal(size=(300, 3)).astype(np.float32)
    g = tgs.CSRGraph.from_edge_list(src, dst, 300)
    jgr = jgs.CSRGraph.from_edge_list(src, dst, 300)
    seeds = rng.choice(300, 24, replace=False)
    for fanouts in ([5, 3], [20], [4, 3, 2]):
        kw = dict(feats=feats, labels=labels, coords=coords)
        got = tgs.sample_subgraph(g, seeds, fanouts,
                                  np.random.default_rng(9), **kw)
        want = jgs.sample_subgraph(jgr, seeds, fanouts,
                                   np.random.default_rng(9), **kw)
        assert got.keys() == want.keys()
        for key in want:
            assert np.array_equal(got[key], want[key]), (fanouts, key)
            assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype
    assert tgs.subgraph_budget(1024, (15, 10)) == (169_984, 168_960)
    assert tgs.subgraph_budget(7, [3, 2]) == jgs.subgraph_budget(7, [3, 2])


def _assert_edges_agree(got, want, coords, k):
    """knn_graph edges of both packages: row i's k neighbours (in order)
    equal, except among neighbours whose distances to i lie within the
    tolerance of each other."""
    assert got.shape == want.shape == (2, len(coords) * k)
    assert got.dtype == want.dtype == np.int32
    gi, wi = got[0].reshape(-1, k), want[0].reshape(-1, k)
    assert np.array_equal(got[1], want[1])
    x = coords.astype(np.float64)

    def dist(ids):
        return np.linalg.norm(x[ids] - x[:, None], axis=-1)

    gd, wd = dist(gi), dist(wi)
    tol = 1e-5 * max(1.0, float(wd.max()))
    np.testing.assert_allclose(gd, wd, rtol=0, atol=tol)
    for i, p in zip(*np.nonzero(gi != wi)):
        assert (np.abs(wd[i] - wd[i, p]) <= tol).sum() > 1, (i, p)


@pytest.mark.parametrize("k", [1, 5, 16])
def test_knn_graph_exact_equals_repro(k):
    coords = np.random.default_rng(k).normal(size=(150, 3)).astype(np.float32)
    got = tgs.knn_graph(coords, k, device="cpu")
    want = jgs.knn_graph(coords, k)
    _assert_edges_agree(got, want, coords, k)


def test_knn_graph_exact_goes_through_ops_knn(monkeypatch):
    seen = []
    real = ops.knn

    def spy(Q, DB, distance="l2", **kw):
        seen.append((tuple(Q.shape), tuple(DB.shape), distance, kw.get("k")))
        return real(Q, DB, distance, **kw)

    monkeypatch.setattr(ops, "knn", spy)
    coords = np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
    tgs.knn_graph(coords, 6, device="cpu")
    assert seen == [((40, 3), (40, 3), "euclidean", 7)]


def test_drop_self_edges_equals_repros_loop(monkeypatch):
    """The vectorised mask against ``repro``'s own loop, fed one id array
    (through its ``knn``) holding self ids, ``-1`` ids, duplicates and rows
    with fewer than k usable ids."""
    ids = np.array([[0, 3, -1, 3, 2, 1],
                    [1, 1, 0, -1, 4, 2],
                    [-1, -1, -1, -1, -1, -1],
                    [4, 3, 0, 1, 2, 0],
                    [2, 4, -1, 4, -1, 0]], np.int32)

    def fake_knn(Q, DB, distance="l2", *, k=10, **kw):
        return jnp.zeros(ids.shape, jnp.float32), jnp.asarray(ids)

    monkeypatch.setattr(j_ops, "knn", fake_knn)
    coords = np.zeros((5, 3), np.float32)
    for k in (1, 2, 3, 5):
        want = jgs.knn_graph(coords, k)
        got = tgs.drop_self_edges(ids, k)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want), k
    empty = tgs.drop_self_edges(np.full((3, 2), -1, np.int32), 2)
    assert empty.shape == (2, 0) and empty.dtype == np.int32


def _overlap(a, b) -> float:
    sa, sb = set(map(tuple, a.T.tolist())), set(map(tuple, b.T.tolist()))
    return len(sa & sb) / len(sb)


def test_knn_graph_pdasc_close_to_exact(monkeypatch):
    """``tests/test_models.py``'s bar on the port; then the queries in
    chunks (a small matrix budget) give the same edges as one call."""
    coords = np.random.default_rng(3).normal(size=(60, 3)).astype(np.float32)
    exact = tgs.knn_graph(coords, 4, device="cpu")
    pdasc = tgs.knn_graph(coords, 4, method="pdasc", device="cpu")
    assert _overlap(pdasc, exact) > 0.7
    monkeypatch.setattr(tgs, "_DENSE_ENTRIES", 60 * 7)
    assert np.array_equal(
        tgs.knn_graph(coords, 4, method="pdasc", device="cpu"), pdasc)


# ------------------------------ learning -----------------------------------


def _train(cfg, p, batches, steps):
    opt = adamw_init(p)
    losses = []
    for s in range(steps):
        (loss, _), g = value_and_grad(lambda pp, bb: tg.loss_fn(pp, bb, cfg),
                                      p, batches(s))
        p, opt, _ = adamw_update(g, opt, p, OPT)
        losses.append(float(loss))
    return losses


def test_node_classification_learns():
    """Sampled subgraphs of a kNN graph; the label is a planted function of
    the features."""
    rng = np.random.default_rng(8)
    cfg = get_arch("egnn").smoke_fn()
    n = 400
    coords = rng.normal(size=(n, 3)).astype(np.float32)
    feats = rng.normal(size=(n, cfg.d_feat)).astype(np.float32)
    labels = feats[:, :cfg.n_classes].argmax(1)
    e = tgs.knn_graph(coords, 8, device="cpu")
    g = tgs.CSRGraph.from_edge_list(e[0], e[1], n)

    def batch(s):
        sub = tgs.sample_subgraph(
            g, rng.choice(n, 32, replace=False), (4, 3),
            np.random.default_rng(s), feats=feats, labels=labels,
            coords=coords)
        return _torch({k: sub[k] for k in ("feats", "coords", "edges",
                                           "edge_mask", "labels",
                                           "label_mask")})

    p = tg.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    losses = _train(cfg, p, batch, 40)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


def test_molecule_regression_learns():
    """Molecules of 12 atoms on their own kNN graphs (k = 2); the target,
    the mean squared distance to the centroid, is rotation-invariant."""
    rng = np.random.default_rng(9)
    _, cfg = _configs(task="graph_reg")
    B, n = 16, 12
    coords = rng.normal(size=(B, n, 3)).astype(np.float32)
    coords *= rng.uniform(0.5, 1.5, (B, 1, 1)).astype(np.float32)
    edges = np.stack([tgs.knn_graph(c, 2, device="cpu") for c in coords])
    assert edges.shape == (B, 2, 2 * n)
    centred = coords - coords.mean(1, keepdims=True)
    b = _torch(dict(
        feats=rng.normal(size=(B, n, cfg.d_feat)).astype(np.float32),
        coords=coords, edges=edges,
        targets=(centred ** 2).sum(-1).mean(-1).astype(np.float32)))
    p = tg.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    losses = _train(cfg, p, lambda s: b, 30)
    assert np.isfinite(losses).all()
    assert losses[-1] < 0.5 * losses[0], losses
