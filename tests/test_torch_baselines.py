"""The port's NN-Descent baseline (``repro_torch.baselines.nndescent``)
against ``repro.baselines.nndescent`` on the same numpy inputs and seeds.

Both packages run the same numpy loops with the same
``np.random.default_rng`` draws in the same order; they differ only in
who computes the distance blocks (``repro``'s jnp registry, the port's
PyTorch one). On integer-valued data every euclidean distance is exact in
both (squared norms and products below 2^24, then one correctly rounded
square root), so the graphs and the search answers are equal entry for
entry, ties included (one numpy stable sort). On real-valued data the two
sum in another order; their recall@10 against exact k-NN is held within
0.02 of each other.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.baselines import NNDescentIndex as JNNDescent
from repro.baselines import exact_knn as jexact_knn
from repro_torch.baselines import NNDescentIndex


def _recall(ids, gt) -> float:
    ids, gt = np.asarray(ids), np.asarray(gt)
    k = gt.shape[1]
    return float(np.mean([len(set(a[:k]) & set(b)) / k
                          for a, b in zip(ids, gt)]))


def test_integer_data_graph_and_search_equal_repro():
    rng = np.random.default_rng(11)
    X = rng.integers(0, 16, (600, 8)).astype(np.float32)
    Q = rng.integers(0, 16, (40, 8)).astype(np.float32)
    kw = dict(n_neighbors=10, distance="euclidean", iters=3, sample=6, seed=5)
    want = JNNDescent.build(X, **kw)
    got = NNDescentIndex.build(X, device="cpu", **kw)
    np.testing.assert_array_equal(got.graph, want.graph)
    skw = dict(k=10, n_seeds=8, max_steps=20, seed=2)
    wd, wi = want.search(Q, **skw)
    gd, gi = got.search(Q, **skw)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gd, wd)


def test_real_data_recall_within_002_of_repro():
    rng = np.random.default_rng(12)
    X = rng.normal(size=(1500, 16)).astype(np.float32)
    Q = rng.normal(size=(60, 16)).astype(np.float32)
    kw = dict(n_neighbors=12, distance="euclidean", iters=3, sample=6, seed=1)
    skw = dict(k=10, n_seeds=16, max_steps=30, seed=3)
    _, gt = jexact_knn(Q, X, distance="euclidean", k=10)
    _, wi = JNNDescent.build(X, **kw).search(Q, **skw)
    got = NNDescentIndex.build(X, device="cpu", **kw)
    _, gi = got.search(Q, **skw)
    assert got.graph.shape == (1500, 12)
    assert abs(_recall(gi, gt) - _recall(wi, gt)) <= 0.02


def test_build_on_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.zeros((20, 4), np.float32)
    with pytest.raises(RuntimeError):
        NNDescentIndex.build(X, n_neighbors=4, device="cuda")
