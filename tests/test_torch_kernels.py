"""The port's kernel ops (``repro_torch.kernels.ops``, their plain PyTorch
versions on the CPU) against ``repro.kernels.ops`` on identical numpy
inputs. ``repro`` runs its normal CPU dispatch; one small case per kernel
runs its Pallas body in interpret mode (``force_pallas=True``).

Tolerance, everywhere below: fp32 values agree within rtol = 1e-5 and
atol = 1e-5 * max(1, max|ref|), because the two packages sum in another
order (XLA's and PyTorch's CPU reductions and matrix products); top-k ids
agree except among entries whose distances lie within that tolerance of
each other, where a rounding-level difference may reorder them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

BIG = 1e30
KERNEL_FORMS = ref.FORMS
REGISTRY_ONLY = ["haversine", "jaccard", "fractional05"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests are small, and the suite's other
    workers (some running 8-device JAX subprocesses) share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(want) -> float:
    want = np.asarray(want, np.float64)
    real = np.abs(want[np.abs(want) < BIG / 2])
    return 1e-5 * max(1.0, float(real.max()) if real.size else 1.0)


def assert_close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=_tol(want))


def assert_topk_agree(gd, gi, wd, wi):
    """Dists close; ids equal except among near-tied real entries."""
    gd, wd = np.asarray(gd, np.float64), np.asarray(wd, np.float64)
    gi, wi = np.asarray(gi), np.asarray(wi)
    real = wd < BIG / 2
    assert np.array_equal(real, gd < BIG / 2)
    assert_close(np.where(real, gd, 0), np.where(real, wd, 0))
    atol = _tol(wd)
    for b in range(wd.shape[0]):
        row = wd[b][real[b]]
        for p in np.nonzero((gi[b] != wi[b]) & real[b])[0]:
            assert (np.abs(row - wd[b, p]) <= atol).sum() > 1 \
                or p == row.size - 1, (b, p, gi[b], wi[b])


def _inputs(rng, distance, shape):
    x = rng.normal(size=shape).astype(np.float32)
    if distance == "haversine":
        return (x[..., :2] * 0.5).astype(np.float32)
    if distance == "jaccard":
        return np.abs(x)
    return x


@pytest.mark.parametrize("distance", list(KERNEL_FORMS) + REGISTRY_ONLY)
def test_pairwise_distance_matches_repro(distance):
    rng = np.random.default_rng(1)
    X, Y = _inputs(rng, distance, (37, 13)), _inputs(rng, distance, (53, 13))
    got = ops.pairwise_distance(torch.from_numpy(X), torch.from_numpy(Y),
                                distance)
    want = jops.pairwise_distance(jnp.asarray(X), jnp.asarray(Y), distance)
    assert got.shape == (37, 53)
    assert_close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("distance", ["l1", "chebyshev", "jaccard"])
def test_pairwise_row_chunk_streams_identically(distance):
    """The streamed plain path (row_chunk smaller than both axes) returns
    the unstreamed values exactly."""
    rng = np.random.default_rng(2)
    X = torch.from_numpy(_inputs(rng, distance, (45, 9)))
    Y = torch.from_numpy(_inputs(rng, distance, (70, 9)))
    whole = ops.pairwise_distance(X, Y, distance, row_chunk=4096)
    streamed = ops.pairwise_distance(X, Y, distance, row_chunk=16)
    assert torch.equal(whole, streamed)


@pytest.mark.parametrize("distance", ["euclidean", "manhattan", "haversine"])
def test_pairwise_batched_equals_per_group(distance):
    """The build's batched [G, m, d] call equals one call per group."""
    rng = np.random.default_rng(3)
    X = torch.from_numpy(_inputs(rng, distance, (4, 20, 6)))
    got = ops.pairwise_distance(X, X, distance)
    for g in range(4):
        assert_close(got[g].numpy(),
                     ops.pairwise_distance(X[g], X[g], distance).numpy())


def test_pairwise_matches_pallas_interpret():
    rng = np.random.default_rng(4)
    X, Y = _inputs(rng, "l2", (19, 11)), _inputs(rng, "l2", (23, 11))
    want = jops.pairwise_distance(jnp.asarray(X), jnp.asarray(Y), "l2",
                                  force_pallas=True, bm=8, bn=8, bd=8)
    got = ops.pairwise_distance(torch.from_numpy(X), torch.from_numpy(Y), "l2")
    assert_close(got.numpy(), np.asarray(want))


def _rank_case(seed, b=6, w=40, n=90, d=10):
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(b, d)).astype(np.float32)
    P = rng.normal(size=(n, d)).astype(np.float32)
    idx = rng.integers(0, n, size=(b, w)).astype(np.int32)
    ok = rng.random((b, w)) > 0.3
    ok[1] = False  # an all-masked row
    live = rng.random(n) > 0.2  # tombstones: dead table rows
    return Q, P, idx, ok, live


@pytest.mark.parametrize("form", KERNEL_FORMS)
@pytest.mark.parametrize("k,tombstones", [(7, False), (40, False), (5, True)])
def test_rank_gathered_matches_repro(form, k, tombstones):
    """Masks, an all-masked row, k = w, and tombstone folding."""
    Q, P, idx, ok, live = _rank_case(5)
    sq = (P * P).sum(-1)
    sv = live if tombstones else None
    gd, gs = ops.rank_gathered(
        torch.from_numpy(Q), torch.from_numpy(P), torch.from_numpy(sq),
        torch.from_numpy(idx), torch.from_numpy(ok), form, k=k,
        slot_valid=None if sv is None else torch.from_numpy(sv))
    wd, ws = jops.rank_gathered(
        jnp.asarray(Q), jnp.asarray(P), jnp.asarray(sq), jnp.asarray(idx),
        jnp.asarray(ok), form, k=k,
        slot_valid=None if sv is None else jnp.asarray(sv))
    assert (gd[1] >= BIG / 2).all()
    assert_topk_agree(gd, gs, np.asarray(wd), np.asarray(ws))


@pytest.mark.parametrize("distance", ["euclidean", "haversine"])
def test_rank_candidates_matches_repro(distance):
    rng = np.random.default_rng(6)
    Q = _inputs(rng, distance, (5, 8))
    C = _inputs(rng, distance, (5, 30, 8))
    ok = rng.random((5, 30)) > 0.25
    gd, gs = ops.rank_candidates(torch.from_numpy(Q), torch.from_numpy(C),
                                 torch.from_numpy(ok), distance, k=6)
    wd, ws = jops.rank_candidates(jnp.asarray(Q), jnp.asarray(C),
                                  jnp.asarray(ok), distance, k=6)
    assert_topk_agree(gd, gs, np.asarray(wd), np.asarray(ws))


def test_rank_matches_pallas_interpret():
    Q, P, idx, ok, _ = _rank_case(7, b=4, w=20, n=50, d=6)
    C = P[idx]
    cc = (C * C).sum(-1)
    wd, ws = jops.rank_candidates(jnp.asarray(Q), jnp.asarray(C),
                                  jnp.asarray(ok), "l2", k=5,
                                  c_sq_norms=jnp.asarray(cc),
                                  force_pallas=True, bq=2, bn=8)
    gd, gs = ops.rank_gathered(
        torch.from_numpy(Q), torch.from_numpy(P),
        torch.from_numpy((P * P).sum(-1)), torch.from_numpy(idx),
        torch.from_numpy(ok), "l2", k=5)
    real = np.asarray(wd) < BIG / 2
    assert_close(np.where(real, gd.numpy(), 0), np.where(real, wd, 0))
    assert np.array_equal(gs.numpy()[real], np.asarray(ws)[real])


@pytest.mark.parametrize("distance", list(KERNEL_FORMS) + ["jaccard"])
def test_knn_matches_repro(distance):
    """n = 1037 is no multiple of any tile."""
    rng = np.random.default_rng(8)
    Q, DB = _inputs(rng, distance, (19, 12)), _inputs(rng, distance, (1037, 12))
    gd, gi = ops.knn(torch.from_numpy(Q), torch.from_numpy(DB), distance, k=7)
    wd, wi = jops.knn(jnp.asarray(Q), jnp.asarray(DB), distance, k=7)
    assert gi.dtype == torch.int32
    assert_topk_agree(gd, gi, np.asarray(wd), np.asarray(wi))


def test_knn_matches_pallas_interpret():
    rng = np.random.default_rng(9)
    Q, DB = _inputs(rng, "l2", (5, 7)), _inputs(rng, "l2", (77, 7))
    wd, wi = jops.knn(jnp.asarray(Q), jnp.asarray(DB), "l2", k=4,
                      force_pallas=True, bq=8, bn=16)
    gd, gi = ops.knn(torch.from_numpy(Q), torch.from_numpy(DB), "l2", k=4)
    assert_topk_agree(gd, gi, np.asarray(wd), np.asarray(wi))


def _swap_case(seed, G=3, g=24, k=6):
    rng = np.random.default_rng(seed)
    D = np.abs(rng.normal(size=(G, g, g))).astype(np.float32)
    d1 = np.abs(rng.normal(size=(G, g))).astype(np.float32)
    d2 = d1 + np.abs(rng.normal(size=(G, g))).astype(np.float32)
    n1 = rng.integers(0, k, size=(G, g)).astype(np.int32)
    valid = rng.random((G, g)) > 0.2
    return D, d1, d2, n1, valid


def test_swap_deltas_batched_matches_repro():
    D, d1, d2, n1, valid = _swap_case(10)
    got = ops.swap_deltas(*map(torch.from_numpy, (D, d1, d2, n1, valid)), k=6)
    assert got.shape == (3, 6, 24)
    for g in range(3):
        args = [jnp.asarray(a[g]) for a in (D, d1, d2, n1, valid)]
        assert_close(got[g].numpy(), np.asarray(jops.swap_deltas(*args, k=6)))
        assert_close(got[g].numpy(),
                     np.asarray(jref.swap_deltas_ref(*args, 6)))
        one = ops.swap_deltas(*(torch.from_numpy(a[g]) for a in
                                (D, d1, d2, n1, valid)), k=6)
        assert torch.equal(one, got[g])


def test_swap_deltas_matches_pallas_interpret():
    D, d1, d2, n1, valid = _swap_case(11, G=1, g=20, k=4)
    want = jops.swap_deltas(*(jnp.asarray(a[0]) for a in (D, d1, d2, n1, valid)),
                            k=4, force_pallas=True, bg=8)
    got = ops.swap_deltas(*(torch.from_numpy(a[0]) for a in
                            (D, d1, d2, n1, valid)), k=4)
    assert_close(got.numpy(), np.asarray(want))


def test_plain_versions_count_no_launches():
    """CPU tensors take the plain versions: no kernel launch is counted."""
    ops.reset_launch_counts()
    Q, P, idx, ok, _ = _rank_case(12)
    t = torch.from_numpy
    ops.pairwise_distance(t(Q), t(P), "l2")
    ops.rank_gathered(t(Q), t(P), None, t(idx), t(ok), "l2", k=3)
    ops.knn(t(Q), t(P), "l2", k=3)
    assert ops.launch_counts() == dict(pairwise=0, rank=0, knn=0,
                                       swap_deltas=0)


def test_topk_order_lower_index_first_on_ties():
    """The stable top-k reproduces lax.top_k's order on ties."""
    D = torch.tensor([[3.0, 1.0, 1.0, 0.5, 1.0, 3.0]])
    vals, idx = ref.topk_smallest(D, 5)
    assert idx.tolist() == [[3, 1, 2, 4, 0]]
    assert vals.tolist() == [[0.5, 1.0, 1.0, 1.0, 3.0]]

