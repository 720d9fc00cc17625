"""The port's MSA build (``repro_torch.core.kmedoids`` / ``msa`` /
``radius``) against ``repro``'s on identical numpy inputs, on the CPU.

Exact parity needs exact arithmetic. The two packages sum fp32 values in
another order, and k-medoids takes argmins and TD comparisons over those
sums: a near-tie at the rounding level (seen in an eager sweep's
batch-versus-single-swap test, 30.7187386 vs 30.7187366) can send the two
down different, equally good paths. So the exact checks run on
integer-valued dissimilarities, where every fp32 sum is exact and both
packages must take the same decisions, tie-breaks included; on real
euclidean data the checks are TD within a stated tolerance and the index
invariants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmedoids as jkm
from repro.core import msa as jmsa
from repro.core import radius as jradius
from repro.core.reference_impl import check_index_invariants
from repro_torch.core import kmedoids as km
from repro_torch.core import msa, radius
from repro_torch.core.index import PDASCIndex


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests are small, and the suite's other
    workers (some running 8-device JAX subprocesses) share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _int_groups(seed, G=6, g=40, d=3, n_invalid=(0, 0, 5, 0, 33, 0)):
    """Integer-grid points, manhattan dissimilarities (exact in fp32)."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(0, 12, size=(G, g, d)).astype(np.float32)
    D = np.abs(pts[:, :, None, :] - pts[:, None, :, :]).sum(-1)
    valid = np.ones((G, g), bool)
    for i, m in enumerate(n_invalid):
        if m:
            valid[i, g - m:] = False
    D = np.where(valid[:, :, None] & valid[:, None, :], D, 1e30).astype(np.float32)
    return D, valid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("method", ["pam", "pam_reference", "alternate", "build"])
def test_kmedoids_grouped_exact_on_integer_dissimilarities(method):
    """Same [G, g, g] input: identical medoids, labels and TD (exact sums;
    a group with 7 valid points < k shows the small-group rule)."""
    D, valid = _int_groups(0)
    k = 8
    want = jkm.kmedoids_grouped(jnp.asarray(D), k, jnp.asarray(valid),
                                method=method, rel_tol=1e-3)
    got = km.kmedoids_grouped(_t(D), k, _t(valid), method=method, rel_tol=1e-3)
    np.testing.assert_array_equal(got.medoids.numpy(), np.asarray(want.medoids))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.td.numpy(), np.asarray(want.td))
    if method in ("pam", "pam_reference"):
        np.testing.assert_array_equal(got.n_swaps.numpy(),
                                      np.asarray(want.n_swaps))


def test_single_group_kmedoids_and_build_exact():
    """The one-group entry points are batches of one of the grouped ones."""
    D, valid = _int_groups(3)
    for g in (0, 2):
        jr = jkm.kmedoids(jnp.asarray(D[g]), 6, jnp.asarray(valid[g]))
        r = km.kmedoids(_t(D[g]), 6, _t(valid[g]))
        np.testing.assert_array_equal(r.medoids.numpy(), np.asarray(jr.medoids))
        assert float(r.td) == float(jr.td)
        np.testing.assert_array_equal(
            km.build(_t(D[g]), 6, _t(valid[g])).numpy(),
            np.asarray(jkm.build(jnp.asarray(D[g]), 6, jnp.asarray(valid[g]))))


def test_kmedoids_grouped_td_on_euclidean_groups():
    """Real euclidean groups: per-group TD within rtol 1e-4 (a rounding-
    level near-tie may pick another, equally good medoid set) and the
    same medoids in most groups."""
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(8, 48, 6)).astype(np.float32)
    valid = np.ones((8, 48), bool)
    from repro_torch.kernels import ops

    D = ops.pairwise_distance(_t(pts), _t(pts), "euclidean").numpy()
    want = jkm.kmedoids_grouped(jnp.asarray(D), 24, jnp.asarray(valid),
                                rel_tol=1e-3)
    got = km.kmedoids_grouped(_t(D), 24, _t(valid), rel_tol=1e-3)
    np.testing.assert_allclose(got.td.numpy(), np.asarray(want.td), rtol=1e-4)
    same = (got.medoids.numpy() == np.asarray(want.medoids)).all(1)
    assert same.mean() >= 0.75


def test_build_and_swap_steps_exact():
    """BUILD variants, the FasterPAM caches and the swap oracle step by
    step on exact dissimilarities."""
    D, valid = _int_groups(2)
    jD, jv = jnp.asarray(D), jnp.asarray(valid)
    for k in (4, 9):
        m_exact = km.build_grouped(_t(D), k, _t(valid))
        np.testing.assert_array_equal(
            m_exact.numpy(), np.asarray(jkm.build_grouped(jD, k, jv)))
        m = km.build_grouped_pruned(_t(D), k, _t(valid))
        jm = jkm.build_grouped_pruned(jD, k, jv)
        np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
        d1, n1, d2 = km._nearest_caches(_t(D), m, _t(valid))
        for g in range(D.shape[0]):
            jd1, jn1, jd2 = jkm._nearest_caches(jD[g], jm[g], jv[g])
            np.testing.assert_array_equal(d1[g].numpy(), np.asarray(jd1))
            np.testing.assert_array_equal(n1[g].numpy(), np.asarray(jn1))
            np.testing.assert_array_equal(d2[g].numpy(), np.asarray(jd2))
            jr, jn = jkm.swap_reference(jD[g], jv[g], jm[g])
            r, n = km.swap_reference(_t(D[g:g + 1]), _t(valid[g:g + 1]),
                                     m[g:g + 1])
            np.testing.assert_array_equal(r[0].numpy(), np.asarray(jr))
            assert int(n[0]) == int(jn)


def _grid_data(n, d, seed):
    return np.random.default_rng(seed).integers(0, 16, size=(n, d)).astype(
        np.float32)


@pytest.mark.parametrize("distance", ["manhattan", "chebyshev"])
def test_build_index_exact_parity_without_shuffle(distance):
    """shuffle=False, method="pam" on integer-grid data: every level's
    arrays, the leaf ids, the level sizes and the per-level TD equal
    repro's (group_chunk=2 slabs in the port, 8 in repro: the result does
    not depend on the slab size)."""
    data = _grid_data(300, 4, seed=3)
    jidx, jstats = jmsa.build_index(data, gl=24, distance=distance,
                                    shuffle=False, group_chunk=8)
    tidx, tstats = msa.build_index(data, gl=24, distance=distance,
                                   shuffle=False, group_chunk=2, device="cpu")
    assert tstats.level_sizes == jstats.level_sizes
    np.testing.assert_allclose(tstats.level_td, jstats.level_td, rtol=1e-6)
    np.testing.assert_array_equal(tidx.leaf_ids.numpy(),
                                  np.asarray(jidx.leaf_ids))
    for tl, jl in zip(tidx.levels, jidx.levels):
        for f in tl._fields:
            np.testing.assert_allclose(getattr(tl, f).numpy(),
                                       np.asarray(getattr(jl, f)), rtol=1e-6)


def _as_repro(index):
    return jmsa.PDASCIndexData(
        levels=tuple(jmsa.PDASCLevel(**{f: jnp.asarray(getattr(lv, f).numpy())
                                        for f in lv._fields})
                     for lv in index.levels),
        leaf_ids=jnp.asarray(index.leaf_ids.numpy()))


def test_build_index_euclidean_matches_repro():
    """Real-valued data: the same level sizes, level-0 TD within rtol 1e-2,
    a valid sibling-contiguous layout, and the same result for any
    group_chunk. The TD tolerance: the pairwise matrices differ in the last
    ulps between the packages, and swap_tol=1e-3 stops a group once a sweep
    gains less than 0.1% of TD, so a gain near that threshold may run one
    sweep more in one package, moving TD by about that much."""
    rng = np.random.default_rng(4)
    data = rng.normal(size=(260, 6)).astype(np.float32)
    jidx, jstats = jmsa.build_index(data, gl=32, distance="euclidean",
                                    shuffle=False)
    tidx, tstats = msa.build_index(data, gl=32, distance="euclidean",
                                   shuffle=False, group_chunk=3, device="cpu")
    assert tstats.level_sizes == jstats.level_sizes
    np.testing.assert_allclose(tstats.level_td[0], jstats.level_td[0],
                               rtol=1e-2)
    assert check_index_invariants(_as_repro(tidx)) == []
    live = tidx.levels[0].valid.numpy()
    assert sorted(tidx.leaf_ids.numpy()[live].tolist()) == list(range(260))
    whole, _ = msa.build_index(data, gl=32, distance="euclidean",
                               shuffle=False, group_chunk=0, device="cpu")
    for a, b in zip(whole.levels, tidx.levels):
        assert all(torch.equal(getattr(a, f), getattr(b, f)) for f in a._fields)


@pytest.mark.parametrize("distance", ["haversine", "jaccard"])
def test_build_registry_distances_keep_invariants(distance):
    """Distances without a kernel build through the registry path."""
    rng = np.random.default_rng(5)
    data = np.abs(rng.normal(size=(150, 2 if distance == "haversine" else 7)))
    data = (data * (0.3 if distance == "haversine" else 1)).astype(np.float32)
    tidx, tstats = msa.build_index(data, gl=20, distance=distance,
                                   device="cpu")
    assert tstats.level_sizes[0] == 150
    assert check_index_invariants(_as_repro(tidx)) == []


def test_n_levels_and_max_children_match_repro():
    data = _grid_data(300, 4, seed=6)
    jidx, _ = jmsa.build_index(data, gl=24, distance="manhattan", shuffle=False)
    tidx, tstats = msa.build_index(data, gl=24, distance="manhattan",
                                   shuffle=False, device="cpu")
    assert msa.max_children(tidx) == jmsa.max_children(jidx)
    assert msa.n_levels_for(300, 24) == jmsa.n_levels_for(300, 24)
    assert tstats.n_levels == len(jidx.levels)
    with pytest.raises(ValueError, match="never reduces"):
        msa.n_levels_for(1000, 10, 6)


def test_kmeans_is_not_yet_ported():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        msa.build_index(_grid_data(50, 3, 7), gl=10, method="kmeans",
                        device="cpu")


def test_radius_estimate_and_per_level_radii():
    """The radius sample is driven by a torch.Generator (its numbers differ
    from jax.random's); per-level radii on the identical index match
    repro's within rtol 1e-5."""
    data = _grid_data(300, 4, seed=8)
    r1 = radius.estimate_radius(_t(data), "manhattan", quantile=0.3,
                                generator=torch.Generator().manual_seed(5))
    r2 = radius.estimate_radius(_t(data), "manhattan", quantile=0.3,
                                generator=torch.Generator().manual_seed(5))
    assert r1 == r2 > 0
    exact = jradius.estimate_radius(jnp.asarray(data), "manhattan",
                                    quantile=0.3, n_pairs=60000,
                                    key=jax.random.PRNGKey(1))
    assert abs(r1 - exact) <= 0.15 * exact  # two samples of one CDF
    tidx, _ = msa.build_index(data, gl=24, distance="manhattan", shuffle=False,
                              device="cpu")
    want = jradius.per_level_radii(_as_repro(tidx), "manhattan",
                                   base_radius=2.0)
    got = radius.per_level_radii(tidx, "manhattan", base_radius=2.0)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_build_entry_point_needs_a_gpu_or_cpu():
    """PDASCIndex.build runs on CUDA by default and raises without a GPU."""
    data = _grid_data(60, 3, 9)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PDASCIndex.build(data, gl=12)
    idx = PDASCIndex.build(data, gl=12, device="cpu")
    assert idx.device.type == "cpu" and idx.n_points == 60


def test_core_build_index_defaults_to_cuda():
    """core.build_index without a device asks for CUDA, as every entry
    point of the port does: here, without a GPU, it raises."""
    from repro_torch.core import build_index

    data = _grid_data(60, 3, 10)
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_index(data, gl=12)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        msa.build_index_arrays(data, gl=12)
    index, stats = build_index(data, gl=12, device="cpu")
    assert index.leaf_ids.device.type == "cpu" and stats.level_sizes[0] == 60
