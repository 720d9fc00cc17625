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


def assert_topk_agree(gd, gi, wd, wi, atol=None):
    """Dists close; ids equal except among near-tied real entries. ``atol``
    defaults to the rule's, taken from the top-k values themselves."""
    gd, wd = np.asarray(gd, np.float64), np.asarray(wd, np.float64)
    gi, wi = np.asarray(gi), np.asarray(wi)
    real = wd < BIG / 2
    assert np.array_equal(real, gd < BIG / 2)
    atol = _tol(wd) if atol is None else atol
    np.testing.assert_allclose(np.where(real, gd, 0), np.where(real, wd, 0),
                               rtol=1e-5, atol=atol)
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
    codes = torch.from_numpy(P).to(torch.float16)
    ops.scan_quantized(t(Q), codes, torch.ones(1), t(idx), t(ok), "l2", k=3,
                       block=P.shape[0])
    assert ops.launch_counts() == dict(pairwise=0, rank=0, knn=0,
                                       swap_deltas=0, scan=0)


def test_topk_order_lower_index_first_on_ties():
    """The stable top-k reproduces lax.top_k's order on ties."""
    D = torch.tensor([[3.0, 1.0, 1.0, 0.5, 1.0, 3.0]])
    vals, idx = ref.topk_smallest(D, 5)
    assert idx.tolist() == [[3, 1, 2, 4, 0]]
    assert vals.tolist() == [[0.5, 1.0, 1.0, 1.0, 3.0]]



# ---------------------------------------------------------------------------
# knn.cu's precision: 3xTF32 on the tensor cores keeps fp32's ranking
# ---------------------------------------------------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round fp32 to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, on the low 13 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _gram_tf32(Q, DB, three: bool):
    """``Q @ DB.T`` as knn.cu forms it: each operand split once as
    ``hi + lo`` (``hi = tf32(x)``, ``lo = tf32(x - hi)``) and the three
    products ``lo*hi' + hi*lo' + hi*hi'`` summed in fp32; or, with
    ``three=False``, plain TF32 (``hi*hi'`` alone)."""
    qh, dh = _tf32(Q), _tf32(DB)
    if not three:
        return qh @ dh.T
    ql, dl = _tf32(Q - qh), _tf32(DB - dh)
    return ql @ dh.T + qh @ dl.T + qh @ dh.T


def _gram_distances(G, qq, dd, form):
    """The Gram epilogue of ``ref.pairwise_ref`` on a given product."""
    if form == "l2":
        return torch.sqrt(torch.clamp(qq[:, None] + dd[None] - 2 * G, min=0))
    norm = (torch.sqrt(torch.clamp(qq, min=1e-12))[:, None]
            * torch.sqrt(torch.clamp(dd, min=1e-12))[None])
    return 1 - torch.clamp(G / norm, -1, 1)


def _precision_case(form, three):
    """Emulated and fp64 distances of 64 dense_embed queries against 20,000
    rows (d = 100); l2 returned squared, as the tolerance rule compares it."""
    from repro_torch.data import make_dataset

    data = make_dataset("dense_embed", n=20_064, seed=3)
    Q, DB = torch.from_numpy(data[:64]), torch.from_numpy(data[64:])
    got = _gram_distances(_gram_tf32(Q, DB, three), (Q * Q).sum(-1),
                          (DB * DB).sum(-1), form)
    Q64, D64 = Q.double(), DB.double()
    want = _gram_distances(Q64 @ D64.T, (Q64 * Q64).sum(-1),
                           (D64 * D64).sum(-1), form)
    if form == "l2":
        got, want = got.double() ** 2, want ** 2
    return Q, DB, got, want


def _gram_tf32_promoted(Q, DB, width=32):
    """``Q @ DB.T`` as knn.cu forms it past d = 128: 3xTF32 products of
    each ``width``-column stage summed into a fresh accumulator, which is
    then added to the running sum in fp32 (per-stage promotion)."""
    acc = torch.zeros(Q.shape[0], DB.shape[0])
    for c in range(0, Q.shape[1], width):
        acc = acc + _gram_tf32(Q[:, c:c + width], DB[:, c:c + width], True)
    return acc


def _near_duplicate_case(form, d=1536, q=48, n=4000):
    """Normal queries and rows, the first half of the rows copies of the
    queries plus noise of 1e-3 |x| (the case chip_smoke.py holds the wgmma
    route to at its largest d): emulated promoted distances and fp64, l2
    returned squared."""
    rng = np.random.default_rng(11)
    Q = rng.normal(size=(q, d)).astype(np.float32)
    DB = rng.normal(size=(n, d)).astype(np.float32)
    u = rng.normal(size=(n // 2, d))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    src = Q[np.arange(n // 2) % q]
    DB[:n // 2] = src + 1e-3 * np.linalg.norm(src, axis=1, keepdims=True) * u
    Q, DB = torch.from_numpy(Q), torch.from_numpy(DB)
    got = _gram_distances(_gram_tf32_promoted(Q, DB), (Q * Q).sum(-1),
                          (DB * DB).sum(-1), form)
    Q64, D64 = Q.double(), DB.double()
    want = _gram_distances(Q64 @ D64.T, (Q64 * Q64).sum(-1),
                           (D64 * D64).sum(-1), form)
    if form == "l2":
        got, want = got.double() ** 2, want ** 2
    return Q, DB, got, want


@pytest.mark.parametrize("form,d", [
    pytest.param("l2", 100, id="l2"), pytest.param("cosine", 100, id="cosine"),
    pytest.param("l2", 1536, id="l2-d1536-promoted")])
def test_knn_3xtf32_keeps_the_fp32_ranking(form, d):
    """3xTF32 keeps fp32's top-k under the tolerance rule: at d = 100 in
    one accumulation; at d = 1536 (near-duplicate rows) with each 32-column
    stage's products promoted into an fp32 sum, as knn.cu does past 128.
    There the top-k lies near zero, where fp32's own Gram form cancels
    terms of size |x|^2: its values are held squared, to the atol of the
    whole distance matrix (the scale pairwise's rule takes)."""
    if d == 100:
        Q, DB, got, want = _precision_case(form, three=True)
        assert_close(got.numpy(), want.numpy())
        emulated = got.sqrt() if form == "l2" else got
        gd, gi = ref.topk_smallest(emulated.float(), 10)
        wd, wi = ref.knn_ref(Q, DB, 10, form)
        assert_topk_agree(gd, gi, wd, wi)
        return
    Q, DB, got, want = _near_duplicate_case(form, d)
    assert_close(got.numpy(), want.numpy())
    gd, gi = ref.topk_smallest(got.float(), 10)
    wd, wi = ref.knn_ref(Q, DB, 10, "sqeuclidean")
    assert_topk_agree(gd, gi, wd, wi, atol=_tol(want.numpy()))
    first = gi[:, 0].numpy()  # a copy of the query comes first
    assert (first < DB.shape[0] // 2).all()
    assert (first % Q.shape[0] == np.arange(Q.shape[0])).all()


@pytest.mark.parametrize("form", ["l2", "cosine"])
def test_knn_plain_tf32_breaks_the_tolerance_rule(form):
    """Why knn.cu splits its operands: one TF32 product keeps ~11 mantissa
    bits, and its distances leave the tolerance rule."""
    _, _, got, want = _precision_case(form, three=False)
    err = (got - want).abs().numpy()
    tol = _tol(want.numpy()) + 1e-5 * want.abs().numpy()
    assert (err > tol).mean() > 0.1


# ---------------------------------------------------------------------------
# host-side logic of the CUDA wrappers (no card needed)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nq,n,d", [(1000, 1_000_000, 100), (1, 3000, 100),
                                    (129, 1037, 3), (37, 5000, 13),
                                    (70_000, 1500, 100)])
@pytest.mark.parametrize("k", [1, 10, 300, 1024])
def test_knn_geometry_covers_the_db_once(nq, n, d, k):
    from repro_torch.kernels import topk

    geo = topk.knn_geometry(nq, n, d, k, "l2")
    assert geo.bq in (16, 32, 64, 128) and 1 <= geo.splits <= 65535
    assert geo.chunk % 128 == 0
    starts = np.arange(geo.splits) * geo.chunk
    ends = np.minimum(n, starts + geo.chunk)
    assert (ends > starts).all()  # no empty split
    assert np.array_equal(np.concatenate([np.arange(a, b) for a, b in
                                          zip(starts, ends)]), np.arange(n))
    for form in ("l2", "l1"):
        bq = topk.knn_geometry(nq, n, d, k, form).bq
        assert topk.knn_smem_bytes(bq, d, k, form) <= 227 * 1024


def test_knn_geometry_picks_the_query_tile():
    """The smallest tile that covers the queries, else the largest that
    fits; shapes no wgmma tile can hold take the streaming route."""
    from repro_torch.kernels import topk

    assert topk.knn_geometry(1000, 10**6, 100, 10, "l2").bq == 128
    assert topk.knn_geometry(1000, 10**6, 100, 1024, "l2").bq == 16
    assert topk.knn_geometry(5, 10**6, 100, 10, "l2").bq == 16
    assert topk.knn_geometry(10, 10**6, 4096, 10, "l2").route == "stream"


def test_swap_shared_memory_check():
    """Every g fits a sweep block: the caches stage 1,024 rows at a time,
    and past ~760 slots a block holds 256 of them. k < 1 raises, and so
    does k past the order kernel's 14,527 (4 x (k + 1) int32 slot counts
    in 227 KB); the slot-block grid limit lies beyond that."""
    from repro_torch.kernels import kmedoids as kmk

    assert kmk.SWAP_MAX_K == 14_527
    assert kmk.order_smem_bytes(kmk.SWAP_MAX_K) <= 227 * 1024
    assert kmk.order_smem_bytes(kmk.SWAP_MAX_K + 1) > 227 * 1024
    kmk.check_swap_shape(2 * kmk.SWAP_MAX_K, kmk.SWAP_MAX_K)
    with pytest.raises(ValueError, match="order kernel"):
        kmk.check_swap_shape(2 * kmk.SWAP_MAX_K + 2, kmk.SWAP_MAX_K + 1)

    kmk.check_swap_shape(256, 128)  # the main path's sweep
    assert kmk.swap_smem_bytes(256, 128) <= 227 * 1024
    assert kmk.swap_geometry(256, 128).slot_blocks == 1
    for g, k in [(256, 1024), (20_000, 8), (1457, 728), (2048, 1024),
                 (4096, 2048)]:
        kmk.check_swap_shape(g, k)
        assert kmk.swap_geometry(g, k).smem <= 227 * 1024
    for g, k in [(256, 0), (300, -1)]:
        with pytest.raises(ValueError):
            kmk.check_swap_shape(g, k)


@pytest.mark.parametrize("g", [24, 300, 1457, 2048, 4096])
def test_swap_geometry_covers_every_slot_and_column_once(g):
    """At k = 1, g / 2 and g: the slot blocks tile [0, k) and the column
    tiles [0, g), each exactly once, and every block fits in 227 KB."""
    from repro_torch.kernels import kmedoids as kmk

    for k in (1, g // 2, g):
        geo = kmk.swap_geometry(g, k)
        assert geo.smem <= 227 * 1024
        slots = np.zeros(k, int)
        for z in range(geo.slot_blocks):
            slots[z * geo.kb:min(z * geo.kb + geo.kb, k)] += 1
        cols = np.zeros(g, int)
        for x in range(geo.col_tiles):
            cols[x * kmk._BN:min(x * kmk._BN + kmk._BN, g)] += 1
        assert (slots == 1).all() and (cols == 1).all(), (g, k, geo)
        assert (geo.slot_blocks == 1) == (kmk.swap_smem_bytes(g, k)
                                          <= 227 * 1024)


def _swap_walk(D, d1, d2, n1, valid, k, geo):
    """swap.cu's sweep in numpy, block by block: the rows ordered by slot
    (valid rows with an out-of-range slot last), each slot block's T rows
    from its own rows, S as the slot blocks' partial sums added in order."""
    g = D.shape[0]
    sl = np.where((n1 >= 0) & (n1 < k), n1, k)
    order = np.argsort(np.where(valid, sl, k + 1), kind="stable")
    order = order[valid[order]]
    starts = np.searchsorted(sl[order], np.arange(k + 1))
    out = np.zeros((k, g), np.float32)
    S = np.zeros(g, np.float32)
    for z in range(geo.slot_blocks):
        i0, i1 = z * geo.kb, min(z * geo.kb + geo.kb, k)
        hi = len(order) if z == geo.slot_blocks - 1 else starts[i1]
        rows = order[starts[i0]:hi]
        x = D[rows]
        S = S + np.minimum(x - d1[rows, None], 0).sum(0, dtype=np.float32)
        t = np.where(x >= d1[rows, None],
                     np.minimum(d2[rows, None], x) - d1[rows, None], 0)
        for i in range(i0, i1):
            out[i] = t[sl[rows] == i].sum(0)
    return out + S


@pytest.mark.parametrize("g,k", [(300, 150), (1500, 1200), (2048, 1024)])
def test_swap_slot_split_walk_matches_the_plain_version(g, k):
    """The split layout's arithmetic (rows of a slot block contiguous in
    walk order, the last block also walking the slot-less valid rows, S
    from partial sums) against ``ref.swap_deltas_ref``, within the tests'
    rule (rtol 1e-5, atol 1e-5 * max|ref|)."""
    from repro_torch.kernels import kmedoids as kmk

    rng = np.random.default_rng(g)
    D = np.abs(rng.normal(size=(g, g))).astype(np.float32)
    d1 = np.abs(rng.normal(size=g)).astype(np.float32)
    d2 = d1 + np.abs(rng.normal(size=g)).astype(np.float32)
    n1 = rng.integers(0, k, size=g).astype(np.int32)
    valid = rng.random(g) > 0.2
    geo = kmk.swap_geometry(g, k)
    assert (geo.slot_blocks > 1) == (k > 760)
    got = _swap_walk(D, d1, d2, n1, valid, k, geo)
    want = ref.swap_deltas_ref(*(torch.from_numpy(x) for x in
                                 (D, d1, d2, n1, valid)), k).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("source,names", [
    ("knn.cu", {"TN": "_KNN_TN", "BK": "_KNN_BK", "STAGES": "_KNN_STAGES",
                "CAP": "_KNN_CAP", "STREAM_BK": "_KNN_STREAM_BK",
                "STREAM_STAGES": "_KNN_STREAM_STAGES"}),
    ("swap.cu", {"BN": "_BN", "STAGES": "_STAGES", "R": "_ROWS",
                 "CHUNK": "_CHUNK", "KB": "_KB"}),
    ("pairwise.cu", {"BM": "_BM", "BN": "_BN", "BK": "_BK",
                     "STAGES": "_STAGES"}),
    ("rank.cu", {"THREADS": "_RANK_THREADS"}),
    ("topk.cuh", {"CAP": "_RANK_CAP", "RING": "_RANK_RING"}),
    ("scan.cu", {"THREADS": "_RANK_THREADS"}),
])
def test_wrapper_layouts_mirror_the_kernels(source, names):
    """The wrappers' shared-memory sums use the kernels' tile constants."""
    import re
    from pathlib import Path

    from repro_torch.kernels import kmedoids as kmk, pairwise as pw, topk

    text = (Path(ops.__file__).resolve().parents[1] / "csrc" / source).read_text()
    module = {"knn.cu": topk, "swap.cu": kmk, "pairwise.cu": pw,
              "rank.cu": topk, "topk.cuh": topk, "scan.cu": topk}[source]
    for c_name, py_name in names.items():
        found = re.search(rf"\b{c_name} = (\d+)", text)
        assert found and int(found.group(1)) == getattr(module, py_name), c_name


@pytest.mark.parametrize("nq,n,d,k", [(1000, 100_000, 1536, 10),
                                      (10, 10**6, 4096, 10),
                                      (20, 3000, 1536, 1024),
                                      (1, 129, 1536, 1),
                                      (3, 12_000, 100, 2000)])
def test_knn_geometry_streams_what_no_wgmma_tile_holds(nq, n, d, k):
    """d = 1536 and 4096 (text-embedding widths) and k past 1024 take the
    streaming route instead of raising: its tile covers the queries where
    one fits, the splits cover the DB once, and its shared memory fits."""
    from repro_torch.kernels import topk

    geo = topk.knn_geometry(nq, n, d, k, "l2")
    assert geo.route == "stream" and geo.bq in (16, 32, 64, 128)
    assert geo.bq >= min(nq, 16)
    starts = np.arange(geo.splits) * geo.chunk
    ends = np.minimum(n, starts + geo.chunk)
    assert (ends > starts).all() and ends[-1] == n and starts[0] == 0
    assert (starts[1:] == ends[:-1]).all()
    assert topk.knn_stream_smem_bytes(geo.bq, k, "l2",
                                      geo.shared_states) <= 227 * 1024
    assert topk.knn_merge_smem_bytes(k) <= 227 * 1024


def test_knn_geometry_raises_only_past_the_largest_k():
    from repro_torch.kernels import topk

    kmax = topk.knn_max_k()
    assert kmax >= 9000
    geo = topk.knn_geometry(3, 2 * kmax, 100, kmax, "l2")
    assert (geo.route, geo.bq, geo.shared_states) == ("stream", 16, False)
    with pytest.raises(ValueError, match=f"k <= {kmax}"):
        topk.knn_geometry(3, 2 * kmax, 100, kmax + 1, "l2")


@pytest.mark.parametrize("d", [100, 1536, 4096])
@pytest.mark.parametrize("k", [1, 10, 100, 1024, 1400, 2000, 9685])
@pytest.mark.parametrize("form", ["l2", "l1"])
def test_knn_stream_geometry_covers_the_db_once_for_every_k(d, k, form):
    """Every k up to knn_max_k() is admitted; on the streaming route the
    splits cover the DB once, the tile's shared memory fits, and the states
    move to device memory only where no tile's states fit in shared memory;
    the wgmma route takes no k past 1024."""
    from repro_torch.kernels import topk

    assert k <= topk.knn_max_k()
    nq, n = 1000, 3 * k + 20_000
    geo = topk.knn_geometry(nq, n, d, k, form)
    starts = np.arange(geo.splits) * geo.chunk
    ends = np.minimum(n, starts + geo.chunk)
    assert starts[0] == 0 and ends[-1] == n and (ends > starts).all()
    assert (starts[1:] == ends[:-1]).all() and geo.chunk % 128 == 0
    assert geo.splits * -(-nq // geo.bq) <= 132  # one wave
    if geo.route == "wgmma":
        assert k <= 1024 and geo.shared_states
        assert topk.knn_smem_bytes(geo.bq, d, k, form) <= 227 * 1024
        return
    assert geo.bq in (16, 32, 64, 128)
    assert topk.knn_stream_smem_bytes(geo.bq, k, form,
                                      geo.shared_states) <= 227 * 1024
    fits = [b for b in (16, 32, 64, 128)
            if topk.knn_stream_smem_bytes(b, k, form) <= 227 * 1024]
    assert geo.shared_states == bool(fits)
    if fits:
        assert geo.bq == max(fits)  # 1000 queries: the largest tile that fits
    if d > 2 * 1230:  # no wgmma tile holds such rows
        assert geo.route == "stream"


@pytest.mark.parametrize("G,m,n,sym", [(1024, 256, 256, True),
                                       (1024, 256, 256, False),
                                       (3, 300, 300, True), (2, 37, 129, False),
                                       (1, 1000, 128, False), (5, 1, 1, True),
                                       (70_000, 129, 129, True)])
def test_pairwise_geometry_covers_every_tile_once(G, m, n, sym):
    """Every [128, 128] output tile of every group is written by exactly
    one block (with sym, blocks above the diagonal also write the mirror),
    G above 65,535 included; a block's shared memory lets two share an SM."""
    from repro_torch.kernels import pairwise as pw

    geo = pw.pairwise_geometry(G, m, n, sym)
    tm, tn = -(-m // 128), -(-n // 128)
    assert (geo.tiles_m, geo.tiles_n) == (tm, tn)
    per = geo.blocks // G
    assert per * G == geo.blocks
    groups = list(range(G)) if G <= 1024 else [0, 1, 2, G - 2, G - 1]
    seen = {}
    for grp in groups:
        for b in range(grp * per, (grp + 1) * per):
            for tile in geo.tiles(b):
                seen[tile] = seen.get(tile, 0) + 1
    assert set(seen.values()) == {1}
    assert set(seen) == {(g, r, c) for g in groups for r in range(tm)
                         for c in range(tn)}
    assert 2 * (pw.pairwise_smem_bytes() + 1024) <= 228 * 1024


@pytest.mark.parametrize("b,d,w,k", [(1000, 100, 384, 10), (1000, 100, 384, 32),
                                     (9, 3, 1, 1), (7, 100, 33, 33),
                                     (5, 1536, 4096, 4096),
                                     (3, 100, 31, 10), (1, 4096, 128, 16)])
def test_rank_geometry_covers_every_query_and_slot_once(b, d, w, k):
    """Each query has one block and ``wpq`` warps, whose 32-slot tiles
    (warp j: tiles j, j + wpq, ...) cover its w slots once; the block's
    shared memory fits and it has at most 8 warps."""
    from repro_torch.kernels import topk

    geo = topk.rank_geometry(b, d, w, k)
    assert geo.wpq in (1, 2, 4) and geo.wpq * geo.qpb <= 8
    queries = [blk * geo.qpb + q for blk in range(geo.blocks)
               for q in range(geo.qpb) if blk * geo.qpb + q < b]
    assert queries == list(range(b))
    tiles = -(-w // 32)
    slots = sorted(s for j in range(geo.wpq) for t in range(j, tiles, geo.wpq)
                   for s in range(32 * t, min(w, 32 * t + 32)))
    assert slots == list(range(w))
    assert topk.rank_smem_bytes(d, k, geo.wpq, geo.qpb) <= 227 * 1024
    if w >= 128 and k <= 64:  # the leaf and beam levels: 4 warps a query
        assert (geo.wpq, geo.qpb) == (4, 2)


def test_rank_geometry_raises_past_one_query_state():
    from repro_torch.kernels import topk

    with pytest.raises(ValueError, match="exceeds shared memory"):
        topk.rank_geometry(4, 100, 40_000, 30_000)


def _build_case():
    """Four build groups of 256 dense_embed points (d = 100): the emulated
    3xTF32 distance matrices of pairwise.cu (exact fp32 norms, repro's l2
    epilogue), the plain fp32 ones and fp64."""
    from repro_torch.data import make_dataset

    X = torch.from_numpy(make_dataset("dense_embed", n=1024, seed=5)).reshape(
        4, 256, 100)
    nn = (X * X).sum(-1)
    emulated = torch.stack([_gram_distances(_gram_tf32(x, x, True), q, q, "l2")
                            for x, q in zip(X, nn)])
    X64 = X.double()
    exact = torch.stack([_gram_distances(x @ x.T, (x * x).sum(-1),
                                         (x * x).sum(-1), "l2") for x in X64])
    return emulated, ref.pairwise_ref(X, X, "l2"), exact


def test_pairwise_3xtf32_keeps_the_build():
    """pairwise.cu's arithmetic on a build slab (G = 4, g = 256, d = 100):
    the emulated 3xTF32 matrices meet the tolerance rule against fp64
    (compared squared), and k-medoids on them (pam, swap_tol 1e-3, as the
    build runs it) picks what it picks on fp32 D until a near-tie: BUILD
    follows fp32's picks until a step whose two picks' fp64 costs lie
    within the rule of each other, and the final medoids' fp64 TD is
    within the swap stop's 1e-3 of fp32's."""
    from repro_torch.core import kmedoids as km

    emulated, fp32, exact = _build_case()
    assert_close(emulated.double().numpy() ** 2, exact.numpy() ** 2)
    valid = torch.ones(4, 256, dtype=torch.bool)
    be = km.build_grouped(emulated, 128, valid)
    bf = km.build_grouped(fp32, 128, valid)
    for i in range(4):
        diff = torch.nonzero(be[i] != bf[i])
        if not len(diff):
            continue
        s = int(diff[0])
        D = exact[i]
        near = torch.full((256,), BIG, dtype=torch.float64)
        for med in be[i][:s].tolist():
            near = torch.minimum(near, D[:, med])
        cost = torch.minimum(near[:, None], D).sum(0)
        a, b = cost[int(be[i][s])], cost[int(bf[i][s])]
        tol = 1e-5 * max(1.0, float(cost.max())) + 1e-5 * float(b)
        assert abs(float(a - b)) <= tol, (i, s, float(a), float(b))
    pe = km.kmedoids_grouped(emulated, 128, valid, rel_tol=1e-3)
    pf = km.kmedoids_grouped(fp32, 128, valid, rel_tol=1e-3)
    td_e = km._labels_and_td(exact, pe.medoids, valid)[1]
    td_f = km._labels_and_td(exact, pf.medoids, valid)[1]
    np.testing.assert_allclose(td_e.numpy(), td_f.numpy(), rtol=1e-3)


def test_pairwise_3xtf32_is_exact_on_integer_data():
    """Integers of at most 11 bits split as hi = x, lo = 0, and with every
    product and sum below 2^24 the 3xTF32 matrix equals fp32's bit for bit
    (the build's integer-data parity rests on it)."""
    rng = np.random.default_rng(7)
    for hi, d in [(64, 100), (2048, 3), (64, 1536)]:
        X = torch.from_numpy(rng.integers(-hi + 1, hi, size=(2, 96, d)).astype(
            np.float32))
        assert torch.equal(_tf32(X), X) and not _tf32(X - _tf32(X)).any()
        nn = (X * X).sum(-1)
        for form in ("sqeuclidean", "dot"):
            want = ref.pairwise_ref(X, X, form)
            got = torch.stack([
                torch.clamp(q[:, None] + q[None] - 2 * _gram_tf32(x, x, True),
                            min=0) if form == "sqeuclidean"
                else -_gram_tf32(x, x, True) for x, q in zip(X, nn)])
            assert torch.equal(got, want), (hi, d, form)
