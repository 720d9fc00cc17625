"""The port's recsys family (``repro_torch.models.recsys`` and its four
configs) against ``repro``'s on the CPU.

Each of the four ``smoke_config()`` archs gets ``repro``'s weights
(``jax.random.PRNGKey(5)``) through ``params_from_repro`` and the same
numpy batch (``recsys_batch``); ``repro``'s forward, loss, gradients and
one AdamW step run under one ``jax.jit`` per arch. Tolerances: fp32
throughout, rtol = atol = 1e-5; retrieval ids equal except among scores
within that tolerance of each other (the two packages sum in another
order). The mesh branch of ``retrieval_step`` runs over 2 ``gloo`` ranks
(``launch.ranks.run_ranks``) on a (2, 1) ``("data", "model")`` mesh.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import recsys as jr
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro_torch.configs import get_arch
from repro_torch.data import recsys_batch
from repro_torch.launch.ranks import run_ranks
from repro_torch.models import recsys as tr
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               value_and_grad)

HERE = os.path.abspath(__file__)
ARCHS = ["wide-deep", "xdeepfm", "din", "autoint"]
RTOL = ATOL = 1e-5
OPT = dict(lr=1e-2, warmup_steps=0, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                          else got),
                               np.asarray(want), rtol=RTOL, atol=ATOL)


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope="module")
def repro_runs():
    """Per arch: ``repro``'s params, batch and outputs (one jit each)."""
    out = {}
    for aid in ARCHS:
        cfg = j_get_arch(aid).smoke_fn()
        p = jr.init_params(cfg, jax.random.PRNGKey(5))
        b = recsys_batch(0, 32, get_arch(aid).smoke_fn(), seed=3)

        @jax.jit
        def run(p, b):
            (loss, aux), g = jax.value_and_grad(
                lambda pp, bb: jr.loss_fn(pp, bb, cfg), has_aux=True)(p, b)
            logits, penult = jr.forward(p, b, cfg)
            new_p, new_o, m = j_adamw_update(g, j_adamw_init(p), p,
                                             JAdamWConfig(**OPT))
            return dict(loss=loss, logit_mean=aux["logit_mean"], grads=g,
                        logits=logits, penult=penult, new_p=new_p,
                        mu=new_o.mu, nu=new_o.nu, gnorm=m["grad_norm"])

        res = jax.tree.map(np.asarray, run(p, jax.tree.map(jnp.asarray, b)))
        out[aid] = (jax.tree.map(np.asarray, p), b, res)
    return out


@pytest.mark.parametrize("arch_id", ARCHS)
def test_forward_loss_grads_and_adamw_equal_repro(arch_id, repro_runs):
    np_params, b, want = repro_runs[arch_id]
    cfg = get_arch(arch_id).smoke_fn()
    params = tr.params_from_repro(np_params, device="cpu")
    assert sorted(params) == sorted(tr.param_shapes(cfg))
    for name, shape in tr.param_shapes(cfg).items():
        assert tuple(params[name].shape) == shape, name
    batch = _torch_batch(b)

    logits, penult = tr.forward(params, batch, cfg)
    _close(logits, want["logits"])
    _close(penult, want["penult"])
    (loss, aux), grads = value_and_grad(
        lambda p, bb: tr.loss_fn(p, bb, cfg), params, batch)
    _close(loss, want["loss"])
    _close(aux["logit_mean"], want["logit_mean"])
    assert sorted(grads) == sorted(want["grads"])
    for name in grads:
        _close(grads[name], want["grads"][name])

    # AdamW on the same gradients (repro's, carried across): a parameter
    # whose true gradient is 0 (din's last attention bias, under the
    # softmax's shift invariance) gets rounding noise of ~1e-10 in either
    # package, and Adam's first step turns that noise into +-lr
    jgrads = tr.params_from_repro(want["grads"], device="cpu")
    new_p, new_o, m = adamw_update(jgrads, adamw_init(params), params,
                                   AdamWConfig(**OPT))
    _close(m["grad_norm"], want["gnorm"])
    assert int(new_o.step) == 1
    for name in params:
        _close(new_p[name], want["new_p"][name])
        _close(new_o.mu[name], want["mu"][name])
        _close(new_o.nu[name], want["nu"][name])
        assert new_o.mu[name].dtype == torch.float32


def test_embedding_bag_fixed_ragged_and_repro_agree():
    rng = np.random.default_rng(4)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (6, 5))
    lens = rng.integers(1, 6, 6)
    mask = np.arange(5)[None] < lens[:, None]
    flat_ids = np.concatenate([ids[b, :lens[b]] for b in range(6)])
    seg = np.repeat(np.arange(6), lens)
    tt = torch.from_numpy(table)
    for combiner in ("mean", "sum"):
        fixed = tr.embedding_bag(tt, torch.from_numpy(ids),
                                 torch.from_numpy(mask), combiner=combiner)
        ragged = tr.embedding_bag_ragged(tt, torch.from_numpy(flat_ids),
                                         torch.from_numpy(seg), 6,
                                         combiner=combiner)
        j_fixed = jr.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                   jnp.asarray(mask), combiner=combiner)
        j_ragged = jr.embedding_bag_ragged(
            jnp.asarray(table), jnp.asarray(flat_ids), jnp.asarray(seg), 6,
            combiner=combiner)
        _close(fixed, ragged)
        _close(fixed, j_fixed)
        _close(ragged, j_ragged)
    # no mask: the mean over the whole bag
    _close(tr.embedding_bag(tt, torch.from_numpy(ids)),
           jr.embedding_bag(jnp.asarray(table), jnp.asarray(ids)))
    # an empty segment stays zero
    empty = tr.embedding_bag_ragged(tt, torch.tensor([1, 2]),
                                    torch.tensor([0, 0]), 3)
    assert torch.equal(empty[1:], torch.zeros(2, 8))


def _assert_topk(scores, ids, want_scores, want_ids):
    """Descending scores within the tolerance; ids equal except among
    near-tied scores."""
    scores, want_scores = np.asarray(scores), np.asarray(want_scores)
    ids, want_ids = np.asarray(ids), np.asarray(want_ids)
    np.testing.assert_allclose(scores, want_scores, rtol=RTOL, atol=ATOL)
    assert (np.diff(scores, axis=1) <= 0).all()
    for q in range(want_scores.shape[0]):
        for p in np.nonzero(ids[q] != want_ids[q])[0]:
            near = np.abs(want_scores[q] - want_scores[q, p]) <= ATOL
            assert near.sum() > 1 or p == want_ids.shape[1] - 1, (q, p)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_retrieval_step_equals_repro(arch_id, repro_runs):
    np_params, _, _ = repro_runs[arch_id]
    cfg = get_arch(arch_id).smoke_fn()
    b = recsys_batch(0, 3, cfg, seed=8)
    cand = np.random.default_rng(7).normal(
        size=(200, cfg.retrieval_dim)).astype(np.float32)
    jcfg = j_get_arch(arch_id).smoke_fn()
    jp = jax.tree.map(jnp.asarray, np_params)
    jb = jax.tree.map(jnp.asarray, b)
    top, jids = jr.retrieval_step(jp, jb, jnp.asarray(cand), jcfg, k=10)
    params = tr.params_from_repro(np_params, device="cpu")
    scores, ids = tr.retrieval_step(params, _torch_batch(b),
                                    torch.from_numpy(cand), cfg, k=10)
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (3, 10)
    _assert_topk(scores, ids, top, jids)
    u = tr.user_vector(params, _torch_batch(b), cfg)
    _close(u, jr.user_vector(jp, jb, jcfg))
    # the scores are the users' dot products with the returned rows
    full = (u @ torch.from_numpy(cand).T).detach()
    _close(scores, torch.gather(full, 1, ids.long()))


def test_retrieval_goes_through_ops_knn(monkeypatch):
    """The top-k is ``ops.knn`` in the ``dot`` form (``knn.cu`` on the
    card), not a matmul and ``torch.topk``."""
    from repro_torch.kernels import ops

    seen = []
    real = ops.knn

    def spy(Q, DB, distance="l2", **kw):
        seen.append((tuple(Q.shape), tuple(DB.shape), distance, kw.get("k")))
        return real(Q, DB, distance, **kw)

    monkeypatch.setattr(ops, "knn", spy)
    cfg = get_arch("autoint").smoke_fn()
    params = tr.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    b = _torch_batch(recsys_batch(0, 2, cfg, seed=1))
    cand = torch.randn((300, cfg.retrieval_dim),
                       generator=torch.Generator().manual_seed(1))
    tr.retrieval_step(params, b, cand, cfg, k=7)
    assert seen == [((2, cfg.retrieval_dim), (300, cfg.retrieval_dim), "dot",
                     7)]


@pytest.mark.parametrize("arch_id", ARCHS)
def test_recsys_learns_planted_signal(arch_id):
    cfg = get_arch(arch_id).smoke_fn()
    p = tr.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    opt = adamw_init(p)
    ocfg = AdamWConfig(lr=3e-3, total_steps=60, warmup_steps=0,
                       weight_decay=0.0, schedule="constant")
    losses = []
    for s in range(50):
        b = _torch_batch(recsys_batch(s, 256, cfg, seed=7))
        (loss, _), g = value_and_grad(lambda pp, bb: tr.loss_fn(pp, bb, cfg),
                                      p, b)
        p, opt, _ = adamw_update(g, opt, p, ocfg)
        losses.append(float(loss))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.01, (
        arch_id, losses[:3], losses[-3:])


def test_init_params_is_seeded_and_scaled():
    cfg = get_arch("xdeepfm").smoke_fn()
    a = tr.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = tr.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["tables"].std()) < 0.02
    assert torch.equal(a["mlp_b0"], torch.zeros_like(a["mlp_b0"]))
    assert cfg.n_params() == sum(v.numel() for v in a.values())
    assert cfg.n_params() == j_get_arch("xdeepfm").smoke_fn().n_params()


# ---------------------------------------------------------------------------
# the mesh branch, over 2 gloo ranks
# ---------------------------------------------------------------------------


def _mesh_inputs():
    cfg = get_arch("wide-deep").smoke_fn()
    params = tr.init_params(cfg, torch.Generator().manual_seed(11),
                            device="cpu")
    batch = _torch_batch(recsys_batch(2, 3, cfg, seed=4))
    cand = np.random.default_rng(9).normal(
        size=(400, cfg.retrieval_dim)).astype(np.float32)
    return cfg, params, batch, cand


def rank_retrieval(rank: int, world: int) -> dict:
    """One rank: the mesh branch on a (2, 1) ("data", "model") mesh."""
    from repro_torch.launch.mesh import make_mesh

    torch.set_num_threads(1)
    cfg, params, batch, cand = _mesh_inputs()
    mesh = make_mesh((world, 1), ("data", "model"))
    scores, ids = tr.retrieval_step(params, batch, cand, cfg, mesh, k=10)
    out = dict(scores=scores.detach().numpy(), ids=ids.numpy())
    try:
        tr.retrieval_step(params, batch, cand[:399], cfg, mesh, k=10)
    except ValueError as e:
        out["ragged"] = str(e)
    return out


def test_retrieval_mesh_branch_equals_one_process(tmp_path):
    cfg, params, batch, cand = _mesh_inputs()
    want_s, want_i = tr.retrieval_step(params, batch, torch.from_numpy(cand),
                                       cfg, k=10)
    outs = run_ranks(f"{HERE}:rank_retrieval", 2, workdir=str(tmp_path),
                     timeout=120)
    for o in outs:
        np.testing.assert_array_equal(o["ids"], outs[0]["ids"])
        np.testing.assert_array_equal(o["scores"], outs[0]["scores"])
        assert "not a multiple" in o["ragged"]
    _assert_topk(outs[0]["scores"], outs[0]["ids"], want_s.detach(), want_i)
