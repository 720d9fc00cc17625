"""The port's training substrate against ``repro``'s on the CPU: the model-zoo
batches, AdamW and its schedules and clipping, microbatch accumulation,
both gradient compressors, checkpoints (each package restoring the
other's), the train loop and the batch pipeline.

fp32 throughout; values within rtol = atol = 1e-5 unless a test says
bit-equal. PowerSGD starts from ``repro``'s initial Q, carried across.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as j_load_checkpoint
from repro.checkpoint import save_checkpoint as j_save_checkpoint
from repro.configs import get_arch as j_get_arch
from repro.data import synthetic as jsyn
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import accumulate_gradients as j_accumulate_gradients
from repro.optim import adamw_init as j_adamw_init
from repro.optim import clip_by_global_norm as j_clip_by_global_norm
from repro.optim import compression as jcomp
from repro.optim import cosine_schedule as j_cosine_schedule
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.configs import get_arch
from repro_torch.data import BatchPipeline, lm_tokens, recsys_batch
from repro_torch.models import recsys as tr
from repro_torch.optim import (AdamWConfig, OptState, accumulate_gradients,
                               adamw_init, adamw_update, clip_by_global_norm,
                               cosine_schedule, global_norm, value_and_grad)
from repro_torch.optim import compression as comp
from repro_torch.train import TrainLoopConfig, train_loop

RTOL = ATOL = 1e-5
ARCHS = ["wide-deep", "xdeepfm", "din", "autoint"]


def _close(got, want, **kw):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want),
                               **({"rtol": RTOL, "atol": ATOL} | kw))


# --------------------------- data ------------------------------------------


@pytest.mark.parametrize("arch_id", ARCHS)
def test_recsys_batch_bit_equal_to_repro(arch_id):
    cfg = get_arch(arch_id).smoke_fn()
    jcfg = j_get_arch(arch_id).smoke_fn()
    for step, seed in ((0, 0), (5, 7)):
        a = recsys_batch(step, 64, cfg, seed=seed)
        b = jsyn.recsys_batch(step, 64, jcfg, seed=seed)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    full = get_arch(arch_id).config_fn()  # full-width table rows
    a = recsys_batch(1, 8, full, seed=2)
    b = jsyn.recsys_batch(1, 8, j_get_arch(arch_id).config_fn(), seed=2)
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_lm_tokens_bit_equal_to_repro_and_stateless():
    for step, seed in ((0, 0), (5, 3)):
        a = lm_tokens(step, 4, 16, 100, seed=seed)
        b = jsyn.lm_tokens(step, 4, 16, 100, seed=seed)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert np.array_equal(lm_tokens(5, 4, 16, 100)["tokens"],
                          lm_tokens(5, 4, 16, 100)["tokens"])
    assert not np.array_equal(lm_tokens(5, 4, 16, 100)["tokens"],
                              lm_tokens(6, 4, 16, 100)["tokens"])


def test_batch_pipeline_order_and_prefetch():
    seen = []
    pipe = BatchPipeline(lambda s: {"step": np.asarray(s)}, prefetch=3)
    for _ in range(5):
        s, b = pipe.get()
        seen.append(int(b["step"]))
    pipe.close()
    assert seen == [0, 1, 2, 3, 4]


def test_batch_pipeline_places_slices_and_restarts():
    cfg = get_arch("din").smoke_fn()

    def make(s):
        return recsys_batch(s, 8, cfg, seed=1)

    pipe = BatchPipeline(make, start_step=3, device="cpu",
                         process_slice=lambda b, r, w: {
                             k: v[r::w] for k, v in b.items()})
    for want_step in (3, 4):
        step, b = pipe.get()
        assert step == want_step
        ref = make(step)  # rank 0 of a world of 1: the whole batch
        for k, v in b.items():
            assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
            assert np.array_equal(v.numpy(), ref[k])
    pipe.close()


# --------------------------- optimizer -------------------------------------


def test_adamw_matches_manual_reference():
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                      grad_clip=0.0, schedule="constant", warmup_steps=0)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.5])}
    p2, st2, _ = adamw_update(g, adamw_init(p), p, cfg)
    m, v = 0.1 * 0.5, 0.01 * 0.25
    mhat, vhat = m / 0.1, v / 0.01
    want = np.array([1.0, -2.0]) - 0.1 * mhat / (np.sqrt(vhat) + 1e-8)
    _close(p2["w"], want)
    assert int(st2.step) == 1 and st2.step.dtype == torch.int32
    assert torch.equal(p["w"], torch.tensor([1.0, -2.0]))  # functional


def test_weight_decay_decoupled():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5, grad_clip=0.0,
                      schedule="constant", warmup_steps=0)
    p = {"w": torch.tensor([2.0])}
    g = {"w": torch.tensor([0.0])}
    p2, _, _ = adamw_update(g, adamw_init(p), p, cfg)
    _close(p2["w"], [2.0 - 0.1 * 0.5 * 2.0])


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedules_equal_repro(schedule):
    cfg = AdamWConfig(lr=0.7, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1, schedule=schedule)
    jcfg = JAdamWConfig(lr=0.7, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1, schedule=schedule)
    for s in (0, 1, 9, 10, 11, 50, 99, 100, 150):
        _close(cosine_schedule(cfg, torch.tensor(s, dtype=torch.int32)),
               j_cosine_schedule(jcfg, jnp.int32(s)))
    if schedule == "cosine":
        assert float(cosine_schedule(cfg, 0)) == 0.0
        assert abs(float(cosine_schedule(cfg, 10)) - 0.7) < 1e-5
        assert abs(float(cosine_schedule(cfg, 100)) - 0.07) < 1e-3


def test_clip_by_global_norm_equals_repro():
    g = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert abs(float(gn) - 5.0) < 1e-5
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-5
    rng = np.random.default_rng(3)
    tree = {"x": rng.normal(size=(7, 3)).astype(np.float32),
            "y": {"z": rng.normal(size=(5,)).astype(np.float32)}}
    for max_norm in (0.5, 100.0):
        got, gn = clip_by_global_norm(
            {"x": torch.from_numpy(tree["x"]),
             "y": {"z": torch.from_numpy(tree["y"]["z"])}}, max_norm)
        want, jgn = j_clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                          max_norm)
        _close(gn, jgn)
        _close(got["x"], want["x"])
        _close(got["y"]["z"], want["y"]["z"])


def _lin_loss_torch(p, b):
    return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2), {"n": b["x"].shape[0]}


def test_grad_accumulation_matches_full_batch_and_repro():
    rng = np.random.default_rng(0)
    W = rng.normal(size=(6, 3)).astype(np.float32)
    X = rng.normal(size=(8, 6)).astype(np.float32)
    Y = rng.normal(size=(8, 3)).astype(np.float32)
    p = {"w": torch.from_numpy(W)}
    batch = {"x": torch.from_numpy(X), "y": torch.from_numpy(Y)}
    l1, _, g_full = accumulate_gradients(_lin_loss_torch, p, batch, 1)
    l4, aux, g_acc = accumulate_gradients(_lin_loss_torch, p, batch, 4)
    _close(g_full["w"], g_acc["w"], atol=1e-6)
    assert aux == {"n": 2}  # the last microbatch's

    def jloss(p, b):
        return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2), {}

    jl, _, jg = j_accumulate_gradients(
        jloss, {"w": jnp.asarray(W)}, {"x": jnp.asarray(X), "y": jnp.asarray(Y)},
        4)
    _close(g_acc["w"], jg["w"])
    _close(l4, jl)
    (l, _), g = value_and_grad(_lin_loss_torch, p, batch)
    _close(l, l1)
    assert not p["w"].requires_grad


# --------------------------- compression -----------------------------------


def test_topk_compression_error_feedback_and_repro():
    rng = np.random.default_rng(1)
    gn = rng.normal(size=(32, 8)).astype(np.float32)
    gn[0, :4] = 3.0  # equal magnitudes: the lower index first, as lax.top_k
    g = torch.from_numpy(gn)
    state = comp.topk_init(g)
    (vals, idx), state2 = comp.topk_compress(g, state, k=16)
    (jv, ji), jstate = jcomp.topk_compress(jnp.asarray(gn),
                                           jcomp.topk_init(jnp.asarray(gn)),
                                           k=16)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    _close(vals, jv)
    _close(state2.error, jstate.error)
    recon = comp.topk_decompress(vals, idx, g.shape)
    _close(recon, jcomp.topk_decompress(jv, ji, gn.shape))
    # the error buffer holds exactly the residual, re-injected next round
    _close(recon + state2.error, gn, atol=1e-6)
    (v2, i2), _ = comp.topk_compress(torch.zeros_like(g), state2, k=256)
    _close(recon + comp.topk_decompress(v2, i2, g.shape), gn)


def test_powersgd_equals_repro_with_its_q_and_converges():
    rng = np.random.default_rng(2)
    lowrank = (rng.normal(size=(20, 3)) @ rng.normal(size=(3, 15))
               ).astype(np.float32)
    jstate = jcomp.powersgd_init(lowrank.shape, rank=3)
    state = comp.powersgd_init(lowrank.shape, 3,
                               q=torch.from_numpy(np.array(jstate.q)),
                               device="cpu")
    g, jg = torch.from_numpy(lowrank), jnp.asarray(lowrank)
    for _ in range(3):  # warm-started Q converges on a fixed matrix
        (p_, q_), state = comp.powersgd_compress(g, state)
        (jp, jq), jstate = jcomp.powersgd_compress(jg, jstate)
        # P's columns are defined up to sign; the reconstruction is not
        signs = np.sign(np.sum(p_.numpy() * np.asarray(jp), axis=0))
        _close(p_ * torch.from_numpy(signs), jp)
        _close(comp.powersgd_decompress(p_, q_),
               jcomp.powersgd_decompress(jp, jq))
        _close(state.error, jstate.error)
    err = np.linalg.norm(comp.powersgd_decompress(p_, q_).numpy() - lowrank)
    assert err < 1e-2 * np.linalg.norm(lowrank)
    # the default Q: seeded, on the requested device
    a = comp.powersgd_init((4, 6), 2, device="cpu")
    b = comp.powersgd_init((4, 6), 2, torch.Generator().manual_seed(17),
                           device="cpu")
    assert torch.equal(a.q, b.q) and a.q.shape == (6, 2)


# --------------------------- checkpoint ------------------------------------


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
            "nested": {"b": torch.from_numpy(
                rng.integers(0, 9, 5).astype(np.int32))}}


def test_checkpoint_roundtrip(tmp_path):
    t = _tree(0)
    save_checkpoint(str(tmp_path), 7, t)
    assert latest_step(str(tmp_path)) == 7
    restored, step = load_checkpoint(str(tmp_path), t)
    assert step == 7
    assert torch.equal(restored["a"], t["a"])
    assert torch.equal(restored["nested"]["b"], t["nested"]["b"])
    with open(tmp_path / "step_000000007" / "manifest.json") as f:
        man = json.load(f)
    assert man["version"] == 2 and man["step"] == 7
    assert man["keys"] == {"a": {"shape": [4, 3], "dtype": "float32"},
                           "nested/b": {"shape": [5], "dtype": "int32"}}


def test_checkpoint_prune_keeps_newest(tmp_path):
    t = _tree(1)
    for s in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), s, t, keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_000000003", "step_000000004"]


def test_checkpoint_async_manager(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    t = _tree(2)
    mgr.save_async(3, t)
    mgr.wait()
    assert mgr.last_saved == 3
    restored, step = mgr.restore_or_none(t)
    assert step == 3 and torch.equal(restored["a"], t["a"])
    assert CheckpointManager(str(tmp_path / "none")).restore_or_none(t) == (
        None, None)


def test_checkpoint_atomic_no_partial(tmp_path):
    """A crashed (simulated) write must not become ``latest``."""
    t = _tree(3)
    save_checkpoint(str(tmp_path), 1, t)
    os.makedirs(tmp_path / "step_000000002.tmp-999", exist_ok=True)
    assert latest_step(str(tmp_path)) == 1
    _, step = load_checkpoint(str(tmp_path), t)
    assert step == 1


def _train_state(arch_id):
    """A ``(params, OptState)`` tree after one AdamW step (nonzero moments)."""
    cfg = get_arch(arch_id).smoke_fn()
    params = tr.init_params(cfg, torch.Generator().manual_seed(4),
                            device="cpu")
    b = {k: torch.from_numpy(v) for k, v in recsys_batch(0, 16, cfg).items()}
    (_, _), g = value_and_grad(lambda p, bb: tr.loss_fn(p, bb, cfg), params, b)
    params, opt, _ = adamw_update(g, adamw_init(params), params, AdamWConfig())
    return params, opt


@pytest.mark.parametrize("arch_id", ["xdeepfm", "din"])
def test_checkpoints_restore_across_packages(arch_id, tmp_path):
    params, opt = _train_state(arch_id)
    # the port writes, repro restores into its own (params, OptState)
    save_checkpoint(str(tmp_path / "port"), 5, (params, opt))
    jparams = {k: jnp.zeros(v.shape, jnp.float32) for k, v in params.items()}
    (jp, jo), step = j_load_checkpoint(str(tmp_path / "port"),
                                       (jparams, j_adamw_init(jparams)))
    assert step == 5 and int(jo.step) == 1
    for k, v in params.items():
        assert np.array_equal(np.asarray(jp[k]), v.numpy())
        assert np.array_equal(np.asarray(jo.mu[k]), opt.mu[k].numpy())
        assert np.array_equal(np.asarray(jo.nu[k]), opt.nu[k].numpy())
    # repro writes, the port restores
    j_save_checkpoint(str(tmp_path / "repro"), 9,
                      (jax.tree.map(jnp.asarray, jp),
                       jax.tree.map(jnp.asarray, jo)))
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    (tp, to), step = load_checkpoint(str(tmp_path / "repro"),
                                     (zeros, adamw_init(zeros)))
    assert step == 9 and isinstance(to, OptState)
    assert to.step.dtype == torch.int32 and int(to.step) == 1
    assert to.step.shape == ()
    for k, v in params.items():
        assert torch.equal(tp[k], v)
        assert torch.equal(to.mu[k], opt.mu[k])
        assert torch.equal(to.nu[k], opt.nu[k])
    # both wrote the same flat keys
    keys = [sorted(np.load(str(tmp_path / d / s / "arrays.npz")).files)
            for d, s in (("port", "step_000000005"),
                         ("repro", "step_000000009"))]
    assert keys[0] == keys[1] and "1/mu/tables" in keys[0]


# --------------------------- train loop ------------------------------------


def _quad_setup():
    target = torch.tensor([1.0, -2.0, 3.0])

    def loss_fn(p, b):
        return torch.sum((p["w"] - target) ** 2) * b["scale"], {}

    ocfg = AdamWConfig(lr=0.05, weight_decay=0.0, grad_clip=0.0,
                       schedule="constant", warmup_steps=0, total_steps=100)

    def step(params, opt, batch):
        (loss, _), g = value_and_grad(loss_fn, params, batch)
        params, opt, m = adamw_update(g, opt, params, ocfg)
        return params, opt, {"loss": loss, **m}

    return step, lambda s: {"scale": torch.tensor(1.0)}


def test_train_loop_restart_is_exact(tmp_path):
    """Interrupted-then-resumed run ends with the same params as an
    uninterrupted one (stateless data + checkpoint/restart)."""
    step, make_batch = _quad_setup()

    def fresh():
        p = {"w": torch.zeros(3)}
        return p, adamw_init(p)

    p_ref, _, hist = train_loop(step, *fresh(), make_batch,
                                TrainLoopConfig(total_steps=20))
    assert [s for s, _ in hist] == list(range(20))
    ck = str(tmp_path / "ck")
    train_loop(step, *fresh(), make_batch,
               TrainLoopConfig(total_steps=10, ckpt_dir=ck, ckpt_every=5))
    assert latest_step(ck) == 9
    p2, o2, hist2 = train_loop(step, *fresh(), make_batch,
                               TrainLoopConfig(total_steps=20, ckpt_dir=ck,
                                               ckpt_every=5))
    assert hist2[0][0] == 10 and int(o2.step) == 20
    assert torch.equal(p_ref["w"], p2["w"])


def test_train_loop_nan_sentinel(tmp_path):
    def step(params, opt, batch):
        return params, opt, {"loss": torch.tensor(float("nan")) * batch["x"]}

    p = {"w": torch.zeros(2)}
    ck = str(tmp_path / "ck")
    with pytest.raises(FloatingPointError, match="non-finite loss at step 0"):
        train_loop(step, p, adamw_init(p), lambda s: {"x": torch.tensor(1.0)},
                   TrainLoopConfig(total_steps=5, ckpt_dir=ck))
    assert latest_step(ck) is None  # no good step to save


@pytest.mark.parametrize("every", [1, 2])
def test_train_loop_nan_keeps_last_good_checkpoint(tmp_path, every):
    """A divergence at step 3 (NaN loss, NaN update) reaches no checkpoint:
    ``latest`` is step 2, the newest step whose loss was read finite, and
    it holds the state after step 2's update, finite and equal to an
    uninterrupted run's."""
    step, make_batch = _quad_setup()

    def poisoned(params, opt, batch):
        params, opt, m = step(params, opt, batch)
        if batch["step"] == 3:
            params = {k: torch.full_like(v, float("nan"))
                      for k, v in params.items()}
            m = {**m, "loss": torch.tensor(float("nan"))}
        return params, opt, m

    def fresh():
        p = {"w": torch.zeros(3)}
        return p, adamw_init(p)

    p_ref, o_ref, _ = train_loop(step, *fresh(), make_batch,
                                 TrainLoopConfig(total_steps=3))
    ck = str(tmp_path / "ck")
    with pytest.raises(FloatingPointError,
                       match="non-finite loss at step 3; last good ckpt "
                             "step 2"):
        train_loop(poisoned, *fresh(), lambda s: {**make_batch(s), "step": s},
                   TrainLoopConfig(total_steps=6, ckpt_dir=ck,
                                   ckpt_every=every))
    assert latest_step(ck) == 2
    (p, o), at = load_checkpoint(ck, fresh())
    assert at == 2 and bool(torch.isfinite(p["w"]).all())
    assert torch.equal(p["w"], p_ref["w"]) and int(o.step) == 3
    assert torch.equal(o.mu["w"], o_ref.mu["w"])
