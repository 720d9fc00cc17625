"""The port's transformer family (``repro_torch.models.transformer`` and its
five configs) against ``repro``'s on the CPU.

Each of the five ``smoke_config()`` archs, and ``tests/test_models.py``'s
``_tiny_cfg`` (dense and MoE), runs with ``dtype=float32`` in both
packages on the same weights (drawn with numpy from a seed at
``repro``'s init scales, carried across by ``params_from_repro``) and the
same ``lm_tokens`` batch. ``repro``'s forward, loss, gradients (its
config's ``remat=True``), one AdamW step, prefill and one decode step run
under one ``jax.jit`` per config (compiled at XLA's backend optimisation
level 0, which changes no floating-point rule and saves a third of the
compile); the port's gradients are held to them with remat on and off. Tolerances: fp32,
rtol = atol = 1e-5; gradients and the AdamW step 1e-4. Then the building
blocks alone (``flash_attention``'s chunking, offsets and fallback with
its gradients, ``_moe_local`` at a capacity that drops slots, ``rmsnorm``
and ``rope`` in bf16), the parameter counts, the mesh refusal, and
``test_models.py``'s and ``test_archs_smoke.py``'s LM tests on the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import transformer as jt
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro_torch._tree import tree_flatten_with_path, tree_leaves, tree_map
from repro_torch.configs import arch_ids, get_arch
from repro_torch.data import lm_tokens
from repro_torch.models import transformer as tt
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               value_and_grad)

LM = ["deepseek-moe-16b", "granite-3-2b", "minitron-8b",
      "qwen3-moe-235b-a22b", "stablelm-1.6b"]
CONFIGS = LM + ["tiny-dense", "tiny-moe"]
RTOL = ATOL = 1e-5
GTOL = 1e-4  # gradients and the AdamW step
OPT = dict(lr=1e-2, warmup_steps=0, total_steps=10)
B = 2
DECODE_PAD = 8  # cache slots past the prompt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_cfg(pkg, moe=False):
    """``tests/test_models.py``'s ``_tiny_cfg`` in either package."""
    m = pkg.MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, n_shared=1,
                      capacity_factor=2.0) if moe else None
    return pkg.TransformerConfig(
        name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
        vocab=101, seq_chunk=8, kv_chunk=8, moe=m)


def _configs(cid):
    """(repro's config, the port's config), both float32."""
    if cid.startswith("tiny-"):
        jcfg, cfg = (_tiny_cfg(jt, cid == "tiny-moe"),
                     _tiny_cfg(tt, cid == "tiny-moe"))
    else:
        jcfg, cfg = j_get_arch(cid).smoke_fn(), get_arch(cid).smoke_fn()
    return (dataclasses.replace(jcfg, dtype=jnp.float32),
            dataclasses.replace(cfg, dtype=torch.float32))


def _seq(cfg) -> int:
    # three KV and xent chunks of the config's own size
    return 3 * cfg.kv_chunk


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _close(got, want, tol=RTOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol, atol=tol)


def _tree_close(got, want, tol):
    want_flat = dict(tree_flatten_with_path(want))
    got_flat = tree_flatten_with_path(got)
    assert sorted(p for p, _ in got_flat) == sorted(want_flat)
    for path, g in got_flat:
        np.testing.assert_allclose(_np(g), want_flat[path], rtol=tol,
                                   atol=tol, err_msg=str(path))


def _torch(b: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


def _jit(fn, *args):
    """``jax.jit(fn)(*args)`` compiled with :data:`_FAST_COMPILE`."""
    return jax.jit(fn).lower(*args).compile(_FAST_COMPILE)(*args)


def _np_params(jcfg, seed) -> dict:
    """Params at ``repro.models.transformer.init_params``' scales (N(0,
    1/fan_in), norms 1), drawn with numpy: both packages get these."""
    rng = np.random.default_rng(seed)

    def draw(s):
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    p = jax.tree.map(draw, jt.param_shapes(jcfg))
    for name in ("ln1", "ln2"):
        p["layers"][name] = np.ones_like(p["layers"][name])
    p["final_norm"] = np.ones_like(p["final_norm"])
    return p


@pytest.fixture(scope="module")
def repro_runs():
    """Per config: ``repro``'s params, batch, next tokens and outputs."""
    out = {}
    for i, cid in enumerate(CONFIGS):
        jcfg, cfg = _configs(cid)
        S = _seq(cfg)
        p = _np_params(jcfg, 10 + i)
        b = lm_tokens(0, B, S, cfg.vocab, seed=i)
        nxt = b["labels"][:, -1:]
        sh = jt.ShardingConfig()

        def run(p, b, nxt):
            hidden, aux = jt.forward(p, b["tokens"], jcfg, sh)
            (loss, parts), g = jax.value_and_grad(
                lambda pp: jt.loss_fn(pp, b, jcfg, sh), has_aux=True)(p)
            new_p, new_o, m = j_adamw_update(g, j_adamw_init(p), p,
                                             JAdamWConfig(**OPT))
            logits_p, cache_p = jt.prefill_step(p, b["tokens"], jcfg, sh)
            pad = ((0, 0), (0, 0), (0, DECODE_PAD), (0, 0), (0, 0))
            cache = {n: jnp.pad(c, pad) for n, c in cache_p.items()}
            logits_d, cache_d = jt.decode_step(p, cache, nxt, jnp.int32(S),
                                               jcfg, sh)
            return dict(hidden=hidden, aux=aux, loss=loss, nll=parts["nll"],
                        aux_loss=parts["aux"], grads=g, new_p=new_p,
                        mu=new_o.mu, nu=new_o.nu, gnorm=m["grad_norm"],
                        logits_p=logits_p, cache_p=cache_p,
                        logits_d=logits_d, cache_d=cache_d)

        res = jax.tree.map(np.asarray, _jit(run, p, b, nxt))
        out[cid] = (p, b, nxt, res)
    return out


def _port(cid, repro_runs, **changes):
    np_params, b, nxt, want = repro_runs[cid]
    _, cfg = _configs(cid)
    cfg = dataclasses.replace(cfg, **changes)
    return cfg, tt.params_from_repro(np_params, device="cpu"), _torch(b), \
        torch.from_numpy(nxt), want


# --------------------------- the model against repro ----------------------


@pytest.mark.parametrize("cid", CONFIGS)
def test_param_shapes_and_params_equal_repro(cid, repro_runs):
    jcfg, cfg = _configs(cid)
    cfg, params, *_ = _port(cid, repro_runs)
    mine = tree_flatten_with_path(tt.param_shapes(cfg))
    theirs = dict(tree_flatten_with_path(jt.param_shapes(jcfg)))
    assert sorted(p for p, _ in mine) == sorted(theirs)
    for path, s in mine:
        assert s.shape == theirs[path].shape and s.dtype == torch.float32
        got = dict(tree_flatten_with_path(params))[path]
        assert tuple(got.shape) == s.shape and got.dtype == torch.float32


@pytest.mark.parametrize("cid", CONFIGS)
def test_forward_and_loss_equal_repro(cid, repro_runs):
    cfg, params, batch, _, want = _port(cid, repro_runs)
    sh = tt.ShardingConfig()
    with torch.no_grad():
        hidden, aux = tt.forward(params, batch["tokens"], cfg, sh)
        loss, parts = tt.loss_fn(params, batch, cfg, sh)
    _close(hidden, want["hidden"])
    _close(aux, want["aux"])
    _close(loss, want["loss"])
    _close(parts["nll"], want["nll"])
    _close(parts["aux"], want["aux_loss"])
    assert (float(aux) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("cid", CONFIGS)
def test_grads_equal_repro(cid, remat, repro_runs):
    cfg, params, batch, _, want = _port(cid, repro_runs, remat=remat)
    sh = tt.ShardingConfig()
    (loss, _), grads = value_and_grad(
        lambda p, b: tt.loss_fn(p, b, cfg, sh), params, batch)
    _close(loss, want["loss"])
    _tree_close(grads, want["grads"], GTOL)
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))


@pytest.mark.parametrize("cid", CONFIGS)
def test_adamw_step_equals_repro(cid, repro_runs):
    # AdamW on repro's gradients, carried across: its first step turns a
    # gradient's rounding noise into +-lr, so the update is held on the
    # same inputs and the gradients to jax.grad above
    cfg, params, _, _, want = _port(cid, repro_runs)
    jgrads = tt.params_from_repro(want["grads"], device="cpu")
    new_p, new_o, m = adamw_update(jgrads, adamw_init(params), params,
                                   AdamWConfig(**OPT))
    _close(m["grad_norm"], want["gnorm"], GTOL)
    assert int(new_o.step) == 1
    _tree_close(new_p, want["new_p"], GTOL)
    _tree_close(new_o.mu, want["mu"], GTOL)
    _tree_close(new_o.nu, want["nu"], GTOL)


@pytest.mark.parametrize("cid", CONFIGS)
def test_prefill_and_decode_equal_repro(cid, repro_runs):
    cfg, params, batch, nxt, want = _port(cid, repro_runs)
    sh = tt.ShardingConfig()
    S = batch["tokens"].shape[1]
    with torch.no_grad():
        logits, cache = tt.prefill_step(params, batch["tokens"], cfg, sh)
    V = cfg.vocab
    assert logits.shape == (B, cfg.vocab_padded)
    _close(logits[:, :V], want["logits_p"][:, :V])
    assert bool(torch.isneginf(logits[:, V:]).all())
    for n in ("k", "v"):
        _close(cache[n], want["cache_p"][n])

    shapes = tt.cache_shapes(cfg, B, S + DECODE_PAD)
    full = {n: torch.zeros(s.shape, dtype=s.dtype) for n, s in shapes.items()}
    for n in ("k", "v"):
        full[n][:, :, :S] = cache[n]
    with torch.no_grad():
        logits_d, same = tt.decode_step(params, full, nxt, S, cfg, sh)
    assert same is full  # written in place
    _close(logits_d[:, :V], want["logits_d"][:, :V])
    assert bool(torch.isneginf(logits_d[:, V:]).all())
    for n in ("k", "v"):
        _close(full[n], want["cache_d"][n])


# --------------------------- building blocks --------------------------------


FLASH_CASES = [  # (Sq, Skv, H, hd, kv_chunk, causal, q_offset)
    (24, 24, 2, 8, 8, True, 0),  # three chunks, rows masked whole in some
    (8, 24, 2, 8, 8, True, 16),  # the last 8 queries of 24 (q_offset)
    (12, 20, 3, 4, 8, False, 0),  # 20 % 8: the single-chunk fallback
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_and_its_grads_equal_repro(case):
    Sq, Skv, H, hd, c, causal, off = case
    rng = np.random.default_rng(Sq * Skv + c)
    q, k, v, w = (rng.normal(size=s).astype(np.float32) for s in
                  ((2, Sq, H, hd), (2, Skv, H, hd), (2, Skv, H, hd),
                   (2, Sq, H, hd)))

    def jf(q, k, v):
        out = jt.flash_attention(q, k, v, causal=causal, kv_chunk=c,
                                 q_offset=off)
        return jnp.sum(out * w), out

    (_, want), jg = _jit(jax.value_and_grad(jf, argnums=(0, 1, 2),
                                            has_aux=True), q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = tt.flash_attention(tq, tk, tv, causal=causal, kv_chunk=c,
                             q_offset=off)
    _close(got, want)
    torch.sum(got * torch.from_numpy(w)).backward()
    for t, g in zip((tq, tk, tv), jg):
        assert bool(torch.isfinite(t.grad).all())
        _close(t.grad, g, GTOL)


def test_moe_local_drops_slots_as_repro_does():
    moe = tt.MoEConfig(n_experts=4, top_k=2, d_ff_expert=16,
                       capacity_factor=0.5)
    jmoe = jt.MoEConfig(n_experts=4, top_k=2, d_ff_expert=16,
                        capacity_factor=0.5)
    rng = np.random.default_rng(7)
    T, d = 40, 12
    x = rng.normal(size=(T, d)).astype(np.float32)
    # a skewed router, so some experts take more than their C slots
    rw = (rng.normal(size=(d, 4)) + np.array([1.5, 0.5, 0, -1])).astype(np.float32)
    ws = [rng.normal(size=s).astype(np.float32) * 0.3
          for s in ((4, d, 16), (4, d, 16), (4, 16, d))]
    w = rng.normal(size=(T, d)).astype(np.float32)
    C = tt.capacity(moe, T)
    assert C == 10  # ceil(0.5 * 40 * 2 / 4)

    def jf(*a):
        y, aux = jt._moe_local(*a, moe=jmoe, model_axis="model", ep=1,
                               dtype=jnp.float32)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (jy, jaux)), jg = _jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2, 3, 4), has_aux=True), x, rw, *ws)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (x, rw, *ws)]
    y, aux = tt._moe_local(*args, moe=moe, dtype=torch.float32)
    _close(y, jy)
    _close(aux, jaux)
    (torch.sum(y * torch.from_numpy(w)) + aux).backward()
    for t, g in zip(args, jg):
        _close(t.grad, g, GTOL)

    _, _, top_e = tt.route(torch.from_numpy(x), torch.from_numpy(rw), 2)
    counts = torch.bincount(top_e.reshape(-1), minlength=4)
    dropped = int(torch.clamp(counts - C, min=0).sum())
    assert dropped > 0  # the case under test
    # a token whose every slot dropped gets 0
    kept = torch.zeros(T, dtype=torch.int64)
    flat = top_e.reshape(-1)
    order = torch.argsort(flat, stable=True)
    rank = torch.arange(T * 2) - torch.searchsorted(flat[order],
                                                    torch.arange(4))[flat[order]]
    kept.index_add_(0, order // 2, (rank < C).long())
    assert bool((y[kept == 0] == 0).all())


def test_rmsnorm_and_rope_in_bf16_equal_repro():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 4, 16)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32) + 3, (2, 6))
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    want = np.asarray(jt.rmsnorm(jx, jnp.asarray(scale), 1e-6), np.float32)
    got = tt.rmsnorm(tx, torch.from_numpy(scale), 1e-6)
    assert got.dtype == torch.bfloat16
    # the same fp32 arithmetic and one bf16 rounding in both: bit-equal
    np.testing.assert_array_equal(got.float().numpy(), want)
    want = np.asarray(jt.rope(jx, jnp.asarray(pos), 10000.0), np.float32)
    got = tt.rope(tx, torch.from_numpy(np.ascontiguousarray(pos)), 10000.0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("arch_id", LM)
def test_param_counts_of_full_configs_equal_repro(arch_id):
    cfg, jcfg = get_arch(arch_id).config_fn(), j_get_arch(arch_id).config_fn()
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()
    total = sum(int(np.prod(s.shape))
                for s in tree_leaves(tt.param_shapes(cfg)))
    V, Vp, d = cfg.vocab, cfg.vocab_padded, cfg.d_model
    assert total == cfg.n_params() + 2 * (Vp - V) * d  # padded vocab rows


def test_a_mesh_raises_naming_roadmap_9d():
    cfg = _tiny_cfg(tt, moe=True)
    sh = tt.ShardingConfig()
    p = tt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    cache = {n: torch.zeros(s.shape, dtype=s.dtype)
             for n, s in tt.cache_shapes(cfg, 1, 8).items()}
    mesh = object()
    calls = [
        lambda: tt.forward(p, toks, cfg, sh, mesh),
        lambda: tt.loss_fn(p, dict(tokens=toks, labels=toks), cfg, sh, mesh),
        lambda: tt.prefill_step(p, toks, cfg, sh, mesh),
        lambda: tt.decode_step(p, cache, toks[:, :1], 0, cfg, sh, mesh),
        lambda: tt.moe_block(torch.zeros(1, 8, 32), p["layers"], cfg, sh,
                             mesh),
    ]
    for call in calls:
        with pytest.raises(NotImplementedError, match="ROADMAP item 9d"):
            call()
    with pytest.raises(NotImplementedError, match="ROADMAP item 9d"):
        tt._moe_local(torch.zeros(4, 32), *(torch.zeros(1),) * 4,
                      moe=cfg.moe, ep=2)


def test_init_params_is_seeded_and_scaled():
    cfg = get_arch("deepseek-moe-16b").smoke_fn()
    a = tt.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    b = tt.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y) and x.dtype == torch.float32
    for name in ("ln1", "ln2"):
        assert bool((a["layers"][name] == 1).all())
    assert bool((a["final_norm"] == 1).all())
    # N(0, 1/fan_in): fan_in = shape[-2] (V for embed, d for wq)
    assert abs(float(a["embed"].std()) * np.sqrt(cfg.vocab_padded) - 1) < 0.05
    assert abs(float(a["layers"]["wq"].std()) * np.sqrt(cfg.d_model) - 1) < 0.05


# ----------------- test_models.py's LM tests, on the port ------------------


def _tok(seed, shape, vocab):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32))


def _params(cfg, seed):
    return tt.init_params(cfg, torch.Generator().manual_seed(seed),
                          device="cpu")


def _zeros_cache(cfg, batch, seq):
    return {n: torch.zeros(s.shape, dtype=s.dtype)
            for n, s in tt.cache_shapes(cfg, batch, seq).items()}


@pytest.mark.parametrize("moe", [False, True])
def test_lm_decode_matches_forward(moe):
    cfg = _tiny_cfg(tt, moe)
    sh = tt.ShardingConfig()
    p = _params(cfg, 0)
    toks = _tok(1, (2, 9), cfg.vocab)
    with torch.no_grad():
        hidden, _ = tt.forward(p, toks, cfg, sh)
        ref = hidden[:, -1].float() @ p["lm_head"].float()
        cache = _zeros_cache(cfg, 2, 16)
        for t in range(9):
            logits, cache = tt.decode_step(p, cache, toks[:, t:t + 1], t,
                                           cfg, sh)
    V = cfg.vocab
    np.testing.assert_allclose(logits[:, :V].numpy(), ref[:, :V].numpy(),
                               atol=1e-2, rtol=1e-2)


def test_lm_prefill_matches_decode():
    cfg = _tiny_cfg(tt)
    sh = tt.ShardingConfig()
    p = _params(cfg, 2)
    toks = _tok(3, (2, 8), cfg.vocab)
    with torch.no_grad():
        logits_p, cache_p = tt.prefill_step(p, toks, cfg, sh)
        cache = _zeros_cache(cfg, 2, 16)
        for t in range(8):
            logits_d, cache = tt.decode_step(p, cache, toks[:, t:t + 1],
                                             torch.tensor(t), cfg, sh)
    V = cfg.vocab
    np.testing.assert_allclose(logits_p[:, :V].numpy(),
                               logits_d[:, :V].numpy(), atol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache_p[key].float().numpy(),
                                   cache[key][:, :, :8].float().numpy(),
                                   atol=1e-5)


def test_lm_scan_equals_unrolled():
    cfg = _tiny_cfg(tt)
    sh = tt.ShardingConfig()
    p = _params(cfg, 4)
    toks = _tok(5, (2, 8), cfg.vocab)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    with torch.no_grad():
        l1, _ = tt.loss_fn(p, batch, cfg, sh)
        cfg2 = dataclasses.replace(cfg, scan_layers=False, unroll_inner=True)
        l2, _ = tt.loss_fn(p, batch, cfg2, sh)
    assert torch.equal(l1, l2)  # the knobs run the one layer loop


def test_lm_training_reduces_loss():
    cfg = _tiny_cfg(tt)
    sh = tt.ShardingConfig()
    p = _params(cfg, 6)
    opt = adamw_init(p)
    ocfg = AdamWConfig(lr=1e-2, total_steps=30, warmup_steps=0,
                       weight_decay=0.0, schedule="constant")
    toks = _tok(7, (4, 16), cfg.vocab)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    losses = []
    for _ in range(25):
        (loss, _), g = value_and_grad(
            lambda pp, bb: tt.loss_fn(pp, bb, cfg, sh), p, batch)
        p, opt, _ = adamw_update(g, opt, p, ocfg)
        losses.append(float(loss))
    assert losses[-1] < losses[0] - 1.0, (losses[0], losses[-1])


def test_moe_capacity_drops_are_bounded():
    cfg = _tiny_cfg(tt, moe=True)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(64, 32)).astype(np.float32))
    lw = _params(cfg, 9)["layers"]
    lw0 = {k: v[0] for k, v in lw.items()}
    y, aux = tt._moe_local(
        x, lw0["router"], lw0["we_gate"], lw0["we_up"], lw0["we_down"],
        moe=cfg.moe, model_axis="model", ep=1, dtype=torch.float32)
    assert y.shape == x.shape
    assert float(aux) > 0.5  # load-balance loss near 1 for near-uniform


# -------------- test_archs_smoke.py's LM tests, on the port ----------------

_OCFG = AdamWConfig(lr=1e-3, total_steps=10)


def test_registry_lists_the_five_lm_archs():
    assert [a for a in arch_ids() if get_arch(a).family == "lm"] == LM


@pytest.mark.parametrize("arch_id", LM)
def test_lm_smoke_train_step(arch_id):
    cfg = get_arch(arch_id).smoke_fn()
    sh = tt.ShardingConfig()
    params = _params(cfg, 0)
    opt = adamw_init(params)
    toks = _tok(1, (2, 32), cfg.vocab)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    (loss, _), grads = value_and_grad(
        lambda p, b: tt.loss_fn(p, b, cfg, sh), params, batch)
    params2, _, _ = adamw_update(grads, opt, params, _OCFG)
    assert np.isfinite(float(loss)) and float(loss) > 0
    for t in tree_leaves(params2) + tree_leaves(grads):
        assert bool(torch.isfinite(t.float()).all())
    assert ([p for p, _ in tree_flatten_with_path(params2)]
            == [p for p, _ in tree_flatten_with_path(params)])
    assert tree_map(lambda t: t.dtype, params2) == tree_map(
        lambda t: t.dtype, params)


@pytest.mark.parametrize("arch_id", LM)
def test_lm_smoke_decode_step(arch_id):
    cfg = get_arch(arch_id).smoke_fn()
    sh = tt.ShardingConfig()
    params = _params(cfg, 2)
    cache = _zeros_cache(cfg, 2, 16)
    toks = _tok(3, (2, 1), cfg.vocab)
    with torch.no_grad():
        logits, cache = tt.decode_step(params, cache, toks, 0, cfg, sh)
    assert logits.shape == (2, cfg.vocab_padded)
    assert bool(torch.isfinite(logits[:, :cfg.vocab]).all())
    assert cache["k"].dtype == torch.bfloat16
