"""Decoder-only transformer LMs, dense and MoE (counterpart of
``repro.models.transformer``).

Params are nested dicts of tensors under ``repro``'s names: the layer
weights are stacked ``[L, ...]`` under ``layers`` (``ln1``, ``wq``, ...,
``we_gate``, ...), beside ``embed``, ``final_norm`` and ``lm_head``. So a
checkpoint of either package restores in the other, and
:func:`params_from_repro` carries ``repro``'s weights across. The layers run
in a Python loop over ``L``.

Features mapped to the archs:
  * GQA        — ``n_kv_heads < n_heads`` (minitron/granite/qwen3), MHA when
                 equal (stablelm, deepseek-moe).
  * MoE        — top-k routing, shared experts, the load-balance aux loss
                 and the capacity-bounded sort dispatch (prefill and
                 training); decode gathers each token's top-k experts and
                 drops nothing (:func:`_moe_local_dense`).
  * Training   — causal LM, chunked online-softmax attention
                 (:func:`flash_attention`), chunked-vocab cross-entropy
                 (never a ``[B, S, V]`` tensor), per-layer remat through
                 ``torch.utils.checkpoint``.
  * Decode     — :func:`decode_step`: one token against a KV cache of
                 ``[L, B, S, KV, hd]``, written in place.

Dtype policy, as ``repro``'s: params are stored in ``param_dtype`` (fp32
master) and cast to ``dtype`` (bf16) for compute; attention, norms, the
router and the loss accumulate in fp32. ``repro`` computes all of this in
``jnp`` outside any Pallas kernel, so every product here is a library
call; attention keeps ``repro``'s chunked fp32 online softmax rather than
``scaled_dot_product_attention``.

``param_specs`` / ``cache_specs`` give ``repro``'s shardings as plain
:class:`~repro_torch._spec.PSpec` data (``launch/steps.py`` records them).
Not here (ROADMAP item 9d-2, the mesh paths): running sharded, expert
parallelism over a mesh and the 2D expert-parallel decode. A non-``None``
``mesh`` raises ``NotImplementedError``. ``scan_layers`` and ``unroll_inner`` are
``repro``'s XLA probe knobs: kept as fields so the configs compare equal,
both values run the same layer loop.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch._spec import PSpec, ShapeDtype  # noqa: F401  (ShapeDtype: re-exported)
from repro_torch._tree import tree_map
from repro_torch.kernels.ref import topk_largest

Tensor = torch.Tensor

_MESH_ITEM = "ROADMAP item 9d-2"


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0  # shared (always-on) experts, deepseek-style
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    seq_chunk: int = 2048  # chunked-xent sequence chunk
    kv_chunk: int = 1024  # flash-attention KV block
    remat: bool = True
    # repro's XLA roofline-probe knobs; the port runs one layer loop for
    # either value
    scan_layers: bool = True
    unroll_inner: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 256 (Megatron-style); padded
        logit columns are masked to -inf."""
        return -(-self.vocab // 256) * 256

    def n_params(self) -> int:
        """Total parameter count (embeddings included)."""
        d, hd, H, KV, V = self.d_model, self.hd, self.n_heads, self.n_kv_heads, self.vocab
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        if self.moe:
            m = self.moe
            ffn = m.n_experts * 3 * d * m.d_ff_expert + d * m.n_experts
            ffn += m.n_shared * 3 * d * m.d_ff_expert
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn + ffn + 2 * d
        return self.n_layers * per_layer + 2 * V * d + d

    def n_active_params(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        if not self.moe:
            return self.n_params()
        m = self.moe
        d = self.d_model
        routed_all = m.n_experts * 3 * d * m.d_ff_expert
        routed_active = m.top_k * 3 * d * m.d_ff_expert
        return self.n_params() - self.n_layers * (routed_all - routed_active)


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Logical-axis assignment onto a mesh (plain data: the port runs on
    one device until ROADMAP item 9d-2)."""

    batch_axes: tuple = ("data",)
    model_axis: str = "model"
    cache_seq_axes: tuple = ("model",)
    cache_batch_axes: tuple = ()

    @property
    def b(self):
        if not self.batch_axes:
            return None
        return self.batch_axes if len(self.batch_axes) != 1 else self.batch_axes[0]

    @property
    def m(self):
        return self.model_axis


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"the transformer with a mesh (GSPMD specs, expert parallelism) "
            f"is {_MESH_ITEM}, not ported yet; pass mesh=None")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def param_shapes(cfg: TransformerConfig) -> dict:
    """:class:`ShapeDtype` of every parameter, nested as ``repro``'s."""
    d, hd, H, KV, V, L = (
        cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.vocab_padded,
        cfg.n_layers,
    )
    pd = cfg.param_dtype

    def f(*s):
        return ShapeDtype(s, pd)

    layer = dict(
        ln1=f(L, d),
        ln2=f(L, d),
        wq=f(L, d, H * hd),
        wk=f(L, d, KV * hd),
        wv=f(L, d, KV * hd),
        wo=f(L, H * hd, d),
    )
    if cfg.moe:
        m = cfg.moe
        layer.update(
            router=f(L, d, m.n_experts),
            we_gate=f(L, m.n_experts, d, m.d_ff_expert),
            we_up=f(L, m.n_experts, d, m.d_ff_expert),
            we_down=f(L, m.n_experts, m.d_ff_expert, d),
        )
        if m.n_shared:
            ffs = m.n_shared * m.d_ff_expert
            layer.update(
                ws_gate=f(L, d, ffs), ws_up=f(L, d, ffs), ws_down=f(L, ffs, d)
            )
    else:
        layer.update(
            w_gate=f(L, d, cfg.d_ff),
            w_up=f(L, d, cfg.d_ff),
            w_down=f(L, cfg.d_ff, d),
        )
    return dict(embed=f(V, d), layers=layer, final_norm=f(d), lm_head=f(d, V))


def param_specs(cfg: TransformerConfig, sh: ShardingConfig) -> dict:
    """:class:`~repro_torch._spec.PSpec` of every parameter, as
    ``repro``'s: TP over ``model``, FSDP over the batch axes. The leading
    layer dim is never split."""
    b, m = sh.b, sh.m
    layer = dict(
        ln1=PSpec(None, None),
        ln2=PSpec(None, None),
        wq=PSpec(None, b, m),
        wk=PSpec(None, b, m),
        wv=PSpec(None, b, m),
        wo=PSpec(None, m, b),
    )
    if cfg.moe:
        layer.update(
            router=PSpec(None, b, None),
            we_gate=PSpec(None, m, b, None),
            we_up=PSpec(None, m, b, None),
            we_down=PSpec(None, m, None, b),
        )
        if cfg.moe.n_shared:
            layer.update(ws_gate=PSpec(None, b, m), ws_up=PSpec(None, b, m),
                         ws_down=PSpec(None, m, b))
    else:
        layer.update(w_gate=PSpec(None, b, m), w_up=PSpec(None, b, m),
                     w_down=PSpec(None, m, b))
    return dict(embed=PSpec(m, b), layers=layer, final_norm=PSpec(None),
                lm_head=PSpec(b, m))


_NORMS = ("ln1", "ln2", "final_norm")


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random params on ``device`` (CUDA unless ``device="cpu"``), at
    ``repro``'s scales: N(0, 1/fan_in) with fan_in = ``shape[-2]`` (V for
    ``embed``), norm scales 1. Drawn in ``repro``'s leaf order from
    ``generator``, on the generator's own device, then moved to
    ``device``."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)

    def draw(name, s):
        if name in _NORMS:
            return torch.ones(s.shape, dtype=s.dtype, device=dev)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        w = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return w.mul_(1.0 / math.sqrt(max(fan_in, 1))).to(dev, s.dtype)

    out = {}
    for name in sorted(shapes):
        if name == "layers":
            out[name] = {n: draw(n, s) for n, s in sorted(shapes[name].items())}
        else:
            out[name] = draw(name, shapes[name])
    return out


def params_from_repro(np_params: dict, device="cuda") -> dict:
    """``repro``'s params (nested dicts of arrays under the same names) as
    the port's, float32 tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda v: torch.from_numpy(np.array(v, np.float32)).to(dev),
                    np_params)


def _layer_params(params: dict, l: int) -> dict:
    return {k: v[l] for k, v in params["layers"].items()}


def _remat(enabled: bool, fn, *args):
    """``fn(*args)``, recomputed in the backward pass when ``enabled`` and
    autograd is recording (``jax.checkpoint``'s counterpart)."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rmsnorm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary embedding. x: [..., S, n_heads, hd], positions: [..., S]."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32, device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., None].float() * freqs  # [..., S, half]
    cos = torch.cos(ang)[..., None, :]  # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def swiglu(x: Tensor, w_gate: Tensor, w_up: Tensor, w_down: Tensor) -> Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                    kv_chunk: int, q_offset: int = 0,
                    unroll: bool = False) -> Tensor:
    """Online-softmax attention over KV chunks, in fp32.

    q: [B, Sq, H, hd]; k, v: [B, Skv, H, hd] (kv heads already repeated).
    Keeps running (max, sum, acc) across chunks; one chunk of ``Skv`` when
    ``kv_chunk`` does not divide it. Rows with every key masked so far are
    guarded, so no ``exp(-inf - -inf)`` reaches a value or a gradient.
    ``unroll`` is ``repro``'s scan knob and changes nothing here.
    """
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    c = min(kv_chunk, Skv)
    if Skv % c:
        c = Skv  # fallback: single chunk
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qf = q.float() * scale
    q_pos = q_offset + torch.arange(Sq, device=dev)

    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=dev)
    for j in range(Skv // c):
        kb = k[:, j * c:(j + 1) * c].float()
        vb = v[:, j * c:(j + 1) * c].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)  # [B, H, Sq, c]
        if causal:
            kv_pos = j * c + torch.arange(c, device=dev)
            s = torch.where(q_pos[:, None] >= kv_pos[None, :], s, -math.inf)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        # fully-masked rows (m_new = -inf): exp(-inf - -inf) would be nan
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        alpha = torch.exp(torch.where(torch.isfinite(m), m - m_safe, -math.inf))
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)  # [B, Sq, H, hd]


def _repeat_kv(k: Tensor, n_rep: int) -> Tensor:
    """[B, S, KV, hd] -> [B, S, KV * n_rep, hd]."""
    if n_rep == 1:
        return k
    B, S, KV, hd = k.shape
    return k[:, :, :, None, :].expand(B, S, KV, n_rep, hd).reshape(
        B, S, KV * n_rep, hd)


# ---------------------------------------------------------------------------
# MoE block
# ---------------------------------------------------------------------------


def route(x_flat: Tensor, router_w: Tensor, k: int):
    """Router of ``T`` tokens: ``(probs [T, E], top_p [T, k] renormalised,
    top_e [T, k] int64)``, the lower expert first among equal
    probabilities (``lax.top_k``'s order)."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = topk_largest(probs, k)
    top_p = top_p / torch.clamp(torch.sum(top_p, dim=-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e.long()


def capacity(moe: MoEConfig, n_tokens: int) -> int:
    """Slots per expert of the sort dispatch, from the host's token count."""
    return max(1, int(math.ceil(moe.capacity_factor * n_tokens * moe.top_k
                                / moe.n_experts)))


def _moe_local(x_flat, router_w, we_gate, we_up, we_down, *, moe: MoEConfig,
               model_axis: str = "model", ep: int = 1, dtype=torch.bfloat16):
    """Route -> sort-dispatch into ``[E, C, d]`` -> expert ffn -> combine.

    x_flat: [T, d] tokens; we_*: [E, ...] every expert (``ep`` = 1: the
    all-to-all over ``model_axis`` is ROADMAP item 9d-2). A token's slot past
    its expert's capacity C goes to a dump row that is sliced away, so
    its expert output is 0. Returns (y [T, d], aux)."""
    if ep != 1:
        raise NotImplementedError(f"expert parallelism (ep={ep}) over "
                                  f"{model_axis!r} is {_MESH_ITEM}")
    E, k = moe.n_experts, moe.top_k
    T, d = x_flat.shape
    dev = x_flat.device

    probs, top_p, top_e = route(x_flat, router_w, k)
    # Load-balance aux loss (Switch-style): E * sum_e f_e * p_e.
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.sum(F.one_hot(top_e, E).float(), dim=1), dim=0) / k
    aux = E * torch.sum(me * ce)

    # ---- sort-based capacity dispatch (no [T, E, C] one-hot) ---------------
    C = capacity(moe, T)
    flat_e = top_e.reshape(-1)  # [T*k]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]  # ascending expert ids
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos = torch.arange(T * k, device=dev) - seg_start[sorted_e]
    keep = pos < C
    token_of = order // k  # source token per sorted slot
    dst = torch.where(keep, sorted_e * C + pos, E * C)  # overflow -> dump slot
    # only the dump row takes duplicate writes, and it is sliced away
    xe = x_flat.new_zeros((E * C + 1, d), dtype=dtype).index_put(
        (dst,), x_flat[token_of].to(dtype))[:E * C].reshape(E, C, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", xe, we_gate.to(dtype)))
    h = h * torch.einsum("ecd,edf->ecf", xe, we_up.to(dtype))
    ye = torch.einsum("ecf,efd->ecd", h, we_down.to(dtype))  # [E, C, d]

    # ---- combine: gather each token's k slots, weight, sum ------------------
    ye_flat = torch.cat([ye.reshape(E * C, d), ye.new_zeros((1, d))])
    slot_of = torch.empty_like(order)
    slot_of[order] = dst  # undo the sort: slot per (token, k)
    y_slots = ye_flat[slot_of].reshape(T, k, d)
    y = torch.sum(y_slots * top_p[..., None].to(dtype), dim=1)
    return y, aux


def moe_block(x: Tensor, lw: dict, cfg: TransformerConfig, sh: ShardingConfig,
              mesh=None) -> tuple[Tensor, Tensor]:
    """x: [B, S, d] -> (y [B, S, d], aux scalar), on one device."""
    _no_mesh(mesh)
    B, S, d = x.shape
    y, aux = _moe_local(
        x.reshape(B * S, d), lw["router"], lw["we_gate"], lw["we_up"],
        lw["we_down"], moe=cfg.moe, model_axis=sh.model_axis, ep=1,
        dtype=cfg.dtype)
    return y.reshape(B, S, d), aux


def _moe_local_dense(h: Tensor, lw: dict, cfg: TransformerConfig):
    """Decode-path MoE: gather each token's top-k expert weights and batch
    the ffn; no capacity, so nothing drops."""
    moe = cfg.moe
    dt = cfg.dtype
    _, top_p, top_e = route(h, lw["router"], moe.top_k)
    wg = lw["we_gate"].to(dt)[top_e]  # [B, k, d, ff]
    wu = lw["we_up"].to(dt)[top_e]
    wd = lw["we_down"].to(dt)[top_e]
    g = F.silu(torch.einsum("bd,bkdf->bkf", h, wg))
    u = torch.einsum("bd,bkdf->bkf", h, wu)
    y = torch.einsum("bkf,bkfd->bkd", g * u, wd)
    return (torch.sum(y * top_p[..., None].to(dt), dim=1),
            h.new_zeros((), dtype=torch.float32))


def _ffn(h: Tensor, lw: dict, cfg: TransformerConfig, sh, mesh, *,
         decode: bool):
    """The layer's feed-forward half: (y, aux)."""
    dt = cfg.dtype
    if not cfg.moe:
        y = swiglu(h, lw["w_gate"].to(dt), lw["w_up"].to(dt),
                   lw["w_down"].to(dt))
        return y, h.new_zeros((), dtype=torch.float32)
    if decode:
        y, aux = _moe_local_dense(h, lw, cfg)
    else:
        y, aux = moe_block(h, lw, cfg, sh, mesh)
    if cfg.moe.n_shared:
        y = y + swiglu(h, lw["ws_gate"].to(dt), lw["ws_up"].to(dt),
                       lw["ws_down"].to(dt))
    return y, aux


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def _layer(x, lw, cfg: TransformerConfig, sh: ShardingConfig, mesh, *,
           positions, causal=True, collect_kv=False):
    """One transformer layer (training / prefill path). x: [B, S, d]."""
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.dtype

    h = rmsnorm(x, lw["ln1"], cfg.norm_eps)
    q = (h @ lw["wq"].to(dt)).reshape(B, S, H, hd)
    k = (h @ lw["wk"].to(dt)).reshape(B, S, KV, hd)
    v = (h @ lw["wv"].to(dt)).reshape(B, S, KV, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    kv = (k, v) if collect_kv else None
    k = _repeat_kv(k, H // KV)
    v = _repeat_kv(v, H // KV)
    attn = flash_attention(q, k, v, causal=causal, kv_chunk=cfg.kv_chunk,
                           unroll=cfg.unroll_inner)
    x = x + (attn.reshape(B, S, H * hd) @ lw["wo"].to(dt))

    h = rmsnorm(x, lw["ln2"], cfg.norm_eps)
    y, aux = _ffn(h, lw, cfg, sh, mesh, decode=False)
    x = x + y
    return (x, aux, kv) if collect_kv else (x, aux)


def _embed(params: dict, tokens: Tensor, cfg: TransformerConfig):
    B, S = tokens.shape
    x = params["embed"][tokens.long()].to(cfg.dtype)
    positions = torch.arange(S, device=x.device).expand(B, S)
    return x, positions


def forward(params, tokens, cfg: TransformerConfig, sh: ShardingConfig,
            mesh=None):
    """tokens [B, S] -> hidden [B, S, d] (+ summed MoE aux loss)."""
    _no_mesh(mesh)
    x, positions = _embed(params, tokens, cfg)
    inner = functools.partial(_layer, cfg=cfg, sh=sh, mesh=None,
                              positions=positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l in range(cfg.n_layers):
        x, a = _remat(cfg.remat, inner, x, _layer_params(params, l))
        aux = aux + a
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, aux


def _mask_vocab(logits: Tensor, vocab: int) -> Tensor:
    """Padded vocab columns out of the softmax: -inf."""
    Vp = logits.shape[-1]
    if Vp <= vocab:
        return logits
    cols = torch.arange(Vp, device=logits.device)
    return torch.where(cols < vocab, logits, -math.inf)


def chunked_xent(hidden, labels, lm_head, cfg: TransformerConfig):
    """Mean token NLL without materialising [B, S, V]: S in chunks of
    ``seq_chunk``, each recomputed in the backward pass."""
    B, S, d = hidden.shape
    c = min(cfg.seq_chunk, S)
    if S % c:
        c = S

    def one(h, lab):
        logits = _mask_vocab(h.float() @ lm_head.float(), cfg.vocab)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, lab.long()[..., None])[..., 0]
        return torch.sum(lse - gold)

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, c):
        tot = tot + _remat(True, one, hidden[:, i:i + c], labels[:, i:i + c])
    return tot / (B * S)


def loss_fn(params, batch, cfg: TransformerConfig, sh: ShardingConfig,
            mesh=None):
    """``(nll + aux_w * aux, {"nll", "aux"})`` of a ``{"tokens",
    "labels"}`` batch."""
    hidden, aux = forward(params, batch["tokens"], cfg, sh, mesh)
    nll = chunked_xent(hidden, batch["labels"], params["lm_head"], cfg)
    aux_w = cfg.moe.aux_loss_weight if cfg.moe else 0.0
    return nll + aux_w * aux, {"nll": nll, "aux": aux}


def prefill_step(params, tokens, cfg: TransformerConfig, sh: ShardingConfig,
                 mesh=None):
    """Inference prefill: process the full prompt, emit the KV cache and the
    last-position logits. tokens [B, S] -> (logits [B, V_padded] fp32, cache
    {k, v} of [L, B, S, KV, hd] in ``cfg.dtype``)."""
    _no_mesh(mesh)
    x, positions = _embed(params, tokens, cfg)
    B, S = tokens.shape
    inner = functools.partial(_layer, cfg=cfg, sh=sh, mesh=None,
                              positions=positions, collect_kv=True)
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
    cache = {n: torch.empty(shape, dtype=cfg.dtype, device=x.device)
             for n in ("k", "v")}
    for l in range(cfg.n_layers):
        x, _, (k, v) = _remat(cfg.remat, inner, x, _layer_params(params, l))
        cache["k"][l] = k
        cache["v"][l] = v
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = x[:, -1].float() @ params["lm_head"].float()
    return _mask_vocab(logits, cfg.vocab), cache


# ---------------------------------------------------------------------------
# Decode (serving) path
# ---------------------------------------------------------------------------


def cache_shapes(cfg: TransformerConfig, batch: int, max_seq: int) -> dict:
    """KV cache :class:`ShapeDtype`: k/v [L, B, S, KV, hd] in ``cfg.dtype``."""
    s = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.hd)
    return dict(k=ShapeDtype(s, cfg.dtype), v=ShapeDtype(s, cfg.dtype))


def cache_specs(sh: ShardingConfig) -> dict:
    """The KV cache's :class:`~repro_torch._spec.PSpec`: batch over
    ``sh.cache_batch_axes``, sequence over ``sh.cache_seq_axes``."""
    spec = PSpec(None, sh.cache_batch_axes or None,
                 sh.cache_seq_axes or None, None, None)
    return dict(k=spec, v=spec)


def decode_step(params, cache, tokens, pos, cfg: TransformerConfig,
                sh: ShardingConfig, mesh=None):
    """One greedy decode step.

    tokens: [B, 1] current token; pos: int or 0-d integer tensor, the
    current position (the cache holds ``pos`` valid entries). Writes this
    token's k/v into ``cache`` at ``pos`` in place (``repro`` returns an
    updated copy) and returns ``(logits [B, V_padded] fp32, cache)``, the
    same dict. Attention runs over the whole cache in fp32, masked to
    positions ``<= pos``.
    """
    _no_mesh(mesh)
    B = tokens.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.dtype
    S = cache["k"].shape[2]
    dev = tokens.device

    x = params["embed"][tokens[:, 0].long()].to(dt)  # [B, d]
    at = torch.as_tensor(pos, device=dev).long().reshape(1)
    positions = at.expand(B)[:, None]  # [B, 1]
    valid = torch.arange(S, device=dev) <= at
    for l in range(cfg.n_layers):
        lw = _layer_params(params, l)
        kc, vc = cache["k"][l], cache["v"][l]  # [B, S, KV, hd] views
        h = rmsnorm(x, lw["ln1"], cfg.norm_eps)
        q = (h @ lw["wq"].to(dt)).reshape(B, 1, H, hd)
        k_new = (h @ lw["wk"].to(dt)).reshape(B, 1, KV, hd)
        v_new = (h @ lw["wv"].to(dt)).reshape(B, 1, KV, hd)
        q = rope(q, positions, cfg.rope_theta)
        k_new = rope(k_new, positions, cfg.rope_theta)
        kc.index_copy_(1, at, k_new.to(kc.dtype))
        vc.index_copy_(1, at, v_new.to(vc.dtype))

        # GQA decode attention over the cache
        qg = q[:, 0].reshape(B, KV, H // KV, hd).float()
        s = torch.einsum("bkgh,bskh->bkgs", qg, kc.float()) / math.sqrt(hd)
        s = torch.where(valid, s, -math.inf)  # [B, KV, G, S]
        m = torch.amax(s, dim=-1, keepdim=True)
        p = torch.exp(s - m)
        denom = torch.sum(p, dim=-1, keepdim=True)
        o = torch.einsum("bkgs,bskh->bkgh", p / torch.clamp(denom, min=1e-30),
                         vc.float())
        attn = o.reshape(B, H * hd).to(dt)
        x = x + attn @ lw["wo"].to(dt)

        h = rmsnorm(x, lw["ln2"], cfg.norm_eps)
        y, _ = _ffn(h, lw, cfg, sh, None, decode=True)
        x = x + y
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = x.float() @ params["lm_head"].float()
    return _mask_vocab(logits, cfg.vocab), cache
