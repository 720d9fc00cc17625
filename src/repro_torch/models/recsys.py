"""Recsys architectures: Wide&Deep, xDeepFM, DIN, AutoInt (counterpart of
``repro.models.recsys``).

The common skeleton is: huge sparse embedding tables -> feature-interaction
op -> small MLP -> CTR logit. The lookup layer is a gather
(:func:`embedding_bag`, the fixed-length masked form of the hot path) or
an ``index_add_`` over segments (:func:`embedding_bag_ragged`, the
true-ragged form of the input pipeline). The gathers, the interaction
einsums and the MLPs are library calls: ``repro`` computes none of them
in a Pallas kernel.

Params are a flat ``dict[str, Tensor]`` under ``repro``'s names
(``tables``, ``mlp_w0``, ``cin_w1``, ``attn0_wq``, ``retrieval_proj``,
...), so a checkpoint of either package restores in the other and
:func:`params_from_repro` carries ``repro``'s weights across. All
``n_sparse`` field tables are stacked into one flat ``[F * rows, D]``
table.

``retrieval_step`` implements the ``retrieval_cand`` shape: one user
vector scored against 10^6 candidate embeddings. Its top-k is the port's
``ops.knn`` in the ``dot`` form, ``csrc/knn.cu``'s Gram route on the card;
with a mesh, each rank takes its row block of the candidates and the
per-rank lists merge through ``core.distributed.topk_merge``, as
``repro``'s ``shard_map`` merges them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch._spec import PSpec
from repro_torch.kernels import ops as kops

Tensor = torch.Tensor

KINDS = ("wide_deep", "xdeepfm", "din", "autoint")


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str
    n_sparse: int
    embed_dim: int
    n_dense: int = 13  # numeric features (criteo-style); 0 to disable
    table_rows: int = 1_000_000  # rows per sparse field
    mlp: tuple = ()
    cin_layers: tuple = ()  # xdeepfm
    seq_len: int = 0  # din behaviour-sequence length
    attn_mlp: tuple = ()  # din attention MLP
    n_attn_layers: int = 0  # autoint
    n_attn_heads: int = 0
    d_attn: int = 0
    retrieval_dim: int = 64
    dtype: Any = torch.float32

    @property
    def flat_rows(self) -> int:
        return self.n_sparse * self.table_rows

    def n_params(self) -> int:
        return sum(math.prod(s) for s in param_shapes(self).values())


# ---------------------------------------------------------------------------
# EmbeddingBag
# ---------------------------------------------------------------------------


def embedding_bag(
    table: Tensor, ids: Tensor, mask: Optional[Tensor] = None,
    combiner: str = "mean",
) -> Tensor:
    """Fixed-length bag: ids [..., L] -> [..., D]; masked sum/mean."""
    e = table[ids.long()]  # [..., L, D]
    if mask is not None:
        e = e * mask[..., None].to(e.dtype)
    s = torch.sum(e, dim=-2)
    if combiner == "mean":
        if mask is None:
            return s / max(float(e.shape[-2]), 1.0)
        n = torch.sum(mask, dim=-1, keepdim=True).to(e.dtype)
        s = s / torch.clamp(n, min=1.0)
    return s


def embedding_bag_ragged(
    table: Tensor, flat_ids: Tensor, segment_ids: Tensor, n_segments: int,
    combiner: str = "mean",
) -> Tensor:
    """True-ragged bag: CSR-style (values, segment) -> [n_segments, D]."""
    e = table[flat_ids.long()]
    seg = segment_ids.long()
    s = e.new_zeros((n_segments, e.shape[-1])).index_add_(0, seg, e)
    if combiner == "mean":
        cnt = e.new_zeros(n_segments).index_add_(
            0, seg, torch.ones_like(seg, dtype=e.dtype))
        s = s / torch.clamp(cnt[:, None], min=1.0)
    return s


def field_lookup(tables_flat: Tensor, ids: Tensor, rows_per_field: int) -> Tensor:
    """Per-field embedding: ids [B, F] into stacked tables [F*R, D] -> [B, F, D]."""
    F = ids.shape[-1]
    offsets = torch.arange(F, dtype=torch.int64, device=ids.device) * rows_per_field
    return tables_flat[ids.long() + offsets]


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _mlp_shapes(dims: Sequence[int], prefix: str) -> dict:
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"{prefix}_w{i}"] = (a, b)
        out[f"{prefix}_b{i}"] = (b,)
    return out


def _interaction_in_dim(cfg: RecsysConfig) -> int:
    F, D = cfg.n_sparse, cfg.embed_dim
    if cfg.kind in ("wide_deep", "xdeepfm"):
        return cfg.n_dense + F * D
    if cfg.kind == "din":
        return 3 * D + cfg.n_dense
    if cfg.kind == "autoint":
        return F * cfg.n_attn_heads * cfg.d_attn
    raise ValueError(cfg.kind)


def param_shapes(cfg: RecsysConfig) -> dict:
    """``{name: shape}`` of every parameter, in ``repro``'s order (all
    float32)."""
    F, R, D = cfg.n_sparse, cfg.table_rows, cfg.embed_dim
    p: dict = dict(tables=(F * R, D))
    mlp_in = _interaction_in_dim(cfg)
    p.update(_mlp_shapes((mlp_in,) + tuple(cfg.mlp) + (1,), "mlp"))

    if cfg.kind == "wide_deep":
        p["wide"] = (F * R, 1)
        if cfg.n_dense:
            p["wide_dense"] = (cfg.n_dense, 1)
    elif cfg.kind == "xdeepfm":
        hs = (F,) + tuple(cfg.cin_layers)
        for i, (h_prev, h) in enumerate(zip(hs[:-1], hs[1:])):
            p[f"cin_w{i}"] = (h, h_prev, F)
        p["cin_out"] = (sum(cfg.cin_layers), 1)
        p["lin"] = (F * R, 1)
    elif cfg.kind == "din":
        # attention MLP on [e_t, e_b, e_t - e_b, e_t * e_b]
        p.update(_mlp_shapes((4 * D,) + tuple(cfg.attn_mlp) + (1,), "attn"))
    elif cfg.kind == "autoint":
        H, da, L = cfg.n_attn_heads, cfg.d_attn, cfg.n_attn_layers
        d_in = D
        for l in range(L):
            for nm in ("wq", "wk", "wv"):
                p[f"attn{l}_{nm}"] = (d_in, H * da)
            p[f"attn{l}_wres"] = (d_in, H * da)
            d_in = H * da
    # retrieval user-tower projection (shared across kinds)
    penult = (cfg.mlp[-1] if cfg.mlp else mlp_in)
    p["retrieval_proj"] = (penult, cfg.retrieval_dim)
    return p


def param_specs(cfg: RecsysConfig, batch_axes=("data",), model_axis="model"
                ) -> dict:
    """:class:`~repro_torch._spec.PSpec` of every parameter, as
    ``repro``'s: the tables (and the ``wide`` / ``lin`` vectors) split by
    rows over ``model_axis``, the rest replicated."""
    return {k: PSpec(model_axis, None) if k in ("tables", "wide", "lin")
            else PSpec(*([None] * len(s)))
            for k, s in param_shapes(cfg).items()}


_BIASES = tuple(f"_b{i}" for i in range(8))


def init_params(cfg: RecsysConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random params on ``device`` (CUDA unless ``device="cpu"``): biases
    0, tables (and ``wide`` / ``lin``) N(0, 0.01²), the rest N(0,
    1/fan_in). Drawn in :func:`param_shapes`' order from ``generator``, on
    the generator's own device (a CUDA generator draws the 10^7-row tables
    on the card), then moved to ``device``."""
    dev = resolve_device(device)
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith(_BIASES):
            out[name] = torch.zeros(shape, dtype=torch.float32, device=dev)
            continue
        scale = 0.01 if name in ("tables", "wide", "lin") else 1.0 / math.sqrt(shape[0])
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        out[name] = w.mul_(scale).to(dev)
    return out


def params_from_repro(np_params: dict, device="cuda") -> dict:
    """``repro``'s params (a dict of arrays under the same names) as the
    port's, float32 tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
            for k, v in np_params.items()}


def _mlp_apply(p, prefix, x, n_layers, act=torch.relu, return_penult=False):
    penult = x
    for i in range(n_layers):
        x = x @ p[f"{prefix}_w{i}"] + p[f"{prefix}_b{i}"]
        if i < n_layers - 1:
            x = act(x)
            penult = x
    return (x, penult) if return_penult else x


def _n_mlp_layers(cfg: RecsysConfig) -> int:
    return len(cfg.mlp) + 1


# ---------------------------------------------------------------------------
# Forward passes (logit [B])
# ---------------------------------------------------------------------------


def _forward_wide_deep(params, batch, cfg):
    emb = field_lookup(params["tables"], batch["sparse"], cfg.table_rows)
    B, F, D = emb.shape
    parts = [emb.reshape(B, F * D)]
    if cfg.n_dense:
        parts.append(batch["dense"])
    deep_in = torch.cat(parts, dim=-1)
    logit_deep, penult = _mlp_apply(params, "mlp", deep_in, _n_mlp_layers(cfg),
                                    return_penult=True)
    wide = embedding_bag(params["wide"], batch["sparse"], combiner="sum")  # [B,1]
    logit = logit_deep[:, 0] + wide[:, 0]
    if cfg.n_dense:
        logit = logit + (batch["dense"] @ params["wide_dense"])[:, 0]
    return logit, penult


def _forward_xdeepfm(params, batch, cfg):
    emb = field_lookup(params["tables"], batch["sparse"], cfg.table_rows)
    B, F, D = emb.shape
    # CIN: x_k[b, h, d] = sum_{i, j} W_k[h, i, j] * x_{k-1}[b, i, d] * x_0[b, j, d]
    x0, xk = emb, emb
    pooled = []
    for i in range(len(cfg.cin_layers)):
        z = torch.einsum("bhd,bfd->bhfd", xk, x0)
        xk = torch.einsum("bhfd,ohf->bod", z, params[f"cin_w{i}"])
        pooled.append(torch.sum(xk, dim=-1))  # [B, h]
    logit_cin = (torch.cat(pooled, dim=-1) @ params["cin_out"])[:, 0]
    parts = [emb.reshape(B, F * D)]
    if cfg.n_dense:
        parts.append(batch["dense"])
    dnn_in = torch.cat(parts, dim=-1)
    logit_dnn, penult = _mlp_apply(params, "mlp", dnn_in, _n_mlp_layers(cfg),
                                   return_penult=True)
    lin = embedding_bag(params["lin"], batch["sparse"], combiner="sum")[:, 0]
    return logit_cin + logit_dnn[:, 0] + lin, penult


def _din_interest(params, e_seq, e_t, seq_mask, cfg):
    """Target attention over the behaviour sequence -> interest vector."""
    et_b = e_t[:, None, :].expand_as(e_seq)
    a_in = torch.cat([et_b, e_seq, et_b - e_seq, et_b * e_seq], dim=-1)
    scores = _mlp_apply(params, "attn", a_in, len(cfg.attn_mlp) + 1)[..., 0]
    scores = torch.where(seq_mask > 0, scores,
                         torch.full((), -1e30, dtype=scores.dtype,
                                    device=scores.device))
    w = torch.softmax(scores.float(), dim=-1).to(e_seq.dtype)
    return torch.einsum("bl,bld->bd", w, e_seq)


def _forward_din(params, batch, cfg):
    # Field 0 of the stacked tables is the item table (targets + behaviours).
    e_t = params["tables"][batch["target"].long()]  # [B, D]
    e_seq = params["tables"][batch["seq"].long()]  # [B, L, D]
    interest = _din_interest(params, e_seq, e_t, batch["seq_mask"], cfg)
    parts = [interest, e_t, interest * e_t]
    if cfg.n_dense:
        parts.append(batch["dense"])
    x = torch.cat(parts, dim=-1)
    logit, penult = _mlp_apply(params, "mlp", x, _n_mlp_layers(cfg),
                               return_penult=True)
    return logit[:, 0], penult


def _forward_autoint(params, batch, cfg):
    emb = field_lookup(params["tables"], batch["sparse"], cfg.table_rows)
    B, F, _ = emb.shape
    H, da = cfg.n_attn_heads, cfg.d_attn
    x = emb
    for l in range(cfg.n_attn_layers):
        q = (x @ params[f"attn{l}_wq"]).reshape(B, F, H, da)
        k = (x @ params[f"attn{l}_wk"]).reshape(B, F, H, da)
        v = (x @ params[f"attn{l}_wv"]).reshape(B, F, H, da)
        s = torch.einsum("bfhd,bghd->bhfg", q, k) / math.sqrt(da)
        w = torch.softmax(s.float(), dim=-1).to(x.dtype)
        o = torch.einsum("bhfg,bghd->bfhd", w, v).reshape(B, F, H * da)
        x = torch.relu(o + x @ params[f"attn{l}_wres"])
    flat = x.reshape(B, F * H * da)
    logit, penult = _mlp_apply(params, "mlp", flat, _n_mlp_layers(cfg),
                               return_penult=True)
    return logit[:, 0], penult


_FORWARDS = dict(
    wide_deep=_forward_wide_deep,
    xdeepfm=_forward_xdeepfm,
    din=_forward_din,
    autoint=_forward_autoint,
)


def forward(params, batch, cfg: RecsysConfig):
    """Returns (ctr logits [B], penultimate representation [B, h])."""
    return _FORWARDS[cfg.kind](params, batch, cfg)


def loss_fn(params, batch, cfg: RecsysConfig):
    """Mean BCE-with-logits and ``{"logit_mean"}``."""
    logits, _ = forward(params, batch, cfg)
    y = batch["labels"].float()
    z = logits.float()
    # numerically-stable BCE-with-logits
    loss = torch.mean(torch.clamp(z, min=0) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))
    return loss, {"logit_mean": torch.mean(z)}


# ---------------------------------------------------------------------------
# Retrieval (the `retrieval_cand` shape)
# ---------------------------------------------------------------------------


def user_vector(params, batch, cfg: RecsysConfig) -> Tensor:
    """[B, retrieval_dim] user-tower output."""
    _, penult = forward(params, batch, cfg)
    return penult @ params["retrieval_proj"]


def retrieval_step(params, batch, candidates, cfg: RecsysConfig, mesh=None,
                   *, k: int = 100, cand_axes=("data", "model")):
    """Score the users against ``[n_cand, retrieval_dim]`` candidates and
    keep the top k: ``(scores [B, k] descending, ids [B, k] int32)``, the
    lower id first among equal scores.

    The top-k is ``ops.knn(u, candidates, "dot", k=k)`` (``knn.cu`` on the
    card, its plain version on the CPU), which ranks ``-u.c`` ascending.
    With a ``DeviceMesh``, this rank takes its row block of the global
    ``candidates`` (a tensor, numpy array or memmap; ``n`` a multiple of
    the rank count over ``cand_axes``, as ``repro``'s reshape requires),
    ranks it, lifts its ids by ``shard * per`` and merges the ranks' lists
    through ``core.distributed.topk_merge`` over ``cand_axes``; every rank
    returns the global top k."""
    u = user_vector(params, batch, cfg)  # [B, Dr]
    if mesh is None:
        negs, ids = kops.knn(u, candidates, "dot", k=k)
        return -negs, ids

    from repro_torch.core import distributed as dd

    n = candidates.shape[0]
    Pn = 1
    for a in cand_axes:
        Pn *= dd.axis_size(mesh, a)
    if n % Pn:
        raise ValueError(f"n_candidates={n} is not a multiple of the "
                         f"{Pn} ranks over {tuple(cand_axes)}")
    per = n // Pn
    shard = dd.shard_index(mesh, cand_axes)
    local = candidates[shard * per:(shard + 1) * per]
    local = (local if isinstance(local, Tensor)
             else torch.from_numpy(np.array(local, np.float32)))
    negs, idx = kops.knn(u, local.to(u.device), "dot", k=k)
    gids = (idx + shard * per).to(torch.int32)
    negs, ids = dd.topk_merge(negs, gids, mesh, tuple(cand_axes), k)
    return -negs, ids
