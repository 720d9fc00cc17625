"""EGNN — E(n)-equivariant graph neural network (Satorras et al., 2021),
the counterpart of ``repro.models.gnn``.

Message passing is edge-list based: gathers of the edge endpoints and
``index_add`` of the messages into ``[N, ·]`` zeros (``repro``'s
``jax.ops.segment_sum``). One EGNN layer (h: node features, x:
coordinates, e_ij edge attrs)::

    m_ij   = phi_e(h_i, h_j, ||x_i - x_j||^2, a_ij)
    x_i'   = x_i + (1/deg_i) * sum_j (x_i - x_j) * phi_x(m_ij)
    h_i'   = phi_h(h_i, sum_j m_ij)

``phi_*`` are small MLPs (d_hidden = 64, SiLU). Coordinates enter only
through squared distances and relative differences, so any E(n) transform
of ``x`` commutes with the layer.

Two regimes, as ``repro``'s:

* flat graphs (``full_graph_sm`` / ``ogb_products`` / ``minibatch_lg``):
  ``h [N, F]``, ``x [N, 3]``, ``edges [2, E]`` and an optional edge mask,
  so sampled subgraphs can be padded to a fixed shape. ``deg`` counts
  every edge, masked or not, as ``repro``'s does: padded edges (dst 0) add
  to node 0's degree.
* batched small graphs (``molecule``): inputs carry a leading batch axis.
  :func:`graph_reg_loss` runs the ``B`` molecules as one disjoint graph
  (``repro`` vmaps one forward per molecule; the sums are the same).

Params are a dict under ``repro``'s names: ``embed_w``/``embed_b``,
``head_w``/``head_b`` and the layer MLPs stacked ``[n_layers, ...]`` under
``layers``. Every product and scatter is a library call: ``repro`` has no
Pallas kernel here. ``param_specs`` replicates every parameter, as
``repro``'s does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch._spec import PSpec, ShapeDtype
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.models.transformer import _remat

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str
    n_layers: int = 4
    d_hidden: int = 64
    d_feat: int = 128  # input node-feature dim
    n_classes: int = 16
    d_edge: int = 0  # edge-attribute dim (0 = none)
    update_coords: bool = True
    task: str = "node_class"  # or "graph_reg"
    dtype: Any = torch.float32
    remat: bool = True  # recompute each layer in the backward pass

    def n_params(self) -> int:
        return sum(math.prod(s.shape) for s in tree_leaves(param_shapes(self)))


def _mlp_shapes(dims, prefix) -> dict:
    out = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"{prefix}_w{i}"] = (a, b)
        out[f"{prefix}_b{i}"] = (b,)
    return out


def param_shapes(cfg: EGNNConfig) -> dict:
    """:class:`ShapeDtype` of every parameter (float32), nested as
    ``repro``'s."""
    h, f, e = cfg.d_hidden, cfg.d_feat, cfg.d_edge
    layer = {}
    layer.update(_mlp_shapes((2 * h + 1 + e, h, h), "phi_e"))  # -> m_ij
    layer.update(_mlp_shapes((h, h, 1), "phi_x"))  # m_ij -> coordinate weight
    layer.update(_mlp_shapes((2 * h, h, h), "phi_h"))  # [h_i, agg_i] -> h_i'
    head_out = cfg.n_classes if cfg.task == "node_class" else 1

    def f32(*s):
        return ShapeDtype(tuple(s), torch.float32)

    return dict(
        embed_w=f32(f, h),
        embed_b=f32(h),
        layers={k: f32(cfg.n_layers, *s) for k, s in layer.items()},
        head_w=f32(h, head_out),
        head_b=f32(head_out),
    )


def param_specs(cfg: EGNNConfig, batch_axes=("data",), model_axis="model"
                ) -> dict:
    """Every parameter replicated (``repro``'s: the EGNN has ~100K)."""
    return tree_map(lambda _: PSpec(), param_shapes(cfg))


def init_params(cfg: EGNNConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random params on ``device`` (CUDA unless ``device="cpu"``), at
    ``repro``'s scales: a leaf of two or more axes is N(0, 1/fan_in) with
    fan_in = ``shape[-2]`` (so a stacked layer bias ``[L, n]`` draws at
    1/L, as ``repro``'s does), a 1-D leaf is zeros. Drawn in ``repro``'s
    leaf order (sorted names) from ``generator``, on the generator's own
    device, then moved to ``device``."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)

    def draw(s):
        if len(s.shape) < 2:
            return torch.zeros(s.shape, dtype=s.dtype, device=dev)
        w = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return w.mul_(1.0 / math.sqrt(s.shape[-2])).to(dev, s.dtype)

    out = {}
    for name in sorted(shapes):
        if name == "layers":
            out[name] = {n: draw(s) for n, s in sorted(shapes[name].items())}
        else:
            out[name] = draw(shapes[name])
    return out


def params_from_repro(np_params: dict, device="cuda") -> dict:
    """``repro``'s params (nested dicts of arrays under the same names) as
    the port's, float32 tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda v: torch.from_numpy(np.array(v, np.float32)).to(dev),
                    np_params)


def _mlp(p, prefix, x, n=2, act_last=False):
    for i in range(n):
        x = x @ p[f"{prefix}_w{i}"] + p[f"{prefix}_b{i}"]
        if i < n - 1 or act_last:
            x = F.silu(x)
    return x


def _segment_sum(values: Tensor, dst: Tensor, n: int) -> Tensor:
    """``jax.ops.segment_sum(values, dst, num_segments=n)``: rows of
    ``values`` added into ``[n, ...]`` zeros at ``dst`` (int64)."""
    return values.new_zeros((n,) + values.shape[1:]).index_add_(0, dst, values)


def egnn_layer(
    lp: dict,
    h: Tensor,  # [N, H]
    x: Tensor,  # [N, 3]
    edges: Tensor,  # [2, E] int64 (src, dst)
    edge_mask: Optional[Tensor] = None,  # [E] bool — padding edges
    edge_attr: Optional[Tensor] = None,  # [E, d_edge]
    *,
    update_coords: bool = True,
):
    """One EGNN message-passing layer on a flat (possibly padded) graph."""
    N = h.shape[0]
    src, dst = edges[0], edges[1]
    h_s = h.index_select(0, src)
    h_d = h.index_select(0, dst)
    dx = x.index_select(0, dst) - x.index_select(0, src)  # [E, 3]
    d2 = (dx * dx).sum(-1, keepdim=True)

    feats = [h_d, h_s, d2]
    if edge_attr is not None:
        feats.append(edge_attr)
    m = _mlp(lp, "phi_e", torch.cat(feats, -1), act_last=True)
    if edge_mask is not None:
        m = m * edge_mask[:, None].to(m.dtype)

    agg = _segment_sum(m, dst, N)  # [N, H]
    h_new = h + _mlp(lp, "phi_h", torch.cat([h, agg], -1))

    if update_coords:
        w = _mlp(lp, "phi_x", m)  # [E, 1]
        if edge_mask is not None:
            w = w * edge_mask[:, None].to(w.dtype)
        # -dx = x_src - x_dst: the update pulls x_i along (x_i - x_j)
        upd = _segment_sum(-dx * w, dst, N)
        deg = _segment_sum(torch.ones_like(w), dst, N)  # masked edges count
        x = x + upd / torch.clamp(deg, min=1.0)
    return h_new, x


def forward(
    params: dict,
    feats: Tensor,  # [N, F]
    coords: Tensor,  # [N, 3]
    edges: Tensor,  # [2, E]
    cfg: EGNNConfig,
    edge_mask: Optional[Tensor] = None,
    edge_attr: Optional[Tensor] = None,
):
    """Returns (node_logits [N, C] or node_energies [N, 1], coords'). Each
    layer is recomputed in the backward pass when ``cfg.remat`` and
    autograd is recording."""
    h = feats.to(cfg.dtype) @ params["embed_w"] + params["embed_b"]
    x = coords.to(cfg.dtype)
    edges = edges.long()

    def layer_fn(h, x, lp):
        return egnn_layer(lp, h, x, edges, edge_mask, edge_attr,
                          update_coords=cfg.update_coords)

    for l in range(cfg.n_layers):
        lp = {k: v[l] for k, v in params["layers"].items()}
        h, x = _remat(cfg.remat, layer_fn, h, x, lp)
    out = h @ params["head_w"] + params["head_b"]
    return out, x


def node_class_loss(params, batch, cfg: EGNNConfig):
    """Masked node-classification CE. batch: feats, coords, edges,
    edge_mask, labels [N], label_mask [N]."""
    logits, _ = forward(params, batch["feats"], batch["coords"],
                        batch["edges"], cfg, edge_mask=batch.get("edge_mask"))
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, batch["labels"].long()[:, None])[:, 0]
    w = batch["label_mask"].float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0), {}


def graph_reg_loss(params, batch, cfg: EGNNConfig):
    """Batched molecule energy regression: MSE of summed node energies.

    batch: feats [B, n, F], coords [B, n, 3], edges [B, 2, e], targets [B].
    The B molecules run as one disjoint graph: molecule b's nodes are rows
    ``[b * n, (b + 1) * n)`` and its edges are offset by ``b * n``."""
    feats, coords = batch["feats"], batch["coords"]
    B, n = feats.shape[:2]
    offs = torch.arange(B, device=feats.device)[:, None, None] * n
    edges = (batch["edges"].long() + offs).transpose(0, 1).reshape(2, -1)
    e, _ = forward(params, feats.reshape(B * n, -1),
                   coords.reshape(B * n, -1), edges, cfg)
    pred = e.reshape(B, -1).sum(-1)
    err = pred - batch["targets"].float()
    return (err * err).mean(), {}


def loss_fn(params, batch, cfg: EGNNConfig):
    if cfg.task == "graph_reg":
        return graph_reg_loss(params, batch, cfg)
    return node_class_loss(params, batch, cfg)
