"""Cell builders: (arch x shape x mesh) -> a step (counterpart of
``repro.launch.steps``).

``build_cell`` returns a :class:`Cell`: the step function, its example
arguments as :class:`~repro_torch._spec.ShapeDtype` trees (never
allocated), the :class:`~repro_torch._spec.PSpec` trees that lay them out
over the mesh, and ``meta`` (``model_flops`` and the cell's sizes, by
``repro``'s formulas). ``launch.dryrun`` costs the step on the meta
device; ``chip_smoke.py`` feeds it tensors on the card.

``cell.step`` is the *global* step on one device: the models run with
``mesh=None`` on the global shapes, and a PDASC cell runs every shard of
its stacked index in turn (``core.distributed.build_stacked`` /
``search_stacked``). The mesh sets the specs, which every mesh records.
A step whose cell was built on a ``torch.distributed`` ``DeviceMesh`` of
one rank runs there: the PDASC cells go through ``build_sharded`` and
``compile_sharded_plan`` over that mesh's groups. A ``DeviceMesh`` of more
than one rank raises ``NotImplementedError``: running a cell sharded over
ranks is ROADMAP item 9d-2.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from repro_torch._spec import PSpec, ShapeDtype, placements
from repro_torch._tree import tree_map
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch.mesh import all_axes_of, axis_sizes, batch_axes_of
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.graph_sampler import subgraph_budget
from repro_torch.optim import adamw as opt_lib
from repro_torch.optim.accumulate import accumulate_gradients, value_and_grad

SDS = ShapeDtype
f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32

RANKS_ITEM = "ROADMAP item 9d-2"


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str
    step: Callable  # the global step (see the module doc)
    args: tuple  # ShapeDtype trees
    in_specs: tuple  # PSpec trees matching args
    out_specs: Any  # PSpec trees (None = replicated)
    donate: tuple = ()
    meta: dict = dataclasses.field(default_factory=dict)

    def in_shardings(self, mesh):
        """The DTensor placements of every argument over ``mesh`` (a
        ``MeshShape`` or a ``DeviceMesh``)."""
        return tree_map(lambda s: placements(mesh.mesh_dim_names, s),
                        self.in_specs)

    def out_shardings(self, mesh):
        if self.out_specs is None:
            return None
        return tree_map(lambda s: placements(mesh.mesh_dim_names, s),
                        self.out_specs)


def _runs_on(mesh) -> Optional[DeviceMesh]:
    """The ``DeviceMesh`` a step runs over (one rank), or None for the
    global step; raises for a ``DeviceMesh`` of more ranks."""
    if not isinstance(mesh, DeviceMesh):
        return None
    if mesh.size() > 1:
        raise NotImplementedError(
            f"running a cell sharded over {mesh.size()} ranks is "
            f"{RANKS_ITEM}; build the cell on a MeshShape (the global step "
            f"on one device) or a DeviceMesh of one rank")
    return mesh


def _b(bA: tuple):
    return bA if len(bA) > 1 else bA[0]


def _opt_cfg(total_steps=10_000):
    return opt_lib.AdamWConfig(total_steps=total_steps)


def _train_step(lfn, ocfg, mesh):
    """AdamW after the gradients of ``lfn(params, batch) -> (loss, aux)``."""

    def step(params, opt_state, batch):
        _runs_on(mesh)
        (loss, _), grads = value_and_grad(lfn, params, batch)
        new_p, new_o, m = opt_lib.adamw_update(grads, opt_state, params, ocfg)
        return new_p, new_o, {"loss": loss, **m}

    return step


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _lm_flops_model(cfg: tfm.TransformerConfig, tokens: int, kind: str) -> float:
    """MODEL_FLOPS: 6*N_active*D for training, 2*N_active*D for inference."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * cfg.n_active_params() * tokens


def _lm_cell(arch_id: str, spec: ShapeSpec, mesh,
             probe_layers: Optional[int] = None) -> Cell:
    cfg = get_arch(arch_id).config_fn()
    if probe_layers is not None:
        # the dry-run's probe: 1 or 2 layers, from which it extrapolates
        cfg = dataclasses.replace(
            cfg, n_layers=probe_layers, scan_layers=False, unroll_inner=True)
    bA = batch_axes_of(mesh)
    allA = all_axes_of(mesh)
    B = spec.dims["global_batch"]
    S = spec.dims["seq_len"]
    sizes = dict(n_params=cfg.n_params(), n_active=cfg.n_active_params())

    if spec.kind == "train":
        sh = tfm.ShardingConfig(batch_axes=bA)
        pshapes = tfm.param_shapes(cfg)
        pspecs = tfm.param_specs(cfg, sh)
        ocfg = _opt_cfg()
        # probes run unaccumulated, so their count extrapolates exactly
        n_micro = 1 if probe_layers is not None else spec.dims.get("n_micro", 4)

        def step(params, opt_state, batch):
            _runs_on(mesh)
            loss, _, grads = accumulate_gradients(
                lambda p, b: tfm.loss_fn(p, b, cfg, sh, None), params, batch,
                n_micro)
            new_p, new_o, m = opt_lib.adamw_update(grads, opt_state, params,
                                                   ocfg)
            return new_p, new_o, {"loss": loss, **m}

        return Cell(
            arch_id, spec.name, "train", step,
            args=(pshapes, opt_lib.opt_state_shapes(pshapes),
                  dict(tokens=SDS((B, S), i32), labels=SDS((B, S), i32))),
            in_specs=(pspecs, opt_lib.opt_state_specs(pspecs),
                      dict(tokens=PSpec(sh.b, None),
                           labels=PSpec(sh.b, None))),
            out_specs=(pspecs, opt_lib.opt_state_specs(pspecs), None),
            donate=(0, 1),
            meta=dict(tokens=B * S,
                      model_flops=_lm_flops_model(cfg, B * S, "train"),
                      **sizes),
        )

    if spec.kind == "prefill":
        sh = tfm.ShardingConfig(batch_axes=bA, cache_seq_axes=("model",),
                                cache_batch_axes=bA)

        def step(params, tokens):
            _runs_on(mesh)
            return tfm.prefill_step(params, tokens, cfg, sh, None)

        return Cell(
            arch_id, spec.name, "prefill", step,
            args=(tfm.param_shapes(cfg), SDS((B, S), i32)),
            in_specs=(tfm.param_specs(cfg, sh), PSpec(sh.b, None)),
            out_specs=(None, tfm.cache_specs(sh)),
            meta=dict(tokens=B * S,
                      model_flops=_lm_flops_model(cfg, B * S, "prefill"),
                      **sizes),
        )

    # decode: decode_32k splits the cache's sequence over model; long_500k
    # over every axis
    if spec.name == "long_500k":
        sh = tfm.ShardingConfig(batch_axes=bA, cache_seq_axes=allA,
                                cache_batch_axes=())
    else:
        sh = tfm.ShardingConfig(batch_axes=bA, cache_seq_axes=("model",),
                                cache_batch_axes=bA)
    cspecs = tfm.cache_specs(sh)

    def step(params, cache, tokens, pos):
        _runs_on(mesh)
        logits, cache = tfm.decode_step(params, cache, tokens, pos, cfg, sh,
                                        None)
        return torch.argmax(logits, dim=-1).to(i32)[:, None], cache

    return Cell(
        arch_id, spec.name, "decode", step,
        args=(tfm.param_shapes(cfg), tfm.cache_shapes(cfg, B, S),
              SDS((B, 1), i32), SDS((), i32)),
        in_specs=(tfm.param_specs(cfg, sh), cspecs,
                  PSpec(sh.cache_batch_axes or None, None), PSpec()),
        out_specs=(None, cspecs),
        donate=(1,),
        meta=dict(tokens=B, model_flops=_lm_flops_model(cfg, B, "decode"),
                  kv_bytes=2 * cfg.n_layers * B * S * cfg.n_kv_heads
                  * cfg.hd * 2, **sizes),
    )


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def subgraph_batch(batch: dict) -> dict:
    """G padded subgraphs (leaves ``[G, n_max, ...]`` and edges ``[G, 2,
    e_max]`` of subgraph-local ids) as one disjoint graph: subgraph g's
    nodes are rows ``[g * n_max, (g + 1) * n_max)`` and its edges are offset
    by ``g * n_max``, masked ones too, so that they land on its own node 0
    (``repro``'s degree counts them there)."""
    G, n_max = batch["feats"].shape[:2]
    offs = torch.arange(G, device=batch["edges"].device)[:, None, None] * n_max
    edges = (batch["edges"].long() + offs).transpose(0, 1).reshape(2, -1)
    flat = {k: v.reshape(G * n_max, *v.shape[2:])
            for k, v in batch.items() if k in ("feats", "coords", "labels",
                                               "label_mask")}
    return dict(flat, edges=edges, edge_mask=batch["edge_mask"].reshape(-1))


def subgraph_loss(params, batch: dict, cfg: gnn_lib.EGNNConfig):
    """The mean over G subgraphs of each one's ``node_class_loss`` (its
    masked CE over its own label count), as ``repro``'s ``vmap``; the G
    subgraphs run as one disjoint graph (:func:`subgraph_batch`)."""
    G, n_max = batch["feats"].shape[:2]
    flat = subgraph_batch(batch)
    logits, _ = gnn_lib.forward(params, flat["feats"], flat["coords"],
                                flat["edges"], cfg,
                                edge_mask=flat["edge_mask"])
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, flat["labels"].long()[:, None])[:, 0]
    w = flat["label_mask"].float().reshape(G, n_max)
    per = (nll.reshape(G, n_max) * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
    return per.mean(), {}


def _gnn_train_cell(arch_id, spec: ShapeSpec, mesh) -> Cell:
    from repro_torch.configs import egnn as egnn_cfg_mod

    cfg = egnn_cfg_mod.specialise(get_arch(arch_id).config_fn(), spec.name)
    b = _b(batch_axes_of(mesh))
    allA = all_axes_of(mesh)

    pshapes = gnn_lib.param_shapes(cfg)
    pspecs = gnn_lib.param_specs(cfg)

    if spec.name == "molecule":
        B, n, e = spec.dims["batch"], spec.dims["n_nodes"], spec.dims["n_edges"]
        batch_sds = dict(
            feats=SDS((B, n, cfg.d_feat), f32),
            coords=SDS((B, n, 3), f32),
            edges=SDS((B, 2, e), i32),
            targets=SDS((B,), f32),
        )
        batch_spec = dict(feats=PSpec(b, None, None),
                          coords=PSpec(b, None, None),
                          edges=PSpec(b, None, None), targets=PSpec(b))
        lfn = lambda p, bt: gnn_lib.loss_fn(p, bt, cfg)  # noqa: E731
        n_edges_total = B * e
    elif spec.name == "minibatch_lg":
        G = spec.dims["n_subgraphs"]
        n_max, e_max = subgraph_budget(spec.dims["batch_nodes"],
                                       spec.dims["fanouts"])
        batch_sds = dict(
            feats=SDS((G, n_max, cfg.d_feat), f32),
            coords=SDS((G, n_max, 3), f32),
            edges=SDS((G, 2, e_max), i32),
            edge_mask=SDS((G, e_max), torch.bool),
            labels=SDS((G, n_max), i32),
            label_mask=SDS((G, n_max), torch.bool),
        )
        batch_spec = dict(
            feats=PSpec(b, None, None), coords=PSpec(b, None, None),
            edges=PSpec(b, None, None), edge_mask=PSpec(b, None),
            labels=PSpec(b, None), label_mask=PSpec(b, None),
        )
        lfn = lambda p, bt: subgraph_loss(p, bt, cfg)  # noqa: E731
        n_edges_total = G * e_max
    else:  # full_graph_sm / ogb_products: flat graph, edges sharded
        N = spec.dims["n_nodes"]
        Ep = spec.dims["n_edges_padded"]
        batch_sds = dict(
            feats=SDS((N, cfg.d_feat), f32),
            coords=SDS((N, 3), f32),
            edges=SDS((2, Ep), i32),
            edge_mask=SDS((Ep,), torch.bool),
            labels=SDS((N,), i32),
            label_mask=SDS((N,), torch.bool),
        )
        batch_spec = dict(
            feats=PSpec(None, None), coords=PSpec(None, None),
            edges=PSpec(None, allA), edge_mask=PSpec(allA),
            labels=PSpec(None), label_mask=PSpec(None),
        )
        lfn = lambda p, bt: gnn_lib.loss_fn(p, bt, cfg)  # noqa: E731
        n_edges_total = spec.dims["n_edges"]

    # MODEL_FLOPS per step ~ 6 * (edge MLP work + node MLP work)
    h = cfg.d_hidden
    per_edge = 2 * ((2 * h + 1) * h + h * h + h)  # phi_e + phi_x fwd
    per_node = 2 * (cfg.d_feat * h + 2 * h * h + h * h)
    n_nodes_total = spec.dims.get("n_nodes", 0) * spec.dims.get("batch", 1)
    model_flops = 3.0 * cfg.n_layers * (
        per_edge * n_edges_total + per_node * max(n_nodes_total, 1))
    ospecs = opt_lib.opt_state_specs(pspecs)
    return Cell(
        arch_id, spec.name, "train", _train_step(lfn, _opt_cfg(), mesh),
        args=(pshapes, opt_lib.opt_state_shapes(pshapes), batch_sds),
        in_specs=(pspecs, ospecs, batch_spec),
        out_specs=(pspecs, ospecs, None),
        donate=(0, 1),
        meta=dict(model_flops=model_flops, n_params=cfg.n_params()),
    )


# ---------------------------------------------------------------------------
# Recsys cells
# ---------------------------------------------------------------------------


def _recsys_batch_sds(cfg: rec_lib.RecsysConfig, B: int, with_labels: bool):
    sds = {}
    if cfg.kind == "din":
        sds.update(target=SDS((B,), i32), seq=SDS((B, cfg.seq_len), i32),
                   seq_mask=SDS((B, cfg.seq_len), f32))
    else:
        sds["sparse"] = SDS((B, cfg.n_sparse), i32)
        if cfg.n_dense:
            sds["dense"] = SDS((B, cfg.n_dense), f32)
    if with_labels:
        sds["labels"] = SDS((B,), f32)
    return sds


def _recsys_batch_spec(sds, b):
    return {k: PSpec(b, *([None] * (len(v.shape) - 1))) for k, v in sds.items()}


def _recsys_cell(arch_id, spec: ShapeSpec, mesh) -> Cell:
    cfg = get_arch(arch_id).config_fn()
    bA = batch_axes_of(mesh)
    allA = all_axes_of(mesh)
    b = _b(bA)
    pshapes = {k: SDS(tuple(s), f32)
               for k, s in rec_lib.param_shapes(cfg).items()}
    pspecs = rec_lib.param_specs(cfg, batch_axes=bA)
    # embedding FLOPs are negligible; interactions + MLP dominate
    dense_params = sum(math.prod(s.shape) for k, s in pshapes.items()
                       if k not in ("tables", "wide", "lin"))
    B = spec.dims["batch"]

    if spec.kind == "train":
        batch_sds = _recsys_batch_sds(cfg, B, True)
        ospecs = opt_lib.opt_state_specs(pspecs)
        return Cell(
            arch_id, spec.name, "train",
            _train_step(lambda p, bt: rec_lib.loss_fn(p, bt, cfg),
                        _opt_cfg(), mesh),
            args=(pshapes, opt_lib.opt_state_shapes(pshapes), batch_sds),
            in_specs=(pspecs, ospecs, _recsys_batch_spec(batch_sds, b)),
            out_specs=(pspecs, ospecs, None),
            donate=(0, 1),
            meta=dict(model_flops=6.0 * dense_params * B,
                      n_params=cfg.n_params()),
        )

    if spec.kind == "serve":
        batch_sds = _recsys_batch_sds(cfg, B, False)

        def step(params, batch):
            _runs_on(mesh)
            logits, _ = rec_lib.forward(params, batch, cfg)
            return torch.sigmoid(logits.float())

        return Cell(
            arch_id, spec.name, "serve", step,
            args=(pshapes, batch_sds),
            in_specs=(pspecs, _recsys_batch_spec(batch_sds, b)),
            out_specs=None,
            meta=dict(model_flops=2.0 * dense_params * B,
                      n_params=cfg.n_params()),
        )

    # retrieval_cand: one user against the padded candidate rows
    n_pad = spec.dims["n_candidates_padded"]
    batch_sds = _recsys_batch_sds(cfg, B, False)

    def step(params, batch, candidates):
        _runs_on(mesh)
        return rec_lib.retrieval_step(params, batch, candidates, cfg, None,
                                      k=100, cand_axes=allA)

    return Cell(
        arch_id, spec.name, "retrieval", step,
        args=(pshapes, batch_sds, SDS((n_pad, cfg.retrieval_dim), f32)),
        in_specs=(pspecs, _recsys_batch_spec(batch_sds, None),
                  PSpec(allA, None)),
        out_specs=(PSpec(), PSpec()),
        meta=dict(model_flops=2.0 * n_pad * cfg.retrieval_dim * B,
                  n_params=cfg.n_params()),
    )


# ---------------------------------------------------------------------------
# PDASC cells (the paper's own architecture)
# ---------------------------------------------------------------------------


def pdasc_level_sizes(per: int, gl: int) -> list:
    """Each level's slot count of an MSA build over ``per`` rows (leaf
    first): a level of ``n`` items is padded to whole groups of ``gl`` and
    keeps ``gl // 2`` medoids a group, until one group remains. These are
    the shapes ``repro`` reads off ``jax.eval_shape`` of its build."""
    sizes, level_n = [], per
    while True:
        G = -(-level_n // gl)
        sizes.append(G * gl)
        level_n = G * (gl // 2)
        if G == 1:
            sizes.append(level_n)
            return sizes


def pdasc_index_shapes(per: int, d: int, gl: int, n_shards: int,
                       dtype=f32):
    """The stacked index's ``ShapeDtype`` tree (a leading shard axis), the
    float leaves in ``dtype``."""
    from repro_torch.core import msa

    def s(n, dt, *rest):
        return SDS((n_shards, n) + rest, dt)

    sizes = pdasc_level_sizes(per, gl)
    levels = tuple(msa.PDASCLevel(
        points=s(n, dtype, d), valid=s(n, torch.bool), parent=s(n, i32),
        child_start=s(n, i32), child_count=s(n, i32), sq_norm=s(n, dtype))
        for n in sizes)
    return msa.PDASCIndexData(levels=levels, leaf_ids=s(sizes[0], i32))


def _pdasc_cell(arch_id, spec: ShapeSpec, mesh, variant: str = "base") -> Cell:
    from repro_torch.core import distributed as dd
    from repro_torch.query import compile_sharded_plan

    cfg = get_arch(arch_id).config_fn()
    allA = all_axes_of(mesh)
    Pn = math.prod(axis_sizes(mesh).values())
    n, d = cfg.n, cfg.d
    per = n // Pn

    if spec.kind == "build":
        knobs = dict(gl=cfg.gl, distance=cfg.distance, method=cfg.method,
                     row_chunk=cfg.row_chunk, group_chunk=cfg.group_chunk,
                     swap_tol=cfg.swap_tol, kb=cfg.kb)

        def step(data):
            ranks = _runs_on(mesh)
            if ranks is None:
                return dd.build_stacked(data, Pn, **knobs)
            local = dd.build_sharded(data, ranks, db_axes=allA,
                                     device=data.device, **knobs)
            return tree_map(lambda a: a[None], local)

        # distance-matrix FLOPs of every level's clustering (the dominant
        # term): level sizes n, n/2, ... a shard; ~2 g^2 d a group
        flops, level_n = 0.0, per
        while True:
            G = -(-level_n // cfg.gl)
            flops += 2.0 * G * (cfg.gl ** 2) * d
            level_n = G * (cfg.gl // 2)
            if G == 1:
                break
        return Cell(
            arch_id, spec.name, "build", step,
            args=(SDS((n, d), f32),),
            in_specs=(PSpec(allA, None),),
            out_specs=None,
            meta=dict(model_flops=flops * Pn, n_points=n),
        )

    # search: each shard's search, then the global top-k merge
    idx_sds = pdasc_index_shapes(per, d, cfg.gl, Pn,
                                 bf16 if variant == "opt" else f32)
    idx_specs = tree_map(lambda _: PSpec(allA), idx_sds)
    Q = cfg.n_queries
    n_levels = len(idx_sds.levels)
    ranks = mesh if isinstance(mesh, DeviceMesh) else None
    if variant == "opt-beam":
        # the beam-pruned search: the top `beam` in-radius prototypes'
        # child blocks a level, through the rank kernel
        beam, mc = 32, 8
        plan = compile_sharded_plan(
            ranks, cfg.search_query(execution="beam", beam=beam),
            dist=cfg.distance, db_axes=allA,
            max_children=(0,) + (mc,) * (n_levels - 1))
    elif variant == "opt":
        # the dense search over an index and queries stored in bf16 (the
        # port's kernels compute in fp32: each call upcasts)
        plan = compile_sharded_plan(
            ranks, cfg.search_query(execution="dense", with_stats=False,
                                    kernel=None),
            dist=cfg.distance, db_axes=allA)
    else:
        plan = compile_sharded_plan(
            ranks, cfg.search_query(execution="dense", kernel=None),
            dist=cfg.distance, db_axes=allA)

    def step(index, queries):
        if _runs_on(mesh) is not None:
            return plan(dd.shard_of(index, 0), queries.float())
        q = plan.query
        return dd.search_stacked(
            index, queries, dist=plan.dist, k=q.k, r=plan.radius,
            mode=plan.shard_mode, beam=q.beam,
            max_children=plan.max_children,
            leaf_radius_filter=q.leaf_radius_filter,
            with_stats=q.with_stats, kernel=plan.kernel)

    # the dense search evaluates every level's distances:
    # sum_l n_l * d * 2 a query
    level_sizes, level_n = [], per
    while True:
        G = -(-level_n // cfg.gl)
        level_sizes.append(level_n)
        level_n = G * (cfg.gl // 2)
        if G == 1:
            level_sizes.append(level_n)
            break
    flops = 2.0 * Q * d * sum(level_sizes) * Pn
    return Cell(
        arch_id, spec.name, "search", step,
        args=(idx_sds, SDS((Q, d), bf16 if variant == "opt" else f32)),
        in_specs=(idx_specs, PSpec(None, None)),
        out_specs=None,
        meta=dict(model_flops=flops, n_points=n, n_queries=Q),
    )


# ---------------------------------------------------------------------------


def build_cell(arch_id: str, shape: Union[str, ShapeSpec], mesh,
               probe_layers: Optional[int] = None,
               variant: str = "base") -> Cell:
    """The cell of ``arch_id`` at ``shape``: a shape name of the arch, or
    a ``ShapeSpec`` (a cut of one) over ``mesh``, a ``MeshShape`` or a
    ``DeviceMesh``."""
    arch = get_arch(arch_id)
    spec = arch.shapes[shape] if isinstance(shape, str) else shape
    if arch.family == "lm":
        return _lm_cell(arch_id, spec, mesh, probe_layers)
    if arch.family == "gnn":
        return _gnn_train_cell(arch_id, spec, mesh)
    if arch.family == "recsys":
        return _recsys_cell(arch_id, spec, mesh)
    if arch.family == "pdasc":
        return _pdasc_cell(arch_id, spec, mesh, variant)
    raise ValueError(arch.family)


def needs_probe(arch_id: str) -> bool:
    """LM cells: the dry-run counts a 1- and a 2-layer probe and
    extrapolates over the depth."""
    return get_arch(arch_id).family == "lm"


def probe_trip_count(arch_id: str) -> int:
    return get_arch(arch_id).config_fn().n_layers
