"""Arch/shape registry (counterpart of ``repro.configs.base``): every
ported architecture is a config module that registers an
:class:`ArchDef`; the launcher resolves ``--arch <id>`` here.

A *cell* is one (architecture x input-shape) pair; ``all_cells()``
enumerates the matrix. Shape kinds:

  train     — train_step: fwd + bwd + AdamW update
  prefill   — inference prefill: fwd, emits KV cache + last logits
  decode    — serve_step: one token against a KV cache of ``seq_len``
  serve     — batched forward-only scoring (recsys)
  retrieval — one query against n_candidates (distributed top-k)
  build     — PDASC MSA sharded build step
  search    — PDASC NSA sharded query step

The shape sets of every family are here as data, as ``repro`` has them
(``pad_to`` keeps its 512-way mesh padding so the numbers stay equal). The
registry holds every config ``repro`` has: the LM, GNN and recsys
families and ``pdasc``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

_MESH_LCM = 512  # repro pads shardable dims to its full device count


def pad_to(n: int, m: int = _MESH_LCM) -> int:
    return -(-n // m) * m


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str
    dims: dict
    note: str = ""


@dataclasses.dataclass(frozen=True)
class ArchDef:
    id: str
    family: str  # "lm" | "gnn" | "recsys" | "pdasc"
    config_fn: Callable[[], Any]  # full-size model config
    smoke_fn: Callable[[], Any]  # reduced config for CPU smoke tests
    shapes: dict
    source: str = ""
    notes: str = ""


_REGISTRY: dict[str, ArchDef] = {}


def register_arch(a: ArchDef) -> ArchDef:
    if a.id in _REGISTRY:
        raise ValueError(f"arch {a.id!r} already registered")
    _REGISTRY[a.id] = a
    return a


def get_arch(arch_id: str) -> ArchDef:
    _ensure_loaded()
    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}"
        ) from None


def arch_ids() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def all_cells(include_pdasc: bool = True) -> list[tuple[str, str]]:
    """Every (arch, shape) pair of the registered archs."""
    _ensure_loaded()
    out = []
    for aid in sorted(_REGISTRY):
        a = _REGISTRY[aid]
        if a.family == "pdasc" and not include_pdasc:
            continue
        for s in a.shapes:
            out.append((aid, s))
    return out


_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from repro_torch.configs import (  # noqa: F401
        autoint,
        deepseek_moe_16b,
        din,
        egnn,
        granite_3_2b,
        minitron_8b,
        pdasc,
        qwen3_moe_235b,
        stablelm_1_6b,
        wide_deep,
        xdeepfm,
    )


# ---------------------------------------------------------------------------
# Shared shape sets (one set per family)
# ---------------------------------------------------------------------------

LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train",
                          dict(seq_len=4096, global_batch=256)),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                             dict(seq_len=32768, global_batch=32)),
    "decode_32k": ShapeSpec("decode_32k", "decode",
                            dict(seq_len=32768, global_batch=128)),
    "long_500k": ShapeSpec(
        "long_500k", "decode", dict(seq_len=524288, global_batch=1),
        note="decode against a 524288-token KV cache is O(S), not O(S^2); "
             "run with fully sharded sequence (DESIGN.md §4 long_500k note)",
    ),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", dict(batch=65536)),
    "serve_p99": ShapeSpec("serve_p99", "serve", dict(batch=512)),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", dict(batch=262144)),
    "retrieval_cand": ShapeSpec(
        "retrieval_cand", "retrieval",
        dict(batch=1, n_candidates=1_000_000,
             n_candidates_padded=pad_to(1_000_000)),
        note="padded candidate rows are masked out of the top-k",
    ),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "train",
        dict(n_nodes=2708, n_edges=10556, d_feat=1433,
             n_edges_padded=pad_to(10556)),
    ),
    "minibatch_lg": ShapeSpec(
        "minibatch_lg", "train",
        dict(n_nodes=232_965, n_edges=114_615_892, batch_nodes=1024,
             fanouts=(15, 10), n_subgraphs=32),
        note="32 sampled subgraphs per step (one per DP shard); static "
             "budget from (batch_nodes, fanouts)",
    ),
    "ogb_products": ShapeSpec(
        "ogb_products", "train",
        dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
             n_edges_padded=pad_to(61_859_140)),
    ),
    "molecule": ShapeSpec(
        "molecule", "train",
        dict(n_nodes=30, n_edges=64, batch=128),
    ),
}
