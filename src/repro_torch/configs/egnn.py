"""egnn [gnn] — n_layers=4 d_hidden=64 equivariance=E(n).
[arXiv:2102.09844; paper]

Shape-specific feature dims come from the shape (full_graph_sm d=1433,
ogb_products d=100, minibatch_lg/molecule use defaults); the caller
specialises ``d_feat``/``n_classes``/``task`` per cell via
``specialise(shape)``.
"""

import dataclasses

from repro_torch.configs.base import ArchDef, GNN_SHAPES, register_arch
from repro_torch.models.gnn import EGNNConfig

ID = "egnn"


def config() -> EGNNConfig:
    return EGNNConfig(name=ID, n_layers=4, d_hidden=64, d_feat=128,
                      n_classes=47)


def specialise(cfg: EGNNConfig, shape_name: str) -> EGNNConfig:
    """Bind the per-shape feature dims / task."""
    if shape_name == "full_graph_sm":
        return dataclasses.replace(cfg, d_feat=1433, n_classes=7)
    if shape_name == "minibatch_lg":
        return dataclasses.replace(cfg, d_feat=602, n_classes=41)  # reddit-like
    if shape_name == "ogb_products":
        return dataclasses.replace(cfg, d_feat=100, n_classes=47)
    if shape_name == "molecule":
        return dataclasses.replace(cfg, d_feat=16, task="graph_reg")
    return cfg


def smoke_config() -> EGNNConfig:
    return EGNNConfig(name=ID + "-smoke", n_layers=2, d_hidden=16, d_feat=12,
                      n_classes=5)


register_arch(ArchDef(
    id=ID, family="gnn", config_fn=config, smoke_fn=smoke_config,
    shapes=GNN_SHAPES, source="arXiv:2102.09844; paper",
    notes="irrep regime: E(n) relative-vector messages (no tensor products; "
          "EGNN's O(n) trick replaces the O(L^6) irrep path)",
))
