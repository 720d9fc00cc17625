"""autoint [recsys] — n_sparse=39 embed_dim=16 n_attn_layers=3 n_heads=2
d_attn=32 interaction=self-attn. [arXiv:1810.11921; paper]
"""

from repro_torch.configs.base import ArchDef, RECSYS_SHAPES, register_arch
from repro_torch.models.recsys import RecsysConfig

ID = "autoint"


def config() -> RecsysConfig:
    return RecsysConfig(
        name=ID, kind="autoint", n_sparse=39, embed_dim=16,
        n_attn_layers=3, n_attn_heads=2, d_attn=32, mlp=(), n_dense=0,
        table_rows=1_000_000,
    )


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name=ID + "-smoke", kind="autoint", n_sparse=6, embed_dim=8,
        n_attn_layers=2, n_attn_heads=2, d_attn=4, mlp=(), n_dense=0,
        table_rows=128,
    )


register_arch(ArchDef(
    id=ID, family="recsys", config_fn=config, smoke_fn=smoke_config,
    shapes=RECSYS_SHAPES, source="arXiv:1810.11921; paper",
))
