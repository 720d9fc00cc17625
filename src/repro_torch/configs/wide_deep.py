"""wide-deep [recsys] — n_sparse=40 embed_dim=32 mlp=1024-512-256
interaction=concat. [arXiv:1606.07792; paper]
"""

from repro_torch.configs.base import ArchDef, RECSYS_SHAPES, register_arch
from repro_torch.models.recsys import RecsysConfig

ID = "wide-deep"


def config() -> RecsysConfig:
    return RecsysConfig(
        name=ID, kind="wide_deep", n_sparse=40, embed_dim=32,
        mlp=(1024, 512, 256), n_dense=13, table_rows=1_000_000,
    )


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name=ID + "-smoke", kind="wide_deep", n_sparse=6, embed_dim=8,
        mlp=(32, 16), n_dense=4, table_rows=128,
    )


register_arch(ArchDef(
    id=ID, family="recsys", config_fn=config, smoke_fn=smoke_config,
    shapes=RECSYS_SHAPES, source="arXiv:1606.07792; paper",
))
