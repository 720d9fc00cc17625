"""xdeepfm [recsys] — n_sparse=39 embed_dim=10 cin_layers=200-200-200
mlp=400-400 interaction=cin. [arXiv:1803.05170; paper]
"""

from repro_torch.configs.base import ArchDef, RECSYS_SHAPES, register_arch
from repro_torch.models.recsys import RecsysConfig

ID = "xdeepfm"


def config() -> RecsysConfig:
    return RecsysConfig(
        name=ID, kind="xdeepfm", n_sparse=39, embed_dim=10,
        cin_layers=(200, 200, 200), mlp=(400, 400), n_dense=13,
        table_rows=1_000_000,
    )


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name=ID + "-smoke", kind="xdeepfm", n_sparse=6, embed_dim=6,
        cin_layers=(12, 12), mlp=(24, 24), n_dense=4, table_rows=128,
    )


register_arch(ArchDef(
    id=ID, family="recsys", config_fn=config, smoke_fn=smoke_config,
    shapes=RECSYS_SHAPES, source="arXiv:1803.05170; paper",
))
