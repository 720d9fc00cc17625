"""din [recsys] — embed_dim=18 seq_len=100 attn_mlp=80-40 mlp=200-80
interaction=target-attn. [arXiv:1706.06978; paper]

DIN's sparse side is the item/behaviour table (n_sparse=1 stacked table);
the behaviour sequence is an EmbeddingBag with target attention.
"""

from repro_torch.configs.base import ArchDef, RECSYS_SHAPES, register_arch
from repro_torch.models.recsys import RecsysConfig

ID = "din"


def config() -> RecsysConfig:
    return RecsysConfig(
        name=ID, kind="din", n_sparse=1, embed_dim=18, seq_len=100,
        attn_mlp=(80, 40), mlp=(200, 80), n_dense=0, table_rows=4_000_000,
    )


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name=ID + "-smoke", kind="din", n_sparse=1, embed_dim=8, seq_len=12,
        attn_mlp=(16, 8), mlp=(24, 8), n_dense=0, table_rows=128,
    )


register_arch(ArchDef(
    id=ID, family="recsys", config_fn=config, smoke_fn=smoke_config,
    shapes=RECSYS_SHAPES, source="arXiv:1706.06978; paper",
))
