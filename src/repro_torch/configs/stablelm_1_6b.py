"""stablelm-1.6b [dense] — 24L d_model=2048 32H (GQA kv=32, i.e. MHA)
d_ff=5632 vocab=100352. [hf:stabilityai/stablelm-2-1_6b; unverified]
"""

from repro_torch.configs.base import ArchDef, LM_SHAPES, register_arch
from repro_torch.models.transformer import TransformerConfig

ID = "stablelm-1.6b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ID,
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=5632,
        vocab=100352,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        seq_chunk=32,
        kv_chunk=32,
    )


register_arch(ArchDef(
    id=ID, family="lm", config_fn=config, smoke_fn=smoke_config,
    shapes=LM_SHAPES, source="hf:stabilityai/stablelm-2-1_6b; unverified",
))
