"""minitron-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000 (pruned nemotron). [arXiv:2407.14679; hf]
"""

from repro_torch.configs.base import ArchDef, LM_SHAPES, register_arch
from repro_torch.models.transformer import TransformerConfig

ID = "minitron-8b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ID,
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16384,
        vocab=256000,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        seq_chunk=32,
        kv_chunk=32,
    )


register_arch(ArchDef(
    id=ID, family="lm", config_fn=config, smoke_fn=smoke_config,
    shapes=LM_SHAPES, source="arXiv:2407.14679; hf",
))
