"""granite-3-2b [dense] — 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155. [hf:ibm-granite/granite-3.0-2b-base; hf]

vocab 49155 is not TP-divisible; the embedding/lm_head are padded to 49408
(masked in the loss — TransformerConfig.vocab_padded).
"""

from repro_torch.configs.base import ArchDef, LM_SHAPES, register_arch
from repro_torch.models.transformer import TransformerConfig

ID = "granite-3-2b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ID,
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        d_ff=8192,
        vocab=49155,
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=128,
        vocab=515,  # deliberately non-divisible, like the real 49155
        seq_chunk=32,
        kv_chunk=32,
    )


register_arch(ArchDef(
    id=ID, family="lm", config_fn=config, smoke_fn=smoke_config,
    shapes=LM_SHAPES, source="hf:ibm-granite/granite-3.0-2b-base; hf",
))
