"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6, 2 shared + 64 routed (fine-grained experts).
[arXiv:2401.06066; hf]
"""

from repro_torch.configs.base import ArchDef, LM_SHAPES, register_arch
from repro_torch.models.transformer import MoEConfig, TransformerConfig

ID = "deepseek-moe-16b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ID,
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab=102400,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab=512,
        seq_chunk=32,
        kv_chunk=32,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96, n_shared=2,
                      capacity_factor=2.0),
    )


register_arch(ArchDef(
    id=ID, family="lm", config_fn=config, smoke_fn=smoke_config,
    shapes=LM_SHAPES, source="arXiv:2401.06066; hf",
))
