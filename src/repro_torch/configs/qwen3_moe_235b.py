"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128e top-8 (128 experts, top-8, no shared).
[hf:Qwen/Qwen3-30B-A3B; hf]
"""

from repro_torch.configs.base import ArchDef, LM_SHAPES, register_arch
from repro_torch.models.transformer import MoEConfig, TransformerConfig

ID = "qwen3-moe-235b-a22b"


def config() -> TransformerConfig:
    return TransformerConfig(
        name=ID,
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        d_ff=1536,
        vocab=151936,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536, n_shared=0),
    )


def smoke_config() -> TransformerConfig:
    return TransformerConfig(
        name=ID + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        d_ff=96,
        vocab=512,
        seq_chunk=32,
        kv_chunk=32,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=48, n_shared=0,
                      capacity_factor=2.0),
    )


register_arch(ArchDef(
    id=ID, family="lm", config_fn=config, smoke_fn=smoke_config,
    shapes=LM_SHAPES, source="hf:Qwen/Qwen3-30B-A3B; hf",
))
