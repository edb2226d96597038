"""Gemma-7B — dense, GeGLU, head_dim=256 (copy of
``repro/configs/gemma_7b.py``). [arXiv:2403.08295]

28L d_model=3072, 16 heads (kv=16), d_ff=24576, vocab=256000, tied
embeddings, embedding scaling, (1+w) RMSNorm.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="gemma-7b",
        arch_type="dense",
        source="arXiv:2403.08295",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab=256_000,
        activation="geglu",
        tie_embeddings=True,
        embed_scale=True,
        rmsnorm_one_plus=True,
    )
)
