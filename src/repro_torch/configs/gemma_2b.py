"""Gemma-2B — dense, GeGLU, head_dim=256, MQA (kv=1) (copy of
``repro/configs/gemma_2b.py``). [arXiv:2403.08295]

18L d_model=2048, 8 heads (kv=1), d_ff=16384, vocab=256000, tied embeddings,
embedding scaling by sqrt(d), (1+w) RMSNorm.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="gemma-2b",
        arch_type="dense",
        source="arXiv:2403.08295",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab=256_000,
        activation="geglu",
        tie_embeddings=True,
        embed_scale=True,
        rmsnorm_one_plus=True,
    )
)
