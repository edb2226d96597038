"""Qwen3-1.7B — dense, GQA (kv=8), qk_norm, tied embeddings (copy of
``repro/configs/qwen3_1p7b.py``)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen3-1.7b",
        arch_type="dense",
        source="hf:Qwen/Qwen3-1.7B (family card hf:Qwen/Qwen3-8B)",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=6144,
        vocab=151_936,
        qk_norm=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
    )
)
