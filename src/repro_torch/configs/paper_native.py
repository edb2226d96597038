"""``eat-paper-8b``: the EAT paper's main reasoning model, shaped like
DeepSeek-R1-0528-Qwen3-8B (copy of ``repro/configs/paper_native.py``)."""
from repro_torch.configs.base import ModelConfig, register

PAPER_8B = register(
    ModelConfig(
        name="eat-paper-8b",
        arch_type="dense",
        source="hf:deepseek-ai/DeepSeek-R1-0528-Qwen3-8B",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab=151_936,
        qk_norm=True,
        rope_theta=1_000_000.0,
    )
)
