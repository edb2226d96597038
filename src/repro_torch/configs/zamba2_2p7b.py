"""Zamba2-2.7B — hybrid: Mamba2 backbone + shared attention block
(copy of ``repro/configs/zamba2_2p7b.py``). [arXiv:2411.15242]

54 blocks d_model=2560: 45 Mamba2 blocks (ssm_state=64) and one SHARED
attention+MLP block (32 heads of 80, d_ff=10240) applied every 6th
position (9 applications, each with its own KV cache).  The shared block
consumes concat(hidden, embed0) (2*d); per-depth LoRA deltas are omitted,
as in the reference.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(
    ModelConfig(
        name="zamba2-2.7b",
        arch_type="hybrid",
        source="arXiv:2411.15242",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab=32_000,
        ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=128, conv_width=4),
        hybrid_pattern=("ssm", "ssm", "ssm", "ssm", "ssm", "shared_attn"),
    )
)
