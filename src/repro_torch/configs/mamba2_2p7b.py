"""Mamba2-2.7B — attention-free SSD state-space model, arXiv:2405.21060
(copy of ``repro/configs/mamba2_2p7b.py``).

64L d_model=2560, d_state=128, expand=2 (d_inner=5120), head_dim=64
(80 SSD heads), vocab 50280 (padded 50432).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(
    ModelConfig(
        name="mamba2-2.7b",
        arch_type="ssm",
        source="arXiv:2405.21060",
        n_layers=64,
        d_model=2560,
        n_heads=1,      # unused by SSM blocks
        n_kv_heads=1,
        d_ff=0,
        vocab=50_280,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=128,
                      conv_width=4, n_groups=1),
    )
)
