"""DeepSeekMoE-16B — fine-grained MoE: 2 shared + 64 routed, top-6
(copy of ``repro/configs/deepseek_moe_16b.py``).
[arXiv:2401.06066]

28L d_model=2048, 16 heads (kv=16), d_expert=1408, layer 0 dense
(d_ff=10944), vocab 102400.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="deepseek-moe-16b",
        arch_type="moe",
        source="arXiv:2401.06066",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,
        vocab=102_400,
        moe=MoEConfig(
            n_routed=64,
            n_shared=2,
            top_k=6,
            d_expert=1408,
            first_k_dense=1,
            dense_d_ff=10944,
            router_aux_weight=0.001,
        ),
    )
)
