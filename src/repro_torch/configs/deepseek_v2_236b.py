"""DeepSeek-V2 236B (21B active) — MLA + fine-grained MoE (copy of
``repro/configs/deepseek_v2_236b.py``).  [arXiv:2405.04434]

60L d_model=5120, 128 heads, MLA kv_lora=512 (q_lora=1536, nope=128, rope=64,
v=128), MoE: 2 shared + 160 routed experts, top-6, d_expert=1536, layer 0
dense FFN (d_ff=12288), vocab 102400.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="deepseek-v2-236b",
        arch_type="moe",
        source="arXiv:2405.04434",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=12288,  # dense layer d_ff (layer 0)
        vocab=102_400,
        activation="silu",
        rope_theta=10_000.0,
        moe=MoEConfig(
            n_routed=160,
            n_shared=2,
            top_k=6,
            d_expert=1536,
            first_k_dense=1,
            dense_d_ff=12288,
            router_aux_weight=0.003,
        ),
        mla=MLAConfig(
            kv_lora_rank=512,
            q_lora_rank=1536,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
    )
)
