"""Tiny configs for CPU tests (copies of ``repro/configs/tiny.py``)."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, register

TINY = register(
    ModelConfig(
        name="tiny",
        arch_type="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=64,
        qk_norm=True,
        dtype="float32",
    )
)

# the black-box monitor model of the proxy-EAT serving tier (paper Fig. 5
# at toy scale: a smaller model of the generator's tokenizer)
TINY_PROXY = register(
    ModelConfig(
        name="tiny-proxy",
        arch_type="dense",
        n_layers=1,
        d_model=32,
        n_heads=2,
        n_kv_heads=1,
        head_dim=16,
        d_ff=64,
        vocab=64,                # must match the generator's tokenizer
        qk_norm=True,
        dtype="float32",
    )
)

TINY_REASONER = register(
    ModelConfig(
        name="tiny-reasoner",
        arch_type="dense",
        n_layers=3,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab=64,
        tie_embeddings=True,
        dtype="float32",
    )
)

TINY_MOE = register(
    ModelConfig(
        name="tiny-moe",
        arch_type="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=64,
        moe=MoEConfig(n_routed=4, n_shared=1, top_k=2, d_expert=32, first_k_dense=1, dense_d_ff=128),
        dtype="float32",
    )
)

TINY_SSM = register(
    ModelConfig(
        name="tiny-ssm",
        arch_type="ssm",
        n_layers=2,
        d_model=64,
        n_heads=1,
        n_kv_heads=1,
        d_ff=0,
        vocab=64,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=16),
        dtype="float32",
    )
)
