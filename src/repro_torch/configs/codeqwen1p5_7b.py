"""CodeQwen1.5-7B — dense, qwen1.5 arch (qkv bias) (copy of
``repro/configs/codeqwen1p5_7b.py``). [hf:Qwen/CodeQwen1.5-7B]

32L d_model=4096, 32 heads (MHA: kv=32), d_ff=13440, vocab=92416.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="codeqwen1.5-7b",
        arch_type="dense",
        source="hf:Qwen/CodeQwen1.5-7B",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=13440,
        vocab=92_416,
        attn_bias=True,
        rope_theta=1_000_000.0,
    )
)
