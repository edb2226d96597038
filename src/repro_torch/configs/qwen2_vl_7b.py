"""Qwen2-VL-7B — VLM language backbone with M-RoPE (copy of
``repro/configs/qwen2_vl_7b.py``). [arXiv:2409.12191]

28L d_model=3584, 28 heads (kv=4), d_ff=18944, vocab=152064, M-RoPE
sections (t,h,w)=(16,24,24) over head_dim=128.  The ViT vision encoder +
projector is a stub, as in the reference: the caller hands projected patch
embeddings (n_image_patches x d_model), prepended to the token stream.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-vl-7b",
        arch_type="vlm",
        source="arXiv:2409.12191",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab=152_064,
        attn_bias=True,
        mrope_sections=(16, 24, 24),
        n_image_patches=256,
        rope_theta=1_000_000.0,
    )
)
