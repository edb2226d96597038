"""SeamlessM4T-large v2 — encoder-decoder, audio (text decoder backbone)
(copy of ``repro/configs/seamless_m4t_large_v2.py``). [arXiv:2308.11596]

24 layers each side, d_model=1024, 16 heads of 64, GELU d_ff=8192, an
untied vocab of 256,206.  The speech frontend (mel + conformer conv) is a
stub, as in the reference: the encoder reads precomputed 1024-dim frame
embeddings, ``encoder_len`` of them.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="seamless-m4t-large-v2",
        arch_type="encdec",
        source="arXiv:2308.11596",
        n_layers=24,            # decoder layers
        n_encoder_layers=24,
        encoder_len=1024,       # stub frontend frames
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab=256_206,
        activation="gelu",
    )
)
